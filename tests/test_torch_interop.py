"""Port parity: ``tools/interop.py`` against the reference tool, on the CPU.

The port keeps the reference's format matrix (``FORMAT_DEFINITIONS``) as
it is. Every row of it passes ``run_format`` in process on both fixtures
(synthetic 96×80, and the clinical XR/CT/MR pixels of
test-data/clinical_pixels.npz at 512²), on the "device" engine (the plain
torch lanes of the kernels) and the "host" engine; the lossless rows'
detail strings — max error, compression ratio and the multi-frame lane's
verdict — equal the reference's, so their streams have the reference's
sizes. ``main`` runs two spawned workers on the CPU, and a worker's
exception is a ``fail`` row and exit code 1. Tolerance: each row's own.
"""

import pytest

torch = pytest.importorskip("torch")

from go_dicom_codec_tpu.tools import interop as ref_interop
from go_dicom_codec_torch.tools import interop

ROWS = interop.FORMAT_DEFINITIONS


def _job(row, fixture, *tail):
    return (row[0], row[1], row[2], row[3], row[4], 96, 80, 7, "self",
            fixture, row[5] if len(row) > 5 else None, *tail)


def test_format_definitions_match_reference():
    assert interop.FORMAT_DEFINITIONS == ref_interop.FORMAT_DEFINITIONS
    assert interop.PIL_DECODABLE == ref_interop.PIL_DECODABLE


@pytest.mark.parametrize("engine", ("device", "host"))
@pytest.mark.parametrize("fixture", ("synthetic", "clinical"))
@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_row_passes(row, fixture, engine):
    label, ok, detail = interop.run_format(_job(row, fixture, "cpu", engine))
    assert ok, detail
    assert label == row[0]
    if row[4] == 0:
        want = ref_interop.run_format(_job(row, fixture))
        assert want[1] and detail == want[2]


def test_worker_exception_is_a_fail_row():
    row = ("bogus", "1.2.3.4", 8, 1, 0)
    label, ok, detail = interop.run_format(_job(row, "synthetic", "cpu",
                                                "auto"))
    assert (label, ok) == ("bogus", False)
    assert detail.startswith("CodecNotFoundError")


def test_main_with_two_workers(capsys):
    assert interop.main(["--device", "cpu", "--parallel", "2", "--formats",
                         "rle,jpeg2000-lossless,jpeg-baseline"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("INTEROP|pass|") for ln in out) == 3
    assert out[-1] == "INTEROP|done|formats=3|failures=0"


def test_pil_oracle_row():
    pytest.importorskip("PIL")
    row = next(r for r in ROWS if r[0] == "jpeg2000-lossless")
    job = list(_job(row, "clinical", "cpu", "device"))
    job[8] = "pil"
    label, ok, detail = interop.run_format(tuple(job))
    assert ok and "foreign(PIL) maxerr=0" in detail
