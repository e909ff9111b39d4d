"""Port parity: ``tools/transcode.py`` against the reference tool, on the CPU.

Every chain of tests/test_transcode.py runs through both tools' ``main``
from the same input, step by step: each step's output file must be
byte-identical to the reference's, and its ``TRANSCODE|`` line equal, on
the "device" engine (the plain torch lanes of the kernels) and the "host"
engine (the native lanes). The error paths raise the reference's error
types. ``--device`` defaults to cuda and fails without a card rather than
falling back. Tolerance 0.
"""

import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_dicom_codec_tpu.tools import transcode as ref_tc
from go_dicom_codec_torch.tools import transcode as tc

ENGINES = ("device", "host")


def _img(bits=8, h=40, w=56, comps=1, seed=5):
    rng = np.random.default_rng(seed)
    a = np.cumsum(rng.integers(-5, 6, (h, w, comps)), axis=1)
    a = (a % ((1 << bits) - 8) + 4)
    dt = np.uint8 if bits <= 8 else np.dtype("<u2")
    return np.squeeze(a.astype(dt))


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("TRANSCODE|")]
    return json.loads(lines[-1].split("|", 1)[1])


def _both(tmp_path, capsys, name, src, argv, engine):
    """One step through both tools: (port output bytes, its line)."""
    ref_out, out = tmp_path / f"ref_{name}", tmp_path / f"port_{name}"
    assert ref_tc.main([str(src), str(ref_out), *argv]) == 0
    ref_line = _line(capsys.readouterr().out)
    assert tc.main([str(src), str(out), *argv, "--device", "cpu",
                    "--engine", engine]) == 0
    line = _line(capsys.readouterr().out)
    assert out.read_bytes() == ref_out.read_bytes(), name
    assert line == ref_line, name
    return out.read_bytes(), out


def _chain(tmp_path, capsys, img, steps, engine):
    """Run ``steps`` of (target, extra argv) from ``img`` as .npy."""
    cur = tmp_path / "in.npy"
    cur.write_bytes(_npy_bytes(img))
    for i, (target, extra) in enumerate(steps):
        _, cur = _both(tmp_path, capsys, f"step{i}.{target}", cur,
                       ["--to", target, *extra], engine)
    return cur


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("chain", [
    ["jls", "j2k", "p14", "rle", "npy"],
    ["sv1", "htj2k", "jls-near", "npy"],
], ids=["jls-j2k-p14-rle-npy", "sv1-htj2k-jlsnear-npy"])
def test_lossless_chain_matches_reference(tmp_path, capsys, chain, engine):
    img = _img(12, seed=9)
    steps, prev = [], None
    for target in chain:
        extra = ["--near", "0"]
        if prev == "rle":  # RLE carries no geometry of its own
            extra += ["--width", str(img.shape[1]),
                      "--height", str(img.shape[0]), "--bits", "16"]
        steps.append((target, extra))
        prev = target
    out = _chain(tmp_path, capsys, img, steps, engine)
    np.testing.assert_array_equal(np.load(io.BytesIO(out.read_bytes())),
                                  img)


@pytest.mark.parametrize("engine", ENGINES)
def test_container_and_uid_target_match_reference(tmp_path, capsys, engine):
    img = _img(8)
    src = tmp_path / "in.npy"
    src.write_bytes(_npy_bytes(img))
    data, out = _both(tmp_path, capsys, "out.jph", src,
                      ["--to", "1.2.840.10008.1.2.4.201", "--container",
                       "jph"], engine)
    assert data.startswith(tc._jp2_magic())
    back, _ = _both(tmp_path, capsys, "back.npy", out, ["--to", "npy"],
                    engine)
    np.testing.assert_array_equal(np.load(io.BytesIO(back)), img)


@pytest.mark.parametrize("engine", ENGINES)
def test_lossy_chains_match_reference(tmp_path, capsys, engine):
    """Baseline at q95 and extended at 12 bits, then back to .npy; and
    the J2K and HTJ2K lossy targets."""
    for bits, target in ((8, "baseline"), (12, "extended"),
                         (12, "j2k-lossy"), (8, "htj2k-lossy")):
        img = _img(bits, seed=2)
        out = _chain(tmp_path, capsys, img,
                     [(target, ["--quality", "95", "--bits", str(bits)]),
                      ("npy", [])], engine)
        got = np.load(io.BytesIO(out.read_bytes())).astype(int)
        assert np.abs(got - img.astype(int)).max() <= 24 << (bits - 8)


@pytest.mark.parametrize("engine", ENGINES)
def test_raw_inputs_match_reference(tmp_path, capsys, engine):
    """--from raw over RLE-lookalike samples, and signed raw samples
    through JPEG-LS and back to raw."""
    img = _img(12, h=16, w=16, seed=1).astype("<u2")
    img.flat[0], img.flat[1] = 5, 0  # u32le 5 => sniffed as "rle"
    src = tmp_path / "in.raw"
    src.write_bytes(img.tobytes())
    assert tc.sniff(img.tobytes()) == ref_tc.sniff(img.tobytes()) == "rle"
    got, _ = _both(tmp_path, capsys, "out.npy", src,
                   ["--to", "npy", "--from", "raw", "--width", "16",
                    "--height", "16", "--bits", "12"], engine)
    np.testing.assert_array_equal(np.load(io.BytesIO(got)), img)

    signed = (_img(12, seed=8).astype(np.int64) - 2048).astype("<i2")
    src = tmp_path / "signed.raw"
    src.write_bytes(signed.tobytes())
    _, mid = _both(tmp_path, capsys, "m.jls", src,
                   ["--to", "jls", "--from", "raw", "--signed",
                    "--width", str(signed.shape[1]),
                    "--height", str(signed.shape[0]), "--bits", "12"],
                   engine)
    back, _ = _both(tmp_path, capsys, "o.raw", mid, ["--to", "raw"], engine)
    assert back == signed.tobytes()


def _rle_src(tmp_path):
    img = _img(8)
    h, w = img.shape
    src = tmp_path / "in.rle"
    src.write_bytes(tc.encode_any("rle", (img.tobytes(), w, h, 1, 8, False),
                                  device=torch.device("cpu")))
    return src


ERRORS = {
    "rle-without-geometry": (_rle_src, ["--to", "npy"], ValueError, None),
    "container-for-jls": (None, ["--to", "jls", "--container", "jp2"],
                          ValueError, None),
    "baseline-12bit": (None, ["--to", "baseline", "--bits", "12"],
                       ValueError, "8-bit"),
    "extended-16bit": (16, ["--to", "extended"], ValueError, "12-bit"),
    "unknown-target": (None, ["--to", "webp"], ValueError, "unknown target"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_error_paths_raise_reference_types(tmp_path, case):
    make, argv, exc, match = ERRORS[case]
    if callable(make):
        src = make(tmp_path)
    else:
        src = tmp_path / "in.npy"
        src.write_bytes(_npy_bytes(_img(make or 12)))
    with pytest.raises(exc, match=match):
        ref_tc.main([str(src), str(tmp_path / "ref.out"), *argv])
    with pytest.raises(exc, match=match):
        tc.main([str(src), str(tmp_path / "port.out"), *argv, "--device",
                 "cpu"])


def test_sniff_and_aliases_match_reference():
    assert tc.ALIASES == ref_tc.ALIASES
    for data in (b"\x00" * 80, b"\xff\xd8\xff\xc1\x00\x02", b"\x93NUMPY",
                 b"\xff\x4f\xff\x51", tc._jp2_magic() + b"\x00" * 8):
        assert tc.sniff(data) == ref_tc.sniff(data)


def test_cuda_default_never_falls_back(tmp_path, monkeypatch):
    """--device defaults to cuda:0; without a card the tool raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.npy"
    src.write_bytes(_npy_bytes(_img(8)))
    with pytest.raises(RuntimeError, match="no such CUDA device"):
        tc.main([str(src), str(tmp_path / "o.jls"), "--to", "jls"])
