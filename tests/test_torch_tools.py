"""Port parity: ``tools/benchmarks.py``, ``tools/perf_check.py``,
``tools/foreign_ab.py``, the device bench's 9/7 and color rows and the
``torch_trace`` hook, on the CPU.

``bench_codec`` through ``make_registry(cpu, engine)`` must give the
reference's compression ratio for every lossless UID at 64² (so the
streams have the reference's sizes) and decode them exactly; the pipeline
row's pipelined streams equal the per-frame encoder's. The perf gate pins
into the port's own file, records the card, and fails against a pin of
another card. The four device-bench steps match the reference's ops
(op by op, as tests/test_torch_dwt97.py compares them) within its 9/7
tolerance, |Δ| ≤ 0.005; the integer RCT exactly. ``foreign_ab`` runs
one round at 64² where PIL is installed, and ``torch_trace`` writes a
Chrome trace.
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import go_dicom_codec_tpu as ref
from go_dicom_codec_tpu.codecs import j2k_quant as ref_quant
from go_dicom_codec_tpu.ops import dwt97 as ref_dwt97
from go_dicom_codec_tpu.ops import mct as ref_mct
from go_dicom_codec_tpu.tools import benchmarks as ref_benchmarks
from go_dicom_codec_torch.tools import benchmarks, device_bench, perf_check
from go_dicom_codec_torch.utils import profiling

CPU = torch.device("cpu")
U = ref.uids
LOSSLESS = (U.RLE_LOSSLESS, U.JPEG_LOSSLESS_P14, U.JPEG_LOSSLESS_SV1,
            U.JPEG_LS_LOSSLESS, U.JPEG_2000_LOSSLESS,
            U.JPEG_2000_MC_LOSSLESS, U.HTJ2K_LOSSLESS,
            U.HTJ2K_LOSSLESS_RPCL)
TOL_97 = 0.005


@pytest.mark.parametrize("engine", ("device", "host"))
@pytest.mark.parametrize("uid", LOSSLESS)
def test_bench_codec_ratio_matches_reference(uid, engine):
    want = ref_benchmarks.bench_codec(uid, 64, 1, 1)
    got = benchmarks.bench_codec(uid, 64, 1, 1, device=CPU, engine=engine)
    assert got["ratio"] == want["ratio"] and got["name"] == want["name"]
    assert got["lossless_exact"] is True


def test_reference_rows_kept():
    assert benchmarks.REFERENCE_MS == ref_benchmarks.REFERENCE_MS
    np.testing.assert_array_equal(benchmarks._synth_frame(40, 12, 3),
                                  ref_benchmarks._synth_frame(40, 12, 3))


def test_pipeline_row_and_main_lines(capsys):
    row = benchmarks.bench_j2k_pipeline(64, 2, 1, device=CPU,
                                        engine="device")
    assert row["metric"] == "j2k_pipeline_vs_scalar"
    assert row["card"] == "cpu" and row["engine"] == "device"
    assert benchmarks.main(["--device", "cpu", "--size", "32", "--frames",
                            "1", "--repeats", "1", "--uids",
                            f"{U.RLE_LOSSLESS},{U.JPEG_BASELINE_8BIT}"]) == 0
    lines = [json.loads(ln.split("|", 1)[1])
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("BENCH|")]
    assert [r["uid"] for r in lines] == [U.RLE_LOSSLESS,
                                         U.JPEG_BASELINE_8BIT]
    assert all(r["card"] == "cpu" and r["engine"] == "auto" for r in lines)


def test_perf_check_pins_inside_the_port_and_names_the_card(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    port_dir = os.path.dirname(os.path.dirname(perf_check.__file__))
    assert os.path.commonpath([perf_check.REF_PATH, port_dir]) == port_dir
    pin = tmp_path / "pin.json"
    monkeypatch.setattr(perf_check, "REF_PATH", str(pin))
    argv = ["--device", "cpu", "--size", "16"]
    assert perf_check.main(argv + ["--update"]) == 0
    cur = json.loads(pin.read_text())
    assert cur["card"] == "cpu" and len(cur["codecs"]) == 14
    # a pin of another card fails, whatever the times say
    cur["card"] = "NVIDIA H100 80GB HBM3, 700.00 W"
    pin.write_text(json.dumps(cur))
    capsys.readouterr()
    assert perf_check.main(argv) == 1
    assert "PERF|fail|the pin was taken on" in capsys.readouterr().out


def test_perf_ab_gate(monkeypatch, capsys):
    def fake(path, size, device, engine):
        slow = 2.0 if path.endswith("slow") else 1.0
        return {"codecs": {"u": {"name": "codec", "encode_ms": slow,
                                 "decode_ms": 1.0}}}

    monkeypatch.setattr(perf_check, "_measure_checkout", fake)
    assert perf_check.ab_gate("/base", 16, CPU) == 0
    monkeypatch.setattr(perf_check, "_measure_checkout",
                        lambda p, *a: fake(p if "/base" in p else p + "slow",
                                           *a))
    assert perf_check.ab_gate("/base", 16, CPU) == 1
    assert "PERF|fail|codec: encode_ms" in capsys.readouterr().out


def test_foreign_ab_one_round(capsys):
    pytest.importorskip("PIL")
    from go_dicom_codec_torch.tools import foreign_ab

    assert foreign_ab.main(["--size", "64", "--rounds", "1", "--device",
                            "cpu", "--engine", "device"]) == 0
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("AB|")]
    assert len(rows) == 6


@pytest.fixture(scope="module")
def frames():
    x = np.random.default_rng(0).integers(0, 1 << 12, (2, 37, 29),
                                          dtype=np.int32)
    return x, x.astype(np.float32)


def test_dwt97_rows_match_reference(frames):
    x, xf = frames
    step = np.float32(ref_quant.step_sizes_97(5, 85)[0] * 4096)
    assert device_bench.STEP_97 == float(step)
    c = ref_dwt97.fwd97_multilevel(jnp.asarray(xf), 5)
    want = np.asarray(jnp.sign(c) * jnp.floor(jnp.abs(c) / step))
    got = device_bench.dwt97_deadzone_quant(torch.as_tensor(xf))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_97)
    want = np.asarray(ref_dwt97.inv97_multilevel(jnp.asarray(want) * step,
                                                 5))
    got = device_bench.idwt97_dequant(got)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_97)


def test_color_rows_match_reference(frames):
    x, xf = frames
    xj = jnp.asarray(x)
    for g, w in zip(device_bench.rct_step(torch.as_tensor(x)),
                    ref_mct.rct_forward(xj, xj + 1, xj + 2)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    xj = jnp.asarray(xf)
    for g, w in zip(device_bench.ict_step(torch.as_tensor(xf)),
                    ref_mct.ict_forward(xj, xj + 1.0, xj + 2.0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL_97)


def test_plain_rows_listed():
    steps = device_bench._plain_steps(torch.zeros((1, 16, 16),
                                                  dtype=torch.int32))
    assert sorted(steps) == ["dwt97_deadzone_quant", "ict_forward",
                             "idwt97_dequant", "rct_forward"]
    assert all(list(lanes) == ["plain"] for lanes in steps.values())


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with profiling.torch_trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
