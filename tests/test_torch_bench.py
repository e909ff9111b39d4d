"""Port parity: the port bench's chains against the root ``bench.py``'s.

``go_dicom_codec_torch/tools/bench.py`` chains the encode, decode and x+1
steps of ``bench.py:47-98`` in torch int32. After ``ITERS`` steps on the
CPU each chain's carried tensor and accumulator must equal the reference
chain's under jax on the CPU (``bench.ITERS`` and the shapes set through
``monkeypatch``), wraparound of ``|c| * 32768`` included.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import bench as ref_bench
from go_dicom_codec_torch.tools import bench as port_bench

CPU = torch.device("cpu")
REF_CHAINS = {"encode": "_chained_encode", "decode": "_chained_decode",
              "copy": "_chained_copy"}


@pytest.mark.parametrize("name", list(REF_CHAINS))
@pytest.mark.parametrize("top", [1 << 12, 1 << 16])
def test_chain_matches_reference(name, top, monkeypatch):
    """BATCH=2, 32×32, ITERS=3 of 12-bit samples (bench.py's input) and of
    16-bit samples, whose first encode step already has |c| ≥ 65536, so
    that ``|c| * 32768`` wraps."""
    iters = 3
    monkeypatch.setattr(ref_bench, "ITERS", iters)
    monkeypatch.setattr(ref_bench, "BATCH", 2)
    monkeypatch.setattr(ref_bench, "H", 32)
    monkeypatch.setattr(ref_bench, "W", 32)
    x = np.random.default_rng(0).integers(0, top, (2, 32, 32),
                                          dtype=np.int32)
    fn = getattr(ref_bench, REF_CHAINS[name])
    want = jax.jit(lambda v: fn(v))(jnp.asarray(x))
    got = port_bench.chain(port_bench.STEPS[name], torch.as_tensor(x), iters)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1])
    if name == "encode" and top == 1 << 16:
        c = port_bench.fwd_stage(torch.as_tensor(x), port_bench.SHIFT,
                                 port_bench.LEVELS)
        assert int(c.abs().max()) >= 65536


def test_main_prints_bench_fields(capsys):
    result = port_bench.main(batch=2, height=32, width=32, iters=2,
                             device=CPU)
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line == result
    for key in ("metric", "value", "unit", "vs_baseline", "decode_value",
                "decode_pct_of_ceiling", "encode_pct_of_ceiling"):
        assert key in line
    assert line["metric"] == "j2k_dwt53_quant_stats_encode_throughput"
    assert line["device"] == "cpu" and line["gpu"] is None
    assert line["vs_baseline"] == pytest.approx(line["value"] / 224.0)


def test_entry_on_the_cpu():
    fn, args = port_bench.entry(CPU)
    assert callable(fn) and len(args) == 1
    assert args[0].device == CPU and tuple(args[0].shape) == (8, 512, 512)
    assert args[0].dtype == torch.int32
    coeffs, cb_max, bits = fn(args[0][:1, :64, :64])
    assert tuple(coeffs.shape) == (1, 64, 64)
    assert tuple(bits.shape) == (1, 1, 1)
