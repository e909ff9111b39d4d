"""The port imports and runs where jax cannot be imported.

The machine with the GPU has no jax, and any module of the JAX package
imports jax through the package's __init__. So the port, its device bench
and chip_smoke.py must import neither, even transitively. A subprocess
blocks ``jax`` before anything is imported and runs the CPU slice once:
the device stages, the device bench, and encode and decode through the
port's codec registry.
"""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError

import numpy as np
import torch

import chip_smoke  # noqa: F401  (imports only; main() needs a GPU)
from go_dicom_codec_torch import pipeline as P
from go_dicom_codec_torch.ops.dct8x8 import LUMA_QUANT, scale_quant_table
from go_dicom_codec_torch.ops.fdct8x8_quant import encode_plane_blocks
from go_dicom_codec_torch.tools import device_bench

rng = np.random.default_rng(7)
gray = torch.as_tensor(rng.integers(0, 4096, (2, 40, 56), dtype=np.int32))
stage = P._pipeline_device_stage(gray, 12, False, 5, narrow=True)
host = P.fetch_coeffs(stage, gray, 12, False, 5)
px = P._j2k_decode_device_stage(torch.as_tensor(host)[:, None], 5, 0, 0, 12,
                                False, mct=False, narrow=True)
assert torch.equal(px[:, 0].to(torch.int32), gray)

rgb = torch.as_tensor(rng.integers(0, 256, (1, 3, 24, 40), dtype=np.int32))
coeffs, _, bits = P.j2k_rgb_lossless_encode_transform(rgb, 3, 8)
px = P._j2k_decode_device_stage(coeffs, 3, 0, 0, 8, False, mct=True)
assert torch.equal(px, rgb) and bits.shape == (1, 3, 1, 1)

q = scale_quant_table(LUMA_QUANT, 90, 255)
assert encode_plane_blocks(gray[0], q, 2048).shape == (5, 7, 8, 8)
q8, _ = device_bench.dwt53_stats(gray, "plain")
assert device_bench.idwt53(q8, "plain").shape == gray.shape

# the codec path: 3 frames through the port's own registry, .90 and .91
import go_dicom_codec_torch as gdc
registry = gdc.make_registry(torch.device("cpu"))
info = gdc.FrameInfo(width=40, height=24, bits_allocated=16, bits_stored=12)
frames = (np.cumsum(rng.integers(-9, 10, (3, 24, 40)), axis=2) % 4096)
for uid in (gdc.uids.JPEG_2000_LOSSLESS, gdc.uids.JPEG_2000_LOSSY):
    src = gdc.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype("<u2").tobytes())
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    registry.get_codec(uid).encode(src, enc)
    dec = gdc.MemoryPixelData(info=info)
    registry.get_codec(uid).decode(enc, dec)
    for i, f in enumerate(frames):
        got = np.frombuffer(dec.get_frame(i), "<u2").astype(np.int64)
        tol = 0 if uid == gdc.uids.JPEG_2000_LOSSLESS else 64
        assert np.abs(got - f.reshape(-1)).max() <= tol, uid

bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith(("jax.", "jaxlib", "go_dicom_codec_tpu"))))
assert not bad, bad
print("no-jax slice ok")
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no-jax slice ok" in proc.stdout
