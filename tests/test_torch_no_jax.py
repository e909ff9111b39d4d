"""The port imports and runs where jax cannot be imported.

The machine with the GPU has no jax, and any module of the JAX package
imports jax through the package's __init__. So the port, its device bench
and chip_smoke.py must import neither, even transitively. A subprocess
blocks ``jax`` before anything is imported and runs the CPU slice once:
the device stages (the encode stages, the decode stage and the inverse
stage under it), the device bench, encode and decode through the port's
codec registry (.90, .91, .80, .70, .201 and .5 on both engines, .50 and
.51 on the device engine, with the islow stages under them), a 2-shard
sharded encode and decode (parallel/mesh.py), the tools (5 fuzz trials,
the .npy → j2k → htj2k → jls → npy transcode chain, the clinical .90
interop row in process) and the port bench at a tiny size.
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
from go_dicom_codec_torch.ops.j2k_inv_stage import inv_stage
px = inv_stage(torch.as_tensor(host).to(torch.int16), 5, bits=12,
               epilogue="narrow")
assert px.dtype == torch.uint16 and torch.equal(px.to(torch.int32), gray)

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

# the codecs of the other families, on both RLE engines
for uid, engine in ((gdc.uids.JPEG_LS_LOSSLESS, "auto"),
                    (gdc.uids.JPEG_LOSSLESS_SV1, "auto"),
                    (gdc.uids.HTJ2K_LOSSLESS, "auto"),
                    (gdc.uids.RLE_LOSSLESS, "device"),
                    (gdc.uids.RLE_LOSSLESS, "host")):
    src = gdc.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype("<u2").tobytes())
    codec = gdc.make_registry(torch.device("cpu"), engine).get_codec(uid)
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = gdc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert [dec.get_frame(i) for i in range(3)] == \
        [src.get_frame(i) for i in range(3)], uid

# JPEG baseline and extended: the islow stages, and encode and decode on
# the device engine (the pipelined encode and the islow inverse)
from go_dicom_codec_torch.codecs import jpeg_progressive  # noqa: F401
from go_dicom_codec_torch.ops.jpeg_islow import fdct_islow, idct_islow
zz = fdct_islow(gray.to(torch.uint16), q, 2048)
assert zz.shape == (2, 5, 7, 64)
assert idct_islow(zz, q, 2048, 4095).shape == (2, 40, 56)
for uid, bits in ((gdc.uids.JPEG_BASELINE_8BIT, 8),
                  (gdc.uids.JPEG_EXTENDED_12BIT, 12)):
    info = gdc.FrameInfo(width=40, height=24,
                         bits_allocated=8 if bits == 8 else 16,
                         bits_stored=bits)
    dt = np.uint8 if bits == 8 else np.dtype("<u2")
    src = gdc.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame((f >> (12 - bits)).astype(dt).tobytes())
    codec = gdc.make_registry(torch.device("cpu"), "device").get_codec(uid)
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = gdc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    for i in range(3):
        got = np.frombuffer(dec.get_frame(i), dt).astype(np.int64)
        want = np.frombuffer(src.get_frame(i), dt).astype(np.int64)
        assert np.abs(got - want).max() <= (1 << bits) // 16, uid

# the sharded encode and decode over a mesh of two CPU shards
from go_dicom_codec_torch.parallel import (decode_frames_sharded,
                                           encode_frames_sharded, make_mesh)
mesh = make_mesh([torch.device("cpu")] * 2)
streams = encode_frames_sharded(frames, bit_depth=12, levels=3, mesh=mesh)
assert len(streams) == 3
got = decode_frames_sharded(streams, mesh=mesh)
assert all(np.array_equal(g[..., 0], f) for g, f in zip(got, frames))

# the tools: 5 fuzz trials, one transcode chain, one interop row in
# process
import contextlib, io, os, tempfile
from go_dicom_codec_torch.tools import fuzz, interop, transcode
with contextlib.redirect_stdout(io.StringIO()):
    assert fuzz.main(["--trials", "5", "--device", "cpu",
                      "--engine", "device"]) == 0
with tempfile.TemporaryDirectory() as tmp:
    buf = io.BytesIO()
    np.save(buf, frames[0].astype("<u2"))
    cur = os.path.join(tmp, "in.npy")
    open(cur, "wb").write(buf.getvalue())
    for i, target in enumerate(("j2k", "htj2k", "jls", "npy")):
        nxt = os.path.join(tmp, f"{i}.{target}")
        with contextlib.redirect_stdout(io.StringIO()):
            assert transcode.main([cur, nxt, "--to", target, "--bits", "12",
                                   "--device", "cpu"]) == 0
        cur = nxt
    back = np.load(io.BytesIO(open(cur, "rb").read()))
    assert np.array_equal(back, frames[0])
row = interop.FORMAT_DEFINITIONS[8]
ok = interop.run_format(row + (96, 80, 7, "self", "clinical", None, "cpu",
                               "device"))
assert ok[1] and ok[0] == "jpeg2000-lossless", ok

# the port bench at a tiny size
from go_dicom_codec_torch.tools import bench
line = bench.main(batch=2, height=64, width=64, iters=2,
                  device=torch.device("cpu"))
assert line["metric"] == "j2k_dwt53_quant_stats_encode_throughput"
fn, args = bench.entry(torch.device("cpu"))
assert fn(args[0][:1, :64, :64])[0].shape == (1, 64, 64)

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
