"""The multi-device dry run: the sharded encode step over a mesh, then the
full codec across it, held byte for byte against the single-device lanes.

Counterpart of ``__graft_entry__.dryrun_multichip`` and ``_dryrun_body``
of the JAX package. There the mesh is n virtual CPU devices that a
subprocess forces into being; here the caller names the devices (four CPU
devices in the tests, four shards of one card or every card of a node on
the GPU), so nothing is re-executed.

    from go_dicom_codec_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip([torch.device("cuda", 0)] * 4)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .mesh import (FRAME_AXIS, decode_frames_sharded,
                   encode_frames_sharded, frame_tile_sharding, make_mesh)


def _expect(ok: bool, what: str) -> None:
    """A dry-run check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(f"dry run: {what}")


def dryrun_multichip(devices: Sequence[torch.device]) -> dict:
    """Shard the encode step over a mesh of ``devices`` and run one step,
    then the full codec across the mesh. Raises AssertionError on any
    divergence; returns the step's summary.

    Mesh axes: frames (data parallel) × tiles (spatial parallel within a
    frame), tiles of 2 when the device count is even. Each position runs
    the DWT + code-block stats transform (the fused forward stage's
    ``stats`` epilogue on a CUDA device) on its [f, t, 64, 64] block; the
    int64 sums of every block's code-block bit planes, added up on the
    first device, stand in for the reference's psum over both axes (the
    cross-shard reduction of global rate allocation). Then: sharded gray
    streams equal the pipelined encoder's and decode losslessly; the
    sharded decode reproduces the pixels; multi-tile RGB/RCT streams and
    the packed-header, SOP, EPH, PLT and TLM streams equal the scalar
    encoder's.
    """
    from ..codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                   decode_to_pixels)
    from ..pipeline import (_Lane, encode_frames_pipelined,
                            j2k_lossless_encode_transform)

    devices = [torch.device(d) for d in devices]
    n = len(devices)
    tile_par = 2 if n % 2 == 0 else 1
    mesh = make_mesh(devices, tile_parallel=tile_par)
    first = devices[0]
    F, T, H, W = mesh.shape[FRAME_AXIS] * 2, tile_par * 2, 64, 64

    def step(block):
        f, t = block.shape[0], block.shape[1]
        coeffs, _cb_max, cb_bits = j2k_lossless_encode_transform(
            block.reshape(f * t, H, W), levels=3, bits=16, signed=False,
            cb=32)
        return coeffs.reshape(f, t, H, W), cb_bits.to(torch.int64).sum()

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 1 << 12, size=(F, T, H, W), dtype=np.int32)
    # every block issued through its position's lane before the first read
    blocks = [((fs, ts), _Lane(dev, slots=1).submit(step, frames[fs, ts]))
              for dev, (fs, ts) in frame_tile_sharding(mesh).shards(
                  frames.shape)]
    coeffs = np.zeros((F, T, H, W), dtype=np.int32)
    sums = []
    for (fs, ts), chunk in blocks:
        coeffs[fs, ts], bits = chunk.result()
        sums.append(torch.as_tensor(bits))
    # the cross-shard reduction: every block's sum added on the first device
    total = torch.stack(sums).to(first).sum()
    # the same step unsharded on the first device
    want, want_bits = _Lane(first, slots=1).submit(step, frames).result()
    _expect(np.array_equal(coeffs, want),
            "the sharded transform step diverged from one device's")
    _expect(int(total) == int(want_bits),
            "the cross-shard bit-plane sum diverged from one device's")

    # the FULL codec across the mesh — sharded device transform → host
    # entropy (T1+MQ+T2) → assembled codestreams — must be bit-identical
    # to the single-device encoder, and the streams must decode back to
    # the input pixels
    pix = (np.cumsum(rng.integers(-9, 10, (5, H, W)), axis=2)
           % 4096).astype(np.int32)
    sharded_streams = encode_frames_sharded(pix, bit_depth=12, levels=3,
                                            mesh=mesh)
    scalar_streams = encode_frames_pipelined(pix, bit_depth=12, levels=3,
                                             device=first)
    _expect(sharded_streams == scalar_streams,
            "mesh-sharded encode diverged from scalar codestreams")
    raw = decode_to_pixels(sharded_streams[0], device=first)[0]
    got = np.frombuffer(raw, dtype="<u2").reshape(H, W)
    _expect(np.array_equal(got.astype(np.int64), pix[0].astype(np.int64)),
            "mesh-sharded stream did not decode losslessly")

    # the decode direction across the mesh — host entropy per frame, then
    # the inverse transform split on the mesh — must reproduce the
    # source pixels bit-exactly
    dec_frames = decode_frames_sharded(sharded_streams, mesh=mesh)
    _expect(len(dec_frames) == len(sharded_streams)
            and all(np.array_equal(df[..., 0].astype(np.int64),
                                   p.astype(np.int64))
                    for df, p in zip(dec_frames, pix)),
            "mesh-sharded decode diverged from the source pixels")

    # the wide parameter surface — multi-tile RGB/MCT lossless here —
    # byte-identical to the full scalar encoder
    rgb = rng.integers(0, 256, (mesh.shape[FRAME_AXIS], 48, 40, 3)
                       ).astype(np.int32)
    p_rgb = J2KEncodeParams(num_levels=2, tile_width=24, tile_height=24)
    sharded_rgb = encode_frames_sharded(rgb, bit_depth=8, mesh=mesh,
                                        params=p_rgb)
    enc = J2KEncoder(J2KEncodeParams(num_levels=2, tile_width=24,
                                     tile_height=24), device=first)
    scalar_rgb = [enc.encode(rgb[i], 40, 48, 3, 8)
                  for i in range(rgb.shape[0])]
    _expect(sharded_rgb == scalar_rgb,
            "sharded multi-tile RGB/MCT encode diverged from scalar")

    # the packed-header/resync/pointer marker options shard
    # byte-identically too (they ride the same precomputed-tiles entry
    # into the full scalar header/entropy path)
    p_pk = J2KEncodeParams(num_levels=3, packed_headers=True,
                           use_sop=True, use_eph=True, plt_markers=True,
                           tlm_markers=True)
    sharded_pk = encode_frames_sharded(pix, bit_depth=12, mesh=mesh,
                                       params=p_pk)
    enc_pk = J2KEncoder(p_pk, device=first)
    scalar_pk = [enc_pk.encode(pix[i], W, H, 1, 12)
                 for i in range(pix.shape[0])]
    _expect(sharded_pk == scalar_pk,
            "sharded packed-header encode diverged from scalar")
    return {"mesh": dict(mesh.shape), "devices": [str(d) for d in devices],
            "step": [F, T, H, W], "cb_bits_total": int(total),
            "frames": len(sharded_streams)}
