"""Device mesh + sharding for frame/tile batches, over torch devices.

Port of ``go_dicom_codec_tpu/parallel/mesh.py``. The reference splits a
frame batch over a ``jax.sharding.Mesh`` of (frames × tiles) and lets XLA
partition one jitted program per device. Here the mesh is an explicit grid
of ``torch.device``s given by the caller (nothing picks a device, so there
is no default of "all devices"; one device may sit at several positions),
and each position's block of frames runs on its device through the same
device stages as the port's single-device lanes:

- encode: per tile, ``codecs.jpeg2000.tile_coeffs_device`` (the scalar
  J2KEncoder's stage over a leading frame axis): DC shift (+ Part-2
  bindings or matrix, or RCT/ICT) then the 5/3 or 9/7. On a CUDA device the
  reversible transform is one launch of ``csrc/j2k_fwd_stage.cu`` per tile
  and shard;
- decode: per tile (or tile-component), the pipelined decode's stage
  (``pipeline._j2k_decode_device_stage`` and ``_97``): the inverse
  transform, inverse RCT/ICT or Part-2 matrices, DC unshift. On a CUDA
  device the reversible stage without Part-2 matrices is one launch of
  ``csrc/j2k_inv_stage.cu`` per tile (or tile-component) and shard.

Each position moves its blocks through a pipeline lane
(``pipeline._Lane``: pinned upload, the stage, pinned readback), and every
shard's work is issued before the first readback, so the devices of a
mesh work at once. The host half (T1/T2, headers, PCRD, quantization) is
the scalar codec's. The reference pads the batch to a multiple of the mesh
size with zero frames and transforms them; the port gives each position
the same contiguous block of the unpadded batch and launches nothing for a
position whose block is empty.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import numpy as np
import torch

FRAME_AXIS = "frames"
TILE_AXIS = "tiles"
AXES = (FRAME_AXIS, TILE_AXIS)


class Mesh:
    """A (frames × tiles) grid of torch devices: ``devices`` is the
    [frames, tiles] object array, ``shape`` maps each axis name to its
    size, as a ``jax.sharding.Mesh`` does."""

    def __init__(self, devices: np.ndarray) -> None:
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"[{', '.join(str(d) for d in self.devices.flat)}])")


class Sharding:
    """Which contiguous block of each leading axis every mesh position
    holds (a ``NamedSharding`` with its ``PartitionSpec``).

    ``spec[d]`` names the mesh axes that split leading axis ``d``: one
    name, a tuple of names (split over their flattened grid, in that
    order) or None (every position holds all of it). Axis ``d`` of length
    n split over k positions gives position i the block
    [i·⌈n/k⌉, (i+1)·⌈n/k⌉) clipped to n, so trailing blocks may be short
    or empty.
    """

    def __init__(self, mesh: Mesh, spec: tuple) -> None:
        self.mesh, self.spec = mesh, spec

    def shards(self, shape) -> List[Tuple[torch.device, Tuple[slice, ...]]]:
        """(device, index) of every mesh position, in row-major order of
        the mesh, for an array of ``shape``."""
        grid = self.mesh.devices.shape
        out = []
        for pos in np.ndindex(grid):
            index = []
            for d, axes in enumerate(self.spec):
                n = shape[d]
                if axes is None:
                    index.append(slice(0, n))
                    continue
                k, count = 0, 1
                for a in ((axes,) if isinstance(axes, str) else axes):
                    i = AXES.index(a)
                    k, count = k * grid[i] + pos[i], count * grid[i]
                b = -(-n // count)
                index.append(slice(min(k * b, n), min((k + 1) * b, n)))
            out.append((self.mesh.devices[pos], tuple(index)))
        return out


def make_mesh(devices: Sequence[torch.device],
              tile_parallel: int = 1) -> Mesh:
    """Mesh over (frames, tiles) of ``devices``, row-major.
    tile_parallel divides the device count. A device may appear more
    than once (two shards on one card serialize on its stream)."""
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if n == 0:
        raise ValueError("make_mesh needs at least one device")
    if tile_parallel < 1 or n % tile_parallel != 0:
        raise ValueError(f"tile_parallel={tile_parallel} must divide {n}")
    for d in devs:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"make_mesh: no lane for device {d}")
    grid = np.empty((n // tile_parallel, tile_parallel), dtype=object)
    for i, d in enumerate(devs):
        grid.flat[i] = d
    return Mesh(grid)


def frame_sharding(mesh: Mesh) -> Sharding:
    """Shard a [F, ...] frame batch over the frame axis."""
    return Sharding(mesh, (FRAME_AXIS,))


def frame_tile_sharding(mesh: Mesh) -> Sharding:
    """Shard a [F, T, ...] frame×tile batch over both mesh axes."""
    return Sharding(mesh, (FRAME_AXIS, TILE_AXIS))


def _flat_sharding(mesh: Mesh) -> Sharding:
    """Shard a [F, ...] batch over the flattened (frames, tiles) grid:
    the block order of the sharded encode and decode."""
    return Sharding(mesh, ((FRAME_AXIS, TILE_AXIS),))


def shard_frames(batch, mesh: Mesh) -> List[torch.Tensor]:
    """Place a [F, ...] batch sharded over frames: one tensor per mesh
    position (row-major), a copy of its block on its device."""
    t = torch.as_tensor(batch)
    return [t[sl].to(dev, copy=True)
            for dev, sl in frame_sharding(mesh).shards(t.shape)]


def pad_batch_to_devices(batch: np.ndarray, n: int) -> Tuple[np.ndarray, int]:
    """Pad the leading dim to a multiple of n; returns (padded, orig_len)."""
    f = batch.shape[0]
    pad = (-f) % n
    if pad:
        batch = np.concatenate([batch, np.zeros((pad,) + batch.shape[1:],
                                                dtype=batch.dtype)], axis=0)
    return batch, f


# ---- issue and gather -------------------------------------------------------

def _compact(a: np.ndarray, unsigned: bool = True) -> np.ndarray:
    """``a`` as uint16 (where ``unsigned`` allows it) or int16 when every
    value fits: half the upload of int32, and the fused stages read both
    (the inverse stage int16 only). Else ``a`` as it is."""
    if a.dtype.itemsize <= 2 or a.size == 0:
        return a
    lo, hi = int(a.min()), int(a.max())
    if unsigned and 0 <= lo and hi <= 65535:
        return a.astype(np.uint16)
    if -32768 <= lo and hi <= 32767:
        return a.astype(np.int16)
    return a


def _run_on_mesh(mesh: Mesh, work) -> List[np.ndarray]:
    """``work``: (batch, stage) pairs, each batch [F, ...] of one frame
    count. Every stage runs over each non-empty block of its batch on the
    flattened mesh, on the block's device, through one pipeline lane per
    position (pinned upload, the stage, pinned readback; see
    pipeline._Lane); all of it is issued before the first readback. Returns
    each stage's output, its blocks in frame order."""
    from ..pipeline import _Lane

    nframes = work[0][0].shape[0]
    chunks = [[] for _ in work]
    for dev, (sl,) in _flat_sharding(mesh).shards((nframes,)):
        if sl.start == sl.stop:
            continue
        lane = _Lane(dev, slots=len(work))
        for pending, (batch, stage) in zip(chunks, work):
            pending.append(lane.submit(stage, batch[sl]))
    return [np.concatenate([c.result()[0] for c in pending])
            for pending in chunks]


# ---- encode -----------------------------------------------------------------

def encode_frames_sharded(frames, bit_depth: int = 16,
                          signed: bool = False, levels: int = 5, *,
                          mesh: Mesh, params=None):
    """Multi-device J2K multi-frame encode over the FULL parameter surface.

    The device stage — DC shift (+RCT/ICT MCT) + multilevel 5/3 or 9/7
    per tile — runs ONCE over the whole batch, split across the mesh's
    flattened (frames, tiles) grid; each device transforms its frame
    block, all at once. The host then runs the FULL scalar encoder
    (headers, T1, PCRD, all progressions/layers) per frame with the
    precomputed per-tile coefficients
    (J2KEncoder.encode(precomputed_tiles=...)) — so multi-tile, RGB/MCT,
    multi-layer, lossy 9/7, HTJ2K, Part-2 custom matrices/bindings,
    ROI, and every marker-surface feature shards.

    Codestreams are byte-identical to the scalar encoder's device lane
    (the same op sequence a tile, and the frame split adds no
    cross-frame math); lossless ones to every lane.

    frames: [F, H, W] grayscale or [F, H, W, C].

    Custom matrices/bindings apply in the batched device stage (same
    order as the scalar transform; they replace RCT/ICT). The ROI mask
    pre-shift applies on the host, post-transform, inside
    encode(precomputed_tiles=...). HTJ2K shards like classic J2K — the
    device transform is the same DWT; only the host block coder
    differs (HT cleanup instead of MQ).
    """
    from ..codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                   quantize_packed)
    from ..codestream import j2k as j2kcs

    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[..., None]
    f, h, w, ncomp = frames.shape

    p = params or J2KEncodeParams(num_levels=levels)
    # ROI needs no exclusion: the mask pre-shift applies on the HOST,
    # post-transform, inside encode(precomputed_tiles=...) —
    # J2KEncoder._roi_shift_coeffs runs on precomputed tiles too.
    nlv = p.clamped_levels(w, h)
    use_mct = p.mct if p.mct is not None else (ncomp == 3)
    if p.mct_matrix is not None or p.mct_bindings:
        use_mct = False    # bindings/custom matrix replace RCT/ICT
        #                    (same override as J2KEncoder.encode)
    lossless = p.lossless
    tw = p.tile_width or w
    th = p.tile_height or h
    siz = j2kcs.SizInfo(xsiz=w, ysiz=h, xtsiz=tw, ytsiz=th,
                        components=[(bit_depth, signed, 1, 1)] * ncomp)
    ntx, nty = siz.num_tiles
    rects = [siz.tile_rect(ti, tj)
             for tj in range(nty) for ti in range(ntx)]

    tile_batches = sharded_tile_coeffs(
        frames, rects, nlv, bit_depth, signed, use_mct, ncomp, lossless,
        mesh, mct_bindings=p.mct_bindings, mct_matrix=p.mct_matrix,
        mct_offsets=p.mct_offsets)

    enc = J2KEncoder(p, device=None)
    if not lossless:
        # the scalar device lane's numpy deadzone quant, over every frame
        band_steps = enc._band_deltas(
            enc._build_qcd(nlv, bit_depth, use_mct, ncomp), nlv, bit_depth)
        tile_batches = [quantize_packed(tb, rect, nlv, band_steps)
                        for tb, rect in zip(tile_batches, rects)]
    return [enc.encode(frames[k], w, h, ncomp, bit_depth, signed,
                       precomputed_tiles=[tb[k] for tb in tile_batches])
            for k in range(f)]


def sharded_tile_coeffs(frames, rects, nlv, bit_depth, signed, use_mct,
                        ncomp, lossless, mesh, mct_bindings=None,
                        mct_matrix=None, mct_offsets=None):
    """The sharded device stage: per-tile DC shift (+MCT) + DWT over a
    [F, H, W, C] frame batch split on the flattened mesh. Returns one
    [F, C, th, tw] array per tile (int32 for 5/3, float32 pre-quant for
    9/7).

    Each block runs the op sequence of the scalar
    J2KEncoder._tile_coeffs_device over [f, C, th, tw], all elementwise
    across frames, so every result is bitwise identical to that lane:
    the integer (lossless, no float MCT) ones to every lane, the 9/7 and
    Part-2 float ones to the port's scalar device lane (the reference's
    jitted programs may differ from both by an ulp, see its
    sharded_tile_coeffs). On a CUDA device the transform of a tile is one
    launch of the fused forward stage, the 5/3's or the 9/7's."""
    from ..codecs.jpeg2000 import tile_coeffs_device

    frames = _compact(np.asarray(frames))
    return _run_on_mesh(mesh, [
        (np.moveaxis(frames[:, ty0:ty1, tx0:tx1, :], -1, 1),
         partial(tile_coeffs_device, x0=tx0, y0=ty0, levels=nlv,
                 bit_depth=bit_depth, signed=signed, use_mct=use_mct,
                 lossless=lossless, mct_bindings=mct_bindings,
                 mct_matrix=mct_matrix, mct_offsets=mct_offsets))
        for (tx0, ty0, tx1, ty1) in rects])


# ---- decode -----------------------------------------------------------------

def _inverse_stage(transform: int, levels: int, x0: int, y0: int, bits: int,
                   signed: bool, mct: bool, mct_inv=(), narrow=True):
    """The pipelined decode's device stage of one tile(-component):
    inverse 5/3 or 9/7, inverse RCT/ICT or the Part-2 inverse matrices, DC
    unshift (one launch of the fused inverse stage, the 5/3's or the 9/7's,
    on a CUDA device unless Part-2 matrices follow it); with ``narrow``
    (samples of 16 bits or fewer) clipped to the declared range and read
    back as 16-bit. The clip is the identity for a full reversible decode
    without Part-2 matrices and the pipeline's policy for a lossy one; a
    caller whose reversible samples may leave the range passes
    ``narrow=False``."""
    from ..pipeline import (_j2k_decode_device_stage,
                            _j2k_decode_device_stage_97)

    stage = (_j2k_decode_device_stage if transform == 1
             else _j2k_decode_device_stage_97)
    return partial(stage, levels=levels, x0=x0, y0=y0, bits=bits,
                   signed=signed, mct=mct, narrow=narrow and bits <= 16,
                   mct_inv=mct_inv)


def _clip_wide(rec: np.ndarray, transform: int, bits: int,
               signed: bool) -> np.ndarray:
    """A lossy reconstruction of more than 16 bits, which the stage does
    not narrow, clipped to the declared range on the host."""
    if transform == 1 or bits <= 16:
        return rec
    lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
              else (0, (1 << bits) - 1))
    return np.clip(rec, lo, hi)


def decode_frames_sharded(streams, *, mesh: Mesh, reduce: int = 0):
    """Multi-device J2K multi-frame DECODE (the scale-out mirror of
    encode_frames_sharded).

    The host entropy-decodes each stream (T2 + T1) to per-tile packed
    subband coefficients (codecs.jpeg2000.decode_to_packed_tiles;
    irreversible streams also dequantize per band on the host), then
    PER TILE the inverse transform — inverse 5/3 or 9/7 + inverse
    RCT/ICT + DC unshift — runs over the whole frame batch split on the
    mesh, each device inverting its block, every tile and block issued
    before the first readback. Reversible pixels are bit-identical to
    J2KDecoder.decode per frame (all-integer math; on a CUDA device one
    launch of the fused inverse stage a tile and block); irreversible
    pixels come back clipped to the declared range and match within ±1.

    Part-2 custom MCT streams shard too — the batched stage applies
    the marker-carried inverse matrices (reverse MCO order) like the
    scalar decoder. Heterogeneous streams — XRsiz/YRsiz-subsampled
    components, per-component COD/QCD (COC/QCC), per-tile overrides —
    shard through the per-component path (_decode_frames_sharded_hetero).
    Requires streams of equal geometry (same SIZ/COD/QCD/COC/QCC/MCT and
    tile grid); raises UnsupportedFormatError otherwise. ROI streams of
    both styles shard — the unshift runs on the packed host
    coefficients. Returns [H, W, C] int32 arrays.
    """
    from ..codecs.j2k_geometry import ceil_div
    from ..codecs.jpeg2000 import (J2KEncoder, decode_to_packed_tiles,
                                   dequantize_packed)
    from ..errors import UnsupportedFormatError

    if not streams:
        return []
    packs, meta, qcd0, mct_inv = [], None, None, None
    for s in streams:
        try:
            tiles, siz, cod, qcd, minv = decode_to_packed_tiles(
                s, reduce=reduce)
        except UnsupportedFormatError:
            if meta is not None or reduce:
                raise  # mixed batch / reduce on a heterogeneous stream
            return _decode_frames_sharded_hetero(streams, mesh)
        mkey = tuple((tuple(ids), inv.tobytes(),
                      offs.tobytes() if offs is not None else None)
                     for (ids, inv, offs) in minv)
        m = ([(r, p.shape) for (r, p) in tiles], cod.num_levels - reduce,
             tuple(ceil_div(v, 1 << reduce)
                   for v in (siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz)),
             siz.components[0][:2], cod.mct, cod.transform, qcd, mkey)
        if meta is None:
            meta, qcd0, mct_inv = m, qcd, minv
        elif m != meta:
            raise UnsupportedFormatError(
                "sharded decode needs equal-geometry streams")
        packs.append(tiles)
    (tile_shapes, levels, (xs, ys, xos, yos), (bits, signed), mct,
     transform, _, _) = meta
    nframes = len(packs)

    # deltas build over the FULL level count (band indices are a
    # prefix-stable subset under reduce)
    deltas = (J2KEncoder._band_deltas(qcd0, levels + reduce, bits)
              if transform != 1 else None)
    height, width = ys - yos, xs - xos
    ncomp = tile_shapes[0][1][0]
    out = np.zeros((nframes, height, width, ncomp), dtype=np.int32)
    # a reversible decode keeps the unclipped int32 readback where it can
    # leave the declared range as J2KDecoder's does: a reduced decode's LL
    # (lowpass ringing) and a float Part-2 inverse matrix
    narrow = (reduce == 0 and not mct_inv) or transform != 1

    work = []
    for t, (rect, _shape) in enumerate(tile_shapes):
        batch = np.stack([packs[f][t][1] for f in range(nframes)])
        if transform != 1:
            # per-band host dequantization with the QCD steps (shared
            # helper with the scalar decoder)
            batch = dequantize_packed(batch, rect, levels, deltas)
        else:
            batch = _compact(batch, unsigned=False)
        work.append((batch, _inverse_stage(
            transform, levels, rect[0], rect[1], bits, signed, bool(mct),
            mct_inv, narrow)))
    for (tx0, ty0, tx1, ty1), rec in zip(
            (r for r, _ in tile_shapes), _run_on_mesh(mesh, work)):
        out[:, ty0 - yos:ty1 - yos, tx0 - xos:tx1 - xos, :] = \
            np.moveaxis(_clip_wide(rec, transform, bits, signed), 1, -1)
    return [out[k] for k in range(nframes)]


def _decode_frames_sharded_hetero(streams, mesh: Mesh):
    """decode_frames_sharded for HETEROGENEOUS streams (subsampled
    components, COC/QCC per-component overrides, per-tile COD/QCD):
    the host entropy-decodes each component onto its own ceil-divided
    grid (codecs.jpeg2000.decode_to_component_tiles), then PER
    TILE-COMPONENT that component's inverse transform (its own levels and
    5/3-or-9/7 choice; QCC streams dequantize per component on the host
    first) runs over the frame batch split on the mesh. No
    cross-component math — mirroring the scalar decoder's heterogeneous
    branch, where MCT is undefined across mixed grids/transforms and
    components reconstruct independently (jpeg2000._decode_tile) —
    then subsampled components upsample to the tile grid by sample
    replication on the host. Tiles that ARE homogeneous in the scalar
    sense (uniform component grids, one transform/levels across
    components — e.g. per-tile-COD streams that differ only in
    progression) take a whole-tile MCT stage instead, applying the
    inverse RCT/ICT exactly like jpeg2000._decode_tile's homogeneous
    branch. Reversible components are bit-identical to
    J2KDecoder.decode; irreversible ones clip to the declared range
    (same policy as the uniform sharded path). T.800 B.3 empty
    tile-components contribute a DC-unshifted zero plane, like the
    scalar decoder."""
    from ..codecs.jpeg2000 import (J2KEncoder, decode_to_component_tiles,
                                   dequantize_packed)
    from ..errors import UnsupportedFormatError

    packs, meta, first = [], None, None
    for s in streams:
        tiles, siz = decode_to_component_tiles(s)
        m = ((siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz),
             siz.components,
             tuple((rect, tuple(crs), tuple(cods), tuple(qcds))
                   for (rect, crs, _pk, cods, qcds) in tiles))
        if meta is None:
            meta, first = m, tiles
        elif m != meta:
            raise UnsupportedFormatError(
                "sharded decode needs equal-geometry streams")
        packs.append(tiles)

    (xs, ys, xos, yos), components, _ = meta
    bits, signed = components[0][:2]
    nframes = len(packs)
    height, width = ys - yos, xs - xos
    ncomp = len(components)
    fill = 0 if signed else (1 << (bits - 1))
    out = np.full((nframes, height, width, ncomp), fill, dtype=np.int32)

    def batch_of(t, c, rect, cod_c, qcd_c):
        pb = np.stack([packs[f][t][2][c] for f in range(nframes)])
        if cod_c.transform != 1:
            return dequantize_packed(
                pb, rect, cod_c.num_levels,
                J2KEncoder._band_deltas(qcd_c, cod_c.num_levels, bits))
        return _compact(pb, unsigned=False)

    # every tile(-component) stage is issued before the first readback;
    # keys: (tile index, component or None for the whole tile, transform)
    keys, work = [], []
    for t, (rect, comp_rects, _pk, cods, qcds) in enumerate(first):
        cod_t = cods[0]
        homog = (all(tuple(cr) == tuple(rect) for cr in comp_rects)
                 and all(cc.transform == cod_t.transform
                         and cc.num_levels == cod_t.num_levels
                         for cc in cods))
        if homog and cod_t.mct == 1 and ncomp >= 3:
            # whole-tile stage with inverse RCT/ICT — the batched mirror
            # of the scalar decoder's homogeneous branch (it applies MCT
            # whenever the tile's component grids and transform/levels
            # agree, even when the stream as a whole is heterogeneous,
            # e.g. a per-tile COD override)
            keys.append((t, None, cod_t.transform))
            work.append((np.stack([batch_of(t, c, rect, cod_t, qcds[c])
                                   for c in range(ncomp)], axis=1),
                         _inverse_stage(cod_t.transform, cod_t.num_levels,
                                        rect[0], rect[1], bits, signed,
                                        True)))
            continue
        for c in range(ncomp):
            cx0, cy0, cx1, cy1 = comp_rects[c]
            if cy1 == cy0 or cx1 == cx0:
                continue    # out prefilled with the unshifted zero plane
            keys.append((t, c, cods[c].transform))
            work.append((batch_of(t, c, comp_rects[c], cods[c], qcds[c]),
                         _inverse_stage(cods[c].transform,
                                        cods[c].num_levels, cx0, cy0, bits,
                                        signed, False)))
    for (t, c, transform), rec in zip(
            keys, _run_on_mesh(mesh, work) if work else ()):
        tx0, ty0, tx1, ty1 = first[t][0]
        th, tw = ty1 - ty0, tx1 - tx0
        rec = _clip_wide(rec, transform, bits, signed)
        win = (slice(None), slice(ty0 - yos, ty1 - yos),
               slice(tx0 - xos, tx1 - xos))
        if c is None:
            out[win] = np.moveaxis(rec, 1, -1)
            continue
        cth, ctw = rec.shape[1], rec.shape[2]
        if (cth, ctw) != (th, tw):
            # replication upsample (reference tile_decoder.go
            # sample-replication interleave; scalar _decode_tile)
            ry = -(-th // cth)
            rx = -(-tw // ctw)
            rec = np.repeat(np.repeat(rec, ry, axis=1), rx, axis=2)
            rec = rec[:, :th, :tw]
        out[win + (c,)] = rec
    return [out[k] for k in range(nframes)]
