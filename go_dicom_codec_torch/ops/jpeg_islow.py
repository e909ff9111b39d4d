"""The JPEG codecs' device stage: the integer islow DCT, forward and inverse.

Counterpart of ``go_dicom_codec_tpu/ops/dct8x8.py:177`` and ``:197``
(``encode_plane_to_zigzag``, ``decode_zigzag_to_plane``), which XLA fuses
into one program each. ``fdct_islow`` and ``idct_islow`` launch their
kernel of ``csrc/jpeg_islow.cu`` once for a CUDA tensor and run the plain
version of ``ops/dct8x8.py`` for a CPU tensor (the inverse's several
tables as a loop over planes, ``idct_islow_plain``); any other device
raises. Both give the reference's results bit for bit (int32 wraparound
included).

Quant tables are the codec's host state (64 values in raster order,
numpy or a list; the inverse also takes a stack of them with each plane's
table index). The kernels read them as int32 tensors on the device, and
the forward also each entry's exact reciprocal (``reciprocals``), built,
checked and uploaded once per (table bytes, device), as is an inverse
call's table index.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from .dct8x8 import ZIGZAG, decode_zigzag_to_plane, encode_plane_to_zigzag


def reciprocals(d) -> np.ndarray:
    """[..., 2] int64 for divisors ``d`` (each 8 · 1..65535): {m, s}, with
    which the forward kernel's quantizer divides by d with no divide: for
    n in [0, 2^31), ⌊n / d⌋ = umulhi(n, m) >> s, m = ⌈2^(31+l) / d⌉ <
    2^32 (stored as its int32 bit pattern), l = ⌈log2 d⌉, s = l − 1."""
    d = np.asarray(d, dtype=np.int64)
    lg = np.frexp((d - 1).astype(np.float64))[1].astype(np.int64)  # ⌈log2⌉
    m = -((-(np.int64(1) << (31 + lg))) // d)
    return np.stack([np.where(m >= 1 << 31, m - (1 << 32), m), lg - 1],
                    axis=-1)


@functools.lru_cache(maxsize=256)
def _state(key: bytes, device: torch.device, lo: int, recip: bool):
    q = np.frombuffer(key, dtype=np.int64).reshape(-1, 64)
    if q.min() < lo or q.max() > 65535:
        raise _kernels.KernelLaunchError(
            f"islow DCT: a quant table needs 64 entries in [{lo}, 65535]")
    zz = np.ascontiguousarray(q[:, ZIGZAG])
    tables = torch.tensor(zz, dtype=torch.int32, device=device)
    if not recip:
        return tables, None
    m, s = reciprocals(8 * zz[0]).T
    return tables, torch.tensor(np.stack([m, (4 * zz[0]) << 5 | s], -1),
                                dtype=torch.int32, device=device)


def _tables(qtables, device: torch.device, lo: int, recip: bool = False):
    """(int32 [T, 64] tensor of the host tables ``qtables`` (raster order)
    on ``device`` in zigzag order, and with ``recip`` each zigzag index's
    {m, (d/2) << 5 | s} of the first table as int32 [64, 2], d = 8q and
    {m, s} its ``reciprocals``), after checking that each entry lies in
    [lo, 65535] (a DQT entry's range); built once per (table bytes,
    device)."""
    q = np.asarray(qtables, dtype=np.int64)
    if q.size == 0 or q.size % 64 or (recip and q.size != 64):
        raise _kernels.KernelLaunchError(
            f"islow DCT: quant tables need 64 entries each, got {q.size}")
    return _state(q.tobytes(), device, lo, recip)


@functools.lru_cache(maxsize=256)
def _index(table_index: tuple, n_tables: int, device: torch.device):
    if any(not 0 <= t < n_tables for t in table_index):
        raise ValueError(f"idct_islow: a table index outside [0, "
                         f"{n_tables})")
    if not any(table_index):
        return None
    return torch.tensor(table_index, dtype=torch.int32, device=device)


def plane_dtype(max_val: int) -> torch.dtype:
    """The narrowest dtype of ``_kernels.JPEG_DTYPES`` that holds
    [0, max_val]."""
    return next(dt for dt, top in _kernels.JPEG_MAX.items() if max_val <= top)


def fdct_islow(x: torch.Tensor, qtable, level_shift: int = 128
               ) -> torch.Tensor:
    """[..., H, W] integer samples → [..., ceil(H/8), ceil(W/8), 64] int32
    quantized islow coefficients in zigzag order, the edge replicated to
    whole blocks (``encode_plane_to_zigzag``'s result). ``qtable``: 64
    values in 1..65535."""
    if x.device.type == "cpu":
        return encode_plane_to_zigzag(x, qtable, level_shift)
    if x.device.type != "cuda":
        raise ValueError(f"fdct_islow: no lane for device {x.device}")
    h, w = x.shape[-2], x.shape[-1]
    lead = tuple(x.shape[:-2])
    if x.dtype not in _kernels.JPEG_DTYPES:
        x = x.to(torch.int32)
    src = x.contiguous().view(-1, h, w)
    out = torch.empty((src.shape[0], -(-h // 8), -(-w // 8), 64),
                      dtype=torch.int32, device=x.device)
    _kernels.jpeg_fdct_islow(src, out, _tables(qtable, x.device, 1, True)[1],
                             level_shift)
    return out.view(lead + tuple(out.shape[1:]))


def _plane_index(table_index, planes: int) -> tuple:
    if table_index is None:
        return (0,) * planes
    idx = (table_index if isinstance(table_index, tuple) else
           tuple(int(t) for t in np.asarray(table_index).reshape(-1)))
    if len(idx) != planes:
        raise ValueError(f"idct_islow: {len(idx)} table indices for "
                         f"{planes} planes")
    return idx


def idct_islow_plain(zz: torch.Tensor, qtables, level_shift: int = 128,
                     max_val: int = 255, table_index=None) -> torch.Tensor:
    """The plain version of the inverse kernel's launch over several
    tables: ``decode_zigzag_to_plane`` of the planes of each table in
    turn, plane p with table ``table_index[p]`` of ``qtables`` (int32
    [..., nby*8, nbx*8])."""
    q = np.asarray(qtables).reshape(-1, 64)
    nby, nbx = zz.shape[-3], zz.shape[-2]
    flat = zz.reshape(-1, nby, nbx, 64)
    idx = _plane_index(table_index, flat.shape[0])
    if not any(idx):
        out = decode_zigzag_to_plane(flat, q[0], level_shift, max_val)
    else:
        out = torch.empty((flat.shape[0], nby * 8, nbx * 8),
                          dtype=torch.int32, device=zz.device)
        idx_t = torch.as_tensor(idx, device=zz.device)
        for t in sorted(set(idx)):
            sel = torch.nonzero(idx_t == t).view(-1)
            out[sel] = decode_zigzag_to_plane(flat[sel], q[t], level_shift,
                                              max_val)
    return out.view(tuple(zz.shape[:-3]) + tuple(out.shape[1:]))


def idct_islow(zz: torch.Tensor, qtable, level_shift: int = 128,
               max_val: int = 255, dtype: torch.dtype = torch.int32,
               table_index=None) -> torch.Tensor:
    """[..., nby, nbx, 64] zigzag coefficients → dequant + islow IDCT +
    ``level_shift`` → clamped to [0, max_val], [..., nby*8, nbx*8] of
    ``dtype`` (``decode_zigzag_to_plane``'s values; ``dtype`` must hold
    ``max_val``). ``qtable``: 64 values in 0..65535, or a stack of T such
    tables ([T, 64] or [T, 8, 8]) with ``table_index``, the host's table of
    each [nby, nbx, 64] plane of ``zz`` in order (None: table 0 for every
    plane). On the card one launch of the inverse kernel, reading int16
    coefficients as they are and any other type as int32."""
    if max_val > _kernels.JPEG_MAX.get(dtype, -1):
        raise ValueError(f"idct_islow: max_val {max_val} does not fit "
                         f"{dtype}")
    if zz.device.type == "cpu":
        return idct_islow_plain(zz, qtable, level_shift, max_val,
                                table_index).to(dtype)
    if zz.device.type != "cuda":
        raise ValueError(f"idct_islow: no lane for device {zz.device}")
    nby, nbx = zz.shape[-3], zz.shape[-2]
    lead = tuple(zz.shape[:-3])
    if zz.dtype not in _kernels.JPEG_COEF_DTYPES:
        zz = zz.to(torch.int32)
    src = zz.contiguous().view(-1, nby, nbx, 64)
    if not _kernels.aligned16(src):  # the kernel loads 16 bytes at a time
        src = src.clone()
    tables, _ = _tables(qtable, zz.device, 0)
    index = (None if table_index is None else
             _index(_plane_index(table_index, src.shape[0]),
                    tables.shape[0], zz.device))
    out = torch.empty((src.shape[0], nby * 8, nbx * 8), dtype=dtype,
                      device=zz.device)
    _kernels.jpeg_idct_islow(src, out, tables, level_shift, max_val, index)
    return out.view(lead + tuple(out.shape[1:]))
