"""The JPEG codecs' device stage: the integer islow DCT, forward and inverse.

Counterpart of ``go_dicom_codec_tpu/ops/dct8x8.py:177`` and ``:197``
(``encode_plane_to_zigzag``, ``decode_zigzag_to_plane``), which XLA fuses
into one program each. ``fdct_islow`` and ``idct_islow`` launch their
kernel of ``csrc/jpeg_islow.cu`` once for a CUDA tensor and run the plain
version of ``ops/dct8x8.py`` for a CPU tensor; any other device raises.
Both give the reference's results bit for bit (int32 wraparound
included).

Quant tables are the codec's host state (64 values in raster order,
numpy or a list); the kernels read them as int32 tensors on the device,
uploaded once per table and device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from .dct8x8 import decode_zigzag_to_plane, encode_plane_to_zigzag


@functools.lru_cache(maxsize=64)
def _device_table(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


def _table(qtable, device: torch.device, lo: int) -> torch.Tensor:
    """The 64 host values of ``qtable`` as an int32 tensor on ``device``,
    after checking that each lies in [lo, 65535] (a DQT entry's range)."""
    q = np.asarray(qtable, dtype=np.int64).reshape(-1)
    if q.size != 64 or q.min() < lo or q.max() > 65535:
        raise _kernels.KernelLaunchError(
            f"islow DCT: a quant table needs 64 entries in [{lo}, 65535]")
    return _device_table(tuple(int(v) for v in q), device)


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
    _kernels.jpeg_fdct_islow(src, out, _table(qtable, x.device, 1),
                             level_shift)
    return out.view(lead + tuple(out.shape[1:]))


def idct_islow(zz: torch.Tensor, qtable, level_shift: int = 128,
               max_val: int = 255, dtype: torch.dtype = torch.int32
               ) -> torch.Tensor:
    """[..., nby, nbx, 64] zigzag coefficients → dequant + islow IDCT +
    ``level_shift`` → clamped to [0, max_val], [..., nby*8, nbx*8] of
    ``dtype`` (``decode_zigzag_to_plane``'s values; ``dtype`` must hold
    ``max_val``). ``qtable``: 64 values in 0..65535."""
    if max_val > _kernels.JPEG_MAX.get(dtype, -1):
        raise ValueError(f"idct_islow: max_val {max_val} does not fit "
                         f"{dtype}")
    if zz.device.type == "cpu":
        return decode_zigzag_to_plane(zz, qtable, level_shift,
                                      max_val).to(dtype)
    if zz.device.type != "cuda":
        raise ValueError(f"idct_islow: no lane for device {zz.device}")
    nby, nbx = zz.shape[-3], zz.shape[-2]
    lead = tuple(zz.shape[:-3])
    src = zz.to(torch.int32).contiguous().view(-1, nby, nbx, 64)
    out = torch.empty((src.shape[0], nby * 8, nbx * 8), dtype=dtype,
                      device=zz.device)
    _kernels.jpeg_idct_islow(src, out, _table(qtable, zz.device, 0),
                             level_shift, max_val)
    return out.view(lead + tuple(out.shape[1:]))
