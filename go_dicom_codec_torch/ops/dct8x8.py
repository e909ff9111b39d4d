"""Float32 orthonormal 8×8 DCT-II and quantization, plain torch.

Port of the float reference part of ``go_dicom_codec_tpu/ops/dct8x8.py``
(:36-111): the plain version of the fused kernel in ``fdct8x8_quant``. As
in the reference, no codec path runs this float DCT; it exists for the
device bench and as the kernel's reference. The integer islow DCT, zigzag
and YCbCr are not ported yet.

``LUMA_QUANT`` and ``scale_quant_table`` are copies of
``go_dicom_codec_tpu/codecs/jpeg_common.py:28-58``, which imports jax.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .convert import saturate_int32


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D; F = D f Dᵀ gives T.81 F(u,v)."""
    d = np.zeros((8, 8), dtype=np.float64)
    for u in range(8):
        c = np.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            d[u, x] = c * np.cos((2 * x + 1) * u * np.pi / 16.0)
    return d


_D_np = _dct_matrix().astype(np.float32)

LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32).reshape(8, 8)


def scale_quant_table(base: np.ndarray, quality: int,
                      max_val: int = 255) -> np.ndarray:
    """IJG quality curve (reference jpeg/standard/tables.go:30-58)."""
    if not (1 <= quality <= 100):
        raise ValueError(f"quality={quality} out of [1, 100]")
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    t = (base.astype(np.int64) * scale + 50) // 100
    return np.clip(t, 1, max_val).astype(np.int32)


def tables_from_numpy(d, qtable, device: torch.device):
    """The DCT basis [8, 8] and a quant table (64 values) as float32
    tensors on ``device`` (required: nothing picks a device): the codec's
    constant state, from the numpy constants of either package (or
    tensors)."""
    dt = torch.as_tensor(d, dtype=torch.float32, device=device)
    qt = torch.as_tensor(qtable, dtype=torch.float32, device=device)
    return dt.reshape(8, 8).contiguous(), qt.reshape(64).contiguous()


@lru_cache(maxsize=None)
def _basis(device: torch.device) -> torch.Tensor:
    """``_D_np`` on ``device``, copied there once."""
    return torch.as_tensor(_D_np, device=device)


def fdct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] (level-shifted samples) → float32 DCT coefficients."""
    x = blocks.to(torch.float32)
    d = _basis(x.device)
    return torch.einsum("ux,...xy,vy->...uv", d, x, d)


def quantize(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Round-half-away(F/Q) → int32 (encoder.go:458-465 semantics),
    saturating as the reference's cast does (NaN → 0)."""
    q = qtable.reshape((1,) * (coeffs.ndim - 2) + (8, 8)).to(torch.float32)
    r = coeffs / q
    return saturate_int32(torch.where(r >= 0, torch.floor(r + 0.5),
                                      -torch.floor(-r + 0.5)))


def to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] (H, W multiples of 8) → [..., H/8, W/8, 8, 8]."""
    h, w = plane.shape[-2], plane.shape[-1]
    lead = tuple(plane.shape[:-2])
    x = plane.reshape(lead + (h // 8, 8, w // 8, 8))
    return x.transpose(-3, -2)


def from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of to_blocks."""
    lead = tuple(blocks.shape[:-4])
    nby, nbx = blocks.shape[-4], blocks.shape[-3]
    return blocks.transpose(-3, -2).reshape(lead + (nby * 8, nbx * 8))


def pad_replicate_to_8(plane: torch.Tensor) -> torch.Tensor:
    """Edge-replicate the last two dims up to multiples of 8 (the
    reference's edge-clamped block extraction)."""
    h, w = plane.shape[-2], plane.shape[-1]
    ph, pw = (-h) % 8, (-w) % 8
    if ph == 0 and pw == 0:
        return plane
    rows = torch.arange(h + ph, device=plane.device).clamp_(max=h - 1)
    cols = torch.arange(w + pw, device=plane.device).clamp_(max=w - 1)
    return plane.index_select(-2, rows).index_select(-1, cols)
