"""Batched 8×8 DCT/IDCT and quantization, plain torch and numpy.

Port of ``go_dicom_codec_tpu/ops/dct8x8.py``:

- the float32 orthonormal DCT pair and (de)quantization (:36-111):
  ``fdct8x8`` and ``quantize``, the plain version of the fused kernel in
  ``fdct8x8_quant``, and ``idct8x8`` and ``dequantize``, their inverses.
  As in the reference, no codec path runs this float pair; it exists for
  the device bench and as the kernel's reference;
- the zigzag tables and scans, RGB ↔ YCbCr in torch and numpy;
- the JPEG codec stages over the integer islow DCT (ops/dct_int.py):
  ``encode_plane_to_zigzag`` (pad → shift → DCT → quant → zigzag) and
  ``decode_zigzag_to_plane`` (un-zigzag → dequant + IDCT → shift → clamp)
  in plain torch, the plain versions of the two kernels of
  ``jpeg_islow`` (the CPU lane and the kernels' reference), and their
  numpy mirrors.

``LUMA_QUANT`` and ``scale_quant_table`` are copies of
``go_dicom_codec_tpu/codecs/jpeg_common.py:28-58``, which imports jax.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import dct_int
from .convert import saturate_int32

# Zigzag scan order (T.81 Figure A.6): index i → raster position ZIGZAG[i].
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)
INV_ZIGZAG = np.argsort(ZIGZAG).astype(np.int32)


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


def idct8x8(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse of fdct8x8 (Dᵀ F D): [..., 8, 8] → float32 samples."""
    f = coeffs.to(torch.float32)
    d = _basis(f.device)
    return torch.einsum("ux,...uv,vy->...xy", d, f, d)


def quantize(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Round-half-away(F/Q) → int32 (encoder.go:458-465 semantics),
    saturating as the reference's cast does (NaN → 0)."""
    q = qtable.reshape((1,) * (coeffs.ndim - 2) + (8, 8)).to(torch.float32)
    r = coeffs / q
    return saturate_int32(torch.where(r >= 0, torch.floor(r + 0.5),
                                      -torch.floor(-r + 0.5)))


def dequantize(q_coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Quantized coefficients [..., 8, 8] × ``qtable`` → float32."""
    q = qtable.reshape((1,) * (q_coeffs.ndim - 2) + (8, 8)).to(torch.float32)
    return q_coeffs.to(torch.float32) * q


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


def zigzag_scan(blocks: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] → [..., 64] in zigzag order."""
    flat = blocks.reshape(tuple(blocks.shape[:-2]) + (64,))
    return flat[..., torch.as_tensor(ZIGZAG, dtype=torch.long,
                                     device=blocks.device)]


def inv_zigzag_scan(zz: torch.Tensor) -> torch.Tensor:
    """[..., 64] zigzag → [..., 8, 8] raster."""
    idx = torch.as_tensor(INV_ZIGZAG, dtype=torch.long, device=zz.device)
    return zz[..., idx].reshape(tuple(zz.shape[:-1]) + (8, 8))


# ---- RGB ↔ YCbCr (JFIF fixed point, reference baseline/encoder.go:343-373,
#      decoder.go:576-588) ---------------------------------------------------

def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 → [..., H, W, 3] uint8, bit-exact fixed point."""
    r = rgb[..., 0].to(torch.int32)
    g = rgb[..., 1].to(torch.int32)
    b = rgb[..., 2].to(torch.int32)
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11056 * r - 21712 * g + 32768 * b + 8421376) >> 16
    cr = (32768 * r - 27440 * g - 5328 * b + 8421376) >> 16
    out = torch.stack([y, cb, cr], dim=-1)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 → RGB uint8, bit-exact fixed point."""
    y = ycc[..., 0].to(torch.int32)
    cb = ycc[..., 1].to(torch.int32) - 128
    cr = ycc[..., 2].to(torch.int32) - 128
    r = y + ((91881 * cr) >> 16)
    g = y - ((22554 * cb + 46802 * cr) >> 16)
    b = y + ((116130 * cb) >> 16)
    out = torch.stack([r, g, b], dim=-1)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def rgb_to_ycbcr_np(rgb: np.ndarray) -> np.ndarray:
    """Host numpy mirror of rgb_to_ycbcr (bit-exact: pure integer math)."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11056 * r - 21712 * g + 32768 * b + 8421376) >> 16
    cr = (32768 * r - 27440 * g - 5328 * b + 8421376) >> 16
    out = np.stack([y, cb, cr], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def ycbcr_to_rgb_np(ycc: np.ndarray) -> np.ndarray:
    """Host numpy mirror of ycbcr_to_rgb (bit-exact: pure integer math)."""
    y = ycc[..., 0].astype(np.int32)
    cb = ycc[..., 1].astype(np.int32) - 128
    cr = ycc[..., 2].astype(np.int32) - 128
    r = y + ((91881 * cr) >> 16)
    g = y - ((22554 * cb + 46802 * cr) >> 16)
    b = y + ((116130 * cb) >> 16)
    out = np.stack([r, g, b], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---- the JPEG codec stages over the integer islow DCT ---------------------

def _int_table(qtable, device: torch.device) -> torch.Tensor:
    """64 quant values in raster order (array, list or tensor) as an int32
    [8, 8] tensor on ``device``."""
    return torch.as_tensor(qtable, dtype=torch.int32,
                           device=device).reshape(8, 8)


def encode_plane_to_zigzag(plane: torch.Tensor, qtable,
                           level_shift: int = 128) -> torch.Tensor:
    """pad → blocks → integer islow DCT → quant → zigzag, plain torch on
    plane's device: the plain version of the ``jpeg_fdct_islow`` kernel.

    plane: [..., H, W] integer samples; qtable: 64 quant values in raster
    order (array or tensor). Returns [..., nby, nbx, 64] int32, equal to
    the reference's jnp and numpy lanes (int32 wraparound included).
    """
    p = pad_replicate_to_8(plane.to(torch.int32)) - level_shift
    f = dct_int.fdct8x8_islow(to_blocks(p), torch,
                              p1=dct_int.pass1_bits(level_shift))
    return zigzag_scan(dct_int.quantize_islow(
        f, _int_table(qtable, plane.device), torch))


def decode_zigzag_to_plane(zz: torch.Tensor, qtable, level_shift: int = 128,
                           max_val: int = 255) -> torch.Tensor:
    """inv-zigzag → integer islow dequant + IDCT → shift → clamp, plain
    torch on zz's device: the plain version of the ``jpeg_idct_islow``
    kernel.

    zz: [..., nby, nbx, 64] int32. Returns [..., nby*8, nbx*8] int32 in
    [0, max_val], equal to the reference's jnp and numpy lanes.
    """
    blocks = inv_zigzag_scan(zz).to(torch.int32)
    s = dct_int.idct8x8_islow(blocks, _int_table(qtable, zz.device), torch,
                              p1=dct_int.pass1_bits(level_shift)
                              ) + level_shift
    return torch.clamp(from_blocks(s), 0, max_val)


def encode_plane_to_zigzag_np(plane: np.ndarray, qtable: np.ndarray,
                              level_shift: int = 128) -> np.ndarray:
    """numpy mirror of encode_plane_to_zigzag (bit-identical)."""
    h, w = plane.shape[-2:]
    ph, pw = (-h) % 8, (-w) % 8
    p = plane
    if ph or pw:
        pad = [(0, 0)] * (plane.ndim - 2) + [(0, ph), (0, pw)]
        p = np.pad(plane, pad, mode="edge")
    p = p.astype(np.int32) - level_shift
    hh, ww = p.shape[-2:]
    lead = p.shape[:-2]
    blocks = p.reshape(lead + (hh // 8, 8, ww // 8, 8)).swapaxes(-3, -2)
    f = dct_int.fdct8x8_islow(blocks, np,
                              p1=dct_int.pass1_bits(level_shift))
    q = dct_int.quantize_islow(f, np.asarray(qtable, dtype=np.int32), np)
    flat = q.reshape(q.shape[:-2] + (64,))
    return flat[..., ZIGZAG]


def decode_zigzag_to_plane_np(zz: np.ndarray, qtable: np.ndarray,
                              level_shift: int = 128,
                              max_val: int = 255) -> np.ndarray:
    """numpy mirror of decode_zigzag_to_plane (bit-identical)."""
    blocks = (zz[..., INV_ZIGZAG].reshape(zz.shape[:-1] + (8, 8))
              .astype(np.int32))
    s = dct_int.idct8x8_islow(blocks, np.asarray(qtable, dtype=np.int32),
                              np, p1=dct_int.pass1_bits(level_shift)
                              ) + level_shift
    lead = s.shape[:-4]
    nby, nbx = s.shape[-4], s.shape[-3]
    plane = s.swapaxes(-3, -2).reshape(lead + (nby * 8, nbx * 8))
    return np.clip(plane, 0, max_val)
