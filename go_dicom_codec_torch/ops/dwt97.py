"""Irreversible 9/7 CDF lifting DWT (ISO/IEC 15444-1 Annex F), float32.

Port of ``go_dicom_codec_tpu/ops/dwt97.py``: α/β/γ/δ lifting with edge
clamps, K/invK normalization, vertical-first 2D, parity-aware windows, in
plain torch on the tensor's device. The inverse is the exact mirror (low×K,
high×1/K, then the negated lifting steps). The multilevel functions return
a new tensor and leave their input as it was.

No hand-written kernel yet: the reference computes the 9/7 in jnp, not in
Pallas.
"""

from __future__ import annotations

import torch

from .dwt53 import _edge_left, _edge_right, _level_windows

ALPHA = -1.586134342
BETA = -0.052980118
GAMMA = 0.882911075
DELTA = 0.443506852
K = 1.230174105
INV_K = 0.812893066


def _predict_update(s, d, sn, dn, even: bool, c_pred: float, c_upd: float):
    """One (predict, update) lifting pair with OpenJPEG edge clamps."""
    if even:
        # d[i] += cp*(s[i] + s[i+1 clamped])
        s_next = _edge_right(s)[..., :dn]
        d = d + c_pred * (s[..., :dn] + s_next)
        # s[i] += cu*(d[i-1 clamped] + d[i clamped])
        d_prev, d_cur = _edge_left(d), d
        if sn == dn + 1:
            d_prev = torch.cat([d_prev, d[..., -1:]], dim=-1)
            d_cur = torch.cat([d_cur, d[..., -1:]], dim=-1)
        s = s + c_upd * (d_prev + d_cur)
    else:
        # d[i] += cp*(s[i-1 cl] + s[i cl])
        if dn == sn:
            s_im1, s_i = _edge_left(s), s
        else:  # dn == sn + 1
            s_im1 = torch.cat([s[..., :1], s], dim=-1)
            s_i = torch.cat([s, s[..., -1:]], dim=-1)
        d = d + c_pred * (s_im1 + s_i)
        # s[i] += cu*(d[i] + d[i+1 cl])
        d_i = d[..., :sn]
        d_ip1 = d[..., 1:sn + 1] if dn >= sn + 1 else _edge_right(d)
        s = s + c_upd * (d_i + d_ip1)
    return s, d


def fwd97_1d(x: torch.Tensor, even: bool) -> torch.Tensor:
    """Forward 9/7 along the last axis → [L | H] packed, float32."""
    w = x.shape[-1]
    x = x.to(torch.float32)
    if w <= 1:
        return x
    if even:
        s, d = x[..., 0::2], x[..., 1::2]
    else:
        d, s = x[..., 0::2], x[..., 1::2]
    sn, dn = s.shape[-1], d.shape[-1]
    s, d = _predict_update(s, d, sn, dn, even, ALPHA, BETA)
    s, d = _predict_update(s, d, sn, dn, even, GAMMA, DELTA)
    return torch.cat([s * INV_K, d * K], dim=-1)


def inv97_1d(x: torch.Tensor, even: bool) -> torch.Tensor:
    """Exact inverse of fwd97_1d."""
    w = x.shape[-1]
    x = x.to(torch.float32)
    if w <= 1:
        return x
    sn = (w + 1) // 2 if even else w // 2
    dn = w - sn
    s = x[..., :sn] * K
    d = x[..., sn:] * INV_K
    s, d = _predict_update(s, d, sn, dn, even, 0.0, -DELTA)
    s, d = _predict_update(s, d, sn, dn, even, -GAMMA, -BETA)
    s, d = _predict_update(s, d, sn, dn, even, -ALPHA, 0.0)
    out = torch.empty_like(x)
    if even:
        out[..., 0::2] = s
        out[..., 1::2] = d
    else:
        out[..., 0::2] = d
        out[..., 1::2] = s
    return out


def _cols(fn, x, even):
    return fn(x.transpose(-1, -2), even).transpose(-1, -2)


def fwd97_2d(x, even_row=True, even_col=True):
    """Vertical pass first, then horizontal."""
    if x.shape[-2] > 1:
        x = _cols(fwd97_1d, x, even_col)
    if x.shape[-1] > 1:
        x = fwd97_1d(x, even_row)
    return x


def inv97_2d(x, even_row=True, even_col=True):
    if x.shape[-1] > 1:
        x = inv97_1d(x, even_row)
    if x.shape[-2] > 1:
        x = _cols(inv97_1d, x, even_col)
    return x


def _multilevel(x: torch.Tensor, levels: int, x0: int, y0: int,
                level, inverse: bool) -> torch.Tensor:
    x = x.to(torch.float32, copy=True)
    wins = _level_windows(x.shape[-1], x.shape[-2], levels, x0, y0)
    for (w, h, lx0, ly0) in (reversed(wins) if inverse else wins):
        x[..., :h, :w] = level(x[..., :h, :w], lx0 % 2 == 0, ly0 % 2 == 0)
    return x


def fwd97_multilevel(x: torch.Tensor, levels: int, x0: int = 0,
                     y0: int = 0) -> torch.Tensor:
    """Multilevel packed decomposition of [..., H, W], finest level first."""
    return _multilevel(x, levels, x0, y0, fwd97_2d, inverse=False)


def inv97_multilevel(x: torch.Tensor, levels: int, x0: int = 0,
                     y0: int = 0) -> torch.Tensor:
    """Multilevel packed reconstruction, coarsest level first."""
    return _multilevel(x, levels, x0, y0, inv97_2d, inverse=True)


# OpenJPEG 9/7 per-band L2 norms, used for step-size derivation.
DWT97_NORMS = (
    (1.000, 1.965, 4.177, 8.403, 16.90, 33.84, 67.69, 135.3, 270.6, 540.9),
    (2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0, 0.0),
    (2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0, 0.0),
    (2.080, 3.865, 8.307, 17.18, 34.71, 69.59, 139.3, 278.6, 557.2, 0.0),
)


def dwt97_norm(level: int, orient: int) -> float:
    level = max(level, 0)
    if orient == 0:
        level = min(level, 9)
    else:
        level = min(level, 8)
    if not (0 <= orient <= 3):
        return 1.0
    return DWT97_NORMS[orient][level]


# OpenJPEG 5/3 per-band L2 norms (opj_dwt_norms), used for NMSEDEC
# distortion weighting.
DWT53_NORMS = (
    (1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3),
    (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9, 0.0),
    (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9, 0.0),
    (.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93, 0.0),
)


def dwt53_norm(level: int, orient: int) -> float:
    level = max(level, 0)
    if orient == 0:
        level = min(level, 9)
    else:
        level = min(level, 8)
    if not (0 <= orient <= 3):
        return 1.0
    return DWT53_NORMS[orient][level]
