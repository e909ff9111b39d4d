"""Multi-component transforms: DC level shift, RCT, ICT, Part-2 matrices.

Port of ``go_dicom_codec_tpu/ops/mct.py``. The DC shift and the RCT are
int32 and bit-exact: ``>>`` on a torch int32 tensor is an arithmetic
shift, as in jnp. The ICT keeps the reference's float32 constants and op
order. The Part-2 matrix product is an explicit sum over components in
the order XLA computes it, so that no TF32 setting can change it on
CUDA. The ``_np`` variants are numpy mirrors for the host fast paths.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .convert import round_to_int32_sat


def dc_level_shift(x: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """Forward DC shift: unsigned samples centered by -2^(bits-1)."""
    if signed:
        return x
    return x - (1 << (bits - 1))


def inv_dc_level_shift(x: torch.Tensor, bits: int,
                       signed: bool) -> torch.Tensor:
    if signed:
        return x
    return x + (1 << (bits - 1))


def rct_forward(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Reversible color transform, ISO 15444-1 G.1.

    Y = (R + 2G + B) >> 2 (floor), U = B - G, V = R - G.
    """
    y = (r + 2 * g + b) >> 2
    u = b - g
    v = r - g
    return y, u, v


def rct_inverse(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Inverse RCT: G = Y - ((U + V) >> 2), R = V + G, B = U + G."""
    g = y - ((u + v) >> 2)
    r = v + g
    b = u + g
    return r, g, b



# numpy mirrors of the integer transforms, for the host fast paths that
# hold numpy arrays (the native DWT lanes); same int32 arithmetic
def dc_level_shift_np(x: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    return x if signed else x - (1 << (bits - 1))


def inv_dc_level_shift_np(x: np.ndarray, bits: int,
                          signed: bool) -> np.ndarray:
    return x if signed else x + (1 << (bits - 1))


def rct_forward_np(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    return (r + 2 * g + b) >> 2, b - g, r - g


def rct_inverse_np(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    g = y - ((u + v) >> 2)
    return v + g, g, u + g

# ICT (irreversible, ISO 15444-1 G.2) coefficients as the reference uses
# them (truncated constants, round-to-int results).
_ICT_FWD = ((0.299, 0.587, 0.114),
            (-0.16875, -0.331260, 0.5),
            (0.5, -0.41869, -0.08131))
_ICT_INV_CR = 1.402
_ICT_INV_CB_G = -0.34413
_ICT_INV_CR_G = -0.71414
_ICT_INV_CB = 1.772


def ict_forward(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Irreversible color transform → float32."""
    rf = r.to(torch.float32)
    gf = g.to(torch.float32)
    bf = b.to(torch.float32)
    y = _ICT_FWD[0][0] * rf + _ICT_FWD[0][1] * gf + _ICT_FWD[0][2] * bf
    cb = _ICT_FWD[1][0] * rf + _ICT_FWD[1][1] * gf + _ICT_FWD[1][2] * bf
    cr = _ICT_FWD[2][0] * rf + _ICT_FWD[2][1] * gf + _ICT_FWD[2][2] * bf
    return y, cb, cr


def ict_inverse(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """Inverse ICT."""
    r = y + _ICT_INV_CR * cr
    g = y + _ICT_INV_CB_G * cb + _ICT_INV_CR_G * cr
    b = y + _ICT_INV_CB * cb
    return r, g, b


def ict_forward_np(r, g, b):
    """numpy mirror of ict_forward for the host fast paths: same float32
    arithmetic and order, no device dispatch."""
    rf = np.asarray(r, dtype=np.float32)
    gf = np.asarray(g, dtype=np.float32)
    bf = np.asarray(b, dtype=np.float32)
    y = np.float32(_ICT_FWD[0][0]) * rf + np.float32(_ICT_FWD[0][1]) * gf \
        + np.float32(_ICT_FWD[0][2]) * bf
    cb = np.float32(_ICT_FWD[1][0]) * rf + np.float32(_ICT_FWD[1][1]) * gf \
        + np.float32(_ICT_FWD[1][2]) * bf
    cr = np.float32(_ICT_FWD[2][0]) * rf + np.float32(_ICT_FWD[2][1]) * gf \
        + np.float32(_ICT_FWD[2][2]) * bf
    return y, cb, cr


def ict_inverse_np(y, cb, cr):
    """numpy mirror of ict_inverse (see ict_forward_np)."""
    yf = np.asarray(y, dtype=np.float32)
    cbf = np.asarray(cb, dtype=np.float32)
    crf = np.asarray(cr, dtype=np.float32)
    r = yf + np.float32(_ICT_INV_CR) * crf
    g = yf + np.float32(_ICT_INV_CB_G) * cbf + np.float32(_ICT_INV_CR_G) * crf
    b = yf + np.float32(_ICT_INV_CB) * cbf
    return r, g, b


def ict_forward_int(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """ICT with round-to-nearest int32 results."""
    return tuple(round_to_int32_sat(v) for v in ict_forward(r, g, b))


def ict_inverse_int(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """Inverse ICT with round-to-nearest int32 results."""
    return tuple(round_to_int32_sat(v) for v in ict_inverse(
        y.to(torch.float32), cb.to(torch.float32), cr.to(torch.float32)))


def _fma32(p: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 of ``p + acc`` rounded once, as one fused multiply-add:
    ``p`` is an exact float64 product of two float32 values, ``acc``
    float32. The float64 sum is made exact with its two-sum error and
    rounded to odd; a float64 rounded to odd rounds to the same float32
    as the exact sum (53 ≥ 24 + 2 bits), so no tie is rounded twice."""
    a = acc.to(torch.float64)
    s = p + a
    bv = s - p
    err = (p - (s - bv)) + (a - bv)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf),
                                             err))
    return torch.where((err != 0) & even, away, s).to(torch.float32)


def _mix(matrix: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[C', C] × [C, ...] → float32, out[i] = Σ_j m[i, j]·x[j] as the
    chain XLA's CPU dot computes: acc = m[i, 0]·x[0], then one fused
    multiply-add per further j (``_fma32``). A product of two float32
    values is exact in float64. No matmul: on CUDA that would follow the
    TF32 flag."""
    m = matrix.to(device=x.device, dtype=torch.float32).to(torch.float64)
    x64 = x.to(torch.float64)
    rows = []
    for i in range(m.shape[0]):
        acc = (m[i, 0] * x64[0]).to(torch.float32)
        for j in range(1, m.shape[1]):
            acc = _fma32(m[i, j] * x64[j], acc)
        rows.append(acc)
    return torch.stack(rows)


def _column(offsets: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return offsets.to(device=x.device, dtype=torch.float32).reshape(
        (-1,) + (1,) * (x.dim() - 1))


def mct_matrix_forward(components: torch.Tensor, matrix: torch.Tensor,
                       offsets: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Part 2 custom-matrix MCT: [C, ..., H, W] × [C, C] → float32."""
    x = components.to(torch.float32)
    if offsets is not None:
        x = x - _column(offsets, x)
    return _mix(matrix, x)


def mct_matrix_inverse(components: torch.Tensor, inv_matrix: torch.Tensor,
                       offsets: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    y = _mix(inv_matrix, components.to(torch.float32))
    if offsets is not None:
        y = y + _column(offsets, y)
    return y
