"""Multi-component transforms: DC level shift and the reversible RCT.

Port of ``go_dicom_codec_tpu/ops/mct.py:14-43``. All int32 and bit-exact:
``>>`` on a torch int32 tensor is an arithmetic shift, as in jnp.
"""

from __future__ import annotations

import torch


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
