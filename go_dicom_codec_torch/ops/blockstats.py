"""Per-codeblock statistics: max |coeff| and magnitude bitplane count.

Port of ``go_dicom_codec_tpu/ops/blockstats.py:18-62``: the whole
codeblock grid is reduced at once by reshaping [H, W] coefficients into
[nby, cbh, nbx, cbw] and max-reducing. Bit-exact with the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to_multiple(x: torch.Tensor, mult_h: int, mult_w: int) -> torch.Tensor:
    """Zero-pad the trailing 2 dims up to multiples of (mult_h, mult_w)."""
    h, w = x.shape[-2], x.shape[-1]
    ph = (-h) % mult_h
    pw = (-w) % mult_w
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, pw, 0, ph))


def codeblock_max_abs(coeffs: torch.Tensor, cb_h: int,
                      cb_w: int) -> torch.Tensor:
    """[..., H, W] int32 → [..., ceil(H/cb_h), ceil(W/cb_w)] max |coeff|.

    Zero padding never raises a block's max magnitude.
    """
    x = pad_to_multiple(coeffs.abs(), cb_h, cb_w)
    h, w = x.shape[-2], x.shape[-1]
    nby, nbx = h // cb_h, w // cb_w
    x = x.reshape(x.shape[:-2] + (nby, cb_h, nbx, cb_w))
    return x.amax(dim=(-3, -1))


def max_bitplane(max_abs: torch.Tensor) -> torch.Tensor:
    """Number of magnitude bitplanes per block: ceil(log2(maxabs+1)), 0 for
    an all-zero block.

    The reference takes the bit length of ``max_abs`` read as uint32; torch
    has no uint32 arithmetic, so the same bits are held in int64.
    """
    v = max_abs.to(torch.int64) & 0xFFFFFFFF
    bits = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for shift in (16, 8, 4, 2, 1):
        ge = v >= (1 << shift)
        bits = bits + torch.where(ge, shift, 0).to(torch.int32)
        v = torch.where(ge, v >> shift, v)
    return torch.where(max_abs > 0, bits + 1, 0).to(torch.int32)


def codeblock_stats(coeffs: torch.Tensor, cb_h: int = 64, cb_w: int = 64):
    """Per-codeblock (max_abs, num_bitplanes)."""
    m = codeblock_max_abs(coeffs, cb_h, cb_w)
    return m, max_bitplane(m)
