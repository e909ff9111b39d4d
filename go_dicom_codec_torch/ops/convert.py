"""Saturating float → int32 conversion, as XLA converts.

``jnp.round(v).astype(jnp.int32)`` saturates: NaN gives 0, values at or
above 2^31 (and +inf) give INT32_MAX, values below -2^31 (and -inf) give
INT32_MIN. ``torch.round(v).to(torch.int32)`` on a CPU tensor gives
INT32_MIN for all of them, and C++'s conversion of an out-of-range float
is undefined. These helpers give XLA's result on every device.

float32(2147483647) is 2^31, so a clamp to [-2^31, 2^31 - 1] in float32
still wraps: the upper clamp is the largest float32 below 2^31, and a
comparison with 2^31 sets INT32_MAX.
"""

from __future__ import annotations

import torch

INT32_MAX = 2147483647
INT32_MIN = -2147483648


def saturate_int32(v: torch.Tensor) -> torch.Tensor:
    """Float ``v`` holding whole numbers → int32, saturating: NaN → 0,
    ≥ 2^31 → INT32_MAX, < -2^31 → INT32_MIN."""
    # the largest value of v's type below 2^31: float64 holds 2^31 - 1
    hi = 2147483647.0 if v.dtype == torch.float64 else 2147483520.0
    out = torch.nan_to_num(v, nan=0.0).clamp(float(INT32_MIN), hi)
    return out.to(torch.int32).masked_fill_(v >= 2.0 ** 31, INT32_MAX)


def round_to_int32_sat(v: torch.Tensor) -> torch.Tensor:
    """``jnp.round(v).astype(jnp.int32)``: round half to even, then
    ``saturate_int32``."""
    return saturate_int32(torch.round(v))
