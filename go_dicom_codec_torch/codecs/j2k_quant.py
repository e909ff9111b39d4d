"""JPEG 2000 scalar quantization (ISO/IEC 15444-1 Annex E).

Role of reference jpeg2000/quantization.go: quality→scale curve, OpenJPEG
9/7 norm-derived per-subband step sizes, and the (ε, μ) 16-bit step
encoding Δ_b = 2^(R_b − ε_b)·(1 + μ_b/2^11) with R_b = bit depth + gain.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..ops.dwt97 import dwt97_norm
from .j2k_geometry import band_gain


def quality_scale(quality: int) -> float:
    """Quality → relative base step (reference quantization.go:54-66 curve).

    The reference's curve pairs with its ×2^7 NMSEDEC fixed-point T1
    domain (encoder.go:2311-2329); our T1 codes plain integers, so the
    same curve is rescaled by 1/128 to give identical effective steps.
    """
    quality = max(1, min(quality, 100))
    scale = 2.0 ** ((100.0 - quality) / 12.5)
    return max(scale, 0.01) * 0.05 / 128.0


def band_sequence(num_levels: int) -> List[Tuple[int, int]]:
    """(resolution, band) in QCD order: LL, then (HL, LH, HH) per res."""
    out = [(0, 0)]
    for r in range(1, num_levels + 1):
        out += [(r, 1), (r, 2), (r, 3)]
    return out


def step_sizes_97(num_levels: int, quality: int) -> List[float]:
    """Per-subband step sizes (reference calcOpenJPEGStepSizes97:84-100).

    Returned in QCD subband order; steps are relative to unit dynamic
    range (multiplied by 2^R_b at dequant time via the ε/μ encoding).
    """
    scale = quality_scale(quality)
    steps = []
    for (r, band) in band_sequence(num_levels):
        level = num_levels - r if r > 0 else num_levels
        orient = band
        norm = dwt97_norm(level, orient)
        steps.append(scale / norm if norm > 0 else scale)
    return steps


def encode_step(step_rel: float, rb: int) -> Tuple[int, int]:
    """Relative step (fraction of 2^R_b dynamic range) → (ε, μ).

    Encoded so any ISO decoder computing Δ_b = 2^(R_b−ε)(1+μ/2^11) gets
    the intended ABSOLUTE step Δ = step_rel·2^R_b. (The reference's
    encodeQuantizationStep at quantization.go:102-128 pairs differently
    with its own decoder; this form is the Annex E.3 convention.)
    """
    if step_rel <= 0:
        return 0, 0
    delta = step_rel * (1 << rb)
    p = math.floor(math.log2(delta))
    expn = max(0, min(rb - p, 31))
    base = 2.0 ** (rb - expn)
    mant = int(round((delta / base - 1.0) * 2048.0))
    mant = max(0, min(mant, 2047))
    return expn, mant


def decode_step(expn: int, mant: int, rb: int) -> float:
    """(ε, μ) → absolute step Δ_b = 2^(R_b − ε)·(1 + μ/2^11)."""
    return (1.0 + mant / 2048.0) * (2.0 ** (rb - expn))


def deadzone_quantize(coeffs: np.ndarray, delta: float) -> np.ndarray:
    """q = sign(c)·floor(|c|/Δ) (Annex E.1 deadzone quantizer)."""
    if delta <= 0:
        return np.rint(coeffs).astype(np.int32)
    return (np.sign(coeffs) * np.floor(np.abs(coeffs) / delta)).astype(np.int32)


def dequantize(q: np.ndarray, delta: float, half_bit: bool = True) -> np.ndarray:
    """ĉ = sign(q)·(|q| + r)·Δ with r = 0.5 midpoint reconstruction."""
    qa = q.astype(np.float32)
    if delta <= 0:
        return qa
    if half_bit:
        return np.sign(qa) * (np.abs(qa) + 0.5) * np.float32(delta) * (q != 0)
    return qa * np.float32(delta)


# OpenJPH filter BIBO/L2 gain tables (public OpenJPH param_qcd constants;
# reference quantization.go:238-241)
OPENJPH_97_LOW_GAIN = (1.0, 1.4021, 2.0304, 2.9012, 4.1153, 5.8245, 8.2388)
OPENJPH_97_HIGH_GAIN = (1.4425, 1.9669, 2.8839, 4.1475, 5.8946, 8.3472)
OPENJPH_53_LOW_BIBO = (1.0, 1.5, 1.625, 1.6875, 1.6963, 1.7067, 1.7116)
OPENJPH_53_HIGH_BIBO = (2.0, 2.5, 2.75, 2.8047, 2.8198, 2.8410)


def openjph_qcd_values(num_levels: int, bit_depth: int, lossless: bool,
                       uses_rct: bool = False):
    """HTJ2K quantization parameters, mirror of the reference's
    CalculateOpenJPHQuantizationParams (quantization.go:243-297 /
    OpenJPH param_qcd).

    Returns ("exponents", guard_bits, [ε per band]) for lossless or
    ("steps", guard_bits, [(ε, μ) per band]) for lossy, in QCD band
    order. Lossless exponents use the 5/3 BIBO bounds (+1 precision bit
    when RCT is active); lossy steps use the 9/7 L2 gains around a
    2^-min(16,depth) base step.
    """
    lv = max(0, min(num_levels, 6))
    if lossless:
        precision = bit_depth + (1 if uses_rct else 0)
        lo, hi = OPENJPH_53_LOW_BIBO, OPENJPH_53_HIGH_BIBO
        exps = [int(precision + math.ceil(math.log2(lo[lv] * lo[lv])) - 1)]
        if lv == 0:
            # BIBO gain 1 leaves no slack for the asymmetric DC shift:
            # |-2^(p-1)| needs p magnitude bits but ε = p-1 gives
            # Mb = p-1 (the reference's HT Kmax would overflow here,
            # encoder.go:3375); clamp up — QCD is self-describing
            exps[0] = max(exps[0], precision)
        for d in range(lv, 0, -1):
            mixed = math.sqrt(lo[d] * hi[d - 1])
            e = int(precision + math.ceil(math.log2(mixed * mixed)) - 1)
            exps += [e, e,
                     int(precision
                         + math.ceil(math.log2(hi[d - 1] * hi[d - 1])) - 1)]
        return "exponents", 1, exps

    base = math.ldexp(1.0, -min(16, bit_depth))
    lo, hi = OPENJPH_97_LOW_GAIN, OPENJPH_97_HIGH_GAIN

    def enc(delta: float):
        expn = 0
        while delta < 1.0:
            expn += 1
            delta *= 2.0
        mant = min(int(round(delta * 2048.0)) - 2048, 2047)
        return expn, max(mant, 0)

    steps = [enc(base / (lo[lv] * lo[lv]))]
    for d in range(lv, 0, -1):
        m = enc(base / (lo[d] * hi[d - 1]))
        steps += [m, m, enc(base / (hi[d - 1] * hi[d - 1]))]
    return "steps", 1, steps
