"""Integer IJG (islow) 8×8 DCT/IDCT — the ONE deterministic JPEG transform.

Role of reference jpeg/standard/{dct_ijg.go,idct_ijg.go} and the 12-bit
variant (jpeg/extended/sequential12.go:239): the classic libjpeg islow
fixed-point DCT (CONST_BITS=13, PASS1_BITS=2, output retains a factor-of-8
scale) and its inverse with fused dequantization.

Written once, generic over the array namespace (`xp` = numpy or torch):
every lane — the plain torch device path (ops/dct8x8.py), the numpy host
fallback, the native C++ mirror (native/ebcot_native.cpp jpg_fdct_quant/
jpg_idct) and the CUDA kernels (csrc/jpeg_islow.cu) — runs the SAME int32
operation sequence, so quantized
coefficients and reconstructed pixels are byte-identical across lanes by
construction (int32 adds/mults/shifts are exact on every backend).  This is
what makes lossy JPEG streams deterministic: the same input encodes to the
same bytes whether the native library built, the device path ran, or the
pure-Python lane was forced (GDCT_DISABLE_NATIVE=1).

Vectorized over blocks: each 1-D pass transforms the last axis of
[..., 8] lanes, so the whole MCU grid is one fused elementwise program —
no per-block Python looping.

Port of ``go_dicom_codec_tpu/ops/dct_int.py``: the same op sequence line
for line; its three ``.astype`` casts go through ``_astype``, which takes
numpy arrays and torch tensors alike.
"""

from __future__ import annotations

CONST_BITS = 13
PASS1_BITS = 2

FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172


def pass1_bits(level_shift: int) -> int:
    """Precision profile: 8-bit samples use PASS1_BITS=2 (classic libjpeg /
    reference dct_ijg.go), >8-bit use PASS1_BITS=1 (libjpeg-turbo 12-bit,
    reference sequential12.go:242 — one bit less internal precision buys
    the int32 headroom that max-amplitude Nyquist blocks need)."""
    return 1 if level_shift >= 1024 else 2


def _astype(x, dtype):
    """x cast to ``dtype``: numpy's ``astype``, torch's ``to``."""
    return x.astype(dtype) if hasattr(x, "astype") else x.to(dtype)


def _descale(x, n):
    """(x + 2^(n-1)) >> n with arithmetic shift (ijgDescale semantics)."""
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(s, xp, final: bool, p1: int = PASS1_BITS):
    """One 8-point forward islow pass along the last axis.

    final=False: row pass (even terms << p1, odd descale CONST-p1).
    final=True: column pass (even descale p1, odd descale CONST+p1).
    s: [..., 8] int32.
    """
    d0, d1, d2, d3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    d4, d5, d6, d7 = s[..., 4], s[..., 5], s[..., 6], s[..., 7]
    tmp0 = d0 + d7
    tmp7 = d0 - d7
    tmp1 = d1 + d6
    tmp6 = d1 - d6
    tmp2 = d2 + d5
    tmp5 = d2 - d5
    tmp3 = d3 + d4
    tmp4 = d3 - d4

    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    if final:
        o0 = _descale(tmp10 + tmp11, p1)
        o4 = _descale(tmp10 - tmp11, p1)
        odd_shift = CONST_BITS + p1
    else:
        o0 = (tmp10 + tmp11) * (1 << p1)
        o4 = (tmp10 - tmp11) * (1 << p1)
        odd_shift = CONST_BITS - p1

    z1 = (tmp12 + tmp13) * FIX_0_541196100
    o2 = _descale(z1 + tmp13 * FIX_0_765366865, odd_shift)
    o6 = _descale(z1 - tmp12 * FIX_1_847759065, odd_shift)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5

    o7 = _descale(tmp4 + z1 + z3, odd_shift)
    o5 = _descale(tmp5 + z2 + z4, odd_shift)
    o3 = _descale(tmp6 + z2 + z3, odd_shift)
    o1 = _descale(tmp7 + z1 + z4, odd_shift)
    return xp.stack([o0, o1, o2, o3, o4, o5, o6, o7], axis=-1)


def fdct8x8_islow(blocks, xp, p1: int = PASS1_BITS):
    """[..., 8, 8] int32 level-shifted samples → coefficients scaled ×8.

    Row pass along x, column pass along y — same order and descales as
    the reference (dct_ijg.go DCTISlow; sequential12.go for p1=1).
    Returns [..., v, u] raster.  Net ×8 scale is invariant in p1.
    """
    t = _fdct_pass(blocks, xp, final=False, p1=p1)  # [..., y, u]
    t = xp.swapaxes(t, -1, -2)                      # [..., u, y]
    f = _fdct_pass(t, xp, final=True, p1=p1)        # [..., u, v]
    return xp.swapaxes(f, -1, -2)                   # [..., v, u]


def quantize_islow(coeffs, qtable, xp):
    """Round-half-away(coef / 8q) — reference encoder.go quantizeBlock.

    coeffs [..., 8, 8] ×8-scaled int32, qtable [8, 8] int → int32.
    """
    d = _astype(qtable.reshape((1,) * (coeffs.ndim - 2) + (8, 8)),
                coeffs.dtype) * 8
    mag = xp.abs(coeffs)
    q = (mag + (d >> 1)) // d
    return _astype(xp.where(coeffs < 0, -q, q), coeffs.dtype)


def _idct_pass(s, xp, final: bool, p1: int = PASS1_BITS):
    """One 8-point inverse islow pass along the last axis.

    final=False: column pass, descale CONST-p1.  final=True: row
    pass, descale CONST+p1+3 (the output stage; level shift and
    clamp are the caller's).  s: [..., 8] int32 (dequantized for pass 1).
    """
    z2 = s[..., 2]
    z3 = s[..., 6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    t0 = (s[..., 0] + s[..., 4]) * (1 << CONST_BITS)
    t1 = (s[..., 0] - s[..., 4]) * (1 << CONST_BITS)
    tmp10 = t0 + tmp3
    tmp13 = t0 - tmp3
    tmp11 = t1 + tmp2
    tmp12 = t1 - tmp2

    tmp0 = s[..., 7]
    tmp1 = s[..., 5]
    tmp2 = s[..., 3]
    tmp3 = s[..., 1]
    z1 = tmp0 + tmp3
    z2 = tmp1 + tmp2
    z3 = tmp0 + tmp2
    z4 = tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4

    shift = (CONST_BITS + p1 + 3) if final else (CONST_BITS - p1)
    o0 = _descale(tmp10 + tmp3, shift)
    o7 = _descale(tmp10 - tmp3, shift)
    o1 = _descale(tmp11 + tmp2, shift)
    o6 = _descale(tmp11 - tmp2, shift)
    o2 = _descale(tmp12 + tmp1, shift)
    o5 = _descale(tmp12 - tmp1, shift)
    o3 = _descale(tmp13 + tmp0, shift)
    o4 = _descale(tmp13 - tmp0, shift)
    return xp.stack([o0, o1, o2, o3, o4, o5, o6, o7], axis=-1)


def idct8x8_islow(coeffs, qtable, xp, p1: int = PASS1_BITS):
    """[..., v, u] int32 quantized coefficients → spatial samples.

    Dequantization (coef × q) is fused into pass 1 exactly like the
    reference (idct_ijg.go IDCTISlow: columns first, then rows).  Output
    is the signed sample value BEFORE level shift/clamp.

    p1=1 (the >8-bit profile) additionally halves the dequantized
    coefficients with round-half-up and compensates in the final descale
    — max-amplitude 12-bit AC coefficients need that extra int32
    headroom (≈2^31.3 without it); the precision cost is far below one
    output LSB.  The reference's own 12-bit decoder is naive float64
    (sequential12.go:628-647), so there is no integer semantic to match;
    accuracy is bounded by roundtrip tests.
    """
    q = _astype(qtable.reshape((1,) * (coeffs.ndim - 2) + (8, 8)),
                coeffs.dtype)
    d = coeffs * q                               # [..., v, u]
    if p1 == 1:
        d = (d + 1) >> 1                         # halve, compensated below
    t = xp.swapaxes(d, -1, -2)                   # [..., u, v]: columns
    w = _idct_pass(t, xp, final=False, p1=p1)    # [..., u, y]
    w = xp.swapaxes(w, -1, -2)                   # [..., y, u]: rows
    s = _idct_pass(w, xp, final=True,
                   p1=p1 if p1 != 1 else 0)      # [..., y, x]
    return s
