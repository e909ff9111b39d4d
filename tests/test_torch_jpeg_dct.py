"""Port parity: the JPEG codecs' integer islow DCT stages, bit for bit.

The port's plain ``encode_plane_to_zigzag`` and ``decode_zigzag_to_plane``
(ops/dct8x8.py, the plain versions of the kernels of csrc/jpeg_islow.cu),
their numpy mirrors, the ops wrappers on the CPU (ops/jpeg_islow.py) and
the numpy lane of the ported ``dct_int`` against the reference's jitted jnp
functions and its numpy mirrors, on seeded inputs at the chip phase's
shapes (its [32, 512, 512] cut to [2, 64, 64]), both precision profiles,
qualities 1, 50, 90 and 100, and the wraparound cases: 16-bit samples
under the 12-bit profile, and coefficients of ±32768 with a table of
65535s. A numpy model of each kernel's launch (its threads' blocks, rows,
edge-clamped loads, tile transposes, its C quantizer and its lanes'
zigzag loads and stores, at the kernel's own index arithmetic) is held
against the same results, with every output element written exactly
once. Also the zigzag tables and RGB ↔ YCbCr both ways on a seeded sample
of uint8 triples, and the wrappers' refusals.

Tolerance: 0 everywhere (integer stages).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.codecs import jpeg_common as ref_jc
from go_dicom_codec_tpu.ops import dct8x8 as ref
from go_dicom_codec_tpu.ops import dct_int as ref_int
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch.ops import dct8x8 as port
from go_dicom_codec_torch.ops import dct_int as port_int
from go_dicom_codec_torch.ops import jpeg_islow

SHAPES = ((2, 64, 64), (3, 37, 45), (1, 1, 1), (2, 8, 4095), (1, 4095, 8))
PROFILES = {"8bit": (8, 128, np.uint8), "12bit": (12, 2048, np.uint16)}
QUALITIES = (1, 50, 90, 100)
ISLOW_SRC = (Path(__file__).resolve().parent.parent / "go_dicom_codec_torch"
             / "csrc" / "jpeg_islow.cu")
CTA_BLOCKS = 32  # kBlocks of csrc/jpeg_islow.cu: 256 threads, 8 a block
ZZ = port.ZIGZAG  # raster position of each zigzag index


def _samples(seed, shape, bits, dtype):
    return np.random.default_rng(seed).integers(0, 1 << bits, shape
                                                ).astype(dtype)


def _qtable(quality):
    return ref_jc.scale_quant_table(ref_jc.LUMA_QUANT, quality, 255)


def _p1(level):
    return port_int.pass1_bits(level)


# ---- numpy models of the two kernels' launches -----------------------------

def _kernel_constant(name):
    """A constexpr of csrc/jpeg_islow.cu, read from the source."""
    m = re.search(rf"constexpr \w+ {name} = (\d+);", ISLOW_SRC.read_text())
    return int(m.group(1))


def _wrap(v):
    """int64 values wrapped to int32, as the kernel's unsigned arithmetic."""
    return ((np.asarray(v, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31)


def recip_quantize(c, q):
    """The kernel's quantize(): num = |c| + d/2 in unsigned (|INT32_MIN| is
    2^31), its wrap mask (num >> 31 as int32), ⌊(num ^ mask) / d⌋ by
    umulhi(·, m) >> s on the host's ``reciprocals`` of d = 8q, ^ mask, the
    sign put back with wraparound. c and q broadcast; returns int32."""
    c = np.asarray(c, np.int64)
    d = 8 * np.asarray(q, np.int64)
    k = jpeg_islow.reciprocals(d)
    m, s = k[..., 0] & 0xFFFFFFFF, k[..., 1]
    num = np.where(c < 0, -c, c) + (d >> 1)
    mask = np.where(num >= 2 ** 31, 0xFFFFFFFF, 0)
    n = num ^ mask
    assert (n < 2 ** 31).all()
    quot = (((n * m) >> 32) >> s) ^ mask
    return _wrap(np.where(c < 0, -quot, quot)).astype(np.int32)


def _geometry(nby, nbx):
    """grid_of(): the CTA tile's log2 columns, the log2 of the tiles a
    plane takes across in grid x (a power of two) and grid y."""
    log_c = 0
    while (1 << log_c) < nbx and log_c < 5:
        log_c += 1
    across = (nbx + (1 << log_c) - 1) >> log_c
    log_gx = 0
    while (1 << log_gx) < across:
        log_gx += 1
    rows = 5 - log_c
    return log_c, log_gx, (nby + (1 << rows) - 1) >> rows


def _ctas(nby, nbx, planes):
    """Every CTA of a launch: the CTA tile's log2 columns and [n, 1]
    arrays of the CTA's plane (blockIdx.x >> log_gx), tile across
    (blockIdx.x & (2^log_gx - 1)) and tile down (blockIdx.y)."""
    log_c, log_gx, gy = _geometry(nby, nbx)
    bx_, by_ = np.meshgrid(np.arange(planes << log_gx), np.arange(gy),
                           indexing="ij")
    bx_, by_ = bx_.reshape(-1, 1), by_.reshape(-1, 1)
    return log_c, bx_ >> log_gx, bx_ & ((1 << log_gx) - 1), by_


def _block_of(log_c, cx, cy, lb):
    """block_of(): (by, bx) of CTA-local block lb, by shifts and masks."""
    bx = (cx << log_c) + (lb & ((1 << log_c) - 1))
    by = (cy << (5 - log_c)) + (lb >> log_c)
    return by, bx


TID = np.arange(256)
R, LB, LANE, WB = TID & 7, TID >> 3, TID & 31, (TID >> 5) * 4


def fdct_kernel_model(x, qtable, level):
    """csrc/jpeg_islow.cu's forward launch over [P, H, W] samples: every
    thread of every CTA (a plane's tile), its edge-clamped row load, the
    row pass (the level shift subtracted from o[0] alone) into its block's
    tile, the column pass back into it, then
    each lane's four zigzag indices of two of its warp's blocks read,
    quantized by the reciprocal quantizer and stored at the warp's run of
    coefficients (its first block's offset, the lane's 16 bytes), every
    coefficient stored exactly once."""
    p_, h, w = x.shape
    nby, nbx = -(-h // 8), -(-w // 8)
    log_c, pl, cx, cy = _ctas(nby, nbx, p_)
    n = len(pl)
    by, bx = _block_of(log_c, cx, cy, LB[None])
    live = (by < nby) & (bx < nbx)
    y = np.minimum(by * 8 + R, h - 1)
    cols = np.minimum(bx[..., None] * 8 + np.arange(8), w - 1)
    d = x[pl[..., None], y[..., None], cols].astype(np.int32)
    rows = port_int._fdct_pass(d, np, final=False, p1=_p1(level))
    # the level shift out of the samples: mod 2^32 it moves o[0] alone
    rows[..., 0] = _wrap(rows[..., 0].astype(np.int64)
                         - level * (8 << _p1(level)))
    it = np.broadcast_to(np.arange(n)[:, None], live.shape)
    lb = np.broadcast_to(LB, live.shape)
    r = np.broadcast_to(R, live.shape)
    tile = np.zeros((n, CTA_BLOCKS, 8, 8), np.int32)
    tile[it[live], lb[live], r[live]] = rows[live]
    col = tile[it, lb, :, r]
    f = port_int._fdct_pass(col, np, final=True, p1=_p1(level))  # [., v]
    tile[it[live], lb[live], :, r[live]] = f[live]
    q = np.asarray(qtable, np.int32).reshape(64)
    # each lane: zigzag z0..z0 + 3 of blocks lane / 16 (+ 2), at the
    # warp's run of 256 coefficients from its first block
    flat = np.zeros(p_ * nby * nbx * 64, np.int32)
    writes = np.zeros(flat.shape, np.int64)
    wy, wx = _block_of(log_c, cx, cy, np.broadcast_to(WB, (n, 256)))
    run = pl * (nby * nbx * 64) + (wy * nbx + wx) * 64     # [n, 256]
    z0 = (LANE * 4) & 63
    for h in range(2):
        j = (LANE >> 4) + 2 * h
        b = np.broadcast_to(WB + j, (n, 256))
        jy, jx = _block_of(log_c, cx, cy, b)
        ok = (jy < nby) & (jx < nbx)
        for i in range(4):
            z = np.broadcast_to(z0 + i, (n, 256))
            at = (run + LANE * 4 + 128 * h + i)[ok]
            flat[at] = recip_quantize(
                tile[it[ok], b[ok], ZZ[z[ok]] >> 3, ZZ[z[ok]] & 7],
                q[ZZ[z[ok]]])
            np.add.at(writes, at, 1)
    out = flat.reshape(p_, nby, nbx, 64)
    assert (writes == 1).all(), "a coefficient not stored exactly once"
    return out


def idct_kernel_model(zz, qtable, level, max_val, table_index=None):
    """csrc/jpeg_islow.cu's inverse launch over [P, nby, nbx, 64] int16 or
    int32 coefficients: each CTA's table (``qtable``: one table, or [T,
    64] with ``table_index``), each lane's 16-byte loads (8 int16 or 4
    int32 zigzag indices of one of its warp's blocks, at the warp's run
    of coefficients) widened and dequantized into the tiles, the column
    and row passes through the tile and each thread's one row store,
    every sample stored exactly once."""
    p_, nby, nbx, _ = zz.shape
    tables = np.asarray(qtable, np.int32).reshape(-1, 64)
    tidx = np.zeros(p_, np.int64) if table_index is None else \
        np.asarray(table_index, np.int64)
    log_c, pl, cx, cy = _ctas(nby, nbx, p_)
    n = len(pl)
    p1 = _p1(level)
    q = tables[tidx[pl[:, 0]]]                          # [n, 64]
    tile = np.zeros((n, CTA_BLOCKS, 8, 8), np.int32)
    it = np.broadcast_to(np.arange(n)[:, None], (n, 256))
    flat = zz.reshape(-1)
    per = 8 if zz.dtype == np.int16 else 4     # 16 bytes a load
    wy, wx = _block_of(log_c, cx, cy, np.broadcast_to(WB, (n, 256)))
    run = pl * (nby * nbx * 64) + (wy * nbx + wx) * 64
    for h in range(256 // (32 * per)):
        e = (h * 32 + LANE) * per
        j = e >> 6
        b = np.broadcast_to(WB + j, (n, 256))
        jy, jx = _block_of(log_c, cx, cy, b)
        ok = (jy < nby) & (jx < nbx)
        for i in range(per):
            z = np.broadcast_to((e & 63) + i, (n, 256))
            c = np.where(ok, flat[np.where(ok, run + e + i, 0)]
                         .astype(np.int32), 0)
            dq = _wrap(c.astype(np.int64) * q[it, ZZ[z]]).astype(np.int32)
            if p1 == 1:
                dq = (dq + np.int32(1)) >> 1
            tile[it, b, ZZ[z] >> 3, ZZ[z] & 7] = dq
    lb = np.broadcast_to(LB, (n, 256))
    r = np.broadcast_to(R, (n, 256))
    tile[it, lb, :, r] = port_int._idct_pass(tile[it, lb, :, r], np,
                                             final=False, p1=p1)
    s = port_int._idct_pass(tile[it, lb, r, :], np, final=True,
                            p1=p1 if p1 != 1 else 0)
    by, bx = _block_of(log_c, cx, cy, LB[None])
    live = (by < nby) & (bx < nbx)
    out = np.full((p_, nby * 8, nbx * 8), -1, np.int64)
    writes = np.zeros(out.shape, np.int64)
    px = np.clip(s + np.int32(level), 0, max_val)
    cols = bx[..., None] * 8 + np.arange(8)
    at = (np.broadcast_to(pl, live.shape)[live, None],
          (by * 8 + r)[live, None], cols[live])
    out[at] = px[live]
    np.add.at(writes, at, 1)
    assert (writes == 1).all(), "a sample not stored exactly once"
    return out.astype(np.int32)


# ---- the stages against the reference --------------------------------------

def _forward_lanes(x, q, level):
    """Every lane's forward result on samples x: {lane: int32 array}."""
    xt = torch.as_tensor(x)
    return {
        "ref_jnp": np.asarray(ref.encode_plane_to_zigzag(
            jnp.asarray(x.astype(np.int32)), jnp.asarray(q),
            level_shift=level)),
        "ref_np": ref.encode_plane_to_zigzag_np(x, q, level),
        "port_plain": port.encode_plane_to_zigzag(xt, q, level).numpy(),
        "port_np": port.encode_plane_to_zigzag_np(x, q, level),
        "ops_cpu": jpeg_islow.fdct_islow(xt, q, level).numpy(),
        "kernel_model": fdct_kernel_model(x, q, level),
    }


def _inverse_lanes(zz, q, level, max_val):
    zt = torch.as_tensor(zz)
    dt = jpeg_islow.plane_dtype(max_val)
    lanes = {}
    if zz.min() >= -32768 and zz.max() <= 32767:  # the pipelines' upload
        lanes["kernel_model_int16"] = idct_kernel_model(
            zz.astype(np.int16), q, level, max_val)
        lanes["ops_cpu_int16"] = jpeg_islow.idct_islow(
            zt.to(torch.int16), q, level, max_val, dt).numpy()
    # as the one table of a stack of two, every plane indexing it
    stack = np.stack([np.full(64, 7, np.int32),
                      np.asarray(q, np.int32).reshape(64)])
    ones = np.ones(int(np.prod(zz.shape[:-3])), np.int64)
    lanes["kernel_model_stack"] = idct_kernel_model(
        zz, stack, level, max_val, ones)
    lanes["ops_cpu_stack"] = jpeg_islow.idct_islow(
        zt, stack, level, max_val, dt, table_index=tuple(ones)).numpy()
    return {**lanes,
        "ref_jnp": np.asarray(ref.decode_zigzag_to_plane(
            jnp.asarray(zz), jnp.asarray(q), level_shift=level,
            max_val=max_val)),
        "ref_np": ref.decode_zigzag_to_plane_np(zz, q, level, max_val),
        "port_plain": port.decode_zigzag_to_plane(zt, q, level,
                                                  max_val).numpy(),
        "port_np": port.decode_zigzag_to_plane_np(zz, q, level, max_val),
        "ops_cpu": jpeg_islow.idct_islow(zt, q, level, max_val).numpy(),
        "ops_cpu_narrow": jpeg_islow.idct_islow(zt, q, level, max_val,
                                                dt).numpy(),
        "kernel_model": idct_kernel_model(zz, q, level, max_val),
    }


def _assert_all_equal(lanes):
    want = lanes.pop("ref_jnp")
    for name, got in lanes.items():
        assert got.shape == want.shape, name
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), \
            name


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_inverse_match_reference(shape, profile, quality):
    bits, level, dtype = PROFILES[profile]
    x = _samples(sum(shape) + quality, shape, bits, dtype)
    q = _qtable(quality)
    fwd = _forward_lanes(x, q, level)
    zz = np.array(fwd["ref_jnp"])
    assert zz.dtype == np.int32
    assert zz.shape == (shape[0], -(-shape[1] // 8), -(-shape[2] // 8), 64)
    _assert_all_equal(fwd)
    _assert_all_equal(_inverse_lanes(zz, q, level, (1 << bits) - 1))


@pytest.mark.parametrize("quality", QUALITIES)
def test_16bit_samples_wrap_under_the_12bit_profile(quality):
    """Samples up to 65535 at level shift 2048: coefficients pass int16
    (93178 at the extreme) and the int32 products wrap; every lane wraps
    alike. The extreme block (alternating 0 / 65535 columns) is planted."""
    x = _samples(quality, (2, 16, 40), 16, np.uint16)
    x[0, :8, :8] = np.where(np.arange(8) % 2, 65535, 0)[None]
    x[1, :8, 8:16] = 65535
    fwd = _forward_lanes(x, _qtable(quality), 2048)
    if quality == 100:
        assert np.abs(fwd["ref_jnp"]).max() > 32767
    _assert_all_equal(fwd)
    zz = np.array(ref.encode_plane_to_zigzag(
        jnp.asarray(x.astype(np.int32)), jnp.asarray(_qtable(quality)),
        level_shift=2048))
    _assert_all_equal(_inverse_lanes(zz, _qtable(quality), 2048, 65535))


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_inverse_wraps_on_hostile_coefficients(profile):
    """±32768 coefficients with a 16-bit table of 65535s: the dequantized
    products reach 2^31 and the passes wrap; every lane wraps alike."""
    bits, level, _ = PROFILES[profile]
    rng = np.random.default_rng(bits)
    zz = rng.choice(np.array([-32768, 32767, 0, 1, -1], np.int32),
                    (2, 3, 5, 64))
    zz[0, 0, 0] = 32767
    zz[0, 0, 1] = -32768
    q = np.full((8, 8), 65535, np.int32)
    _assert_all_equal(_inverse_lanes(zz, q, level, (1 << bits) - 1))


@pytest.mark.parametrize("p1", (1, 2))
def test_dct_int_lanes_match_reference(p1):
    """The ported dct_int, numpy and torch lanes, against the reference's
    numpy lane, transform by transform: forward, quantizer, inverse."""
    rng = np.random.default_rng(p1)
    blocks = rng.integers(-32768, 32768, (4, 3, 8, 8)).astype(np.int32)
    coeffs = rng.integers(-40000, 40000, (4, 3, 8, 8)).astype(np.int32)
    coeffs[0, 0, 0, 0] = -2 ** 31          # |INT32_MIN| wraps
    coeffs[0, 0, 0, 1] = 2 ** 31 - 1        # the rounding sum wraps
    q = _qtable(1 if p1 == 1 else 90)
    for xp, conv in ((np, np.asarray), (torch, torch.as_tensor)):
        def as_np(v):
            return v.numpy() if isinstance(v, torch.Tensor) else v
        b, c, qq = conv(blocks), conv(coeffs), conv(q)
        pairs = (
            (port_int.fdct8x8_islow(b, xp, p1),
             ref_int.fdct8x8_islow(blocks, np, p1)),
            (port_int.quantize_islow(c, qq, xp),
             ref_int.quantize_islow(coeffs, q, np)),
            (port_int.idct8x8_islow(c, qq, xp, p1),
             ref_int.idct8x8_islow(coeffs, q, np, p1)))
        for got, want in pairs:
            got = as_np(got)
            assert got.dtype == want.dtype == np.int32
            assert np.array_equal(got, want)
    assert recip_quantize(coeffs, 3).tolist() == ref_int.quantize_islow(
        coeffs, np.full((8, 8), 3, np.int32), np).tolist()


def test_zigzag_tables_and_scans_match_reference():
    assert np.array_equal(port.ZIGZAG, ref.ZIGZAG)
    assert np.array_equal(port.INV_ZIGZAG, ref.INV_ZIGZAG)
    assert port.ZIGZAG.dtype == port.INV_ZIGZAG.dtype == np.int32
    blocks = np.arange(3 * 64, dtype=np.int32).reshape(3, 8, 8)
    zz = port.zigzag_scan(torch.as_tensor(blocks))
    assert np.array_equal(zz.numpy(),
                          np.asarray(ref.zigzag_scan(jnp.asarray(blocks))))
    assert np.array_equal(port.inv_zigzag_scan(zz).numpy(), blocks)


def test_ycbcr_matches_reference_both_ways():
    """Every triple of a seeded sample of 2^16 uint8 triples (and the
    eight corners of the cube), through the torch and numpy forms."""
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    rgb[0, :8] = np.array([[r, g, b] for r in (0, 255) for g in (0, 255)
                           for b in (0, 255)], np.uint8)
    for fwd in (True, False):
        pf, pnp, rf, rnp = ((port.rgb_to_ycbcr, port.rgb_to_ycbcr_np,
                             ref.rgb_to_ycbcr, ref.rgb_to_ycbcr_np) if fwd
                            else (port.ycbcr_to_rgb, port.ycbcr_to_rgb_np,
                                  ref.ycbcr_to_rgb, ref.ycbcr_to_rgb_np))
        want = np.asarray(rf(jnp.asarray(rgb)))
        assert np.array_equal(rnp(rgb), want)
        got = pf(torch.as_tensor(rgb))
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(pnp(rgb), want)


# ---- the reciprocal quantizer and the launch geometry ----------------------

DIVISORS = 8 * np.arange(1, 65536, dtype=np.int64)


def _numerators(kind, rng):
    """[k, 65535] numerators num = |c| + d/2 of each divisor d = 8q."""
    d = DIVISORS
    top = (2 ** 31 - 1) // d * d                 # the last multiple below 2^31
    return {
        "zero_and_half": [np.zeros_like(d), d // 2 - 1, d // 2, d // 2 + 1],
        "multiples": [d - 1, d, d + 1, 2 * d - 1, 2 * d, 2 * d + 1],
        "near_2_31": [top - 1, top, top + 1, top - d, top - d + 1,
                      np.full_like(d, 2 ** 31 - 1)],
        "random": list(rng.integers(0, 2 ** 31, (8, d.size))),
    }[kind]


@pytest.mark.parametrize("kind", ("zero_and_half", "multiples", "near_2_31",
                                  "random", "wrapped"))
def test_reciprocal_quantizer_matches_reference_for_every_divisor(kind):
    """The kernel's quantize() (``recip_quantize``, on the host's
    ``reciprocals``) against the reference's ``quantize_islow`` for every
    d = 8q, q in 1..65535, at coefficients ±(num − d/2) for edge
    numerators (0, d/2 ± 1, kd − 1, kd, kd + 1 up to 2^31 − 1) and seeded
    ones, and where the sum wraps (|c| within d/2 of 2^31, INT32_MIN)."""
    rng = np.random.default_rng(15)
    d = DIVISORS
    if kind == "wrapped":
        coeffs = [np.full_like(d, -2 ** 31), np.full_like(d, 2 ** 31 - 1),
                  np.full_like(d, -2 ** 31 + 1), 2 ** 31 - d // 2,
                  2 ** 31 - 1 - d // 2, 2 ** 31 - d // 2 - 1,
                  2 ** 31 - 1 - rng.integers(0, d // 2 + 1)]
        coeffs += [-c for c in coeffs[1:]]
    else:
        coeffs = [sign * (n - d // 2) for n in _numerators(kind, rng)
                  for sign in (1, -1)]
    c = np.clip(np.stack(coeffs), -2 ** 31, 2 ** 31 - 1)     # [k, 65535]
    got = recip_quantize(c, d // 8)
    q = np.append(d // 8, 1).reshape(-1, 8, 8)             # 1024 tables
    cc = np.concatenate([c, np.zeros((len(c), 1), np.int64)], axis=1
                        ).astype(np.int32).reshape(len(c), -1, 8, 8)
    want = np.stack([ref_int.quantize_islow(cc[:, t], q[t], np)
                     for t in range(len(q))], axis=1).reshape(len(c), -1)
    assert np.array_equal(got, want[:, :d.size])
    k = jpeg_islow.reciprocals(d)
    assert (k[:, 1] >= 2).all() and (k[:, 1] <= 18).all()
    m = k[:, 0] & 0xFFFFFFFF
    assert ((m >= 2 ** 31) & (m < 2 ** 32)).all()


def test_launch_constants_match_the_source():
    """The models' CTA constants and zigzag tile words are the kernel's,
    and neither kernel (nor its host code) divides: no / or % outside
    comments."""
    assert 1 << _kernel_constant("kLogBlocks") == CTA_BLOCKS
    src = ISLOW_SRC.read_text()
    table = src[src.index("kZigzagTile[16] = {"):]
    words = [int(v) for v in re.findall(r"\d+", table[:table.index("};")])]
    assert words[1:] == [(p >> 3) * 9 + (p & 7) for p in ZZ.tolist()]
    assert _kernel_constant("kPitch") == 9
    code = re.sub(r"//[^\n]*", "", ISLOW_SRC.read_text())
    assert "/" not in code and "%" not in code


@pytest.mark.parametrize("nbx", (1, 2, 3, 4, 5, 8, 9, 31, 32, 33, 64, 512))
def test_cta_tile_covers_block_columns(nbx):
    """grid_of's tiles: 2^log_c columns (the least power of two >= nbx,
    at most 32) by 32 >> log_c rows, the tiles across a plane rounded up
    to a power of two in grid x, times 3 planes; every block of every
    plane lies in one CTA once, a surplus tile holds none, and a warp's
    four blocks are neighbours in one block row from 4 columns on."""
    nby, planes = 7, 3
    log_c, log_gx, _ = _geometry(nby, nbx)
    assert 1 << log_c == min(32, 1 << (nbx - 1).bit_length())
    assert (1 << log_gx) >= -(-nbx // (1 << log_c)) > (1 << log_gx) // 2
    _, pl, cx, cy = _ctas(nby, nbx, planes)
    by, bx = _block_of(log_c, cx, cy, np.arange(CTA_BLOCKS)[None])
    live = (by < nby) & (bx < nbx)
    seen = np.zeros((planes, nby, nbx), np.int64)
    np.add.at(seen, (np.broadcast_to(pl, live.shape)[live], by[live],
                     bx[live]), 1)
    assert (seen == 1).all()
    if log_c >= 2:
        warp = np.arange(CTA_BLOCKS).reshape(-1, 4)
        assert (np.diff(by[0][warp], axis=1) == 0).all()
        assert (np.diff(bx[0][warp], axis=1) == 1).all()


@pytest.mark.parametrize("nbx", (1, 5, 33, 70))
@pytest.mark.parametrize("coef", ("int16", "int32"))
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_table_stack_inverse_matches_reference(profile, coef, nbx):
    """One inverse launch over 7 planes of three tables (a seeded index a
    plane, as a chunk's luma and chroma), int16 or int32 coefficients in,
    ``nbx`` block columns (70: three tiles across, rounded up to four in
    grid x): the kernel model and the ops wrapper's plain loop over the
    tables equal the reference's numpy lane plane by plane."""
    bits, level, _ = PROFILES[profile]
    rng = np.random.default_rng(bits + nbx)
    zz = rng.integers(-300, 300, (7, 3, nbx, 64)).astype(np.int32)
    zz[..., 0] = rng.integers(-2000, 2000, (7, 3, nbx))
    tables = np.stack([_qtable(q).reshape(64) for q in (50, 90, 10)])
    index = rng.integers(0, 3, 7)
    index[:3] = (2, 0, 1)
    max_val = (1 << bits) - 1
    want = np.stack([ref.decode_zigzag_to_plane_np(zz[p], tables[t], level,
                                                   max_val)
                     for p, t in enumerate(index)])
    src = zz.astype(np.int16) if coef == "int16" else zz
    got = idct_kernel_model(src, tables, level, max_val, index)
    assert np.array_equal(got, want)
    ops = jpeg_islow.idct_islow(torch.as_tensor(src), tables, level,
                                max_val, jpeg_islow.plane_dtype(max_val),
                                table_index=tuple(index))
    assert np.array_equal(ops.numpy().astype(np.int64), want)
    with pytest.raises(ValueError, match="table indices"):
        jpeg_islow.idct_islow(torch.as_tensor(src), tables, level, max_val,
                              table_index=(0, 1))


# ---- the wrappers' refusals ------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors_and_bad_arguments():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    q = torch.ones(64, dtype=torch.int32)
    recip = torch.zeros((64, 2), dtype=torch.int32)
    out = torch.empty((1, 1, 1, 64), dtype=torch.int32)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.jpeg_fdct_islow(x, out, recip, 128)
    with pytest.raises(_kernels.KernelLaunchError, match="no route"):
        _kernels.jpeg_fdct_islow(x.to(torch.int16), out, recip, 128)
    zz = torch.zeros((1, 1, 1, 64), dtype=torch.int32)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.jpeg_idct_islow(zz, torch.empty((1, 8, 8),
                                                 dtype=torch.uint8),
                                 q.view(1, 64), 128, 255)
    with pytest.raises(_kernels.KernelLaunchError, match="no route"):
        _kernels.jpeg_idct_islow(zz, torch.empty((1, 8, 8),
                                                 dtype=torch.int16),
                                 q.view(1, 64), 128, 255)
    with pytest.raises(_kernels.KernelLaunchError, match="no route"):
        _kernels.jpeg_idct_islow(zz.to(torch.int64), torch.empty(
            (1, 8, 8), dtype=torch.uint8), q.view(1, 64), 128, 255)


def test_ops_check_tables_and_devices():
    cpu = torch.device("cpu")
    bad = np.ones(64, np.int32)
    bad[5] = 0       # a zero divisor: the forward refuses it
    with pytest.raises(_kernels.KernelLaunchError, match="quant table"):
        jpeg_islow._tables(bad, cpu, 1, recip=True)
    tables, recip = jpeg_islow._tables(bad, cpu, 0)     # zigzag order
    assert recip is None and tables.tolist() == [bad[ZZ].tolist()]
    assert jpeg_islow._tables(bad, cpu, 0)[0] is tables     # built once
    with pytest.raises(_kernels.KernelLaunchError, match="quant table"):
        jpeg_islow._tables(np.full(64, 65536), cpu, 0)
    with pytest.raises(_kernels.KernelLaunchError, match="64 entries"):
        jpeg_islow._tables(np.ones(65), cpu, 0)
    with pytest.raises(_kernels.KernelLaunchError, match="64 entries"):
        jpeg_islow._tables(np.ones((2, 64)), cpu, 1, recip=True)
    stack, _ = jpeg_islow._tables(np.arange(192).reshape(3, 8, 8), cpu, 0)
    assert stack.shape == (3, 64) and stack.dtype == torch.int32
    assert stack.is_contiguous()            # as the CUDA wrapper needs
    assert stack.tolist() == np.arange(192).reshape(3, 64)[:, ZZ].tolist()
    q = _qtable(90)
    tables, recip = jpeg_islow._tables(q, cpu, 1, recip=True)
    assert recip.shape == (64, 2) and recip.dtype == torch.int32
    k = jpeg_islow.reciprocals(8 * q.reshape(64)[ZZ].astype(np.int64))
    assert recip[:, 0].tolist() == k[:, 0].tolist()
    assert recip[:, 1].tolist() == (
        (4 * q.reshape(64)[ZZ].astype(np.int64)) << 5 | k[:, 1]).tolist()
    assert jpeg_islow._index((0, 0), 1, cpu) is None    # table 0: no index
    assert jpeg_islow._index((1, 0), 2, cpu).tolist() == [1, 0]
    with pytest.raises(ValueError, match="table index"):
        jpeg_islow._index((0, 2), 2, cpu)
    with pytest.raises(ValueError, match="does not fit"):
        jpeg_islow.idct_islow(torch.zeros((1, 1, 64), dtype=torch.int32),
                              np.ones(64), 2048, 4095, torch.uint8)
    meta = torch.zeros((1, 8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no lane"):
        jpeg_islow.fdct_islow(meta, np.ones(64))
    with pytest.raises(ValueError, match="no lane"):
        jpeg_islow.idct_islow(meta.to(torch.int32).view(1, 1, 64),
                              np.ones(64))
    assert [jpeg_islow.plane_dtype(m) for m in (255, 4095, 65535, 65536)] \
        == [torch.uint8, torch.uint16, torch.uint16, torch.int32]


def test_device_bench_islow_rows_agree_on_the_cpu():
    """The device bench's islow rows: both lanes give the same result on
    CPU tensors, and the bound counts uint16 samples and int32 (or int16)
    coefficients."""
    from go_dicom_codec_torch.tools import device_bench

    x = torch.as_tensor(_samples(9, (2, 24, 40), 12, np.int32))
    rows = device_bench._jpeg_steps(x)
    assert sorted(rows) == ["dct8x8_quant_zigzag", "idct8x8_dequant",
                            "idct8x8_dequant_int16"]
    for name, (lanes, bound) in rows.items():
        assert torch.equal(lanes["kernel"](), lanes["plain"]())
        per = 4 if name.endswith("int16") else 6
        assert bound == pytest.approx(x.numel() * per / 3.35e12 * 1e3)
    assert rows["idct8x8_dequant_int16"][0]["kernel"]().equal(
        rows["idct8x8_dequant"][0]["kernel"]())
