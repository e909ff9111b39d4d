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
CTA_BLOCKS = 32  # kBlocks of csrc/jpeg_islow.cu: 256 threads, 8 a block


def _samples(seed, shape, bits, dtype):
    return np.random.default_rng(seed).integers(0, 1 << bits, shape
                                                ).astype(dtype)


def _qtable(quality):
    return ref_jc.scale_quant_table(ref_jc.LUMA_QUANT, quality, 255)


def _p1(level):
    return port_int.pass1_bits(level)


# ---- numpy models of the two kernels' launches -----------------------------

def _c_quantize(c, d):
    """The kernel's quantize(): |c| and the sum wrap, C's truncating
    division, then the floor fix."""
    c = c.astype(np.int32)
    mag = np.where(c < 0, np.int32(0) - c, c)
    num = (mag + (d >> 1)).astype(np.int32)
    n64, d64 = num.astype(np.int64), d.astype(np.int64)
    q = np.sign(n64) * (np.abs(n64) // d64)          # truncation
    q = q - ((n64 < 0) & (q * d64 != n64))           # to the floor
    return np.where(c < 0, -q, q).astype(np.int64).astype(np.int32)


def _threads(n_blocks):
    """Every thread of the launch: (cta, r, lb, first, g, lane, wb)."""
    grid = -(-n_blocks // CTA_BLOCKS)
    t = np.arange(grid * 256)
    cta, tid = t // 256, t % 256
    first = cta * CTA_BLOCKS
    return (cta, tid & 7, tid >> 3, first, first + (tid >> 3), tid & 31,
            (tid >> 5) * 4, grid)


def fdct_kernel_model(x, qtable, level):
    """csrc/jpeg_islow.cu's forward launch over [P, H, W] samples."""
    p_, h, w = x.shape
    nby, nbx = -(-h // 8), -(-w // 8)
    per, n_blocks = nby * nbx, p_ * nby * nbx
    cta, r, lb, first, g, lane, wb, grid = _threads(n_blocks)
    live = g < n_blocks
    plane = np.where(live, g // per, 0)
    rem = np.where(live, g - plane * per, 0)
    by, bx = rem // nbx, rem - (rem // nbx) * nbx
    y = np.minimum(by * 8 + r, h - 1)
    cols = np.minimum(bx[:, None] * 8 + np.arange(8), w - 1)
    d = (x[plane[:, None], y[:, None], cols].astype(np.int32)
         - np.int32(level))
    rows = port_int._fdct_pass(d, np, final=False, p1=_p1(level))
    tile = np.zeros((grid, CTA_BLOCKS, 8, 8), np.int32)
    tile[cta[live], lb[live], r[live]] = rows[live]
    col = tile[cta, lb, :, r]
    f = port_int._fdct_pass(col, np, final=True, p1=_p1(level))  # [t, v]
    q = np.asarray(qtable, np.int32).reshape(64)
    div = q[np.arange(8)[None] * 8 + r[:, None]] * np.int32(8)
    tile[cta[live], lb[live], :, r[live]] = _c_quantize(f, div)[live]
    out = np.zeros(n_blocks * 64, np.int32)
    writes = np.zeros(n_blocks * 64, np.int64)
    for k in range(8):
        b = wb + (k >> 1)
        z = lane + 32 * (k & 1)
        p = ref.ZIGZAG[z]
        ok = first + b < n_blocks
        at = ((first + b) * 64 + z)[ok]
        out[at] = tile[cta[ok], b[ok], p[ok] >> 3, p[ok] & 7]
        np.add.at(writes, at, 1)
    assert (writes == 1).all(), "a coefficient not stored exactly once"
    return out.reshape(p_, nby, nbx, 64)


def idct_kernel_model(zz, qtable, level, max_val):
    """csrc/jpeg_islow.cu's inverse launch over [P, nby, nbx, 64]."""
    p_, nby, nbx, _ = zz.shape
    per, n_blocks = nby * nbx, p_ * nby * nbx
    cta, r, lb, first, g, lane, wb, grid = _threads(n_blocks)
    flat = zz.reshape(-1).astype(np.int32)
    q = np.asarray(qtable, np.int32).reshape(64)
    p1 = _p1(level)
    tile = np.zeros((grid, CTA_BLOCKS, 8, 8), np.int32)
    for k in range(8):
        b = wb + (k >> 1)
        z = lane + 32 * (k & 1)
        p = ref.ZIGZAG[z]
        ok = first + b < n_blocks
        c = np.where(ok, flat[np.where(ok, (first + b) * 64 + z, 0)], 0)
        dq = (c * q[p]).astype(np.int32)
        if p1 == 1:
            dq = (dq + np.int32(1)) >> 1
        tile[cta, b, p >> 3, p & 7] = dq
    w_ = port_int._idct_pass(tile[cta, lb, :, r], np, final=False, p1=p1)
    tile[cta, lb, :, r] = w_
    s = port_int._idct_pass(tile[cta, lb, r, :], np, final=True,
                            p1=p1 if p1 != 1 else 0)
    live = g < n_blocks
    plane = g // per
    rem = g - plane * per
    by, bx = rem // nbx, rem - (rem // nbx) * nbx
    out = np.full((p_, nby * 8, nbx * 8), -1, np.int64)
    px = np.clip(s + np.int32(level), 0, max_val)
    cols = bx[:, None] * 8 + np.arange(8)
    out[plane[live, None], (by * 8 + r)[live, None], cols[live]] = px[live]
    assert (out >= 0).all(), "a sample not stored"
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
    return {
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
    assert _c_quantize(coeffs, np.full(coeffs.shape, 8 * 3, np.int32)
                       ).tolist() == ref_int.quantize_islow(
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


# ---- the wrappers' refusals ------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors_and_bad_arguments():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    q = torch.ones(64, dtype=torch.int32)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.jpeg_fdct_islow(x, torch.empty((1, 1, 1, 64),
                                                dtype=torch.int32), q, 128)
    with pytest.raises(_kernels.KernelLaunchError, match="no route"):
        _kernels.jpeg_fdct_islow(x.to(torch.int16), torch.empty(
            (1, 1, 1, 64), dtype=torch.int32), q, 128)
    zz = torch.zeros((1, 1, 1, 64), dtype=torch.int32)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.jpeg_idct_islow(zz, torch.empty((1, 8, 8),
                                                 dtype=torch.uint8), q, 128,
                                 255)
    with pytest.raises(_kernels.KernelLaunchError, match="no route"):
        _kernels.jpeg_idct_islow(zz, torch.empty((1, 8, 8),
                                                 dtype=torch.int16), q, 128,
                                 255)


def test_ops_check_tables_and_devices():
    bad = np.ones(64, np.int32)
    bad[5] = 0       # a zero divisor: the forward refuses it
    with pytest.raises(_kernels.KernelLaunchError, match="quant table"):
        jpeg_islow._table(bad, torch.device("cpu"), 1)
    assert jpeg_islow._table(bad, torch.device("cpu"), 0).tolist() == \
        bad.tolist()
    with pytest.raises(_kernels.KernelLaunchError, match="quant table"):
        jpeg_islow._table(np.full(64, 65536), torch.device("cpu"), 0)
    with pytest.raises(ValueError, match="does not fit"):
        jpeg_islow.idct_islow(torch.zeros((1, 1, 64), dtype=torch.int32),
                              np.ones(64), 2048, 4095, torch.uint8)
    meta = torch.zeros((1, 8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no lane"):
        jpeg_islow.fdct_islow(meta, np.ones(64))
    assert [jpeg_islow.plane_dtype(m) for m in (255, 4095, 65535, 65536)] \
        == [torch.uint8, torch.uint16, torch.uint16, torch.int32]


def test_device_bench_islow_rows_agree_on_the_cpu():
    """The device bench's two islow rows: both lanes give the same result
    on CPU tensors, and the bound counts uint16 in and int32 out."""
    from go_dicom_codec_torch.tools import device_bench

    x = torch.as_tensor(_samples(9, (2, 24, 40), 12, np.int32))
    rows = device_bench._jpeg_steps(x)
    assert sorted(rows) == ["dct8x8_quant_zigzag", "idct8x8_dequant"]
    for lanes, bound in rows.values():
        assert torch.equal(lanes["kernel"](), lanes["plain"]())
        assert bound == pytest.approx(x.numel() * 6 / 3.35e12 * 1e3)
