"""Port parity: the 9/7 forward stage, bit-exact against the JAX package.

A numpy model of one csrc/j2k97_fwd_stage.cu launch stands in for the
kernel here. It takes the launch's arguments (the level table, the
samples in their type and the shift, the components and the ICT) and runs
what the kernel runs, tile by tile: each level of the table is a tile pass
(csrc/lifting97.cuh) over output tiles of the schedule's side, grid rows
and then the block rows of the coarse levels, each tile loaded with its
halo of 4 through the symmetric fold into a buffer in the kernel's layout
(even columns first), lifted by the kernel's steps over the kernel's
ranges in float32 (each operation rounded once, in the reference's order:
d + c · (l + r)), scaled by 1/K and K on the tile's rows, and stored at its
packed place: the LL to the scratch area the row names, the high bands to
the output. Buffers, scratch and output start as NaN; the model checks
that every output sample is written once and that no level writes scratch
it reads. The tile side is cut to 4 samples here, so that small frames
have many tiles, partial ones and grid rows; 64 is the card's.

Tolerance 0 against the JAX package's op-by-op functions (the DC shift in
int32, ``ict_forward``, ``fwd97_multilevel``: go_dicom_codec_tpu/ops/
mct.py, ops/dwt97.py:120), bit for bit (-0.0 is not +0.0), over the
covering of tests/test_torch_dwt97.py: shapes 1×1 to 9×9 on three
diagonals and 61×37, every origin parity, levels 0-6; uint16, uint8 and
float32 (the Part-2 path) samples, the ICT on and off.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.ops import dwt97 as ref_dwt97
from go_dicom_codec_tpu.ops import mct as ref_mct
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch.codecs import jpeg2000 as port_j2k
from go_dicom_codec_torch.ops import dwt53, dwt97, mct
from go_dicom_codec_torch.ops import j2k97_fwd_stage as stage
from test_torch_dwt97 import LARGE, SMALL, _cases
from test_torch_j2k_fwd_stage import (BLOCK, HOPPER_SMEM, Scratch, fold,
                                      groups, n_tiles, no_other_kernels,
                                      phases, xs)

F32 = np.float32
CSRC = Path(dwt97.__file__).resolve().parent.parent / "csrc"
ALPHA, BETA, GAMMA, DELTA, K, INV_K = (F32(v) for v in (
    dwt97.ALPHA, dwt97.BETA, dwt97.GAMMA, dwt97.DELTA, dwt97.K,
    dwt97.INV_K))
ICT_FWD = [[F32(c) for c in row] for row in mct._ICT_FWD]
ICT_INV = [F32(c) for c in (mct._ICT_INV_CR, mct._ICT_INV_CB_G,
                            mct._ICT_INV_CR_G, mct._ICT_INV_CB)]
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


# ---- the tile pass of csrc/lifting97.cuh, in numpy ---------------------------

def first_of(p):
    """gdct97::first_of: the first ext index >= 1 of parity p."""
    return 1 if p else 2


def count_of(n, p):
    """gdct97::count_of: the positions of parity p in [1, n - 2]."""
    return (n - first_of(p)) // 2


class Tile97:
    """gdct97::Tile: one tile of a w×h window with a halo of ``halo``
    samples and its nb float32 buffers, which start as NaN."""

    def __init__(self, size, w, h, index, nb, halo):
        ty, tx = divmod(index, -(-w // size))
        self.halo = halo
        self.pitch = size + 2 * halo
        self.hx = self.pitch // 2
        self.ty0, self.tx0 = ty * size, tx * size
        self.tey, self.tex = min(size, h - self.ty0), min(size, w - self.tx0)
        self.eyn, self.exn = self.tey + 2 * halo, self.tex + 2 * halo
        self.buf = np.full((nb, self.pitch, self.pitch), np.nan, F32)

    def ext(self, h, w):
        """The window positions of the ext rows and columns, folded."""
        return (fold(self.ty0 - self.halo + np.arange(self.eyn), h),
                fold(self.tx0 - self.halo + np.arange(self.exn), w))

    def fill(self, vals):
        """Ext samples [nb, eyn, exn] into the buffers' layout."""
        self.buf[:, np.arange(self.eyn)[:, None],
                 xs(np.arange(self.exn), self.hx)[None, :]] = vals

    def step_y(self, p, c):
        """The step of parity p along y over every stored column."""
        first, count = first_of(p), count_of(self.eyn, p)
        if count <= 0:
            return
        y = first + 2 * np.arange(count)
        b = self.buf
        b[:, y] = b[:, y] + c * (b[:, y - 1] + b[:, y + 1])

    def step_x(self, p, c, y_lo, y_hi):
        """The step of parity p along x over rows [y_lo, y_hi)."""
        first, count = first_of(p), count_of(self.exn, p)
        if count <= 0:
            return
        e = first + 2 * np.arange(count)
        r, b, hx = slice(y_lo, y_hi), self.buf, self.hx
        b[:, r, xs(e, hx)] = b[:, r, xs(e, hx)] + c * (
            b[:, r, xs(e - 1, hx)] + b[:, r, xs(e + 1, hx)])

    def scale(self, by_x, lo, low, high, y_lo, y_hi):
        """gdct97::scale: low × ``low``, high × ``high`` in rows
        [y_lo, y_hi) of every stored column."""
        parity = ((np.arange(self.pitch) >= self.hx)[None, :] if by_x
                  else (np.arange(y_lo, y_hi) & 1)[:, None])
        f = np.where(parity == lo, low, high).astype(F32)
        self.buf[:, y_lo:y_hi] = self.buf[:, y_lo:y_hi] * f

    def fwd_lift(self, lo_x, lo_y, w, h):
        """gdct97::fwd_lift."""
        y_lo, y_hi = self.halo, self.halo + self.tey
        if h > 1:
            for p, c in ((1 - lo_y, ALPHA), (lo_y, BETA), (1 - lo_y, GAMMA),
                         (lo_y, DELTA)):
                self.step_y(p, c)
            self.scale(False, lo_y, INV_K, K, y_lo, y_hi)
        if w > 1:
            for p, c in ((1 - lo_x, ALPHA), (lo_x, BETA), (1 - lo_x, GAMMA),
                         (lo_x, DELTA)):
                self.step_x(p, c, y_lo, y_hi)
            self.scale(True, lo_x, INV_K, K, y_lo, y_hi)

    def inv_lift(self, lo_x, lo_y, w, h):
        """gdct97::inv_lift: the reference's six steps a side, the two of
        coefficient 0.0 among them."""
        zero = F32(0.0)
        if w > 1:
            self.scale(True, lo_x, K, INV_K, 0, self.eyn)
            for p, c in ((1 - lo_x, zero), (lo_x, -DELTA),
                         (1 - lo_x, -GAMMA), (lo_x, -BETA),
                         (1 - lo_x, -ALPHA), (lo_x, zero)):
                self.step_x(p, c, 0, self.eyn)
        if h > 1:
            self.scale(False, lo_y, K, INV_K, 0, self.eyn)
            for p, c in ((1 - lo_y, zero), (lo_y, -DELTA),
                         (1 - lo_y, -GAMMA), (lo_y, -BETA),
                         (1 - lo_y, -ALPHA), (lo_y, zero)):
                self.step_y(p, c)


class Scratch97(Scratch):
    """The launch's float32 scratch, NaN at first, with each row's reads
    and writes (``Scratch``)."""

    def __init__(self, planes, words):
        super().__init__(planes, words)
        self.mem = np.full(planes * words, np.nan, F32)


def ict_fwd(r, g, b):
    """gdct97::dot3 rows: (c0·r + c1·g) + c2·b, as ops/mct.ict_forward."""
    return [(c0 * r + c1 * g) + c2 * b for c0, c1, c2 in ICT_FWD]


def widen(x, shift):
    """A launch's samples as the transform takes them: less ``shift`` in
    wrapping int32, then float32; float32 samples as they are."""
    if x.dtype == np.float32:
        return x.copy()
    v = (x.astype(np.int64) - shift + (1 << 31)) % (1 << 32) - (1 << 31)
    return v.astype(np.int32).astype(F32)


def fwd97_launch_model(x, shift, schedule, comps, ict):
    """One launch of csrc/j2k97_fwd_stage.cu on samples x [P, H, W]: the
    float32 coefficients, each written once."""
    tile, words, rows = schedule
    p, h, w = x.shape
    frames = p // comps
    out = np.full((p, h, w), np.nan, F32)
    count = np.zeros((p, h, w), np.int64)
    scr = Scratch97(p, words)
    wide = widen(x, shift)
    with np.errstate(all="ignore"):
        if not rows:               # no level: shift, float32 and ICT only
            f = wide.reshape(frames, comps, h, w).copy()
            if ict:
                f[:, :3] = np.stack(ict_fwd(f[:, 0], f[:, 1], f[:, 2]), 1)
            out[...] = f.reshape(p, h, w)
            count += 1
        for r0, r1 in phases(rows):
            g3 = ict and r0 == 0
            for plane0, nb in groups(frames, comps, g3):
                for ri in range(r0, r1):
                    for t in range(n_tiles(rows[ri], tile)):
                        fwd97_tile_model(rows[ri], ri, tile, t, plane0, nb,
                                         g3, wide, out, count, scr)
    scr.check()
    assert (count == 1).all(), "an output sample is not written once"
    return out


def fwd97_tile_model(row, ri, size, index, plane0, nb, g3, wide, out, count,
                     scr):
    """csrc/j2k97_fwd_stage.cu::fwd_tile."""
    _, w, h, even_x, even_y, in_off, out_off = row
    lo_x, lo_y = 1 - even_x, 1 - even_y
    halo = _kernels.FWD97_HALO
    t = Tile97(size, w, h, index, nb, halo)
    qy, qx = t.ext(h, w)
    planes = plane0 + np.arange(nb)
    if in_off < 0:
        vals = wide[planes[:, None, None], qy[None, :, None],
                    qx[None, None, :]]
        if g3 and nb == 3:
            vals = np.stack(ict_fwd(*vals))
    else:
        vals = scr.read(ri, scr.at(planes[:, None, None], in_off,
                                   qy[None, :, None], qx[None, None, :], w))
    t.fill(vals)
    t.fwd_lift(lo_x, lo_y, w, h)
    snx, sny = (w + even_x) >> 1, (h + even_y) >> 1
    nlx, nly = (t.tex + 1 - lo_x) >> 1, (t.tey + 1 - lo_y) >> 1
    oy, ox = np.arange(t.tey), np.arange(t.tex)
    low_y, low_x = oy < nly, ox < nlx
    oy, ox = np.where(low_y, oy, oy - nly), np.where(low_x, ox, ox - nlx)
    by = np.where(low_y, lo_y, 1 - lo_y) + halo + 2 * oy
    bx = np.where(low_x, lo_x, 1 - lo_x) * t.hx + halo // 2 + ox
    py = np.where(low_y, 0, sny) + t.ty0 // 2 + oy
    px = np.where(low_x, 0, snx) + t.tx0 // 2 + ox
    vals = t.buf[:, by[:, None], bx[None, :]]
    ll = (low_y[:, None] & low_x[None, :]) & (out_off >= 0)
    py, px = np.broadcast_to(py[:, None], ll.shape), \
        np.broadcast_to(px[None, :], ll.shape)
    for k, plane in enumerate(planes):
        scr.write(ri, scr.at(plane, out_off, py[ll], px[ll], snx),
                  vals[k][ll])
        out[plane, py[~ll], px[~ll]] = vals[k][~ll]
        count[plane, py[~ll], px[~ll]] += 1


def _fwd97_model(launches):
    """A stand-in for _kernels.j2k97_fwd_stage; each launch appends
    "coeffs" to ``launches``."""
    def launch(src, out, schedule, shift, comps=1, mct=False):
        assert src.dtype in _kernels.FWD97_STAGE_DTYPES
        assert src.dim() == 3 and src.shape[0] % comps == 0
        assert out.dtype == torch.float32 and out.shape == src.shape
        assert out.data_ptr() != src.data_ptr()
        assert src.dtype != torch.float32 or shift == 0
        tile, _, rows = schedule
        ict = mct and comps >= 3
        assert len(rows) <= _kernels.STAGE_MAX_ROWS
        assert _kernels.stage97_smem_bytes(tile, _kernels.FWD97_HALO,
                                           ict) <= HOPPER_SMEM
        launches.append("coeffs")
        out.copy_(torch.as_tensor(fwd97_launch_model(
            src.numpy(), shift, schedule, comps, ict)))
    return launch


def clear_tables():
    for fn in (dwt53.fwd_schedule, dwt53.inv_schedule, dwt97.fwd97_schedule,
               dwt97.inv97_schedule):
        fn.cache_clear()


@pytest.fixture(params=[4])
def tile(request, monkeypatch):
    """The stages' tile side in samples; the 5/3's and 9/7's schedules
    are built anew, and the caches hold none of them after the test."""
    monkeypatch.setattr(dwt53, "_TILE", request.param)
    clear_tables()
    yield request.param
    clear_tables()


@pytest.fixture
def kernel_lane(monkeypatch, tile):
    """The 9/7 forward stage's kernel lane on CPU tensors, through the
    model, for the stage, the codec's tile transform and
    ``fwd97_multilevel``; no other kernel may launch. Yields the
    launches."""
    launches = []
    no_other_kernels(monkeypatch, ("j2k97_fwd_stage",))
    monkeypatch.setattr(_kernels, "j2k97_fwd_stage", _fwd97_model(launches))
    monkeypatch.setattr(port_j2k, "fwd97_stage", stage._fwd97_stage_kernel)
    monkeypatch.setattr(dwt97, "_on_cuda", lambda x: True)
    return launches


def bits_equal(got, want):
    """float32 arrays equal bit for bit (-0.0 is not +0.0); NaN where
    NaN, whatever its payload."""
    got = np.ascontiguousarray(got, dtype=F32)
    want = np.ascontiguousarray(want, dtype=F32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.uint32)[~nan],
                                  want.view(np.uint32)[~nan])


# (dtype, shift, bits of content) of the covering's inputs, in turns
SAMPLES = ((np.uint16, 2048, 12), (np.uint8, 128, 8), (np.float32, 0, 12))


def _samples(rng, kind, shape):
    dtype, shift, bits = SAMPLES[kind]
    x = rng.integers(0, 1 << bits, shape)
    if dtype == np.float32:     # shifted and matrixed: any float32
        return (rng.uniform(-2048, 2048, shape).astype(F32), shift)
    return x.astype(dtype), shift


def _ref_forward(x, shift, levels, x0, y0):
    """The JAX package's op-by-op encoder path of frames x [F, 3, h, w]
    (codecs/jpeg2000.py:680-704): the DC shift in int32 (float samples as
    they are), then, for the ICT's half of the batch, ict_forward; one
    fwd97_multilevel over [ICT frames, plain frames]."""
    s = (jnp.asarray(x) if x.dtype == np.float32
         else jnp.asarray(x.astype(np.int32)) - shift).astype(jnp.float32)
    ycc = jnp.stack(ref_mct.ict_forward(s[:, 0], s[:, 1], s[:, 2]), axis=1)
    both = np.asarray(ref_dwt97.fwd97_multilevel(
        jnp.concatenate([ycc, s]), levels, x0, y0))
    return both[:len(x)], both[len(x):]


@pytest.mark.parametrize("shape,x0,y0,levels", _cases(SMALL + LARGE))
def test_stage_bit_exact_over_the_covering(shape, x0, y0, levels,
                                           kernel_lane, rng):
    """The model (the kernel lane) and the plain version against the JAX
    package's op-by-op shift, ICT and 9/7, with the ICT and without."""
    kind = (shape[0] + 2 * shape[1] + x0) % len(SAMPLES)
    x, shift = _samples(rng, kind, (1, 3) + shape)
    want_ict, want = _ref_forward(x, shift, levels, x0, y0)
    t = torch.as_tensor(x)
    for mct_on, w in ((True, want_ict), (False, want)):
        bits_equal(stage.fwd97_stage_plain(t, shift, levels, x0, y0,
                                           mct_on).numpy(), w)
        bits_equal(stage._fwd97_stage_kernel(t, shift, levels, x0, y0,
                                             mct_on).numpy(), w)
    assert kernel_lane == ["coeffs"] * 2


@pytest.mark.parametrize("shape,x0,y0,levels", _cases(LARGE))
@pytest.mark.parametrize("tile", [64], indirect=True)
def test_stage_bit_exact_at_the_cards_tile(shape, x0, y0, levels,
                                           kernel_lane, rng):
    """61×37 at every level at the card's tile side (one tile a level,
    block rows only): 12-bit uint16 gray frames and the ICT of RGB,
    against the plain version, which the covering holds to the JAX
    package."""
    x = torch.as_tensor(rng.integers(0, 4096, (2, 3) + shape)
                        .astype(np.uint16))
    for t, mct_on in ((x, True), (x[:, :1], False)):
        bits_equal(stage._fwd97_stage_kernel(t, 2048, levels, x0, y0,
                                             mct_on).numpy(),
                   stage.fwd97_stage_plain(t, 2048, levels, x0, y0,
                                           mct_on).numpy())
    assert kernel_lane == ["coeffs"] * 2


@pytest.mark.parametrize("shape", [(1, 2, 61), (1, 61, 2), (2, 1, 37),
                                   (2, 37, 1), (3, 5, 3)])
@pytest.mark.parametrize("x0,y0", [(0, 0), (1, 1)])
def test_thin_windows_and_four_components(shape, x0, y0, kernel_lane, rng):
    """Long, thin windows (one and two samples across: the fold at n = 1
    and 2, a side of one left as it is) and frames of four components,
    the ICT on components 0-2 only; int16 and int32 samples. Against the
    plain version, which the covering holds to the JAX package."""
    x = rng.integers(-2048, 2048, (2, 4) + shape[1:]).astype(np.int16)
    levels = 4
    want = stage.fwd97_stage_plain(torch.as_tensor(x), 0, levels, x0, y0,
                                   True).numpy()
    for dtype in (torch.int16, torch.int32):
        got = stage._fwd97_stage_kernel(torch.as_tensor(x).to(dtype), 0,
                                        levels, x0, y0, True)
        bits_equal(got.numpy(), want)
    assert kernel_lane == ["coeffs"] * 2


def test_signed_zero_and_saturation_inputs(kernel_lane):
    """float32 samples of ±0, ±inf, NaN and ±3e9 beside ordinary ones, the
    ICT on: the model, the plain version and the JAX package agree bit for
    bit (a NaN where the reference has one)."""
    x = np.full((1, 3, 6, 7), 1234.25, F32)
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, 3e9, -3e9, 2.5]
    x.reshape(3, -1)[0, :len(special)] = special
    x.reshape(3, -1)[1, 10:10 + len(special)] = special
    x.reshape(3, -1)[2, -len(special):] = -np.array(special, F32)
    for levels in (0, 1, 3):
        s = jnp.asarray(x)
        ycc = jnp.stack(ref_mct.ict_forward(s[:, 0], s[:, 1], s[:, 2]), 1)
        want = np.asarray(ref_dwt97.fwd97_multilevel(ycc, levels))
        t = torch.as_tensor(x)
        bits_equal(stage._fwd97_stage_kernel(t, 0, levels, mct=True).numpy(),
                   want)
        bits_equal(stage.fwd97_stage_plain(t, 0, levels, mct=True).numpy(),
                   want)
    assert kernel_lane == ["coeffs"] * 3


def test_stage_widens_each_dtype(kernel_lane, rng):
    """uint16 (65535 exact), int16, int32 (past 2^24: rounded to float32
    as torch and jnp round) and uint8 are read as they are; int8 and int64
    are cast to int32 first, float64 to float32, as the plain version
    casts them."""
    wide = rng.integers(0, 65536, (2, 9, 11))
    wide[0, 0, :2] = (65535, 0)
    big = rng.integers(-(1 << 31), (1 << 31) - 1, (2, 9, 11))
    for arr, shift in ((wide.astype(np.uint16), 32768),
                       (wide.astype(np.int16), 0),
                       (big.astype(np.int32), 12345),
                       (wide.astype(np.uint8), 128),
                       (wide.astype(np.int8), 0),
                       (big.astype(np.int64), 7),
                       (big.astype(np.float64), 0)):
        t = torch.as_tensor(arr)
        got = stage._fwd97_stage_kernel(t, shift, 2)
        bits_equal(got.numpy(),
                   stage.fwd97_stage_plain(t, shift, 2).numpy())
    assert len(kernel_lane) == 7


def test_multilevel_kernel_lane(kernel_lane, rng):
    """``fwd97_multilevel``'s kernel lane: one launch of the stage, shift
    0, input left as it was, bit for bit the plain lane."""
    x = torch.as_tensor(rng.uniform(-2048, 2048, (2, 3, 13, 21)).astype(F32))
    keep = x.clone()
    got = dwt97.fwd97_multilevel(x, 3, 1, 0)
    assert torch.equal(x, keep) and got.shape == x.shape
    bits_equal(got.numpy(), dwt97.fwd97_multilevel_plain(x, 3, 1, 0).numpy())
    assert kernel_lane == ["coeffs"]


# ---- the codec's tile transform and the registry ---------------------------

@pytest.mark.parametrize("rgb", [False, True])
def test_tile_coeffs_device_is_one_launch(rgb, kernel_lane, rng):
    """The lossy tile transform (codecs/jpeg2000.tile_coeffs_device) is one
    stage launch: the DC shift and the ICT inside it, bit for bit the
    JAX package's op-by-op encoder path."""
    c = 3 if rgb else 1
    x = rng.integers(0, 256, (2, c, 19, 23)).astype(np.uint8)
    got = port_j2k.tile_coeffs_device(torch.as_tensor(x), 1, 2, 3, 8, False,
                                      use_mct=rgb, lossless=False)
    s = jnp.asarray(x.astype(np.int32)) - 128
    if rgb:
        s = jnp.stack(ref_mct.ict_forward(s[:, 0], s[:, 1], s[:, 2]), 1)
    bits_equal(got.numpy(), ref_dwt97.fwd97_multilevel(s, 3, 1, 2))
    assert kernel_lane == ["coeffs"]


@pytest.mark.parametrize("part2", ["matrix", "bindings"])
def test_part2_tile_transform_matrix_then_one_launch(part2, kernel_lane,
                                                     monkeypatch, rng):
    """With a Part-2 matrix or bindings the matrix runs in plain torch,
    then one stage launch on its float32 output (shift 0), the ICT of
    ``colour`` in it where the codec asks for it: bit for bit the plain
    lane."""
    from go_dicom_codec_torch.codecs.mct_builder import MCTBinding

    m = [[0.6, 0.5, 0.5], [0.5, 0.6, -0.5], [0.5, -0.5, 0.6]]
    kw = (dict(mct_matrix=m, mct_offsets=[1.0, -2.0, 0.5])
          if part2 == "matrix" else
          dict(mct_bindings=[MCTBinding(component_ids=[0, 2], matrix=[
              [0.5, 0.5], [0.5, -0.5]])]))
    x = torch.as_tensor(rng.integers(0, 4096, (2, 3, 17, 12))
                        .astype(np.uint16))
    got = port_j2k.tile_coeffs_device(x, 0, 1, 3, 12, False, True, False,
                                      **kw)
    monkeypatch.setattr(port_j2k, "fwd97_stage", stage.fwd97_stage_plain)
    want = port_j2k.tile_coeffs_device(x, 0, 1, 3, 12, False, True, False,
                                       **kw)
    bits_equal(got.numpy(), want.numpy())
    assert kernel_lane == ["coeffs"]


def test_part2_lossy_registry_encode_through_the_model(kernel_lane,
                                                       monkeypatch, rng):
    """A .93 encode of two RGB frames with a Part-2 matrix on the device
    engine: one stage launch a frame, codestreams byte-identical to the
    plain lane's."""
    import go_dicom_codec_torch as gdc

    frames = rng.integers(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    m = [[0.6, 0.5, 0.5], [0.5, 0.6, -0.5], [0.5, -0.5, 0.6]]
    params = gdc.Parameters(mct_matrix=m,
                            mct_inverse=np.linalg.inv(m).tolist())
    info = gdc.FrameInfo(width=24, height=16, bits_allocated=8,
                         samples_per_pixel=3)

    def encode():
        src = gdc.MemoryPixelData(info=info)
        for f in frames:
            src.add_frame(f.tobytes())
        enc = gdc.MemoryPixelData(info=info, encapsulated=True)
        gdc.make_registry(torch.device("cpu"), engine="device").get_codec(
            gdc.uids.JPEG_2000_MC_LOSSY).encode(src, enc, params)
        return [enc.get_frame(i) for i in range(2)]
    got = encode()
    assert kernel_lane == ["coeffs"] * 2
    monkeypatch.setattr(port_j2k, "fwd97_stage", stage.fwd97_stage_plain)
    assert got == encode()


# ---- tables, constants, lanes ------------------------------------------------

def test_tables_drop_one_sample_windows():
    """The 9/7 tables are the 5/3's, less every 1×1 window (at either
    parity: the 9/7 leaves a side of one as it is)."""
    assert dwt97.fwd97_schedule(512, 512, 5) == dwt53.fwd_schedule(512, 512,
                                                                   5)
    assert dwt97.inv97_schedule(512, 512, 5) == dwt53.inv_schedule(512, 512,
                                                                   5)
    assert dwt97.fwd97_schedule(1, 1, 3, 1, 1) == (64, 0, ())
    assert dwt53.fwd_schedule(1, 1, 3, 1, 1)[2]    # the 5/3's ×2 rule
    rows = dwt97.inv97_schedule(1, 5, 3, 1, 1)[2]
    assert [r[:5] for r in rows] == [(BLOCK, 1, 5, 0, 0)]
    for w in range(1, 10):
        for h in range(1, 10):
            for x0, y0 in ((0, 0), (1, 1), (1, 0)):
                for sched in (dwt97.fwd97_schedule(w, h, 6, x0, y0),
                              dwt97.inv97_schedule(w, h, 6, x0, y0)):
                    assert all(r[1:3] != (1, 1) for r in sched[2])


def test_shared_memory_and_constants():
    """A block's buffers fit Hopper's shared memory (three with the ICT,
    halos of 4 and 6 at tiles of 64), and csrc/lifting97.cuh's constants
    are the float32 roundings of the port's (and the reference's)."""
    assert _kernels.stage97_smem_bytes(64, 4, True) == 3 * 72 * 72 * 4
    assert _kernels.stage97_smem_bytes(64, 6, True) == 3 * 76 * 76 * 4
    assert _kernels.stage97_smem_bytes(64, 6, True) <= HOPPER_SMEM // 2
    src = (CSRC / "lifting97.cuh").read_text()
    consts = {name: F32(float.fromhex(v)) for name, v in re.findall(
        r"(k\w+) = (-?0x[0-9a-f.]+p[-+]\d+)f", src)}
    want = {"kAlpha": ALPHA, "kBeta": BETA, "kGamma": GAMMA,
            "kDelta": DELTA, "kK": K, "kInvK": INV_K,
            "kInvCr": ICT_INV[0], "kInvCbG": ICT_INV[1],
            "kInvCrG": ICT_INV[2], "kInvCb": ICT_INV[3]}
    want.update(zip(("kYr", "kYg", "kYb", "kCbr", "kCbg", "kCbb", "kCrr",
                     "kCrg", "kCrb"), [c for row in ICT_FWD for c in row]))
    assert consts == want
    assert (dwt97.ALPHA, dwt97.K, mct._ICT_INV_CR) == (
        ref_dwt97.ALPHA, ref_dwt97.K, ref_mct._ICT_INV_CR)


def test_stage_lanes_by_device():
    x = torch.zeros((1, 3, 8, 8), dtype=torch.uint16)
    got = stage.fwd97_stage(x, 2048, 2, mct=True)       # CPU: plain
    assert got.dtype == torch.float32 and got.shape == x.shape
    with pytest.raises(ValueError, match="no lane"):
        stage.fwd97_stage(x.to("meta"), 0, 1)
    with pytest.raises(ValueError, match="no lane"):
        dwt97.fwd97_multilevel(x.to("meta"), 1)
    with pytest.raises(ValueError, match="no shift"):
        stage.fwd97_stage(x.to(torch.float32), 5, 1)
    x3 = torch.zeros((3, 8, 8), dtype=torch.float32)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.j2k97_fwd_stage(x3, x3.clone(),
                                 dwt97.fwd97_schedule(8, 8, 2), 0)
