"""Port parity: the 9/7 forward stage, bit-exact against the JAX package.

A numpy model of one csrc/j2k97_fwd_stage.cu launch stands in for the
kernel here. It takes the launch's arguments (the level table, the
samples in their type and the shift, the components and the ICT) and runs
what the kernel runs: each level of the table is a strip pass
(csrc/lifting97.cuh) over its work items, grid rows and then the block
rows of the coarse levels. An item is a strip of the row's lanes, each
lane two pairs of a low column and the high column right of it, and a
segment of the row's output rows with a halo of 4 through the symmetric
fold; its rows
arrive in pairs, the steps along y fire in a rolling window whose state
starts at 0.0 (every register of the kernel's), each row out of it is
scaled by 1/K or K and lifted along x lane by lane, a neighbouring lane's
sample read as the card's shuffles read it (the strip's end lanes their
own), then scaled by 1/K and K and stored at its packed place: the LL to
the scratch area the row names, the high bands to the output. Every
operation is a float32 one, rounded once, in the reference's order (d +
c · (l + r)). Scratch and output start as NaN; the model checks that every
output sample is written once and that no level writes scratch it reads.
The ``geometry`` fixture cuts strips to 4 lanes and segments to 4 rows
here, so that small frames cross many strip and segment seams, have
partial items and grid rows; the card's geometry (strips of up to 32
lanes, segments of up to 64 rows, chosen per level) runs where a test
asks for it.

Tolerance 0 against the JAX package's op-by-op functions (the DC shift in
int32, ``ict_forward``, ``fwd97_multilevel``: go_dicom_codec_tpu/ops/
mct.py, ops/dwt97.py:120), bit for bit (-0.0 is not +0.0), over the
covering of tests/test_torch_dwt97.py: shapes 1×1 to 9×9 on three
diagonals and 61×37, every origin parity, levels 0-6; uint16, uint8 and
float32 (the Part-2 path) samples, the ICT on and off.
"""

import itertools
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
from test_torch_j2k_fwd_stage import (BLOCK, Scratch, fold, groups,
                                      no_other_kernels, phases, to_packed)

F32 = np.float32
CSRC = Path(dwt97.__file__).resolve().parent.parent / "csrc"
ALPHA, BETA, GAMMA, DELTA, K, INV_K = (F32(v) for v in (
    dwt97.ALPHA, dwt97.BETA, dwt97.GAMMA, dwt97.DELTA, dwt97.K,
    dwt97.INV_K))
ICT_FWD = [[F32(c) for c in row] for row in mct._ICT_FWD]
ICT_INV = [F32(c) for c in (mct._ICT_INV_CR, mct._ICT_INV_CB_G,
                            mct._ICT_INV_CR_G, mct._ICT_INV_CB)]
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


# ---- the strip pass of csrc/lifting97.cuh, in numpy -------------------------

# The lifting steps of a side (gdct97::Steps): step i lifts the high
# samples (i even) or the low ones (i odd).
FWD_STEPS = (ALPHA, BETA, GAMMA, DELTA)
INV_STEPS = (F32(0.0), -DELTA, -GAMMA, -BETA, -ALPHA, F32(0.0))


def lift(d, c, l, r):
    """gdct97::lift: d + c · (l + r), each float32 operation rounded
    once."""
    return d + c * (l + r)


def shfl_down(v):
    """__shfl_down_sync(mask, v, 1, lanes) along the last axis, a strip's
    lanes: lane l gets lane l + 1's value, the last lane its own."""
    return np.concatenate([v[..., 1:], v[..., -1:]], axis=-1)


def shfl_up(v):
    """__shfl_up_sync(mask, v, 1, lanes): lane l gets lane l - 1's value,
    the first lane its own."""
    return np.concatenate([v[..., :1], v[..., :-1]], axis=-1)


def lift_x(v, steps):
    """gdct97::lift_x over [..., lanes, 2·pairs] arrays: each lane holds
    pairs of a low sample (even index) and the high sample right of it, so
    a high step reads its pair's low sample and the next pair's, the last
    pair the next lane's first (a shuffle down), and a low step the
    previous pair's high sample and its own, the first pair the previous
    lane's last (a shuffle up)."""
    s, d = v[..., 0::2], v[..., 1::2]
    for i, c in enumerate(steps):
        if i % 2 == 0:
            nxt = shfl_down(s[..., 0])[..., None]
            d = lift(d, c, s, np.concatenate([s[..., 1:], nxt], axis=-1))
        else:
            prv = shfl_up(d[..., -1])[..., None]
            s = lift(s, c, np.concatenate([prv, d[..., :-1]], axis=-1), d)
    out = np.empty(np.broadcast_shapes(s.shape, d.shape)[:-1]
                   + (2 * s.shape[-1],), F32)
    out[..., 0::2], out[..., 1::2] = s, d
    return out


class Column:
    """gdct97::Column: the steps along y as a rolling window over a
    segment's pairs of rows (a low row, the high row below it), every
    register 0.0 at first. For each pair of steps j it keeps the low row
    step 2j reads next and the high row it lifts next, and the last high
    row out; push takes pair q and returns pair q - len(steps) / 2,
    final."""

    def __init__(self, steps):
        self.steps, self.m = steps, len(steps) // 2
        self.s = [F32(0.0)] * self.m
        self.d = [F32(0.0)] * (self.m + 1)

    def push(self, s_new, d_prev):
        for j in range(self.m):
            d_out = lift(self.d[j], self.steps[2 * j], self.s[j], s_new)
            s_out = lift(self.s[j], self.steps[2 * j + 1], self.d[j + 1],
                         d_out)
            self.s[j], self.d[j] = s_new, d_prev
            s_new, d_prev = s_out, d_out
        self.d[self.m] = d_prev
        return s_new, d_prev


class Strips:
    """The work items of one level (gdct97::Items, gdct97::Item): strips
    of ``lanes`` lanes, lane l holding the 2·pairs window columns from
    x = xo + 2·pairs·l (low, high, low, ...), xo = the strip's first
    output column - halo + lo_x, and segments of ``seg`` output rows,
    pair q their rows yo + 2q (low) and yo + 2q + 1 (high), yo = the
    segment's first row - halo + lo_y. Column arrays are [items, lanes,
    2·pairs]; row arrays [items]."""

    def __init__(self, row, halo):
        _, w, h, even_x, even_y, _, _, lanes, seg = row
        self.w, self.h, self.lo_x, self.lo_y = w, h, 1 - even_x, 1 - even_y
        self.snx, self.sny = (w + even_x) >> 1, (h + even_y) >> 1
        strips, segs = dwt97.strip_items(w, h, lanes, seg, halo)
        cols = 2 * dwt97._PAIRS
        out_w = cols * lanes - 2 * halo
        seg_i, strip = np.divmod(np.arange(strips * segs), strips)
        x_lo = strip * out_w
        self.x = ((x_lo - halo + self.lo_x)[:, None, None]
                  + cols * np.arange(lanes)[None, :, None]
                  + np.arange(cols)[None, None, :])
        self.fx = fold(self.x, w)
        self.x_out = ((self.x >= x_lo[:, None, None])
                      & (self.x < np.minimum(x_lo + out_w, w)[:, None, None]))
        self.y_lo = seg_i * seg
        self.y_hi = np.minimum(self.y_lo + seg, h)
        self.yo = self.y_lo - halo + self.lo_y
        self.pairs = seg // 2 + halo

    def out(self, y):
        """The samples of rows y (one a item) that the level stores."""
        return ((y >= self.y_lo) & (y < self.y_hi))[:, None, None] \
            & self.x_out

    def run(self, load, emit, steps):
        """gdct97::run_item over every item: rows y from load(y, kind)
        ([nb, items, lanes, 2], finished), through the Column, out to
        emit(y, v, kind). A window one row high goes through as it is."""
        zero = np.zeros_like(self.y_lo)
        if self.h == 1:
            emit(zero, load(zero, "only"), "only")
            return
        col = Column(steps)
        m = len(steps) // 2
        for q in range(self.pairs):
            y = self.yo + 2 * q
            lo, hi = col.push(load(y, "low"), load(y + 1, "high"))
            if q >= m:
                emit(y - 2 * m, lo, "low")
                emit(y - 2 * m + 1, hi, "high")


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
    words, rows = schedule
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
                    fwd97_level_model(rows[ri], ri, plane0, nb, g3, wide,
                                      out, count, scr)
    scr.check()
    assert (count == 1).all(), "an output sample is not written once"
    return out


def fwd97_level_model(row, ri, plane0, nb, g3, wide, out, count, scr):
    """csrc/j2k97_fwd_stage.cu::fwd_level for one plane group: every item
    of level ``ri`` (In::load and finish, run_item, Out)."""
    _, w, h, even_x, even_y, in_off, out_off, lanes, seg = row
    st = Strips(row, _kernels.FWD97_HALO)
    planes = (plane0 + np.arange(nb))[:, None, None, None]

    def load(y, kind):
        fy = fold(y, h)[None, :, None, None]
        if in_off >= 0:
            return scr.read(ri, scr.at(planes, in_off, fy, st.fx[None], w))
        v = wide[planes, fy, st.fx[None]]
        return np.stack(ict_fwd(*v)) if g3 and nb == 3 else v

    def emit(y, v, kind):
        if kind != "only":
            v = v * (INV_K if kind == "low" else K)
        if w > 1:
            v = lift_x(v, FWD_STEPS)
            v[..., 0::2] *= INV_K
            v[..., 1::2] *= K
        keep = st.out(y)
        py = np.broadcast_to(to_packed(y, st.sny, st.lo_y)[:, None, None],
                             keep.shape)[keep]
        px = to_packed(st.x, st.snx, st.lo_x)[keep]
        ll = (py < st.sny) & (px < st.snx) & (out_off >= 0)
        for k in range(nb):
            plane, vals = plane0 + k, v[k][keep]
            scr.write(ri, scr.at(plane, out_off, py[ll], px[ll], st.snx),
                      vals[ll])
            out[plane, py[~ll], px[~ll]] = vals[~ll]
            count[plane, py[~ll], px[~ll]] += 1

    st.run(load, emit, FWD_STEPS)


def _fwd97_model(launches):
    """A stand-in for _kernels.j2k97_fwd_stage; each launch appends
    "coeffs" to ``launches``."""
    def launch(src, out, schedule, shift, comps=1, mct=False):
        assert src.dtype in _kernels.FWD97_STAGE_DTYPES
        assert src.dim() == 3 and src.shape[0] % comps == 0
        assert out.dtype == torch.float32 and out.shape == src.shape
        assert out.data_ptr() != src.data_ptr()
        assert src.dtype != torch.float32 or shift == 0
        ict = mct and comps >= 3
        _kernels._stage97_plane("j2k97_fwd_stage", *src.shape[1:], schedule,
                                _kernels.FWD97_HALO)
        launches.append("coeffs")
        out.copy_(torch.as_tensor(fwd97_launch_model(
            src.numpy(), shift, schedule, comps, ict)))
    return launch


def clear_tables():
    for fn in (dwt53.fwd_schedule, dwt53.inv_schedule, dwt97.fwd97_schedule,
               dwt97.inv97_schedule):
        fn.cache_clear()


# The strip geometries of the tests: (lanes a strip at most, rows a
# segment at most). "small" gives strips of 4 lanes, 8 output columns
# forward and 4 inverse, and segments of 4 rows, so that small frames
# cross many strip and segment seams; "card" is the card's
# (ops/dwt97.py).
GEOMETRIES = {"small": (4, 4), "card": (dwt97._LANES, dwt97._SEG)}
# (grid warps, block warps) of the stage kernels on an H100, as
# ``_kernels.j2k97_fwd_warps``/``j2k97_inv_warps`` measure them there: 132
# SMs × 2 blocks of 8 warps (``__launch_bounds__(256, 2)``), the ICT
# kernels 1 block (``(256, 1)``); the tables the models run are sized for
# them.
H100_WARPS = {False: (132 * 16, 8), True: (132 * 8, 8)}


def card_warps(monkeypatch):
    """``_kernels.j2k97_fwd_warps``/``j2k97_inv_warps`` report the H100's
    ``H100_WARPS`` for CPU tensors (they need the card)."""
    for name in ("j2k97_fwd_warps", "j2k97_inv_warps"):
        monkeypatch.setattr(_kernels, name,
                            lambda src, ict=False: H100_WARPS[bool(ict)])


@pytest.fixture(params=["small"])
def geometry(request, monkeypatch):
    """The 9/7 stages' strip geometry (``GEOMETRIES``) on the H100's warps
    (``card_warps``); the schedules are built anew, and the caches hold
    none of them after the test."""
    lanes, seg = GEOMETRIES[request.param]
    monkeypatch.setattr(dwt97, "_LANES", lanes)
    monkeypatch.setattr(dwt97, "_SEG", seg)
    card_warps(monkeypatch)
    clear_tables()
    yield request.param
    clear_tables()


@pytest.fixture
def kernel_lane(monkeypatch, geometry):
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
@pytest.mark.parametrize("geometry", ["card"], indirect=True)
def test_stage_bit_exact_at_the_cards_tile(shape, x0, y0, levels,
                                           kernel_lane, rng):
    """61×37 at every level at the card's strip geometry (two strips
    across, segments of 32 rows and fewer): 12-bit uint16 gray frames and
    the ICT of RGB, against the plain version, which the covering holds
    to the JAX package."""
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


# special float32 values, one a frame in the seam tests
SPECIAL = (0.0, -0.0, np.inf, -np.inf, np.nan, 3e9, -3e9, 2.5)


@pytest.mark.parametrize("x0,y0", [(0, 0), (1, 1), (1, 0), (0, 1)])
def test_strip_and_segment_seams(x0, y0, kernel_lane, rng):
    """Frames of 19×21 float32 samples at the tests' geometry (strips of 8
    output columns, segments of 4 rows: seams at columns 8 and 16 and at
    every fourth row of the first level, and of the coarser ones), each
    with one of ±0, ±inf, NaN, ±3e9 on a strip seam, a segment seam and
    the window's last sample, at 3 levels: the model, the plain version
    and the JAX package agree bit for bit."""
    x = rng.uniform(-2048, 2048, (len(SPECIAL), 1, 19, 21)).astype(F32)
    for i, v in enumerate(SPECIAL):
        x[i, 0, 5, 8] = x[i, 0, 8, 15] = x[i, 0, -1, -1] = v
    want = np.asarray(ref_dwt97.fwd97_multilevel(jnp.asarray(x), 3, x0, y0))
    t = torch.as_tensor(x)
    bits_equal(stage._fwd97_stage_kernel(t, 0, 3, x0, y0).numpy(), want)
    bits_equal(stage.fwd97_stage_plain(t, 0, 3, x0, y0).numpy(), want)
    assert kernel_lane == ["coeffs"]


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
    """The 9/7 tables have the 5/3's windows, parities and scratch, less
    every 1×1 window (at either parity: the 9/7 leaves a side of one as
    it is), and a strip geometry a level."""
    gray = H100_WARPS[False]
    for f97, f53 in ((dwt97.fwd97_schedule, dwt53.fwd_schedule),
                     (dwt97.inv97_schedule, dwt53.inv_schedule)):
        words, rows = f97(512, 512, 5, warps=gray)
        assert words == f53(512, 512, 5)[1]
        assert [r[1:7] for r in rows] == [r[1:7] for r in
                                          f53(512, 512, 5)[2]]
    assert dwt97.fwd97_schedule(1, 1, 3, 1, 1, warps=gray) == (0, ())
    assert dwt53.fwd_schedule(1, 1, 3, 1, 1)[2]    # the 5/3's ×2 rule
    rows = dwt97.inv97_schedule(1, 5, 3, 1, 1, warps=gray)[1]
    assert [r[:5] for r in rows] == [(BLOCK, 1, 5, 0, 0)]
    for w in range(1, 10):
        for h in range(1, 10):
            for x0, y0 in ((0, 0), (1, 1), (1, 0)):
                for fn in (dwt97.fwd97_schedule, dwt97.inv97_schedule):
                    sched = fn(w, h, 6, x0, y0, warps=gray)
                    assert all(r[1:3] != (1, 1) for r in sched[1])


@pytest.mark.parametrize("warps", [H100_WARPS[False], H100_WARPS[True],
                                   (96, 4)])
@pytest.mark.parametrize("inverse", [False, True])
def test_strip_geometry_of_the_tables(inverse, warps):
    """Each level's strips are the fewest lanes (8, 16 or 32) whose
    4·lanes - 2·halo output columns (two pairs a lane) cover its width,
    at most 32; the head ("block" rows) is the levels at most 64 samples
    each way; its segments the height of 64, 32, 16, 8 or 4 rows (at most
    the window's, rounded up to even) whose rounds of items over the
    kernel's ``warps`` (grid warps: every plane group, a plane each but
    a frame's components 0-2 one at the level that runs the ICT, the
    forward's first and the inverse's last; the head: one plane group
    over a block's warps) times its chain of S/2 + halo pairs is the
    least, the tallest of equals; the kernel's checks pass."""
    fn = dwt97.inv97_schedule if inverse else dwt97.fwd97_schedule
    halo = _kernels.INV97_HALO if inverse else _kernels.FWD97_HALO
    assert _kernels.STRIP_PAIRS == dwt97._PAIRS == 2
    for (w, h), frames, (comps, ict) in itertools.product(
            ((512, 512), (65535, 16), (16, 65535), (61, 37), (7, 3)),
            (1, 8, 32), ((1, False), (3, True), (4, True), (3, False))):
        planes = frames * comps
        words, rows = fn(w, h, 5, 0, 0, planes, warps=warps, comps=comps,
                         ict=ict)
        _kernels._stage97_plane("stage", h, w, (words, rows), halo)
        ict_row = len(rows) - 1 if inverse else 0
        for i, (kind, lw, lh, *_, lanes, seg) in enumerate(rows):
            assert lanes == min(l for l in (8, 16, 32)
                                if 4 * l - 2 * halo >= lw or l == 32)
            assert (kind == BLOCK) == (max(lw, lh) <= 64)
            grid = frames * (comps - 2) if ict and i == ict_row else planes
            groups, n = (1, warps[1]) if kind == BLOCK else (grid, warps[0])

            def cost(s):
                strips, segs = -(-lw // (4 * lanes - 2 * halo)), -(-lh // s)
                rounds = -(-groups * strips * segs // (n * 32 // lanes))
                return rounds * (s // 2 + halo)
            heights = sorted({min(s, lh + lh % 2) for s in (64, 32, 16, 8, 4)},
                             reverse=True)
            assert seg == min(heights, key=cost)
    if warps == H100_WARPS[True]:    # 8 RGB frames with the ICT
        assert [r[7:] for r in dwt97.fwd97_schedule(
            512, 512, 5, 0, 0, 24, warps=warps, comps=3, ict=True)[1]] == [
            (32, 32), (32, 32), (32, 8), (32, 8), (16, 4)]
        assert [r[7:] for r in dwt97.inv97_schedule(
            512, 512, 5, 0, 0, 24, warps=warps, comps=3, ict=True)[1]] == [
            (16, 4), (32, 8), (32, 8), (32, 32), (32, 32)]
    if warps != H100_WARPS[False]:
        return
    assert [r[0:1] + r[7:] for r in dwt97.fwd97_schedule(
        512, 512, 5, 0, 0, 32, warps=warps)[1]] == [
        (0, 32, 64), (0, 32, 16), (0, 32, 4), (BLOCK, 32, 8),
        (BLOCK, 16, 4)]
    assert [r[7:] for r in dwt97.inv97_schedule(
        512, 512, 5, 0, 0, 8, warps=warps)[1]
            ] == [(16, 4), (32, 8), (32, 4), (32, 4), (32, 16)]
    assert [r[7] for r in dwt97.fwd97_schedule(16, 65535, 5,
                                               warps=warps)[1]] == [
        8, 8, 8, 8, 8]
    assert [r[7] for r in dwt97.inv97_schedule(65535, 16, 5,
                                               warps=warps)[1]] == [
        32, 32, 32, 32, 32]


@pytest.mark.parametrize("bad", [
    lambda r: r[:7] + (2, 32),          # lanes not 4, 8, 16 or 32
    lambda r: r[:7] + (32, 7),          # odd segments
    lambda r: r[:7] + (32, 0),
    lambda r: r[:8],                    # a row of 8 columns
])
def test_strip_table_refuses_bad_rows(bad):
    words, rows = dwt97.fwd97_schedule(61, 37, 2, warps=H100_WARPS[False])
    rows = (bad(rows[0]),) + rows[1:]
    with pytest.raises(_kernels.KernelLaunchError):
        _kernels._stage97_plane("j2k97_fwd_stage", 37, 61, (words, rows),
                                _kernels.FWD97_HALO)


def test_shared_memory_and_constants():
    """The strip pass keeps everything in registers and shuffles: no
    shared memory and no block barrier inside a level in either stage
    (a block barrier only between the head's levels), and
    csrc/lifting97.cuh's constants are the float32 roundings of the
    port's (and the reference's)."""
    for name in ("lifting97.cuh", "j2k97_fwd_stage.cu",
                 "j2k97_inv_stage.cu"):
        code = re.sub(r"//.*", "", (CSRC / name).read_text())
        assert "__shared__" not in code and "extern __shared" not in code
        assert code.count("__syncthreads()") == (0 if name.endswith("cuh")
                                                 else 1)
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
                                 dwt97.fwd97_schedule(
                                     8, 8, 2, warps=H100_WARPS[False]), 0)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.j2k97_fwd_warps(x3)
