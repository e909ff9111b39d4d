"""Port parity: the fused J2K forward stage, bit-exact against the JAX
package.

A numpy model of one csrc/j2k_fwd_stage.cu launch stands in for the kernel
here. It takes the launch's arguments (the level table, the components and
the RCT, the epilogue's outputs) and runs what the kernel runs, tile by
tile: each level of the table is a tile pass (csrc/lifting.cuh) over
output tiles of the schedule's side, grid rows and then the block rows of
the coarse levels, each tile loaded with its halo of 2 through the
symmetric fold into a buffer in the kernel's layout (even columns first),
lifted by the kernel's steps over the kernel's ranges, and stored at its
packed place: the LL to the scratch area the row names, the high bands to
the output. The model checks that every output sample is written once
and that no level writes scratch words it reads, and computes the
epilogue as the kernel does (a partial code-block's max starts at its
padding's zero, a full one's at INT_MIN). The tile side is cut to 4 and 8
samples here, so that small frames have many tiles, partial ones and grid
rows; 64 is the card's. Through the model the kernel lane of the stage,
of the pipelines' stages and of the encode transforms is held against
go_dicom_codec_tpu/pipeline.py and its 5/3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu import pipeline as ref
from go_dicom_codec_tpu.ops import blockstats as ref_stats
from go_dicom_codec_tpu.ops import dwt53 as ref_dwt
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch import pipeline as port
from go_dicom_codec_torch.ops import dwt53
from go_dicom_codec_torch.ops import j2k_fwd_stage as stage
from test_torch_dwt53 import KERNEL_LANE_CASES

INT_MIN = np.iinfo(np.int32).min
GARBAGE = 0x5A5A5A5A
HOPPER_SMEM = 232448       # a block's shared memory on Hopper (227 KB)
GRID, BLOCK = dwt53.ROW_KINDS["grid"], dwt53.ROW_KINDS["block"]


# ---- the tile pass of csrc/lifting.cuh, in numpy ----------------------------

def fold(q, n):
    """gdct::fold: whole-sample symmetric extension of positions q."""
    q = np.asarray(q, dtype=np.int64)
    if n == 1:
        return np.zeros_like(q)
    period = 2 * (n - 1)
    q = np.mod(q, period)
    return np.where(q < n, q, period - q)


def xs(e, hx):
    """gdct::xs: the word of ext column e in a buffer row."""
    e = np.asarray(e)
    return (e & 1) * hx + (e >> 1)


def to_packed(q, sn, lo):
    """gdct::interleaved_to_packed."""
    return np.where((q & 1) == lo, (q - lo) >> 1, sn + ((q - (1 - lo)) >> 1))


def groups(frames, comps, rct):
    """gdct::group over a phase: (first plane, planes) of each group."""
    per = [(0, 3)] + [(c, 1) for c in range(3, comps)] if rct else \
        [(c, 1) for c in range(comps)]
    return [(f * comps + c, nb) for f in range(frames) for c, nb in per]


def phases(rows):
    """The launch's phases: a grid row alone, or a run of block rows."""
    out, r0 = [], 0
    while r0 < len(rows):
        r1 = r0 + 1
        if rows[r0][0] == BLOCK:
            while r1 < len(rows) and rows[r1][0] == BLOCK:
                r1 += 1
        out.append((r0, r1))
        r0 = r1
    return out


def n_tiles(row, tile):
    return -(-row[1] // tile) * -(-row[2] // tile)


class Tile:
    """gdct::Tile: one tile of a w×h window and its nb buffers, which
    start as garbage."""

    def __init__(self, size, w, h, index, nb):
        ty, tx = divmod(index, -(-w // size))
        self.pitch = size + 4
        self.hx = self.pitch // 2
        self.ty0, self.tx0 = ty * size, tx * size
        self.tey, self.tex = min(size, h - self.ty0), min(size, w - self.tx0)
        self.eyn, self.exn = self.tey + 4, self.tex + 4
        self.buf = np.full((nb, self.pitch, self.pitch), GARBAGE, np.int32)

    def ext(self, h, w):
        """The window positions of the ext rows and columns, folded."""
        return (fold(self.ty0 - 2 + np.arange(self.eyn), h),
                fold(self.tx0 - 2 + np.arange(self.exn), w))

    def fill(self, vals):
        """Ext samples [nb, eyn, exn] into the buffers' layout."""
        self.buf[:, np.arange(self.eyn)[:, None],
                 xs(np.arange(self.exn), self.hx)[None, :]] = vals

    def step_y(self, first, count, rnd, shift, add):
        """Every stored column: those past the tile hold nothing a stored
        sample reads."""
        if count <= 0:
            return
        c = np.arange(self.pitch)
        y = first + 2 * np.arange(count)
        b = self.buf
        v = (b[:, y - 1][:, :, c] + b[:, y + 1][:, :, c] + np.int32(rnd)) \
            >> shift
        cur = b[:, y][:, :, c]
        b[:, y[:, None], c[None, :]] = cur + v if add else cur - v

    def step_x(self, first, count, rnd, shift, add, y_lo, y_hi):
        if count <= 0:
            return
        e = first + 2 * np.arange(count)
        rows = np.arange(y_lo, y_hi)[:, None]
        b = self.buf
        v = (b[:, rows, xs(e - 1, self.hx)] + b[:, rows, xs(e + 1, self.hx)]
             + np.int32(rnd)) >> shift
        cur = b[:, rows, xs(e, self.hx)]
        b[:, rows, xs(e, self.hx)] = cur + v if add else cur - v

    def single(self, v, inverse):
        return v >> 1 if inverse else v + v

    def single_y(self, inverse):
        self.buf[:, 2, :] = self.single(self.buf[:, 2, :], inverse)

    def single_x(self, inverse, y_lo, y_hi):
        c = xs(2, self.hx)
        self.buf[:, y_lo:y_hi, c] = self.single(self.buf[:, y_lo:y_hi, c],
                                                inverse)

    def fwd_lift(self, lo_x, lo_y, w, h):
        """gdct::fwd_lift."""
        if h > 1:
            fp = 2 if lo_y else 1
            self.step_y(fp, (self.eyn - fp) // 2, 0, 1, False)
            fu = 2 + lo_y
            self.step_y(fu, (self.eyn - 1 - fu) // 2, 2, 2, True)
        elif lo_y:
            self.single_y(False)
        if w > 1:
            fp = 2 if lo_x else 1
            self.step_x(fp, (self.exn - fp) // 2, 0, 1, False, 2,
                        2 + self.tey)
            fu = 2 + lo_x
            self.step_x(fu, (self.exn - 1 - fu) // 2, 2, 2, True, 2,
                        2 + self.tey)
        elif lo_x:
            self.single_x(False, 2, 2 + self.tey)

    def inv_lift(self, lo_x, lo_y, w, h):
        """gdct::inv_lift."""
        if w > 1:
            fu = 1 if lo_x else 2
            self.step_x(fu, (self.exn - fu) // 2, 2, 2, False, 0, self.eyn)
            fp = 3 - lo_x
            self.step_x(fp, (self.exn - 1 - fp) // 2, 0, 1, True, 0,
                        self.eyn)
        elif lo_x:
            self.single_x(True, 0, self.eyn)
        if h > 1:
            fu = 1 if lo_y else 2
            self.step_y(fu, (self.eyn - fu) // 2, 2, 2, False)
            fp = 3 - lo_y
            self.step_y(fp, (self.eyn - 1 - fp) // 2, 0, 1, True)
        elif lo_y:
            self.single_y(True)


class Scratch:
    """A launch's scratch areas (garbage at first) with each row's reads
    and writes, which must not meet: tiles of one level run at once."""

    def __init__(self, planes, words):
        self.words = words
        self.mem = np.full(planes * words, GARBAGE, np.int32)
        self.reads, self.writes = {}, {}

    def at(self, plane, off, q_y, q_x, pitch):
        return plane * self.words + off + q_y * pitch + q_x

    def read(self, ri, idx):
        self.reads.setdefault(ri, set()).update(np.ravel(idx).tolist())
        return self.mem[idx]

    def write(self, ri, idx, vals):
        self.writes.setdefault(ri, set()).update(np.ravel(idx).tolist())
        self.mem[idx] = vals

    def check(self):
        for ri, wr in self.writes.items():
            assert not wr & self.reads.get(ri, set()), \
                f"level {ri} writes scratch words it reads"


def _rct_fwd(r, g, b):
    return (r + g + g + b) >> 2, b - g, r - g


def fwd_launch_model(x, shift, schedule, comps, rct):
    """One launch of csrc/j2k_fwd_stage.cu on int32 samples x [P, H, W]:
    the final coefficients, each written once."""
    tile, words, rows = schedule
    p, h, w = x.shape
    frames = p // comps
    out = np.full((p, h, w), GARBAGE, np.int32)
    count = np.zeros((p, h, w), np.int64)
    scr = Scratch(p, words)
    wide = (x.astype(np.int64) - shift).astype(np.int32)
    if not rows:                   # no level: shift and RCT only
        out[...] = wide
        if rct:
            f = wide.reshape(frames, comps, h, w)
            f[:, :3] = np.stack(_rct_fwd(f[:, 0], f[:, 1], f[:, 2]), 1)
            out[...] = f.reshape(p, h, w)
        count += 1
    for r0, r1 in phases(rows):
        g3 = rct and r0 == 0
        for plane0, nb in groups(frames, comps, g3):
            for ri in range(r0, r1):
                row = rows[ri]
                for t in range(n_tiles(row, tile)):
                    fwd_tile_model(row, ri, tile, t, plane0, nb, g3, wide,
                                   out, count, scr)
    scr.check()
    assert (count == 1).all(), "an output sample is not written once"
    return out


def fwd_tile_model(row, ri, size, index, plane0, nb, g3, wide, out, count,
                   scr):
    """csrc/j2k_fwd_stage.cu::fwd_tile."""
    _, w, h, even_x, even_y, in_off, out_off = row
    lo_x, lo_y = 1 - even_x, 1 - even_y
    t = Tile(size, w, h, index, nb)
    qy, qx = t.ext(h, w)
    planes = plane0 + np.arange(nb)
    if in_off < 0:
        vals = wide[planes[:, None, None], qy[None, :, None],
                    qx[None, None, :]]
        if g3 and nb == 3:
            vals = np.stack(_rct_fwd(*vals))
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
    by = np.where(low_y, lo_y, 1 - lo_y) + 2 + 2 * oy
    bx = np.where(low_x, lo_x, 1 - lo_x) * t.hx + 1 + ox
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


def _stage_model(launches):
    """A stand-in for _kernels.j2k_fwd_stage; each launch's epilogue is
    appended to ``launches``."""
    def launch(src, coef, schedule, shift, epilogue, cb=0, narrow=None,
               maxabs=None, cb_max=None, cb_bits=None, comps=1, mct=False):
        assert src.dtype in _kernels.FWD_STAGE_DTYPES
        assert src.dim() == 3 and src.shape[0] % comps == 0
        assert (coef is None) == (epilogue == "narrow")
        if coef is not None:
            assert coef.dtype == torch.int32 and coef.shape == src.shape
            assert coef.data_ptr() != src.data_ptr()
        tile, _, rows = schedule
        rct = mct and comps >= 3
        assert len(rows) <= _kernels.STAGE_MAX_ROWS
        assert _kernels.stage_smem_bytes(tile, rct) <= HOPPER_SMEM
        launches.append(epilogue)
        c = fwd_launch_model(src.numpy().astype(np.int32), shift, schedule,
                             comps, rct)
        a = np.abs(c)                    # int32: |INT_MIN| stays INT_MIN
        if epilogue == "narrow":
            narrow.copy_(torch.as_tensor(c.astype(np.int16)))
            maxabs.fill_(int(a.max(initial=INT_MIN)))
            return
        coef.copy_(torch.as_tensor(c))
        if epilogue == "stats":
            p, h, w = c.shape
            for by in range(-(-h // cb)):
                for bx in range(-(-w // cb)):
                    blk = a[:, by * cb:(by + 1) * cb, bx * cb:(bx + 1) * cb]
                    full = blk.shape[1:] == (cb, cb)
                    m = blk.reshape(p, -1).max(
                        axis=1, initial=INT_MIN if full else 0)
                    cb_max[:, by, bx] = torch.as_tensor(m)
                    cb_bits[:, by, bx] = torch.as_tensor(
                        [int(v).bit_length() if v > 0 else 0 for v in m])
    return launch


@pytest.fixture(params=[8])
def tile(request, monkeypatch):
    """The stages' tile side in samples; the schedules are built anew, and
    the caches hold none of them after the test."""
    monkeypatch.setattr(dwt53, "_TILE", request.param)
    dwt53.fwd_schedule.cache_clear()
    dwt53.inv_schedule.cache_clear()
    yield request.param
    dwt53.fwd_schedule.cache_clear()
    dwt53.inv_schedule.cache_clear()


def no_other_kernels(monkeypatch, keep):
    """Every kernel wrapper of _kernels but those named in ``keep`` raises
    when called: a lane that launches another kernel beside its stage
    fails."""
    def refuse(name):
        def launch(*args, **kwargs):
            raise AssertionError(f"{name} launched beside {keep}")
        return launch
    for name in _kernels.launch_counts:
        if name not in keep:
            monkeypatch.setattr(_kernels, name, refuse(name))


@pytest.fixture
def kernel_lane(monkeypatch, tile):
    """The stage's kernel lane on CPU tensors, through the model; no other
    kernel may launch. Yields the launches."""
    launches = []
    no_other_kernels(monkeypatch, ("j2k_fwd_stage",))
    monkeypatch.setattr(_kernels, "j2k_fwd_stage", _stage_model(launches))
    monkeypatch.setattr(port, "fwd_stage", stage._fwd_stage_kernel)
    return launches


def _frames(rng, shape, bits, signed=False):
    lo = -(1 << (bits - 1)) if signed else 0
    return rng.integers(lo, lo + (1 << bits), shape).astype(np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("shape,levels,bits,signed,cb", [
    ((2, 64, 64), 5, 12, False, 64), ((3, 61, 37), 3, 16, False, 16),
    ((2, 40, 24), 2, 12, True, 8), ((1, 33, 70), 6, 8, False, 32),
    ((2, 70, 33), 0, 12, False, 16)])
@pytest.mark.parametrize("dtype", [np.int32, np.uint16])
def test_gray_encode_transform_bit_exact(shape, levels, bits, signed, cb,
                                         dtype, kernel_lane, rng):
    x = _frames(rng, shape, bits, signed)
    if dtype == np.uint16 and signed:
        dtype = np.int16
    got = port.j2k_lossless_encode_transform(
        torch.as_tensor(x.astype(dtype)), levels, bits, signed, cb)
    want = ref.j2k_lossless_encode_transform_jit(jnp.asarray(x), levels,
                                                 bits, signed, cb)
    for g, w in zip(got, want):
        _eq(g.numpy(), w)
    assert kernel_lane == ["stats"]


@pytest.mark.parametrize("shape,levels,bits", [((2, 3, 64, 48), 5, 8),
                                               ((1, 3, 37, 29), 3, 12)])
@pytest.mark.parametrize("fn", ["transform", "stage"])
def test_rgb_encode_transform_bit_exact(shape, levels, bits, fn, kernel_lane,
                                        rng):
    """The RGB stages, DC shift and RCT fused into one launch: the encode
    transform against go_dicom_codec_tpu/pipeline.py:368, the pipelines'
    narrow stage against :56."""
    x = _frames(rng, shape, bits)
    if fn == "transform":
        got = port.j2k_rgb_lossless_encode_transform(torch.as_tensor(x),
                                                     levels, bits, cb=16)
        want = ref.j2k_rgb_lossless_encode_transform(jnp.asarray(x), levels,
                                                     bits, cb=16)
    else:
        got = port._pipeline_device_stage_rgb(
            torch.as_tensor(x.astype(np.uint8 if bits == 8 else np.uint16)),
            bits, levels, True)
        want = ref._pipeline_device_stage_rgb(jnp.asarray(x), bits, levels,
                                              True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        _eq(g.numpy(), w)
    assert kernel_lane == ["stats" if fn == "transform" else "narrow"]


def test_no_plain_rct_on_the_kernel_lane(kernel_lane, monkeypatch, rng):
    """An RGB encode on the kernel lane runs the RCT inside the stage's
    launch: no plain-torch RCT runs (the pipelines, the scalar codec's
    tile stage), and the pipeline keeps no separate RCT step."""
    from go_dicom_codec_torch.codecs import jpeg2000
    from go_dicom_codec_torch.ops import mct

    def no_rct(*args):
        raise AssertionError("a plain-torch RCT ran on the kernel lane")
    for mod in (mct, stage, jpeg2000):
        monkeypatch.setattr(mod, "rct_forward", no_rct)
    monkeypatch.setattr(jpeg2000, "fwd_stage", stage._fwd_stage_kernel)
    assert not hasattr(port, "_rct_shifted")
    x = _frames(rng, (2, 3, 24, 40), 8)
    t = torch.as_tensor(x.astype(np.uint8))
    port._pipeline_device_stage_rgb(t, 8, 3, True)
    port._pipeline_device_stage_rgb(t, 8, 3, False)
    port.j2k_rgb_lossless_encode_transform(t, 3, 8, cb=16)
    got = jpeg2000.tile_coeffs_device(t, 1, 0, 3, 8, False, True, True)
    s = (x - 128).astype(np.int32)
    yuv = np.stack([(s[:, 0] + 2 * s[:, 1] + s[:, 2]) >> 2,
                    s[:, 2] - s[:, 1], s[:, 0] - s[:, 1]], axis=1)
    _eq(got.numpy(), ref_dwt.fwd53_multilevel_jit(jnp.asarray(yuv), 3, 1,
                                                  0))
    assert kernel_lane == ["narrow", "coeffs", "stats", "coeffs"]


# (rgb, bits, content bits): 16-bit content overflows int16 after the
# lifting gain, so the narrow stage's flag trips and fetch redoes in int32
@pytest.mark.parametrize("rgb,bits,content,dtype", [
    (False, 12, 12, np.uint16), (False, 16, 16, np.uint16),
    (False, 8, 8, np.uint8), (False, 12, 12, np.int64),
    (True, 8, 8, np.uint8), (True, 16, 16, np.int32)])
@pytest.mark.parametrize("narrow", [False, True])
def test_device_stage_and_fetch_bit_exact(rgb, bits, content, dtype, narrow,
                                          kernel_lane, rng):
    shape = (2, 3, 40, 56) if rgb else (2, 48, 40)
    x = _frames(rng, shape, content)
    t = torch.as_tensor(x.astype(dtype))
    if rgb:
        got = port._pipeline_device_stage_rgb(t, bits, 4, narrow)
        want = ref._pipeline_device_stage_rgb(jnp.asarray(x), bits, 4,
                                              narrow)
        wide = ref._pipeline_device_stage_rgb(jnp.asarray(x), bits, 4)
    else:
        got = port._pipeline_device_stage(t, bits, False, 4, narrow)
        want = ref._pipeline_device_stage(jnp.asarray(x), bits, False, 4,
                                          narrow)
        wide = ref._pipeline_device_stage(jnp.asarray(x), bits, False, 4)
    if narrow:
        assert got[0].dtype == torch.int16 and got[1].dtype == torch.int32
        _eq(got[0].numpy(), want[0])
        assert int(got[1]) == int(want[1])
        assert (int(got[1]) > 32767) == (content == 16)
    else:
        _eq(got.numpy(), want)
    host = port.fetch_coeffs(got, t, bits, False, 4, rgb=rgb)
    assert host.dtype == np.int32
    _eq(host, wide)
    # the int32 redo is one more launch of the stage
    redo = narrow and content == 16
    assert kernel_lane == (["narrow", "coeffs"] if redo
                           else ["narrow" if narrow else "coeffs"])


def _jax_stage(x, shift, levels, x0, y0, cb):
    """The stage's three outputs from the JAX package's functions."""
    c = ref_dwt.fwd53_multilevel_jit(jnp.asarray(x) - shift, levels, x0, y0)
    m = ref_stats.codeblock_max_abs(c, cb, cb)
    return (np.asarray(c), np.asarray(c.astype(jnp.int16)),
            int(jnp.max(jnp.abs(c))), np.asarray(m),
            np.asarray(ref_stats.max_bitplane(m)))


@pytest.mark.parametrize("shape,origin,levels", KERNEL_LANE_CASES)
@pytest.mark.parametrize("tile", [4, 8, 64], indirect=True)
def test_stage_model_odd_matrix_bit_exact(shape, origin, levels, tile,
                                          kernel_lane, rng):
    """The odd-shape, origin and level matrix of the per-pass lane's
    test, in all three epilogues, against the JAX 5/3 and block stats."""
    x = rng.integers(0, 1 << 12, shape).astype(np.int32)
    c, c16, maxabs, m, bits = _jax_stage(x, 2048, levels, *origin, 16)
    run = (lambda ep: stage._fwd_stage_kernel(torch.as_tensor(x), 2048,
                                              levels, *origin, ep, 16))
    _eq(run("coeffs").numpy(), c)
    got16, got_max = run("narrow")
    _eq(got16.numpy(), c16)
    assert int(got_max) == maxabs
    got_c, got_m, got_bits = run("stats")
    _eq(got_c.numpy(), c)
    _eq(got_m.numpy(), m)
    _eq(got_bits.numpy(), bits)
    assert kernel_lane == ["coeffs", "narrow", "stats"]


def test_stage_model_levels_1_to_6(kernel_lane, rng):
    x = rng.integers(0, 1 << 12, (2, 61, 37)).astype(np.uint16)
    for levels in range(1, 7):
        for x0, y0 in ((0, 0), (1, 0), (0, 1), (1, 1)):
            got = stage._fwd_stage_kernel(torch.as_tensor(x), 2048, levels,
                                          x0, y0, "coeffs", 64)
            _eq(got.numpy(), _jax_stage(x.astype(np.int32), 2048, levels,
                                        x0, y0, 64)[0])
    assert len(kernel_lane) == 24


@pytest.mark.parametrize("levels", range(7))
@pytest.mark.parametrize("tile", [4, 8, 64], indirect=True)
def test_stage_model_every_level_and_tile(levels, tile, kernel_lane, rng):
    """Levels 0-6 at every origin and tile side, gray and RGB (the RCT
    fused), with frames whose tiles are partial at both edges."""
    x = rng.integers(0, 1 << 12, (2, 3, 27, 45)).astype(np.uint16)
    for x0, y0 in ((0, 0), (1, 0), (0, 1), (1, 1)):
        got = stage._fwd_stage_kernel(torch.as_tensor(x), 2048, levels, x0,
                                      y0, "coeffs", 64)
        _eq(got.numpy(), _jax_stage(x.astype(np.int32), 2048, levels, x0,
                                    y0, 64)[0])
        got = stage._fwd_stage_kernel(torch.as_tensor(x), 2048, levels, x0,
                                      y0, "coeffs", 64, mct=True)
        s = x.astype(np.int32) - 2048
        yuv = np.stack([(s[:, 0] + 2 * s[:, 1] + s[:, 2]) >> 2,
                        s[:, 2] - s[:, 1], s[:, 0] - s[:, 1]], axis=1)
        _eq(got.numpy(), ref_dwt.fwd53_multilevel_jit(jnp.asarray(yuv),
                                                      levels, x0, y0))
    assert kernel_lane == ["coeffs"] * 8


def test_stage_phases_at_512():
    """At 5 levels of 512² each stage is 3 grid levels and one block phase
    of the two coarsest: 4 phases, 3 grid barriers (10 passes before)."""
    for sched in (dwt53.fwd_schedule(512, 512, 5),
                  dwt53.inv_schedule(512, 512, 5)):
        rows = sched[2]
        assert [r[0] for r in rows].count(GRID) == 3
        assert len(phases(rows)) == 4


@pytest.mark.parametrize("schedule", [(128, 0, ()), (3, 0, ()), (0, 0, ()),
                                      (8, 0, ((0, 1, 1, 1, 1, -1, -1),) * 65)])
def test_stage_table_refuses_bad_schedules(schedule):
    """Tiles over 64 samples or odd, and tables over 64 levels, are refused
    before any launch."""
    with pytest.raises(_kernels.KernelLaunchError):
        _kernels._stage_table("j2k_fwd_stage", schedule)


EDGE = np.array([[INT_MIN, 5, 0, 0, 1, 40000],
                 [INT_MIN, INT_MIN, 0, 0, 2, -40000],
                 [INT_MIN, INT_MIN, 0, 0, 65535, -32769],
                 [INT_MIN, INT_MIN, 0, 0, 1 << 30, 2**31 - 1],
                 [7, -8, 3, 3, -1, 0]], dtype=np.int32)


@pytest.mark.parametrize("case", ["mixed", "all_int_min", "zeros"])
def test_epilogue_edge_cases(case, kernel_lane):
    """|INT_MIN| stays INT_MIN and raises no max, max_bitplane gives 0 for
    a max of 0 or less, .to(int16) wraps, and the zero padding of a
    partial code-block raises no max: the model, the plain version and the
    JAX package agree. Levels 0: the coefficients are the samples."""
    x = {"mixed": EDGE, "all_int_min": np.full((5, 6), INT_MIN, np.int32),
         "zeros": np.zeros((5, 6), np.int32)}[case][None]
    want = ref.j2k_lossless_encode_transform_jit(jnp.asarray(x), 0, 16, True,
                                                 2)
    want16 = ref._pipeline_device_stage(jnp.asarray(x), 16, True, 0, True)
    for fn in (stage._fwd_stage_kernel, stage.fwd_stage_plain):
        got = fn(torch.as_tensor(x), 0, 0, 0, 0, "stats", 2)
        for g, w in zip(got, want):
            _eq(g.numpy(), w)
        c16, maxabs = fn(torch.as_tensor(x), 0, 0, 0, 0, "narrow", 2)
        _eq(c16.numpy(), want16[0])
        assert int(maxabs) == int(want16[1])
    if case == "mixed":
        # [[INT_MIN, 5], [INT_MIN, INT_MIN]] → 5; a full block of INT_MIN
        # → INT_MIN and 0 bit planes; the partial bottom row → its |max|
        assert got[1].tolist() == [[[5, 0, 40000], [INT_MIN, 0, 2**31 - 1],
                                    [8, 3, 1]]]
        assert got[2].tolist() == [[[3, 0, 16], [0, 0, 31], [4, 2, 1]]]
    assert kernel_lane == ["stats", "narrow"]


def test_stage_widens_each_dtype(kernel_lane, rng):
    """uint16 (65535 exact), int16, int32 and uint8 are read as they are;
    other types (int8, int64) are cast to int32 first, as the reference's
    astype."""
    x = rng.integers(0, 256, (2, 9, 11))
    x[0, 0, :3] = (0, 255, 128)
    wide = rng.integers(0, 65536, (2, 9, 11))
    wide[0, 0, :2] = (65535, 0)
    for arr, shift in ((x.astype(np.uint8), 128), (x.astype(np.int8), 0),
                       (wide.astype(np.uint16), 32768),
                       (wide.astype(np.int16), 0),
                       (wide.astype(np.int32), 32768),
                       (wide.astype(np.int64), 32768)):
        got = stage._fwd_stage_kernel(torch.as_tensor(arr), shift, 2, 0, 0,
                                      "coeffs", 64)
        want = ref_dwt.fwd53_multilevel_jit(
            jnp.asarray(arr).astype(jnp.int32) - shift, 2)
        _eq(got.numpy(), want)
    assert len(kernel_lane) == 6


@pytest.mark.parametrize("tile", [64], indirect=True)
def test_long_lines_take_the_stage(kernel_lane, rng):
    """A frame 60001 samples wide (DICOM allows 65535) runs in one launch
    of the fused stage and no other kernel: its table spreads the tiles
    along the long side, and the narrow stage comes out bit-exact against
    the plain lane and the JAX pipeline's stage."""
    x = rng.integers(0, 1 << 12, (1, 4, 60001)).astype(np.uint16)
    got = stage._fwd_stage_kernel(torch.as_tensor(x), 2048, 2, 0, 0,
                                  "narrow", 64)
    want = stage.fwd_stage_plain(torch.as_tensor(x), 2048, 2, 0, 0,
                                 "narrow", 64)
    _eq(got[0].numpy(), want[0].numpy())
    assert int(got[1]) == int(want[1])
    want = ref._pipeline_device_stage(jnp.asarray(x), 12, False, 2, True)
    _eq(got[0].numpy(), want[0])
    assert kernel_lane == ["narrow"]


def test_stage_lanes_by_device():
    x = torch.zeros((2, 8, 8), dtype=torch.uint16)
    got = stage.fwd_stage(x, 0, 2, epilogue="stats", cb=4)  # CPU: plain
    assert [tuple(t.shape) for t in got] == [(2, 8, 8), (2, 2, 2), (2, 2, 2)]
    with pytest.raises(ValueError, match="no lane"):
        stage.fwd_stage(x.to("meta"), 0, 1)
    with pytest.raises(ValueError, match="epilogue"):
        stage.fwd_stage(x, 0, 1, epilogue="max")
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.j2k_fwd_stage(x, x.to(torch.int32), [], 0, "coeffs")
