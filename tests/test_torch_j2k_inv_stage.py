"""Port parity: the fused J2K inverse stage, bit-exact against the JAX
package.

A numpy model of one csrc/j2k_inv_stage.cu launch stands in for the kernel
here. It takes the launch's arguments (the level table with its block
rows, the head; the epilogue; an int16 or int32 input) and runs what the
kernel runs, tile by tile (csrc/lifting.cuh, modelled in
test_torch_j2k_fwd_stage): each level, coarsest first, loads the packed
coefficients of its tile and a halo of 2 through the symmetric fold — the
LL from the scratch area the level above wrote (the coarsest level's from
the input), the high bands from the input — undoes the row and column
lifting by the kernel's steps over the kernel's ranges and stores the
tile interleaved: to scratch, or at the finest level through the
epilogue (inverse RCT of a group of components 0-2, unshift, clip and
16-bit cast). Scratch and output start as garbage, as torch.empty leaves
them; the model checks that every output sample is written once and that
no level writes scratch words it reads. Through the model the kernel lane
of the decode stage, of the in-place inverse 5/3 and of the decode
pipeline is held against go_dicom_codec_tpu/pipeline.py and its 5/3, with
the head's budget set to none, 64 and 4096 samples and the tile side cut
to 4 and 8 samples (64 on the card).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu import pipeline as ref
from go_dicom_codec_tpu.ops import dwt53 as ref_dwt
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch import pipeline as port
from go_dicom_codec_torch.ops import dwt53
from go_dicom_codec_torch.ops import j2k_inv_stage as stage
from go_dicom_codec_torch.ops.mct import dc_level_shift, rct_forward
from test_torch_dwt53 import KERNEL_LANE_CASES
# `tile`: the fixture of the stages' tile side, shared with those tests
from test_torch_j2k_fwd_stage import (BLOCK, GARBAGE, GRID, HOPPER_SMEM,
                                      Scratch, Tile, groups, n_tiles,
                                      no_other_kernels, phases, tile,
                                      to_packed, xs)


def _rct_inv(y, u, v):
    g = y - ((u + v) >> 2)
    return v + g, g, u + g


def inv_launch_model(x, schedule, comps, rct, dc):
    """One launch of csrc/j2k_inv_stage.cu on int32 coefficients x
    [P, H, W]: the finest level's samples after the inverse RCT and + dc,
    in int32, each written once."""
    tile, words, rows = schedule
    p, h, w = x.shape
    frames = p // comps
    out = np.full((p, h, w), GARBAGE, np.int32)
    count = np.zeros((p, h, w), np.int64)
    scr = Scratch(p, words)
    if not rows:                   # no level: the epilogue of the input
        f = x.reshape(frames, comps, h, w).copy()
        if rct:
            f[:, :3] = np.stack(_rct_inv(f[:, 0], f[:, 1], f[:, 2]), 1)
        out[...] = f.reshape(p, h, w) + np.int32(dc)
        count += 1
    for r0, r1 in phases(rows):
        g3 = rct and r1 == len(rows)
        for plane0, nb in groups(frames, comps, g3):
            for ri in range(r0, r1):
                row = rows[ri]
                for t in range(n_tiles(row, tile)):
                    inv_tile_model(row, ri, tile, t, plane0, nb, g3, x, dc,
                                   out, count, scr)
    scr.check()
    assert (count == 1).all(), "an output sample is not written once"
    return out


def inv_tile_model(row, ri, size, index, plane0, nb, g3, x, dc, out, count,
                   scr):
    """csrc/j2k_inv_stage.cu::inv_tile."""
    _, w, h, even_x, even_y, in_off, out_off = row
    lo_x, lo_y = 1 - even_x, 1 - even_y
    snx, sny = (w + even_x) >> 1, (h + even_y) >> 1
    t = Tile(size, w, h, index, nb)
    qy, qx = t.ext(h, w)
    py, px = to_packed(qy, sny, lo_y), to_packed(qx, snx, lo_x)
    planes = plane0 + np.arange(nb)
    vals = x[planes[:, None, None], py[None, :, None], px[None, None, :]]
    ll = (py[:, None] < sny) & (px[None, :] < snx)
    if in_off >= 0 and ll.any():
        yy, xx = np.broadcast_to(py[:, None], ll.shape)[ll], \
            np.broadcast_to(px[None, :], ll.shape)[ll]
        for k, plane in enumerate(planes):
            vals[k][ll] = scr.read(ri, scr.at(plane, in_off, yy, xx, snx))
    t.fill(vals)
    t.inv_lift(lo_x, lo_y, w, h)
    oy, ox = np.arange(t.tey), np.arange(t.tex)
    rec = t.buf[:, 2 + oy[:, None], xs(2 + ox, t.hx)[None, :]]
    qy, qx = t.ty0 + oy[:, None], t.tx0 + ox[None, :]
    qy, qx = np.broadcast_to(qy, rec.shape[1:]), np.broadcast_to(qx,
                                                                 rec.shape[1:])
    if out_off >= 0:
        for k, plane in enumerate(planes):
            scr.write(ri, scr.at(plane, out_off, qy, qx, w), rec[k])
        return
    if g3 and nb == 3:
        rec = np.stack(_rct_inv(*rec))
    for k, plane in enumerate(planes):
        out[plane, qy, qx] = rec[k] + np.int32(dc)
        count[plane, qy, qx] += 1


def _inv_stage_model(launches):
    """A stand-in for _kernels.j2k_inv_stage; each launch's epilogue is
    appended to ``launches``."""
    def launch(src, out, schedule, comps, epilogue, mct=False, bits=16,
               signed=False):
        assert src.dtype in _kernels.INV_STAGE_DTYPES
        assert src.dim() == 3 and src.shape[0] % comps == 0
        assert out.shape == src.shape and out.data_ptr() != src.data_ptr()
        tile_side, _, rows = schedule
        mct = mct and epilogue != "coeffs"
        rct = mct and comps >= 3
        assert len(rows) <= _kernels.STAGE_MAX_ROWS
        assert _kernels.stage_smem_bytes(tile_side, rct) <= HOPPER_SMEM
        launches.append(epilogue)
        dc = 0 if signed or epilogue == "coeffs" else 1 << (bits - 1)
        px = inv_launch_model(src.numpy().astype(np.int32), schedule, comps,
                              rct, dc)
        if epilogue == "narrow":
            lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
                      else (0, (1 << bits) - 1))
            assert out.dtype == (torch.int16 if signed else torch.uint16)
            px = np.clip(px, lo, hi).astype(np.int16 if signed else np.uint16)
        else:
            assert out.dtype == torch.int32
        out.copy_(torch.as_tensor(px))
    return launch


@pytest.fixture
def kernel_lane(monkeypatch, tile):
    """The stage's kernel lane on CPU tensors, through the model; no other
    kernel may launch. Yields the launches."""
    launches = []
    no_other_kernels(monkeypatch, ("j2k_inv_stage",))
    monkeypatch.setattr(_kernels, "j2k_inv_stage", _inv_stage_model(launches))
    monkeypatch.setattr(port, "inv_stage", stage._inv_stage_kernel)
    return launches


@pytest.fixture
def set_head(monkeypatch):
    """Sets the head's budget in samples, its sides unbounded; the
    schedules are built anew, and the cache holds none of them after the
    test."""
    def set_budget(samples):
        monkeypatch.setattr(dwt53, "_HEAD_SAMPLES", samples)
        monkeypatch.setattr(dwt53, "_HEAD_SIDE", None)
        dwt53.inv_schedule.cache_clear()
    yield set_budget
    dwt53.inv_schedule.cache_clear()


@pytest.fixture(params=[0, 64, 4096], ids=["nohead", "head64", "head4096"])
def head(request, set_head):
    """The head's budget in samples."""
    set_head(request.param)
    return request.param


def _frames(rng, shape, bits, signed=False):
    lo = -(1 << (bits - 1)) if signed else 0
    return rng.integers(lo, lo + (1 << bits), shape).astype(np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _packed(px, bits, signed, mct, levels, x0, y0):
    """The reversible coefficients of pixels px [B, C, H, W]."""
    s = dc_level_shift(torch.as_tensor(px), bits, signed)
    if mct:
        y, u, v = rct_forward(s[:, 0], s[:, 1], s[:, 2])
        s = torch.cat([torch.stack([y, u, v], 1), s[:, 3:]], 1)
    return dwt53.fwd53_multilevel_(s.clone(), levels, x0, y0).numpy()


def _check_stage(packed, levels, x0, y0, bits, signed, mct, narrow):
    """The kernel lane of the pipeline's decode stage against the JAX
    stage; returns the port's result as int32."""
    got = port._j2k_decode_device_stage(torch.as_tensor(packed), levels, x0,
                                        y0, bits, signed, mct, narrow)
    want = np.asarray(ref._j2k_decode_device_stage(
        jnp.asarray(packed), levels, x0, y0, bits, signed, mct, narrow))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _eq(got.to(torch.int32).numpy(), want.astype(np.int32))
    return got.to(torch.int32).numpy()


# (components, mct, bits, signed)
EPILOGUE_CASES = [(1, False, 8, False), (1, False, 12, False),
                  (1, False, 16, False), (1, False, 12, True),
                  (1, False, 16, True), (3, True, 8, False),
                  (3, True, 12, False), (3, False, 12, False),
                  (3, True, 16, True), (4, True, 8, False),
                  (4, False, 16, True), (4, True, 12, True)]


@pytest.mark.parametrize("c,mct,bits,signed", EPILOGUE_CASES)
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("head", [64], indirect=True)
def test_decode_stage_epilogue_matrix(c, mct, bits, signed, dtype, narrow,
                                      head, kernel_lane, rng):
    """Components, mct, depth, sign, input type and narrow, with a head
    and grid passes; one coefficient out of range, so the clip acts."""
    content = min(bits, 12) if dtype == np.int16 else bits
    px = _frames(rng, (2, c, 37, 45), content, signed)
    packed = _packed(px, bits, signed, mct, 3, 1, 0)
    packed[0, 0, 0, 0] += 1 << (14 if dtype == np.int16 else bits + 2)
    assert np.abs(packed).max() <= np.iinfo(dtype).max
    got = _check_stage(packed.astype(dtype), 3, 1, 0, bits, signed, mct,
                       narrow)
    _eq(got[1], px[1])
    assert kernel_lane == ["narrow" if narrow else "pixels"]


@pytest.mark.parametrize("levels", range(7))
@pytest.mark.parametrize("origin", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("tile", [4, 8, 64], indirect=True)
def test_decode_stage_levels_and_origins(levels, origin, tile, head,
                                         kernel_lane, rng):
    px = _frames(rng, (2, 3, 29, 23), 8)
    packed = _packed(px, 8, False, True, levels, *origin)
    got = _check_stage(packed.astype(np.int16), levels, *origin, 8, False,
                       True, True)
    _eq(got, px)
    assert kernel_lane == ["narrow"]


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (6, 1), (2, 7), (7, 2)])
@pytest.mark.parametrize("narrow", [False, True])
def test_decode_stage_one_sample_windows(shape, narrow, head, kernel_lane,
                                         rng):
    """1-sample windows at odd origins still run (the >>1 rule)."""
    px = _frames(rng, (2, 1) + shape, 12)
    packed = _packed(px, 12, False, False, 3, 1, 1)
    _eq(_check_stage(packed, 3, 1, 1, 12, False, False, narrow), px)
    assert len(kernel_lane) == 1


@pytest.mark.parametrize("tile", [64], indirect=True)
def test_decode_stage_at_512_with_each_head(kernel_lane, set_head, rng):
    """[1, 1, 512, 512] int16 → uint16 at the budgets measured on the
    card: none, 64² and 128², at the card's tile side."""
    px = _frames(rng, (1, 1, 512, 512), 12)
    packed = _packed(px, 12, False, False, 5, 0, 0).astype(np.int16)
    want = np.asarray(ref._j2k_decode_device_stage(
        jnp.asarray(packed), 5, 0, 0, 12, False, False, True))
    for budget, extent in ((0, 0), (64 * 64, 64), (128 * 128, 128)):
        set_head(budget)
        rows = dwt53.inv_schedule(512, 512, 5)[2]
        assert max([r[1] for r in rows if r[0] == BLOCK], default=0) \
            == extent
        got = port._j2k_decode_device_stage(torch.as_tensor(packed), 5, 0, 0,
                                            12, False, False, True)
        _eq(got.to(torch.int32).numpy(), want.astype(np.int32))
        _eq(got.to(torch.int32).numpy(), px)
    assert kernel_lane == ["narrow"] * 3


@pytest.mark.parametrize("shape,origin,levels", KERNEL_LANE_CASES)
def test_inverse_in_place_bit_exact(shape, origin, levels, head, kernel_lane,
                                    rng):
    """inv53_multilevel_'s kernel lane: one launch, in place on the int32
    input, against the JAX inverse of the JAX forward."""
    x = rng.integers(-4096, 4096, shape).astype(np.int32)
    coeffs = np.asarray(ref_dwt.fwd53_multilevel_jit(jnp.asarray(x), levels,
                                                     *origin))
    t = torch.tensor(coeffs)
    got = dwt53._inv_multilevel_kernel_(t, levels, *origin)
    assert got is t
    _eq(got.numpy(), ref_dwt.inv53_multilevel_jit(jnp.asarray(coeffs),
                                                  levels, *origin))
    _eq(got.numpy(), x)
    assert kernel_lane == ["coeffs"]


def test_coeffs_epilogue_widens_untouched_samples(kernel_lane, rng):
    """With no level to run the "coeffs" epilogue still widens every
    sample of an int16 input; "pixels" and "narrow" still unshift."""
    x = rng.integers(-2048, 2048, (2, 3, 5, 4)).astype(np.int16)
    for levels in (0, 2):
        want = ref_dwt.inv53_multilevel_jit(jnp.asarray(x, jnp.int32),
                                            levels)
        got = stage._inv_stage_kernel(torch.as_tensor(x), levels,
                                      epilogue="coeffs")
        assert got.dtype == torch.int32
        _eq(got.numpy(), want)
        got = stage._inv_stage_kernel(torch.as_tensor(x), levels, bits=12,
                                      mct=True, epilogue="narrow")
        _eq(got.to(torch.int32).numpy(), ref._j2k_decode_device_stage(
            jnp.asarray(x), levels, 0, 0, 12, False, True, True))
    assert kernel_lane == ["coeffs", "narrow"] * 2


def test_stage_leaves_its_input(kernel_lane, rng):
    x = rng.integers(-100, 100, (1, 3, 16, 16)).astype(np.int32)
    t = torch.as_tensor(x.copy())
    for epilogue in ("coeffs", "pixels", "narrow"):
        stage._inv_stage_kernel(t, 2, bits=8, mct=True, epilogue=epilogue)
        _eq(t.numpy(), x)


# ---- the decode pipeline through the model ---------------------------------

CPU = torch.device("cpu")


def _walk(rng, shape, bits=12):
    return (np.cumsum(rng.integers(-9, 10, shape), axis=-2 if len(shape) == 4
                      else -1) % (1 << bits)).astype(np.int32)


@pytest.mark.parametrize("n,chunk", [(1, 8), (3, 2), (8, 8), (9, 4)])
def test_pipelines_match_reference(n, chunk, kernel_lane, rng):
    """The device engine's decode, one stage launch a chunk."""
    frames = _walk(rng, (n, 48, 40))
    streams = ref.encode_frames_pipelined(frames, bit_depth=12, levels=2,
                                          chunk=chunk, device="device")
    dec = port.decode_frames_pipelined(streams, chunk=chunk, engine="device",
                                       device=CPU)
    ref_dec = ref.decode_frames_pipelined(streams, chunk=chunk,
                                          device="device")
    assert len(dec) == n
    for d, r, f in zip(dec, ref_dec, frames):
        assert d.dtype == np.int32 and d.shape == (48, 40, 1)
        _eq(d, r)
        _eq(d[..., 0], f)
    assert kernel_lane == ["narrow"] * -(-n // chunk)


@pytest.mark.parametrize("reduce", [1, 2])
def test_pipeline_reduce_matches_reference(reduce, kernel_lane, rng):
    """A reduced reversible decode keeps int32 pixels ("pixels")."""
    frames = _walk(rng, (3, 40, 36))
    streams = ref.encode_frames_pipelined(frames, bit_depth=12, levels=3)
    want = ref.decode_frames_pipelined(streams, device="device",
                                       reduce=reduce)
    got = port.decode_frames_pipelined(streams, engine="device",
                                       reduce=reduce, device=CPU)
    for g, w in zip(got, want):
        _eq(g, w)
    assert kernel_lane == ["pixels"]


@pytest.mark.parametrize("case", ["rgb8", "rgb12-odd", "signed12"])
def test_pipeline_shapes_and_depths_match_reference(case, kernel_lane, rng):
    bits, signed = 12, False
    if case == "rgb8":
        frames, bits = _walk(rng, (3, 24, 40, 3), 8), 8
    elif case == "rgb12-odd":
        frames = _walk(rng, (2, 21, 35, 3))
    else:
        frames, signed = _walk(rng, (3, 32, 24)) - 2048, True
    streams = ref.encode_frames_pipelined(frames, bit_depth=bits,
                                          signed=signed, levels=3)
    dec = port.decode_frames_pipelined(streams, engine="device", device=CPU)
    for d, r, f in zip(dec, ref.decode_frames_pipelined(streams), frames):
        _eq(d, r)
        _eq(d.reshape(f.shape), f)
    assert kernel_lane == ["narrow"]


def test_refused_launch_propagates_through_the_decode_adapter(monkeypatch,
                                                              rng):
    """A refused stage launch leaves codec.decode as KernelLaunchError; the
    adapters' scalar fallback catches only ValueError."""
    import go_dicom_codec_torch as gdc

    frames = rng.integers(0, 4096, (3, 16, 24)).astype(np.int32)
    info = gdc.FrameInfo(width=24, height=16, bits_allocated=16,
                         bits_stored=12)
    src = gdc.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype("<u2").tobytes())
    codec = gdc.make_registry(CPU, engine="device").get_codec(
        gdc.uids.JPEG_2000_LOSSLESS)
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)

    def refused(*args, **kwargs):
        raise _kernels.KernelLaunchError("j2k_inv_stage: refused")
    monkeypatch.setattr(_kernels, "j2k_inv_stage", refused)
    monkeypatch.setattr(port, "inv_stage", stage._inv_stage_kernel)
    with pytest.raises(_kernels.KernelLaunchError, match="refused"):
        codec.decode(enc, gdc.MemoryPixelData(info=info))


# ---- routes and lanes ---------------------------------------------------------

def test_inv_schedule_route_by_shape():
    """The head, the grid levels, the scratch areas and the route follow
    from the shape alone, before any launch."""
    tile, words, rows = dwt53.inv_schedule(512, 512, 5)
    assert tile == 64
    # levels 5 and 4 (32² and 64² windows) in the head, coarsest first,
    # then levels 3, 2, 1 on the grid: 4 phases, 3 grid barriers; each
    # level reads the area the level above wrote and writes the other
    assert rows == ((BLOCK, 32, 32, 1, 1, -1, 65536),
                    (BLOCK, 64, 64, 1, 1, 65536, 0),
                    (GRID, 128, 128, 1, 1, 0, 65536),
                    (GRID, 256, 256, 1, 1, 65536, 0),
                    (GRID, 512, 512, 1, 1, 0, -1))
    assert words == 256 * 256 + 128 * 128
    assert len(phases(rows)) == 4
    assert _kernels.stage_smem_bytes(tile, False) == 68 * 68 * 4
    assert _kernels.stage_smem_bytes(tile, True) == 3 * 68 * 68 * 4
    # a table for every line length: the longest the stage's shared memory
    # held before the tile pass took long lines (58111), then longer ones
    # up to DICOM's 65535
    for n in (58104, 58111, 58112, 60001, 65535):
        assert dwt53.inv_schedule(n, 3, 5)[2][-1][1:3] == (n, 3)
        assert dwt53.inv_schedule(3, n, 5)[2][-1][1:3] == (3, n)
    # the head bounds its sides by 64 samples: the coarse 4096×1 window
    # of a 16-row frame 65535 wide is a grid row, not one block walking
    # its 64 tiles
    rows = dwt53.inv_schedule(65535, 16, 5)[2]
    assert [r[:3] for r in rows] == [(GRID, 4096, 1), (GRID, 8192, 2),
                                     (GRID, 16384, 4), (GRID, 32768, 8),
                                     (GRID, 65535, 16)]
    assert dwt53._inv_schedule(65535, 16, 5, 0, 0, 64 * 64)[2][0][:3] == (
        BLOCK, 4096, 1)
    # no level to run; 1-sample windows at odd origins still run
    assert dwt53.inv_schedule(7, 5, 0) == (64, 0, ())
    assert dwt53.inv_schedule(1, 1, 2, 1, 1) == (
        64, 0, ((BLOCK, 1, 1, 0, 0, -1, -1),))
    assert dwt53._inv_schedule(1, 1, 2, 1, 1, 0) == (
        64, 0, ((GRID, 1, 1, 0, 0, -1, -1),))


@pytest.mark.parametrize("tile", [64], indirect=True)
def test_long_lines_take_the_stage(kernel_lane, rng):
    """A frame 60001 samples wide (DICOM allows 65535) decodes in one
    launch of the fused stage and no other kernel, bit-exact against the
    plain lane and back to its pixels."""
    px = _frames(rng, (1, 1, 4, 60001), 12)
    packed = torch.as_tensor(
        _packed(px, 12, False, False, 2, 0, 0).astype(np.int16))
    got = stage._inv_stage_kernel(packed, 2, 0, 0, 12, False, False,
                                  "narrow")
    want = stage.inv_stage_plain(packed, 2, 0, 0, 12, False, False, "narrow")
    _eq(got.to(torch.int32).numpy(), want.to(torch.int32).numpy())
    _eq(got.to(torch.int32).numpy(), px)
    assert kernel_lane == ["narrow"]


def test_stage_lanes_by_device():
    x = torch.zeros((1, 3, 8, 8), dtype=torch.int16)
    got = stage.inv_stage(x, 2, bits=8, mct=True)   # CPU: plain, pixels
    assert got.dtype == torch.int32 and bool((got == 128).all())
    assert stage.inv_stage(x, 2, bits=8, epilogue="narrow").dtype \
        == torch.uint16
    with pytest.raises(ValueError, match="no lane"):
        stage.inv_stage(x.to("meta"), 1)
    with pytest.raises(ValueError, match="epilogue"):
        stage.inv_stage(x, 1, epilogue="stats")
    x3 = torch.zeros((3, 8, 8), dtype=torch.int32)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.j2k_inv_stage(x3, x3, dwt53.inv_schedule(8, 8, 2), 3,
                               "coeffs")
