"""Port parity: the fused J2K inverse stage, bit-exact against the JAX
package.

A numpy model of one csrc/j2k_inv_stage.cu launch stands in for the kernel
here. It takes the launch's arguments (the pass table with the head's
extent, the epilogue, an int16 or int32 input) and does what the kernel
does: the head levels on a tile of each plane's head window, then every
grid pass of the table through the model of the shared-memory lifting body
(test_torch_dwt53._pass_model), each pass reading the window earlier passes
wrote from the coefficients and the rest from the input, then the epilogue
(inverse RCT, unshift, clip and 16-bit cast). The coefficient buffer starts
as garbage, as torch.empty leaves it. Through the model the kernel lane of
the decode stage, of the in-place inverse 5/3 and of the decode pipeline is
held against go_dicom_codec_tpu/pipeline.py and its 5/3, with the head's
budget set to none, 64 and 4096 samples.
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
from test_torch_dwt53 import KERNEL_LANE_CASES, _pass_model

GARBAGE = 0x5A5A5A5A


def _inv_stage_model(launches):
    """A stand-in for _kernels.j2k_inv_stage; each launch's epilogue is
    appended to ``launches``."""
    def launch(src, coef, schedule, comps, epilogue, mct=False, bits=16,
               signed=False, out=None):
        assert src.dtype in _kernels.INV_STAGE_DTYPES
        assert coef.dtype == torch.int32 and coef.shape == src.shape
        assert src.dim() == 3 and src.shape[0] % comps == 0
        head_w, head_h, head_rows, rows, final_w, final_h = schedule
        assert len(head_rows) + len(rows) <= _kernels.STAGE_MAX_PASSES
        assert (_kernels.inv_stage_smem_bytes(schedule)
                <= _kernels.SMEM_MAX_BYTES)
        launches.append(epilogue)
        p, h, w = src.shape
        wide = torch.as_tensor(src.numpy().astype(np.int32))  # a load of src
        if coef.data_ptr() != src.data_ptr():
            coef.fill_(GARBAGE)
        # 1. the head: each plane's head window lifted on a tile
        if head_w:
            tile = wide[:, :head_h, :head_w].clone(
                memory_format=torch.contiguous_format)
            for n_lines, ls, n, es, lpb, even in head_rows:
                _pass_model(tile, n_lines, ls, n, es, lpb, bool(even),
                            inverse=True)
            coef[:, :head_h, :head_w] = tile
        # 2. the grid passes: what earlier passes wrote from coef, the rest
        # from src
        flat, flat_src = coef.view(p, -1), wide.view(p, -1)
        for n_lines, ls, n, es, lpb, even, done_lines, done_n in rows:
            j, i = np.arange(n_lines)[:, None], np.arange(n)[None, :]
            addr = torch.as_tensor(j * ls + i * es)
            done = torch.as_tensor((j < done_lines) & (i < done_n))
            lines = flat.clone()
            lines[:, addr] = torch.where(done, flat[:, addr],
                                         flat_src[:, addr])
            _pass_model(lines.view(p, h, w), n_lines, ls, n, es, lpb,
                        bool(even), inverse=True)
            flat[:, addr] = lines[:, addr]
        # 3. the epilogue: the final window from coef, the rest from src
        c = wide.numpy().copy()
        c[:, :final_h, :final_w] = coef.numpy()[:, :final_h, :final_w]
        if epilogue == "coeffs":
            coef.copy_(torch.as_tensor(c))
            return
        px = c.reshape(p // comps, comps, h, w)
        if mct and comps >= 3:     # int32 numpy arithmetic wraps, as torch
            y, u, v = px[:, 0], px[:, 1], px[:, 2]
            g = y - ((u + v) >> 2)
            px = np.concatenate([np.stack([v + g, g, u + g], 1), px[:, 3:]],
                                1)
        if not signed:
            px = px + np.int32(1 << (bits - 1))
        px = px.reshape(p, h, w)
        if epilogue == "narrow":
            lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
                      else (0, (1 << bits) - 1))
            px = np.clip(px, lo, hi).astype(np.int16 if signed else np.uint16)
        out.copy_(torch.as_tensor(px))
    return launch


@pytest.fixture
def kernel_lane(monkeypatch):
    """The stage's kernel lane on CPU tensors, through the model; the
    per-pass kernels must not launch. Yields the launches."""
    launches = []
    monkeypatch.setattr(_kernels, "j2k_inv_stage", _inv_stage_model(launches))
    monkeypatch.setattr(port, "inv_stage", stage._inv_stage_kernel)

    def no_pass(*args):
        raise AssertionError("a lifting pass launched beside the stage")
    monkeypatch.setattr(_kernels, "dwt53_pass", no_pass)
    return launches


@pytest.fixture
def set_head(monkeypatch):
    """Sets the head's budget in samples; the schedules are built anew,
    and the cache holds none of them after the test."""
    def set_budget(samples):
        monkeypatch.setattr(dwt53, "_HEAD_SAMPLES", samples)
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
def test_decode_stage_levels_and_origins(levels, origin, head, kernel_lane,
                                         rng):
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


def test_decode_stage_at_512_with_each_head(kernel_lane, set_head, rng):
    """[1, 1, 512, 512] int16 → uint16 at the budgets measured on the
    card: none, 64² and 128²."""
    px = _frames(rng, (1, 1, 512, 512), 12)
    packed = _packed(px, 12, False, False, 5, 0, 0).astype(np.int16)
    want = np.asarray(ref._j2k_decode_device_stage(
        jnp.asarray(packed), 5, 0, 0, 12, False, False, True))
    for budget, extent in ((0, 0), (64 * 64, 64), (128 * 128, 128)):
        set_head(budget)
        assert dwt53.inv_schedule(512, 512, 5)[:2] == (extent, extent)
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
    """The head's extent, the grid passes and the route follow from the
    shape alone, before any launch."""
    head_w, head_h, head_rows, rows, final_w, final_h = \
        dwt53.inv_schedule(512, 512, 5)
    # levels 5 and 4 (32² and 64² windows) in the head, coarsest first
    assert (head_w, head_h) == (64, 64)
    assert head_rows == ((32, 64, 32, 1, 32, 1), (32, 1, 32, 64, 32, 1),
                         (64, 64, 64, 1, 32, 1), (64, 1, 64, 64, 32, 1))
    # levels 3, 2, 1 on the grid, each pass reading what the last wrote
    assert len(rows) == 6
    assert rows[0] == (128, 512, 128, 1, 16, 1, 64, 64)
    assert rows[1] == (128, 1, 128, 512, 8, 1, 128, 128)
    assert rows[-1] == (512, 1, 512, 512, 8, 1, 512, 512)
    assert (final_w, final_h) == (512, 512)
    assert _kernels.inv_stage_smem_bytes(dwt53.inv_schedule(512, 512, 5)) \
        == 64 * 64 * 4 + 32 * 65 * 4
    # the longest line the stage holds, then the long-line route
    for n in (58104, 58111):
        assert dwt53.inv_schedule(n, 3, 5)[3][-2][2] == n   # level-1 rows
        assert dwt53.inv_schedule(3, n, 5)[3][-1][2] == n   # its columns
    for n in (58112, 60001, 65535):
        assert dwt53.inv_schedule(n, 3, 5) is None
        assert dwt53.inv_schedule(3, n, 5) is None
    # no level to run; 1-sample windows at odd origins still run
    assert dwt53.inv_schedule(7, 5, 0) == (0, 0, (), (), 0, 0)
    assert dwt53.inv_schedule(1, 1, 2, 1, 1) == (
        1, 1, ((1, 1, 1, 1, 1, 0), (1, 1, 1, 1, 1, 0)), (), 1, 1)
    assert dwt53._inv_schedule(1, 1, 2, 1, 1, 0) == (
        0, 0, (), ((1, 1, 1, 1, 1, 0, 0, 0), (1, 1, 1, 1, 1, 0, 1, 1)), 1, 1)


def test_long_lines_take_the_per_pass_lane(monkeypatch, rng):
    """A frame with a side over 58111 samples runs the widening copy, the
    lifting passes (long-line route along that side) and the epilogue
    apart."""
    from test_torch_dwt53 import _route_model

    routes = []
    monkeypatch.setattr(_kernels, "dwt53_pass", _route_model(routes))

    def no_stage(*args, **kwargs):
        raise AssertionError("the fused stage cannot hold these lines")
    monkeypatch.setattr(_kernels, "j2k_inv_stage", no_stage)
    px = _frames(rng, (1, 1, 4, 60001), 12)
    packed = _packed(px, 12, False, False, 2, 0, 0).astype(np.int16)
    got = stage._inv_stage_kernel(torch.as_tensor(packed), 2, 0, 0, 12,
                                  False, False, "narrow")
    _eq(got.to(torch.int32).numpy(), px)
    assert routes.count("long") == 1


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
