"""Port parity: the fused J2K forward stage, bit-exact against the JAX
package.

A numpy model of one csrc/j2k_fwd_stage.cu launch stands in for the kernel
here: it takes the launch's arguments (the pass table and the epilogue's
outputs), widens and shifts the input, runs every pass of the table through
the model of the shared-memory lifting body, and computes the epilogue as
the kernel does (a partial code-block's max starts at its padding's zero, a
full one's at INT_MIN). Through it the kernel lane of the stage, of the
pipelines' stages and of the encode transforms is held against
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
from go_dicom_codec_torch.ops import j2k_fwd_stage as stage
from test_torch_dwt53 import KERNEL_LANE_CASES, _pass_model

INT_MIN = np.iinfo(np.int32).min


def _stage_model(launches):
    """A stand-in for _kernels.j2k_fwd_stage; each launch's epilogue is
    appended to ``launches``."""
    def launch(src, coef, schedule, shift, epilogue, cb=0, narrow=None,
               maxabs=None, cb_max=None, cb_bits=None):
        assert src.dtype in _kernels.FWD_STAGE_DTYPES
        assert coef.dtype == torch.int32 and coef.shape == src.shape
        assert len(schedule) <= _kernels.STAGE_MAX_PASSES
        launches.append(epilogue)
        # pass 0 reads the input in its own type, widened, less the shift
        coef.copy_(torch.as_tensor(
            (src.numpy().astype(np.int64) - shift).astype(np.int32)))
        for n_lines, line_stride, n, elem_stride, lpb, even in schedule:
            _pass_model(coef, n_lines, line_stride, n, elem_stride, lpb,
                        bool(even), inverse=False)
        c = coef.numpy()
        a = np.abs(c)                    # int32: |INT_MIN| stays INT_MIN
        if epilogue == "narrow":
            narrow.copy_(torch.as_tensor(c.astype(np.int16)))
            maxabs.fill_(int(a.max(initial=INT_MIN)))
        elif epilogue == "stats":
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


@pytest.fixture
def kernel_lane(monkeypatch):
    """The stage's kernel lane on CPU tensors, through the model; the
    per-pass kernels must not launch. Yields the launches."""
    launches = []
    monkeypatch.setattr(_kernels, "j2k_fwd_stage", _stage_model(launches))
    monkeypatch.setattr(port, "fwd_stage", stage._fwd_stage_kernel)

    def no_pass(*args):
        raise AssertionError("a lifting pass launched beside the stage")
    monkeypatch.setattr(_kernels, "dwt53_pass", no_pass)
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
def test_rgb_encode_transform_bit_exact(shape, levels, bits, kernel_lane,
                                        rng):
    x = _frames(rng, shape, bits)
    got = port.j2k_rgb_lossless_encode_transform(torch.as_tensor(x), levels,
                                                 bits, cb=16)
    want = ref.j2k_rgb_lossless_encode_transform(jnp.asarray(x), levels,
                                                 bits, cb=16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _eq(g.numpy(), w)
    assert kernel_lane == ["stats"]


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
def test_stage_model_odd_matrix_bit_exact(shape, origin, levels,
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
    """uint16 (65535 exact), int16 and int32 are read as they are; other
    types (uint8, int8, int64) are cast to int32 first, as the reference's
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


def test_long_lines_take_the_per_pass_lane(monkeypatch, rng):
    """A frame with a side over 58111 samples runs the shift, the lifting
    passes (long-line route along that side) and the epilogue apart."""
    from test_torch_dwt53 import _route_model

    routes = []
    monkeypatch.setattr(_kernels, "dwt53_pass", _route_model(routes))

    def no_stage(*args, **kwargs):
        raise AssertionError("the fused stage cannot hold these lines")
    monkeypatch.setattr(_kernels, "j2k_fwd_stage", no_stage)
    x = rng.integers(0, 1 << 12, (1, 4, 60001)).astype(np.uint16)
    got = stage._fwd_stage_kernel(torch.as_tensor(x), 2048, 2, 0, 0,
                                  "narrow", 64)
    want = ref._pipeline_device_stage(jnp.asarray(x), 12, False, 2, True)
    _eq(got[0].numpy(), want[0])
    assert int(got[1]) == int(want[1])
    assert routes.count("long") == 1


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
