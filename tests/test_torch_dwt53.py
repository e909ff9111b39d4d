"""Port parity: reversible 5/3 DWT, bit-exact against the JAX package.

Covers the shape, parity, origin and level matrix of tests/test_dwt53.py
and tests/test_wavelet_sizes.py, the geometry helpers the port copies,
and the kernel lane's host side: its passes run here through a numpy
model of csrc/dwt53.cu (interleaved lifting with symmetric extension, the
packed index map), fed the same line/stride arguments as the kernel.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.ops import dwt53 as ref
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch.ops import dwt53 as port


def _jax_fwd(x, levels, x0=0, y0=0):
    # the jit wrapper compiles one program per shape, several times faster
    # here than the op-by-op eager call of the same function
    return np.asarray(ref.fwd53_multilevel_jit(jnp.asarray(x), levels, x0,
                                               y0))


def _check_multilevel(x, levels, x0=0, y0=0):
    """Forward bit-exact against JAX; the inverse must give x back, which
    is what the JAX inverse gives (pinned by the reference's own tests)."""
    t = torch.as_tensor(x)
    got = port.fwd53_multilevel_(t.clone(), levels, x0, y0)
    np.testing.assert_array_equal(got.numpy(), _jax_fwd(x, levels, x0, y0))
    back = port.inv53_multilevel_(got, levels, x0, y0)
    np.testing.assert_array_equal(back.numpy(), x)


def test_geometry_helpers_match_reference():
    for w, h, x0, y0 in itertools.product(range(0, 12), range(0, 12),
                                          range(4), range(4)):
        assert port.next_window(w, h, x0, y0) == ref.next_window(w, h, x0, y0)
        for levels in range(0, 7):
            assert (port.ll_dimensions(w, h, levels, x0, y0)
                    == ref.ll_dimensions(w, h, levels, x0, y0))
            assert (port._level_windows(w, h, levels, x0, y0)
                    == ref._level_windows(w, h, levels, x0, y0))
    for n in range(0, 9):
        for even in (True, False):
            assert port.low_len(n, even) == ref.low_len(n, even)


WIDTHS = [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 31, 64, 127, 128]


@pytest.mark.parametrize("even", [True, False])
@pytest.mark.parametrize("w", WIDTHS)
def test_1d_bit_exact(w, even, rng):
    x = rng.integers(-(1 << 14), 1 << 14, (3, w)).astype(np.int32)
    got = port.fwd53_1d(torch.as_tensor(x), even)
    want = np.asarray(ref.fwd53_1d(jnp.asarray(x), even))
    np.testing.assert_array_equal(got.numpy(), want)
    back = port.inv53_1d(got, even)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref.inv53_1d(jnp.asarray(want), even)))
    np.testing.assert_array_equal(back.numpy(), x)


SHAPES_2D = [(1, 1), (1, 8), (8, 1), (2, 2), (3, 5), (5, 3), (8, 8), (9, 7),
             (16, 16), (17, 31), (64, 64), (33, 129)]


@pytest.mark.parametrize("even_row", [True, False])
@pytest.mark.parametrize("even_col", [True, False])
@pytest.mark.parametrize("shape", SHAPES_2D)
def test_2d_bit_exact(shape, even_row, even_col, rng):
    x = rng.integers(-(1 << 12), 1 << 12, shape).astype(np.int32)
    got = port.fwd53_2d(torch.as_tensor(x), even_row, even_col)
    want = np.asarray(ref.fwd53_2d(jnp.asarray(x), even_row, even_col))
    np.testing.assert_array_equal(got.numpy(), want)
    back = port.inv53_2d(got, even_row, even_col)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("levels", [1, 2, 3, 5])
@pytest.mark.parametrize("shape,origin", [((64, 64), (0, 0)),
                                          ((60, 52), (3, 1)),
                                          ((127, 129), (0, 0)),
                                          ((33, 20), (5, 7))])
def test_multilevel_bit_exact(shape, origin, levels, rng):
    x = rng.integers(-(1 << 12), 1 << 12, (2,) + shape).astype(np.int32)
    _check_multilevel(x, levels, *origin)


def _gradient(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return ((x + y) % 256).astype(np.int32)


@pytest.mark.parametrize("size", [192, 256])
@pytest.mark.parametrize("levels", [1, 3, 5])
def test_large_square_bit_exact(size, levels):
    _check_multilevel(_gradient(size, size), levels)


@pytest.mark.parametrize("shape", [(256, 192), (192, 256), (255, 255),
                                   (257, 255), (253, 1), (1, 253),
                                   (129, 127), (96, 33)])
def test_odd_rect_bit_exact(shape, rng):
    data = rng.integers(-2048, 2048, shape).astype(np.int32)
    for levels in ((1, 2, 5) if shape == (129, 127) else (5,)):
        _check_multilevel(data, levels)


@pytest.mark.parametrize("origin", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_256_odd_origin_bit_exact(origin, rng):
    data = rng.integers(-1 << 14, 1 << 14, (256, 256)).astype(np.int32)
    _check_multilevel(data, 4, *origin)


@pytest.mark.parametrize("case", ["deep", "extreme", "batch"])
def test_special_inputs_bit_exact(case, rng):
    if case == "deep":      # more levels than the image supports
        _check_multilevel(rng.integers(-100, 100, (16, 16)).astype(np.int32),
                          10)
    elif case == "extreme":  # 16-bit extremes through 5 levels
        data = np.full((64, 64), 32767, dtype=np.int32)
        data[::2, ::2] = -32768
        _check_multilevel(data, 5)
    else:
        _check_multilevel(
            rng.integers(-4096, 4096, (6, 96, 64)).astype(np.int32), 3)


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 7, 8])
def test_tiny_sizes_bit_exact(size, rng):
    data = rng.integers(-500, 500, (size, size)).astype(np.int32)
    for levels in (1, 2):
        _check_multilevel(data, levels)


# ---- kernel lane, host side -------------------------------------------------

def _mirror(q, n):
    return np.where(q < 0, -q, np.where(q >= n, 2 * (n - 1) - q, q))


def _pass_model(x3, n_lines, line_stride, n, elem_stride, lpb, even,
                inverse):
    """numpy model of one csrc/dwt53.cu launch, with its arguments."""
    assert lpb >= 1
    assert _kernels.dwt53_smem_bytes(lpb, n) <= _kernels.SMEM_MAX_BYTES
    flat = x3.reshape(x3.shape[0], -1)
    j = np.arange(n_lines)[:, None]
    i = np.arange(n)[None, :]
    addr = torch.as_tensor(j * line_stride + i * elem_stride)  # [lines, n]
    lo0 = 0 if even else 1
    sn = (n + 1 - lo0) // 2
    packed_pos = np.where(i < sn, 2 * i + lo0, 2 * (i - sn) + 1 - lo0)[0]
    lines = flat[:, addr].numpy().astype(np.int64)  # [B, lines, n]
    buf = np.empty_like(lines)
    if inverse:
        buf[..., packed_pos] = lines
    else:
        buf = lines
    if n == 1:
        if not even:
            buf = buf >> 1 if inverse else buf * 2
    else:
        def lift(first, rnd, shift, sign):
            p = np.arange(first, n, 2)
            t = (buf[..., _mirror(p - 1, n)] + buf[..., _mirror(p + 1, n)]
                 + rnd) >> shift
            buf[..., p] += sign * t
        steps = [(1 - lo0, 0, 1, -1), (lo0, 2, 2, 1)]
        for first, rnd, shift, sign in (steps[::-1] if inverse else steps):
            lift(first, rnd, shift, -sign if inverse else sign)
    out = buf if inverse else buf[..., packed_pos]
    flat[:, addr] = torch.as_tensor(out.astype(np.int32))


@pytest.mark.parametrize("shape,origin,levels", [
    ((3, 61, 37), o, lv) for o in [(0, 0), (1, 0), (0, 1), (1, 1)]
    for lv in (1, 3, 6)] + [((2, h, w), (1, 1), 2)
                            for h, w in [(1, 1), (1, 5), (6, 1), (2, 7)]])
def test_kernel_lane_model_bit_exact(shape, origin, levels, monkeypatch,
                                     rng):
    monkeypatch.setattr(_kernels, "dwt53_pass", _pass_model)
    x = rng.integers(-4096, 4096, shape).astype(np.int32)
    t = torch.as_tensor(x)
    got = port._multilevel_(t.clone(), levels, *origin,
                            port._fwd_level_kernel_, inverse=False)
    np.testing.assert_array_equal(got.numpy(), _jax_fwd(x, levels, *origin))
    back = port._multilevel_(got, levels, *origin, port._inv_level_kernel_,
                             inverse=True)
    np.testing.assert_array_equal(back.numpy(), x)


def test_lanes_by_device():
    x = torch.zeros((2, 8, 8), dtype=torch.int32)
    assert port.fwd53_multilevel_(x, 2) is x        # CPU: plain, in place
    with pytest.raises(ValueError, match="no lane"):
        port.fwd53_multilevel_(torch.zeros((8, 8), dtype=torch.int32,
                                           device="meta"), 1)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.dwt53_pass(x, 8, 8, 8, 1, 1, True, False)
    # a line longer than shared memory holds (DICOM allows 65535 columns)
    long = torch.zeros((1, 1, 60000), dtype=torch.int32)
    with pytest.raises(_kernels.KernelLaunchError, match="shared memory"):
        _kernels.dwt53_pass(long, 1, 60000, 60000, 1, 1, True, False)
