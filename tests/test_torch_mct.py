"""Port parity: DC level shift and RCT, bit-exact against the JAX package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.ops import mct as ref
from go_dicom_codec_torch.ops import mct as port


@pytest.mark.parametrize("bits,signed", [(8, False), (12, False),
                                         (16, False), (12, True)])
def test_dc_level_shift_bit_exact(bits, signed, rng):
    lo = -(1 << (bits - 1)) if signed else 0
    x = rng.integers(lo, lo + (1 << bits), (3, 17, 29)).astype(np.int32)
    got = port.dc_level_shift(torch.as_tensor(x), bits, signed)
    want = np.asarray(ref.dc_level_shift(jnp.asarray(x), bits, signed))
    np.testing.assert_array_equal(got.numpy(), want)
    back = port.inv_dc_level_shift(got, bits, signed)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref.inv_dc_level_shift(jnp.asarray(want),
                                                        bits, signed)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("bits", [8, 12, 16])
def test_rct_bit_exact(bits, rng):
    # centered samples, so (R + 2G + B) and (U + V) are often negative and
    # the floor of >> is exercised
    rgb = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1),
                       (3, 2, 19, 23)).astype(np.int32)
    got = port.rct_forward(*(torch.as_tensor(c) for c in rgb))
    want = ref.rct_forward(*(jnp.asarray(c) for c in rgb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = port.rct_inverse(*got)
    want_back = ref.rct_inverse(*want)
    for b, w, c in zip(back, want_back, rgb):
        np.testing.assert_array_equal(b.numpy(), np.asarray(w))
        np.testing.assert_array_equal(b.numpy(), c)


def test_arithmetic_shift_floors_negatives():
    x = torch.tensor([-5, -4, -1, 0, 1, 5], dtype=torch.int32)
    np.testing.assert_array_equal((x >> 1).numpy(),
                                  np.asarray(jnp.asarray(x.numpy()) >> 1))


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


# ICT and the Part-2 matrices against the reference's functions as the
# codec calls them (ICT op by op, the matrices through XLA's dot): found
# exact, 0 ulp. The matrix product matches because the port computes
# XLA's CPU FMA chain (see ops/mct.py:_mix).
@pytest.mark.parametrize("fn", ["ict_forward", "ict_forward_int",
                                "ict_forward_np"])
def test_ict_forward_exact(fn, rng):
    rgb = rng.integers(-2048, 2048, (3, 2, 31, 27)).astype(np.int32)
    want = getattr(ref, fn)(*(jnp.asarray(c) for c in rgb))
    args = rgb if fn.endswith("_np") else [torch.as_tensor(c) for c in rgb]
    got = getattr(port, fn)(*args)
    for g, w in zip(got, want):
        g = g if isinstance(g, np.ndarray) else g.numpy()
        assert g.dtype == np.asarray(w).dtype
        assert _ulps(g.astype(np.float32), np.asarray(w, np.float32)) == 0


@pytest.mark.parametrize("fn", ["ict_inverse", "ict_inverse_int",
                                "ict_inverse_np"])
def test_ict_inverse_exact(fn, rng):
    ycc = rng.uniform(-2048, 2048, (3, 2, 31, 27)).astype(np.float32)
    want = getattr(ref, fn)(*(jnp.asarray(c) for c in ycc))
    args = ycc if fn.endswith("_np") else [torch.as_tensor(c) for c in ycc]
    got = getattr(port, fn)(*args)
    for g, w in zip(got, want):
        g = g if isinstance(g, np.ndarray) else g.numpy()
        assert g.dtype == np.asarray(w).dtype
        assert _ulps(g.astype(np.float32), np.asarray(w, np.float32)) == 0


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("offsets", [False, True])
def test_matrix_transforms_exact(n, offsets, rng):
    m = rng.uniform(-1, 1, (n, n)).astype(np.float32)
    comps = rng.integers(0, 4096, (n, 2, 23, 19)).astype(np.int32)
    off = rng.uniform(-100, 100, n).astype(np.float32) if offsets else None
    t = (lambda a: None if a is None else torch.as_tensor(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    for fn in ("mct_matrix_forward", "mct_matrix_inverse"):
        want = getattr(ref, fn)(j(comps), j(m), j(off))
        got = getattr(port, fn)(t(comps), t(m), t(off))
        assert got.dtype == torch.float32
        assert _ulps(got.numpy(), want) == 0


@pytest.mark.parametrize("bits,signed", [(8, False), (12, True)])
def test_numpy_mirrors_match_torch(bits, signed, rng):
    x = rng.integers(-(1 << 11), 1 << 11, (3, 19, 23)).astype(np.int32)
    t = torch.as_tensor(x)
    np.testing.assert_array_equal(port.dc_level_shift_np(x, bits, signed),
                                  port.dc_level_shift(t, bits, signed))
    np.testing.assert_array_equal(
        port.inv_dc_level_shift_np(x, bits, signed),
        port.inv_dc_level_shift(t, bits, signed))
    for np_fn, t_fn in ((port.rct_forward_np, port.rct_forward),
                        (port.rct_inverse_np, port.rct_inverse)):
        for g, w in zip(np_fn(*x), t_fn(*t)):
            np.testing.assert_array_equal(g, w.numpy())


def test_matrix_step_rounds_once_at_a_float32_tie():
    """acc + a·b lies just above a float32 halfway point, so close that
    its float64 sum lands on the halfway point itself: two roundings
    would give the even neighbour below, one fused multiply-add (XLA's
    CPU dot) the one above."""
    a, b, acc = 1.0000168085098267, 1.326241135597229, 512.0000610351562
    m = np.array([[1.0, a]], np.float32)
    x = np.array([[acc], [b]], np.float32)
    assert np.float32(np.float64(a) * b + acc) == np.float32(513.3262939453125)
    want = ref.mct_matrix_forward(jnp.asarray(x), jnp.asarray(m))
    got = port.mct_matrix_forward(torch.as_tensor(x), torch.as_tensor(m))
    assert float(got[0, 0]) == float(want[0, 0]) == 513.3263549804688
