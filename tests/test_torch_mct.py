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
