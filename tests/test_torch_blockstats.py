"""Port parity: code-block stats, bit-exact against the JAX package,
including ragged grids and all-zero blocks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.ops import blockstats as ref
from go_dicom_codec_torch.ops import blockstats as port


@pytest.mark.parametrize("shape,cb", [((2, 128, 128), 64), ((3, 70, 100), 64),
                                      ((33, 17), 8), ((1, 5, 7), 4),
                                      ((2, 3, 64, 64), 32)])
def test_codeblock_stats_bit_exact(shape, cb, rng):
    x = rng.integers(-(1 << 14), 1 << 14, shape).astype(np.int32)
    # an all-zero first block and an all-zero (ragged) last block
    h, w = shape[-2:]
    x[..., :cb, :cb] = 0
    x[..., -(h % cb or cb):, -(w % cb or cb):] = 0
    m, bits = port.codeblock_stats(torch.as_tensor(x), cb, cb)
    m_ref = ref.codeblock_max_abs(jnp.asarray(x), cb, cb)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(ref.max_bitplane(m_ref)))
    assert int(bits[..., 0, 0].max()) == 0
    assert int(bits[..., -1, -1].max()) == 0


@pytest.mark.parametrize("shape,mult", [((5, 7), (4, 4)), ((2, 8, 8), (8, 8)),
                                        ((3, 9, 1), (2, 16))])
def test_pad_to_multiple_bit_exact(shape, mult, rng):
    x = rng.integers(-100, 100, shape).astype(np.int32)
    got = port.pad_to_multiple(torch.as_tensor(x), *mult)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.pad_to_multiple(jnp.asarray(x), *mult)))


def test_max_bitplane_edges():
    v = np.array([0, 1, 2, 3, 4, 7, 8, 255, 256, 4095, 4096, 1 << 16,
                  (1 << 30) + 1, (1 << 31) - 1, -(1 << 31)], dtype=np.int32)
    got = port.max_bitplane(torch.as_tensor(v))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.max_bitplane(jnp.asarray(v))))
    assert got.dtype == torch.int32
