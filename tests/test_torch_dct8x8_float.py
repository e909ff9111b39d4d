"""Port parity: the float 8×8 IDCT and dequantization of ops/dct8x8.py
against go_dicom_codec_tpu/ops/dct8x8.py (``idct8x8``, ``dequantize``).

No codec path runs this float pair in either package. The IDCT is a float32
einsum: the two packages may sum in another order, so it is held within a
few ulp of the reference's result (rtol 4 ulp of float32 relative to the
largest coefficient of a block, the tolerance the reference allows
between its own lanes, parallel/mesh.py:456-465); the dequantization is one
float32 product of exact integers and must agree bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.ops import dct8x8 as ref
from go_dicom_codec_torch.ops import dct8x8 as port

ULP = np.finfo(np.float32).eps


@pytest.mark.parametrize("shape", [(8, 8), (32, 8, 8), (2, 3, 4, 8, 8)])
def test_idct8x8_matches_reference(shape, rng):
    f = (rng.standard_normal(shape) * 200).astype(np.float32)
    got = port.idct8x8(torch.as_tensor(f)).numpy()
    want = np.asarray(ref.idct8x8(jnp.asarray(f)))
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True) + 1.0
    assert np.all(np.abs(got - want) <= 4 * ULP * scale)


@pytest.mark.parametrize("quality", [1, 50, 90, 100])
def test_dequantize_matches_reference_exactly(quality, rng):
    q = port.scale_quant_table(port.LUMA_QUANT, quality, 255)
    zz = rng.integers(-2048, 2048, (5, 8, 8)).astype(np.int32)
    got = port.dequantize(torch.as_tensor(zz), torch.as_tensor(q)).numpy()
    want = np.asarray(ref.dequantize(jnp.asarray(zz), jnp.asarray(q)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_dct_idct_roundtrip(rng):
    """The reference's round trip (tests/test_jpeg_baseline.py:41-45) on
    the port."""
    x = rng.integers(-128, 128, size=(32, 8, 8)).astype(np.float32)
    back = port.idct8x8(port.fdct8x8(torch.as_tensor(x))).numpy()
    np.testing.assert_allclose(back, x, atol=1e-3)


def test_quantize_dequantize_idct_roundtrip(rng):
    """quantize → dequantize → idct8x8 at quality 100 (a table of ones)
    lands within half a coefficient step of the samples."""
    x = rng.integers(-128, 128, size=(16, 8, 8)).astype(np.float32)
    q = torch.ones(64, dtype=torch.float32)
    coeffs = port.quantize(port.fdct8x8(torch.as_tensor(x)), q)
    back = port.idct8x8(port.dequantize(coeffs, q)).numpy()
    want = np.asarray(ref.idct8x8(ref.dequantize(
        ref.quantize(ref.fdct8x8(jnp.asarray(x)), jnp.asarray(q.numpy())),
        jnp.asarray(q.numpy()))))
    np.testing.assert_allclose(back, want, atol=1e-3)
    assert np.abs(back - x).max() <= 4.0
