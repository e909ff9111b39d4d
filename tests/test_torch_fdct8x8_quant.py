"""Port parity: the fused 8×8 DCT + quant (counterpart of the Pallas kernel).

The port's plain version is held against the Pallas kernel in interpret
mode and against the reference einsum path, at the tolerance of
tests/test_pallas_dct.py: float summation order can flip the round-half
boundary on a handful of coefficients, so |Δ| ≤ 1 on < 0.5 % of them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.codecs import jpeg_common as jc
from go_dicom_codec_tpu.ops import dct8x8 as ref
from go_dicom_codec_tpu.ops.pallas_dct import encode_plane_blocks_pallas
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch.ops import dct8x8 as port
from go_dicom_codec_torch.ops.fdct8x8_quant import (encode_plane_blocks,
                                                    fdct8x8_quant)


def _assert_close(got, want):
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 1
    assert (d != 0).mean() < 0.005


@pytest.mark.parametrize("shape", [(64, 128), (64, 136), (33, 17), (8, 8)])
@pytest.mark.parametrize("quality", [50, 90])
def test_port_matches_pallas_and_einsum(shape, quality, rng):
    h, w = shape
    img = rng.integers(0, 4096, (h, w)).astype(np.int32)
    q = jc.scale_quant_table(jc.LUMA_QUANT, quality, 255)

    got = encode_plane_blocks(torch.as_tensor(img), q, level_shift=2048)
    assert got.dtype == torch.int32
    got = got.numpy()
    pallas = encode_plane_blocks_pallas(img, q, level_shift=2048,
                                        interpret=True)
    p = np.asarray(ref.pad_replicate_to_8(jnp.asarray(img))
                   ).astype(np.float32) - 2048
    einsum = np.asarray(ref.quantize(ref.fdct8x8(ref.to_blocks(
        jnp.asarray(p))), jnp.asarray(q)))
    assert got.shape == einsum.shape == pallas.shape
    _assert_close(got, pallas)
    _assert_close(got, einsum)


def test_batched_raster_layout_matches_blocks(rng):
    x = rng.integers(0, 4096, (3, 16, 24)).astype(np.int32)
    q = port.scale_quant_table(port.LUMA_QUANT, 75, 255)
    out = fdct8x8_quant(torch.as_tensor(x), q, level_shift=2048).numpy()
    for b in range(3):
        blocks = encode_plane_blocks(torch.as_tensor(x[b]), q, 2048).numpy()
        np.testing.assert_array_equal(
            out[b].reshape(2, 8, 3, 8).transpose(0, 2, 1, 3), blocks)


@pytest.mark.parametrize("shape", [(8, 8), (13, 21), (16, 24)])
def test_helpers_bit_exact(shape, rng):
    x = rng.integers(-1000, 1000, shape).astype(np.int32)
    padded = port.pad_replicate_to_8(torch.as_tensor(x))
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(ref.pad_replicate_to_8(jnp.asarray(x))))
    blocks = port.to_blocks(padded)
    np.testing.assert_array_equal(
        blocks.numpy(), np.asarray(ref.to_blocks(jnp.asarray(padded))))
    np.testing.assert_array_equal(port.from_blocks(blocks).numpy(),
                                  padded.numpy())
    c = rng.normal(0, 300, (5, 8, 8)).astype(np.float32)
    c[0, 0, :4] = [16.0, -16.0, 8.0, -8.0]  # exact half-way cases
    q = torch.full((64,), 32.0)
    np.testing.assert_array_equal(
        port.quantize(torch.as_tensor(c), q).numpy(),
        np.asarray(ref.quantize(jnp.asarray(c), jnp.asarray(q.numpy()))))


def test_constants_match_reference():
    np.testing.assert_array_equal(port._D_np, ref._D_np)
    assert port._D_np.dtype == ref._D_np.dtype
    np.testing.assert_array_equal(port.LUMA_QUANT, jc.LUMA_QUANT)
    for quality in range(1, 101):
        np.testing.assert_array_equal(
            port.scale_quant_table(port.LUMA_QUANT, quality, 255),
            jc.scale_quant_table(jc.LUMA_QUANT, quality, 255))
    d, q = port.tables_from_numpy(ref._D_np, jc.LUMA_QUANT)
    assert d.dtype == q.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), ref._D_np)
    np.testing.assert_array_equal(q.numpy(), jc.LUMA_QUANT.reshape(64))


def test_kernel_wrapper_rejects_cpu_tensors():
    x = torch.zeros((1, 8, 8), dtype=torch.int32)
    d, q = port.tables_from_numpy(port._D_np, port.LUMA_QUANT)
    with pytest.raises(_kernels.KernelLaunchError, match="CUDA tensor"):
        _kernels.fdct8x8_quant(x, torch.empty_like(x), d.reshape(64), q, 128)
    with pytest.raises(ValueError, match="no lane"):
        fdct8x8_quant(x.to("meta"), q, 128)
