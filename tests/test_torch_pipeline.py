"""Port parity: the device half of the J2K lossless pipeline.

Each device stage of the port is bit-exact against the JAX stage, and the
slice closes end to end through the JAX package's own host seams: the
port's coefficients go into J2KEncoder.encode(precomputed_tiles=...) and
must give the same codestream bytes as the reference encoder; the
reference's decode_to_packed followed by the port's decode stage must give
the source pixels back.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu import pipeline as ref
from go_dicom_codec_tpu.codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                                decode_to_packed)
from go_dicom_codec_torch import pipeline as port
from go_dicom_codec_torch.ops.dwt53 import fwd53_multilevel_
from go_dicom_codec_torch.ops.mct import dc_level_shift, rct_forward


def _frames(rng, shape, bits, signed=False):
    lo = -(1 << (bits - 1)) if signed else 0
    return rng.integers(lo, lo + (1 << bits), shape).astype(np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("shape,levels,bits,signed,cb", [
    ((2, 64, 64), 5, 12, False, 64), ((3, 61, 37), 3, 16, False, 16),
    ((2, 40, 24), 2, 12, True, 8), ((1, 33, 70), 6, 8, False, 32)])
def test_gray_encode_transform_bit_exact(shape, levels, bits, signed, cb,
                                         rng):
    x = _frames(rng, shape, bits, signed)
    got = port.j2k_lossless_encode_transform(torch.as_tensor(x), levels,
                                             bits, signed, cb)
    want = ref.j2k_lossless_encode_transform_jit(jnp.asarray(x), levels,
                                                 bits, signed, cb)
    for g, w in zip(got, want):
        _eq(g.numpy(), w)


@pytest.mark.parametrize("shape,levels,bits", [((2, 3, 64, 48), 5, 8),
                                               ((1, 3, 37, 29), 3, 12)])
def test_rgb_encode_transform_bit_exact(shape, levels, bits, rng):
    x = _frames(rng, shape, bits)
    got = port.j2k_rgb_lossless_encode_transform(torch.as_tensor(x), levels,
                                                 bits, cb=16)
    want = ref.j2k_rgb_lossless_encode_transform(jnp.asarray(x), levels,
                                                 bits, cb=16)
    for g, w in zip(got, want):
        _eq(g.numpy(), w)


# (rgb, bits, content bits): 16-bit content overflows int16 after the
# lifting gain, so the narrow stage's flag trips and fetch redoes in int32
@pytest.mark.parametrize("rgb,bits,content", [(False, 12, 12), (False, 16, 16),
                                              (True, 8, 8), (True, 16, 16)])
@pytest.mark.parametrize("narrow", [False, True])
def test_device_stage_and_fetch_bit_exact(rgb, bits, content, narrow, rng):
    shape = (2, 3, 40, 56) if rgb else (2, 48, 40)
    x = _frames(rng, shape, content)
    t = torch.as_tensor(x)
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
        assert got[0].dtype == torch.int16
        _eq(got[0].numpy(), want[0])
        assert int(got[1]) == int(want[1])
        assert (int(got[1]) > 32767) == (content == 16)
    else:
        _eq(got.numpy(), want)
    host = port.fetch_coeffs(got, t, bits, False, 4, rgb=rgb)
    assert host.dtype == np.int32
    _eq(host, wide)


@pytest.mark.parametrize("c,bits,signed,mct,origin", [
    (1, 12, False, False, (0, 0)), (3, 8, False, True, (0, 0)),
    (1, 16, True, False, (1, 1)), (4, 12, False, True, (1, 0))])
@pytest.mark.parametrize("narrow", [False, True])
def test_decode_stage_bit_exact(c, bits, signed, mct, origin, narrow, rng):
    px = _frames(rng, (2, c, 37, 45), bits, signed)
    x0, y0 = origin
    # real coefficients of px, then some out of range to exercise the clip
    s = dc_level_shift(torch.as_tensor(px), bits, signed)
    if mct:
        y, u, v = rct_forward(s[:, 0], s[:, 1], s[:, 2])
        s = torch.cat([torch.stack([y, u, v], 1), s[:, 3:]], 1)
    packed = fwd53_multilevel_(s.clone(), 3, x0, y0).numpy()
    packed[0, 0, 0, 0] += 1 << (bits + 2)
    got = port._j2k_decode_device_stage(torch.as_tensor(packed), 3, x0, y0,
                                        bits, signed, mct, narrow)
    want = ref._j2k_decode_device_stage(jnp.asarray(packed), 3, x0, y0, bits,
                                        signed, mct, narrow)
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _eq(got.to(torch.int32).numpy(), want.astype(np.int32))
    _eq(got.to(torch.int32).numpy()[1], px[1])


@pytest.mark.parametrize("rgb", [False, True])
def test_codestream_through_reference_seams(rgb, rng):
    """Port coefficients → reference T1/T2 → identical bytes; reference
    packed decode → port inverse stage → the source pixels."""
    h, w, bits = 64, 48, (8 if rgb else 12)
    comps = 3 if rgb else 1
    pixels = _frames(rng, (h, w, comps), bits)
    params = J2KEncodeParams(num_levels=5)
    levels = params.clamped_levels(w, h)
    chw = torch.as_tensor(np.ascontiguousarray(np.moveaxis(pixels, -1, 0)))
    if rgb:
        coeffs = port.j2k_rgb_lossless_encode_transform(chw[None], levels,
                                                        bits)[0][0]
    else:
        coeffs = port.j2k_lossless_encode_transform(chw, levels, bits)[0]
    stream = J2KEncoder(params).encode(pixels, w, h, comps, bits,
                                       precomputed_tiles=[coeffs.numpy()])
    assert stream == J2KEncoder(J2KEncodeParams(num_levels=5)).encode(
        pixels, w, h, comps, bits)

    packed, siz, cod = decode_to_packed(stream)
    assert siz.components[0][:2] == (bits, False)
    out = port._j2k_decode_device_stage(
        torch.as_tensor(np.asarray(packed))[None], cod.num_levels, 0, 0,
        bits, False, bool(cod.mct), narrow=True)
    _eq(out[0].to(torch.int32).numpy(), np.moveaxis(pixels, -1, 0))
