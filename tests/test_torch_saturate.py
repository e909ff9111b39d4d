"""Port parity: float → int32 conversions saturate as the JAX package's do.

``jnp.round(v).astype(jnp.int32)`` turns NaN into 0 and clamps values out
of the int32 range; ``torch.round(v).to(torch.int32)`` on a CPU tensor
gives INT32_MIN for all of them. The port converts through
``ops/convert.py`` at every site where the reference casts a float to
int32 on the device. Each site is held bit-exact against its reference
counterpart on NaN, ±inf and out-of-range values.
"""

import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from go_dicom_codec_tpu import pipeline as ref_pipeline
from go_dicom_codec_tpu.codecs import jpeg2000 as ref_j2k
from go_dicom_codec_tpu.codecs import jpeg_common as jc
from go_dicom_codec_tpu.ops import dct8x8 as ref_dct
from go_dicom_codec_tpu.ops import mct as ref_mct
from go_dicom_codec_tpu.ops.pallas_dct import fdct8x8_quant_pallas
from go_dicom_codec_torch import pipeline as port_pipeline
from go_dicom_codec_torch.codecs import jpeg2000 as port_j2k
from go_dicom_codec_torch.codecs.mct_builder import MCTBinding
from go_dicom_codec_torch.codestream import j2k
from go_dicom_codec_torch.ops import dct8x8 as port_dct
from go_dicom_codec_torch.ops import mct as port_mct
from go_dicom_codec_torch.ops.convert import (round_to_int32_sat,
                                              saturate_int32)
from go_dicom_codec_torch.ops.fdct8x8_quant import fdct8x8_quant

INT32_MAX, INT32_MIN = 2147483647, -2147483648
# out of range both ways, NaN, ±inf, the largest float32 below 2^31, 2^31
# itself (float32(INT32_MAX)), -2^31, and ties that round half to even
VALUES = (3e9, -3e9, math.nan, math.inf, -math.inf, 2147483520.0, 2.0 ** 31,
          -2.0 ** 31, 2.5, -2.5, 0.5)


def _f32(values) -> np.ndarray:
    return np.asarray(values, dtype=np.float32)


def _jnp_rint32(v):
    return jnp.round(v).astype(jnp.int32)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("value", VALUES)
def test_helper_matches_jnp(value, jit):
    v = _f32([value])
    fn = jax.jit(_jnp_rint32) if jit else _jnp_rint32
    want = np.asarray(fn(jnp.asarray(v)))
    got = round_to_int32_sat(torch.as_tensor(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_helper_float64_and_saturate():
    """float64 holds 2^31 - 1 exactly: its clamp is not float32's."""
    v = torch.tensor([2147483646.6, 2147483647.0, 2.0 ** 31, -2.0 ** 31 - 1,
                      math.nan, -0.5], dtype=torch.float64)
    assert round_to_int32_sat(v).tolist() == [INT32_MAX, INT32_MAX, INT32_MAX,
                                              INT32_MIN, 0, 0]
    whole = torch.tensor([1e20, -1e20, 7.0, -8.0, math.nan])
    assert saturate_int32(whole).tolist() == [INT32_MAX, INT32_MIN, 7, -8, 0]


def _planted(c: int) -> np.ndarray:
    """[1, C, 2, 6] float32 coefficients: VALUES in plane 0, the last
    sample ordinary. With three planes the chroma planes are 0 under
    VALUES (so the inverse ICT passes them on exactly: the jitted
    reference fuses its products into FMAs, which round large finite sums
    differently) and carry ±inf at the last sample."""
    f = np.full((1, c, 2, 6), 1234.25, np.float32)
    flat = f.reshape(c, -1)
    flat[0, :len(VALUES)] = VALUES
    if c > 1:
        flat[1:, :len(VALUES)] = 0.0
        flat[1:, -1] = (math.inf, -math.inf)
    return f


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("mct", [False, True])
def test_decode_stage_97_saturates(narrow, signed, mct):
    fbatch = _planted(3 if mct else 1)
    args = (0, 0, 0, 12, signed, mct, narrow)
    want = np.asarray(ref_pipeline._j2k_decode_device_stage_97(
        jnp.asarray(fbatch), *args))
    got = port_pipeline._j2k_decode_device_stage_97(torch.as_tensor(fbatch),
                                                    *args).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["ict_forward_int", "ict_inverse_int"])
def test_ict_int_saturates(fn):
    rng = np.random.default_rng(7)
    planes = rng.uniform(-300, 300, (3, 4, 11)).astype(np.float32)
    for i, v in enumerate(VALUES):
        planes[i % 3, i % 4, i] = v
    want = getattr(ref_mct, fn)(*(jnp.asarray(p) for p in planes))
    got = getattr(port_mct, fn)(*(torch.as_tensor(p) for p in planes))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("values", [(3e10, -3e10, math.nan, math.inf),
                                    VALUES], ids=["beyond_int32", "values"])
def test_quantize_saturates(values):
    c = np.zeros((2, 8, 8), np.float32)
    c.reshape(-1)[:len(values)] = values
    c.reshape(-1)[64:64 + len(values)] = [-v for v in values]
    q = np.ones(64, np.float32)
    want = np.asarray(ref_dct.quantize(jnp.asarray(c), jnp.asarray(q)))
    got = port_dct.quantize(torch.as_tensor(c), torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [50, 90])
@pytest.mark.parametrize("sample", [INT32_MAX, INT32_MIN])
def test_fdct8x8_quant_saturates(sample, quality):
    """Planes of INT32_MAX and INT32_MIN samples: the plain version equals
    the Pallas kernel in interpret mode bit for bit, DC saturated at
    quality 90."""
    x = np.full((2, 16, 128), sample, np.int32)
    q = jc.scale_quant_table(jc.LUMA_QUANT, quality, 255)
    want = np.asarray(fdct8x8_quant_pallas(jnp.asarray(x), jnp.asarray(q),
                                           level_shift=2048, interpret=True))
    got = fdct8x8_quant(torch.as_tensor(x), q, 2048).numpy()
    np.testing.assert_array_equal(got, want)
    if quality == 90:   # DC / 3 is past the int32 range
        assert (got[:, ::8, ::8] == sample).all()


def _tile_coeffs(module, params, device_kw):
    """One lossless tile of 8-bit RGB through ``_tile_coeffs_device``."""
    tile = np.random.default_rng(3).integers(0, 256, (8, 12, 3))
    enc = module.J2KEncoder(params, **device_kw)
    cod = j2k.CodInfo(num_levels=2, transform=1)
    return enc._tile_coeffs_device(tile, (0, 0, 12, 8), cod, j2k.QcdInfo(),
                                   8, False, False, 3)


@pytest.mark.parametrize("site", ["mct_matrix", "mct_bindings"])
def test_encode_matrix_sites_saturate(site):
    """``codecs/jpeg2000.py`` ``_tile_coeffs_device`` (the two lossless
    Part-2 sites), by a direct call: a matrix that sends component 0 to
    +inf and component 1 below -2^31 rounds them to INT32_MAX and
    INT32_MIN, as the reference does, before the 5/3."""
    m = [[1e38, 0.0, 0.0], [0.0, -1e9, 0.0], [0.0, 0.0, 1.0]]
    kw = ({"mct_matrix": m} if site == "mct_matrix" else
          {"mct_bindings": [MCTBinding(component_ids=[0, 1, 2], matrix=m)]})
    want = _tile_coeffs(ref_j2k, ref_j2k.J2KEncodeParams(**kw), {})
    got = _tile_coeffs(port_j2k, port_j2k.J2KEncodeParams(**kw),
                       {"device": torch.device("cpu")})
    np.testing.assert_array_equal(got, want)


def test_decode_sites_use_the_helper():
    """``codecs/jpeg2000.py`` ``J2KDecoder._decode_tile`` (the reference's
    three decode sites: Part-2 inverse of the 5/3, the 9/7 of a
    homogeneous tile, the per-component 9/7), by reading its source: a
    direct call needs a codestream whose coefficients dequantize out of
    range, which no encoder writes. The two Part-2 inverses (the 5/3's
    and the 9/7's) round through ``round_to_int32_sat``, the helper held
    against jnp above; the other two 9/7 sites round inside the 9/7
    decode stage's "pixels" epilogue (the same helper in its plain
    version, __float2int_rn in its kernel: tests/test_torch_j2k97_inv_
    stage.py holds both against jnp on these inputs); none casts with
    torch."""
    src = inspect.getsource(port_j2k.J2KDecoder._decode_tile)
    assert src.count("round_to_int32_sat(") == 2
    assert src.count("inv97_stage(") == 3
    assert src.count('epilogue="pixels")') == 2
    assert "torch.round" not in src and ".to(torch.int32)" not in src
    ref_src = inspect.getsource(ref_j2k.J2KDecoder._decode_tile)
    assert ref_src.count("jnp.round(") == 3
