"""Port parity: the hand-packed streams of ``testdata.py`` through the port's
decoder.

``go_dicom_codec_torch/testdata.py`` is a copy of the reference's
(sha-pinned in test_torch_host_copies.py); its generators pack J2K
codestreams byte by byte with ``struct``, independent of any repo encoder.
Every case of tests/test_independent_streams.py and tests/test_tile_grids.py
goes through the port's ``J2KDecoder(device=cpu)`` on the "device" engine
(the plain torch lane of the inverse stage) and the "host" engine (the
native 5/3) and must equal the reference's ``J2KDecoder().decode`` bit for
bit, with the same image grid. The tile-grid streams come from the
reference encoder, and the port's encoder must write the same bytes.
Tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_dicom_codec_tpu import testdata as ref_td
from go_dicom_codec_tpu.codecs import jpeg2000 as ref_j2k
from go_dicom_codec_torch import testdata as td
from go_dicom_codec_torch.codecs import jpeg2000 as port_j2k

CPU = torch.device("cpu")
ENGINES = ("device", "host")


def _header_only(m):
    s = b"\xff\x4f" + m.siz(8, 8, 8) + m.cod(0, 0) + m.qcd(0, 8)
    return s + b"\xff\xd9"


# (id, stream maker of a testdata module, resilient): the cases of
# test_independent_streams.py
STREAMS = [
    ("simple_0level", lambda m: m.simple_j2k(8, 8, 8), False),
    ("multilevel_17x13_3lv", lambda m: m.multilevel_j2k(17, 13, 12, 3),
     False),
    *[(f"multitile_{w}x{h}_t{tw}x{th}_c{c}",
       lambda m, w=w, h=h, tw=tw, th=th, c=c: m.multitile_j2k(
           w, h, tw, th, 8, 1, c), False)
      for (w, h, tw, th, c) in ((16, 16, 8, 8, 1), (24, 16, 8, 8, 1),
                                (16, 16, 8, 8, 3), (20, 12, 8, 8, 1))],
    ("rgb_rct", lambda m: m.rgb_j2k(8, 8, 8, levels=1, mct=1), False),
    ("header_only", _header_only, True),
    *[(f"encoded_{p}_{w}x{h}_{b}bit",
       lambda m, p=p, w=w, h=h, b=b: m.encoded_j2k(w, h, b, pattern=p)[0],
       False)
      for p in ("cross", "corners")
      for (w, h, b) in ((8, 8, 8), (11, 7, 12), (16, 16, 16))],
]


def _compare(stream, engine, resilient=False):
    want, ref_siz, _ = ref_j2k.J2KDecoder(resilient=resilient).decode(stream)
    got, siz, _ = port_j2k.J2KDecoder(resilient=resilient, device=CPU,
                                      engine=engine).decode(stream)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert ((siz.xsiz, siz.ysiz, siz.xtsiz, siz.ytsiz, siz.components)
            == (ref_siz.xsiz, ref_siz.ysiz, ref_siz.xtsiz, ref_siz.ytsiz,
                ref_siz.components))
    return got


def test_generators_match_reference():
    """The copy's generators write the reference's bytes and patterns."""
    for _, make, _ in STREAMS:
        assert make(td) == make(ref_td)
    for name, bits in (("gradient_image", 8), ("dense_noise_image", 12),
                       ("textured_image", 12), ("checkerboard_image", 8),
                       ("rgb_pattern_image", 8)):
        np.testing.assert_array_equal(getattr(td, name)(31, 17, bits),
                                      getattr(ref_td, name)(31, 17, bits))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("make,resilient",
                         [pytest.param(m, r, id=i) for i, m, r in STREAMS])
def test_hand_packed_stream_decodes_as_reference(make, resilient, engine):
    _compare(make(td), engine, resilient)


def _tile_cases():
    rng = np.random.default_rng(15444)
    cases = [(f"aligned_{gx}x{gy}", rng.integers(0, 256, (16 * gy, 16 * gx)),
              16, {}) for gx, gy in ((2, 2), (3, 2), (1, 4))]
    cases += [(f"ragged_{h}x{w}", rng.integers(0, 256, (h, w)), 16, {})
              for h, w in ((33, 49), (17, 16), (40, 23))]
    mosaic = np.zeros((32, 48), dtype=np.int64)
    for ty in range(2):
        for tx in range(3):
            mosaic[ty * 16:(ty + 1) * 16, tx * 16:(tx + 1) * 16] = \
                10 + ty * 3 + tx
    cases.append(("indexing", mosaic, 16, {}))
    cases.append(("rgb_2x2", rng.integers(0, 256, (32, 32, 3)), 16, {}))
    cases += [(f"levels_{lv}", rng.integers(0, 256, (40, 56)), 16,
               {"num_levels": lv}) for lv in (0, 2, 4)]
    cases.append(("degenerate", rng.integers(0, 256, (24, 24)), 64, {}))
    return cases


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("img,tile,kw", [pytest.param(i, t, k, id=n)
                                         for n, i, t, k in _tile_cases()])
def test_tile_grid_stream_decodes_as_reference(img, tile, kw, engine):
    """The cases of tests/test_tile_grids.py: the reference encoder's
    stream, equal to the port encoder's, decodes identically and back to
    the image."""
    img = img if img.ndim == 3 else img[:, :, None]
    h, w, c = img.shape
    px = img.astype("<u1").tobytes()
    stream = ref_j2k.J2KEncoder(ref_j2k.J2KEncodeParams(
        tile_width=tile, tile_height=tile, **kw)).encode(px, w, h, c, 8)
    port_stream = port_j2k.J2KEncoder(port_j2k.J2KEncodeParams(
        tile_width=tile, tile_height=tile, **kw), device=CPU,
        engine=engine).encode(px, w, h, c, 8)
    assert port_stream == stream
    got = _compare(stream, engine)
    np.testing.assert_array_equal(np.asarray(got), img)


@pytest.mark.parametrize("engine", ENGINES)
def test_pattern_stream_decodes_as_reference(engine):
    """test_independent_streams.py's production round trip: the 12-bit
    textured pattern, 2 levels."""
    img = td.textured_image(33, 21, 12).astype(np.int32)
    stream = ref_j2k.J2KEncoder(ref_j2k.J2KEncodeParams(
        num_levels=2)).encode(img, 33, 21, 1, 12)
    assert port_j2k.J2KEncoder(port_j2k.J2KEncodeParams(num_levels=2),
                               device=CPU, engine=engine).encode(
        img, 33, 21, 1, 12) == stream
    got = _compare(stream, engine)
    np.testing.assert_array_equal(np.asarray(got)[:, :, 0], img)
