"""Port parity: the J2K codec core (``codecs/jpeg2000.py``).

Both packages encode and decode the same seeded frames. With the native
library stubbed off in both, the transforms take the device branches (the
port's on CPU tensors) and T1/T2 the Python coders; with it on, both take
the native host lanes. Lossless codestreams must be byte-identical and
decodes bit-identical. Lossy ones go through float stages (9/7, ICT,
matrices) whose reference is XLA-jitted: where the bytes differ, the
decodes agree within ±1; ``decode_to_packed`` is host-only and always
bit-identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_dicom_codec_tpu import native as ref_native
from go_dicom_codec_tpu.codecs import jpeg2000 as ref
from go_dicom_codec_tpu.codecs.mct_builder import \
    MCTBindingBuilder as RefBinding
from go_dicom_codec_torch import native as port_native
from go_dicom_codec_torch.codecs import jpeg2000 as port
from go_dicom_codec_torch.codecs.mct_builder import \
    MCTBindingBuilder as PortBinding

CPU = torch.device("cpu")
M3 = [[0.6, 0.5, 0.5], [0.5, 0.6, -0.5], [0.5, -0.5, 0.6]]


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    monkeypatch.setattr(port_native, "get_lib", lambda: None)


def _pixels(rng, h, w, comps, bits, signed):
    """Smooth seeded content (a random walk along rows) spanning the full
    range of the depth: the Python T1 coder's time grows with noise."""
    walk = np.cumsum(rng.integers(-3, 4, (h, w, comps)), axis=1)
    walk += rng.integers(0, 1 << bits, (1, 1, comps))
    lo = -(1 << (bits - 1)) if signed else 0
    return (walk % (1 << bits) + lo).astype(np.int32)


def _bindings(builder):
    return [builder().components([0, 1]).matrix([[0.5, 0.5], [-0.5, 0.5]])
            .offsets([1.0, -2.0]).build(),
            builder().components([2]).matrix([[2.0]]).build()]


def _encoders(params, binding_maker=None):
    rp, pp = dict(params), dict(params)
    if binding_maker:
        rp["mct_bindings"] = binding_maker(RefBinding)
        pp["mct_bindings"] = binding_maker(PortBinding)
    return (ref.J2KEncoder(ref.J2KEncodeParams(**rp)),
            port.J2KEncoder(port.J2KEncodeParams(**pp), device=CPU))


LOSSLESS = [
    pytest.param(23, 37, 1, 12, False, {}, id="gray12-odd"),
    pytest.param(21, 27, 3, 8, False, {}, id="rgb8-rct"),
    pytest.param(24, 20, 1, 16, True, {}, id="signed16"),
    pytest.param(21, 19, 1, 8, True, {}, id="signed8"),
    pytest.param(32, 24, 1, 16, False, {"tile_width": 16,
                                        "tile_height": 16},
                 id="gray16-tiles"),
    pytest.param(16, 32, 3, 12, False, {"tile_width": 16,
                                        "tile_height": 16},
                 id="rgb12-tiles"),
    pytest.param(24, 24, 3, 8, False, {"mct_matrix": M3,
                                       "mct_inverse": np.linalg.inv(M3)
                                       .tolist()},
                 id="rgb8-part2-matrix"),
]


@pytest.mark.parametrize("h,w,comps,bits,signed,extra", LOSSLESS)
def test_lossless_byte_identical_device_branches(h, w, comps, bits, signed,
                                                 extra, rng, no_native):
    px = _pixels(rng, h, w, comps, bits, signed)
    renc, penc = _encoders(dict(num_levels=3, **extra))
    want = renc.encode(px, w, h, comps, bits, signed)
    got = penc.encode(px, w, h, comps, bits, signed)
    assert got == want
    rdec = ref.J2KDecoder().decode(want)[0]
    pdec = port.J2KDecoder(device=CPU).decode(want)[0]
    np.testing.assert_array_equal(pdec, rdec)
    if "mct_matrix" not in extra:   # a float matrix is exact only to ±1
        np.testing.assert_array_equal(pdec, px)
    if "tile_width" not in extra and "mct_matrix" not in extra:
        rp, rsiz, rcod = ref.decode_to_packed(want)
        pp, psiz, pcod = port.decode_to_packed(want)
        np.testing.assert_array_equal(pp, rp)
        assert (psiz.components, pcod.num_levels) == (rsiz.components,
                                                      rcod.num_levels)


LOSSY = [
    pytest.param(23, 37, 1, 12, {}, None, id="gray12"),
    pytest.param(21, 27, 3, 8, {}, None, id="rgb8-ict"),
    pytest.param(32, 24, 1, 8, {"tile_width": 16, "tile_height": 16},
                 None, id="gray8-tiles"),
    pytest.param(24, 24, 3, 8, {}, _bindings, id="rgb8-part2-bindings"),
]


@pytest.mark.parametrize("h,w,comps,bits,extra,bindings", LOSSY)
def test_lossy_within_one_device_branches(h, w, comps, bits, extra,
                                          bindings, rng, no_native):
    px = _pixels(rng, h, w, comps, bits, False)
    renc, penc = _encoders(dict(num_levels=3, lossless=False, quality=80,
                                **extra), bindings)
    want = renc.encode(px, w, h, comps, bits)
    got = penc.encode(px, w, h, comps, bits)
    rdec = ref.J2KDecoder().decode(want)[0].astype(np.int64)
    if got != want:
        own = port.J2KDecoder(device=CPU).decode(got)[0]
        assert np.abs(own - rdec).max() <= 1
    pdec = port.J2KDecoder(device=CPU).decode(want)[0]
    assert np.abs(pdec - rdec).max() <= 1
    if "tile_width" not in extra and bindings is None:
        np.testing.assert_array_equal(port.decode_to_packed(want)[0],
                                      ref.decode_to_packed(want)[0])


@pytest.mark.parametrize("comps,bits,lossless", [(1, 12, True),
                                                 (3, 8, True),
                                                 (1, 12, False),
                                                 (3, 8, False)])
def test_native_host_lanes_byte_identical(comps, bits, lossless, rng):
    """With the native library, both packages run the same host lanes:
    byte-identical streams and decodes, lossy included."""
    px = _pixels(rng, 48, 40, comps, bits, False)
    renc, penc = _encoders(dict(num_levels=4, lossless=lossless))
    want = renc.encode(px, 40, 48, comps, bits)
    assert penc.encode(px, 40, 48, comps, bits) == want
    np.testing.assert_array_equal(
        port.J2KDecoder(device=CPU).decode(want)[0],
        ref.J2KDecoder().decode(want)[0])
    assert port.decode_to_pixels(want, device=CPU) == \
        ref.decode_to_pixels(want)


def test_params_defaults_match_reference():
    assert port.J2KEncodeParams() == port.J2KEncodeParams(
        **vars(ref.J2KEncodeParams()))
    assert vars(port.J2KEncodeParams()) == vars(ref.J2KEncodeParams())


def test_device_stage_without_device_raises(rng, no_native):
    px = _pixels(rng, 16, 16, 1, 8, False)
    with pytest.raises(ValueError, match="torch.device"):
        port.J2KEncoder(port.J2KEncodeParams(num_levels=2)).encode(
            px, 16, 16, 1, 8)


@pytest.mark.parametrize("cut", [10, 60, -3])
def test_corrupt_stream_errors_match(cut, rng):
    """The packages' error classes differ; name and message must not."""
    px = _pixels(rng, 32, 32, 1, 12, False)
    stream = ref.J2KEncoder(ref.J2KEncodeParams(num_levels=3)).encode(
        px, 32, 32, 1, 12)
    bad = stream[:cut]
    errs = []
    for dec in (ref.J2KDecoder(), port.J2KDecoder(device=CPU)):
        try:
            dec.decode(bad)
            errs.append(None)
        except Exception as e:  # noqa: BLE001 - compared across packages
            errs.append((type(e).__name__, str(e)))
    assert errs[0] == errs[1]
