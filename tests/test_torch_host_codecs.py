"""Port parity: the host codecs .57, .70 (lossless JPEG) and .80, .81
(JPEG-LS) through the port's registry.

Their modules are byte-for-byte copies of the reference's (scans in the
native library), instantiated into ``make_registry``'s registry. Streams
and decoded frames must be byte-identical to the reference codec classes'
on the same seeded frames: every predictor of .57, NEAR 0, 2 and 5 of .81,
8/12/16 bits, gray and RGB. Also the fo-dicom SV1 fixture's pinned decode,
the fourteen UIDs of ``make_registry``, and the port's global registry
staying empty.
"""

import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import go_dicom_codec_tpu as ref
import go_dicom_codec_torch as port
from go_dicom_codec_torch.registry import get_global_registry

CPU = torch.device("cpu")
BASE = os.path.join(os.path.dirname(__file__), "..", "test-data")
SV1_PIXEL_SHA = ("bae1813f165ae41351acbffb87ee982c"
                 "e80ea942c1c88f5ee83b0824ab5e377a")
PORT_UIDS = sorted([
    ref.uids.RLE_LOSSLESS, ref.uids.JPEG_BASELINE_8BIT,
    ref.uids.JPEG_EXTENDED_12BIT, ref.uids.JPEG_LOSSLESS_P14,
    ref.uids.JPEG_LOSSLESS_SV1, ref.uids.JPEG_LS_LOSSLESS,
    ref.uids.JPEG_LS_NEAR_LOSSLESS, ref.uids.JPEG_2000_LOSSLESS,
    ref.uids.JPEG_2000_LOSSY, ref.uids.JPEG_2000_MC_LOSSLESS,
    ref.uids.JPEG_2000_MC_LOSSY, ref.uids.HTJ2K_LOSSLESS,
    ref.uids.HTJ2K_LOSSLESS_RPCL, ref.uids.HTJ2K])


def _frames(rng, bits, rgb, n=2, h=24, w=40):
    """Seeded smooth frames with noise, ``bits`` deep."""
    shape = (n, h, w, 3) if rgb else (n, h, w)
    walk = np.cumsum(rng.integers(-9, 10, shape), axis=2)
    return (walk + rng.integers(0, 4, shape)) % (1 << bits)


def _round_trip(pkg, codec, frames, bits, rgb, params=None):
    info = pkg.FrameInfo(width=frames.shape[2], height=frames.shape[1],
                         bits_allocated=8 if bits <= 8 else 16,
                         bits_stored=bits, samples_per_pixel=3 if rgb else 1,
                         photometric_interpretation="RGB" if rgb
                         else "MONOCHROME2")
    src = pkg.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype(np.uint8 if bits <= 8 else "<u2").tobytes())
    enc = pkg.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, params)
    dec = pkg.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    n = enc.frame_count()
    return ([enc.get_frame(i) for i in range(n)],
            [dec.get_frame(i) for i in range(n)],
            [src.get_frame(i) for i in range(n)])


def _cases():
    out = []
    for bits in (8, 12, 16):
        for rgb in (False, True):
            for pred in range(1, 8):
                out.append((ref.uids.JPEG_LOSSLESS_P14, {"predictor": pred},
                            bits, rgb))
            out.append((ref.uids.JPEG_LOSSLESS_SV1, None, bits, rgb))
            out.append((ref.uids.JPEG_LS_LOSSLESS, None, bits, rgb))
            for near in (0, 2, 5):
                out.append((ref.uids.JPEG_LS_NEAR_LOSSLESS, {"near": near},
                            bits, rgb))
    return out


@pytest.mark.parametrize("uid,params,bits,rgb", _cases())
def test_codec_matches_reference(uid, params, bits, rgb, rng):
    frames = _frames(rng, bits, rgb)
    want = _round_trip(ref, ref.get_global_registry().get_codec(uid), frames,
                       bits, rgb, params and ref.Parameters(**params))
    got = _round_trip(port, port.make_registry(CPU).get_codec(uid), frames,
                      bits, rgb, params and port.Parameters(**params))
    assert got[0] == want[0]
    assert got[1] == want[1]
    if uid != ref.uids.JPEG_LS_NEAR_LOSSLESS or params["near"] == 0:
        assert got[1] == got[2]


def test_sv1_golden_decode():
    """The fo-dicom-encoded clinical SV1 stream decodes through the port's
    registry to the pinned pixels."""
    with open(os.path.join(BASE, "us_fodicom_sv1.jpg"), "rb") as f:
        stream = f.read()
    info = port.FrameInfo(width=512, height=512, bits_allocated=16,
                          bits_stored=12)
    enc = port.MemoryPixelData(info=info, encapsulated=True)
    enc.add_frame(stream)
    dec = port.MemoryPixelData(info=info)
    port.make_registry(CPU).get_codec(port.uids.JPEG_LOSSLESS_SV1).decode(
        enc, dec)
    assert hashlib.sha256(dec.get_frame(0)).hexdigest() == SV1_PIXEL_SHA


def test_registry_holds_twelve_uids_and_the_global_one_stays_empty():
    for engine in ("auto", "device", "host"):
        reg = port.make_registry(CPU, engine)
        assert reg.registered_transfer_syntaxes() == PORT_UIDS
        for uid in PORT_UIDS:
            assert reg.get_codec(uid).transfer_syntax() == uid
            assert reg.get_codec(uid).name() == \
                ref.get_global_registry().get_codec(uid).name()
    assert get_global_registry().registered_transfer_syntaxes() == []
