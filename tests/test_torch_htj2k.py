"""Port parity: HTJ2K (.201-.203) through the port's registry.

The OpenJPH golden codestreams of ``test-data/htj2k_interop/`` decode
through ``make_registry(cpu)`` to their ``input.raw``, on the native
inverse and on the device lane; .201/.202 encodes
are byte-identical to the reference adapter's and decode bit-exact, with 1
frame (the scalar decode) and 3 (``decode_frames_pipelined``), with
``ht_refinement`` and with three layers; .203 encodes are byte-identical
and decodes within ±1. A kernel that refused to launch inside the decode
pipeline leaves the codec's decode instead of falling back to the scalar
path.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import go_dicom_codec_tpu as ref
import go_dicom_codec_torch as port

CPU = torch.device("cpu")
BASE = os.path.join(os.path.dirname(__file__), "..", "test-data",
                    "htj2k_interop")
GOLDEN_UIDS = {"htj2k_lossless": ref.uids.HTJ2K_LOSSLESS,
               "htj2k_lossless_rpcl": ref.uids.HTJ2K_LOSSLESS_RPCL}


def _manifest():
    with open(os.path.join(BASE, "manifest.json")) as f:
        return {fx["name"]: fx for fx in json.load(f)["fixtures"]}


def _golden():
    return [(name, key) for name, fx in _manifest().items()
            for key in fx["codestreams"]]


@pytest.mark.parametrize("engine", ["auto", "device"])
@pytest.mark.parametrize("name,key", _golden())
def test_openjph_golden_decode(name, key, engine, monkeypatch):
    """On the CPU "auto" runs the scalar decode's inverse 5/3 natively, as
    the reference does, and "device" through the device lane (plain torch
    here, one fused inverse launch a stream on a GPU)."""
    from go_dicom_codec_torch.codecs import jpeg2000

    calls = []
    inv = jpeg2000.inv_stage
    monkeypatch.setattr(jpeg2000, "inv_stage",
                        lambda *a, **k: (calls.append(1), inv(*a, **k))[1])
    fx = _manifest()[name]
    w, h, nc = fx["width"], fx["height"], fx["components"]
    ba = fx["bitsAllocated"]
    dt = np.uint8 if ba == 8 else (np.dtype("<i2") if fx["signed"]
                                   else np.dtype("<u2"))
    with open(os.path.join(BASE, fx["inputRaw"]), "rb") as f:
        raw = np.frombuffer(f.read(), dtype=dt).reshape(h, w, nc)
    with open(os.path.join(BASE, fx["codestreams"][key]["path"]),
              "rb") as f:
        stream = f.read()
    info = port.FrameInfo(width=w, height=h, bits_allocated=ba,
                          bits_stored=fx["bitsStored"],
                          samples_per_pixel=nc,
                          pixel_representation=int(fx["signed"]))
    enc = port.MemoryPixelData(info=info, encapsulated=True)
    enc.add_frame(stream)
    dec = port.MemoryPixelData(info=info)
    port.make_registry(CPU, engine).get_codec(GOLDEN_UIDS[key]).decode(
        enc, dec)
    got = np.frombuffer(dec.get_frame(0), dtype=dt).reshape(h, w, nc)
    np.testing.assert_array_equal(got, raw)
    assert len(calls) == (1 if engine == "device" else 0)


CONTENT = {  # bits_allocated, bits_stored, signed, samples
    "gray12": (16, 12, False, 1),
    "signed16": (16, 16, True, 1),
    "rgb8": (8, 8, False, 3),
}


def _frames(rng, content, n, h=24, w=40):
    ba, bits, signed, spp = CONTENT[content]
    shape = (n, h, w, spp) if spp > 1 else (n, h, w)
    walk = np.cumsum(rng.integers(-9, 10, shape), axis=2) % (1 << bits)
    return walk - (1 << (bits - 1)) if signed else walk


def _round_trip(pkg, codec, frames, content, params=None):
    ba, bits, signed, spp = CONTENT[content]
    info = pkg.FrameInfo(width=frames.shape[2], height=frames.shape[1],
                         bits_allocated=ba, bits_stored=bits,
                         samples_per_pixel=spp,
                         pixel_representation=int(signed),
                         photometric_interpretation="RGB" if spp == 3
                         else "MONOCHROME2")
    dt = (np.uint8 if ba == 8 else np.dtype("<i2") if signed
          else np.dtype("<u2"))
    src = pkg.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype(dt).tobytes())
    enc = pkg.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, params)
    dec = pkg.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    n = enc.frame_count()
    return ([enc.get_frame(i) for i in range(n)],
            [np.frombuffer(dec.get_frame(i), dt) for i in range(n)],
            [np.frombuffer(src.get_frame(i), dt) for i in range(n)])


def _pair(uid, frames, content, params=None, engine="auto"):
    want = _round_trip(ref, ref.get_global_registry().get_codec(uid), frames,
                       content, params and ref.Parameters(**params))
    got = _round_trip(port, port.make_registry(CPU, engine).get_codec(uid),
                      frames, content, params and port.Parameters(**params))
    return want, got


@pytest.mark.parametrize("engine", ["auto", "device"])
@pytest.mark.parametrize("nframes", [1, 3])
@pytest.mark.parametrize("content", list(CONTENT))
@pytest.mark.parametrize("uid", [ref.uids.HTJ2K_LOSSLESS,
                                 ref.uids.HTJ2K_LOSSLESS_RPCL])
def test_lossless_matches_reference(uid, content, nframes, engine, rng):
    """On the CPU "auto" encodes each frame through the native 5/3, as the
    reference does, and "device" through the device stage (plain torch
    here, one fused forward launch a frame on a GPU)."""
    want, got = _pair(uid, _frames(rng, content, nframes), content,
                      engine=engine)
    assert got[0] == want[0]
    for g, w, s in zip(*got[1:], want[1]):
        np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("params", [
    {"ht_refinement": True},
    {"num_layers": 3, "layer_rates": [8.0, 4.0],
     "append_lossless_layer": True}])
@pytest.mark.parametrize("nframes", [1, 3])
def test_lossless_options_match_reference(params, nframes, rng):
    want, got = _pair(ref.uids.HTJ2K_LOSSLESS,
                      _frames(rng, "gray12", nframes), "gray12", params)
    assert got[0] == want[0]
    for g, s in zip(got[1], got[2]):
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("nframes", [1, 3])
@pytest.mark.parametrize("content", ["gray12", "rgb8"])
def test_lossy_within_one(content, nframes, rng):
    want, got = _pair(ref.uids.HTJ2K, _frames(rng, content, nframes),
                      content, {"quality": 85})
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= 1


@pytest.mark.parametrize("uid", [ref.uids.HTJ2K_LOSSLESS, ref.uids.HTJ2K])
def test_refused_launch_in_the_decode_pipeline_propagates(uid, rng,
                                                          monkeypatch):
    """The multi-frame decode falls back to the scalar path on the
    pipeline's UnsupportedFormatError, ValueError or CorruptStreamError; a
    kernel that refused to launch must leave the decode."""
    from go_dicom_codec_torch import _kernels, pipeline

    frames = _frames(rng, "gray12", 3)
    codec = port.make_registry(CPU, "device").get_codec(uid)
    _, bits, _, _ = CONTENT["gray12"]
    info = port.FrameInfo(width=40, height=24, bits_allocated=16,
                          bits_stored=bits)
    src = port.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype("<u2").tobytes())
    enc = port.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)

    def refused(*a, **k):
        raise _kernels.KernelLaunchError("j2k_inv_stage: refused")

    for stage in ("_j2k_decode_device_stage", "_j2k_decode_device_stage_97"):
        monkeypatch.setattr(pipeline, stage, refused)
    with pytest.raises(_kernels.KernelLaunchError, match="refused"):
        codec.decode(enc, port.MemoryPixelData(info=info))


@pytest.mark.parametrize("engine,device_stage", [("auto", False),
                                                 ("host", False),
                                                 ("device", True)])
@pytest.mark.parametrize("uid", [ref.uids.HTJ2K_LOSSLESS, ref.uids.HTJ2K])
def test_encode_engine_picks_the_tile_transform(uid, engine, device_stage,
                                                rng, monkeypatch):
    """The per-frame encode's reversible transform runs the device stage
    once a frame on the "device" engine and the native 5/3 otherwise on
    the CPU; the irreversible one keeps the native 9/7 on every engine."""
    from go_dicom_codec_torch.codecs import jpeg2000

    calls = []
    tile = jpeg2000.J2KEncoder._tile_coeffs_device
    monkeypatch.setattr(jpeg2000.J2KEncoder, "_tile_coeffs_device",
                        lambda *a: (calls.append(1), tile(*a))[1])
    frames = _frames(rng, "gray12", 3)
    want, got = _pair(uid, frames, "gray12", engine=engine)
    assert got[0] == want[0]
    lossless = uid == ref.uids.HTJ2K_LOSSLESS
    assert len(calls) == (3 if device_stage and lossless else 0)


def test_codecs_hold_device_and_engine():
    reg = port.make_registry(CPU, "host")
    for uid in (ref.uids.HTJ2K_LOSSLESS, ref.uids.HTJ2K_LOSSLESS_RPCL,
                ref.uids.HTJ2K):
        codec = reg.get_codec(uid)
        assert codec.device == CPU and codec.engine == "host"
    with pytest.raises(ValueError, match="engine"):
        port.make_registry(CPU, "tpu")
