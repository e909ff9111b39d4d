"""Port parity: the J2K transfer-syntax codecs through the registries.

The port's ``make_registry(cpu)`` against the reference's global registry,
for UIDs .90-.93, single-frame and multi-frame, on MemoryPixelData. The
encoders are deterministic on both sides (the lossy ones run the same
native 9/7 host lane), so every encapsulated frame must be byte-identical.
Lossless decodes are bit-identical; lossy multi-frame decodes go through
the pipelines' float 9/7 stage, whose reference is XLA-jitted, and agree
within ±1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import go_dicom_codec_tpu as ref
import go_dicom_codec_torch as port

CPU = torch.device("cpu")
J2K_UIDS = [ref.uids.JPEG_2000_LOSSLESS, ref.uids.JPEG_2000_MC_LOSSLESS,
            ref.uids.JPEG_2000_LOSSY, ref.uids.JPEG_2000_MC_LOSSY]
LOSSLESS = {ref.uids.JPEG_2000_LOSSLESS, ref.uids.JPEG_2000_MC_LOSSLESS}


def _round_trip(pkg, registry, uid, frames, rgb, bits_stored):
    info = pkg.FrameInfo(width=frames.shape[2], height=frames.shape[1],
                         bits_allocated=8 if rgb else 16,
                         bits_stored=bits_stored,
                         samples_per_pixel=3 if rgb else 1)
    src = pkg.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype(np.uint8 if rgb else "<u2").tobytes())
    enc = pkg.MemoryPixelData(info=info, encapsulated=True)
    codec = registry.get_codec(uid)
    codec.encode(src, enc)
    dec = pkg.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    n = enc.frame_count()
    return ([enc.get_frame(i) for i in range(n)],
            [dec.get_frame(i) for i in range(n)])


@pytest.mark.parametrize("uid", J2K_UIDS)
@pytest.mark.parametrize("rgb,nframes", [(False, 1), (False, 3), (True, 1),
                                         (True, 3)])
def test_codecs_match_reference(uid, rgb, nframes, rng):
    shape = (nframes, 24, 40, 3) if rgb else (nframes, 40, 32)
    bits = 8 if rgb else 12
    frames = (np.cumsum(rng.integers(-9, 10, shape), axis=2)
              % (1 << bits)).astype(np.int32)
    want_enc, want_dec = _round_trip(ref, ref.get_global_registry(), uid,
                                     frames, rgb, bits)
    got_enc, got_dec = _round_trip(port, port.make_registry(CPU), uid,
                                   frames, rgb, bits)
    assert got_enc == want_enc
    dt = np.uint8 if rgb else np.dtype("<u2")
    for g, w, f in zip(got_dec, want_dec, frames):
        g, w = np.frombuffer(g, dt), np.frombuffer(w, dt)
        if uid in LOSSLESS:
            assert g.tobytes() == w.tobytes()
            np.testing.assert_array_equal(g, f.reshape(-1))
        elif nframes == 1:          # the native host lane on both sides
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g.astype(np.int64) - w).max() <= 1


def test_make_registry_is_fresh_and_holds_the_j2k_family():
    a, b = port.make_registry(CPU), port.make_registry(CPU)
    assert a is not b
    assert set(J2K_UIDS) <= set(a.registered_transfer_syntaxes())
    for uid in J2K_UIDS:
        codec = a.get_codec(uid)
        assert codec.transfer_syntax() == uid
        assert codec is not b.get_codec(uid)
        assert codec.device == CPU
        assert codec.name() == \
            ref.get_global_registry().get_codec(uid).name()
    # every codec UID is registered now: a transfer syntax without a
    # codec stays unknown
    with pytest.raises(port.CodecNotFoundError):
        a.get_codec(ref.uids.EXPLICIT_VR_LITTLE_ENDIAN)


@pytest.mark.parametrize("uid,stage", [
    (ref.uids.JPEG_2000_LOSSLESS, "_j2k_decode_device_stage"),
    (ref.uids.JPEG_2000_LOSSY, "_j2k_decode_device_stage_97")])
def test_refused_launch_in_the_decode_pipeline_propagates(uid, stage, rng,
                                                          monkeypatch):
    """The multi-frame decode falls back to the scalar path on the
    pipeline's ValueError; a kernel that refused to launch must not."""
    from go_dicom_codec_torch import _kernels, pipeline

    frames = rng.integers(0, 4096, (3, 16, 24)).astype(np.int32)
    info = port.FrameInfo(width=24, height=16, bits_allocated=16,
                          bits_stored=12)
    src = port.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype("<u2").tobytes())
    codec = port.make_registry(CPU).get_codec(uid)
    enc = port.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)

    def refused(*a, **k):
        raise _kernels.KernelLaunchError("j2k_inv_stage: refused")

    monkeypatch.setattr(pipeline, stage, refused)
    with pytest.raises(_kernels.KernelLaunchError, match="refused"):
        codec.decode(enc, port.MemoryPixelData(info=info))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_registry_engine_reaches_the_pipelines(engine, rng):
    """``make_registry(device, engine)`` hands the engine to the codecs'
    pipelines: the same bytes either way, and each pipeline call logs the
    engine it ran."""
    from go_dicom_codec_torch.utils import profiling

    frames = rng.integers(0, 4096, (3, 16, 24)).astype(np.int32)
    want_enc, want_dec = _round_trip(port, port.make_registry(CPU),
                                     ref.uids.JPEG_2000_LOSSLESS, frames,
                                     False, 12)
    timer = profiling.enable_global_timer()
    try:
        got_enc, got_dec = _round_trip(port, port.make_registry(CPU, engine),
                                       ref.uids.JPEG_2000_LOSSLESS, frames,
                                       False, 12)
    finally:
        profiling.GLOBAL_TIMER = None
    assert got_enc == want_enc and got_dec == want_dec
    for name in ("pipeline.encode", "pipeline.decode"):
        assert timer.counts[name] == 1
        assert profiling.EVENTS[name] == {"engine": engine, "frames": 3,
                                          "chunks": 2 if name.endswith(
                                              "encode") else 1}


def test_registry_rejects_an_unknown_engine():
    with pytest.raises(ValueError, match="engine"):
        port.make_registry(CPU, engine="tpu")
