"""Port parity: JPEG baseline (.50) and extended (.51) through the port's
registry, on the CPU, against the reference codecs of its global registry.

Encoded streams must be byte-identical and decodes bit-identical on every
engine: .50 gray (multi-frame, which "device" sends through the pipelined
encode) and RGB in both planar configurations, .51 12-bit gray
multi-frame and 8-bit gray. ``encode_frames_pipelined_jpeg`` must equal
the reference's at 8 and 12 bits on both engines, over several chunks; a
progressive stream made by PIL decodes through the port's .50 as through
the reference's; a refused kernel launch leaves ``codec.decode`` and the
pipelined encode as ``KernelLaunchError``, past the progressive retry;
the byte-level encode's engine rule ("device" takes the islow stage even
where the native library is built). Tolerance: 0.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import go_dicom_codec_tpu as ref
import go_dicom_codec_torch as port
from go_dicom_codec_tpu import pipeline as ref_pipeline
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch import pipeline
from go_dicom_codec_torch.codecs import jpeg_baseline, jpeg_common
from go_dicom_codec_torch.ops import jpeg_islow
from go_dicom_codec_torch.utils import profiling

CPU = torch.device("cpu")
ENGINES = ("auto", "device", "host")
UIDS = {"50": ref.uids.JPEG_BASELINE_8BIT, "51": ref.uids.JPEG_EXTENDED_12BIT}


def _frames(rng, bits, rgb, n=3, h=37, w=45):
    """Seeded smooth frames with noise, ``bits`` deep."""
    shape = (n, h, w, 3) if rgb else (n, h, w)
    walk = np.cumsum(rng.integers(-9, 10, shape), axis=2)
    return (walk + rng.integers(0, 4, shape)) % (1 << bits)


def _round_trip(pkg, codec, frames, bits, rgb, planar=0):
    info = pkg.FrameInfo(width=frames.shape[2], height=frames.shape[1],
                         bits_allocated=8 if bits <= 8 else 16,
                         bits_stored=bits, samples_per_pixel=3 if rgb else 1,
                         photometric_interpretation="RGB" if rgb
                         else "MONOCHROME2", planar_configuration=planar)
    src = pkg.MemoryPixelData(info=info)
    for f in frames:
        a = f.astype(np.uint8 if bits <= 8 else "<u2")
        if rgb and planar:
            a = np.moveaxis(a, -1, 0)
        src.add_frame(np.ascontiguousarray(a).tobytes())
    enc = pkg.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = pkg.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    n = enc.frame_count()
    return ([enc.get_frame(i) for i in range(n)],
            [dec.get_frame(i) for i in range(n)])


def _count(monkeypatch, module, name):
    """Calls of ``module.name`` from here on, in a list."""
    calls, fn = [], getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: (calls.append(1), fn(*a, **k))[1])
    return calls


CASES = [("50", 8, False, 0), ("50", 8, True, 0), ("50", 8, True, 1),
         ("51", 12, False, 0), ("51", 8, False, 0)]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("uid,bits,rgb,planar", CASES)
def test_codec_matches_reference(uid, bits, rgb, planar, engine, rng,
                                 monkeypatch):
    """Streams and decodes equal the reference's; on the CPU "device"
    takes the pipelined encode for multi-frame gray (not for 8-bit .51,
    as the reference) and the pipelined decode, one islow inverse call for
    the three frames (one chunk, one grid shape: gray, or RGB's three
    components with their two tables), "auto" and "host" the native
    lanes."""
    frames = _frames(rng, bits, rgb)
    want = _round_trip(ref, ref.get_global_registry().get_codec(UIDS[uid]),
                       frames, bits, rgb, planar)
    enc_calls = _count(monkeypatch, pipeline, "encode_frames_pipelined_jpeg")
    idct_calls = _count(monkeypatch, jpeg_islow, "idct_islow")
    codec = port.make_registry(CPU, engine).get_codec(UIDS[uid])
    got = _round_trip(port, codec, frames, bits, rgb, planar)
    assert got[0] == want[0]
    assert got[1] == want[1]
    on_device = engine == "device"
    pipelined = on_device and not rgb and (uid == "50" or bits == 12)
    assert len(enc_calls) == int(pipelined)
    assert len(idct_calls) == int(on_device)


@pytest.mark.parametrize("engine", ("device", "host"))
@pytest.mark.parametrize("precision", (8, 12))
def test_pipelined_encode_matches_reference(precision, engine, rng):
    """[5, 37, 45] frames in chunks of 2: the reference's streams, the
    reference's per-frame encoder's, and a pipeline.encode event naming
    the engine."""
    frames = _frames(rng, precision, False, n=5).astype(
        np.uint8 if precision == 8 else np.uint16)
    want = ref_pipeline.encode_frames_pipelined_jpeg(
        frames, quality=75, precision=precision, chunk=2)
    profiling.enable_global_timer()
    got = pipeline.encode_frames_pipelined_jpeg(
        frames, quality=75, precision=precision, chunk=2, device=CPU,
        engine=engine)
    assert got == want
    assert profiling.EVENTS["pipeline.encode"] == {
        "engine": engine, "frames": 5, "chunks": 3}
    # frames of another dtype go up as int32, as the reference casts them
    assert pipeline.encode_frames_pipelined_jpeg(
        frames.astype(np.int64), quality=75, precision=precision, chunk=2,
        device=CPU, engine=engine) == want
    assert pipeline.encode_frames_pipelined_jpeg(
        frames[:0], device=CPU) == []


def test_progressive_stream_decodes_as_reference(rng):
    Image = pytest.importorskip("PIL.Image")
    img = _frames(rng, 8, True, n=1, h=40, w=56)[0].astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", progressive=True,
                              quality=90)
    stream = buf.getvalue()
    out = []
    for pkg, codec in (
            (ref, ref.get_global_registry().get_codec(UIDS["50"])),
            (port, port.make_registry(CPU, "device").get_codec(UIDS["50"]))):
        info = pkg.FrameInfo(width=56, height=40, bits_allocated=8,
                             samples_per_pixel=3,
                             photometric_interpretation="RGB")
        enc = pkg.MemoryPixelData(info=info, encapsulated=True)
        enc.add_frame(stream)
        dec = pkg.MemoryPixelData(info=info)
        codec.decode(enc, dec)
        out.append(dec.get_frame(0))
    assert out[0] == out[1]
    assert len(out[0]) == 40 * 56 * 3


def test_refused_launch_leaves_decode_and_encode(rng, monkeypatch):
    """A KernelLaunchError of the islow wrappers is not turned into the
    progressive retry's UnsupportedFormatError, nor into a host fallback."""
    frames = _frames(rng, 8, False)
    codec = port.make_registry(CPU, "device").get_codec(UIDS["50"])
    info = port.FrameInfo(width=45, height=37, bits_allocated=8)
    src = port.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype(np.uint8).tobytes())
    enc = port.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)

    def refused(*a, **k):
        raise _kernels.KernelLaunchError("jpeg_islow: refused")

    monkeypatch.setattr(jpeg_islow, "idct_islow", refused)
    with pytest.raises(_kernels.KernelLaunchError, match="refused"):
        codec.decode(enc, port.MemoryPixelData(info=info))
    monkeypatch.setattr(jpeg_islow, "fdct_islow", refused)
    with pytest.raises(_kernels.KernelLaunchError, match="refused"):
        codec.encode(src, port.MemoryPixelData(info=info, encapsulated=True))


def test_idct_engine_rule(monkeypatch):
    """idct_and_assemble takes the native IDCT without a device, on "host"
    and on the CPU's "auto"; the islow inverse on "device"; the numpy
    mirror where the native library is missing."""
    from go_dicom_codec_torch import native

    rng = np.random.default_rng(3)
    cf = rng.integers(-60, 60, (2, 3, 64)).astype(np.int32)
    q = np.full((8, 8), 4, np.int32)
    want = ref.codecs.jpeg_common.idct_and_assemble(cf, q, 8, 1, 1, 1, 1, 13,
                                                    20)
    calls = _count(monkeypatch, jpeg_islow, "idct_islow")
    for device, engine, n in ((None, "auto", 0), (CPU, "host", 0),
                              (CPU, "auto", 0), (CPU, "device", 1)):
        got = jpeg_common.idct_and_assemble(cf, q, 8, 1, 1, 1, 1, 13, 20,
                                            device=device, engine=engine)
        assert np.array_equal(got.astype(np.int32), want)
        assert len(calls) == n
    monkeypatch.setattr(native, "jpg_idct_native", lambda *a: None)
    assert np.array_equal(jpeg_common.idct_and_assemble(
        cf, q, 8, 1, 1, 1, 1, 13, 20), want)


@pytest.mark.parametrize("components,precision", ((1, 8), (3, 8), (1, 12)))
def test_encode_engine_rule(components, precision, monkeypatch):
    """The byte-level encode takes the native DCT without a device, on
    "host" and on "auto"; on "device" the islow forward stage, one call a
    plane, even where the native library is built (before, "device" never
    reached the kernel from a single-frame encode); every lane writes the
    reference's bytes."""
    from go_dicom_codec_torch import native

    assert native.get_lib() is not None
    rng = np.random.default_rng(4)
    frame = rng.integers(0, 1 << precision, (21, 30, components))
    px = frame.astype(np.uint8 if precision == 8 else "<u2").tobytes()
    sof = {"sof_marker": 0xC1, "precision": 12} if precision == 12 else {}
    want = ref.codecs.jpeg_baseline.encode(px, 30, 21, components, 90, **sof)
    calls = _count(monkeypatch, jpeg_islow, "fdct_islow")
    for device, engine, n in ((None, "device", 0), (CPU, "host", 0),
                              (CPU, "auto", 0), (CPU, "device", components)):
        got = jpeg_baseline.encode(px, 30, 21, components, 90, **sof,
                                   device=device, engine=engine)
        assert got == want and len(calls) == n, (device, engine)
        calls.clear()


def test_codecs_hold_device_and_engine():
    reg = port.make_registry(CPU, "host")
    for uid in UIDS.values():
        codec = reg.get_codec(uid)
        assert codec.device == CPU and codec.engine == "host"
        assert codec.name() == ref.get_global_registry().get_codec(
            uid).name()
    with pytest.raises(ValueError, match="engine"):
        jpeg_baseline.JPEGBaselineCodec(CPU, "tpu")
    assert not jpeg_baseline.use_pipeline(CPU, "auto")
    assert jpeg_baseline.use_pipeline(CPU, "device")


@pytest.mark.parametrize("call", ("baseline_encode", "baseline_decode",
                                  "extended_encode", "extended_decode"))
def test_device_is_required(call):
    """``device`` is a required keyword of the codecs' byte-level encode
    and decode, as in ``J2KEncoder``: a call without it raises TypeError
    (nothing picks a device); an explicit None runs the host lanes and
    equals the reference."""
    from go_dicom_codec_torch.codecs import jpeg_extended

    px = (np.arange(16 * 24) % 251).astype(np.uint8).tobytes()
    stream = ref.codecs.jpeg_baseline.encode(px, 24, 16, 1, 90)
    fn, args = {
        "baseline_encode": (jpeg_baseline.encode, (px, 24, 16, 1, 90)),
        "baseline_decode": (jpeg_baseline.decode, (stream,)),
        "extended_encode": (jpeg_extended.encode, (px, 24, 16, 1, 8, 90)),
        "extended_decode": (jpeg_extended.decode, (stream,)),
    }[call]
    with pytest.raises(TypeError, match="device"):
        fn(*args)
    got = fn(*args, device=None)
    if call.endswith("encode"):
        assert got == stream
    else:
        assert got[0] == ref.codecs.jpeg_baseline.decode(stream)[0]
