"""Port parity: the pipelined JPEG decode (.50/.51), on the CPU.

``pipeline.decode_frames_pipelined_jpeg`` and the .50/.51 adapters that
take it for multi-frame data against the reference registry's per-frame
decode, on the "device" engine (one inverse call a chunk and grid shape,
the plain version on the CPU) and the "host" engine (the native IDCT a
frame): gray 8- and 12-bit at chunks of 1, 3 and 8 with a ragged last
chunk; RGB 4:4:4 (one call a chunk: luma and chroma tables in one
stack) and 4:2:0 made with PIL (two: the luma grid and the chroma
grids); a progressive frame in the middle of a multi-frame decode; a
corrupt frame raising the reference's error at the reference's frame,
the frames before it decoded; the int16/int32 upload choice, on frames
whose coefficients pass int16; the ``idct_islow`` calls counted a chunk
and group; a refused launch leaving the pipeline at once. Tolerance: 0.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import go_dicom_codec_tpu as ref
import go_dicom_codec_torch as port
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch import pipeline
from go_dicom_codec_torch.codecs import jpeg_baseline, jpeg_common
from go_dicom_codec_torch.codecs import jpeg_extended
from go_dicom_codec_torch.ops import jpeg_islow
from go_dicom_codec_torch.utils import profiling

CPU = torch.device("cpu")
UID50, UID51 = ref.uids.JPEG_BASELINE_8BIT, ref.uids.JPEG_EXTENDED_12BIT
PARSE = {UID50: jpeg_baseline.parse_frame, UID51: jpeg_extended.parse_frame}


def _frames(rng, bits, n, h=37, w=45, rgb=False):
    """Seeded smooth frames with noise, ``bits`` deep."""
    shape = (n, h, w, 3) if rgb else (n, h, w)
    walk = np.cumsum(rng.integers(-9, 10, shape), axis=2)
    return (walk + rng.integers(0, 4, shape)) % (1 << bits)


def _info(pkg, frames, bits, rgb):
    return pkg.FrameInfo(width=frames.shape[2], height=frames.shape[1],
                         bits_allocated=8 if bits <= 8 else 16,
                         bits_stored=bits, samples_per_pixel=3 if rgb else 1,
                         photometric_interpretation="RGB" if rgb
                         else "MONOCHROME2")


def _encode(frames, bits, rgb, uid):
    """The reference codec's streams of ``frames``."""
    info = _info(ref, frames, bits, rgb)
    src = ref.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype(np.uint8 if bits <= 8 else "<u2").tobytes())
    enc = ref.MemoryPixelData(info=info, encapsulated=True)
    ref.get_global_registry().get_codec(uid).encode(src, enc)
    return [enc.get_frame(i) for i in range(enc.frame_count())]


def _decode(pkg, codec, streams, info):
    """(the frames ``codec`` decodes, the error it raised or None)."""
    enc = pkg.MemoryPixelData(info=info, encapsulated=True)
    for s in streams:
        enc.add_frame(s)
    dec = pkg.MemoryPixelData(info=info)
    try:
        codec.decode(enc, dec)
        err = None
    except Exception as exc:  # compared with the reference's
        err = exc
    return [dec.get_frame(i) for i in range(dec.frame_count())], err


def _reference(streams, uid, info):
    return _decode(ref, ref.get_global_registry().get_codec(uid), streams,
                   info)


def _count(monkeypatch, module, name):
    calls, fn = [], getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: (calls.append((a, k)), fn(*a, **k))[1])
    return calls


def _upload_dtypes(monkeypatch):
    """The dtype of each group's coefficients at ``idct_group``, in a
    list, from here on."""
    dtypes, group = [], jpeg_common.idct_group

    def recorded(z, *a):
        dtypes.append(z.dtype)
        return group(z, *a)

    monkeypatch.setattr(jpeg_common, "idct_group", recorded)
    return dtypes


def _pil(frames, **save):
    Image = pytest.importorskip("PIL.Image")
    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f.astype(np.uint8)).save(buf, format="JPEG", **save)
        out.append(buf.getvalue())
    return out


@pytest.mark.parametrize("engine", ("device", "host"))
@pytest.mark.parametrize("chunk", (1, 3, 8))
@pytest.mark.parametrize("uid,bits", ((UID50, 8), (UID51, 12)))
def test_gray_chunks_match_reference(uid, bits, chunk, engine, rng,
                                     monkeypatch):
    """10 gray frames, chunks of 1, 3 and 8 (the last ragged): the
    pipeline's pixels equal the reference's per-frame decode; on "device"
    one inverse call a chunk, int16 coefficients up, and a
    pipeline.decode event naming the engine."""
    frames = _frames(rng, bits, 10)
    streams = _encode(frames, bits, False, uid)
    want, err = _reference(streams, uid, _info(ref, frames, bits, False))
    assert err is None
    calls = _count(monkeypatch, jpeg_islow, "idct_islow")
    dtypes = _upload_dtypes(monkeypatch)
    profiling.enable_global_timer()
    got = list(pipeline.decode_frames_pipelined_jpeg(
        streams, chunk, device=CPU, engine=engine, parse=PARSE[uid]))
    assert got == want
    chunks = -(-10 // chunk)
    assert profiling.EVENTS["pipeline.decode"] == {
        "engine": engine, "frames": 10, "chunks": chunks}
    if engine == "device":
        assert len(calls) == chunks
        assert dtypes == [torch.int16] * chunks
    else:
        assert not calls and not dtypes


@pytest.mark.parametrize("engine", ("device", "host"))
@pytest.mark.parametrize("layout", ("444", "420"))
def test_rgb_matches_reference(layout, engine, rng, monkeypatch):
    """RGB frames through the .50 adapter: 4:4:4 from the reference's
    encoder (one inverse call a chunk over the three components' two
    tables), 4:2:0 from PIL (two: the luma grid, then both chroma
    grids); the pixels equal the reference's per-frame decode."""
    frames = _frames(rng, 8, 5, h=40, w=56, rgb=True)
    streams = (_encode(frames, 8, True, UID50) if layout == "444"
               else _pil(frames, quality=85, subsampling=2))
    info = _info(port, frames, 8, True)
    want, err = _reference(streams, UID50, _info(ref, frames, 8, True))
    assert err is None
    calls = _count(monkeypatch, jpeg_islow, "idct_islow")
    codec = port.make_registry(CPU, engine).get_codec(UID50)
    got, err = _decode(port, codec, streams, info)
    assert err is None and got == want
    groups = 1 if layout == "444" else 2
    assert len(calls) == (groups if engine == "device" else 0)
    if engine == "device":
        planes = [a[0].shape[0] for a, _ in calls]
        assert planes == ([15] if layout == "444" else [5, 10])
        assert [len(a[1]) for a, _ in calls] == (
            [2] if layout == "444" else [1, 1])
        assert calls[0][1]["table_index"][:3] == (
            (0, 1, 1) if layout == "444" else (0, 0, 0))


@pytest.mark.parametrize("engine", ("device", "host"))
@pytest.mark.parametrize("uid", (UID50, UID51))
def test_progressive_frame_in_the_middle(uid, engine, rng, monkeypatch):
    """Frame 2 of 6 a PIL progressive stream: .50's progressive retry and
    .51's SOF2 path decode it in its place, the sequential frames around it
    through the pipeline (chunks of 3: the chunk holding it launches for
    its two sequential frames)."""
    frames = _frames(rng, 8, 6)
    streams = _encode(frames, 8, False, uid)
    streams[2] = _pil(frames[2:3], quality=80, progressive=True)[0]
    info = _info(port, frames, 8, False)
    want, err = _reference(streams, uid, _info(ref, frames, 8, False))
    assert err is None and len(want) == 6
    calls = _count(monkeypatch, jpeg_islow, "idct_islow")
    got = list(pipeline.decode_frames_pipelined_jpeg(
        streams, 3, device=CPU, engine=engine, parse=PARSE[uid]))
    assert got == want
    assert [a[0].shape[0] for a, _ in calls] == (
        [2, 3] if engine == "device" else [])
    codec = port.make_registry(CPU, engine).get_codec(uid)
    assert _decode(port, codec, streams, info) == (want, None)


@pytest.mark.parametrize("engine", ("device", "host"))
@pytest.mark.parametrize("at", (0, 4, 8))
@pytest.mark.parametrize("bad", (b"\xff\xd8\xff\xd9", "precision"))
def test_corrupt_frame_raises_at_its_frame(bad, at, engine, rng):
    """A corrupt frame (EOI before the scan; a 12-bit SOF in .50, whose
    progressive retry fails too) among 9 decodes: the adapter raises the
    reference's error, type and message, with the frames before it added,
    as the reference's per-frame loop leaves them."""
    frames = _frames(rng, 8, 9)
    streams = _encode(frames, 8, False, UID50)
    if bad == "precision":
        streams[at] = _encode(_frames(rng, 12, 1), 12, False, UID51)[0]
    else:
        streams[at] = bad
    want, want_err = _reference(streams, UID50,
                                _info(ref, frames, 8, False))
    assert want_err is not None and len(want) == at
    codec = port.make_registry(CPU, engine).get_codec(UID50)
    got, err = _decode(port, codec, streams, _info(port, frames, 8, False))
    assert got == want
    assert type(err).__name__ == type(want_err).__name__
    assert str(err) == str(want_err)


def test_upload_choice_and_wide_coefficients(rng, monkeypatch):
    """Coefficients that fit int16 go up as int16, others as int32:
    ``_jpeg_upload`` on the edges, and frames parsed with DC coefficients
    past int16 (a ``parse`` that hands the pipeline ScanFrames) decode
    through an int32 upload equal to the numpy lane."""
    a = np.array([[-32768, 32767]], np.int32)
    assert pipeline._jpeg_upload(a).dtype == np.int16
    assert pipeline._jpeg_upload(a - 1).dtype == np.int32
    assert pipeline._jpeg_upload(a + 1).dtype == np.int32
    assert pipeline._jpeg_upload(np.array([[-2 ** 31]], np.int32)
                                 ).dtype == np.int32
    grids = rng.integers(-60, 60, (4, 2, 3, 64)).astype(np.int32)
    grids[1, 0, 0, 0] = 40000
    q = np.full(64, 2, np.int32)
    scans = [jpeg_baseline.ScanFrame(8, 24, 16, [g], [q], [(1, 1)])
             for g in grids]
    dtypes = _upload_dtypes(monkeypatch)
    got = list(pipeline.decode_frames_pipelined_jpeg(
        scans, 2, device=CPU, engine="device", parse=lambda s: s))
    assert dtypes == [torch.int32, torch.int16]
    from go_dicom_codec_tpu.ops.dct8x8 import decode_zigzag_to_plane_np
    for g, px in zip(grids, got):
        want = decode_zigzag_to_plane_np(g, q, 128, 255)[:16, :24]
        assert px == want.astype(np.uint8).tobytes()


def test_refused_launch_leaves_the_pipeline(rng, monkeypatch):
    """A KernelLaunchError of the inverse leaves the pipelined decode at
    its first chunk, before any frame: no progressive retry, no host
    lane."""
    frames = _frames(rng, 8, 6)
    streams = _encode(frames, 8, False, UID50)

    def refused(*a, **k):
        raise _kernels.KernelLaunchError("jpeg_idct_islow: refused")

    monkeypatch.setattr(jpeg_islow, "idct_islow", refused)
    out = []
    with pytest.raises(_kernels.KernelLaunchError, match="refused"):
        for px in pipeline.decode_frames_pipelined_jpeg(
                streams, 3, device=CPU, engine="device"):
            out.append(px)
    assert out == []


def test_single_frame_decode_launches_a_group_once(rng, monkeypatch):
    """The byte-level decode of one RGB 4:4:4 frame on "device": one
    inverse call for its three components (the plain per-table loop on
    the CPU), the reference's pixels."""
    frames = _frames(rng, 8, 1, h=40, w=56, rgb=True)
    stream = _encode(frames, 8, True, UID50)[0]
    calls = _count(monkeypatch, jpeg_islow, "idct_islow")
    got = jpeg_baseline.decode(stream, device=CPU, engine="device")
    assert got[0] == ref.codecs.jpeg_baseline.decode(stream)[0]
    assert len(calls) == 1 and calls[0][0][0].shape[0] == 3
