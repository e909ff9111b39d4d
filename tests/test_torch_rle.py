"""Port parity: RLE Lossless (.5) and the byte planes under it.

``go_dicom_codec_torch/ops/planes.py``'s torch split and merge against the
reference's jitted jnp forms, and the port's ``RLECodec`` (through
``make_registry(cpu, engine)``) against the reference codec: streams and
decoded frames byte-identical over 8/16/32-bit containers, 1 and 3
samples, interleaved and planar, odd widths, 1 and 4 frames, on the device
planes ("device") and on numpy ("host").
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import go_dicom_codec_tpu as ref
from go_dicom_codec_tpu.ops import planes as ref_planes
import go_dicom_codec_torch as port
from go_dicom_codec_torch.codecs import rle as port_rle
from go_dicom_codec_torch.ops import planes as port_planes

CPU = torch.device("cpu")
DTYPES = {8: np.uint8, 16: np.dtype("<u2"), 32: np.dtype("<u4")}


@pytest.mark.parametrize("ba,spp", [(1, 1), (2, 1), (4, 1), (1, 3), (2, 3),
                                    (4, 3)])
@pytest.mark.parametrize("nframes", [1, 4])
def test_planes_match_reference(ba, spp, nframes, rng):
    p = 7 * 13
    batch = rng.integers(0, 256, (nframes, p * spp * ba)).astype(np.uint8)
    split = jax.jit(ref_planes.split_byte_planes, static_argnums=(1, 2))
    merge = jax.jit(ref_planes.merge_byte_planes, static_argnums=(1, 2))
    want = np.asarray(split(jnp.asarray(batch), ba, spp))
    got = port_planes.split_byte_planes(torch.as_tensor(batch), ba, spp)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    back = port_planes.merge_byte_planes(got, ba, spp)
    # the transpose happens where the op runs, not after the readback
    assert got.is_contiguous() and back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(merge(jnp.asarray(want), ba,
                                                   spp)))
    np.testing.assert_array_equal(back.numpy(), batch)


def _round_trip(pkg, codec, frames, ba, spp, planar):
    info = pkg.FrameInfo(width=frames.shape[2], height=frames.shape[1],
                         bits_allocated=ba, bits_stored=ba,
                         samples_per_pixel=spp, planar_configuration=planar,
                         photometric_interpretation="RGB" if spp == 3
                         else "MONOCHROME2")
    src = pkg.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(np.ascontiguousarray(
            f.transpose(2, 0, 1) if planar else f).tobytes())
    enc = pkg.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = pkg.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    n = enc.frame_count()
    return ([enc.get_frame(i) for i in range(n)],
            [dec.get_frame(i) for i in range(n)],
            [src.get_frame(i) for i in range(n)])


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("nframes", [1, 4])
@pytest.mark.parametrize("spp,planar", [(1, 0), (3, 0), (3, 1)])
@pytest.mark.parametrize("ba", [8, 16, 32])
def test_codec_matches_reference(ba, spp, planar, nframes, engine, rng,
                                 monkeypatch):
    calls = []
    for name in ("split_byte_planes", "merge_byte_planes"):
        fn = getattr(port_rle, name)
        monkeypatch.setattr(port_rle, name, lambda *a, fn=fn, name=name: (
            calls.append(name), fn(*a))[1])
    # runs of equal samples and noise, so PackBits takes both branches
    frames = rng.integers(0, 1 << min(ba, 31),
                          (nframes, 9, 13, spp)).astype(DTYPES[ba])
    frames[:, :4] = frames[:, :1]
    want = _round_trip(ref, ref.get_global_registry().get_codec(
        ref.uids.RLE_LOSSLESS), frames, ba, spp, planar)
    got = _round_trip(port, port.make_registry(CPU, engine).get_codec(
        port.uids.RLE_LOSSLESS), frames, ba, spp, planar)
    assert got[0] == want[0]
    assert got[1] == want[1] == got[2]
    on_device = engine == "device" and nframes > 1 and not planar
    assert calls == (["split_byte_planes", "merge_byte_planes"]
                     if on_device else [])


def test_auto_engine_on_the_cpu_stays_on_numpy(rng, monkeypatch):
    """The CPU has no transfer to amortise: "auto" takes the numpy planes,
    as ``prefer_batched_device`` says."""
    monkeypatch.setattr(port_rle, "split_byte_planes", None)
    frames = rng.integers(0, 1 << 12, (3, 8, 8, 1)).astype("<u2")
    got = _round_trip(port, port.make_registry(CPU).get_codec(
        port.uids.RLE_LOSSLESS), frames, 16, 1, 0)
    assert got[1] == got[2]


def test_codec_rejects_an_unknown_engine():
    with pytest.raises(ValueError, match="engine"):
        port_rle.RLECodec(CPU, "tpu")
