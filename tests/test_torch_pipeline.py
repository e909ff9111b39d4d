"""Port parity: the J2K pipelines and their device stages.

Each device stage of the port is bit-exact against the JAX stage, and the
stages close end to end through the JAX package's own host seams: the
port's coefficients go into J2KEncoder.encode(precomputed_tiles=...) and
must give the same codestream bytes as the reference encoder; the
reference's decode_to_packed followed by the port's decode stage must give
the source pixels back. The port's double-buffered pipelines then run
against the reference's over the matrix of tests/test_pipeline_edges.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu import pipeline as ref
from go_dicom_codec_tpu.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder, decode_to_packed)
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


# ---- the double-buffered pipelines against the reference's ----------------
# The matrix of tests/test_pipeline_edges.py: both packages encode the same
# frames with the same engine; lossless bytes must be identical and the
# decodes bit-identical to the reference's and to the source.

CPU = torch.device("cpu")


def _walk(rng, shape, bits=12):
    return (np.cumsum(rng.integers(-9, 10, shape), axis=-2 if len(shape) == 4
                      else -1) % (1 << bits)).astype(np.int32)


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("n,chunk", [(1, 8), (3, 2), (8, 8), (9, 4)])
def test_pipelines_match_reference(n, chunk, engine, rng):
    frames = _walk(rng, (n, 48, 40))
    want = ref.encode_frames_pipelined(frames, bit_depth=12, levels=2,
                                       chunk=chunk, device=engine)
    got = port.encode_frames_pipelined(frames, bit_depth=12, levels=2,
                                       chunk=chunk, engine=engine,
                                       device=CPU)
    assert got == want
    dec = port.decode_frames_pipelined(want, chunk=chunk, engine=engine,
                                       device=CPU)
    ref_dec = ref.decode_frames_pipelined(want, chunk=chunk, device=engine)
    assert len(dec) == n
    for d, r, f in zip(dec, ref_dec, frames):
        assert d.dtype == np.int32 and d.shape == (48, 40, 1)
        _eq(d, r)
        _eq(d[..., 0], f)


@pytest.mark.parametrize("case", ["8bit", "odd", "rgb8", "rgb12-odd",
                                  "signed12"])
def test_pipeline_shapes_and_depths_match_reference(case, rng):
    bits, signed = 12, False
    if case == "8bit":
        frames, bits = rng.integers(0, 256, (3, 32, 32)).astype(np.int32), 8
    elif case == "odd":
        frames = _walk(rng, (2, 33, 47))
    elif case == "rgb8":
        frames, bits = _walk(rng, (3, 24, 40, 3), 8), 8
    elif case == "rgb12-odd":
        frames = _walk(rng, (2, 21, 35, 3))
    else:
        frames, signed = _walk(rng, (3, 32, 24)) - 2048, True
    want = ref.encode_frames_pipelined(frames, bit_depth=bits, signed=signed,
                                       levels=3)
    got = port.encode_frames_pipelined(frames, bit_depth=bits, signed=signed,
                                       levels=3, device=CPU)
    assert got == want
    dec = port.decode_frames_pipelined(got, device=CPU)
    for d, r, f in zip(dec, ref.decode_frames_pipelined(want), frames):
        _eq(d, r)
        _eq(d.reshape(f.shape), f)


def test_pipeline_int16_overflow_redo(monkeypatch, rng):
    """A narrow readback whose max |coeff| exceeds the int16 bound is
    recomputed in int32 from the chunk's device input (no real 13-bit
    frame overflows, so the bound is lowered here)."""
    frames = _walk(rng, (5, 32, 32))
    want = ref.encode_frames_pipelined(frames, bit_depth=12, levels=3)
    reruns = []
    real = port._Lane.rerun

    def counting(self, chunk, stage):
        reruns.append(chunk)
        return real(self, chunk, stage)

    monkeypatch.setattr(port, "INT16_MAX", 100)
    monkeypatch.setattr(port._Lane, "rerun", counting)
    got = port.encode_frames_pipelined(frames, bit_depth=12, levels=3,
                                       chunk=2, engine="device", device=CPU)
    assert got == want
    assert len(reruns) == 3          # every chunk of 2, 2, 1 frames


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("reduce", [1, 2])
def test_pipeline_reduce_matches_reference(engine, reduce, rng):
    frames = _walk(rng, (3, 40, 36))
    streams = ref.encode_frames_pipelined(frames, bit_depth=12, levels=3)
    want = ref.decode_frames_pipelined(streams, device=engine,
                                       reduce=reduce)
    got = port.decode_frames_pipelined(streams, engine=engine,
                                       reduce=reduce, device=CPU)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("ncomp,engine", [(1, "device"), (1, "host"),
                                          (3, "device"), (3, "host")])
def test_pipeline_lossy_decode_within_one(ncomp, engine, rng):
    """Irreversible streams: host dequant + 9/7 inverse on either engine,
    within one rounding tie of the reference's scalar decoder (and of its
    pipeline), clipped to the declared range."""
    shape = (4, 48, 64) if ncomp == 1 else (4, 48, 64, 3)
    frames = (np.cumsum(rng.integers(-9, 10, shape), axis=2)
              % 256).astype(np.int32)
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, lossless=False,
                                     quality=90))
    streams = [enc.encode(f, 64, 48, ncomp, 8) for f in frames]
    got = port.decode_frames_pipelined(streams, engine=engine, device=CPU)
    piped = ref.decode_frames_pipelined(streams, device=engine)
    for g, p, s in zip(got, piped, streams):
        scalar = J2KDecoder().decode(s)[0]
        assert np.abs(g.astype(np.int64) - scalar).max() <= 1
        assert np.abs(g.astype(np.int64) - p).max() <= 1
        assert g.min() >= 0 and g.max() <= 255


def test_pipeline_decode_rejects_mixed_transforms(rng):
    img = rng.integers(0, 256, (32, 32)).astype(np.int32)
    s_ll = J2KEncoder(J2KEncodeParams(num_levels=2)).encode(img, 32, 32, 1, 8)
    s_ir = J2KEncoder(J2KEncodeParams(num_levels=2, lossless=False)
                      ).encode(img, 32, 32, 1, 8)
    with pytest.raises(ValueError, match="equal-geometry"):
        port.decode_frames_pipelined([s_ll, s_ir], device=CPU)


def test_pipeline_empty_and_bad_engine():
    assert port.encode_frames_pipelined(np.zeros((0, 16, 16), np.int32),
                                        bit_depth=12, device=CPU) == []
    assert port.decode_frames_pipelined([], device=CPU) == []
    assert port.decode_frames_pipelined([], return_info=True,
                                        device=CPU) == ([], None)
    with pytest.raises(ValueError, match="engine"):
        port.encode_frames_pipelined(np.zeros((2, 8, 8), np.int32),
                                     bit_depth=8, engine="tpu", device=CPU)


def test_lane_refuses_to_overwrite_unread_results():
    lane = port._Lane(CPU)
    first = lane.submit(lambda x: x + 1, np.arange(4, dtype=np.int32))
    lane.submit(lambda x: x + 2, np.arange(4, dtype=np.int32))
    with pytest.raises(RuntimeError, match="not read"):
        lane.submit(lambda x: x, np.arange(4, dtype=np.int32))
    _eq(first.result()[0], np.arange(4) + 1)


def test_transfer_policy_measured_fake_regimes(monkeypatch):
    """The engine choice comes from a measured round trip per device; fake
    both regimes on a CUDA device object (no card is touched)."""
    from go_dicom_codec_torch.utils import profiling as prof

    monkeypatch.setattr(port, "_POLICY", {})
    gpu = torch.device("cuda", 0)
    pol = port.transfer_policy(gpu, force_remeasure=True,
                               _probe_roundtrip=lambda: 0.2,
                               _probe_host=lambda: 3.0)
    assert pol["prefer_device"] is True
    assert prof.EVENTS["pipeline.transfer_policy"]["prefer_device"] is True
    assert port.prefer_batched_device(gpu) is True
    assert port._tunnel_backend(gpu) is False

    pol = port.transfer_policy(gpu, force_remeasure=True,
                               _probe_roundtrip=lambda: 35.0,
                               _probe_host=lambda: 3.0)
    assert pol["prefer_device"] is False
    assert port.prefer_batched_device(gpu) is False
    assert port._tunnel_backend(gpu) is True
    assert port.transfer_policy(gpu) is pol          # cached

    # the CPU: no transfer, no probes; the device engine runs there
    pol = port.transfer_policy(CPU, force_remeasure=True,
                               _probe_roundtrip=lambda: 1 / 0,
                               _probe_host=lambda: 1 / 0)
    assert pol["prefer_device"] is False and pol["reason"] == "cpu device"
    assert port._tunnel_backend(CPU) is False
    assert port.prefer_batched_device(CPU) is False
