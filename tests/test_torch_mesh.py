"""Port parity: the port's multi-device scale-out (parallel/mesh.py and the
dry run) against the JAX package's, on the CPU.

The cases of tests/test_sharding.py, each on the same seeded inputs
through both packages. The reference runs on its conftest's 8 virtual
CPU devices; the port on meshes of 4 and 8 CPU devices with
tile_parallel 1 and 2 (``torch.device("cpu")`` repeated: the split, the
per-position stages and the gather run as on distinct cards).

Tolerances: lossless codestreams (Part-2 ones included) byte-identical
to the reference's sharded and scalar streams and to the port's scalar
encoder; lossy ones (the 9/7, a lossy Part-2 matrix) byte-identical to the
port's own scalar encoder on its device lane (the reference's jitted float
programs may differ from it by an ulp, which can flip a quantization tie:
their decodes agree within the reference's own bound of 16 between its
sharded and scalar lossy streams); reversible decodes bit-identical to
both packages' scalar decoders, heterogeneous ones included; lossy decodes
within ±1 of the reference.
No case here meets the reference's jitted 9/7 fault (a 1-wide column at
an odd origin over two or more levels, ROADMAP C): every tile and
tile-component is wider than that.
"""

import dataclasses
import functools
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.codecs import jpeg2000 as rj
from go_dicom_codec_tpu.codecs.mct_builder import MCTBinding
from go_dicom_codec_tpu.codestream import j2k
from go_dicom_codec_tpu.errors import UnsupportedFormatError as RefUnsupported
from go_dicom_codec_tpu.ops.dwt53 import fwd53_multilevel
from go_dicom_codec_tpu.parallel import mesh as rmesh
from go_dicom_codec_tpu.pipeline import (encode_frames_pipelined as
                                         ref_pipelined,
                                         j2k_lossless_encode_transform)

from go_dicom_codec_torch import native
from go_dicom_codec_torch import pipeline
from go_dicom_codec_torch.codecs import jpeg2000 as pj
from go_dicom_codec_torch.errors import UnsupportedFormatError
from go_dicom_codec_torch.parallel import mesh as pmesh
from go_dicom_codec_torch.parallel.dryrun import dryrun_multichip

CPU = torch.device("cpu")
# the port's meshes: devices, tile_parallel
MESHES = {"cpu4": (4, 1), "cpu4_t2": (4, 2), "cpu8": (8, 1),
          "cpu8_t2": (8, 2)}


@pytest.fixture(params=sorted(MESHES))
def mesh(request):
    n, tp = MESHES[request.param]
    return pmesh.make_mesh([CPU] * n, tile_parallel=tp)


def _smooth(shape, mod, seed=1234):
    """The reference tests' seeded random-walk frames (their ``rng``
    fixture's seed)."""
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.integers(-9, 10, shape), axis=2)
            % mod).astype(np.int32)


def _uniform(shape, bits, seed=1234):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, shape).astype(np.int32)


def _port_scalar(kw, frames, bits, device_lane=False):
    """The port's scalar encoder over each frame; ``device_lane`` keeps
    it off the native 9/7 (the lane the sharded stage mirrors)."""
    enc = pj.J2KEncoder(pj.J2KEncodeParams(**kw), device=CPU)
    nf, hh, ww = frames.shape[:3]
    nc = frames.shape[3] if frames.ndim == 4 else 1
    saved = native.get_lib
    if device_lane:
        native.get_lib = lambda: None
    try:
        return [enc.encode(frames[i], ww, hh, nc, bits) for i in range(nf)]
    finally:
        native.get_lib = saved


def _ref_scalar(kw, frames, bits):
    enc = rj.J2KEncoder(rj.J2KEncodeParams(**kw))
    nf, hh, ww = frames.shape[:3]
    nc = frames.shape[3] if frames.ndim == 4 else 1
    return [enc.encode(frames[i], ww, hh, nc, bits) for i in range(nf)]


# ---- the mesh and its plans -------------------------------------------------

def test_make_mesh_shapes():
    m = pmesh.make_mesh([CPU] * 8, tile_parallel=2)
    r = rmesh.make_mesh(8, tile_parallel=2)
    assert m.shape == dict(r.shape) == {pmesh.FRAME_AXIS: 4,
                                        pmesh.TILE_AXIS: 2}
    assert pmesh.make_mesh([CPU] * 8).shape[pmesh.FRAME_AXIS] == 8
    assert (pmesh.FRAME_AXIS, pmesh.TILE_AXIS) == (rmesh.FRAME_AXIS,
                                                   rmesh.TILE_AXIS)
    with pytest.raises(ValueError):
        pmesh.make_mesh([CPU] * 8, tile_parallel=3)
    with pytest.raises(ValueError):
        pmesh.make_mesh([])
    with pytest.raises(ValueError):
        pmesh.make_mesh([torch.device("meta")])
    with pytest.raises(TypeError):
        pmesh.make_mesh()          # no default: nothing picks a device
    cards = pmesh.make_mesh([torch.device("cuda", 0)] * 2, tile_parallel=2)
    assert cards.shape == {pmesh.FRAME_AXIS: 1, pmesh.TILE_AXIS: 2}
    assert list(cards.devices.flat) == [torch.device("cuda", 0)] * 2


def _norm(index, shape):
    """An index as one range per axis; axes it leaves out are whole."""
    index = tuple(index) + (slice(None),) * (len(shape) - len(index))
    return tuple(range(*sl.indices(n)) for sl, n in zip(index, shape))


@pytest.mark.parametrize("plan", ["frame", "frame_tile", "flat"])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("shape", [(8, 4, 3), (16, 2, 5), (32, 8, 1)])
def test_sharding_blocks_match_reference(plan, tp, shape):
    """Every mesh position holds the block the reference's NamedSharding
    gives the device at that position (row-major over the mesh)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    r = rmesh.make_mesh(8, tile_parallel=tp)
    m = pmesh.make_mesh([CPU] * 8, tile_parallel=tp)
    ref_sh, port_sh = {
        "frame": (rmesh.frame_sharding(r), pmesh.frame_sharding(m)),
        "frame_tile": (rmesh.frame_tile_sharding(r),
                       pmesh.frame_tile_sharding(m)),
        "flat": (NamedSharding(r, P((rmesh.FRAME_AXIS, rmesh.TILE_AXIS))),
                 pmesh._flat_sharding(m)),
    }[plan]
    want = ref_sh.devices_indices_map(shape)
    got = port_sh.shards(shape)
    assert len(got) == 8
    for dev, (pdev, index) in zip(r.devices.flat, got):
        assert pdev == CPU
        assert _norm(index, shape) == _norm(want[dev], shape)


@pytest.mark.parametrize("f", [1, 5, 7, 9, 16])
def test_uneven_blocks_are_the_padded_reference_blocks(f):
    """A frame count the mesh does not divide: each position holds its
    block of the reference's padded batch, less the pad frames."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    r = rmesh.make_mesh(8, tile_parallel=2)
    m = pmesh.make_mesh([CPU] * 8, tile_parallel=2)
    padded, orig = rmesh.pad_batch_to_devices(np.zeros((f, 3)), 8)
    want = NamedSharding(r, P((rmesh.FRAME_AXIS, rmesh.TILE_AXIS))
                         ).devices_indices_map(padded.shape)
    got = pmesh._flat_sharding(m).shards((f,))
    for dev, (_, (sl,)) in zip(r.devices.flat, got):
        rows = range(*want[dev][0].indices(padded.shape[0]))
        assert list(range(*sl.indices(f))) == [i for i in rows if i < orig]


def test_shard_frames_matches_reference(rng):
    batch = rng.integers(0, 4096, (8, 6, 5)).astype(np.int32)
    r = rmesh.make_mesh(8, tile_parallel=2)
    arr = rmesh.shard_frames(jnp.asarray(batch), r)
    want = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    got = pmesh.shard_frames(batch, pmesh.make_mesh([CPU] * 8, 2))
    assert len(got) == 8
    for dev, t in zip(r.devices.flat, got):
        assert t.device == CPU and np.array_equal(t.numpy(), want[dev])
    got[0][0, 0, 0] = -1        # a copy: the caller's batch is untouched
    assert batch[0, 0, 0] != -1


@pytest.mark.parametrize("f,n", [(5, 8), (8, 8), (3, 2), (0, 4)])
def test_pad_batch_to_devices(f, n):
    batch = np.ones((f, 4, 4), dtype=np.int32)
    padded, orig = pmesh.pad_batch_to_devices(batch, n)
    want, worig = rmesh.pad_batch_to_devices(batch, n)
    assert orig == worig == f
    assert padded.shape == want.shape and np.array_equal(padded, want)
    assert (padded[f:] == 0).all()


def test_sharded_dwt_matches_single_device(rng, mesh):
    """The sharded 5/3 stage over a frame batch == one device's
    multilevel 5/3 in the reference."""
    frames = rng.integers(-2048, 2048, size=(8, 64, 64)).astype(np.int32)
    got = pmesh.sharded_tile_coeffs(frames[..., None], [(0, 0, 64, 64)], 3,
                                    16, True, False, 1, True, mesh)
    want = np.asarray(fwd53_multilevel(jnp.asarray(frames), 3))
    assert len(got) == 1 and got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0][:, 0], want)


def test_sharded_roundtrip_inverse(rng, mesh):
    """fwd + inv 5/3 over the mesh is the identity."""
    frames = rng.integers(-500, 500, size=(8, 40, 56)).astype(np.int32)
    coeffs = pmesh.sharded_tile_coeffs(frames[..., None], [(0, 0, 56, 40)],
                                       2, 16, True, False, 1, True, mesh)[0]
    (back,) = pmesh._run_on_mesh(mesh, [(coeffs, pmesh._inverse_stage(
        1, 2, 0, 0, 16, True, False))])
    np.testing.assert_array_equal(back[:, 0], frames)


@pytest.mark.parametrize("devices", [4, 8, 3])
def test_dryrun_multichip(devices):
    """The dry run passes on a mesh of CPU devices, and its cross-shard
    bit-plane sum equals the reference's unsharded transform's on the
    same frames."""
    out = dryrun_multichip([CPU] * devices)
    tp = 2 if devices % 2 == 0 else 1
    f, t = devices // tp * 2, tp * 2
    assert out["step"] == [f, t, 64, 64]
    frames = np.random.default_rng(0).integers(
        0, 1 << 12, size=(f, t, 64, 64), dtype=np.int32)
    _, _, bits = j2k_lossless_encode_transform(
        jnp.asarray(frames.reshape(f * t, 64, 64)), levels=3, bits=16,
        signed=False, cb=32)
    assert out["cb_bits_total"] == int(np.asarray(bits).astype(
        np.int64).sum())


# ---- the sharded encode -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_gray_encode():
    frames = _smooth((5, 64, 64), 4096)
    streams = rmesh.encode_frames_sharded(
        frames, bit_depth=12, levels=3,
        mesh=rmesh.make_mesh(tile_parallel=2))
    assert streams == ref_pipelined(frames, bit_depth=12, levels=3)
    return frames, streams


def test_encode_frames_sharded_byte_identical(mesh):
    """Sharded streams == the reference's sharded and pipelined streams
    == the port's pipelined encoder's."""
    frames, want = _ref_gray_encode()
    got = pmesh.encode_frames_sharded(frames, bit_depth=12, levels=3,
                                      mesh=mesh)
    assert len(got) == 5 and got == want
    assert got == pipeline.encode_frames_pipelined(
        frames, bit_depth=12, levels=3, device=CPU)


FULL_SURFACE = {
    "multi_tile": (dict(tile_width=48, tile_height=40), (3, 96, 80), 12),
    "rgb_mct": (dict(), (2, 64, 64, 3), 8),
    "lossy_97": (dict(lossless=False, quality=60), (2, 96, 80), 12),
    "rgb_lossy_layers": (dict(lossless=False, num_layers=3,
                              layer_rates=[8.0, 4.0, 0.0]),
                         (2, 64, 64, 3), 8),
    "precincts": (dict(precincts=[(6, 6)] * 4, progression=2),
                  (2, 96, 80), 12),
    "htj2k": (dict(htj2k=True), (2, 64, 64), 12),
    "packed_markers": (dict(packed_headers=True, use_sop=True, use_eph=True,
                            plt_markers=True, tlm_markers=True,
                            tile_width=48, tile_height=40), (2, 96, 80), 12),
}


@functools.lru_cache(maxsize=None)
def _ref_full_surface(name):
    kw, shape, bits = FULL_SURFACE[name]
    frames = _uniform(shape, bits)
    streams = rmesh.encode_frames_sharded(
        frames, bit_depth=bits, levels=3, mesh=rmesh.make_mesh(),
        params=rj.J2KEncodeParams(num_levels=3, **kw))
    return frames, streams


@pytest.mark.parametrize("name", sorted(FULL_SURFACE))
def test_encode_frames_sharded_full_surface(name, mesh):
    """The full parameter surface shards: multi-tile, RGB/RCT, 9/7,
    multi-layer, precincts, HTJ2K, packed markers. Lossless: equal to
    the reference's sharded and scalar streams and the port's scalar.
    Lossy: equal to the port's scalar encoder on its device lane, and
    decoding as the reference's sharded streams do within a quantization
    step."""
    kw, shape, bits = FULL_SURFACE[name]
    frames, ref_streams = _ref_full_surface(name)
    kw = dict(num_levels=3, **kw)
    got = pmesh.encode_frames_sharded(
        frames, bit_depth=bits, levels=3, mesh=mesh,
        params=pj.J2KEncodeParams(**kw))
    if kw.get("lossless", True):
        assert got == ref_streams == _ref_scalar(kw, frames, bits)
        assert got == _port_scalar(kw, frames, bits)
        return
    assert got == _port_scalar(kw, frames, bits, device_lane=True)
    # a flipped quantization tie moves a coefficient by one step: the
    # reference's own bound between its sharded and scalar lossy streams
    # (tests/test_sharding.py)
    for a, b in zip(got, ref_streams):
        ra = rj.J2KDecoder().decode(a)[0].astype(np.int64)
        rb = rj.J2KDecoder().decode(b)[0].astype(np.int64)
        assert np.abs(ra - rb).max() <= 16


@pytest.mark.parametrize("style", ["maxshift", "general"])
def test_encode_frames_sharded_roi(style, mesh):
    """ROI shards: the mask pre-shift runs on the host inside
    encode(precomputed_tiles=...) — equal to both packages."""
    from go_dicom_codec_tpu.codecs.j2k_roi import ROIRegion as RefROI
    from go_dicom_codec_torch.codecs.j2k_roi import ROIRegion

    frames = _smooth((3, 64, 64), 4096)
    kw = dict(num_levels=3, cb_style=0, roi_style=style)
    got = pmesh.encode_frames_sharded(
        frames, bit_depth=12, mesh=mesh, params=pj.J2KEncodeParams(
            roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 24, 24))],
            **kw))
    ref_kw = dict(roi_regions=[RefROI(shape="rect", rect=(8, 8, 24, 24))],
                  **kw)
    assert got == rmesh.encode_frames_sharded(
        frames, bit_depth=12, mesh=rmesh.make_mesh(),
        params=rj.J2KEncodeParams(**ref_kw))
    assert got == _ref_scalar(ref_kw, frames, 12)


M3 = [[0.5, 0.25, 0.25], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]]
M2 = [[0.7, 0.3], [0.3, 0.7]]


def _mct_kw(case, binding):
    """The Part-2 parameter sets of the reference's custom-MCT tests, with
    ``binding`` the package's MCTBinding class."""
    minv = np.linalg.inv(np.asarray(M3)).tolist()
    b1 = binding(component_ids=[0, 1, 2], matrix=np.eye(3).tolist(),
                 inverse=np.eye(3).tolist(), offsets=[5.0, 0.0, -5.0])
    b2 = binding(component_ids=[0, 1], matrix=M2,
                 inverse=np.linalg.inv(M2).tolist(), offsets=None)
    return {
        "matrix": dict(mct_matrix=M3, mct_inverse=minv),
        "bindings": dict(mct_bindings=[b1]),
        "two_bindings": dict(mct_bindings=[b1, b2]),
        "lossy_matrix": dict(mct_matrix=M3, mct_inverse=minv,
                             lossless=False, quality=90),
    }[case]


@pytest.mark.parametrize("case", ["matrix", "bindings", "two_bindings",
                                  "lossy_matrix"])
def test_encode_frames_sharded_custom_mct(case, mesh):
    """Part-2 matrices and MCT bindings shard (bindings and matrix replace
    RCT/ICT): byte-identical to the port's scalar encoder, whose Part-2
    stage they run batched. Lossless ones also equal both of the
    reference's lanes (the float matrix's result is rounded before the
    5/3, and the port's sum is XLA's CPU FMA chain)."""
    from go_dicom_codec_torch.codecs.mct_builder import MCTBinding as PB

    rgb = _uniform((3, 48, 48, 3), 8)
    kw = dict(num_levels=3, **_mct_kw(case, PB))
    got = pmesh.encode_frames_sharded(rgb, bit_depth=8, mesh=mesh,
                                      params=pj.J2KEncodeParams(**kw))
    assert got == _port_scalar(kw, rgb, 8)
    if case != "lossy_matrix":
        ref_kw = dict(num_levels=3, **_mct_kw(case, MCTBinding))
        assert got == _ref_scalar(ref_kw, rgb, 8) == \
            rmesh.encode_frames_sharded(rgb, bit_depth=8,
                                        mesh=rmesh.make_mesh(),
                                        params=rj.J2KEncodeParams(**ref_kw))


# ---- the sharded decode -----------------------------------------------------

@pytest.mark.parametrize("name,shape,bits,kw", [
    ("gray", (5, 64, 64), 12, {}),
    ("rgb_rct", (3, 48, 56), 8, {}),   # the reference's case: gray
    ("rgb_rct_3c", (3, 48, 56, 3), 8, {}),
    ("gray_deep", (2, 96, 80), 16, {"num_levels": 4}),
    ("htj2k", (3, 64, 64), 12, {"htj2k": True}),
])
def test_decode_frames_sharded_bit_identical(name, shape, bits, kw, mesh):
    """Host entropy per frame + the inverse stage over the mesh is
    bit-identical to the reference's sharded and scalar decodes and to
    the source."""
    frames = _uniform(shape, bits)
    kw = {"num_levels": 3, **kw}
    streams = _ref_scalar(kw, frames, bits)
    got = pmesh.decode_frames_sharded(streams, mesh=mesh)
    want = rmesh.decode_frames_sharded(streams, mesh=rmesh.make_mesh())
    for i, df in enumerate(got):
        assert df.dtype == np.int32
        np.testing.assert_array_equal(df, want[i])
        np.testing.assert_array_equal(df, rj.J2KDecoder().decode(
            streams[i])[0])
        src = frames[i] if frames.ndim == 4 else frames[i][..., None]
        np.testing.assert_array_equal(df, src)


def test_decode_frames_sharded_empty_and_reduce(mesh):
    assert pmesh.decode_frames_sharded([], mesh=mesh) == []
    frames = _smooth((3, 64, 64), 4096)
    streams = _ref_scalar(dict(num_levels=3), frames, 12)
    got = pmesh.decode_frames_sharded(streams, mesh=mesh, reduce=1)
    want = rmesh.decode_frames_sharded(streams, mesh=rmesh.make_mesh(),
                                       reduce=1)
    assert got[0].shape == (32, 32, 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_decode_frames_sharded_roi_both_styles(mesh):
    """ROI streams of both styles shard on decode: the unshift runs on the
    packed host coefficients — bit-identical to the scalar decoders."""
    from go_dicom_codec_tpu.codecs.j2k_roi import ROIRegion

    frames = _smooth((3, 64, 64), 4096)
    for style in ("maxshift", "general"):
        kw = dict(num_levels=3, cb_style=0,
                  roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 24, 24))],
                  roi_style=style)
        streams = _ref_scalar(kw, frames, 12)
        got = pmesh.decode_frames_sharded(streams, mesh=mesh)
        for i, df in enumerate(got):
            np.testing.assert_array_equal(
                df, rj.J2KDecoder().decode(streams[i])[0], err_msg=style)
            np.testing.assert_array_equal(
                df, pj.J2KDecoder(device=CPU).decode(streams[i])[0])


def test_decode_frames_sharded_lossy_within_tie_tolerance(mesh):
    """Irreversible streams: host dequant + the 9/7 inverse over the mesh,
    within ±1 of the reference's sharded and scalar decodes, and equal to
    the port's scalar decoder on its device lane."""
    frames = _smooth((3, 64, 64), 256)
    kw = dict(num_levels=3, lossless=False, quality=90)
    streams = _ref_scalar(kw, frames, 8)
    got = pmesh.decode_frames_sharded(streams, mesh=mesh)
    want = rmesh.decode_frames_sharded(streams)
    for i, df in enumerate(got):
        for other in (want[i], rj.J2KDecoder().decode(streams[i])[0]):
            assert np.abs(df.astype(np.int64)
                          - other.astype(np.int64)).max() <= 1
        err = np.abs(df[..., 0].astype(np.int64) - frames[i])
        assert err.max() <= 12 and err.mean() < 2.5


@pytest.mark.parametrize("case", ["gray_lossless", "rgb_lossy"])
def test_decode_frames_sharded_multitile(case, mesh):
    """Multi-tile streams: one stage a tile and mesh position."""
    if case == "gray_lossless":
        frames = _smooth((3, 96, 80), 4096)
        streams = _ref_scalar(dict(num_levels=3, tile_width=48,
                                   tile_height=40), frames, 12)
        for d, f in zip(pmesh.decode_frames_sharded(streams, mesh=mesh),
                        frames):
            np.testing.assert_array_equal(d[..., 0], f)
        return
    rgb = _uniform((3, 96, 96, 3), 8)
    streams = _ref_scalar(dict(num_levels=3, tile_width=48, tile_height=48,
                               lossless=False, quality=90), rgb, 8)
    got = pmesh.decode_frames_sharded(streams, mesh=mesh)
    want = rmesh.decode_frames_sharded(streams, mesh=rmesh.make_mesh())
    for d, w, s in zip(got, want, streams):
        for other in (w, rj.J2KDecoder().decode(s)[0]):
            assert np.abs(d.astype(np.int64)
                          - other.astype(np.int64)).max() <= 1


@pytest.mark.parametrize("case", ["matrix_lossless", "bindings_lossless",
                                  "matrix_lossy"])
def test_decode_frames_sharded_custom_mct(case, mesh):
    """Part-2 custom MCT streams: the marker-carried inverse matrices in
    reverse MCO order, batched. Lossless: bit-identical to the port's
    scalar decoder; all within ±1 of the reference's."""
    kw = dict(num_levels=3, **_mct_kw(
        {"matrix_lossless": "matrix", "bindings_lossless": "bindings",
         "matrix_lossy": "lossy_matrix"}[case], MCTBinding))
    rgb = _uniform((3, 48, 48, 3), 8)
    streams = _ref_scalar(kw, rgb, 8)
    got = pmesh.decode_frames_sharded(streams, mesh=mesh)
    want = rmesh.decode_frames_sharded(streams, mesh=rmesh.make_mesh())
    for d, w, s in zip(got, want, streams):
        if case.endswith("lossless"):
            np.testing.assert_array_equal(
                d, pj.J2KDecoder(device=CPU).decode(s)[0])
        for other in (w, rj.J2KDecoder().decode(s)[0]):
            assert np.abs(d.astype(np.int64)
                          - other.astype(np.int64)).max() <= 1


# ---- heterogeneous streams (subsampled / COC / QCC / per-tile) -------------

def _hetero_streams(case):
    """Three 2-component streams of the reference's heterogeneous tests
    (tests/test_sharding.py's remux recipe)."""
    from test_sharding import _remux_two_component

    rng = np.random.default_rng(1234)
    streams = []
    for _ in range(3):
        a = rng.integers(0, 1 << 16, (64, 64), dtype=np.uint16)
        if case == "subsampled":
            b = rng.integers(0, 1 << 16, (32, 32), dtype=np.uint16)
            streams.append(_remux_two_component(a, b, sub=True))
        else:
            b = rng.integers(0, 1 << 16, (64, 64), dtype=np.uint16)
            streams.append(_remux_two_component(a, b, sub=False,
                                                levels_b=1))
    return streams


@pytest.mark.parametrize("case", ["subsampled", "coc_levels"])
def test_decode_frames_sharded_heterogeneous(case, mesh):
    """Subsampled and COC/QCC streams: one stage a tile-component and
    mesh position, bit-identical to both packages' scalar decoders and
    the reference's sharded decode."""
    streams = _hetero_streams(case)
    got = pmesh.decode_frames_sharded(streams, mesh=mesh)
    want = rmesh.decode_frames_sharded(streams, mesh=rmesh.make_mesh())
    for d, w, s in zip(got, want, streams):
        np.testing.assert_array_equal(d, w)
        np.testing.assert_array_equal(d, rj.J2KDecoder().decode(s)[0])
        np.testing.assert_array_equal(
            d, pj.J2KDecoder(device=CPU).decode(s)[0])


def _per_tile_cod(frames, comps, bits, raw=False):
    """Two-tile streams whose second tile carries its own COD (RLCP
    progression): the reference tests' recipe."""
    enc = rj.J2KEncoder(rj.J2KEncodeParams(num_levels=2, tile_width=24,
                                           tile_height=64))
    streams = []
    for f in frames:
        s = enc.encode(f.tobytes() if raw else f, 48, 64, comps, bits)
        cs = j2k.parse_codestream(s)
        cod1 = dataclasses.replace(cs.cod, progression=1)
        sot1 = s.index(struct.pack(">HHH", j2k.SOT, 10, 1))
        body1 = cs.tiles[1].data
        cod_seg = j2k.write_cod(cod1)
        psot = 12 + len(cod_seg) + 2 + len(body1)
        tile1 = struct.pack(">HHHIBB", j2k.SOT, 10, 1, psot, 0, 1)
        tile1 += cod_seg + struct.pack(">H", j2k.SOD) + body1
        streams.append(s[:sot1] + tile1 + j2k.EOC.to_bytes(2, "big"))
    return streams


@pytest.mark.parametrize("case", ["gray", "rgb_mct"])
def test_decode_frames_sharded_per_tile_cod_override(case, mesh):
    """Per-tile COD overrides shard through the heterogeneous path; an
    RGB tile that is homogeneous in the scalar sense takes the whole-tile
    stage with the inverse RCT. Bit-identical to both packages and the
    source."""
    if case == "gray":
        frames = _smooth((3, 64, 48), 4096)
        streams = _per_tile_cod(frames, 1, 12)
    else:
        frames = _smooth((3, 64, 48, 3), 256).astype(np.uint8)
        streams = _per_tile_cod(frames, 3, 8, raw=True)
    got = pmesh.decode_frames_sharded(streams, mesh=mesh)
    for d, s, f in zip(got, streams, frames):
        np.testing.assert_array_equal(d, rj.J2KDecoder().decode(s)[0])
        np.testing.assert_array_equal(
            d, pj.J2KDecoder(device=CPU).decode(s)[0])
        np.testing.assert_array_equal(
            d if case == "rgb_mct" else d[..., 0], f)


def test_decode_frames_sharded_qcc_override_rgb_ict(mesh):
    """A lossy RGB stream with a chroma QCC override shards through the
    heterogeneous path's whole-tile stage with the inverse ICT: within
    ±1 of both reference decodes."""
    frames = _smooth((3, 64, 64, 3), 256).astype(np.uint8)
    enc = rj.J2KEncoder(rj.J2KEncodeParams(num_levels=3, lossless=False,
                                           quality=90))
    streams = []
    for f in frames:
        s = enc.encode(f.tobytes(), 64, 64, 3, 8)
        cs = j2k.parse_codestream(s)
        qcd2 = dataclasses.replace(
            cs.qcd, steps=[(e, max(m - 64, 0)) for (e, m) in cs.qcd.steps])
        sot0 = s.index(struct.pack(">HHH", j2k.SOT, 10, 0))
        streams.append(s[:sot0] + j2k.write_qcc(2, qcd2, 3) + s[sot0:])
    got = pmesh.decode_frames_sharded(streams, mesh=mesh)
    want = rmesh.decode_frames_sharded(streams, mesh=rmesh.make_mesh())
    for d, w, s in zip(got, want, streams):
        for other in (w, rj.J2KDecoder().decode(s)[0]):
            assert np.abs(d.astype(np.int64)
                          - other.astype(np.int64)).max() <= 1


def test_decode_frames_sharded_mixed_batch_raises(mesh):
    """A batch mixing a uniform stream with a heterogeneous one raises in
    either order, as the reference does."""
    from test_sharding import _remux_two_component

    rng = np.random.default_rng(1234)
    a = rng.integers(0, 1 << 16, (64, 64), dtype=np.uint16)
    b = rng.integers(0, 1 << 16, (32, 32), dtype=np.uint16)
    uniform = rj.J2KEncoder(rj.J2KEncodeParams(num_levels=2)).encode(
        a.astype(np.int32), 64, 64, 1, 16)
    hetero = _remux_two_component(a, b, sub=True)
    for batch in ([uniform, hetero], [hetero, uniform]):
        with pytest.raises(RefUnsupported):
            rmesh.decode_frames_sharded(batch, mesh=rmesh.make_mesh())
        with pytest.raises(UnsupportedFormatError):
            pmesh.decode_frames_sharded(batch, mesh=mesh)
    with pytest.raises(UnsupportedFormatError):
        pmesh.decode_frames_sharded([hetero], mesh=mesh, reduce=1)
