"""The T1 decode of a pipelined .90 chunk on the card.

On the CPU: a chunk's plan (``codecs/jpeg2000.t1_blocks``,
``ops/j2k_t1_decode.make_plan``), decoded by the native batched coder and
placed by the plan's own offsets, equals ``decode_to_packed`` frame for
frame; the decode pipeline gives the card a chunk's T1 only for
reversible MQ streams at full resolution with no ROI shift, whatever the
chunk's count of code-blocks (the route runs here on a lane that takes
itself for a card's and runs the kernels' plain versions).

On the card (marked ``card``; they skip without one): csrc/j2k_t1_decode.cu
equals the plain version block for block over code-block styles and their mixes, layered and truncated
streams, ragged, one-row and one-column blocks, empty blocks, numbps 1 to
30, 8-, 12- and 16-bit samples with and without sign and RGB with the
RCT; a pipelined decode through the card's route equals
``J2KDecoder.decode`` frame for frame, with one T1 launch a chunk. This
file imports no JAX, so a machine without JAX runs it without the
suite's conftest:
``python -m pytest --noconftest -m card tests/test_torch_j2k_t1_decode.py``.
"""

import numpy as np
import pytest
import torch

from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch import pipeline as P
from go_dicom_codec_torch.codecs.j2k_roi import ROIRegion
from go_dicom_codec_torch.codecs.jpeg2000 import (J2KDecoder,
                                                  J2KEncodeParams, J2KEncoder,
                                                  decode_to_packed, ht_blocks,
                                                  t1_blocks)
from go_dicom_codec_torch.ops import j2k_t1_decode as T
from go_dicom_codec_torch.tools.device_bench import t1_streams
from go_dicom_codec_torch.utils import profiling

CPU = torch.device("cpu")


def _walk(seed, h, w, comps, bits, signed, step=60):
    """Seeded rows of a noisy random walk over the whole depth."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.integers(-step, step + 1, (h, w, comps)), axis=1)
    walk += rng.integers(0, 1 << bits, (1, 1, comps))
    lo = -(1 << (bits - 1)) if signed else 0
    return (walk % (1 << bits) + lo).astype(np.int32)


def _encode(px, bits, signed=False, **params):
    h, w, comps = px.shape
    enc = J2KEncoder(J2KEncodeParams(**{"num_levels": 3, **params}),
                     device=CPU)
    return enc.encode(px, w, h, comps, bits, signed)


def _phantom(n):
    return t1_streams(n, 1618033988)


def _series(seed, n, h, w, comps=1, bits=12, signed=False, **params):
    return [_encode(_walk(seed + k, h, w, comps, bits, signed), bits, signed,
                    **params) for k in range(n)]


def _empty():
    px = np.zeros((64, 72, 1), np.int32)
    px[20:30, 40:52] = _walk(9, 10, 12, 1, 12, False)
    return [_encode(px, 12, cb_width=16, cb_height=16)]


STYLES = (0, 1, 2, 4, 8, 0x20, 1 | 2, 1 | 4, 1 | 8, 2 | 0x20, 4 | 8,
          1 | 2 | 4 | 8 | 0x20)

# name → streams; the CPU tests take some, the card every one
CORPUS = {
    "phantom": lambda: _phantom(2),
    **{f"style{s:#04x}": (lambda s=s: _series(s, 2, 70, 90, cb_width=32,
                                              cb_height=32, cb_style=s))
       for s in STYLES},
    "layers": lambda: _series(40, 2, 64, 80, num_layers=3,
                              layer_rates=[24.0, 8.0, 3.0], cb_style=1),
    "truncated": lambda: _series(41, 2, 64, 80, target_ratio=6.0,
                                 cb_width=16, cb_height=32),
    "ragged": lambda: _series(42, 2, 37, 61, cb_width=16, cb_height=8),
    "row": lambda: _series(43, 2, 1, 300, num_levels=2),
    "column": lambda: _series(44, 2, 150, 1, num_levels=2),
    "empty": _empty,
    **{f"depth{b}": (lambda b=b: _series(100 + b, 1, 40, 44, bits=b,
                                         signed=b % 2 == 0, cb_width=16,
                                         cb_height=16))
       for b in range(1, 30)},
    "gray8": lambda: _series(50, 2, 48, 56, bits=8),
    "gray8s": lambda: _series(51, 2, 48, 56, bits=8, signed=True),
    "gray12s": lambda: _series(52, 2, 48, 56, bits=12, signed=True),
    "gray16": lambda: _series(53, 2, 48, 56, bits=16),
    "gray16s": lambda: _series(54, 2, 48, 56, bits=16, signed=True),
    "rgb8": lambda: _series(55, 2, 40, 52, comps=3, bits=8),
    "rgb12-odd": lambda: _series(56, 2, 33, 45, comps=3, bits=12,
                                 cb_width=16, cb_height=16),
}
CPU_CASES = ("phantom", "layers", "truncated", "rgb8", "style0x01",
             "style0x2f", "ragged", "depth29")


def _plan(stream):
    shape, _, _, _, blocks = t1_blocks(stream)
    return T.make_plan(blocks, shape)


def _chunk_plan(streams):
    """One plan of every frame of ``streams``, as the pipeline makes it."""
    frames = [t1_blocks(s) for s in streams]
    return T.chunk_plan([f[4] for f in frames], frames[0][0])


# ---- the plan on the CPU ------------------------------------------------------

@pytest.mark.parametrize("case", CPU_CASES)
def test_plan_decodes_to_the_packed_coefficients(case):
    """The plan of each frame, decoded by the native batched call and
    pasted by the plan's offsets, is decode_to_packed's array; the plan of
    the whole chunk is every frame's."""
    streams = CORPUS[case]()
    wants = [decode_to_packed(s)[0] for s in streams]
    for s, want in zip(streams, wants):
        plan = _plan(s)
        got = T.t1_decode_plain(torch.from_numpy(plan.buf), plan.launch)
        assert got.dtype == (torch.int16 if plan.launch.narrow
                             else torch.int32)
        np.testing.assert_array_equal(got.numpy(), want)
    plan = _chunk_plan(streams)
    got = T.t1_decode_plain(torch.from_numpy(plan.buf), plan.launch)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(wants))


def test_plan_records_sorted_by_work_and_dtype():
    plan = _chunk_plan(CORPUS["phantom"]())
    rec, _, _ = T.records(plan.buf, plan.launch)
    work = rec[:, T.PASSES] * rec[:, T.W] * rec[:, T.H]
    assert (np.diff(work) <= 0).all()
    assert plan.launch.blocks == 140 and plan.launch.narrow
    assert plan.launch.max_words == T.block_words(64, 64)
    wide = _plan(CORPUS["depth20"]()[0])
    assert not wide.launch.narrow


def test_plan_refuses_blocks_outside_its_limits():
    blk = (b"\x00", 4, 4, 0, 1, 3, [], 0, 0, 0, 0)
    T.make_plan([blk], (1, 4, 4))
    for bad in ((b"", 4, 4, 0, 1, 31, [], 0, 0, 0, 0),
                (b"", 4, 4, 0, 1, 3, [], 0, 0, 1, 0),
                (b"", 4, 4, 0, 1, 3, [], 0, 1, 0, 0),
                (b"", 64, 128, 0, 1, 3, [], 0, 0, 0, 0)):
        with pytest.raises(_kernels.KernelLaunchError):
            T.make_plan([bad], (1, 4, 4) if bad[1] == 4 else (1, 128, 64))


# ---- the route, on a lane that takes itself for a card's --------------------

class _CardLane(P._Lane):
    """A CPU lane that answers the route as a card's lane does; its chunks
    run at once on CPU tensors, through the kernels' plain versions."""

    def __init__(self, device, slots=2):
        super().__init__(CPU, slots)
        self.cuda = True

    def _submit(self, stage, arrays):
        self.cuda = False
        try:
            return super()._submit(stage, arrays)
        finally:
            self.cuda = True


@pytest.fixture
def card_lane(monkeypatch):
    """The card's route on the CPU; yields the recorder's counters."""
    monkeypatch.setattr(P, "_Lane", _CardLane)
    rec = profiling.enable_global_timer()
    try:
        yield rec.counts
    finally:
        profiling.GLOBAL_TIMER = None


def _scalar(streams, reduce=0):
    return [J2KDecoder(device=CPU, reduce=reduce).decode(s)[0]
            for s in streams]


@pytest.mark.parametrize("case,chunk", [("phantom", 2), ("rgb8", 1),
                                        ("style0x2f", 2), ("layers", 2)])
def test_card_route_takes_reversible_chunks(case, chunk, card_lane):
    streams = CORPUS[case]()
    card_lane.clear()   # the encode's counts
    got = P.decode_frames_pipelined(streams, chunk=chunk, engine="device",
                                    device=CPU)
    counts = dict(card_lane)
    for g, w in zip(got, _scalar(streams)):
        np.testing.assert_array_equal(g, w)
    blocks = sum(len(t1_blocks(s)[4]) for s in streams)
    assert counts["t1.device_blocks"] == blocks
    assert counts.get("t1.blocks", 0) == 0


def _ht():
    """HT code-blocks with SigProp and MagRef passes: the HT kernel takes
    cleanup passes alone, so these stay on the host."""
    return _series(60, 2, 48, 56, htj2k=True, ht_refinement=True)


def _lossy():
    return _series(61, 2, 48, 56, lossless=False)


def _roi():
    return _series(62, 2, 48, 56,
                   roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 24, 24))])


@pytest.mark.parametrize("make", [_ht, _lossy, _roi],
                         ids=["htj2k", "lossy", "roi"])
def test_card_route_leaves_other_streams_on_the_host(make, card_lane):
    streams = make()
    assert all(t1_blocks(s) is None and ht_blocks(s) is None
               for s in streams)
    card_lane.clear()
    got = P.decode_frames_pipelined(streams, engine="device", device=CPU)
    assert card_lane.get("t1.device_blocks", 0) == 0
    assert card_lane.get("ht.device_blocks", 0) == 0
    want = P.decode_frames_pipelined(streams, engine="device", device=CPU,
                                     chunk=1) if make is _lossy else \
        _scalar(streams)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_card_route_takes_htj2k_cleanup_chunks(card_lane):
    """HT code-blocks of cleanup passes alone go to the card's HT kernel
    (ops/j2k_ht_decode.py), none to the MQ one."""
    streams = _series(60, 2, 48, 56, htj2k=True)
    assert all(t1_blocks(s) is None for s in streams)
    card_lane.clear()
    got = P.decode_frames_pipelined(streams, engine="device", device=CPU)
    counts = dict(card_lane)
    for g, w in zip(got, _scalar(streams)):
        np.testing.assert_array_equal(g, w)
    assert counts.get("t1.device_blocks", 0) == 0
    assert counts["ht.device_blocks"] == sum(len(ht_blocks(s)[4])
                                             for s in streams)


def test_card_route_leaves_reduced_decodes_on_the_host(card_lane):
    streams = CORPUS["layers"]()
    card_lane.clear()
    got = P.decode_frames_pipelined(streams, engine="device", device=CPU,
                                    reduce=1)
    counts = dict(card_lane)
    for g, w in zip(got, _scalar(streams, reduce=1)):
        np.testing.assert_array_equal(g, w)
    assert counts.get("t1.device_blocks", 0) == 0
    assert counts["t1.blocks"] > 0


@pytest.mark.parametrize("case", ["small", "blank"])
def test_card_route_takes_chunks_of_few_blocks(case, card_lane):
    """A chunk of a few code-blocks, or of none with passes (a blank
    frame), goes to the card too."""
    if case == "small":
        streams = _series(63, 2, 16, 16, num_levels=1)
    else:
        streams = [_encode(np.zeros((16, 16, 1), np.int32), 12,
                           num_levels=1)] * 2
    blocks = [len(t1_blocks(s)[4]) for s in streams]
    assert max(blocks) < 8
    card_lane.clear()
    got = P.decode_frames_pipelined(streams, chunk=1, engine="device",
                                    device=CPU)
    counts = dict(card_lane)
    for g, w in zip(got, _scalar(streams)):
        np.testing.assert_array_equal(g, w)
    assert counts.get("t1.device_blocks", 0) == sum(blocks)
    assert counts.get("t1.blocks", 0) == 0
    assert counts["pipeline.chunks"] == len(streams)


def test_cpu_lane_keeps_the_host_stage():
    """The CPU lane, the host engine: decode_to_packed as before."""
    rec = profiling.enable_global_timer()
    try:
        streams = CORPUS["style0x01"]()
        for engine in ("device", "host"):
            got = P.decode_frames_pipelined(streams, engine=engine,
                                            device=CPU)
            for g, w in zip(got, _scalar(streams)):
                np.testing.assert_array_equal(g, w)
        assert rec.counts.get("t1.device_blocks", 0) == 0
    finally:
        profiling.GLOBAL_TIMER = None


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CORPUS))
def test_kernel_matches_plain(case, card):
    """Each frame's plan and the chunk's, block for block equal to the
    native batched decode."""
    streams = CORPUS[case]()
    for plan in [_plan(s) for s in streams] + [_chunk_plan(streams)]:
        want = T.t1_decode_plain(torch.from_numpy(plan.buf), plan.launch)
        buf = torch.from_numpy(plan.buf).to(card)
        times = torch.zeros((plan.launch.blocks, 2), dtype=torch.int64,
                            device=card)
        got = T.t1_decode(buf, plan.launch, times=times)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        t = times.cpu().numpy()
        assert (t[:, 1] >= t[:, 0]).all() and (t[:, 0] > 0).all()


@pytest.mark.card
@pytest.mark.parametrize("case", ["phantom", "rgb8", "layers", "truncated",
                                  "style0x2f", "gray16s", "ragged"])
def test_pipelined_decode_on_the_card(case, card):
    """Through the card's route equal to J2KDecoder.decode, one T1 launch
    and one stage launch a chunk."""
    streams = CORPUS[case]()
    _kernels.reset_launch_counts()
    rec = profiling.enable_global_timer()
    try:
        got = P.decode_frames_pipelined(streams, chunk=2, engine="device",
                                        device=card)
    finally:
        profiling.GLOBAL_TIMER = None
    for g, w in zip(got, _scalar(streams)):
        np.testing.assert_array_equal(g, w)
    blocks = sum(len(t1_blocks(s)[4]) for s in streams)
    chunks = -(-len(streams) // 2)
    assert _kernels.launch_counts["j2k_t1_decode"] == chunks
    assert rec.counts["t1.device_blocks"] == blocks
    assert _kernels.launch_counts["j2k_inv_stage"] == chunks


@pytest.mark.card
def test_refused_plan_raises(card):
    plan = _plan(CORPUS["style0x01"]()[0])
    buf = torch.from_numpy(plan.buf).to(card)
    out = torch.empty(plan.launch.shape, dtype=torch.int32, device=card)
    with pytest.raises(_kernels.KernelLaunchError):
        _kernels.j2k_t1_decode(buf, out, plan.launch)
    with pytest.raises(_kernels.KernelLaunchError):
        _kernels.j2k_t1_decode(buf[:plan.launch.data_at - 1],
                               torch.empty_like(out, dtype=torch.int16),
                               plan.launch)
