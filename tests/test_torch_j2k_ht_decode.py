"""The HT cleanup decode of a pipelined .201 chunk on the card.

On the CPU: a plan of HT code-blocks (``codecs/jpeg2000.ht_blocks``,
``ops/j2k_ht_decode.make_plan``), decoded by the kernel's plain version
(the native batched decoder and the plan's paste), equals the blocks the
port's HT encoder was given, the native ``ht_cleanup_decode_blocks`` and
the benchmark's plain T.814 decoder (``bench_port/htj2k_reference.py``),
over block sizes from 1×1 to 64×64, 32×128 and 128×32, Kmax 1 to 30,
all-zero, one-sample, sparse and dense blocks; the plan refuses what
T.814 forbids of a cleanup segment; the decode pipeline sends a chunk of
cleanup-only HT streams to the card (here a lane that takes itself for a
card's) and its pixels equal ``decode_to_pixels``'; seeded mutations of
Scup, Lcup and a segment's bytes end in a refused plan, a stream error or
the host's pixels.

On the card (marked ``card``; they skip without one): csrc/j2k_ht_decode.cu
equals the plain version block for block, status included, on the same
blocks, frames and mutations, and a registry decode of a .201 series
launches the HT kernel and the inverse stage once a chunk. This file
imports no JAX: ``python -m pytest --noconftest -m card
tests/test_torch_j2k_ht_decode.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import go_dicom_codec_torch as gdc
from bench_port import htj2k_reference as R
from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch import pipeline as P
from go_dicom_codec_torch.codecs.ht_tables import DEC_LUT0, DEC_LUT1
from go_dicom_codec_torch.codecs.jpeg2000 import (J2KEncodeParams,
                                                  J2KEncoder,
                                                  decode_to_packed,
                                                  decode_to_pixels,
                                                  ht_blocks, t1_blocks)
from go_dicom_codec_torch.errors import CorruptStreamError
from go_dicom_codec_torch.native import (ht_cleanup_decode_blocks_native,
                                         ht_cleanup_encode_native)
from go_dicom_codec_torch.ops import j2k_ht_decode as H
from go_dicom_codec_torch.utils import profiling

CPU = torch.device("cpu")
CSRC = Path(_kernels.__file__).resolve().parent / "csrc"

SHAPES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (32, 128),
          (128, 32), (1, 1), (5, 7), (1, 64), (64, 1), (33, 31))
KMAXES = tuple(range(1, 31))
KINDS = ("dense", "one", "sparse", "zero")


def _block(rng, w, h, kmax, kind):
    lim = 1 << kmax
    if kind == "dense":
        return rng.integers(-lim + 1, lim, (h, w))
    d = np.zeros((h, w), np.int64)
    if kind == "one":
        d[rng.integers(h), rng.integers(w)] = \
            rng.choice([-1, 1]) * rng.integers(1, lim)
    elif kind == "sparse":
        d = rng.integers(-lim + 1, lim, (h, w)) * (rng.random((h, w)) < 0.1)
    return d


def _blocks(seed, w, h):
    """Seeded blocks of one size, every Kmax and kind, laid out side by
    side on one plane: (plan blocks, the coefficients, plane shape)."""
    rng = np.random.default_rng(seed)
    items, want = [], []
    for kmax in KMAXES:
        for kind in KINDS:
            d = _block(rng, w, h, kmax, kind)
            seg = ht_cleanup_encode_native(d.astype(np.int64), kmax)
            want.append(d)
            if seg:         # an all-zero block has no pass: not in a plan
                items.append((seg, w, h, kmax, kmax - 1, 0, 0,
                              w * (len(want) - 1)))
    plane = np.concatenate(want, axis=1)
    return items, plane, (1, h, plane.shape[1])


def _encode(px, levels=3, **params):
    h, w, comps = px.shape
    enc = J2KEncoder(J2KEncodeParams(num_levels=levels, htj2k=True,
                                     lossless=True, **params), device=CPU)
    return enc.encode(px, w, h, comps, 12, False)


def _frames(seed, n, size):
    """Seeded .201 frames of size², 12 bits, 5 levels at 128 and 3 at 64."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        walk = np.cumsum(rng.integers(-60, 61, (size, size, 1)), axis=1)
        px = ((walk + rng.integers(0, 4096)) % 4096).astype(np.int32)
        out.append(_encode(px, 5 if size >= 128 else 3))
    return out


def _plan(streams):
    frames = [ht_blocks(s) for s in streams]
    return H.chunk_plan([f[4] for f in frames], frames[0][0])


def _plain(plan):
    return H.ht_decode_plain(torch.from_numpy(plan.buf), plan.launch)


# ---- the plan on the CPU ------------------------------------------------------

@pytest.mark.parametrize("w,h", SHAPES)
def test_plan_equals_encoded_native_and_reference(w, h):
    """Every Kmax and kind of one block size: the plan's plain decode is
    the encoded coefficients, block for block the native batched decode's
    and the plain T.814 decoder's."""
    items, want, shape = _blocks(1000 * w + h, w, h)
    plan = H.make_plan(items, shape)
    got, status = _plain(plan)
    assert status.item() == 0
    assert got.dtype == torch.int32          # Kmax up to 30
    np.testing.assert_array_equal(got.numpy()[0], want)
    native = ht_cleanup_decode_blocks_native([it[:5] for it in items])
    for it, blk in zip(items, native):
        x = it[7]
        np.testing.assert_array_equal(blk, want[:, x:x + w])
        if w * h <= 1024 or it[3] in (1, 12, 30):
            np.testing.assert_array_equal(
                R.decode_cleanup(it[0], w, h, it[3], it[4]), want[:, x:x + w])


@pytest.mark.parametrize("missing", [0, 3, 9, 14])
def test_fewer_missing_msbs_read_alike(missing):
    """The same segments read with fewer missing MSBs than the encoder
    wrote (a cleanup pass above bit-plane 0): the plain version, the
    native decoder and the plain T.814 decoder agree, on the stream error
    too."""
    rng = np.random.default_rng(77 + missing)
    for kmax in (16, 20, 30):
        d = _block(rng, 16, 16, min(kmax, missing + 1), "dense")
        seg = ht_cleanup_encode_native(d.astype(np.int64),
                                       min(kmax, missing + 1))
        plan = H.make_plan([(seg, 16, 16, kmax, missing, 0, 0, 0)],
                           (1, 16, 16))
        got, status = _plain(plan)
        native = ht_cleanup_decode_blocks_native(
            [(seg, 16, 16, kmax, missing)])[0]
        try:
            ref = R.decode_cleanup(seg, 16, 16, kmax, missing)
        except R.StreamError:
            ref = None
        if isinstance(native, tuple):
            assert status.item() == 1 and ref is None
        else:
            assert status.item() == 0
            np.testing.assert_array_equal(got.numpy()[0], native)
            np.testing.assert_array_equal(ref, native)


def test_plan_refuses_malformed_segments_and_places():
    seg = ht_cleanup_encode_native(np.arange(16).reshape(4, 4), 5)
    ok = (seg, 4, 4, 5, 4, 0, 0, 0)
    H.make_plan([ok], (1, 4, 4))
    scup = (seg[-1] << 4) | (seg[-2] & 0xF)

    def with_scup(v):
        return seg[:-2] + bytes([(seg[-2] & 0xF0) | (v & 0xF), v >> 4])
    bad = [(b"", 4, 4, 5, 4, 0, 0, 0), (seg[-1:], 4, 4, 5, 4, 0, 0, 0),
           (with_scup(1),) + ok[1:], (with_scup(len(seg) + 1),) + ok[1:],
           (seg, 4, 4, 5, -1, 0, 0, 0), (seg, 4, 4, 31, 30, 0, 0, 0),
           (seg, 4, 4, 0, 0, 0, 0, 0), (seg, 4, 4, 5, 4, 1, 0, 0),
           (seg, 4, 4, 5, 4, 0, 1, 0), (seg, 4, 4, 5, 4, 0, 0, -1),
           (seg, 64, 128, 5, 4, 0, 0, 0)]
    big = bytes(5000) + bytes([0x0F, 0xFF])   # Scup 4095 of 5002 bytes
    bad.append((big, 4, 4, 5, 4, 0, 0, 0))
    assert scup >= 2
    for b in bad:
        with pytest.raises(_kernels.KernelLaunchError):
            H.make_plan([b], (1, 4, 4) if b[1] == 4 else (1, 128, 64))


def test_plan_records_sorted_by_work_and_dtype():
    items, _, shape = _blocks(3, 8, 8)
    small, _, _ = _blocks(4, 4, 4)
    items = items[:5] + [it[:7] + (0,) for it in small[:5]]
    plan = H.make_plan(items, shape)
    rec, _ = H.records(plan.buf, plan.launch)
    quads = ((rec[:, H.W] + 1) // 2) * ((rec[:, H.H] + 1) // 2)
    assert (np.diff(quads) <= 0).all()
    assert plan.launch.narrow                  # Kmax 1 to 5
    assert plan.launch.max_words == int(H.block_words(
        rec[:, H.W], rec[:, H.H], rec[:, H.LEN], rec[:, H.SCUP]).max())
    wide, _, _ = _blocks(5, 4, 4)
    assert not H.make_plan(wide, (1, 4, 4 * 120)).launch.narrow


def test_block_words_stay_under_the_launch_limit():
    """The most shared memory any block T.800 allows can take, at a Scup
    of 4079 and any Lcup, is under what a launch gets without opting in."""
    worst = max(int(H.block_words(w, h, 1 << 20, H.MAX_SCUP))
                for w in (1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
                for h in (1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
                if w * h <= 4096)
    assert worst <= _kernels.HT_MAX_WORDS
    assert 4 * _kernels.HT_MAX_WORDS <= 48 * 1024


def test_kernel_tables_are_the_decoder_luts():
    """The VLC tables copied into csrc/j2k_ht_decode.cu are
    codecs/ht_tables.py's."""
    src = (CSRC / "j2k_ht_decode.cu").read_text()
    body = re.search(r"kDecLut\[2\]\[1024\] = \{(.*?)\};", src, re.S)
    values = [int(v, 16) for v in re.findall(r"0x[0-9A-F]+", body.group(1))]
    assert values == list(DEC_LUT0) + list(DEC_LUT1)


@pytest.mark.parametrize("size", [64, 128])
def test_frame_plans_equal_the_packed_coefficients(size):
    streams = _frames(size, 2, size)
    wants = [decode_to_packed(s)[0] for s in streams]
    for s, want in zip(streams, wants):
        assert t1_blocks(s) is None
        got, status = _plain(_plan([s]))
        assert status.item() == 0
        np.testing.assert_array_equal(got.numpy(), want)
        shape, _, _, _, blocks = ht_blocks(s)
        for seg, w, h, kmax, missing, c, row, col in blocks[::7]:
            np.testing.assert_array_equal(
                R.decode_cleanup(seg, w, h, kmax, missing),
                want[c, row:row + h, col:col + w])
    got, _ = _plain(_plan(streams))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(wants))


def test_refined_streams_stay_on_the_host():
    px = _frames_px(7, 48)
    s = _encode(px, ht_refinement=True)
    assert ht_blocks(s) is None and t1_blocks(s) is None


def _frames_px(seed, size):
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.integers(-60, 61, (size, size, 1)), axis=1)
    return ((walk + 2048) % 4096).astype(np.int32)


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


def _pixels(streams):
    return [np.frombuffer(decode_to_pixels(s, device=CPU)[0], "<u2")
            for s in streams]


@pytest.mark.parametrize("size,chunk", [(64, 2), (128, 3)])
def test_card_route_takes_ht_cleanup_chunks(size, chunk, card_lane):
    streams = _frames(size + 1, 5, size)
    card_lane.clear()
    got = P.decode_frames_pipelined(streams, chunk=chunk, engine="device",
                                    device=CPU)
    counts = dict(card_lane)
    for g, w in zip(got, _pixels(streams)):
        np.testing.assert_array_equal(g.ravel(), w)
    assert counts["ht.device_blocks"] == sum(len(ht_blocks(s)[4])
                                             for s in streams)
    assert counts.get("t1.device_blocks", 0) == 0
    assert counts.get("t1.blocks", 0) == 0      # no HT T1 on the host
    assert counts["pipeline.chunks"] == -(-len(streams) // chunk)


def test_counted_blocks_are_the_plans(card_lane):
    """``ht.device_blocks`` counts the plan's blocks; the plan's build is
    the span ``j2k.ht_plan``, once a chunk, inside the host stage."""
    streams = _frames(9, 3, 64)
    card_lane.clear()
    profiling.GLOBAL_TIMER.drain()
    P.decode_frames_pipelined(streams, chunk=3, engine="device", device=CPU)
    assert card_lane["ht.device_blocks"] == _plan(streams).launch.blocks
    spans = profiling.GLOBAL_TIMER.drain()["spans"]
    by_id = {s["id"]: s for s in spans}
    plans = [s for s in spans if s["name"] == "j2k.ht_plan"]
    assert len(plans) == 1
    assert by_id[plans[0]["parent"]]["name"] == "pipeline.host_stage"


def test_registry_decode_takes_the_card_route(card_lane):
    """A .201 series through make_registry: the pipelined adapter."""
    info = gdc.FrameInfo(width=64, height=64, bits_allocated=16,
                         bits_stored=12)
    src = gdc.MemoryPixelData(info=info)
    for k in range(4):
        src.add_frame(_frames_px(20 + k, 64).astype("<u2").tobytes())
    codec = gdc.make_registry(CPU, engine="device").get_codec(
        gdc.uids.HTJ2K_LOSSLESS)
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    card_lane.clear()
    dec = gdc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    for k in range(4):
        assert dec.get_frame(k) == src.get_frame(k)
    assert card_lane["ht.device_blocks"] > 0
    assert card_lane.get("adapter.fallbacks", 0) == 0


# ---- hostile segments ---------------------------------------------------------

def _mutations(seed, trials):
    """Seeded mutants of two 64² .201 frames: one block's segment given
    another Scup, other last two bytes, or some bytes of its own changed;
    each (mutant streams, what was done)."""
    rng = np.random.default_rng(seed)
    base = _frames(seed, 2, 64)
    out = []
    for t in range(trials):
        k = int(rng.integers(2))
        s = bytearray(base[k])
        blocks = ht_blocks(bytes(s))[4]
        seg = blocks[int(rng.integers(len(blocks)))][0]
        at = bytes(s).find(seg)
        end = at + len(seg)
        how = ("scup", "tail", "bytes")[t % 3]
        if how == "scup":
            v = int(rng.choice([0, 1, 2, 3, len(seg) - 1, len(seg),
                                len(seg) + 1, 4079, 4095,
                                int(rng.integers(4096))]))
            s[end - 2] = (s[end - 2] & 0xF0) | (v & 0xF)
            s[end - 1] = v >> 4
        elif how == "tail":
            s[end - 2:end] = bytes(rng.integers(0, 256, 2).tolist())
        else:
            for i in rng.integers(at, end, int(rng.integers(1, 4))):
                s[i] = int(rng.integers(256))
        streams = list(base)
        streams[k] = bytes(s)
        out.append((streams, how))
    return out


def _host_outcome(streams):
    try:
        return _pixels(streams)
    except CorruptStreamError:
        return "corrupt"


def _check_outcome(codec_decode, streams, host):
    """The adapter's outcome of a mutant series: a refused plan, a stream
    error, or the host's pixels."""
    try:
        got = codec_decode(streams)
    except (_kernels.KernelLaunchError, CorruptStreamError):
        return
    assert not isinstance(host, str), "the host refused what decoded"
    for g, w in zip(got, host):
        np.testing.assert_array_equal(np.frombuffer(g, "<u2"), w)


def _adapter(device):
    codec = gdc.make_registry(device, engine="device").get_codec(
        gdc.uids.HTJ2K_LOSSLESS)
    info = gdc.FrameInfo(width=64, height=64, bits_allocated=16,
                         bits_stored=12)

    def decode(streams):
        enc = gdc.MemoryPixelData(info=info, encapsulated=True)
        for s in streams:
            enc.add_frame(s)
        dec = gdc.MemoryPixelData(info=info)
        codec.decode(enc, dec)
        return [dec.get_frame(k) for k in range(len(streams))]
    return decode


def test_hostile_segments_end_refused_or_as_the_host(card_lane):
    decode = _adapter(CPU)
    for streams, _ in _mutations(31, 30):
        _check_outcome(decode, streams, _host_outcome(streams))


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _on_card(plan, card):
    want, want_status = _plain(plan)
    got, status = H.ht_decode(torch.from_numpy(plan.buf).to(card),
                              plan.launch)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    assert status.item() == want_status.item()
    if not want_status.item():
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.card
@pytest.mark.parametrize("w,h", SHAPES)
def test_kernel_matches_plain_on_blocks(w, h, card):
    items, want, shape = _blocks(1000 * w + h, w, h)
    _on_card(H.make_plan(items, shape), card)
    narrow = [it for it in items if it[3] <= 15]
    _on_card(H.make_plan(narrow, shape), card)


@pytest.mark.card
@pytest.mark.parametrize("missing", [0, 3, 9, 14])
def test_kernel_matches_plain_with_fewer_missing_msbs(missing, card):
    rng = np.random.default_rng(77 + missing)
    for kmax in (16, 20, 30):
        k = min(kmax, missing + 1)
        seg = ht_cleanup_encode_native(
            _block(rng, 16, 16, k, "dense").astype(np.int64), k)
        _on_card(H.make_plan([(seg, 16, 16, kmax, missing, 0, 0, 0)],
                             (1, 16, 16)), card)


@pytest.mark.card
@pytest.mark.parametrize("size", [64, 128])
def test_kernel_matches_plain_on_frames(size, card):
    streams = _frames(size, 4, size)
    for s in streams:
        _on_card(_plan([s]), card)
    _on_card(_plan(streams), card)


@pytest.mark.card
def test_kernel_matches_plain_on_mutated_segments(card):
    """Every mutant's blocks, read as the plan takes them (a refused plan
    is the plan's own test), equal on the card, status included."""
    for streams, _ in _mutations(31, 30):
        for s in streams:
            try:
                got = ht_blocks(s)
                plan = None if got is None else _plan([s])
            except Exception:   # noqa: BLE001 - T2 or the plan refused it
                continue
            if plan is not None:
                _on_card(plan, card)


@pytest.mark.card
def test_hostile_segments_on_the_card(card):
    decode = _adapter(card)
    for streams, _ in _mutations(31, 30):
        _check_outcome(decode, streams, _host_outcome(streams))


@pytest.mark.card
def test_pipelined_decode_on_the_card(card):
    """A registry .201 decode of 32 frames: one HT launch and one stage
    launch a chunk of 8, no host T1, the frames exact."""
    info = gdc.FrameInfo(width=128, height=128, bits_allocated=16,
                         bits_stored=12)
    src = gdc.MemoryPixelData(info=info)
    for k in range(32):
        src.add_frame(_frames_px(40 + k, 128).astype("<u2").tobytes())
    codec = gdc.make_registry(card, engine="device").get_codec(
        gdc.uids.HTJ2K_LOSSLESS)
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    _kernels.reset_launch_counts()
    rec = profiling.enable_global_timer()
    try:
        dec = gdc.MemoryPixelData(info=info)
        codec.decode(enc, dec)
    finally:
        profiling.GLOBAL_TIMER = None
    for k in range(32):
        assert dec.get_frame(k) == src.get_frame(k)
    assert _kernels.launch_counts["j2k_ht_decode"] == 4
    assert _kernels.launch_counts["j2k_inv_stage"] == 4
    assert _kernels.launch_counts["j2k_t1_decode"] == 0
    assert rec.counts.get("t1.blocks", 0) == 0
    assert rec.counts["ht.device_blocks"] > 0


@pytest.mark.card
def test_refused_launch_raises(card):
    plan = _plan(_frames(3, 1, 64))
    buf = torch.from_numpy(plan.buf).to(card)
    out = torch.empty(plan.launch.shape, dtype=torch.int32, device=card)
    status = torch.empty(1, dtype=torch.int32, device=card)
    with pytest.raises(_kernels.KernelLaunchError):
        _kernels.j2k_ht_decode(buf, out, status, plan.launch)
    with pytest.raises(_kernels.KernelLaunchError):
        _kernels.j2k_ht_decode(buf[:plan.launch.data_at - 1],
                               torch.empty_like(out, dtype=torch.int16),
                               status, plan.launch)
