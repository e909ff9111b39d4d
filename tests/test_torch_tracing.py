"""The port's recorder (``utils.profiling``): spans and counters.

Off by default, where ``span()`` hands back one shared no-op; safe under
concurrent client threads; and the span trees and counters the CPU
registry paths record, which the benchmark's span readers
(``bench_port/spans.py``) rely on.
"""

import sys
import threading
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import go_dicom_codec_torch as port
from go_dicom_codec_torch.utils import profiling

CPU = torch.device("cpu")
UID = port.uids.JPEG_2000_LOSSLESS


def _info(frames):
    return port.FrameInfo(width=frames.shape[2], height=frames.shape[1],
                          bits_allocated=16, bits_stored=12)


def _raw(frames):
    src = port.MemoryPixelData(info=_info(frames))
    for f in frames:
        src.add_frame(f.astype("<u2").tobytes())
    return src


def _encode(frames, registry=None, parameters=None):
    enc = port.MemoryPixelData(info=_info(frames), encapsulated=True)
    (registry or port.make_registry(CPU)).get_codec(UID).encode(
        _raw(frames), enc, parameters)
    return enc


def _decode(enc, registry=None):
    dec = port.MemoryPixelData(info=enc.get_frame_info())
    (registry or port.make_registry(CPU)).get_codec(UID).decode(enc, dec)
    return dec


def _frames(rng, n, h=32, w=48):
    return (np.cumsum(rng.integers(-9, 10, (n, h, w)), axis=2)
            % 4096).astype(np.int32)


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder installed for the test; the global is restored
    afterwards."""
    rec = profiling.StageTimer()
    monkeypatch.setattr(profiling, "GLOBAL_TIMER", rec)
    return rec


def _paths(spans):
    """Each span's chain of names from the outermost, joined by '/'."""
    by_id = {s["id"]: s for s in spans}

    def path(s):
        names = [s["name"]]
        while s["parent"] is not None:
            s = by_id[s["parent"]]
            names.append(s["name"])
        return "/".join(reversed(names))
    return Counter(path(s) for s in spans)


def test_off_records_nothing(monkeypatch, rng):
    """With no recorder installed a .90 round trip records nothing, and
    ``span()`` is the shared no-op."""
    rec = profiling.StageTimer()
    monkeypatch.setattr(profiling, "GLOBAL_TIMER", None)
    assert profiling.span("codec.decode", frames=3) is profiling.NO_SPAN
    with profiling.span("x") as sp:
        sp.set(route="scalar")
    profiling.count("frames.decode")
    frames = _frames(rng, 3)
    dec = _decode(_encode(frames))
    assert dec.get_frame(0) == frames[0].astype("<u2").tobytes()
    assert rec.drain() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("threads", [4, 16])
def test_threads_keep_their_own_chains(recorder, threads):
    """Client threads recording nested spans at once lose no record; each
    keeps its own parent chain and call id, and thread CPU <= wall."""
    calls, depth = 50, 3
    barrier = threading.Barrier(threads)

    def client():
        barrier.wait()
        for _ in range(calls):
            with profiling.span("codec.decode"):
                with profiling.span("pipeline.host_stage"):
                    with profiling.span("j2k.t1", threads=1):
                        sum(range(200))
            profiling.count("frames.decode")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=client) for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in workers)
    out = recorder.drain()
    spans = out["spans"]
    assert len(spans) == threads * calls * depth
    assert out["counters"] == {"frames.decode": threads * calls}
    assert len({s["id"] for s in spans}) == len(spans)
    by_id = {s["id"]: s for s in spans}
    assert len({s["tid"] for s in spans}) == threads
    for s in spans:
        up = by_id.get(s["parent"])
        if s["name"] == "codec.decode":
            assert up is None and s["call"] == s["id"]
        else:
            assert up["tid"] == s["tid"] and up["call"] == s["call"]
            assert up["t0"] <= s["t0"] <= s["t1"] <= up["t1"]
        assert 0 <= s["cpu1"] - s["cpu0"] <= s["t1"] - s["t0"] + 1e-3
    assert _paths(spans) == {
        "codec.decode": threads * calls,
        "codec.decode/pipeline.host_stage": threads * calls,
        "codec.decode/pipeline.host_stage/j2k.t1": threads * calls}
    assert recorder.drain()["spans"] == []


def test_log_event_counts_under_threads(recorder):
    """Four threads x 1000 ``log_event`` calls count 4000."""
    def client():
        for _ in range(1000):
            profiling.log_event("pipeline.decode", {"engine": "device"})

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=client) for _ in range(4)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in workers)
    assert recorder.counts["pipeline.decode"] == 4000


PIPELINED = {"codec.decode/pipeline.host_stage/j2k.frame/j2k.parse",
             "codec.decode/pipeline.host_stage/j2k.frame/j2k.t2",
             "codec.decode/pipeline.host_stage/j2k.frame/j2k.t1",
             "codec.decode/pipeline.submit", "codec.decode/pipeline.wait",
             "codec.decode/pipeline.readback", "codec.decode/adapter.pack"}


@pytest.mark.parametrize("case,nframes,engine,route,want,parses", [
    ("series-decode", 3, "auto", "pipelined", PIPELINED, 2),
    ("frame-decode", 1, "device", "scalar",
     {"codec.decode/j2k.frame/j2k.parse", "codec.decode/j2k.frame/j2k.t2",
      "codec.decode/j2k.frame/j2k.t1",
      "codec.decode/j2k.frame/device.stage"}, 1),
    ("series-encode", 3, "device", "pipelined",
     {"codec.encode/j2k.frame/j2k.t1", "codec.encode/j2k.frame/j2k.t2",
      "codec.encode/pipeline.submit", "codec.encode/pipeline.wait",
      "codec.encode/pipeline.readback"}, 0),
    ("frame-encode", 1, "device", "scalar",
     {"codec.encode/j2k.frame/j2k.t1", "codec.encode/j2k.frame/j2k.t2",
      "codec.encode/j2k.frame/device.stage"}, 0),
])
def test_registry_paths_record_their_trees(monkeypatch, rng, case, nframes,
                                           engine, route, want, parses):
    """The documented span tree of each CPU registry path, one
    ``codec.<op>`` span a call with its frames and route, and the
    counters."""
    op = case.split("-")[1]
    frames = _frames(rng, nframes)
    registry = port.make_registry(CPU, engine)
    enc = _encode(frames, registry) if op == "decode" else None
    rec = profiling.StageTimer()
    monkeypatch.setattr(profiling, "GLOBAL_TIMER", rec)
    if op == "decode":
        dec = _decode(enc, registry)
        assert dec.get_frame(nframes - 1) == \
            frames[-1].astype("<u2").tobytes()
    else:
        _encode(frames, registry)
    out = rec.drain()
    paths = _paths(out["spans"])
    assert want <= set(paths)
    roots = [s for s in out["spans"] if s["parent"] is None]
    assert [(s["name"], s["attrs"]) for s in roots] == [
        (f"codec.{op}", {"frames": nframes, "route": route})]
    assert all(s["call"] == roots[0]["id"] for s in out["spans"])
    assert paths[f"codec.{op}/j2k.frame"] + paths[
        f"codec.{op}/pipeline.host_stage/j2k.frame"] == nframes
    t1 = [s for s in out["spans"] if s["name"] == "j2k.t1"]
    assert t1 and all(s["attrs"]["threads"] >= 1 for s in t1)
    c = out["counters"]
    assert c[f"frames.{op}"] == nframes
    assert c["t1.blocks"] > 0 and c.get("t1.scalar_blocks", 0) == 0
    assert c.get("j2k.parses", 0) == parses * nframes
    assert c.get("adapter.fallbacks", 0) == 0
    assert c.get("pipeline.chunks", 0) == (
        -(-nframes // (8 if op == "decode" else 2))
        if route == "pipelined" else 0)


def test_a_series_the_pipeline_cannot_batch_counts_a_fallback(recorder,
                                                              rng):
    """Multi-tile streams leave the decode pipeline for the scalar path:
    one ``adapter.fallbacks``, and the call's route reads scalar."""
    frames = _frames(rng, 2)
    enc = _encode(frames, parameters=port.Parameters(tile_width=16,
                                                     tile_height=16))
    recorder.drain()
    dec = _decode(enc)
    assert dec.get_frame(1) == frames[1].astype("<u2").tobytes()
    out = recorder.drain()
    assert out["counters"]["adapter.fallbacks"] == 1
    root = [s for s in out["spans"] if s["parent"] is None]
    assert [s["attrs"]["route"] for s in root] == ["scalar"]
