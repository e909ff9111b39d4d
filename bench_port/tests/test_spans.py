"""The span readers of ``bench_port/spans.py`` on synthetic runs: what
each reads, the cases that read None, that the parts of a call add up to
it, and idle gaps named by the span open over them."""

from __future__ import annotations

import pytest

from bench_port import spans as S

_ids = iter(range(1, 10_000))


def sp(name, t0, t1, parent=None, tid=1, cpu=None, **attrs):
    """A drained span; ``cpu`` defaults to the wall."""
    i = next(_ids)
    up = parent["call"] if parent is not None else i
    busy = t1 - t0 if cpu is None else cpu
    return {"name": name, "tid": tid, "id": i,
            "parent": parent["id"] if parent is not None else None,
            "call": up, "t0": t0, "t1": t1, "cpu0": 0.0, "cpu1": busy,
            "attrs": attrs}


def one_call(op="decode", t0=0.0, tid=1, threads=1):
    """A 10 s call of 4 frames: T1 3 s, T2 1 s, device waits 1.5 s, so
    4.5 s of Python; the thread ran 6 s of it, 0.1 s inside the waits."""
    root = sp(f"codec.{op}", t0, t0 + 10, tid=tid, cpu=6.0, frames=4)
    host = sp("pipeline.host_stage", t0 + 0.5, t0 + 5.5, root, tid)
    frame = sp("j2k.frame", t0 + 0.6, t0 + 5.4, host, tid)
    return [root, host, frame,
            sp("j2k.parse", t0 + 0.6, t0 + 0.9, frame, tid),
            sp("j2k.t1", t0 + 1, t0 + 4, frame, tid, threads=threads),
            sp("j2k.t2", t0 + 4, t0 + 5, frame, tid),
            sp("pipeline.wait", t0 + 6, t0 + 7, root, tid, cpu=0.05),
            sp("device.stage", t0 + 7, t0 + 7.5, root, tid, cpu=0.05)]


def run_of(spans, lo=0.0, hi=10.0, calls=None, events=()):
    calls = calls if calls is not None else [
        {"client": 0, "op": "decode", "t0": 0.0, "t1": 10.0, "frames": 4,
         "ok": True}]
    return {"calls": calls, "spans": spans,
            "trace": {"t0": lo, "t1": hi, "events": list(events)}}


def test_the_parts_add_up_to_the_call():
    got = S.split_ms_per_frame(run_of(one_call()), "decode")
    assert got == pytest.approx({"codec": 2500.0, "t1": 750.0, "t2": 250.0,
                                 "device_wait": 375.0, "python": 1125.0})
    assert got["t1"] + got["t2"] + got["device_wait"] + got["python"] \
        == pytest.approx(got["codec"])
    reads = S.readings(run_of(one_call()), "decode")
    assert reads == pytest.approx({
        "t1_ms_per_frame.decode": 750.0,
        "host_python_ms_per_frame.decode": 1125.0,
        "device_wait_ms_per_frame.decode": 375.0,
        # (6 - 0.1) s of CPU over (10 - 1.5) s of wall
        "host_wait_share.decode": 100 * (1 - 5.9 / 8.5)})


def test_spans_are_clipped_to_the_stretch():
    """Stretch [2, 8]: 6 s of the call, 2.4 of its frames; T1 2 s, T2 1,
    the waits 1.5."""
    got = S.split_ms_per_frame(run_of(one_call(), lo=2.0, hi=8.0), "decode")
    k = 1e3 / 2.4
    assert got == pytest.approx({"codec": 6 * k, "t1": 2 * k, "t2": 1 * k,
                                 "device_wait": 1.5 * k,
                                 "python": 1.5 * k})


def test_a_wait_inside_a_wait_counts_once():
    spans = one_call()
    wait = spans[6]
    spans.append(sp("device.stage", 6.2, 6.8, wait))
    got = S.split_ms_per_frame(run_of(spans), "decode")
    assert got["device_wait"] == pytest.approx(375.0)


@pytest.mark.parametrize("case", ["no trace", "no spans", "other op",
                                  "no frames"])
def test_nothing_to_read_reads_none(case):
    run = run_of(one_call())
    if case == "no trace":
        run["trace"] = None
    elif case == "no spans":
        run.pop("spans")
    elif case == "other op":
        run = run_of(one_call("encode"))
    else:
        run["calls"] = []
    for read in S.READERS.values():
        assert read(run, "decode") is None
    assert S.readings(run, "decode") == {}


def test_the_wait_share_needs_one_native_thread():
    """A coder on more threads works off the calling thread: no wait
    share, the other readings stay."""
    run = run_of(one_call(threads=2))
    assert S.host_wait_share(run, "decode") is None
    assert set(S.readings(run, "decode")) == {
        "t1_ms_per_frame.decode", "host_python_ms_per_frame.decode",
        "device_wait_ms_per_frame.decode"}


def test_name_gap_takes_the_innermost_span_with_most_thread_time():
    a = sp("codec.decode", 0, 10, tid=1)
    b = sp("codec.decode", 0, 10, tid=2)
    host = sp("pipeline.host_stage", 1, 9, b, 2)
    spans = [a, sp("j2k.t1", 2, 6, a, 1), b, host,
             sp("j2k.t1", 3, 5, host, 2)]
    # over [2, 6]: j2k.t1 4 + 2 s, pipeline.host_stage 2 s, codec 0
    assert S.name_gap(spans, 2, 6) == "j2k.t1"
    # over [8.5, 10]: codec.decode 1.5 + 1 s, pipeline.host_stage 0.5 s
    assert S.name_gap(spans, 8.5, 10) == "codec.decode"
    assert S.name_gap(spans, 11, 12) is None


def test_breakdown_names_gaps_by_span_else_as_the_harness_does():
    """Device busy over [0, 1] and [4, 5] of [0, 12]: gaps [5, 12], [1, 4]
    and none else; a span is open over the second only."""
    spans = [sp("codec.decode", 0.5, 4.5)]
    spans.append(sp("j2k.t1", 1.0, 4.0, spans[0]))
    calls = [{"client": 0, "op": "decode", "t0": 0.5, "t1": 4.5,
              "frames": 1, "ok": True},
             {"client": 0, "op": "decode", "t0": 6.0, "t1": 11.0,
              "frames": 1, "ok": True}]
    run = run_of(spans, 0.0, 12.0, calls,
                 events=[("k", 0.0, 1.0), ("k", 4.0, 5.0)])
    got = S.breakdown(run)
    assert got["idle_gaps"] == [["codec.decode", 7.0], ["j2k.t1", 3.0]]
    assert got["device_ops"] == [["k", 2.0]]


def test_checks_hold_the_spans_to_the_harness_calls():
    calls, spans = [], []
    for i in range(12):
        t0 = 2.0 * i
        calls.append({"client": 0, "op": "decode", "t0": t0,
                      "t1": t0 + 1.0 + 0.1 * i, "frames": 4, "ok": True})
        spans.append(sp("codec.decode", t0 + 0.001, t0 + 0.999 + 0.1 * i))
    got = S.checks(run_of(spans, 0.0, 30.0, calls), "decode")
    assert got["calls"] == got["codec_spans"] == 12
    assert got["sum_ratio"] == pytest.approx(1.0, abs=0.01)
    assert got["p90_ratio"] == pytest.approx(1.0, abs=0.01)
    assert S.checks(run_of([], 0.0, 30.0, calls), "decode") is None
