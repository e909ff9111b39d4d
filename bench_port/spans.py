"""The program's own spans over the traced stretch: the host stage's and
the pipeline's per-layer readings, idle gaps named by the span open over
them, and a traced run with the program's recorder on.

    python3 -m bench_port.spans --workload <cell> --seed <n> --seconds <s>

runs the cell once as ``python3 -m bench_port.run ... --trace 1`` does,
with ``go_dicom_codec_torch.utils.profiling``'s recorder installed in each
worker just before the window and drained once its client has stopped,
and prints one JSON line: the harness's result, the readings below, the
idle gaps named by span, the checks of the spans against the harness's
own call times, the counters, and what a span costs. ``bench_port.run``
does not install the recorder, so its result lines hold none of these.

A run here is the harness's ``run`` with ``spans`` (the recorders'
drained records: ``name``, ``tid``, ``id``, ``parent``, ``call``, ``t0``,
``t1``, ``cpu0``, ``cpu1``, ``attrs``, and the ``worker`` that recorded
it, whose index is part of each id) and ``counters``. Every reading
clips the spans to the traced stretch and divides by the frames done
inside it (``arith.frames_within``), as ``copy_us_per_frame`` does. A
span belongs to ``op`` when the outermost span of its call is
``codec.<op>``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from typing import Optional

from . import arith

# the spans inside a codec call that are not host Python: the native
# coder, native T2, and the host blocked on the card
T1, T2 = "j2k.t1", "j2k.t2"
WAITS = ("pipeline.wait", "device.stage")
PARTS = (T1, T2) + WAITS


def _inside(s: dict, lo: float, hi: float) -> float:
    return arith.overlap(s["t0"], s["t1"], lo, hi)


def _of_op(spans: list, op: str) -> list:
    roots = {s["id"] for s in spans
             if s["id"] == s["call"] and s["name"] == f"codec.{op}"}
    return [s for s in spans if s["call"] in roots]


def _outermost_parts(spans: list) -> list:
    """The spans of ``PARTS`` that no other span of ``PARTS`` holds."""
    by_id = {s["id"]: s for s in spans}

    def held(s):
        up = by_id.get(s["parent"])
        while up is not None:
            if up["name"] in PARTS:
                return True
            up = by_id.get(up["parent"])
        return False
    return [s for s in spans if s["name"] in PARTS and not held(s)]


def _traced(run: dict, op: str):
    """(the op's spans, lo, hi, frames inside), or None."""
    tr, spans = run.get("trace"), run.get("spans")
    if tr is None or not spans:
        return None
    mine = _of_op(spans, op)
    frames = arith.frames_within(run["calls"], tr["t0"], tr["t1"], op)
    if not mine or frames <= 0:
        return None
    return mine, tr["t0"], tr["t1"], frames


def split_ms_per_frame(run: dict, op: str) -> Optional[dict]:
    """The wall of the ``codec.<op>`` spans a frame, in ms, and its parts:
    ``t1`` (the native coder, ``j2k.t1``), ``t2`` (native T2),
    ``device_wait`` (``pipeline.wait`` and ``device.stage``) and
    ``python``, the rest: parsing, assembly, packing and staging in Python
    and numpy. The four parts add up to ``codec``."""
    got = _traced(run, op)
    if got is None:
        return None
    mine, lo, hi, frames = got
    sums: dict = defaultdict(float)
    for s in _outermost_parts(mine):
        sums[s["name"]] += _inside(s, lo, hi)
    codec = sum(_inside(s, lo, hi) for s in mine if s["id"] == s["call"])
    wait = sum(sums[n] for n in WAITS)
    k = 1e3 / frames
    return {"codec": codec * k, "t1": sums[T1] * k, "t2": sums[T2] * k,
            "device_wait": wait * k,
            "python": (codec - sums[T1] - sums[T2] - wait) * k}


def t1_ms_per_frame(run: dict, op: str) -> Optional[float]:
    got = split_ms_per_frame(run, op)
    return None if got is None else got["t1"]


def host_python_ms_per_frame(run: dict, op: str) -> Optional[float]:
    got = split_ms_per_frame(run, op)
    return None if got is None else got["python"]


def device_wait_ms_per_frame(run: dict, op: str) -> Optional[float]:
    got = split_ms_per_frame(run, op)
    return None if got is None else got["device_wait"]


def host_wait_share(run: dict, op: str) -> Optional[float]:
    """Percent of the clients' ``codec.<op>`` wall, less the device waits
    inside, in which the client thread did not run: 100 × (1 − thread CPU
    / wall), each span's CPU taken by the share of its wall inside the
    stretch. None where a traced ``j2k.t1`` ran on more than one native
    thread: the coder then works off the calling thread."""
    got = _traced(run, op)
    if got is None:
        return None
    mine, lo, hi = got[:3]

    def wall_cpu(s):
        wall = s["t1"] - s["t0"]
        part = _inside(s, lo, hi)
        cpu = (s["cpu1"] - s["cpu0"]) * part / wall if wall > 0 else 0.0
        return part, cpu
    if any(s["name"] == T1 and s["attrs"].get("threads", 1) > 1
           and _inside(s, lo, hi) > 0 for s in mine):
        return None
    wall = cpu = 0.0
    for s in mine:
        if s["id"] == s["call"]:
            w, c = wall_cpu(s)
            wall, cpu = wall + w, cpu + c
    for s in _outermost_parts(mine):
        if s["name"] in WAITS:
            w, c = wall_cpu(s)
            wall, cpu = wall - w, cpu - c
    if wall <= 0:
        return None
    return 100.0 * (1.0 - cpu / wall)


READERS = {"t1_ms_per_frame": t1_ms_per_frame,
           "host_python_ms_per_frame": host_python_ms_per_frame,
           "host_wait_share": host_wait_share,
           "device_wait_ms_per_frame": device_wait_ms_per_frame}


def readings(run: dict, op: str) -> dict:
    """``{<metric>.<op>: value}`` of every reader that finds a value."""
    out = {}
    for name, read in READERS.items():
        value = read(run, op)
        if value is not None:
            out[f"{name}.{op}"] = value
    return out


def name_gap(spans: list, s: float, e: float) -> Optional[str]:
    """The name of the innermost spans with the most thread time over
    [s, e], summed over the threads; None where no span was open."""
    over = [x for x in spans if x["t1"] > s and x["t0"] < e]
    if not over:
        return None
    held: dict = defaultdict(float)
    for x in over:
        if x["parent"] is not None:
            held[x["parent"]] += _inside(x, s, e)
    own: dict = defaultdict(float)
    for x in over:
        own[x["name"]] += _inside(x, s, e) - held[x["id"]]
    return max(own, key=own.get)


def breakdown(run: dict) -> dict:
    """The harness's breakdown with each idle gap named by ``name_gap``
    where a program span was open over it."""
    from .run import breakdown as harness_breakdown

    out = harness_breakdown(run)
    tr = run["trace"]
    gaps = sorted(arith.gaps(tr["events"], tr["t0"], tr["t1"]),
                  key=lambda g: g[0] - g[1])[:10]
    out["idle_gaps"] = [
        [name_gap(run.get("spans") or [], s, e) or old, e - s]
        for (s, e), (old, _) in zip(gaps, out["idle_gaps"])]
    return out


def checks(run: dict, op: str) -> Optional[dict]:
    """The ``codec.<op>`` spans against the harness's own call records:
    their time inside the stretch, and their 90th percentiles over every
    call of the window."""
    tr, spans = run.get("trace"), run.get("spans")
    if tr is None or not spans:
        return None
    lo, hi = tr["t0"], tr["t1"]
    roots = [s for s in spans
             if s["id"] == s["call"] and s["name"] == f"codec.{op}"]
    calls = [c for c in run["calls"] if c["op"] == op]
    span_s = sum(_inside(s, lo, hi) for s in roots)
    call_s = sum(arith.overlap(c["t0"], c["t1"], lo, hi) for c in calls)
    span_p90 = arith.p90([(s["t1"] - s["t0"]) * 1e3 for s in roots])
    call_p90 = arith.p90([(c["t1"] - c["t0"]) * 1e3 for c in calls])
    return {"codec_s": span_s, "call_s": call_s,
            "sum_ratio": span_s / call_s if call_s > 0 else None,
            "codec_spans": len(roots), "calls": len(calls),
            "codec_p90_ms": span_p90, "call_p90_ms": call_p90,
            "p90_ratio": span_p90 / call_p90
            if span_p90 and call_p90 else None}


def span_cost_ns(pairs: int = 200_000) -> dict:
    """Host ns of one ``with span(...)`` pair and of one ``count``, with a
    recorder installed and without, and of each clock a span reads twice;
    the recorder is off afterwards."""
    from go_dicom_codec_torch.utils import profiling

    def per_pair(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(pairs):
            fn()
        return (time.perf_counter() - t0) * 1e9 / pairs

    def one_span():
        with profiling.span("cost", frames=1):
            pass

    def one_count():
        profiling.count("cost")
    profiling.GLOBAL_TIMER = None
    off = {"span_off": per_pair(one_span), "count_off": per_pair(one_count),
           "perf_counter": per_pair(time.perf_counter),
           "thread_time": per_pair(time.thread_time)}
    profiling.enable_global_timer()
    try:
        on = {"span_on": per_pair(one_span), "count_on": per_pair(one_count)}
    finally:
        profiling.GLOBAL_TIMER = None
    return {**off, **on}


def traced_run(workload: str, seed: int, seconds: float) -> dict:
    """``run.run_cell`` with ``--trace 1`` and the program's recorder on
    in each worker from the end of its set-up until its client has
    stopped, so that calls across either end of the stretch are whole;
    the spans of every worker (ids made (worker, id)) and their counters,
    summed, land in ``run["spans"]`` and ``run["counters"]``."""
    from . import run as harness

    out = harness.run_cell(workload, seed, seconds, True, spans=True)
    if out["run"]["trace"] is None:
        raise SystemExit("no result: the run made no traced stretch")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    out = traced_run(args.workload, args.seed, args.seconds)
    from . import readers

    run, res = out["run"], out["result"]
    op = run["traffic"]["op"]
    tr = run["trace"]
    frames = arith.frames_within(run["calls"], tr["t0"], tr["t1"], op)
    inside = sum(1 for s in run["spans"] if _inside(s, tr["t0"], tr["t1"]))
    line = {"workload": args.workload, "seed": args.seed,
            "correct": res["correct"], "failed": res["failed"],
            "frames_per_s": readers.frames_per_s(run, op),
            "metrics": res["metrics"],
            "spans": readings(run, op),
            "split_ms_per_frame": split_ms_per_frame(run, op),
            "checks": checks(run, op),
            "breakdown": breakdown(run),
            "harness_idle_gaps": res["breakdown"]["idle_gaps"],
            "counters": run["counters"],
            "spans_per_frame": inside / frames if frames else None,
            "cost_ns": span_cost_ns(),
            "device": res["device"]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
