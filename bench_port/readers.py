"""What the per-layer and end-to-end readers in ``metrics/`` share: each
reader is ``read(run) -> number or None`` and calls one of these with its
operation. None means the run holds nothing to read."""

from __future__ import annotations

from typing import Optional

from . import arith


def _calls(run: dict, op: str) -> list:
    return [c for c in run["calls"] if c["op"] == op]


def frames_per_s(run: dict, op: str) -> Optional[float]:
    return arith.window_rate(run["calls"], run["start"], op)


def call_p90_ms(run: dict, op: str) -> Optional[float]:
    """The 90th percentile of the calls' times, every call of every
    client."""
    ms = [(c["t1"] - c["t0"]) * 1e3 for c in _calls(run, op)]
    return arith.p90(ms)


def _traced(run: dict, op: str):
    tr = run["trace"]
    if tr is None or not _calls(run, op):
        return None, 0.0
    frames = arith.frames_within(run["calls"], tr["t0"], tr["t1"], op)
    return tr, frames


def host_cpu_ms_per_frame(run: dict, op: str) -> Optional[float]:
    """CPU time of the process (user and system, every thread) over the
    part of the window outside the profiler, a frame of that part."""
    tr, inside = _traced(run, op)
    if tr is None:
        return None
    total = sum(c["frames"] for c in _calls(run, op))
    outside = total - inside
    cpu = (run["cpu"][1] - run["cpu"][0]) - (tr["cpu"][1] - tr["cpu"][0])
    if outside <= 0:
        return None
    return cpu * 1e3 / outside


def copy_us_per_frame(run: dict, op: str) -> Optional[float]:
    """Device time of the traced copies and fills, a frame traced."""
    tr, frames = _traced(run, op)
    if tr is None or frames <= 0:
        return None
    copies = [ev for ev in tr["events"] if arith.is_copy(ev[0])]
    if not copies:
        return None
    return sum(e - s for _, s, e in copies) * 1e6 / frames


def stage_roofline(run: dict, op: str) -> Optional[float]:
    """Percent of the HBM bound: the bytes of the traced frames' 5/3 stage
    (``arith.stage_bytes_per_frame``) over the device time of every
    kernel that is not a copy."""
    tr, frames = _traced(run, op)
    if tr is None:
        return None
    kernel_s = sum(e - s for n, s, e in tr["events"]
                   if not arith.is_copy(n))
    f = run["config"]["frame"]
    per = arith.stage_bytes_per_frame(f["rows"], f["columns"],
                                      f["samples_per_pixel"],
                                      f["bits_allocated"], f["bits_stored"])
    return arith.roofline_share(frames, per, kernel_s)


def device_idle_share(run: dict, op: str) -> Optional[float]:
    """Percent of the traced stretch in which no device operation ran."""
    tr, _ = _traced(run, op)
    if tr is None or tr["t1"] <= tr["t0"]:
        return None
    busy = arith.busy_seconds(tr["events"])
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (tr["t1"] - tr["t0"]))
