"""The yardstick's arithmetic: rates, percentiles, roofline bytes and
device intervals, on the records a run keeps.

A call record is a dict with ``client``, ``op`` ("decode" or "encode"),
``t0`` and ``t1`` (seconds on the host's monotonic clock) and ``frames``.
A device event is ``(name, start, end)`` in the same seconds.
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM, HBM3: the published 3.35 TB/s (the data sheet's rate at
# the card's full power limit of 700 W).
HBM_BYTES_PER_S = 3.35e12


def window_rate(calls: Sequence[dict], start: float, op: str
                ) -> Optional[float]:
    """Frames/s of ``op``: every frame of every call, over the time from
    the common start to the end of the last call."""
    mine = [c for c in calls if c["op"] == op]
    if not mine:
        return None
    end = max(c["t1"] for c in mine)
    if end <= start:
        return None
    return sum(c["frames"] for c in mine) / (end - start)


def p90(values: Sequence[float]) -> Optional[float]:
    """The 90th percentile. A 51 s window gives 100 calls or more, ten
    beyond it, on the machines measured; a slower host that makes fewer
    still gets a reading, from ten values up."""
    if len(values) < 10:
        return None
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def frames_within(calls: Iterable[dict], lo: float, hi: float, op: str
                  ) -> float:
    """Frames of ``op`` done inside [lo, hi], a call that straddles an end
    counted by the share of its time inside."""
    total = 0.0
    for c in calls:
        if c["op"] != op:
            continue
        span = c["t1"] - c["t0"]
        if span <= 0:
            total += c["frames"] if lo <= c["t0"] <= hi else 0.0
        else:
            total += c["frames"] * overlap(c["t0"], c["t1"], lo, hi) / span
    return total


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(events: Iterable[Tuple[str, float, float]]) -> float:
    """Seconds in which at least one device operation ran."""
    return sum(e - s for s, e in union((s, e) for _, s, e in events))


def gaps(events: Iterable[Tuple[str, float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] between device operations."""
    out, t = [], lo
    for s, e in union((s, e) for _, s, e in events):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def split_seconds(sources: Sequence[Iterable[Tuple[str, float, float]]]
                  ) -> dict:
    """Device seconds of each operation name, from the events of several
    sources: processes, each with a CUDA context of its own. The card runs
    the contexts' kernels in turns, and their copies in turns on the copy
    engines, so an event's span may hold other contexts' turns. Each
    instant of an engine (kernels, or copies and fills) goes to the source
    whose open operation there started last, since an operation starts
    only on its context's turn: a short kernel that ran inside another
    context's long one keeps its span, the long one loses it. A source's
    own operations that overlap (the streams of one context, which run at
    once) each take the instant in full. One source gives each event its
    whole span."""
    points = []
    for w, events in enumerate(sources):
        for n, s, e in events:
            if e > s:
                points += [(s, 1, w, n), (e, 0, w, n)]
    points.sort(key=lambda p: (p[0], p[1]))
    # per engine and source: {name: [open count, latest start]}
    open_ops: dict = {}
    out: dict = {}
    last = None
    for t, starts, w, n in points:
        if last is not None and t > last:
            for by_source in open_ops.values():
                mine = [ops for ops in by_source.values() if ops]
                if mine:
                    ops = max(mine, key=lambda o: max(v[1]
                                                      for v in o.values()))
                    for name, (count, _) in ops.items():
                        out[name] = out.get(name, 0.0) + (t - last) * count
        last = t
        ops = open_ops.setdefault(is_copy(n), {}).setdefault(w, {})
        count, latest = ops.get(n, (0, t))
        if starts:
            ops[n] = (count + 1, t)
        elif count > 1:
            ops[n] = (count - 1, latest)
        else:
            del ops[n]
    return out


def coeff_bytes(bits_stored: int) -> int:
    """Bytes of one reversible 5/3 coefficient of ``bits_stored``-bit
    samples in the narrowest integer type that holds it: the samples'
    bits, a sign and the two bits of gain of the HH band."""
    need = bits_stored + 3
    return 1 if need <= 8 else 2 if need <= 16 else 4


def stage_bytes_per_frame(rows: int, columns: int, samples: int,
                          bits_allocated: int, bits_stored: int) -> int:
    """Bytes a 5/3 stage must move for one frame: each sample read or
    written once in its stored container, each coefficient once at
    ``coeff_bytes``."""
    n = rows * columns * samples
    return n * (bits_allocated // 8) + n * coeff_bytes(bits_stored)


def roofline_share(frames: float, bytes_per_frame: int,
                   kernel_seconds: float) -> Optional[float]:
    """Percent of the HBM bound: the least time for the bytes over the
    kernels' device time."""
    if kernel_seconds <= 0 or frames <= 0:
        return None
    return 100.0 * frames * bytes_per_frame / HBM_BYTES_PER_S \
        / kernel_seconds


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (Python's quantiles, as the bound's rule takes them)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def spread_trimmed(values: Sequence[float]) -> float:
    """The spread without the value farthest from the median, as the
    check of a bound's tightness takes it."""
    med = statistics.median(values)
    rest = list(values)
    rest.remove(max(rest, key=lambda v: abs(v - med)))
    return spread(rest)
