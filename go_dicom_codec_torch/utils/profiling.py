"""Per-stage timing.

Copy of ``go_dicom_codec_tpu/utils/profiling.py`` without its
``jax_trace`` hook, which imports jax: a lightweight stage timer usable
around the device/host pipeline stages, and the one-off event log.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class StageTimer:
    """Accumulates wall time per named pipeline stage."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:28s} {t * 1e3:9.2f} ms total"
                         f"  {t / n * 1e3:8.3f} ms/call  x{n}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


# a process-wide default timer the codecs can opt into
GLOBAL_TIMER: Optional[StageTimer] = None


def enable_global_timer() -> StageTimer:
    global GLOBAL_TIMER
    GLOBAL_TIMER = StageTimer()
    return GLOBAL_TIMER


def log_event(name: str, payload: dict) -> None:
    """Record a one-off decision/observation: accumulates under the
    global stage timer (zero duration, count 1) when enabled, and keeps
    the last payload per name for inspection (EVENTS)."""
    EVENTS[name] = dict(payload)
    if GLOBAL_TIMER is not None:
        GLOBAL_TIMER.counts[name] += 1


EVENTS: Dict[str, dict] = {}


@contextlib.contextmanager
def maybe_stage(name: str) -> Iterator[None]:
    if GLOBAL_TIMER is None:
        yield
    else:
        with GLOBAL_TIMER.stage(name):
            yield

