"""The traced sub-window: torch.profiler over a stretch of the measured
window, read into device events on the host's monotonic clock.

Each worker runs a profiler of its own, which records the card's
operations of its process. Two marks of the thread that starts it tie the
profiler's clock to ``time.perf_counter``, the clock every process on the
machine shares.
"""

from __future__ import annotations

import time
from typing import List, Tuple

MARK = "bench_port.mark"


class Tracer:
    def __init__(self, torch) -> None:
        self.torch = torch
        self._prof = None
        self.t0 = self.t1 = 0.0
        self.cpu0 = self.cpu1 = 0.0
        self._mark0 = self._mark1 = 0.0

    def _profile(self):
        acts = [self.torch.profiler.ProfilerActivity.CPU,
                self.torch.profiler.ProfilerActivity.CUDA]
        return self.torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that its own
        start-up falls outside the window."""
        with self._profile():
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    def start(self) -> None:
        self._prof = self._profile()
        self._prof.__enter__()
        with self.torch.profiler.record_function(MARK):
            self._mark0 = time.perf_counter()
        self.t0, self.cpu0 = self._mark0, time.process_time()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        with self.torch.profiler.record_function(MARK):
            self._mark1 = time.perf_counter()
        self.t1, self.cpu1 = self._mark1, time.process_time()
        self._prof.__exit__(None, None, None)

    def device_events(self) -> List[Tuple[str, float, float]]:
        """Every device operation of the profile as (name, start, end)
        in perf_counter seconds, clipped to the traced stretch."""
        events = self._prof.events()
        marks = sorted(e.time_range.start for e in events if e.name == MARK)
        if len(marks) != 2:
            raise RuntimeError(f"the profile holds {len(marks)} marks, not 2")
        # perf_counter = a + b * profiler µs, from the two marks
        b = (self._mark1 - self._mark0) / max(marks[1] - marks[0], 1e-9)
        a = self._mark0 - b * marks[0]
        cuda = self.torch.autograd.DeviceType.CUDA
        out = []
        for e in events:
            if e.device_type != cuda:
                continue
            s, t = a + b * e.time_range.start, a + b * e.time_range.end
            s, t = max(s, self.t0), min(t, self.t1)
            if t > s:
                out.append((e.name, s, t))
        return out
