"""Per-stage timing + the torch profiler hook.

Copy of ``go_dicom_codec_tpu/utils/profiling.py`` with ``torch_trace`` in
place of its ``jax_trace`` hook: a lightweight stage timer usable around
the device/host pipeline stages, the one-off event log, and a context
manager that drives torch.profiler for GPU traces.
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



@contextlib.contextmanager
def torch_trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace, with the card's kernels when CUDA
    is available, as a Chrome trace in ``log_dir`` (TensorBoard's
    ``*.pt.trace.json``, viewable in Perfetto)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if cuda:   # the work in flight ends inside the trace
                torch.cuda.synchronize()
