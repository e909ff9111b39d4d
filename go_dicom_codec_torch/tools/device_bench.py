"""Device bench of the port: the J2K lossless transform and the fused DCT.

Counterpart of part of ``go_dicom_codec_tpu/tools/device_bench.py`` and
of ``bench.py:47-98``. Rows:

  - ``dwt53_stats``: DC shift + 5-level 5/3 + fixed-point deadzone quant +
    64×64 code-block max/bitplane stats (the bench.py encode step);
  - ``idwt53``: dequant ×2 + inverse 5/3 + inverse DC shift + clip (the
    bench.py decode step);
  - ``dct8x8_quant_pallas``: the fused 8×8 DCT + quant kernel, the port of
    the Pallas kernel;
  - ``xplus1_ceiling``: ``x + 1``, the memory-bound ceiling of this shape.

Each row runs in the kernel lane (the hand-written kernels) and the plain
lane (the same step in plain torch), except the ceiling, which is plain
torch only. Inputs are device-resident 12-bit samples from
``numpy.random.default_rng(seed)``. A run is ``iters`` calls back to back
between two CUDA events; a row reports the median over ``RUNS`` runs
after one warm-up run, as ms per call and Mpx/s, and beside it the host
time it took to issue one call in the same runs (``host_ms``).

The command line then shows, in the same process, where the time goes
(``run_profile``): for every row and lane, and for the 5-level forward
and inverse alone, the device time per call (the kernel time
torch.profiler records over ``iters`` calls), its largest kernels and the
device's idle share, 1 − device time / event time; then the same for
each single lifting pass of the 5-level transform (``iters`` launches of
the one pass back to back).

Usage:
    python -m go_dicom_codec_torch.tools.device_bench [--batch N]
        [--size WxH] [--iters N]

Prints the card, one ``BENCH|`` JSON line per row and lane, one
``PROFILE|`` line per step and one ``PASS|`` line per pass. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..ops.blockstats import codeblock_max_abs, max_bitplane
from ..ops.dct8x8 import LUMA_QUANT, scale_quant_table
from ..ops.dwt53 import (_level_windows, _pass_kernel_, fwd53_multilevel_,
                         fwd53_multilevel_plain_, inv53_multilevel_,
                         inv53_multilevel_plain_)
from ..ops.fdct8x8_quant import fdct8x8_quant, fdct8x8_quant_plain
from ..ops.mct import dc_level_shift, inv_dc_level_shift

LEVELS = 5
RUNS = 5  # timed runs per measurement, after one warm-up run
LANES = {"kernel": (fwd53_multilevel_, inv53_multilevel_, fdct8x8_quant),
         "plain": (fwd53_multilevel_plain_, inv53_multilevel_plain_,
                   fdct8x8_quant_plain)}


def card_info() -> str:
    """``name, power.limit`` of GPU 0, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def dwt53_stats(x: torch.Tensor, lane: str = "kernel"):
    """One bench.py encode step: shift, 5/3, deadzone quant, stats.

    ``(mag * 32768) >> 16`` stays torch int32, wraparound included.
    """
    fwd = LANES[lane][0]
    c = fwd(dc_level_shift(x, 16, False), LEVELS)
    q = torch.sign(c) * ((c.abs() * 32768) >> 16)
    return q, max_bitplane(codeblock_max_abs(q, 64, 64))


def idwt53(q: torch.Tensor, lane: str = "kernel") -> torch.Tensor:
    """One bench.py decode step: dequant, inverse 5/3, unshift, clip."""
    inv = LANES[lane][1]
    r = inv(q * 2, LEVELS)
    return inv_dc_level_shift(r, 16, False).clamp(0, 65535)


def time_ms(fn, iters: int = 10) -> tuple:
    """Median over ``RUNS`` runs of ``iters`` calls of ``fn`` back to back,
    after one warm-up run: (CUDA-event ms per call, host ms to issue one
    call). The event time is the device's wall time; where the host time
    is as long, the host, not the device, sets the rate."""
    dev, host = [], []
    for r in range(RUNS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        t1 = time.perf_counter()
        end.synchronize()
        if r:
            dev.append(start.elapsed_time(end) / iters)
            host.append((t1 - t0) * 1e3 / iters)
    return statistics.median(dev), statistics.median(host)


def device_ms(fn, iters: int = 10) -> tuple:
    """Kernel time per call of ``fn`` on the device, from torch.profiler
    over ``iters`` calls after one warm-up call: (ms, the six largest
    kernels as [name, µs per call]). Only device events count: a torch
    op on the host reports its kernels' time as its own as well."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sorted(((e.self_device_time_total / iters, e.key)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0), reverse=True)
    top = [[k[:72], t] for t, k in us[:6]]
    return sum(t for t, _ in us) / 1e3, top


def _inputs(batch: int, height: int, width: int, seed: int):
    if not torch.cuda.is_available():
        raise RuntimeError("device_bench needs a CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(0, 1 << 12, (batch, height, width),
                                     dtype=np.int32), device=dev)
    qt = torch.as_tensor(scale_quant_table(LUMA_QUANT, 90, 255),
                         dtype=torch.float32, device=dev)
    return x, qt


def _steps(x: torch.Tensor, qt: torch.Tensor) -> dict:
    """Every row's step, as a function of the lane."""
    q = dwt53_stats(x)[0]
    return {"dwt53_stats": lambda lane: dwt53_stats(x, lane),
            "idwt53": lambda lane: idwt53(q, lane),
            "dct8x8_quant_pallas": lambda lane: LANES[lane][2](x, qt, 2048)}


def run_bench(batch: int = 32, height: int = 512, width: int = 512,
              iters: int = 10, seed: int = 0, card: str = "") -> list:
    """Measure every row and lane on CUDA device 0; returns the rows."""
    x, qt = _inputs(batch, height, width, seed)
    card = card or card_info()
    px = batch * height * width
    rows = []

    def row(name, lane, fn):
        ms, host = time_ms(fn, iters)
        rows.append({"row": name, "lane": lane, "ms": ms,
                     "mpx_per_s": px / ms / 1e3, "host_ms": host,
                     "batch": batch, "size": f"{width}x{height}",
                     "runs": RUNS, "iters": iters, "gpu": card})

    for name, step in _steps(x, qt).items():
        for lane in LANES:  # kernel, then plain: the pair runs back to back
            row(name, lane, lambda: step(lane))
    row("xplus1_ceiling", "plain", lambda: x + 1)
    return rows


def run_profile(batch: int = 32, height: int = 512, width: int = 512,
                iters: int = 10, seed: int = 0, card: str = "") -> tuple:
    """Where the time goes, on CUDA device 0: (step lines, pass lines).

    Every time of a line comes from this one call: event and host time
    from ``time_ms``, device time from ``device_ms``, unprofiled runs
    first.
    """
    x, qt = _inputs(batch, height, width, seed)
    card = card or card_info()
    buf = x - 2048
    fns = {f"{name}/{lane}": (lambda step=step, lane=lane: step(lane))
           for name, step in _steps(x, qt).items() for lane in LANES}
    for lane, (fwd, inv, _) in LANES.items():
        fns[f"fwd53_{LEVELS}lv/{lane}"] = lambda fwd=fwd: fwd(buf, LEVELS)
        fns[f"inv53_{LEVELS}lv/{lane}"] = lambda inv=inv: inv(buf, LEVELS)
    fns["xplus1/plain"] = lambda: x + 1

    def line(fn, **key):
        ms, host = time_ms(fn, iters)
        dev, top = device_ms(fn, iters)
        return {**key, "event_ms": ms, "host_ms": host, "device_ms": dev,
                "idle_share": 1 - dev / ms, "top_kernels_us": top,
                "gpu": card}

    steps = [line(fn, step=name) for name, fn in fns.items()]
    passes = []
    for level, (w, h, _, _) in enumerate(
            _level_windows(width, height, LEVELS, 0, 0), 1):
        for inverse in (False, True):
            for vertical in (True, False):
                p = line(lambda: _pass_kernel_(buf, h, w, vertical, True,
                                               inverse),
                         level=level, window=f"{w}x{h}",
                         axis="cols" if vertical else "rows",
                         inverse=inverse)
                p["device_gb_per_s"] = 8 * batch * h * w / p["device_ms"] / 1e6
                passes.append(p)
    return steps, passes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=str, default="512x512")
    ap.add_argument("--iters", type=int, default=10)
    opts = ap.parse_args(argv)
    w, h = (int(v) for v in opts.size.split("x"))
    card = card_info()
    print(card)
    for r in run_bench(opts.batch, h, w, opts.iters, card=card):
        print("BENCH|" + json.dumps(r))
    steps, passes = run_profile(opts.batch, h, w, opts.iters, card=card)
    for r in steps:
        print("PROFILE|" + json.dumps(r))
    for r in passes:
        print("PASS|" + json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
