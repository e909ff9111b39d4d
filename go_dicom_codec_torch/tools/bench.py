"""The port's headline bench: JPEG 2000 lossless transform throughput.

Counterpart of the root ``bench.py`` (lines 47-149) and of
``__graft_entry__.entry()``, with the port's ops on one CUDA device:

  - encode chain: ``ITERS`` steps of DC shift (16 bits, unsigned) +
    5-level 5/3 (one launch of the fused forward stage) + fixed-point
    deadzone quant ``q = sign(c) * ((|c| * 32768) >> 16)`` + 64×64
    code-block max |q| and bit planes; q feeds the next step and the
    accumulator takes ``sum(bits) + q[0, 0, 0]``;
  - decode chain: ``ITERS`` steps of dequant ``c = q * 2`` + inverse 5/3 +
    inverse DC shift (one launch of the fused inverse stage) + clip to
    [0, 65535]; the clipped frames feed the next step;
  - x+1 chain: the memory-bound ceiling in the same harness.

All arithmetic is torch int32 and wraps as the reference's does: ``|c| *
32768`` overflows once |c| ≥ 65536, which the feedback reaches. Each
chain is timed between two CUDA events with no host synchronisation
inside it; three rounds run in turns (copy, encode, decode), each chain's
best time gives its rate and the median of the rounds' ratios its share
of the ceiling. On stderr: each chain's event time, the host time to issue
it, whether it is host-bound, and its device time from torch.profiler.

Usage:
    python -m go_dicom_codec_torch.tools.bench [--device cpu]

The last line of stdout is one JSON object with bench.py's fields
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``decode_value``,
``decode_pct_of_ceiling``, ``encode_pct_of_ceiling``) and ``device`` (the
card's name) and ``gpu`` (its name and power limit from nvidia-smi).
``vs_baseline`` divides by the Go reference's single-core CPU rate
(224 Mpx/s, BASELINE.md), as bench.py does. On the CPU (``--device
cpu``) the times are wall-clock and no device time is taken.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..ops.blockstats import codeblock_max_abs, max_bitplane
from ..ops.j2k_fwd_stage import fwd_stage
from ..ops.j2k_inv_stage import inv_stage

BATCH, H, W, LEVELS, ITERS = 32, 512, 512, 5, 30
ROUNDS = 3
BASELINE_MPX_S = 224.0   # the Go reference, single CPU core (BASELINE.md)
SHIFT = 1 << 15          # DC shift of 16-bit unsigned samples


def encode_step(frames: torch.Tensor, acc: torch.Tensor):
    """One bench.py encode step (``bench.py:56-66``)."""
    c = fwd_stage(frames, SHIFT, LEVELS)
    q = torch.sign(c) * ((c.abs() * 32768) >> 16)
    bits = max_bitplane(codeblock_max_abs(q, 64, 64))
    return q, acc + bits.sum(dtype=torch.int32) + q[0, 0, 0]


def decode_step(q: torch.Tensor, acc: torch.Tensor):
    """One bench.py decode step (``bench.py:80-85``): the inverse stage's
    "pixels" epilogue is the inverse 5/3 and the inverse DC shift."""
    p = inv_stage((q * 2)[:, None], LEVELS, bits=16, epilogue="pixels")[:, 0]
    return p.clamp(0, 65535), acc + p[0, 0, 0]


def copy_step(frames: torch.Tensor, acc: torch.Tensor):
    """One step of the x+1 ceiling (``bench.py:90-98``)."""
    y = frames + 1
    return y, acc + y[0, 0, 0]


STEPS = {"encode": encode_step, "decode": decode_step, "copy": copy_step}


def chain(step, x: torch.Tensor, iters: int = ITERS):
    """``iters`` steps from (x, 0): (the carried tensor, the int32
    accumulator), both on x's device; no host synchronisation."""
    carry = (x, torch.zeros((), dtype=torch.int32, device=x.device))
    for _ in range(iters):
        carry = step(*carry)
    return carry


def _time_chain(step, x: torch.Tensor, iters: int) -> tuple:
    """(seconds the chain took, seconds the host took to issue it). On CUDA
    the first is the CUDA-event time around the chain."""
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        chain(step, x, iters)
        dt = time.perf_counter() - t0
        return dt, dt
    torch.cuda.synchronize(x.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    chain(step, x, iters)
    end.record()
    host = time.perf_counter() - t0
    end.synchronize()
    return start.elapsed_time(end) / 1e3, host


def _device_s(step, x: torch.Tensor, iters: int) -> float:
    """Device time of one chain: the kernel, copy and fill time
    torch.profiler records (None where it recorded no device event)."""
    from .device_bench import device_ms
    ms = device_ms(lambda: chain(step, x, iters), iters=1)[0]
    return None if ms is None else ms / 1e3


def _card(device: torch.device) -> tuple:
    """(torch's device name, nvidia-smi's "name, power limit"), or ("cpu",
    None)."""
    if device.type != "cuda":
        return "cpu", None
    from .device_bench import card_info
    return torch.cuda.get_device_name(device), card_info()


def main(batch: int = BATCH, height: int = H, width: int = W,
         iters: int = ITERS, device: torch.device = None) -> dict:
    """Run the three chains on ``device`` (CUDA device 0 unless given),
    print the JSON line and return it as a dict."""
    device = torch.device("cuda", 0) if device is None else device
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.integers(0, 1 << 12, (batch, height, width),
                                          dtype=np.int32), device=device)
    for step in STEPS.values():
        _time_chain(step, frames, iters)   # builds the kernels, warms up
    best = {k: None for k in STEPS}
    host = {k: None for k in STEPS}
    ratios = {"encode": [], "decode": []}
    for _ in range(ROUNDS):
        t = {}
        for name in ("copy", "encode", "decode"):
            t[name], h = _time_chain(STEPS[name], frames, iters)
            if best[name] is None or t[name] < best[name]:
                best[name], host[name] = t[name], h
        for name in ratios:
            ratios[name].append(t["copy"] / t[name])
    px = batch * height * width * iters
    mpx = {k: px / best[k] / 1e6 for k in STEPS}
    pct = {k: 100 * statistics.median(v) for k, v in ratios.items()}
    for name in STEPS:
        dev = (_device_s(STEPS[name], frames, iters)
               if device.type == "cuda" else None)
        print(f"{name} chain of {iters} steps at [{batch}, {height}, "
              f"{width}]: {best[name] * 1e3:.4f} ms "
              f"({'event' if device.type == 'cuda' else 'wall'}), "
              f"host {host[name] * 1e3:.4f} ms to issue it"
              f"{' (host-bound)' if host[name] >= 0.9 * best[name] else ''}"
              + (f", device {dev * 1e3:.4f} ms" if dev is not None else "")
              + f"; {mpx[name]:.1f} Mpx/s", file=sys.stderr)
    print(f"x+1 ceiling (same chained harness): {mpx['copy']:.0f} Mpx/s; "
          f"encode reaches {pct['encode']:.0f}% of it, decode "
          f"{pct['decode']:.0f}% (medians of {ROUNDS} interleaved rounds)",
          file=sys.stderr)
    name, gpu = _card(device)
    result = {
        "metric": "j2k_dwt53_quant_stats_encode_throughput",
        "value": mpx["encode"],
        "unit": "Mpx/s/chip",
        "vs_baseline": mpx["encode"] / BASELINE_MPX_S,
        "decode_value": mpx["decode"],
        "decode_pct_of_ceiling": pct["decode"],
        "encode_pct_of_ceiling": pct["encode"],
        "device": name,
        "gpu": gpu,
    }
    print(json.dumps(result))
    return result


def entry(device: torch.device = None):
    """(fn, example_args) of the flagship device computation, as
    ``__graft_entry__.entry()``: the J2K lossless encode transform (DC
    shift + 5-level 5/3 + code-block stats) of 8 512×512 frames on
    ``device`` (CUDA device 0 unless given)."""
    from ..pipeline import j2k_lossless_encode_transform

    device = torch.device("cuda", 0) if device is None else device

    def fn(frames):
        return j2k_lossless_encode_transform(frames, levels=5, bits=16,
                                             signed=False, cb=64)

    return fn, (torch.zeros((8, 512, 512), dtype=torch.int32, device=device),)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (device 0, the default) or cpu")
    dev = ap.parse_args().device
    main(device=torch.device("cuda", 0) if dev == "cuda"
         else torch.device(dev))
