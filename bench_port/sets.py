"""Run cells several times, each run a process of its own, and print the
median and spread of each metric: how the bounds in BENCHMARK.json are
measured.

    python3 -m bench_port.sets --workload <cell> [--workload ...] \
        --seeds 11,12,13 --seconds 51 [--trace 1] [--out DIR]

Every run's standard output and error are kept under ``--out``. The runs
of a cell follow one another, in the order of the seeds.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from .arith import spread, spread_trimmed


def run_once(workload: str, seed: int, seconds: float, trace: int,
             out: Path, tag: str) -> dict:
    cmd = [sys.executable, "-m", "bench_port.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=1500)
    wall = time.perf_counter() - t0
    (out / f"{tag}.out").write_text(r.stdout)
    (out / f"{tag}.err").write_text(r.stderr)
    lines = r.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1]) if r.returncode == 0 and lines else None
    except json.JSONDecodeError:
        res = None
    return {"workload": workload, "seed": seed, "trace": trace,
            "rc": r.returncode, "wall_s": wall, "result": res,
            "stderr_tail": r.stderr[-1500:] if res is None else ""}


def summarize(runs: list) -> dict:
    """{metric: {"values", "median", "spread"}} over runs with a result."""
    values: dict = {}
    for r in runs:
        if r["result"] is None:
            continue
        for name, m in r["result"]["metrics"].items():
            values.setdefault(name, []).append(m["value"])
    out = {}
    for name, vals in values.items():
        out[name] = {"values": vals, "median": statistics.median(vals),
                     "spread": spread(vals) if len(vals) >= 2 else None,
                     "spread_trimmed": spread_trimmed(vals)
                     if len(vals) >= 3 else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="build/bench_sets")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    for w in args.workload:
        runs = []
        for i, seed in enumerate(seeds):
            r = run_once(w, seed, args.seconds, args.trace, out,
                         f"{w}.t{args.trace}.{i}.{seed}")
            runs.append(r)
            print("RUN " + json.dumps(r), flush=True)
        print("SET " + json.dumps({"workload": w, "trace": args.trace,
                                   "seconds": args.seconds,
                                   "correct": [r["result"]["correct"]
                                               if r["result"] else None
                                               for r in runs],
                                   "summary": summarize(runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
