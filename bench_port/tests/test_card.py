"""On the card only (``card`` marker; each test skips without CUDA): a
short run of a cell through the benchmark's own command, and the control
at the cell's own size. Run them on the chip with

    python3 -m pytest bench_port/tests -m card -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench_port import spec

CELL = "ct-j2k-lossless.frame-decode"


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(args):
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, timeout=900, cwd=spec.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.card
def test_a_traced_run_on_the_card_is_correct_and_complete():
    _need_card()
    res = _run(["bench_port.run", "--workload", CELL, "--seed", "2147483905",
                "--seconds", "8", "--trace", "1"])[-1]
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    bench = spec.load_benchmark()
    want = {m["name"] for m in spec.cell_metrics(bench, CELL, trace=True)}
    assert want <= set(res["metrics"])
    for name in ("j2k_inv_stage_roofline", "device_idle_share.decode"):
        assert 0 < res["metrics"][name]["value"] <= 100


@pytest.mark.card
def test_the_control_on_the_card_is_not_correct():
    _need_card()
    r = subprocess.run([sys.executable, "-m", "bench_port.control",
                        "--workload", CELL, "--seeds", "2147483906",
                        "--seconds", "5"], capture_output=True, text=True,
                       timeout=900, cwd=spec.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("CONTROL ")][-1]
    reading = json.loads(line[len("CONTROL "):])
    assert reading["correct"] is False
    assert reading["checks"]["mismatched_samples"]["value"] > 0
