"""What a cell is made of, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; their
files are ``configs/<config>.json`` and ``traffic/<traffic>.json`` beside
this module, and each metric is read by ``metrics/<metric>.py``, whose
``read(run)`` returns a number or None (nothing to read). A mix may name
its own client loop, ``traffic/<module>.py``, under ``"loop_module"``.
A new cell, mix, configuration or metric is new files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_config(name: str, here: Path = HERE) -> dict:
    with open(here / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg.setdefault("name", name)
    return cfg


def load_traffic(name: str, here: Path = HERE) -> dict:
    with open(here / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    mix.setdefault("name", name)
    return mix


def applies(metric: dict, workload: str) -> bool:
    """A metric without a ``workloads`` key is read in every cell."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    with ``trace`` off, the per-layer ones with it on."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if applies(m, workload)]


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, here: Path = HERE) -> ModuleType:
    """``metrics/<metric>.py``; metric names may hold dots, so the file is
    loaded by its path."""
    path = here / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path} for metric {metric!r}")
    return _load_module(path, "bench_port_metric_" + metric.replace(
        ".", "_").replace("-", "_"))


def load_loop(mix: dict, here: Path = HERE) -> Optional[ModuleType]:
    """The mix's own client loop, when it names one."""
    name = mix.get("loop_module")
    if not name:
        return None
    return _load_module(here / "traffic" / f"{name}.py",
                        "bench_port_loop_" + name.replace("-", "_"))


def read_metrics(metrics: list, run: dict, here: Path = HERE) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"], here).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
