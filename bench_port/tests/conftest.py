"""Fixtures of the harness's tests: a copy of the benchmark's files cut to
a tiny size, which the harness runs on the CPU with the program's plain
lanes. Tests that need the card carry the ``card`` marker and skip
without one."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

TINY = {"rows": 32, "columns": 48}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def make_tiny(dest: Path, frames_per_call: int = 3, clients: int = 2
              ) -> tuple:
    """A copy of BENCHMARK.json and bench_port's data files under
    ``dest``, with frames of TINY size: (root, here)."""
    here = dest / "bench_port"
    shutil.copytree(HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cfg_path in (here / "configs").glob("*.json"):
        cfg = json.loads(cfg_path.read_text())
        cfg["frame"].update(TINY)
        cfg["phantom"].update(TINY)
        cfg_path.write_text(json.dumps(cfg))
    for mix_path in (here / "traffic").glob("*.json"):
        mix = json.loads(mix_path.read_text())
        mix["frames_per_call"] = min(mix["frames_per_call"], frames_per_call)
        mix["objects_per_client"] = min(mix["objects_per_client"], 4)
        mix["clients"] = clients
        mix["check"]["calls_per_client"] = 8
        mix_path.write_text(json.dumps(mix))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest, here


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)


@pytest.fixture
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
