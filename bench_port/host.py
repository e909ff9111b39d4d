"""What a run prints about the machine it runs on, before it measures:
the card's name and power limit, the CPUs this process may use and the
cgroup's CPU quota. Everything here only reads."""

from __future__ import annotations

import os
import subprocess


def card_line() -> str:
    """``nvidia-smi``'s name, power limit and SM clock of each card."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable ({type(exc).__name__})"
    if r.returncode != 0:
        return f"unavailable (nvidia-smi exit {r.returncode})"
    return "; ".join(line.strip() for line in r.stdout.splitlines()
                     if line.strip())


def affinity_count() -> int:
    return len(os.sched_getaffinity(0))


def cpu_max() -> str:
    """The cgroup v2 quota (``cpu.max``: quota and period in us, or
    "max"), read only."""
    try:
        with open("/proc/self/cgroup") as f:
            rel = next((line.split(":", 2)[2].strip() for line in f
                        if line.startswith("0::")), "/")
    except OSError:
        rel = "/"
    for path in (f"/sys/fs/cgroup{rel}/cpu.max", "/sys/fs/cgroup/cpu.max"):
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            continue
    return "unavailable"

