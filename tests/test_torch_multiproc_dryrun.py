"""The port's two-process dry run (go_dicom_codec_torch/tools/
multiproc_dryrun.py), the counterpart of the JAX package's.

Two OS processes join one torch.distributed group over gloo on the CPU,
each transforms and encodes its contiguous half of the reference tool's 8
frames (64 × 60, 12 bits, 3 levels), every stream equal to the scalar
encoder's and, here, to the JAX package's scalar encoder; an all_reduce
and an all_gather_object cross the process boundary. The device and
backend choice of ``--device cuda`` is checked by faking the card count;
on a machine without a card, ``--device cuda`` must fail, not fall back.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.codecs.jpeg2000 import J2KEncodeParams, J2KEncoder
from go_dicom_codec_tpu.ops.dwt53 import fwd53_multilevel
from go_dicom_codec_tpu.tools import multiproc_dryrun as ref_tool

from go_dicom_codec_torch import native
from go_dicom_codec_torch.tools import multiproc_dryrun as tool

ROOT = Path(__file__).resolve().parent.parent


def _run(*args):
    native.get_lib()      # build the host library once, not in each rank
    proc = subprocess.run(
        [sys.executable, "-m", "go_dicom_codec_torch.tools.multiproc_dryrun",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=120)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("MP|")]
    assert len(lines) == 1, proc.stdout + proc.stderr
    return proc.returncode, json.loads(lines[0][3:]), proc


@pytest.fixture(scope="module")
def cpu_run():
    return _run("--device", "cpu")


def test_two_processes_on_the_cpu(cpu_run):
    rc, line, proc = cpu_run
    assert rc == 0 and line["ok"], proc.stdout + proc.stderr
    assert line["frames"] == list(range(8))
    assert line["per_process"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert line["backend"] == "gloo"
    assert line["devices"] == ["cpu", "cpu"]
    assert line["fwd_stage_launches"] == [0, 0]
    # the same frames as the reference tool's, and the all_reduced sum of
    # |coefficient| equal to the reference's 5/3 over all of them
    frames = ref_tool._frames()
    assert np.array_equal(tool._frames(), frames)
    assert (tool.F, tool.H, tool.W, tool.LEVELS, tool.BITS) == (
        ref_tool.F, ref_tool.H, ref_tool.W, ref_tool.LEVELS, ref_tool.BITS)
    coeffs = np.asarray(fwd53_multilevel(jnp.asarray(frames - 2048), 3))
    assert line["abs_sum_total"] == int(np.abs(coeffs.astype(np.int64)).sum())


def test_streams_equal_the_reference_encoder(cpu_run):
    """Every frame's stream, from either rank, hashes as the JAX
    package's scalar encoder's."""
    rc, line, proc = cpu_run
    assert rc == 0, proc.stderr
    enc = J2KEncoder(J2KEncodeParams(num_levels=3))
    want = [hashlib.sha256(enc.encode(f, 60, 64, 1, 12)).hexdigest()
            for f in ref_tool._frames()]
    assert line["shas"] == want


@pytest.mark.parametrize("cards,want", [
    (0, None),
    (1, [("cuda:0", "gloo"), ("cuda:0", "gloo")]),
    (2, [("cuda:0", "nccl"), ("cuda:1", "nccl")]),
    (8, [("cuda:0", "nccl"), ("cuda:1", "nccl")]),
])
def test_placement_of_cuda_ranks(cards, want, monkeypatch):
    """One card a rank: NCCL on cuda:r; fewer cards than ranks: gloo with
    both ranks on cuda:0; no card: an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool._placement("cuda", 0)
        return
    got = [tool._placement("cuda", r) for r in range(tool.WORLD)]
    assert [(str(d), b) for d, b in got] == want
    assert tool._placement("cpu", 1) == (torch.device("cpu"), "gloo")


def test_cuda_is_never_served_by_the_cpu():
    """``--device cuda`` (the default) fails on a machine without a card,
    and passes naming its backend on one with a card."""
    rc, line, proc = _run()
    if not torch.cuda.is_available():
        assert rc != 0 and line["ok"] is False, proc.stdout
        return
    assert rc == 0 and line["ok"], proc.stdout + proc.stderr
    assert line["backend"] in ("nccl", "gloo")
    assert all(d.startswith("cuda") for d in line["devices"])
    assert line["fwd_stage_launches"] == [1, 1]
