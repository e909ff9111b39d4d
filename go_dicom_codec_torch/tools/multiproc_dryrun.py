"""Two-process dry run of the sharded J2K encode over torch.distributed.

Port of ``go_dicom_codec_tpu/tools/multiproc_dryrun.py``. Two OS processes
join one ``torch.distributed`` process group (``tcp://127.0.0.1:<free
port>``, world size 2). Each rank runs the J2K device transform over its
contiguous half of a global batch of 8 frames on its own device, finishes
the host entropy stage for that half only, and holds every stream against
the in-process scalar encoder byte for byte. Two collectives cross the
process boundary: an ``all_reduce`` of each rank's sum of |coefficient|,
and an ``all_gather_object`` of the per-frame sha256s.

``--device cuda`` (the default): with a card for each rank, rank r runs
on ``cuda:r`` over NCCL; with fewer cards than ranks both run on
``cuda:0`` over gloo (NCCL refuses two ranks on one card). ``--device
cpu`` runs on the CPU over gloo. A rank that cannot get the device it was
asked for fails; nothing falls back to the CPU.

Usage: python -m go_dicom_codec_torch.tools.multiproc_dryrun [--device cuda|cpu]
Prints one MP| JSON line; exit 0 = both processes byte-identical.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

F, H, W, LEVELS, BITS = 8, 64, 60, 3, 12
WORLD = 2
TIMEOUT_S = 300


def _frames():
    import numpy as np
    rng = np.random.default_rng(11)
    return rng.integers(0, 1 << BITS, size=(F, H, W)).astype(np.int32)


def _placement(kind: str, rank: int):
    """(device, backend) of ``rank`` for ``--device kind``."""
    import torch

    if kind == "cpu":
        return torch.device("cpu"), "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device")
    if torch.cuda.device_count() >= WORLD:
        return torch.device("cuda", rank), "nccl"
    return torch.device("cuda", 0), "gloo"


def _child(rank: int, port: int, kind: str) -> dict:
    import datetime
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import _kernels
    from ..codecs.jpeg2000 import J2KEncodeParams, J2KEncoder
    from ..ops.j2k_fwd_stage import fwd_stage

    device, backend = _placement(kind, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        frames = _frames()                   # the same on both ranks
        per = F // WORLD
        base = rank * per
        x = torch.as_tensor(frames[base:base + per], device=device)
        # DC shift + multilevel 5/3: one launch of the fused forward stage
        # on a card
        before = _kernels.launch_counts["j2k_fwd_stage"]
        coeffs = fwd_stage(x[:, None], 1 << (BITS - 1), LEVELS)
        launches = _kernels.launch_counts["j2k_fwd_stage"] - before
        # collectives: NCCL reduces on the card, gloo on the host
        stat = coeffs.abs().to(torch.int64).sum()
        local = int(stat)
        if backend == "gloo":
            stat = stat.cpu()
        dist.all_reduce(stat, op=dist.ReduceOp.SUM)
        data = coeffs.cpu().numpy()

        enc = J2KEncoder(J2KEncodeParams(num_levels=LEVELS), device=None)
        scalar_enc = J2KEncoder(J2KEncodeParams(num_levels=LEVELS),
                                device=device)
        shas = {}
        for i in range(per):
            fi = base + i
            stream = enc.encode(frames[fi], W, H, 1, BITS,
                                precomputed_tiles=[data[i]])
            # cross-check vs the fully scalar encoder in this process
            scalar = scalar_enc.encode(frames[fi], W, H, 1, BITS)
            if stream != scalar:
                raise AssertionError(f"frame {fi} diverged from scalar")
            shas[fi] = hashlib.sha256(stream).hexdigest()
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, shas)
        return {"rank": rank, "device": str(device), "backend": backend,
                "fwd_stage_launches": launches, "shas": shas,
                "gathered": gathered, "abs_sum": local,
                "abs_sum_total": int(stat)}
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if os.environ.get("GDCT_MP_ROLE") is not None:
        out = _child(int(os.environ["GDCT_MP_ROLE"]),
                     int(os.environ["GDCT_MP_PORT"]), args.device)
        print("MPCHILD|" + json.dumps(out))
        return 0

    port = _free_port()
    root = str(Path(__file__).resolve().parents[2])
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ)
        env.update({"GDCT_MP_ROLE": str(rank), "GDCT_MP_PORT": str(port),
                    "PYTHONPATH": os.pathsep.join(
                        [root] + [p for p in [env.get("PYTHONPATH")] if p])})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "go_dicom_codec_torch.tools."
             "multiproc_dryrun", "--device", args.device],
            env=env, stdout=subprocess.PIPE, text=True))
    # a rank that fails leaves the other waiting in a collective: stop
    # both at the first failure or at the deadline
    deadline = time.monotonic() + TIMEOUT_S
    while any(p.poll() is None for p in procs):
        if (time.monotonic() > deadline
                or any(p.poll() not in (None, 0) for p in procs)):
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    rcs = [p.wait() for p in procs]
    outs = [p.stdout.read() for p in procs]
    if any(rcs):
        print("MP|" + json.dumps({"ok": False, "rcs": rcs}))
        return 1
    results = [json.loads(next(line for line in o.splitlines()
                               if line.startswith("MPCHILD|"))[8:])
               for o in outs]
    covered = {}
    for r in results:
        covered.update({int(k): v for k, v in r["shas"].items()})
    union = {str(k): v for k, v in covered.items()}
    per = F // WORLD
    per_process = [sorted(int(k) for k in r["shas"]) for r in results]
    ok = (sorted(covered) == list(range(F))
          and per_process == [list(range(r * per, (r + 1) * per))
                              for r in range(WORLD)]
          and all({k: v for g in r["gathered"] for k, v in g.items()}
                  == union for r in results)
          and all(r["abs_sum_total"] == sum(q["abs_sum"] for q in results)
                  for r in results)
          and len({r["backend"] for r in results}) == 1
          and all(r["fwd_stage_launches"] == (r["device"] != "cpu")
                  for r in results))
    print("MP|" + json.dumps({
        "ok": ok, "frames": sorted(covered), "per_process": per_process,
        "backend": results[0]["backend"],
        "devices": [r["device"] for r in results],
        "fwd_stage_launches": [r["fwd_stage_launches"] for r in results],
        "abs_sum_total": results[0]["abs_sum_total"],
        "shas": [covered[k] for k in sorted(covered)],
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
