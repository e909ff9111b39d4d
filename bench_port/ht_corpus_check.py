"""Every HT code-block of a cell's corpus decoded three ways and compared:
the program's HT cleanup kernel (``ops/j2k_ht_decode.ht_decode`` on the
card), its plain version (the native host decoder) and the plain T.814
decoder of ``htj2k_reference.py``.

    python3 -m bench_port.ht_corpus_check --workload <cell> --seed <n> \
        [--device cuda:0] [--workers 8]

Each client's corpus is made as its worker makes it (``clients.Client``:
the phantom from (seed, client), encoded by the program with the
configuration's parameters); its frames go through the plan by chunk of
8, as the decode pipeline takes them. The plain decoder runs in
``--workers`` processes. One JSON line: the blocks compared and those
that differ, for each pair; nothing of JAX may be loaded.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time

from . import run, spec

CHUNK = 8


def _reference_block(item):
    """The plain decoder's coefficients of one block, or its refusal."""
    import numpy as np

    from . import htj2k_reference

    seg, w, h, kmax, missing = item
    try:
        return htj2k_reference.decode_cleanup(seg, w, h, kmax, missing) \
            .astype(np.int64)
    except htj2k_reference.StreamError as exc:
        return str(exc)


def check(workload: str, seed: int, device, workers: int,
          cfg: dict = None, mix: dict = None) -> dict:
    """Compare every HT block of the cell's corpus; ``cfg`` and ``mix`` in
    place of the cell's own files (the harness's tests)."""
    import numpy as np
    import torch

    import go_dicom_codec_torch as gdc
    from go_dicom_codec_torch.codecs.jpeg2000 import ht_blocks
    from go_dicom_codec_torch.ops import j2k_ht_decode as H

    from .clients import Client

    if cfg is None:
        cell = spec.find_cell(spec.load_benchmark(), workload)
        cfg = spec.load_config(cell["config"])
        mix = spec.load_traffic(cell["traffic"])
    t0 = time.perf_counter()
    out = {"workload": workload, "seed": seed, "device": str(device),
           "frames": 0, "blocks": 0, "kernel_vs_native": 0,
           "kernel_vs_reference": 0, "reference_refused": 0,
           "status_nonzero": 0}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        for i in range(int(mix["clients"])):
            client = Client(i, seed, cfg, mix, device, gdc)
            client.make_corpus()
            client.encode_corpus()
            streams = [s for obj in client.inputs for s in obj.frames]
            for k in range(0, len(streams), CHUNK):
                parsed = [ht_blocks(s) for s in streams[k:k + CHUNK]]
                plan = H.chunk_plan([p[4] for p in parsed], parsed[0][0])
                buf = torch.from_numpy(plan.buf)
                got, status = H.ht_decode(buf.to(device), plan.launch)
                got = got.cpu().numpy().astype(np.int64)
                want, _ = H.ht_decode_plain(buf, plan.launch)
                rec, data = H.records(plan.buf, plan.launch)
                items = [(data[r[H.OFF]:r[H.OFF] + r[H.LEN]].tobytes(),
                          int(r[H.W]), int(r[H.H]), int(r[H.KMAX]),
                          int(r[H.MISSING])) for r in rec]
                refs = pool.map(_reference_block, items, chunksize=16)
                want = want.numpy().astype(np.int64)
                for r, ref in zip(rec, refs):
                    p, y, x, w, h = (int(r[H.PLANE]), int(r[H.ROW]),
                                     int(r[H.COL]), int(r[H.W]),
                                     int(r[H.H]))
                    blk = got[p, y:y + h, x:x + w]
                    out["kernel_vs_native"] += int(
                        not np.array_equal(blk, want[p, y:y + h, x:x + w]))
                    if isinstance(ref, str):
                        out["reference_refused"] += 1
                    else:
                        out["kernel_vs_reference"] += int(
                            not np.array_equal(blk, ref))
                out["blocks"] += len(rec)
                out["frames"] += len(parsed)
                out["status_nonzero"] += int(status.item() != 0)
    out["seconds"] = time.perf_counter() - t0
    out["forbidden"] = run.forbidden_modules()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no result: no CUDA card")
    out = check(args.workload, args.seed, device, args.workers)
    print(json.dumps(out), flush=True)
    ok = (out["blocks"] > 0 and not out["forbidden"]
          and out["kernel_vs_native"] == out["kernel_vs_reference"]
          == out["reference_refused"] == out["status_nonzero"] == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
