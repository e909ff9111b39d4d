"""The control of ``correct``: a cell run with the program's lossy path of
the same family (the configuration's ``control``: .91 for .90, .203 for
.201, at quality 100) in place of the lossless one, at the cell's own size
and load. Its readings must fail the lossless limits; the benchmark's own
runs never run it.

    python3 -m bench_port.control --workload <cell> --seeds 1,2,3 \
        [--seconds 10] [--sound]

Each seed runs after the last, with worker processes of its own, as
``bench_port.run`` starts them; ``--sound`` runs the program as
configured instead, for the lower readings. One line a seed:
``CONTROL {json}`` with the compared numbers and the verdict.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(args.workload, seed, args.seconds, False,
                           control=not args.sound)
        res = out["result"]
        print("CONTROL " + json.dumps({
            "workload": args.workload, "seed": seed,
            "control": not args.sound, "correct": res["correct"],
            "attempted": res["attempted"], "judged": out["judged"],
            "checks": res["checks"], "metrics": res["metrics"],
            "errors": out["errors"][:3]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
