"""Run one cell of the port's benchmark once and print its result line.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Each of the cell's clients is a worker process of its own
(``worker.py``), started with ``spawn`` at once and pinned to a core pair
of the run's CPUs; this process does not load torch to run a cell. Worker
0 builds the program while the others import; then each worker builds
``go_dicom_codec_torch.make_registry(cuda:0, engine=...)``, makes its
corpus from (seed, client) and warms its calls, all at once; set-up stops
unless those calls took the configured route and wrote codestreams with
the configuration's parameters. Then all of them run closed loops of
codec calls over one window of ``--seconds``. With ``--trace 1`` the
middle half of the window runs under each worker's torch.profiler and the
per-layer metrics are read; otherwise the end-to-end ones. After the
window the outputs of the calls are judged against the reference
(``reference.py``): a decode's sample of calls drawn from the seed, an
encode's frames drawn from the seed over every stretch of a call, with
every output of an object the same bytes.

Earlier lines on standard error describe the machine, the workers and the
route the calls took; the last line on standard output is the result,
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from . import spec


def _process_age() -> float:
    """Seconds since this process started (/proc), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = time.perf_counter() - _process_age()

FORBIDDEN = ("jax", "jaxlib", "flax", "go_dicom_codec_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def set_host_threads(cfg: dict) -> None:
    """The configuration's host threads, before numpy and torch load."""
    threads = cfg["host_threads"]
    os.environ["OMP_NUM_THREADS"] = str(threads["omp"])
    os.environ["MKL_NUM_THREADS"] = str(threads["omp"])
    os.environ["GDCT_THREADS"] = str(threads["native_per_client"])


def client_cpus(cpus: list, clients: int) -> list:
    """The CPUs each client's worker pins itself to: a pair of the run's
    CPUs each where they hold two a client, else the CPUs cut evenly, a
    CPU shared where there are fewer CPUs than clients."""
    n = len(cpus)
    if n >= 2 * clients:
        return [cpus[2 * i:2 * i + 2] for i in range(clients)]
    if n >= clients:
        return [cpus[i * n // clients:(i + 1) * n // clients]
                for i in range(clients)]
    return [[cpus[i % n]] for i in range(clients)]


def _parallel(fns) -> None:
    """Run the callables in threads and raise the first error."""
    errors = []

    def wrap(fn):
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def build_program(on_card: bool) -> dict:
    """Build the program's native library and, for the card, its CUDA
    kernels (a no-op once built in this checkout): fixed paths inside the
    checkout, built by worker 0 alone before any other worker loads
    them."""
    from go_dicom_codec_torch import _kernels, native

    t0 = time.perf_counter()
    out: dict = {"kernels": False}
    jobs = [lambda: out.update(native=native.get_lib() is not None)]
    if on_card:
        jobs.append(lambda: out.update(kernels=_kernels.build()["built"]))
    _parallel(jobs)
    if not out["native"]:
        raise RuntimeError("the native T1/T2 library did not build or load")
    out["seconds"] = time.perf_counter() - t0
    return out


class Workers:
    """The cell's worker processes and their pipes; ``close`` stops and
    waits for every one of them."""

    def __init__(self, jobs: list) -> None:
        import multiprocessing

        from . import worker

        ctx = multiprocessing.get_context("spawn")
        self.procs, self.conns = [], []
        for job in jobs:
            mine, theirs = ctx.Pipe()
            p = ctx.Process(target=worker.serve, args=(theirs, job),
                            daemon=True)
            p.start()
            theirs.close()
            self.procs.append(p)
            self.conns.append(mine)

    def send(self, *msg) -> None:
        for conn in self.conns:
            conn.send(msg)

    def receive(self, kind: str) -> list:
        """Each worker's next message, which must be ``kind``; a worker
        that reports an error or ends without a word raises."""
        got = []
        for i, (conn, p) in enumerate(zip(self.conns, self.procs)):
            try:
                msg = conn.recv()
            except EOFError:
                p.join(10)
                raise RuntimeError(f"worker {i} ended (exit code "
                                   f"{p.exitcode}) without a result")
            if msg[0] != kind:
                raise RuntimeError(f"worker {i}: {msg[1]}")
            got.append(msg[1])
        return got

    def close(self) -> None:
        for conn, p in zip(self.conns, self.procs):
            if p.is_alive():
                try:
                    conn.send(("stop",))
                except OSError:
                    pass
            conn.close()
        for p in self.procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
                p.join()


def merge(results: list) -> dict:
    """One run's records from the workers' results: the calls in the order
    of ``t0``; the CPU seconds of every worker summed, as ``(0, sum)``; the
    traced stretch every worker covered, with every worker's device events
    clipped to it (``events``: a reader that unions them counts two
    contexts' overlapping operations once), the device seconds of each
    operation name split among the contexts that ran in turns
    (``device_s``, ``arith.split_seconds``) and their CPU there summed."""
    from . import arith

    calls = sorted((c for r in results for c in r["calls"]),
                   key=lambda c: c["t0"])
    run = {"calls": calls, "cpu": (0.0, sum(r["cpu"] for r in results)),
           "trace": None}
    traces = [r["trace"] for r in results if r["trace"] is not None]
    if traces:
        lo = max(tr["t0"] for tr in traces)
        hi = min(tr["t1"] for tr in traces)
        sources = [[(n, max(s, lo), min(e, hi)) for n, s, e in tr["events"]
                    if min(e, hi) > max(s, lo)] for tr in traces]
        run["trace"] = {"t0": lo, "t1": hi,
                        "cpu": (0.0, sum(tr["cpu"] for tr in traces)),
                        "events": [ev for src in sources for ev in src],
                        "device_s": arith.split_seconds(sources)}
    if any("spans" in r for r in results):
        run["spans"] = [s for r in results for s in r.get("spans", [])]
        counters: dict = {}
        for r in results:
            for k, v in r.get("counters", {}).items():
                counters[k] = counters.get(k, 0) + v
        run["counters"] = counters
    return run


def breakdown(run: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the clients were doing."""
    from . import arith

    tr = run["trace"]
    ops = sorted(tr["device_s"].items(), key=lambda kv: -kv[1])[:10]
    calls = run["calls"]
    named = []
    for s, e in sorted(arith.gaps(tr["events"], tr["t0"], tr["t1"]),
                       key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        busy = [c["op"] for c in calls if c["t0"] <= mid <= c["t1"]]
        named.append([f"codec.{busy[0]}" if busy else "outside_calls",
                      e - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def _rounded(phases: dict) -> str:
    return json.dumps({k: round(v, 3) for k, v in phases.items()})


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             control: bool = False, device=None, root=spec.ROOT,
             here=spec.HERE, spans: bool = False) -> dict:
    """Run ``workload`` once; returns the result and what it was read
    from. ``root`` holds BENCHMARK.json and ``here`` the configs, mixes and
    readers. ``device`` other than the card (a torch device or its name)
    is for the harness's own tests (no card check, no traced window).
    ``control`` runs the configuration's control in place of its transfer
    syntax (``control.py``); ``spans`` installs the program's recorder in
    each worker from the end of its set-up until its client has stopped
    (``spans.py``)."""
    phases = {"start": time.perf_counter() - T_PROCESS}
    bench = spec.load_benchmark(root)
    cell = spec.find_cell(bench, workload)
    cfg = spec.load_config(cell["config"], here)
    mix = spec.load_traffic(cell["traffic"], here)
    n = int(mix["clients"])
    cpus = client_cpus(sorted(os.sched_getaffinity(0)), n)
    cuda_at_start = _cuda_initialized()
    dev = "cuda:0" if device is None else str(device)
    on_card = dev.startswith("cuda")
    t = time.perf_counter()
    workers = Workers([{
        "index": i, "seed": seed, "cfg": cfg, "mix": mix, "here": str(here),
        "device": dev, "control": control, "trace": trace, "spans": spans,
        "cpus": cpus[i], "build": i == 0} for i in range(n)])
    phases["spawn"] = time.perf_counter() - t
    try:
        from . import arith, host, reference

        threads = cfg["host_threads"]
        log(f"host: {host.affinity_count()} CPUs in this process's "
            f"affinity, cgroup cpu.max {host.cpu_max()!r}; {n} worker "
            f"processes, one a client, GDCT_THREADS "
            f"{threads['native_per_client']} each "
            f"({threads['setup_native_per_client']} in the corpus encode), "
            f"torch threads {threads['torch']}, OMP_NUM_THREADS "
            f"{threads['omp']}; torch.cuda initialized in this process "
            f"when the workers started: {cuda_at_start}")
        t = time.perf_counter()
        imported = workers.receive("imported")
        phases["imports_and_build"] = time.perf_counter() - t
        if on_card and imported[0]["cards"] < cell["chips"]:
            raise SystemExit(f"no result: this cell needs {cell['chips']} "
                             f"CUDA device(s), found {imported[0]['cards']}")
        built = imported[0]["built"]
        workers.send("go")
        t = time.perf_counter()
        ready = workers.receive("ready")
        phases["workers"] = time.perf_counter() - t
        log(f"set-up: {_rounded(phases)}, kernels built {built['kernels']}")
        for i, r in enumerate(ready):
            log(f"worker {i}: pid {r['pid']}, CPUs {r['cpus']}, set-up "
                f"{_rounded(r['phases'])}")
        log(f"route: {mix['op']} through make_registry({dev}, engine="
            f"{cfg['engine']!r}).get_codec({ready[0]['uid']}); client 0's "
            f"event {json.dumps(ready[0]['event'])}, kernel launches a "
            f"frame {json.dumps(ready[0]['launches_per_frame'])}"
            + (" (the control's lossy path)" if control else
               "; every client's route and codestreams checked"))
        if mix["op"] == "decode":
            per = [round(r["compressed_bytes_per_frame"], 1) for r in ready]
            raw = cfg["frame"]["rows"] * cfg["frame"]["columns"] * \
                cfg["frame"]["bits_allocated"] // 8
            log(f"corpus: compressed bytes a frame by client {per}, ratio "
                f"{raw * len(per) / sum(per):.3f}:1")

        start = time.perf_counter() + 0.05
        deadline = start + seconds
        setup_s = start - T_PROCESS
        workers.send("window", start, deadline, start + seconds / 4,
                     start + 3 * seconds / 4)
        results = workers.receive("done")
    finally:
        workers.close()

    found = sorted({m for r in results for m in r["forbidden"]})
    if found:
        raise SystemExit(f"no result: a worker loaded {found}")
    run = {"workload": workload, "config": cfg, "traffic": mix,
           "start": start, "deadline": deadline, "setup_s": setup_s,
           **merge(results)}
    calls = run["calls"]
    launches: dict = {}
    for r in results:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    frames = sum(r["frames"] for r in calls) or 1
    log(f"window: worker CPU {run['cpu'][1]:.3f} s; kernel launches a "
        f"frame, all clients "
        + json.dumps({k: v / frames for k, v in launches.items()}))
    if mix["op"] == "encode":
        sizes = [s for r in results for s in r["first_sizes"]]
        log(f"window: compressed bytes a frame of the first encodes "
            f"{sum(sizes) / len(sizes) if sizes else 0.0:.1f}")
    if on_card:
        # nvidia-smi once the window has closed, outside the set-up
        log(f"card: {host.card_line()}")

    device_info = {"platform": "gpu" if on_card else dev,
                   "kind": ready[0]["kind"] if on_card else "cpu",
                   "count": cell["chips"],
                   # the card holds every worker's memory at once
                   "memory_peak_bytes": sum(r["memory_peak_bytes"]
                                            for r in results)}
    if run["trace"] is not None:
        device_info["busy_s"] = arith.busy_seconds(run["trace"]["events"])
        device_info["window_s"] = run["trace"]["t1"] - run["trace"]["t0"]

    limits = dict(reference.LOSSLESS_LIMITS)
    if mix["op"] == "encode":
        # the plain decoder is slow: a few frames, drawn from the seed
        # over every stretch of a call and every client, judge each
        # object's first output; every later output of the object must be
        # the same bytes
        judged = reference.compare_encoded(
            [item for r in results for item in r["items"]],
            workers=min(8, host.affinity_count()))
        judged["frames_differing"] = sum(r["differing"] for r in results)
        limits["frames_differing"] = 0
    else:
        judged = reference.add_judged([r["judged"] for r in results])
    failed = sum(1 for r in calls if not r["ok"])
    correct, checks = reference.verdict(judged, limits, failed)
    metrics = spec.read_metrics(spec.cell_metrics(bench, workload, trace),
                                run, here)
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": failed, "metrics": metrics, "device": device_info}
    if run["trace"] is not None:
        result["breakdown"] = breakdown(run)
    result["checks"] = checks
    errors = sorted({e for r in results for e in r["errors"]})
    return {"result": result, "run": run, "judged": judged,
            "errors": errors, "cuda_at_start": cuda_at_start,
            "workers": [{"pid": r["pid"], "cpus": r["cpus"]}
                        for r in ready]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace))
    res = out["result"]
    calls = out["run"]["calls"]
    per_client = {}
    for r in calls:
        per_client.setdefault(r["client"], [0, 0])
        per_client[r["client"]][0] += 1
        per_client[r["client"]][1] += r["frames"]
    log(f"window: calls and frames by client {json.dumps(per_client)}; "
        f"judged {json.dumps(out['judged'])}")
    for err in out["errors"][:5]:
        log(f"error in a call: {err}")
    found = forbidden_modules()
    if found:
        log(f"no result: the run loaded {found}")
        return 4
    for name, c in res["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
