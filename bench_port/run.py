"""Run one cell of the port's benchmark once and print its result line.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's clients are threads of this one process, the only process on
the card. Each builds ``go_dicom_codec_torch.make_registry(cuda:0,
engine=...)``, makes its corpus from (seed, client), and warms its calls,
all clients at once; set-up stops unless those calls took the configured
route and wrote codestreams with the configuration's parameters. Then all
of them run closed loops of codec calls over one window of
``--seconds``. With ``--trace 1`` the middle half of the window runs
under torch.profiler and the per-layer metrics are read; otherwise the
end-to-end ones. After the window the outputs of the calls are judged
against the reference (``reference.py``): a decode's sample of calls
drawn from the seed, an encode's frames drawn from the seed over every
stretch of a call, with every output of an object the same bytes.

Earlier lines on standard error describe the machine and the route the
calls took; the last line on standard output is the result, JSON.
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
    checkout."""
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


def warm_and_check_route(clients, cfg: dict, on_card: bool,
                         check: bool) -> dict:
    """Every client's warm calls, all at once. With ``check`` they must
    have taken the configured route: the configured kernel launched (on
    the card; on the CPU the kernels' plain versions run and count
    nothing), and a pipelined call's ``pipeline.<op>`` event naming the
    configured engine. Returns the event, the launches per frame and each
    client's first warm output."""
    from go_dicom_codec_torch import _kernels
    from go_dicom_codec_torch.utils import profiling

    op = clients[0].op
    profiling.EVENTS.pop(f"pipeline.{op}", None)
    _kernels.reset_launch_counts()
    warm = int(clients[0].mix["warm_calls_per_client"])
    outs: dict = {}
    _parallel([lambda c=c: outs.setdefault(c.index, [
        c.call(k) for k in range(warm)]) for c in clients])
    frames = sum(len(o.frames) for got in outs.values() for o in got)
    launches = {k: v / frames for k, v in _kernels.launch_counts.items()
                if v}
    event = profiling.EVENTS.get(f"pipeline.{op}")
    if check:
        kernel = cfg["route"][op]
        if on_card and not launches.get(kernel):
            raise RuntimeError(f"route: the warm {op} calls launched "
                               f"{launches}, not {kernel}")
        multi = max(len(o.frames) for got in outs.values() for o in got)
        if multi > 1 and (event is None
                          or event["engine"] != cfg["engine"]):
            raise RuntimeError(f"route: the warm {op} calls of {multi} "
                               f"frames logged {event}, not the "
                               f"{cfg['engine']} engine")
    return {"event": event, "launches_per_frame": launches,
            "first": {i: got[0] for i, got in outs.items()}}


def check_codestreams(clients, first: dict, cfg: dict) -> None:
    """The first codestream of each client (its corpus for a decode, its
    first warm output for an encode) must carry the configuration's frame
    and coding parameters."""
    from . import reference

    for c in clients:
        stream = (c.inputs[0] if c.op == "decode" else first[c.index])\
            .frames[0]
        wrong = reference.header_mismatches(stream, cfg)
        if wrong:
            raise RuntimeError(f"codestream of client {c.index} is not the "
                               f"configuration's: {'; '.join(wrong)}")


def breakdown(run: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the clients were doing."""
    from . import arith

    tr = run["trace"]
    ops = sorted(arith.seconds_by_name(tr["events"]).items(),
                 key=lambda kv: -kv[1])[:10]
    calls = run["calls"]
    named = []
    for s, e in sorted(arith.gaps(tr["events"], tr["t0"], tr["t1"]),
                       key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        busy = [c["op"] for c in calls if c["t0"] <= mid <= c["t1"]]
        named.append([f"codec.{busy[0]}" if busy else "outside_calls",
                      e - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             control: bool = False, device=None, root=spec.ROOT,
             here=spec.HERE) -> dict:
    """Run ``workload`` once; returns the result and what it was read
    from. ``root`` holds BENCHMARK.json and ``here`` the configs, mixes and
    readers. ``device`` other than the card is for the harness's own
    tests (no card check, no traced window)."""
    phases = {"start": time.perf_counter() - T_PROCESS}
    bench = spec.load_benchmark(root)
    cell = spec.find_cell(bench, workload)
    cfg = spec.load_config(cell["config"], here)
    mix = spec.load_traffic(cell["traffic"], here)
    set_host_threads(cfg)

    t = time.perf_counter()
    import numpy as np
    import torch
    phases["imports"] = time.perf_counter() - t

    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"no result: this cell needs {cell['chips']} "
                             f"CUDA device(s), found "
                             f"{torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    from . import arith, host, reference
    from .clients import Client, set_native_threads

    threads = cfg["host_threads"]
    log(f"host: {host.affinity_count()} CPUs in this process's affinity, "
        f"cgroup cpu.max {host.cpu_max()!r}; {mix['clients']} client "
        f"threads, GDCT_THREADS {threads['native_per_client']} each "
        f"({threads['setup_native_per_client']} in the corpus encode), "
        f"torch threads {threads['torch']}, OMP_NUM_THREADS "
        f"{threads['omp']}")
    torch.set_num_threads(int(threads["torch"]))
    t = time.perf_counter()
    built = build_program(on_card)
    phases["build"] = time.perf_counter() - t
    import go_dicom_codec_torch as gdc

    t = time.perf_counter()
    clients = [Client(i, seed, cfg, mix, device, gdc, control=control)
               for i in range(int(mix["clients"]))]
    phases["registries"] = time.perf_counter() - t
    t = time.perf_counter()
    _parallel([c.make_corpus for c in clients])
    phases["corpus"] = time.perf_counter() - t
    t = time.perf_counter()
    set_native_threads(threads["setup_native_per_client"])
    _parallel([c.encode_corpus for c in clients])
    set_native_threads(threads["native_per_client"])
    phases["corpus_encode"] = time.perf_counter() - t
    t = time.perf_counter()
    route = warm_and_check_route(clients, cfg, on_card, not control)
    if not control:
        check_codestreams(clients, route["first"], cfg)
    if on_card:
        torch.cuda.synchronize()
    phases["warm"] = time.perf_counter() - t
    tracer = None
    if trace and on_card:
        from .trace import Tracer
        t = time.perf_counter()
        tracer = Tracer(torch)
        tracer.warm()
        phases["profiler"] = time.perf_counter() - t
    log(f"set-up: {json.dumps({k: round(v, 3) for k, v in phases.items()})}"
        f", kernels built {built['kernels']}")
    log(f"route: {mix['op']} through make_registry({device}, engine="
        f"{cfg['engine']!r}).get_codec({clients[0].uid}); "
        + f"event {json.dumps(route['event'])}, kernel launches a frame "
        f"{json.dumps(route['launches_per_frame'])}"
        + (" (the control's lossy path)" if control else
           "; codestreams carry the configuration's parameters"))
    if mix["op"] == "decode":
        per = [round(c.compressed_bytes_per_frame(), 1) for c in clients]
        raw = cfg["frame"]["rows"] * cfg["frame"]["columns"] * \
            cfg["frame"]["bits_allocated"] // 8
        log(f"corpus: compressed bytes a frame by client {per}, ratio "
            f"{raw * len(per) / sum(per):.3f}:1")

    from go_dicom_codec_torch import _kernels
    _kernels.reset_launch_counts()
    # a mix may bring a client loop of its own kind (traffic/<module>.py)
    own = spec.load_loop(mix, here)
    start = time.perf_counter() + 0.05
    deadline = start + seconds
    setup_s = start - T_PROCESS
    cpu_start = time.process_time()
    loops = [threading.Thread(
        target=own.loop if own else Client.loop, args=(c, start, deadline))
        for c in clients]
    for th in loops:
        th.start()
    if tracer is not None:
        time.sleep(max(0.0, start + seconds / 4 - time.perf_counter()))
        tracer.start()
        time.sleep(max(0.0, start + 3 * seconds / 4 - time.perf_counter()))
        tracer.stop()
    for th in loops:
        th.join()
    cpu_end = time.process_time()
    calls = sorted((r for c in clients for r in c.calls),
                   key=lambda r: r["t0"])
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"no result: the run loaded {found}")
    frames = sum(r["frames"] for r in calls) or 1
    log(f"window: process CPU {cpu_end - cpu_start:.3f} s; kernel launches "
        f"a frame, all clients "
        + json.dumps({k: v / frames for k, v in
                      _kernels.launch_counts.items() if v}))
    if mix["op"] == "encode":
        sizes = [len(s) for c in clients for frames in c.first.values()
                 for s in frames]
        log(f"window: compressed bytes a frame of the first encodes "
            f"{float(np.mean(sizes)) if sizes else 0.0:.1f}")
    for c in clients:
        c.release()
    if on_card:
        torch.cuda.empty_cache()
        # nvidia-smi once the window has closed, outside the set-up
        log(f"card: {host.card_line()}")

    run = {"workload": workload, "config": cfg, "traffic": mix,
           "calls": calls, "start": start, "deadline": deadline,
           "setup_s": setup_s, "cpu": (cpu_start, cpu_end), "trace": None}
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card
                   else "cpu",
                   "count": cell["chips"],
                   "memory_peak_bytes": int(memory_peak)}
    if tracer is not None:
        events = tracer.device_events()
        run["trace"] = {"t0": tracer.t0, "t1": tracer.t1,
                        "cpu": (tracer.cpu0, tracer.cpu1),
                        "events": events}
        device_info["busy_s"] = arith.busy_seconds(events)
        device_info["window_s"] = tracer.t1 - tracer.t0

    limits = dict(reference.LOSSLESS_LIMITS)
    if mix["op"] == "encode":
        # the plain decoder is slow: a few frames, drawn from the seed
        # over every stretch of a call and every client, judge each
        # object's first output; every later output of the object must be
        # the same bytes
        items = []
        for ci, obj, i in reference.encode_picks(
                seed, len(clients), int(mix["objects_per_client"]),
                int(mix["frames_per_call"]),
                int(mix["check"]["frames_per_client"])):
            c = clients[ci]
            streams = c.first.get(obj, [])
            items.append((streams[i] if i < len(streams) else None,
                          c.frames[obj][i]))
        judged = reference.compare_encoded(
            items, workers=min(8, host.affinity_count()))
        judged["frames_differing"] = sum(c.differing for c in clients)
        limits["frames_differing"] = 0
    else:
        judged = reference.compare_frames(
            (out.frames, c.expected(k)) for c in clients for k, out in c.kept)
    failed = sum(1 for r in calls if not r["ok"])
    correct, checks = reference.verdict(judged, limits, failed)
    metrics = spec.read_metrics(spec.cell_metrics(bench, workload, trace),
                                run, here)
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": failed, "metrics": metrics, "device": device_info}
    if run["trace"] is not None:
        result["breakdown"] = breakdown(run)
    result["checks"] = checks
    errors = sorted({e for c in clients for e in c.errors})
    return {"result": result, "run": run, "judged": judged,
            "errors": errors, "clients": clients}


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
