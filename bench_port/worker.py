"""One client of a cell, in a worker process of its own.

``run.run_cell`` starts one worker a client with ``multiprocessing``'s
``spawn`` method, as a Python imaging service runs its decoders in worker
processes, one interpreter each. A worker pins itself to its CPUs, sets
the configuration's host threads, imports torch, counts the cards and,
once worker 0 has built the program, builds the client's registry and
corpus, warms its calls and checks their route and codestreams. It
reports ready, runs its
closed loop over the window the parent sends (with ``--trace 1`` under
its own profiler over the stretch the parent names), and sends back its
call records, device events, CPU and memory readings, launch counts and
what the check needs: a decode's kept outputs judged here against its own
frames, an encode's picked streams with their frames for the parent's
plain decoder.

The pipe carries, from the worker: ("imported", {"cards", "built"}) once
torch is loaded (worker 0 builds the program first, the only process that
does); then ("ready", info) and ("done", result), or ("error", traceback)
in place of any of them. From the parent: ("go",) once every worker has
imported, or ("stop",); then ("window", start, deadline, lo, hi) or
("stop",).
Times are ``time.perf_counter`` seconds, CLOCK_MONOTONIC, which every
process on the machine shares.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from pathlib import Path

# nothing that loads numpy or torch at import: the host threads are set
# first (``run.set_host_threads``)
from . import run, spec


def serve(conn, job: dict) -> None:
    """The worker's entry: ``job`` holds ``index``, ``seed``, ``cfg``,
    ``mix``, ``here``, ``device``, ``control``, ``trace``, ``spans``,
    ``cpus`` and ``build``."""
    try:
        _serve(conn, job)
    except BaseException:  # noqa: BLE001 - reported, then the worker ends
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
    finally:
        conn.close()


def _sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.perf_counter()))


def _serve(conn, job: dict) -> None:
    os.sched_setaffinity(0, job["cpus"])
    # the parent's last line of standard output is the result
    sys.stdout = sys.stderr
    cfg, mix, i = job["cfg"], job["mix"], int(job["index"])
    threads = cfg["host_threads"]
    t_start = time.perf_counter()
    run.set_host_threads(cfg)
    import torch
    torch.set_num_threads(int(threads["torch"]))
    phases = {"imports": time.perf_counter() - t_start}
    on_card = torch.device(job["device"]).type == "cuda"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    built = None
    if job["build"] and (cards or not on_card):
        t = time.perf_counter()
        built = run.build_program(on_card)
        phases["build"] = time.perf_counter() - t
    conn.send(("imported", {"cards": cards, "built": built}))
    if conn.recv()[0] != "go":
        return

    t = time.perf_counter()
    import go_dicom_codec_torch as gdc
    from go_dicom_codec_torch import _kernels
    from go_dicom_codec_torch.utils import profiling

    from . import reference
    from .clients import Client, set_native_threads

    # a mix may bring a client loop of its own kind (traffic/<module>.py)
    own = spec.load_loop(mix, Path(job["here"]))
    device = torch.device(job["device"])
    client = Client(i, job["seed"], cfg, mix, device, gdc,
                    control=job["control"])
    phases["registry"] = time.perf_counter() - t
    t = time.perf_counter()
    client.make_corpus()
    phases["corpus"] = time.perf_counter() - t
    t = time.perf_counter()
    set_native_threads(threads["setup_native_per_client"])
    client.encode_corpus()
    set_native_threads(threads["native_per_client"])
    phases["corpus_encode"] = time.perf_counter() - t
    t = time.perf_counter()
    route = warm_and_check_route(client, cfg, on_card, not job["control"])
    if not job["control"]:
        check_codestream(client, route["first"], cfg)
    if on_card:
        torch.cuda.synchronize()
    phases["warm"] = time.perf_counter() - t
    tracer = None
    if job["trace"] and on_card:
        from .trace import Tracer
        t = time.perf_counter()
        tracer = Tracer(torch)
        tracer.warm()
        phases["profiler"] = time.perf_counter() - t
    recorder = profiling.enable_global_timer() if job["spans"] else None
    _kernels.reset_launch_counts()
    conn.send(("ready", {
        "pid": os.getpid(), "cpus": sorted(os.sched_getaffinity(0)),
        "phases": phases, "uid": client.uid, "event": route["event"],
        "launches_per_frame": route["launches_per_frame"],
        "compressed_bytes_per_frame": client.compressed_bytes_per_frame(),
        "kind": torch.cuda.get_device_name(device) if on_card
        else device.type}))

    msg = conn.recv()
    if msg[0] != "window":
        return
    start, deadline, lo, hi = msg[1:]
    cpu_start = time.process_time()
    loop = threading.Thread(target=own.loop if own else Client.loop,
                            args=(client, start, deadline))
    loop.start()
    if tracer is not None:
        _sleep_until(lo)
        tracer.start()
        _sleep_until(hi)
        tracer.stop()
    loop.join()
    cpu_end = time.process_time()
    drained = recorder.drain() if recorder is not None else None
    profiling.GLOBAL_TIMER = None
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    out = {"pid": os.getpid(), "calls": client.calls,
           "cpu": cpu_end - cpu_start, "memory_peak_bytes": int(memory_peak),
           "launches": {k: v for k, v in _kernels.launch_counts.items()
                        if v},
           "errors": sorted(set(client.errors)),
           "forbidden": run.forbidden_modules(), "trace": None}
    for c in out["calls"]:
        c["pid"] = out["pid"]
    if tracer is not None:
        out["trace"] = {"t0": tracer.t0, "t1": tracer.t1,
                        "cpu": tracer.cpu1 - tracer.cpu0,
                        "events": tracer.device_events()}
    if drained is not None:
        out["spans"] = tag_spans(drained["spans"], i)
        out["counters"] = drained["counters"]
    out["first_sizes"] = [len(s) for frames in client.first.values()
                          for s in frames]
    client.release()
    if on_card:
        torch.cuda.empty_cache()
    # the check, once the window has closed and the program's state is
    # freed
    if client.op == "encode":
        out["items"], out["differing"] = encode_items(client, job["seed"],
                                                      mix), client.differing
    else:
        out["judged"] = reference.compare_frames(
            (o.frames, client.expected(k)) for k, o in client.kept)
    conn.send(("done", out))


def warm_and_check_route(client, cfg: dict, on_card: bool,
                         check: bool) -> dict:
    """The client's warm calls. With ``check`` they must have taken the
    configured route: the configured kernel launched (on the card; on the
    CPU the kernels' plain versions run and count nothing), and a
    pipelined call's ``pipeline.<op>`` event naming the configured engine.
    Returns the event, the launches per frame and the first warm
    output."""
    from go_dicom_codec_torch import _kernels
    from go_dicom_codec_torch.utils import profiling

    op = client.op
    profiling.EVENTS.pop(f"pipeline.{op}", None)
    _kernels.reset_launch_counts()
    outs = [client.call(k)
            for k in range(int(client.mix["warm_calls_per_client"]))]
    frames = sum(len(o.frames) for o in outs)
    launches = {k: v / frames for k, v in _kernels.launch_counts.items()
                if v}
    event = profiling.EVENTS.get(f"pipeline.{op}")
    if check:
        kernel = cfg["route"][op]
        if on_card and not launches.get(kernel):
            raise RuntimeError(f"route: the warm {op} calls launched "
                               f"{launches}, not {kernel}")
        multi = max(len(o.frames) for o in outs)
        if multi > 1 and (event is None
                          or event["engine"] != cfg["engine"]):
            raise RuntimeError(f"route: the warm {op} calls of {multi} "
                               f"frames logged {event}, not the "
                               f"{cfg['engine']} engine")
    return {"event": event, "launches_per_frame": launches,
            "first": outs[0]}


def check_codestream(client, first, cfg: dict) -> None:
    """The client's first codestream (its corpus for a decode, its first
    warm output for an encode) must carry the configuration's frame and
    coding parameters."""
    from . import reference

    stream = (client.inputs[0] if client.op == "decode" else first)\
        .frames[0]
    wrong = reference.header_mismatches(stream, cfg)
    if wrong:
        raise RuntimeError(f"codestream of client {client.index} is not "
                           f"the configuration's: {'; '.join(wrong)}")


def encode_items(client, seed: int, mix: dict) -> list:
    """This client's share of the frames the plain decoder judges
    (``reference.encode_picks``, drawn from the seed over every client):
    (the first timed output's stream of the picked frame, or None; the
    frame the encode was given)."""
    from . import reference

    items = []
    for ci, obj, i in reference.encode_picks(
            seed, int(mix["clients"]), int(mix["objects_per_client"]),
            int(mix["frames_per_call"]),
            int(mix["check"]["frames_per_client"])):
        if ci != client.index:
            continue
        streams = client.first.get(obj, [])
        items.append((streams[i] if i < len(streams) else None,
                      client.frames[obj][i]))
    return items


def tag_spans(spans: list, index: int) -> list:
    """The drained spans of worker ``index``, their ids (``id``,
    ``parent``, ``call``) made (index, id) so that the spans of all
    workers can be read together, and each tagged with its ``worker``."""
    for s in spans:
        s["id"], s["call"] = (index, s["id"]), (index, s["call"])
        if s["parent"] is not None:
            s["parent"] = (index, s["parent"])
        s["worker"] = index
    return spans
