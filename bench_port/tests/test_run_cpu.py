"""The harness driven end to end on the CPU at a tiny size, with the
timed path sound, broken underneath, and replaced by the control."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from bench_port import run

CPU = torch.device("cpu")
CELLS = ["ct-j2k-lossless.series-decode", "ct-j2k-lossless.frame-decode",
         "ct-j2k-lossless.series-encode"]


def run_tiny(tiny, cell, **kw):
    root, here = tiny
    return run.run_cell(cell, 2**31 + 99, 0.3, False, device=CPU,
                        root=root, here=here, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    out = run_tiny(tiny, cell)
    res = out["result"]
    assert res["correct"], (res, out["errors"])
    assert res["failed"] == 0 and res["attempted"] >= 1
    op = "encode" if cell.endswith("encode") else "decode"
    assert res["metrics"][f"{op}_frames_per_s"]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0
    assert out["judged"]["frames_checked"] >= 1
    assert list(res)[-1] == "checks"


# A fault is planted in the workers through a loop module the mix names
# (``traffic/<module>.py``, imported by each worker as a mix's own loop):
# it wraps the client's timed calls, so the warm calls stay sound.
PLANTED = """
from bench_port.clients import Client

FAULT = {fault!r}


def loop(client, start, deadline):
    real = client.call
    timed = [0]

    def call(k):
        timed[0] += 1
        out = real(k)
        if FAULT == "half":
            keep = len(out.frames) // 2
            out.frames = out.frames[:keep]
        elif FAULT == "altered":
            # a decoded frame's first sample, or a byte of coded data near
            # the end of every codestream
            for i in range(len(out.frames) if out.encapsulated else 1):
                frame = bytearray(out.frames[i])
                frame[-10 if out.encapsulated else 0] ^= 1
                out.frames[i] = bytes(frame)
        elif FAULT == "one_position":
            # one stretch of every call (one chunk of the pipeline): its
            # last frame's first sample, or a coded byte near its end
            frame = bytearray(out.frames[-1])
            frame[-10 if out.encapsulated else 0] ^= 1
            out.frames[-1] = bytes(frame)
        elif FAULT == "one_call" and timed[0] == 3:
            # one frame of one timed call, not an object's first output
            frame = bytearray(out.frames[0])
            frame[-10] ^= 1
            out.frames[0] = bytes(frame)
        elif FAULT == "raises" and timed[0] > 1:
            raise RuntimeError("a planted failure")
        return out
    client.call = call
    Client.loop(client, start, deadline)
"""


def plant(tiny, cell, source, name="planted"):
    """Write ``source`` as a loop module and make the cell's mix name it."""
    _, here = tiny
    (here / "traffic" / f"{name}.py").write_text(source)
    mix_path = here / "traffic" / f"{cell.split('.', 1)[1]}.json"
    mix = json.loads(mix_path.read_text())
    mix["loop_module"] = name
    mix_path.write_text(json.dumps(mix))


# one altered call is the encode's to catch (every output against the
# object's first); a decode judges a sample of whole calls
FAULTS = [(cell, fault) for cell in CELLS
          for fault in ("half", "altered", "one_position", "one_call",
                        "raises")
          if fault != "one_call" or cell.endswith("encode")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    plant(tiny, cell, PLANTED.format(fault=fault))
    res = run_tiny(tiny, cell)["result"]
    assert res["correct"] is False, res
    worst = {k: v["value"] for k, v in res["checks"].items()
             if v["value"] > v["limit"]}
    assert worst, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, cell):
    """The program's lossy path of the same family in place of the
    lossless one breaks the configuration's guarantee."""
    res = run_tiny(tiny, cell, control=True)["result"]
    assert res["correct"] is False
    assert res["checks"]["mismatched_samples"]["value"] > 0


@pytest.mark.parametrize("control", [False, True])
def test_a_configuration_is_a_file_and_entries_away(tiny, control):
    """A configuration in no cell yet, HTJ2K lossless (.201), added as a
    new file and BENCHMARK.json entries alone: it runs, its codestreams
    pass the set-up's header check, and its control (.203) fails."""
    root, here = tiny
    cfg = json.loads((here / "configs" / "ct-j2k-lossless.json").read_text())
    cfg.update(name="ct-htj2k-lossless",
               transfer_syntax="1.2.840.10008.1.2.4.201",
               codestream={"code-block style": 0x40, "guard bits": 1},
               control={"transfer_syntax": "1.2.840.10008.1.2.4.203",
                        "parameters": {"quality": 100}})
    (here / "configs" / "ct-htj2k-lossless.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = "ct-htj2k-lossless.series-decode"
    bench["configs"].append({"name": "ct-htj2k-lossless", "source": "x",
                             "file": "bench_port/configs/"
                             "ct-htj2k-lossless.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": name, "config": "ct-htj2k-lossless",
                               "traffic": "series-decode", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"].startswith("decode_frames"):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_tiny(tiny, name, control=control)["result"]
    assert res["correct"] is (not control)
    assert res["metrics"]["decode_frames_per_s"]["value"] > 0


# a loop module imported before the worker builds its client: the
# encodes leave every coding parameter to the program's defaults
DEFAULT_PARAMETERS = """
from bench_port.clients import Client

Client._parameters = lambda self, values: None
loop = Client.loop
"""


@pytest.mark.parametrize("cell", CELLS)
def test_set_up_refuses_codestreams_unlike_the_configuration(tiny, cell):
    """Coding parameters left to the program's defaults, where they differ
    from the configuration's, stop the run before its window."""
    root, here = tiny
    path = here / "configs" / "ct-j2k-lossless.json"
    cfg = json.loads(path.read_text())
    cfg["parameters"]["num_levels"] = 3
    path.write_text(json.dumps(cfg))
    plant(tiny, cell, DEFAULT_PARAMETERS)
    with pytest.raises(RuntimeError, match="levels: 5, expected 3"):
        run_tiny(tiny, cell)


def test_the_workers_calls_come_back_merged_and_tagged(tiny):
    """Two workers, each its own process: their calls come back in the
    order of their starts, each client's from one PID of its own, and the
    spans of both (``spans=True``) with ids that do not collide."""
    root, here = tiny
    out = run.run_cell(CELLS[0], 17, 0.3, False, device=CPU, root=root,
                       here=here, spans=True)
    calls = out["run"]["calls"]
    assert out["result"]["correct"], out["result"]
    assert [c["t0"] for c in calls] == sorted(c["t0"] for c in calls)
    pids = {c["client"]: set() for c in calls}
    for c in calls:
        pids[c["client"]].add(c["pid"])
    assert sorted(pids) == [0, 1]
    assert all(len(p) == 1 for p in pids.values())
    assert len(set.union(*pids.values())) == 2
    assert os.getpid() not in set.union(*pids.values())
    assert [w["pid"] for w in out["workers"]] == [
        pids[0].pop(), pids[1].pop()]
    spans = out["run"]["spans"]
    assert {s["worker"] for s in spans} == {0, 1}
    assert len({s["id"] for s in spans}) == len(spans)
    roots = [s for s in spans if s["id"] == s["call"]]
    assert {s["name"] for s in roots} == {"codec.decode"}
    assert out["run"]["counters"]["frames.decode"] >= sum(
        c["frames"] for c in calls)


def test_the_parent_holds_no_cuda_state_when_the_workers_start(tiny,
                                                                monkeypatch):
    """The parent starts its workers before it touches CUDA, and touches
    none of torch.cuda's state afterwards (a CPU run: the card check
    reads a count and no more); each worker pins itself to its share of
    the parent's CPUs."""
    def touched():
        raise AssertionError("the parent initialised torch.cuda")
    monkeypatch.setattr(torch.cuda, "_lazy_init", touched)
    out = run_tiny(tiny, CELLS[0])
    assert out["result"]["correct"]
    assert out["cuda_at_start"] is False
    assert not torch.cuda.is_initialized()
    cpus = run.client_cpus(sorted(os.sched_getaffinity(0)), 2)
    assert [w["cpus"] for w in out["workers"]] == cpus


@pytest.mark.parametrize("n_cpus,clients,want", [
    (8, 4, [[0, 1], [2, 3], [4, 5], [6, 7]]),
    (32, 4, [[0, 1], [2, 3], [4, 5], [6, 7]]),
    (6, 4, [[0], [1, 2], [3], [4, 5]]),
    (4, 4, [[0], [1], [2], [3]]),
    (2, 4, [[0], [1], [0], [1]]),
    (1, 2, [[0], [0]])])
def test_each_client_gets_a_core_pair_or_an_even_share(n_cpus, clients,
                                                       want):
    assert run.client_cpus(list(range(n_cpus)), clients) == want


def test_merged_device_events_of_two_workers_count_once():
    """Two workers' traced stretches and overlapping events: the merged
    trace is the stretch both covered, its events clipped to it, and the
    busy time counts an overlap once; CPU, calls and counters add up."""
    from bench_port import arith

    def result(pid, t0, t1, events, cpu, trace_cpu):
        return {"pid": pid, "cpu": cpu, "calls": [
                    {"client": pid, "op": "decode", "t0": t0 + 0.1,
                     "t1": t1, "frames": 2, "ok": True}],
                "trace": {"t0": t0, "t1": t1, "cpu": trace_cpu,
                          "events": events},
                "spans": [], "counters": {"frames.decode": 2}}
    a = result(0, 1.0, 3.0, [("k", 1.0, 2.0), ("c", 2.5, 2.9)], 5.0, 2.0)
    b = result(1, 1.2, 3.1, [("k", 1.5, 2.2), ("k", 0.9, 1.25)], 4.0, 1.5)
    merged = run.merge([a, b])
    tr = merged["trace"]
    assert (tr["t0"], tr["t1"]) == (1.2, 3.0)
    assert sorted(tr["events"]) == sorted([
        ("k", 1.2, 2.0), ("c", 2.5, 2.9), ("k", 1.5, 2.2),
        ("k", 1.2, 1.25)])
    # [1.2, 2.2] and [2.5, 2.9]: the overlap of the two workers' "k" once
    assert arith.busy_seconds(tr["events"]) == pytest.approx(1.4)
    # where both workers' "k" are open the later start takes the instant:
    # the device seconds add up to the busy time
    assert tr["device_s"] == pytest.approx({"k": 1.0, "c": 0.4})
    assert merged["cpu"] == (0.0, 9.0) and tr["cpu"] == (0.0, 3.5)
    assert [c["client"] for c in merged["calls"]] == [0, 1]
    assert merged["counters"] == {"frames.decode": 4}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxfoo", "go_dicom_codec_tpu_extra", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "go_dicom_codec_tpu.ops",
                        types.ModuleType("go_dicom_codec_tpu.ops"))
    assert run.forbidden_modules() == ["go_dicom_codec_tpu", "jax"]


def test_a_dry_run_loads_no_jax(tmp_path):
    """One client's tiny CPU run, in a fresh process: neither jax, jaxlib,
    flax nor the JAX package is loaded, in the worker (its own check, else
    no result) or here, and this process loads no torch: the port runs in
    the worker."""
    code = (
        "import json, sys\n"
        "from bench_port import run\n"
        "from bench_port.tests.conftest import make_tiny\n"
        f"root, here = make_tiny(__import__('pathlib').Path({str(tmp_path)!r}),"
        " clients=1)\n"
        "out = run.run_cell('ct-j2k-lossless.series-decode', 5, 0.2, False,"
        " device='cpu', root=root, here=here)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([out['result']['correct'], run.forbidden_modules(),"
        " 'torch' in tops]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=run.spec.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [True, [], False]


def test_no_card_means_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                  "--trace", "0"])
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""


def test_checks_compare_each_sample():
    from bench_port import reference
    want = np.arange(12, dtype=np.uint16).reshape(2, 2, 3)
    got = [want[0].astype("<u2").tobytes(), want[1].astype("<u2").tobytes()]
    ok = reference.compare_frames([(got, want)])
    assert ok == {"frames_checked": 2, "frames_missing": 0,
                  "mismatched_samples": 0, "max_abs_diff": 0}
    bad = reference.compare_frames([(got[:1], want)])
    assert bad["frames_missing"] == 1
    off = want.copy()
    off[1, 1, 2] += 3
    worse = reference.compare_frames([(got, off)])
    assert worse["mismatched_samples"] == 1 and worse["max_abs_diff"] == 3
    correct, checks = reference.verdict(worse, reference.LOSSLESS_LIMITS, 0)
    assert not correct and checks["max_abs_diff"] == {"value": 3, "limit": 0}


def test_encode_picks_cover_every_stretch_and_client():
    from bench_port import reference
    picks = reference.encode_picks(2**31 + 7, 4, 2, 32, 2)
    assert picks == reference.encode_picks(2**31 + 7, 4, 2, 32, 2)
    assert picks != reference.encode_picks(2**31 + 8, 4, 2, 32, 2)
    # stratum s holds frames 4s .. 4s + 3: every chunk of 4 is judged
    assert [f // 4 for _, _, f in picks] == list(range(8))
    for c in range(4):
        assert sorted(o for ci, o, _ in picks if ci == c) == [0, 1]
    # more picks than frames: each frame still judged once at least
    few = reference.encode_picks(3, 2, 2, 3, 2)
    assert {f for _, _, f in few} == {0, 1, 2}


def test_header_check_reads_what_the_encode_wrote():
    from bench_port import reference
    from go_dicom_codec_torch.codecs import jpeg2000
    cfg = json.loads((run.spec.HERE / "configs" / "ct-j2k-lossless.json")
                     .read_text())
    cfg["frame"].update(rows=40, columns=56)
    frame = np.random.default_rng(0).integers(0, 4096, (40, 56)) \
        .astype("<u2")
    p = jpeg2000.J2KEncodeParams(lossless=True, cb_style=1)
    stream = jpeg2000.J2KEncoder(p, device=CPU, engine="host").encode(
        frame.tobytes(), 56, 40, 1, 12, False)
    assert reference.header_mismatches(stream, cfg) == []
    cfg["parameters"].update(cb_width=32, num_levels=4)
    assert sorted(reference.header_mismatches(stream, cfg)) == [
        "code-block: [64, 64], expected [32, 64]",
        "levels: 5, expected 4"]
    assert reference.header_mismatches(b"\x00" * 8, cfg)[0].startswith(
        "unreadable")
