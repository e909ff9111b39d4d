"""The harness driven end to end on the CPU at a tiny size, with the
timed path sound, broken underneath, and replaced by the control."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from bench_port import clients, run

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


def _broken(monkeypatch, fault):
    real = clients.Client.call

    def call(self, k):
        # the warm calls (at most two a client) stay sound
        self.planted_calls = getattr(self, "planted_calls", 0) + 1
        out = real(self, k)
        if fault == "half":
            keep = len(out.frames) // 2
            out.frames = out.frames[:keep]
        elif fault == "altered":
            # a decoded frame's first sample, or a byte of coded data near
            # the end of every codestream
            for i in range(len(out.frames) if out.encapsulated else 1):
                frame = bytearray(out.frames[i])
                frame[-10 if out.encapsulated else 0] ^= 1
                out.frames[i] = bytes(frame)
        elif fault == "one_position":
            # one stretch of every call (one chunk of the pipeline): its
            # last frame's first sample, or a coded byte near its end
            frame = bytearray(out.frames[-1])
            frame[-10 if out.encapsulated else 0] ^= 1
            out.frames[-1] = bytes(frame)
        elif fault == "one_call" and self.planted_calls == 4:
            # one frame of one timed call, not an object's first output
            frame = bytearray(out.frames[0])
            frame[-10] ^= 1
            out.frames[0] = bytes(frame)
        elif fault == "raises" and self.planted_calls > 2:
            raise RuntimeError("a planted failure")
        return out
    monkeypatch.setattr(clients.Client, "call", call)


# one altered call is the encode's to catch (every output against the
# object's first); a decode judges a sample of whole calls
FAULTS = [(cell, fault) for cell in CELLS
          for fault in ("half", "altered", "one_position", "one_call",
                        "raises")
          if fault != "one_call" or cell.endswith("encode")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
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


@pytest.mark.parametrize("cell", CELLS)
def test_set_up_refuses_codestreams_unlike_the_configuration(tiny, cell):
    """Coding parameters left to the program's defaults, where they differ
    from the configuration's, stop the run before its window."""
    root, here = tiny
    path = here / "configs" / "ct-j2k-lossless.json"
    cfg = json.loads(path.read_text())
    cfg["parameters"]["num_levels"] = 3
    path.write_text(json.dumps(cfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(clients.Client, "_parameters", lambda self, values: None)
        with pytest.raises(RuntimeError, match="levels: 5, expected 3"):
            run_tiny(tiny, cell)


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
    flax nor the JAX package is loaded, and the port is."""
    code = (
        "import json, sys, torch\n"
        "from bench_port import run\n"
        "from bench_port.tests.conftest import make_tiny\n"
        f"root, here = make_tiny(__import__('pathlib').Path({str(tmp_path)!r}),"
        " clients=1)\n"
        "out = run.run_cell('ct-j2k-lossless.series-decode', 5, 0.2, False,"
        " device=torch.device('cpu'), root=root, here=here)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([out['result']['correct'], run.forbidden_modules(),"
        " 'go_dicom_codec_torch' in tops]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=run.spec.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [True, [], True]


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
