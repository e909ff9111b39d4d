"""Discovery by name: every configuration, mix and metric that
BENCHMARK.json names has its file, and a new one is found as new files
and entries alone."""

from __future__ import annotations

import json
import re

import pytest
import torch

from bench_port import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_has_its_files(bench):
    for cfg in bench["configs"]:
        assert (spec.ROOT / cfg["file"]).is_file()
        loaded = spec.load_config(cfg["name"])
        assert loaded["engine"] == "device"
        assert set(loaded["host_threads"]) >= {"native_per_client", "torch"}
        assert len(loaded["source"]) <= 200
    for cell in bench["workloads"]:
        assert cell["chips"] == 1
        mix = spec.load_traffic(cell["traffic"])
        assert mix["loop"] == "closed" and mix["clients"] >= 1
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(metric["name"]).read)


def test_names_and_keys_keep_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for group in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in bench[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        cells = {c["name"] for c in bench["workloads"]}
        assert set(m.get("workloads", cells)) <= cells
    for cell in bench["workloads"]:
        w = cell["name"]
        assert any(m["name"] != "setup_s" for m in
                   spec.cell_metrics(bench, w, trace=False))
        assert spec.cell_metrics(bench, w, trace=True)


def test_applies_reads_the_workloads_key():
    assert spec.applies({"name": "a"}, "x.y")
    assert spec.applies({"name": "a", "workloads": ["x.y"]}, "x.y")
    assert not spec.applies({"name": "a", "workloads": ["x.z"]}, "x.y")


def test_a_new_cell_config_mix_and_metric_are_files_alone(tiny):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and BENCHMARK.json entries run without an edit to any file the
    harness has."""
    root, here = tiny
    cfg = json.loads((here / "configs" / "ct-j2k-lossless.json").read_text())
    cfg["name"] = "ct-j2k-lossless-10bit"
    cfg["frame"]["bits_stored"] = cfg["phantom"]["bits_stored"] = 10
    (here / "configs" / "ct-j2k-lossless-10bit.json").write_text(
        json.dumps(cfg))
    mix = json.loads((here / "traffic" / "series-decode.json").read_text())
    mix.update(name="pair-decode", frames_per_call=2, clients=1)
    (here / "traffic" / "pair-decode.json").write_text(json.dumps(mix))
    (here / "metrics" / "calls_a_client.py").write_text(
        "def read(run):\n"
        "    return len(run['calls']) / run['traffic']['clients']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = "ct-j2k-lossless-10bit.pair-decode"
    bench["configs"].append({"name": cfg["name"], "source": "test",
                             "file": "x", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": "pair-decode", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append(name)
    bench["end_to_end"].append({"name": "calls_a_client", "unit": "calls",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run.run_cell(name, 7, 0.3, False, device=torch.device("cpu"),
                       root=root, here=here)
    res = out["result"]
    assert res["correct"], res
    assert set(res["metrics"]) == {"decode_frames_per_s", "setup_s",
                                   "calls_a_client"}
    assert res["metrics"]["calls_a_client"]["value"] >= 1
    assert all(c["frames"] == 2 for c in out["run"]["calls"])


def test_a_missing_reader_is_an_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no_such_metric", here=tmp_path)


def test_a_mix_may_bring_its_own_client_loop(tiny):
    """A mix of a new kind names its loop module; the harness runs it."""
    root, here = tiny
    (here / "traffic" / "two_calls.py").write_text(
        "def loop(client, start, deadline):\n"
        "    for k in range(2):\n"
        "        t0 = start + k\n"
        "        out = client.call(k)\n"
        "        client.calls.append({'client': client.index, 'op': 'decode',"
        " 't0': t0, 't1': t0 + 0.5, 'frames': len(out.frames),"
        " 'ok': True})\n"
        "        client._keep(k, out)\n")
    mix = json.loads((here / "traffic" / "series-decode.json").read_text())
    mix["loop_module"] = "two_calls"
    (here / "traffic" / "series-decode.json").write_text(json.dumps(mix))
    out = run.run_cell("ct-j2k-lossless.series-decode", 3, 0.1, False,
                       device=torch.device("cpu"), root=root, here=here)
    assert out["result"]["correct"]
    assert out["result"]["attempted"] == 2 * mix["clients"]
