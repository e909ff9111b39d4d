"""The HTJ2K lossless cell, ``ct-htj2k-lossless.series-decode``, driven end
to end on the CPU at the tiny size of ``test_run_cpu.py``; its two kernel
metrics read from that run's own record; its configuration's header
check held against a real .201 codestream of the program's encoder; and
the plain T.814 decoder against the program's frames."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench_port import arith, ht_arith, reference, run, spec

CPU = torch.device("cpu")
CELL = "ct-htj2k-lossless.series-decode"
HT = "void (anonymous namespace)::ht_cleanup_kernel<short>(unsigned char c"


def _cfg():
    return json.loads((spec.HERE / "configs" / "ct-htj2k-lossless.json")
                      .read_text())


def test_the_cell_runs_correct_and_reads_its_kernel_metrics(tiny):
    """The cell at the tiny size is correct. No trace on the CPU: its
    kernel metrics find nothing to read; the same run's calls with an HT
    kernel's events over their stretch: both read."""
    root, here = tiny
    out = run.run_cell(CELL, 2**31 + 4321, 0.3, True, device=CPU,
                       root=root, here=here)
    res = out["result"]
    assert res["correct"] is True and res["failed"] == 0
    rec = out["run"]
    assert rec["config"]["transfer_syntax"] == "1.2.840.10008.1.2.4.201"
    assert spec.load_reader("j2k_ht_decode_us_per_frame").read(rec) is None
    assert spec.load_reader("j2k_ht_decode_roofline").read(rec) is None
    calls = rec["calls"]
    lo, hi = calls[0]["t0"], calls[-1]["t1"]
    events = [(HT, lo, lo + (hi - lo) / 10)]
    rec = dict(rec, trace={"t0": lo, "t1": hi, "cpu": (0.0, 0.0),
                           "events": events,
                           "device_s": arith.split_seconds([events])})
    frames = arith.frames_within(calls, lo, hi, "decode")
    assert spec.load_reader("j2k_ht_decode_us_per_frame").read(rec) == \
        pytest.approx((hi - lo) / 10 * 1e6 / frames)
    rows, cols = rec["config"]["frame"]["rows"], \
        rec["config"]["frame"]["columns"]
    assert spec.load_reader("j2k_ht_decode_roofline").read(rec) == \
        pytest.approx(100 * frames * rows * cols * 2
                      / arith.HBM_BYTES_PER_S / ((hi - lo) / 10))


def test_the_cell_reports_its_metrics(bench):
    names = {m["name"] for m in spec.cell_metrics(bench, CELL, False)}
    assert names == {"decode_frames_per_s", "setup_s"}
    traced = {m["name"] for m in spec.cell_metrics(bench, CELL, True)}
    assert {"j2k_ht_decode_us_per_frame", "j2k_ht_decode_roofline",
            "j2k_inv_stage_roofline", "device_idle_share.decode",
            "copy_us_per_frame.decode", "host_cpu_ms_per_frame.decode",
            "call_p90_ms.decode"} == traced


def _series(n=3, rows=64, cols=64):
    import go_dicom_codec_torch as gdc
    cfg = _cfg()
    info = gdc.FrameInfo(width=cols, height=rows, bits_allocated=16,
                         bits_stored=12)
    src = gdc.MemoryPixelData(info=info)
    frames = np.random.default_rng(5).integers(0, 4096, (n, rows, cols))
    for f in frames:
        src.add_frame(f.astype("<u2").tobytes())
    codec = gdc.make_registry(CPU, engine="device").get_codec(
        cfg["transfer_syntax"])
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, gdc.Parameters(**cfg["parameters"]))
    return [enc.get_frame(k) for k in range(n)], frames


def test_the_header_check_holds_for_a_real_201_codestream():
    """The codestream the program's .201 encoder writes with the
    configuration's parameters passes the set-up's header check, HT style
    and guard bits from ``codestream``; every band's Mb is at most the
    one ``ht_arith`` counts the kernel's int16 output by."""
    from go_dicom_codec_torch.codecs.jpeg2000 import ht_blocks
    cfg = _cfg()
    cfg["frame"].update(rows=64, columns=64)
    streams, _ = _series()
    assert reference.header_mismatches(streams[0], cfg) == []
    blocks = ht_blocks(streams[0])[4]
    assert max(b[3] for b in blocks) <= ht_arith.largest_mb(
        12, ht_arith.guard_bits(cfg)) <= ht_arith.NARROW_MB
    del cfg["codestream"]
    cfg["parameters"].update(cb_style=1, guard_bits=2)
    assert sorted(reference.header_mismatches(streams[0], cfg)) == [
        "code-block style: 64, expected 1", "guard bits: 1, expected 2"]


def test_the_corpus_check_compares_every_block(tiny):
    """``ht_corpus_check`` over the tiny cell's corpus on the CPU (the
    kernel's plain version in its place): every block read, none
    differing."""
    from bench_port import ht_corpus_check
    _, here = tiny
    cfg = spec.load_config("ct-htj2k-lossless", here)
    mix = spec.load_traffic("series-decode", here)
    out = ht_corpus_check.check(CELL, 2**31 + 77, CPU, 2, cfg=cfg, mix=mix)
    assert out["frames"] == mix["clients"] * mix["objects_per_client"] * \
        mix["frames_per_call"]
    assert out["blocks"] > out["frames"]
    assert out["kernel_vs_native"] == out["kernel_vs_reference"] == \
        out["reference_refused"] == out["status_nonzero"] == 0
    assert out["forbidden"] == []
