"""The HT cleanup kernel's byte count and its two readers, on synthetic
traces: the count follows the configuration's frame and guard bits alone;
nothing to read without a trace or without the kernel (a program that
decodes HT code-blocks on the host)."""

from __future__ import annotations

import json

import pytest

from bench_port import arith, ht_arith, spec

HT = "void (anonymous namespace)::ht_cleanup_kernel<short>(unsigned char c"
STAGE = "void (anonymous namespace)::inv_stage_kernel<short, false>(short"
EVENTS = [("Memcpy HtoD (Pinned -> Device)", 1.0, 1.001),
          ("Memset (Device)", 1.001, 1.0011),
          (STAGE, 1.0061, 1.0071),
          ("Memcpy DtoH (Device -> Pinned)", 2.5, 2.501)]
HT_EVENTS = EVENTS + [(HT, 1.0011, 1.0013)]


def run_with(events, trace=True):
    """Four decode calls of 8 frames over [0, 4] s, the middle 2 s traced
    with ``events``."""
    calls = [{"client": i, "op": "decode", "t0": float(i),
              "t1": float(i + 1), "frames": 8, "ok": True}
             for i in range(4)]
    return {"calls": calls, "start": 0.0, "setup_s": 12.5, "cpu": (0.0, 4.0),
            "config": _cfg(),
            "trace": {"t0": 1.0, "t1": 3.0, "cpu": (1.0, 3.0),
                      "events": list(events),
                      "device_s": arith.split_seconds([events])}
            if trace else None}


def read(metric, run):
    return spec.load_reader(metric).read(run)


def _cfg():
    return json.loads((spec.HERE / "configs" / "ct-htj2k-lossless.json")
                      .read_text())


def test_the_configurations_coefficients_are_int16():
    cfg = _cfg()
    assert ht_arith.guard_bits(cfg) == 1
    assert ht_arith.largest_mb(12, 1) == 14
    assert ht_arith.bytes_per_frame(cfg) == 512 * 512 * 2


@pytest.mark.parametrize("bits,guard,want", [(12, 1, 2), (12, 2, 2),
                                             (13, 1, 2), (13, 2, 4), (14, 1, 4),
                                             (13, 3, 4), (16, 1, 4),
                                             (8, 1, 2)])
def test_the_width_is_the_kernels(bits, guard, want):
    """int16 where the HH band's Mb, guard + bits + 1, is 15 or less."""
    assert ht_arith.coeff_bytes(bits, guard) == want


def test_the_guard_bits_come_from_the_codestream_then_the_parameters():
    cfg = _cfg()
    cfg["codestream"]["guard bits"] = 3
    assert ht_arith.guard_bits(cfg) == 3
    del cfg["codestream"]
    cfg["parameters"]["guard_bits"] = 2
    assert ht_arith.guard_bits(cfg) == 2
    cfg["frame"]["bits_stored"] = 16
    assert ht_arith.bytes_per_frame(cfg) == 512 * 512 * 4


def test_the_readers_read_the_ht_kernel_alone():
    run = run_with(HT_EVENTS)
    assert read("j2k_ht_decode_us_per_frame", run) == pytest.approx(200 / 16)
    assert read("j2k_ht_decode_roofline", run) == pytest.approx(
        100 * 16 * 512 * 512 * 2 / arith.HBM_BYTES_PER_S / 0.2e-3)
    # the 5/3 stage's share reads its own kernel, as before
    assert read("j2k_inv_stage_roofline", run) == \
        read("j2k_inv_stage_roofline", run_with(EVENTS))


@pytest.mark.parametrize("metric", ["j2k_ht_decode_us_per_frame",
                                    "j2k_ht_decode_roofline"])
def test_nothing_to_read_without_the_kernel_or_a_trace(metric):
    for run in (run_with(HT_EVENTS, trace=False), run_with(EVENTS)):
        assert read(metric, run) is None
