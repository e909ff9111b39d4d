"""The readers of the decode kernels' own metrics: the 5/3 inverse stage's
roofline over its kernel's time alone, and the T1 decode kernel's device
time a frame, on a synthetic trace; nothing to read without a trace, or
without such a kernel (a program that has no T1 decode kernel)."""

from __future__ import annotations

import pytest

from bench_port import arith, spec

STAGE = "void (anonymous namespace)::inv_stage_kernel<short, false>(short"
T1 = "void (anonymous namespace)::t1_warp_kernel<short>(unsigned char cons"


def run_with(events, trace=True):
    calls = [{"client": i % 4, "op": "decode", "t0": a, "t1": b,
              "frames": 8, "ok": True}
             for i, (a, b) in enumerate([(0.0, 1.0), (1.0, 2.0), (2.0, 3.0),
                                         (3.0, 4.0)])]
    return {"calls": calls, "start": 0.0, "setup_s": 12.5, "cpu": (0.0, 4.0),
            "config": {"frame": {"rows": 512, "columns": 512,
                                 "samples_per_pixel": 1,
                                 "bits_allocated": 16, "bits_stored": 12}},
            "trace": {"t0": 1.0, "t1": 3.0, "cpu": (1.0, 3.0),
                      "events": list(events),
                      "device_s": arith.split_seconds([events])}
            if trace else None}


EVENTS = [("Memcpy HtoD (Pinned -> Device)", 1.0, 1.001),
          ("Memset (Device)", 1.001, 1.0011),
          (T1, 1.0011, 1.0061),
          (STAGE, 1.0061, 1.0071),
          ("void (anonymous namespace)::inv97_stage_kernel<float>", 2.0, 2.5),
          ("Memcpy DtoH (Device -> Pinned)", 2.5, 2.501)]


STAGE_EVENT = EVENTS[3]
FWD = "void (anonymous namespace)::fwd_stage_kernel<unsigned short, fal"


def read(metric, run):
    return spec.load_reader(metric).read(run)


def test_stage_roofline_reads_the_stage_kernel_alone():
    run = run_with(EVENTS)
    per = arith.stage_bytes_per_frame(512, 512, 1, 16, 12)
    assert read("j2k_inv_stage_roofline", run) == pytest.approx(
        100 * 16 * per / arith.HBM_BYTES_PER_S / 1e-3)
    # the T1 kernel, the 9/7 stage and the copies leave it unmoved
    assert read("j2k_inv_stage_roofline", run_with([STAGE_EVENT])) == \
        read("j2k_inv_stage_roofline", run)


def test_t1_kernel_time_a_frame():
    assert read("j2k_t1_decode_us_per_frame", run_with(EVENTS)) == \
        pytest.approx(5000 / 16)


@pytest.mark.parametrize("metric", ["j2k_inv_stage_roofline",
                                    "j2k_t1_decode_us_per_frame"])
def test_kernel_readers_find_nothing_to_read(metric):
    assert read(metric, run_with(EVENTS, trace=False)) is None
    assert read(metric, run_with([e for e in EVENTS
                                  if "warp" not in e[0]
                                  and "inv_stage" not in e[0]])) is None


def test_stage_roofline_reads_a_program_without_the_t1_kernel():
    """The parent's program: the stage kernel and no T1 kernel."""
    run = run_with([e for e in EVENTS if "warp" not in e[0]])
    assert read("j2k_inv_stage_roofline", run) > 0
    assert read("j2k_t1_decode_us_per_frame", run) is None


def test_encode_stage_roofline_reads_the_forward_stage_kernel_alone():
    """A T1-like kernel among the encode's events (T1 encode on the card)
    and the copies leave the forward stage's share unmoved."""
    stage = [(FWD, 1.5, 1.501)]
    alone = run_with(stage)
    for c in alone["calls"]:
        c["op"] = "encode"
    beside = run_with(stage + [(T1.replace("t1_warp", "t1_encode_warp"),
                                1.6, 1.9)] + EVENTS[:2])
    beside["calls"] = alone["calls"]
    per = arith.stage_bytes_per_frame(512, 512, 1, 16, 12)
    want = 100 * 16 * per / arith.HBM_BYTES_PER_S / 1e-3
    assert read("encode_stage_roofline", alone) == pytest.approx(want)
    assert read("encode_stage_roofline", beside) == pytest.approx(want)
    assert read("encode_stage_roofline", run_with(EVENTS)) is None
