"""The yardstick's arithmetic on synthetic records."""

from __future__ import annotations

import statistics

import pytest

from bench_port import arith, readers


def calls(spans, frames=32, op="decode"):
    return [{"client": i % 4, "op": op, "t0": a, "t1": b, "frames": frames,
             "ok": True} for i, (a, b) in enumerate(spans)]


def test_window_rate_counts_every_frame_over_all_the_time():
    recs = calls([(0.0, 1.0), (1.0, 2.5), (0.2, 3.0)])
    assert arith.window_rate(recs, 0.0, "decode") == pytest.approx(96 / 3.0)
    assert arith.window_rate(recs, 0.0, "encode") is None


def test_p90_from_ten_values_up():
    assert arith.p90(list(range(9))) is None
    assert arith.p90(list(range(10))) is not None
    vals = list(range(1, 101))
    assert arith.p90(vals) == pytest.approx(
        statistics.quantiles(vals, n=10, method="inclusive")[-1])
    assert 90 <= arith.p90(vals) <= 91


def test_frames_within_shares_straddling_calls():
    recs = calls([(0.0, 2.0), (2.0, 4.0)], frames=10)
    assert arith.frames_within(recs, 1.0, 3.0, "decode") == pytest.approx(10)
    assert arith.frames_within(recs, 0.0, 4.0, "decode") == pytest.approx(20)


def test_intervals_union_busy_and_gaps():
    ev = [("k", 0.0, 1.0), ("c", 0.5, 1.5), ("k", 3.0, 4.0)]
    assert arith.union([(s, e) for _, s, e in ev]) == [(0.0, 1.5), (3.0, 4.0)]
    assert arith.busy_seconds(ev) == pytest.approx(2.5)
    assert arith.gaps(ev, -1.0, 5.0) == [(-1.0, 0.0), (1.5, 3.0), (4.0, 5.0)]
    assert arith.seconds_by_name(ev) == {"k": 2.0, "c": 1.0}


def test_roofline_bytes_from_shapes():
    assert arith.coeff_bytes(5) == 1
    assert arith.coeff_bytes(12) == 2
    assert arith.coeff_bytes(13) == 2
    assert arith.coeff_bytes(14) == 4
    per = arith.stage_bytes_per_frame(512, 512, 1, 16, 12)
    assert per == 512 * 512 * 4
    # 8 frames in 1 ms of kernels: 8 MiB over 3.35 TB/s is 2.504 us
    share = arith.roofline_share(8, per, 1e-3)
    assert share == pytest.approx(100 * 8 * per / 3.35e12 / 1e-3)
    assert arith.roofline_share(8, per, 0.0) is None


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [90.0, 95.0, 100.0, 105.0, 110.0, 100.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert arith.spread(vals) == pytest.approx((q3 - q1) / med)


def synthetic_run(trace=True):
    recs = calls([(0.0, 1.0), (1.0, 2.0), (2.0, 3.0), (3.0, 4.0)], frames=8)
    run = {"calls": recs, "start": 0.0, "setup_s": 12.5, "cpu": (0.0, 4.0),
           "config": {"frame": {"rows": 512, "columns": 512,
                                "samples_per_pixel": 1,
                                "bits_allocated": 16, "bits_stored": 12}},
           "trace": None}
    if trace:
        run["trace"] = {"t0": 1.0, "t1": 3.0, "cpu": (1.0, 3.0),
                        "events": [("Memcpy HtoD", 1.0, 1.001),
                                   ("inv_stage_kernel", 1.001, 1.002),
                                   ("Memcpy DtoH", 2.0, 2.001)]}
    return run


def test_readers_on_a_synthetic_trace():
    run = synthetic_run()
    assert readers.frames_per_s(run, "decode") == pytest.approx(8.0)
    # 32 frames, 2 s of CPU outside the profile, 16 frames outside
    assert readers.host_cpu_ms_per_frame(run, "decode") == pytest.approx(125)
    assert readers.copy_us_per_frame(run, "decode") == pytest.approx(
        2000 / 16)
    assert readers.stage_roofline(run, "decode") == pytest.approx(
        100 * 16 * 512 * 512 * 4 / 3.35e12 / 1e-3)
    assert readers.device_idle_share(run, "decode") == pytest.approx(
        100 * (1 - 0.003 / 2.0))
    assert readers.call_p90_ms(run, "decode") is None   # 4 calls


def test_readers_find_nothing_without_a_trace():
    run = synthetic_run(trace=False)
    for fn in (readers.host_cpu_ms_per_frame, readers.copy_us_per_frame,
               readers.stage_roofline, readers.device_idle_share):
        assert fn(run, "decode") is None
    assert readers.stage_roofline(synthetic_run(), "encode") is None


def test_trimmed_spread_leaves_out_the_farthest_value():
    vals = [10.0, 10.2, 9.9, 10.1, 10.0, 14.0]
    assert arith.spread_trimmed(vals) == pytest.approx(
        arith.spread([10.0, 10.2, 9.9, 10.1, 10.0]))
    assert arith.spread_trimmed(vals) < arith.spread(vals)
