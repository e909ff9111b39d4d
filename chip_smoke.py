#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (go_dicom_codec_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

1. prints the card (nvidia-smi name and power limit, torch's device name)
   and fails without a CUDA device;
2. builds every kernel of ``go_dicom_codec_torch/csrc`` with nvcc;
3. holds each kernel against its plain torch version on the card:
   the fused DCT + quant at [32, 512, 512] (|Δ| ≤ 1 on < 0.5 % of the
   coefficients: float summation order differs), the 5/3 lifting passes
   bit-exact at [32, 512, 512] × 5 levels and on small odd cases;
4. drives the main path at full size: 32 gray 512×512 12-bit frames and 8
   RGB 512×512 8-bit frames through encode transform → narrow fetch →
   decode stage, each bit-exact back to its input, then the device bench;
   every kernel must have launched in that run;
5. drives the codec path on the card through ``make_registry(cuda:0)``,
   once the native T1/T2 library (g++, built beside the nvcc build) is
   loaded: 32 gray 512×512 12-bit frames and 8 RGB 512×512 8-bit frames
   through .90, 8 gray 12-bit frames through .91. Lossless codestreams
   must equal the native host lane's byte for byte and decode bit-exact,
   the lossy decode lie within ±1 of the host lane's; both lifting
   kernels must launch inside the registry calls and the pipelines must
   have run on the device engine (their ``pipeline.*`` events; the
   adapters' scalar fallback would hide a failure). Part-2
   matrix streams (.92/.93) take the scalar codec's device branches and
   must equal the same codec on the CPU. It also forces the
   int16-overflow redo once. Encode and decode frames/s of the
   registry path and of the same calls through ``make_registry(cuda:0,
   engine="host")``, the device's share of the encode and the lossy PSNR
   go on lines of their own;
6. prints the device bench rows, one JSON object of kernel results, and as
   its last line ``{"ok": true, "device": {...}}``.

Any failure raises, exits non-zero and prints no ok line. Imports no JAX.
"""

import json
import statistics
import sys
import threading
import time

import numpy as np
import torch

import go_dicom_codec_torch as gdc
from go_dicom_codec_torch import _kernels, native
from go_dicom_codec_torch import pipeline as P
from go_dicom_codec_torch.codecs import j2k_adapters
from go_dicom_codec_torch.ops.dct8x8 import LUMA_QUANT, scale_quant_table
from go_dicom_codec_torch.ops.dwt53 import (fwd53_multilevel_,
                                            fwd53_multilevel_plain_,
                                            inv53_multilevel_,
                                            inv53_multilevel_plain_)
from go_dicom_codec_torch.ops.dwt97 import fwd97_multilevel, inv97_multilevel
from go_dicom_codec_torch.ops.fdct8x8_quant import (encode_plane_blocks,
                                                    fdct8x8_quant,
                                                    fdct8x8_quant_plain)
from go_dicom_codec_torch.ops.mct import dc_level_shift
from go_dicom_codec_torch.tools import device_bench
from go_dicom_codec_torch.utils import profiling

SEED = 0
B, H, W, LEVELS = 32, 512, 512, 5
RGB_FRAMES = 8
ROUNDS = 5
DCT_SHIFT = 2048
SOURCES = {
    "fdct8x8_quant": ("cuda", "go_dicom_codec_torch/csrc/fdct8x8_quant.cu",
                      "go_dicom_codec_tpu/ops/pallas_dct.py:83"),
    "dwt53_fwd_pass": ("cuda", "go_dicom_codec_torch/csrc/dwt53.cu",
                       "go_dicom_codec_tpu/ops/dwt53.py:71"),
    "dwt53_inv_pass": ("cuda", "go_dicom_codec_torch/csrc/dwt53.cu",
                       "go_dicom_codec_tpu/ops/dwt53.py:112"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def compare_dct(x, qt) -> int:
    got = fdct8x8_quant(x, qt, DCT_SHIFT)
    want = fdct8x8_quant_plain(x, qt, DCT_SHIFT)
    d = (got - want).abs()
    err, frac = int(d.max()), float((d != 0).float().mean())
    print(f"fdct8x8_quant vs plain: max |d| {err}, differing {frac:.6f}")
    check(err <= 1 and frac < 0.005, "fdct8x8_quant outside tolerance")
    # a ragged plane goes through the edge-replicating wrapper
    plane = x[0, :61, :37]
    got = encode_plane_blocks(plane, qt, DCT_SHIFT)
    want = encode_plane_blocks(plane.cpu(), qt.cpu(), DCT_SHIFT).to(x.device)
    check(max_abs_diff(got, want) <= 1, "encode_plane_blocks [61, 37]")
    return err


def compare_dwt(x: torch.Tensor, levels: int, x0: int = 0,
                y0: int = 0) -> tuple:
    """Kernel lane against plain lane, forward and inverse; bit-exact.
    Returns (forward max |d|, inverse max |d|)."""
    fwd_k = fwd53_multilevel_(x.clone(), levels, x0, y0)
    fwd_p = fwd53_multilevel_plain_(x.clone(), levels, x0, y0)
    inv_k = inv53_multilevel_(fwd_p.clone(), levels, x0, y0)
    inv_p = inv53_multilevel_plain_(fwd_p.clone(), levels, x0, y0)
    errs = max_abs_diff(fwd_k, fwd_p), max_abs_diff(inv_k, inv_p)
    check(errs == (0, 0) and torch.equal(inv_k, x),
          f"5/3 lanes differ: shape {tuple(x.shape)} levels {levels} "
          f"origin ({x0}, {y0}), max |d| forward {errs[0]}, inverse "
          f"{errs[1]}")
    return errs


def compare_dwt_all(rng, dev) -> dict:
    x = torch.as_tensor(rng.integers(0, 1 << 12, (B, H, W), dtype=np.int32),
                        device=dev)
    cases = [(dc_level_shift(x, 16, False), LEVELS, 0, 0)]
    odd = torch.as_tensor(rng.integers(-4096, 4096, (3, 61, 37),
                                       dtype=np.int32), device=dev)
    for x0, y0 in ((0, 0), (1, 0), (0, 1), (1, 1)):
        for levels in range(1, 7):
            cases.append((odd, levels, x0, y0))
            cases += [(odd[:2, :h, :w].contiguous(), levels, x0, y0)
                      for h in range(1, 9) for w in range(1, 9)]
    errs = [compare_dwt(*case) for case in cases]
    print(f"5/3 kernel lane == plain lane on {len(cases)} cases")
    return {"dwt53_fwd_pass": max(e[0] for e in errs),
            "dwt53_inv_pass": max(e[1] for e in errs)}


def round_trip_gray(rng, dev) -> None:
    frames = rng.integers(0, 1 << 12, (B, H, W), dtype=np.int32)
    x = torch.as_tensor(frames, device=dev)
    coeffs, cb_max, cb_bits = P.j2k_lossless_encode_transform(
        x, LEVELS, bits=16, signed=False, cb=64)
    check(tuple(cb_bits.shape) == (B, H // 64, W // 64), "gray stats shape")
    stage = P._pipeline_device_stage(x, 16, False, LEVELS, narrow=True)
    host = P.fetch_coeffs(stage, x, 16, False, LEVELS)
    check(np.array_equal(host, coeffs.cpu().numpy()), "gray narrow fetch")
    packed = torch.as_tensor(host, device=dev)[:, None]
    px = P._j2k_decode_device_stage(packed, LEVELS, 0, 0, 16, False,
                                    mct=False, narrow=True)
    check(px.dtype == torch.uint16 and tuple(px.shape) == (B, 1, H, W),
          "gray decode shape")
    check(np.array_equal(px.to(torch.int32).cpu().numpy()[:, 0], frames),
          "gray round trip is not bit-exact")
    print(f"gray round trip [{B}, {H}, {W}] bit-exact; max |coeff| "
          f"{int(stage[1])} (int32 redo: {int(stage[1]) > 32767})")


def round_trip_rgb(rng, dev) -> None:
    frames = rng.integers(0, 256, (RGB_FRAMES, 3, H, W), dtype=np.int32)
    x = torch.as_tensor(frames, device=dev)
    coeffs, _, _ = P.j2k_rgb_lossless_encode_transform(x, LEVELS, bits=8)
    stage = P._pipeline_device_stage_rgb(x, 8, LEVELS, narrow=True)
    host = P.fetch_coeffs(stage, x, 8, False, LEVELS, rgb=True)
    check(np.array_equal(host, coeffs.cpu().numpy()), "rgb narrow fetch")
    px = P._j2k_decode_device_stage(torch.as_tensor(host, device=dev),
                                    LEVELS, 0, 0, 8, False, mct=True,
                                    narrow=True)
    check(np.array_equal(px.to(torch.int32).cpu().numpy(), frames),
          "rgb round trip is not bit-exact")
    print(f"rgb round trip [{RGB_FRAMES}, 3, {H}, {W}] bit-exact")


def time_dwt(dev, rng) -> dict:
    """Kernel and plain ms per lifting pass: the time of the 5-level
    forward or inverse transform of [B, H, W], in place on one buffer,
    over the number of passes it launches."""
    buf = torch.as_tensor(rng.integers(-2048, 2048, (B, H, W),
                                       dtype=np.int32), device=dev)
    t = {}
    for name, k, p in (("dwt53_fwd_pass", fwd53_multilevel_,
                        fwd53_multilevel_plain_),
                       ("dwt53_inv_pass", inv53_multilevel_,
                        inv53_multilevel_plain_)):
        before = _kernels.launch_counts[name]
        k(buf, LEVELS)
        n = _kernels.launch_counts[name] - before
        k_ms = device_bench.time_ms(lambda: k(buf, LEVELS))[0]
        p_ms = device_bench.time_ms(lambda: p(buf, LEVELS))[0]
        print(f"{name}: {n} passes per {LEVELS}-level transform, "
              f"{k_ms:.4f} ms kernel, {p_ms:.4f} ms plain")
        t[name] = (k_ms / n, p_ms / n)
    return t


# ---- the codec path -----------------------------------------------------

def phantom(rng, n: int, bits: int, shape=(H, W)) -> np.ndarray:
    """Seeded CT-like frames: a smooth field of a few random waves plus
    noise (σ = 1 % of full scale), clipped to ``bits``."""
    top = (1 << bits) - 1
    yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                         indexing="ij")
    out = np.empty((n,) + shape, np.int64)
    for k in range(n):
        f = np.zeros(shape)
        for _ in range(4):
            fy, fx = rng.uniform(0.002, 0.03, 2)
            f += np.sin(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 7))
        f = top / 2 + top / 9 * f + rng.normal(0, top / 100, shape)
        out[k] = np.clip(np.rint(f), 0, top)
    return out


def pixel_data(frames: np.ndarray, bits: int, rgb: bool):
    info = gdc.FrameInfo(width=frames.shape[2], height=frames.shape[1],
                         bits_allocated=8 if rgb else 16, bits_stored=bits,
                         samples_per_pixel=3 if rgb else 1)
    src = gdc.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype(np.uint8 if rgb else "<u2").tobytes())
    return info, src


def timed(fn):
    """fn's result and its wall seconds, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def rates(calls: dict, n: int) -> dict:
    """Frames/s of each named call of n frames, the calls run in turns
    ``ROUNDS`` times: median, slowest and fastest round."""
    secs = {k: [] for k in calls}
    for _ in range(ROUNDS):
        for k, fn in calls.items():
            secs[k].append(timed(fn)[1])
    return {k: {"median": n / statistics.median(v), "min": n / max(v),
                "max": n / min(v)} for k, v in secs.items()}


def pipeline_runs() -> dict:
    """The pipeline calls that returned since the last call, by engine."""
    timer, runs = profiling.GLOBAL_TIMER, {}
    for name in ("pipeline.encode", "pipeline.decode"):
        if timer.counts.get(name):
            runs[name] = (timer.counts[name],
                          profiling.EVENTS[name]["engine"])
    profiling.enable_global_timer()
    return runs


def registry_round_trip(registry, host_registry, uid, frames, bits, rgb):
    """Encode then decode through the registry, counts reset before each
    call and read after it. Returns (streams, decoded, launches, the
    calls for ``rates`` on both registries, pipeline runs)."""
    info, src = pixel_data(frames, bits, rgb)
    codec = registry.get_codec(uid)
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    pipeline_runs()
    _kernels.reset_launch_counts()
    codec.encode(src, enc)
    launches = {"encode": dict(_kernels.launch_counts)}
    dec = gdc.MemoryPixelData(info=info)
    _kernels.reset_launch_counts()
    codec.decode(enc, dec)
    launches["decode"] = dict(_kernels.launch_counts)
    runs = pipeline_runs()
    n = len(frames)
    streams = [enc.get_frame(i) for i in range(n)]
    dt = np.uint8 if rgb else np.dtype("<u2")
    decoded = np.stack([np.frombuffer(dec.get_frame(i), dt)
                        for i in range(n)]).reshape(frames.shape)
    calls = {}
    for name, reg in (("registry", registry), ("host", host_registry)):
        c = reg.get_codec(uid)
        calls[f"{name}_encode"] = lambda c=c: c.encode(
            src, gdc.MemoryPixelData(info=info, encapsulated=True))
        calls[f"{name}_decode"] = lambda c=c: c.decode(
            enc, gdc.MemoryPixelData(info=info))
    return streams, decoded, launches, calls, runs


def host_lane(frames, bits, dev, streams):
    """The native host lane on the same frames: the pipelines with
    engine="host" and the adapter's parameters. Returns (streams,
    decoded)."""
    params = j2k_adapters._params_from(None, lossless=True)
    return (P.encode_frames_pipelined(frames, bit_depth=bits, params=params,
                                      engine="host", device=dev),
            np.stack(P.decode_frames_pipelined(streams, engine="host",
                                               device=dev)))


def host_checked(calls: dict) -> dict:
    """``calls`` with each host-engine call failing if it launched a
    kernel."""
    def checked(fn):
        def run():
            before = dict(_kernels.launch_counts)
            fn()
            check(_kernels.launch_counts == before,
                  "the host engine launched a kernel")
        return run
    return {k: checked(fn) if k.startswith("host") else fn
            for k, fn in calls.items()}


def codec_phase(rng, dev, card: str) -> dict:
    check(native.get_lib() is not None,
          "the native T1/T2 library did not build or load")
    wide = torch.tensor([0, 1, 65535], dtype=torch.uint16, device=dev)
    check(wide.to(torch.int32).tolist() == [0, 1, 65535],
          "uint16 → int32 on the card is not exact")
    registry = gdc.make_registry(dev)
    host_registry = gdc.make_registry(dev, engine="host")
    profiling.enable_global_timer()
    policy = P.transfer_policy(dev)
    print(f"transfer policy: {json.dumps(policy)}")
    measured, launches = {}, {}
    for name, uid, n, bits, rgb in (
            ("gray", gdc.uids.JPEG_2000_LOSSLESS, B, 12, False),
            ("rgb", gdc.uids.JPEG_2000_LOSSLESS, RGB_FRAMES, 8, True)):
        frames = (np.stack([phantom(rng, n, bits) for _ in range(3)],
                           axis=-1) if rgb else phantom(rng, n, bits))
        streams, decoded, lc, calls, runs = registry_round_trip(
            registry, host_registry, uid, frames, bits, rgb)
        check(runs == {"pipeline.encode": (1, "device"),
                       "pipeline.decode": (1, "device")},
              f"{name}: the pipelines did not run on the device {runs}")
        host_streams, host_dec = host_lane(frames, bits, dev, streams)
        check(streams == host_streams,
              f"{name}: registry codestreams differ from the host lane's")
        check(np.array_equal(decoded, frames),
              f"{name}: registry decode is not bit-exact")
        check(np.array_equal(host_dec.reshape(frames.shape), frames),
              f"{name}: host lane decode is not bit-exact")
        check(lc["encode"]["dwt53_fwd_pass"] > 0,
              f"{name}: dwt53_fwd_pass never launched inside the encode")
        check(lc["decode"]["dwt53_inv_pass"] > 0,
              f"{name}: dwt53_inv_pass never launched inside the decode")
        launches[name] = lc
        print(f"{name} .90 [{n}, {H}, {W}]: codestreams == host lane, "
              f"decode bit-exact; launches {json.dumps(lc)}")
        measured[name] = rates(host_checked(calls), n)

    # lossy .91: encode runs the native host 9/7 per frame; the decode
    # pipeline runs dequant on the host and the 9/7 inverse on the card
    frames = phantom(rng, RGB_FRAMES, 12)
    streams, decoded, _, calls, runs = registry_round_trip(
        registry, host_registry, gdc.uids.JPEG_2000_LOSSY, frames, 12, False)
    check(runs == {"pipeline.decode": (1, "device")},
          f"lossy: the decode pipeline did not run on the device {runs}")
    host_dec = np.stack(P.decode_frames_pipelined(
        streams, engine="host", device=dev))[..., 0]
    err = int(np.abs(decoded.astype(np.int64) - host_dec).max())
    check(err <= 1, f"lossy decode differs from the host lane by {err}")
    mse = float(np.mean((decoded.astype(np.float64) - frames) ** 2))
    psnr = 10 * np.log10(4095.0 ** 2 / mse)
    measured["lossy"] = rates(host_checked(calls), RGB_FRAMES)
    print(f"lossy .91 [{RGB_FRAMES}, {H}, {W}]: max |registry - host "
          f"lane| {err}, PSNR {psnr:.2f} dB, "
          f"{sum(len(s) for s in streams) / RGB_FRAMES:.0f} bytes/frame")
    # the float stages themselves: the card's 9/7 against the native one
    shifted = frames[0].astype(np.float32) - 2048
    fwd = fwd97_multilevel(torch.as_tensor(shifted, device=dev), LEVELS)
    fwd_host = native.dwt97_fwd_native(shifted, LEVELS, 0, 0)
    inv = inv97_multilevel(torch.as_tensor(fwd_host, device=dev), LEVELS)
    inv_host = native.dwt97_inv_native(fwd_host, LEVELS, 0, 0)
    print(f"9/7 on the card vs the native host lane, [{H}, {W}] "
          f"{LEVELS} levels: forward max |d| "
          f"{float(np.abs(fwd.cpu().numpy() - fwd_host).max()):.6g}, "
          f"inverse max |d| "
          f"{float(np.abs(inv.cpu().numpy() - inv_host).max()):.6g}")

    # Part 2 custom matrices (.92/.93): the scalar codec's device branches
    # (matrix, 5/3 or 9/7 on the card, and their inverses) against the
    # same registry on the CPU; float32 elementwise ops round alike there
    rgb = np.stack([phantom(rng, 2, 8) for _ in range(3)], axis=-1)
    m = [[0.6, 0.5, 0.5], [0.5, 0.6, -0.5], [0.5, -0.5, 0.6]]
    params = gdc.Parameters(mct_matrix=m,
                            mct_inverse=np.linalg.inv(m).tolist())
    cpu_registry = gdc.make_registry(torch.device("cpu"))
    for uid in (gdc.uids.JPEG_2000_MC_LOSSLESS, gdc.uids.JPEG_2000_MC_LOSSY):
        got = []
        for reg in (registry, cpu_registry):
            info, src = pixel_data(rgb, 8, True)
            enc = gdc.MemoryPixelData(info=info, encapsulated=True)
            dec = gdc.MemoryPixelData(info=info)
            _kernels.reset_launch_counts()
            reg.get_codec(uid).encode(src, enc, params)
            fwd = _kernels.launch_counts["dwt53_fwd_pass"]
            _kernels.reset_launch_counts()
            reg.get_codec(uid).decode(enc, dec)
            inv = _kernels.launch_counts["dwt53_inv_pass"]
            got.append(([enc.get_frame(i) for i in range(2)],
                        [dec.get_frame(i) for i in range(2)], fwd, inv))
        (card_enc, card_dec, fwd, inv), (cpu_enc, cpu_dec, _, _) = got
        check(card_enc == cpu_enc, f"{uid}: card codestreams differ from "
              "the CPU's")
        check(card_dec == cpu_dec, f"{uid}: card decode differs from the "
              "CPU's")
        err = max(int(np.abs(np.frombuffer(d, np.uint8).astype(np.int64)
                             - f.reshape(-1)).max())
                  for d, f in zip(card_dec, rgb))
        if uid == gdc.uids.JPEG_2000_MC_LOSSLESS:
            check(fwd > 0 and inv > 0, f"{uid}: the lifting kernels did "
                  f"not launch ({fwd}, {inv})")
            check(err <= 1, f"{uid}: round trip off by {err}")
        print(f"{uid} Part-2 matrix, 2 × [{H}, {W}, 3]: card == CPU, "
              f"codestreams and decode; max |decode - source| {err}; "
              f"lifting launches {fwd} forward, {inv} inverse")

    # the int16-overflow redo: no 12-bit frame overflows, so lower the
    # bound; the redo runs on the pipeline's side stream
    frames = phantom(rng, 6, 12)
    host_streams = P.encode_frames_pipelined(frames, bit_depth=12,
                                             engine="host", device=dev)
    bound, P.INT16_MAX = P.INT16_MAX, 100
    try:
        redo = P.encode_frames_pipelined(frames, bit_depth=12,
                                         engine="device", device=dev)
    finally:
        P.INT16_MAX = bound
    check(redo == host_streams, "the int32 redo changed the codestreams")
    print("int16-overflow redo on the side stream: codestreams == host lane")

    # the device's share of one registry encode of the gray frames
    frames = phantom(rng, B, 12)
    info, src = pixel_data(frames, 12, False)
    codec = registry.get_codec(gdc.uids.JPEG_2000_LOSSLESS)
    encode = (lambda: codec.encode(
        src, gdc.MemoryPixelData(info=info, encapsulated=True)))
    encode()
    wall = timed(encode)[1]
    dev_ms, top = device_bench.device_ms(encode, iters=1)
    share = dev_ms / (wall * 1e3)
    print(f"registry encode of [{B}, {H}, {W}]: wall {wall * 1e3:.1f} ms, "
          f"device {dev_ms:.3f} ms, device share {share:.4f}; top "
          f"kernels {json.dumps(top)}")
    for name, r in measured.items():
        print("RATE " + json.dumps({"path": name, "card": card, **r}))
    return launches


def main() -> int:
    card = device_bench.card_info()
    print(card)
    check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # g++ builds the native host library while nvcc builds the kernels
    t_native = time.perf_counter()
    host_build = threading.Thread(target=native.get_lib)
    host_build.start()
    info = _kernels.build(force=True)
    print(f"built {info['path']} in {info['seconds']:.2f} s")
    print(info["log"], file=sys.stderr)

    rng = np.random.default_rng(SEED)
    qt = torch.as_tensor(scale_quant_table(LUMA_QUANT, 90, 255),
                         dtype=torch.float32, device=dev)
    x = torch.as_tensor(rng.integers(0, 1 << 12, (B, H, W), dtype=np.int32),
                        device=dev)
    errs = {"fdct8x8_quant": compare_dct(x, qt), **compare_dwt_all(rng, dev)}
    torch.cuda.synchronize()

    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    round_trip_gray(rng, dev)
    round_trip_rgb(rng, dev)
    rows = device_bench.run_bench(B, H, W, seed=SEED, card=card)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    print(f"main path {time.perf_counter() - t0:.2f} s, launches {launches}")
    check(all(n > 0 for n in launches.values()), "a kernel never launched")
    for r in rows:
        print(json.dumps(r))

    host_build.join()
    print(f"native host library ready after "
          f"{time.perf_counter() - t_native:.2f} s")
    codec_phase(rng, dev, card)

    times = time_dwt(dev, rng)
    ms = {r["row"] + "/" + r["lane"]: r["ms"] for r in rows}
    times["fdct8x8_quant"] = (ms["dct8x8_quant_pallas/kernel"],
                              ms["dct8x8_quant_pallas/plain"])
    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": times[name][0],
                        "plain_ms": times[name][1]})
    print(json.dumps({"kernels": kernels, "gpu": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
