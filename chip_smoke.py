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
5. prints the device bench rows, one JSON object of kernel results, and as
   its last line ``{"ok": true, "device": {...}}``.

Any failure raises, exits non-zero and prints no ok line. Imports no JAX.
"""

import json
import sys
import time

import numpy as np
import torch

from go_dicom_codec_torch import _kernels
from go_dicom_codec_torch import pipeline as P
from go_dicom_codec_torch.ops.dct8x8 import LUMA_QUANT, scale_quant_table
from go_dicom_codec_torch.ops.dwt53 import (fwd53_multilevel_,
                                            fwd53_multilevel_plain_,
                                            inv53_multilevel_,
                                            inv53_multilevel_plain_)
from go_dicom_codec_torch.ops.fdct8x8_quant import (encode_plane_blocks,
                                                    fdct8x8_quant,
                                                    fdct8x8_quant_plain)
from go_dicom_codec_torch.ops.mct import dc_level_shift
from go_dicom_codec_torch.tools import device_bench

SEED = 0
B, H, W, LEVELS = 32, 512, 512, 5
RGB_FRAMES = 8
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


def main() -> int:
    card = device_bench.card_info()
    print(card)
    check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
