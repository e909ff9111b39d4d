#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (go_dicom_codec_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

1. prints the card (nvidia-smi name and power limit, torch's device name)
   and fails without a CUDA device;
2. builds every kernel of ``go_dicom_codec_torch/csrc`` with nvcc;
3. holds each kernel against its plain torch version on the card:
   the fused DCT + quant at [32, 512, 512] and at ragged shapes (W of
   five blocks, H = 8, B = 1, odd B × H/8) with |Δ| ≤ 1 on < 0.5 % of the
   coefficients (float summation order differs), both against a float64
   result (a difference only within the float32 error of a rounding
   tie), a misaligned view refused by the wrapper and copied by the ops
   layer; saturating float → int32 casts (the DCT on INT32_MAX and
   INT32_MIN planes, ``quantize``, the rounding helper, the 9/7 decode
   stage on NaN, ±inf and ±3e9) equal to the CPU's; the fused forward
   stage bit-exact at [32, 512, 512] uint16 and [8, 3, 512, 512] uint8
   with the RCT fused, in all three epilogues; the fused inverse stage
   bit-exact at [32, 1, 512, 512] int16 → uint16 and [8, 3, 512, 512] with
   the RCT, on int16 and int32 input, in all three epilogues; the fused
   forward and inverse 5/3 bit-exact at [32, 512, 512] × 5 levels and on
   the stages' launch-model matrix (odd shapes and every shape up to 8×8
   at every origin and levels 0-6 at the card's tile side of 64; odd shapes, rows of whole
   16-byte vectors and one-sample windows at tiles of 8, with head budgets
   of none, 64 and 4096 samples), both stages' epilogues (the forward's
   also with the RCT fused) on those too; the islow
   forward and inverse kernels bit-exact (``compare_islow``) at
   [32, 512, 512] and ragged shapes, 8-bit and 12-bit profiles, qualities
   1, 50, 90 and 100, int16 and int32 coefficients in, a stack of three
   tables in one inverse launch, 65537 planes (past a grid dimension's
   65535: folded into grid x), 16-bit
   samples under the 12-bit profile (the int32 wraparound) and ±32768
   coefficients with a table of 65535s; the 9/7
   stages bit-exact (``compare_97``: the forward from uint16, uint8 and
   float32 samples, the decode in all three epilogues) at [32, 1, 512,
   512], [8, 3, 512, 512] with the ICT, [2, 1, 16, 65535], [2, 1, 65535,
   16], one- and two-sample frames, an odd origin and frames that cross
   the strip pass's strip and segment seams at odd origins ([3, 1, 523,
   517], [2, 3, 97, 1031]), then over the launch models' covering at the
   card's strip geometry and at strips of 4 lanes and segments of 4 rows;
4. drives the main path at full size: 32 gray 512×512 12-bit frames and 8
   RGB 512×512 8-bit frames through encode transform → narrow fetch →
   decode stage, each bit-exact back to its input; frames with a side of
   58111, 60001 and 65535 samples along rows and along columns, thin ones
   of one and two samples across, an odd origin (``LONG_SHAPES``) forward
   and back, one stage launch each way bit-exact against the plain lane;
   the narrow stages of 16- and 8-bit samples 58111, 60000 and 60001 wide
   and of an RGB frame 60001 wide with the RCT fused; then the device
   bench; every kernel must have launched in that run;
5. drives the codec path on the card through ``make_registry(cuda:0)``,
   once the native T1/T2 library (g++, built beside the nvcc build) is
   loaded: 32 gray 512×512 12-bit frames and 8 RGB 512×512 8-bit frames
   through .90, 8 gray 12-bit frames through .91. Lossless codestreams
   must equal the native host lane's byte for byte and decode bit-exact,
   the lossy decode lie within ±1 of the host lane's; the fused forward
   stage must launch once per encode chunk and no other kernel beside it
   (an RGB chunk's stage is one device operation, and no RGB call runs the
   plain-torch RCT), the fused inverse stage once per decode chunk and no
   other kernel, and the pipelines must have run on the device engine
   (their ``pipeline.*`` events; the adapters' scalar fallback would hide
   a failure), and no call may launch the float DCT. Two gray 16 × 60001
   frames round-trip through .90 the same way, one stage launch a chunk
   each way and no other kernel. Part-2 matrix streams (.92/.93) take the
   scalar codec's device branches and must equal the same codec on the
   CPU. It also forces the
   int16-overflow redo once. Encode and decode frames/s of the
   registry path and of the same calls through ``make_registry(cuda:0,
   engine="host")``, the device's share of an encode and of a decode
   (torch.profiler over one registry call) and the lossy PSNR
   go on lines of their own; before it, the 9/7 stages' own main path
   (``lossy_phase``, every call counted from 0): .91 through the registry
   on 32 gray 512² 12-bit frames (4 ``j2k97_inv_stage`` launches, one a
   decode chunk, no other kernel) and 8 RGB frames (1, the inverse ICT in
   it), within ±1 of the host lane, and .93 with a Part-2 matrix (one
   ``j2k97_fwd_stage`` launch an encoded frame, one "coeffs"
   ``j2k97_inv_stage`` launch a decoded one), equal to the CPU's;
6. drives the other codec families through the same registry: exactly
   the fourteen UIDs; HTJ2K .201/.202 on 32 gray 512×512 12-bit frames,
   codestreams byte-identical to ``make_registry(cuda:0, engine="host")``
   with one fused forward stage launch a frame and one fused inverse
   stage launch a decode chunk, .203 within ±1; the 14 OpenJPH golden
   codestreams, one inverse stage launch each; RLE .5 on 32 gray 16-bit
   and 8 RGB frames, the card's byte planes equal to numpy's (their device
   time beside an x+1 of the same bytes on ``PLANES`` lines); .57, .70,
   .80 and .81 on the clinical fixtures and the fo-dicom SV1 stream with
   no launch and no card allocation; ``RATE`` and device-share lines of
   .201 and .5; then the port bench's line (``BENCH``);
7. drives JPEG baseline and extended through the same registry
   (``jpeg_phase``): .50 on 32 gray 512² 8-bit frames and .51 on 32 gray
   12-bit frames (the pipelined encode: one ``jpeg_fdct_islow`` launch an
   encode chunk; the pipelined decode: one ``jpeg_idct_islow`` launch a
   decode chunk of 8, 4 a decode), .50 on 8 RGB 4:4:4 frames (the
   per-frame native encode; one inverse launch for the decode, luma and
   chroma tables together), each byte-identical to ``make_registry(cuda:0,
   engine="host")`` in streams and pixels, with no float DCT launch;
   ``RATE`` and device-share lines of .50 and .51;
8. drives the multi-device scale-out (``go_dicom_codec_torch/parallel``,
   ``mesh_phase``) on a mesh of every visible card and on two shards of
   cuda:0 (tiles of 2): 32 gray 512² 12-bit frames, 5 levels, lossless,
   whose ``encode_frames_sharded`` streams equal
   ``encode_frames_pipelined`` on cuda:0 and the host engine's and whose
   ``decode_frames_sharded`` is bit-exact, with exactly one fused forward
   stage launch per tile and shard on encode, one fused inverse stage
   launch per tile and shard on decode and no other kernel (the lossy
   calls: one 9/7 stage launch per shard each way); 8 RGB
   512² 8-bit frames in four 256² tiles equal to the scalar
   ``J2KEncoder`` on cuda:0, decoding bit-exact with the RCT fused into
   the inverse stage; 8 gray 12-bit frames lossy at quality 85 whose
   streams equal the scalar encoder's device lane on cuda:0 and decode
   within ±1 of the scalar decoder's; a COC batch (component 1 at 4
   levels) through the heterogeneous decode, equal to ``J2KDecoder`` a
   frame; ``dryrun_multichip([cuda:0] * 4)`` (and on every card where
   there are two or more) and ``python -m
   go_dicom_codec_torch.tools.multiproc_dryrun --device cuda`` (its ``MP|``
   line names the backend); ``MESH`` lines of encode and decode frames/s
   (three rounds in turns with the pipelines on cuda:0) and of the device
   time of one sharded call;
9. drives the port's tools on cuda:0 (``tools_phase``): ``tools.fuzz``,
   400 trials of every family on the device engine from seed base 77000
   with no failure, the trials themselves launching ``j2k_inv_stage`` and
   ``jpeg_idct_islow``, then a known-good .90 512² decode bit-exact (the
   CUDA context survived); ``tools.transcode``, the clinical CT as .npy
   through j2k → htj2k → jls → npy bit-exact and the XR through baseline →
   npy within 64, every step's file equal to the same chain on the CPU,
   with both forward and both inverse kernels launched;
   ``python -m go_dicom_codec_torch.tools.interop --fixture clinical
   --parallel 2`` on the card, 18 rows and the multi-frame lanes passing;
   ``tools.benchmarks``' per-UID table at 512², 4 frames (the default 11
   UIDs and the other three through the registry, all 14 on the host
   engine) and its pipeline row at 8 frames, with ``BENCH|`` lines naming
   the card; ``tools.perf_check --emit-json`` at 256² (printed, no gate);
   ``utils.profiling.torch_trace`` around a registry .90 encode of 32
   frames between eight torch launches before it and eight after, whose
   Chrome trace names the forward stage's kernel (the counts printed:
   torch.profiler drops some kernel events);
10. prints the device bench rows (``BENCH|``, the 9/7 and color rows
   among them), one JSON object of kernel results
   (each with its event, device and host ms and device operations a
   call, timed once the main path has run, before the codec phase: the
   device ms is null where no profile held every launch, and a fused
   stage call must be one device operation; the DCT's with an x+1 copy
   of its input timed beside it; the islow kernels' launches from the
   JPEG phase, timed at the pipelines' chunk of 8 frames (the inverse
   from int16), with the forward of 12-bit samples, the RGB chunk's
   table-stack inverse, both at [32, 512, 512] and the inverse of one
   frame timed beside them; the forward stage's with its RGB narrow stage
   beside it; both fused stages' with their narrow stage of [2, 16, 65535]
   (``long``); the 9/7 stages' at [32, 1, 512, 512] with RGB and long
   rows, their plain versions' device operations and their launches on
   the lossy main path; the fused stages' ``mesh_launches``; every kernel's
   ``tools_launches`` of the fuzz, transcode and benchmarks runs), after a
   line that names the retired lifting-pass kernels and why, and as its
   last line
   ``{"ok": true, "device": {...}}``.

Any failure raises, exits non-zero and prints no ok line. Imports no JAX.
"""

import contextlib
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
from go_dicom_codec_torch.codecs.jpeg2000 import J2KEncoder
from go_dicom_codec_torch.codecs.jpeg_common import CHROMA_QUANT
from go_dicom_codec_torch.ops.convert import round_to_int32_sat
from go_dicom_codec_torch.ops.dct8x8 import (LUMA_QUANT, _basis,
                                            decode_zigzag_to_plane,
                                            encode_plane_to_zigzag, quantize,
                                            scale_quant_table, to_blocks)
from go_dicom_codec_torch.ops import dwt53
from go_dicom_codec_torch.ops.dwt53 import (_level_windows,
                                            fwd53_multilevel_,
                                            fwd53_multilevel_plain_,
                                            inv53_multilevel_,
                                            inv53_multilevel_plain_)
from go_dicom_codec_torch.ops import dwt97
from go_dicom_codec_torch.ops.dwt97 import fwd97_multilevel, inv97_multilevel
from go_dicom_codec_torch.ops.fdct8x8_quant import (encode_plane_blocks,
                                                    fdct8x8_quant,
                                                    fdct8x8_quant_plain)
from go_dicom_codec_torch.ops.j2k97_fwd_stage import (fwd97_stage,
                                                     fwd97_stage_plain)
from go_dicom_codec_torch.ops.j2k97_inv_stage import (inv97_stage,
                                                     inv97_stage_plain)
from go_dicom_codec_torch.ops.j2k_fwd_stage import fwd_stage, fwd_stage_plain
from go_dicom_codec_torch.ops.j2k_inv_stage import inv_stage, inv_stage_plain
from go_dicom_codec_torch.ops.jpeg_islow import (fdct_islow, idct_islow,
                                                 idct_islow_plain,
                                                 plane_dtype)
from go_dicom_codec_torch.ops.mct import dc_level_shift
from go_dicom_codec_torch.tools import device_bench
from go_dicom_codec_torch.utils import profiling

SEED = 0
B, H, W, LEVELS = 32, 512, 512, 5
RGB_FRAMES = 8
ROUNDS = 5
TRACE_XPLUS1 = 8  # torch launches before and after the traced encode
DCT_SHIFT = 2048
SOURCES = {
    "fdct8x8_quant": ("cuda", "go_dicom_codec_torch/csrc/fdct8x8_quant.cu",
                      "go_dicom_codec_tpu/ops/pallas_dct.py:83"),
    "j2k_fwd_stage": ("cuda", "go_dicom_codec_torch/csrc/j2k_fwd_stage.cu",
                      "go_dicom_codec_tpu/pipeline.py:43 (RGB: :56, :368)"),
    "j2k_inv_stage": ("cuda", "go_dicom_codec_torch/csrc/j2k_inv_stage.cu",
                      "go_dicom_codec_tpu/pipeline.py:435"),
    "j2k97_fwd_stage": ("cuda",
                        "go_dicom_codec_torch/csrc/j2k97_fwd_stage.cu",
                        "go_dicom_codec_tpu/codecs/jpeg2000.py:703 "
                        "(ops/dwt97.py:184 fwd97_multilevel_jit)"),
    "j2k97_inv_stage": ("cuda",
                        "go_dicom_codec_torch/csrc/j2k97_inv_stage.cu",
                        "go_dicom_codec_tpu/pipeline.py:462 "
                        "(_j2k_decode_device_stage_97)"),
    "jpeg_fdct_islow": ("cuda", "go_dicom_codec_torch/csrc/jpeg_islow.cu",
                        "go_dicom_codec_tpu/ops/dct8x8.py:177"),
    "jpeg_idct_islow": ("cuda", "go_dicom_codec_torch/csrc/jpeg_islow.cu",
                        "go_dicom_codec_tpu/ops/dct8x8.py:197"),
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM outside the tensor cores
# int32 outside the tensor cores: 64 lanes an SM a clock, a multiply-add
# counted as two operations as the float32 rate counts an FMA (half of it)
INT32_OPS_PER_S = 33.5e12
INT32_MAX, INT32_MIN = 2147483647, -2147483648
# shapes of the DCT kernel's ragged edges: W of five blocks (a tile and a
# masked part), H = 8, B = 1, and B × H/8 odd and not a multiple of the
# warps of a grid
DCT_RAGGED = ((1, 8, 40), (3, 8, 40), (1, 64, 40), (5, 24, 136), (7, 8, 8))
# float32 → int32 casts that must saturate as XLA's: out of range both
# ways, NaN, ±inf, the largest float32 below 2^31, 2^31, -2^31, ties
SATURATE = (3e9, -3e9, float("nan"), float("inf"), float("-inf"),
            2147483520.0, 2.0 ** 31, -2.0 ** 31, 2.5, -2.5, 0.5)
# the islow kernels' checks: shapes of ragged edges (beside [B, H, W]), the
# profiles (bits, level shift, sample dtype) and the qualities
ISLOW_RAGGED = ((3, 37, 45), (1, 1, 1), (2, 8, 4095), (1, 4095, 8),
                (2, 16, 9), (2, 24, 17), (1, 40, 263), (2, 16, 560))
# planes of one launch past a grid dimension's 65535 (csrc/jpeg_islow.cu
# folds the planes into grid x)
ISLOW_FOLD_PLANES = 65537
ISLOW_CHUNK = 8  # frames a chunk of both JPEG pipelines
ISLOW_PROFILES = ((8, 128, np.uint8), (12, 2048, np.uint16))
ISLOW_QUALITIES = (1, 50, 90, 100)
# frames with long sides (DICOM's longest is 65535), along rows and along
# columns, thin ones (one and two samples across) and an odd origin, as
# (shape, origin): one launch of a fused stage each way, whatever the
# line length
LONG_SHAPES = (((1, 8, 58111), (0, 0)), ((1, 58111, 8), (0, 0)),
               ((1, 8, 60001), (0, 0)), ((1, 60001, 8), (0, 0)),
               ((2, 16, 65535), (0, 0)), ((2, 65535, 16), (0, 0)),
               ((1, 1, 65535), (0, 0)), ((1, 65535, 2), (0, 0)),
               ((1, 8, 60001), (1, 1)))
# widths of the narrow stages' long-line checks: odd (the forward stage
# loads a sample at a time) and whole 16-byte vectors of 16- and 8-bit
# samples (it loads 16 bytes at a time)
NARROW_WIDTHS = (58111, 60000, 60001)
# the 9/7 stages' checks against their plain versions, as (shape [F, C,
# H, W], origin, levels): the main path's gray and RGB chunks, DICOM's
# longest side both ways, one- and two-sample frames, an odd origin, and
# frames that cross the card's strip seams (120 and 116 columns) and
# segment seams (64 rows and fewer) at every level, at an odd origin; the
# ICT wherever C >= 3
SHAPES_97 = (((B, 1, H, W), (0, 0), LEVELS),
             ((RGB_FRAMES, 3, H, W), (0, 0), LEVELS),
             ((2, 1, 16, 65535), (0, 0), LEVELS),
             ((2, 1, 65535, 16), (0, 0), LEVELS),
             ((2, 1, 1, 1), (1, 1), 3), ((2, 3, 1, 2), (0, 0), 3),
             ((2, 1, 2, 1), (1, 0), 3), ((2, 3, 2, 2), (1, 1), 3),
             ((2, 1, 1, 65535), (1, 0), LEVELS),
             ((2, 3, 61, 37), (1, 1), LEVELS),
             ((3, 1, 523, 517), (1, 1), LEVELS),
             ((2, 3, 97, 1031), (0, 0), LEVELS))
# the 9/7 forward stage's sample types: (dtype, bits of content, shift)
SAMPLES_97 = ((np.uint16, 12, 2048), (np.uint8, 8, 128),
              (np.float32, 12, 0))
# the kernels of csrc/dwt53.cu, retired: every line length runs in the
# fused stages' tile pass
RETIRED = {"dwt53_fwd_pass": "go_dicom_codec_tpu/ops/dwt53.py:71",
           "dwt53_inv_pass": "go_dicom_codec_tpu/ops/dwt53.py:112"}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def dct_f64_check(x, qt, got, label: str) -> int:
    """``got`` (a DCT result of x) against the float64 result of the
    kernel's float32 inputs (samples less the shift, D, Q): where they
    differ, the exact quotient must lie within the float32 error of a
    half-integer, so that only a rounding tie can flip. Returns how many
    coefficients differ.

    The margin, from the float32 error of the two 8-term sums: each sum
    of float32 products is off by at most γ8 Σ|terms| (γ8 = 8u / (1 -
    8u), u = 2^-24). A row of D has unit 2-norm, so Σ_k |D[u][k]| ≤ √8:
    Y = D·X is off by at most √8 γ8 M (M the block's largest |sample|),
    and a row of Y has 2-norm at most 8 M. Z = Y·Dᵀ is then off by at
    most γ8 · 8 M (its own sums) + √8 · √8 γ8 M (Y's error carried) =
    16 γ8 M. The divide adds u |Z/Q|, and adding 0.5 before the floor
    at most as much again: margin = 16 γ8 M / Q + 2^-22 |Z/Q|, about
    0.005 at 12-bit input (M ≤ 2048, Q ≥ 3)."""
    xf = to_blocks((x.to(torch.float32) - DCT_SHIFT).to(torch.float64))
    d = _basis(x.device).to(torch.float64)
    exact = (torch.einsum("ux,...xy,vy->...uv", d, xf, d)
             / qt.reshape(8, 8).to(torch.float64))
    m = xf.abs().amax(dim=(-2, -1), keepdim=True)
    gamma8 = 8 * 2.0 ** -24 / (1 - 8 * 2.0 ** -24)
    margin = (16 * gamma8 * m / qt.reshape(8, 8).to(torch.float64)
              + 2.0 ** -22 * exact.abs())
    r = exact.abs()
    want = round_to_int32_sat(torch.sign(exact) * torch.floor(r + 0.5))
    differ = to_blocks(got) != want
    tie = ((r - torch.floor(r)) - 0.5).abs()
    n = int(differ.sum())
    check(bool((tie[differ] <= margin[differ]).all()),
          f"{label}: a coefficient differs from the float64 result away "
          f"from a rounding tie")
    return n


def compare_dct(x, qt) -> int:
    """The fused DCT against its plain version (|Δ| ≤ 1 on < 0.5 % of the
    coefficients: float summation order differs) and both against the
    float64 result (``dct_f64_check``), at [32, 512, 512] and the ragged
    shapes; a misaligned view is refused by the wrapper and copied by the
    ops layer."""
    err = 0
    rng = np.random.default_rng(SEED + 1)
    for shape in ((B, H, W),) + DCT_RAGGED:
        xs = x if shape == (B, H, W) else torch.as_tensor(
            rng.integers(0, 1 << 12, shape, dtype=np.int32), device=x.device)
        got = fdct8x8_quant(xs, qt, DCT_SHIFT)
        want = fdct8x8_quant_plain(xs, qt, DCT_SHIFT)
        d = (got - want).abs()
        e, frac = int(d.max()), float((d != 0).float().mean())
        n_k = dct_f64_check(xs, qt, got, f"fdct8x8_quant {shape}")
        n_p = dct_f64_check(xs, qt, want, f"fdct8x8_quant_plain {shape}")
        print(f"fdct8x8_quant vs plain {shape}: max |d| {e}, differing "
              f"{frac:.6f}; off the float64 result at a tie: kernel {n_k}, "
              f"plain {n_p}")
        check(e <= 1 and frac < 0.005, f"fdct8x8_quant {shape} outside "
              f"tolerance")
        err = max(err, e)
    # a ragged plane goes through the edge-replicating wrapper
    plane = x[0, :61, :37]
    got = encode_plane_blocks(plane, qt, DCT_SHIFT)
    want = encode_plane_blocks(plane.cpu(), qt.cpu(), DCT_SHIFT).to(x.device)
    check(max_abs_diff(got, want) <= 1, "encode_plane_blocks [61, 37]")
    # a view off the 16-byte grid: the wrapper refuses it, the ops layer
    # copies it
    flat = x.reshape(-1)[1:1 + 3 * 8 * 40]
    odd = flat.view(3, 8, 40)
    check(not _kernels.aligned16(odd), "the test view is aligned")
    try:
        _kernels.fdct8x8_quant(odd, torch.empty_like(odd),
                               _basis(x.device).reshape(64), qt, DCT_SHIFT)
        check(False, "fdct8x8_quant launched on a misaligned view")
    except _kernels.KernelLaunchError:
        pass
    check(max_abs_diff(fdct8x8_quant(odd, qt, DCT_SHIFT),
                       fdct8x8_quant_plain(odd, qt, DCT_SHIFT)) <= 1,
          "fdct8x8_quant of a misaligned view")
    return err


def saturation(dev, qt) -> None:
    """Float → int32 saturates on the card as XLA's cast does: the DCT
    kernel and its plain version on planes of INT32_MAX and INT32_MIN
    samples (DC / 3 is past int32: exact; the rest, float residue of
    2^31-sized sums, within the float64 margin), ``quantize`` and the
    rounding helper on SATURATE, and the 9/7 decode stage (the kernel:
    one launch of j2k97_inv_stage) with SATURATE planted in its
    coefficients at 0-2 levels (the zero-coefficient lifting steps turn an
    inf into a NaN, the round sends it to 0), each equal to the same call
    on the CPU."""
    for sample in (INT32_MAX, INT32_MIN):
        x = torch.full((2, 16, 40), sample, dtype=torch.int32, device=dev)
        got = fdct8x8_quant(x, qt, DCT_SHIFT)
        want = fdct8x8_quant_plain(x, qt, DCT_SHIFT)
        host = fdct8x8_quant_plain(x.cpu(), qt.cpu(), DCT_SHIFT)
        for name, r in (("kernel", got), ("plain", want), ("cpu", host)):
            check(bool((r[:, ::8, ::8] == sample).all()),
                  f"fdct8x8_quant {name}: DC of {sample} does not saturate")
        dct_f64_check(x, qt, got, f"fdct8x8_quant of {sample}")
        dct_f64_check(x, qt, want, f"fdct8x8_quant_plain of {sample}")
        print(f"fdct8x8_quant of {sample} samples: DC {int(got[0, 0, 0])}; "
              f"kernel == CPU plain: {bool(got.cpu().equal(host))}, "
              f"max |kernel - plain| {max_abs_diff(got, want)}")
    v = torch.tensor(SATURATE, dtype=torch.float32)
    check(round_to_int32_sat(v.to(dev)).cpu().equal(round_to_int32_sat(v)),
          "round_to_int32_sat differs on the card")
    c = torch.zeros((2, 8, 8))
    c.view(-1)[:len(SATURATE)] = v
    c.view(-1)[64:64 + len(SATURATE)] = -v
    ones = torch.ones(64)
    check(quantize(c.to(dev), ones.to(dev)).cpu().equal(quantize(c, ones)),
          "quantize differs on the card")
    for mct in (False, True):
        f = torch.full((1, 3 if mct else 1, 2, 6), 1234.25)
        f.view(f.shape[1], -1)[0, :len(SATURATE)] = v
        if mct:   # chroma 0 under SATURATE, ±inf beside it
            f.view(3, -1)[1:, :len(SATURATE)] = 0.0
            f.view(3, -1)[1:, -1] = torch.tensor([float("inf"),
                                                  float("-inf")])
        for levels in (0, 1, 2):   # the elementwise epilogue, then lifting
            for signed in (True, False):
                for narrow in (False, True):
                    args = (levels, 0, 0, 12, signed, mct, narrow)
                    got = P._j2k_decode_device_stage_97(f.to(dev), *args)
                    check(got.cpu().equal(P._j2k_decode_device_stage_97(
                        f, *args)), f"_j2k_decode_device_stage_97 {args} "
                          f"differs on the card")
    print("saturating casts: the DCT kernel and plain version, quantize, "
          "the rounding helper and the 9/7 decode stage agree with the CPU")


def compare_dwt(x: torch.Tensor, levels: int, x0: int = 0,
                y0: int = 0) -> dict:
    """The fused forward stage against the plain lane, the fused inverse
    stage against the plain inverse, and the stages' epilogues against
    their plain versions (the forward's also with the RCT fused, on the first
    three planes as one frame; the inverse's with the planes as the
    components of one frame, RCT on, int16 and int32 input); all
    bit-exact. Returns each kernel's max |d|."""
    fwd_p = fwd53_multilevel_plain_(x.clone(), levels, x0, y0)
    errs = {"j2k_fwd_stage": max_abs_diff(
                fwd53_multilevel_(x.clone(), levels, x0, y0), fwd_p),
            "j2k_inv_stage": max_abs_diff(
                inv53_multilevel_(fwd_p.clone(), levels, x0, y0), x)}
    rgb = x[None, :3] if x.shape[0] >= 3 else None
    for src, mct in ((x, False), (rgb, True)):
        for epilogue in ("narrow", "stats") if src is not None else ():
            got = fwd_stage(src, 7, levels, x0, y0, epilogue, 16, mct)
            want = fwd_stage_plain(src, 7, levels, x0, y0, epilogue, 16, mct)
            errs["j2k_fwd_stage"] = max(errs["j2k_fwd_stage"], *(
                max_abs_diff(g, w) for g, w in zip(got, want)))
    packed = fwd_p[None]
    for src in (packed, packed.clamp(-32768, 32767).to(torch.int16)):
        for epilogue in ("pixels", "narrow"):
            args = (levels, x0, y0, 12, False, True, epilogue)
            errs["j2k_inv_stage"] = max(errs["j2k_inv_stage"], max_abs_diff(
                inv_stage(src, *args), inv_stage_plain(src, *args)))
    check(inv53_multilevel_plain_(fwd_p, levels, x0, y0).equal(x)
          and not any(errs.values()),
          f"5/3 lanes differ: shape {tuple(x.shape)} levels {levels} "
          f"origin ({x0}, {y0}), max |d| {errs}")
    return errs


def compare_stage(x16: torch.Tensor, rgb: torch.Tensor) -> int:
    """The fused forward stage of the pipelines' uint16 gray frames and of
    uint8 RGB frames (DC shift and RCT fused) against its plain version,
    in all three epilogues; bit-exact."""
    err = 0
    for x, shift, mct in ((x16, 2048, False), (rgb, 128, True)):
        for epilogue in ("coeffs", "narrow", "stats"):
            got = fwd_stage(x, shift, LEVELS, epilogue=epilogue, mct=mct)
            want = fwd_stage_plain(x, shift, LEVELS, epilogue=epilogue,
                                   mct=mct)
            if epilogue == "coeffs":
                got, want = (got,), (want,)
            err = max(err, *(max_abs_diff(g, w) for g, w in zip(got, want)))
    check(err == 0, f"j2k_fwd_stage differs from its plain version: {err}")
    print(f"j2k_fwd_stage == plain at {tuple(x16.shape)} uint16 and "
          f"{tuple(rgb.shape)} uint8 RGB, coeffs, narrow and stats")
    return err


def compare_inv_stage(coeffs: torch.Tensor) -> int:
    """The fused inverse stage of the pipelines' decode chunks against its
    plain version: [32, 1, 512, 512] gray and [8, 3, 512, 512] with the RCT
    (the coefficients' first 24 planes), int16 and int32 input, in all
    three epilogues; bit-exact."""
    err = 0
    for shape, bits, mct in (((B, 1, H, W), 12, False),
                             ((RGB_FRAMES, 3, H, W), 12, True)):
        packed = coeffs[:shape[0] * shape[1]].reshape(shape)
        for src in (packed.to(torch.int16), packed):
            for epilogue in ("coeffs", "pixels", "narrow"):
                args = (LEVELS, 0, 0, bits, False, mct, epilogue)
                got, want = inv_stage(src, *args), inv_stage_plain(src, *args)
                check(got.dtype == want.dtype, f"j2k_inv_stage {epilogue} "
                      f"gives {got.dtype}, its plain version {want.dtype}")
                err = max(err, max_abs_diff(got, want))
    check(err == 0, f"j2k_inv_stage differs from its plain version: {err}")
    print(f"j2k_inv_stage == plain at [{B}, 1, {H}, {W}] and "
          f"[{RGB_FRAMES}, 3, {H}, {W}] (RCT), int16 and int32, coeffs, "
          f"pixels and narrow")
    return err


def stage_tables(tile: int, head: int, lanes: int = 32,
                 seg: int = 64) -> None:
    """Set the fused stages' tile side and the inverse stage's head budget
    (ops/dwt53.py), and the 9/7 stages' strip geometry: strips of at most
    ``lanes`` lanes, segments of at most ``seg`` rows (ops/dwt97.py); the
    level tables are built anew."""
    dwt53._TILE, dwt53._HEAD_SAMPLES = tile, head
    dwt97._LANES, dwt97._SEG = lanes, seg
    for fn in (dwt53.fwd_schedule, dwt53.inv_schedule, dwt97.fwd97_schedule,
               dwt97.inv97_schedule):
        fn.cache_clear()


def compare_dwt_all(rng, dev) -> dict:
    """``compare_dwt`` over the launch models' matrix (tests/
    test_torch_j2k_*_stage.py): [B, H, W] at 5 levels; odd shapes and
    every shape up to 8×8 at every origin and levels 0-6, at the card's
    tile side of 64; then odd shapes, shapes whose rows are whole 16-byte
    vectors, and one-sample windows at tiles of 8 samples (many tiles,
    partial ones, grid levels), at head budgets of none, 64 and 4096
    samples."""
    x = torch.as_tensor(rng.integers(0, 1 << 12, (B, H, W), dtype=np.int32),
                        device=dev)
    cases = [(dc_level_shift(x, 16, False), LEVELS, 0, 0)]
    odd = torch.as_tensor(rng.integers(-4096, 4096, (3, 61, 37),
                                       dtype=np.int32), device=dev)
    wide = torch.as_tensor(rng.integers(-4096, 4096, (3, 40, 48),
                                        dtype=np.int32), device=dev)
    origins = ((0, 0), (1, 0), (0, 1), (1, 1))
    for x0, y0 in origins:
        for levels in range(0, 7):
            cases.append((odd, levels, x0, y0))
            cases += [(odd[:2, :h, :w].contiguous(), levels, x0, y0)
                      for h in range(1, 9) for w in range(1, 9)]
    errs = [compare_dwt(*case) for case in cases]
    n = len(cases)
    try:
        for head in (0, 64, 64 * 64):
            stage_tables(8, head)
            small = [odd, wide, wide[:1, :16, :16].contiguous(),
                     odd[:2, :1, :5].contiguous(),
                     odd[:2, :6, :1].contiguous()]
            for x0, y0 in origins:
                for levels in range(0, 7):
                    errs += [compare_dwt(c, levels, x0, y0) for c in small]
                    n += len(small)
    finally:
        stage_tables(64, 64 * 64)
    print(f"5/3 fused stages and plain lane agree on "
          f"{n} cases (tiles of 64 and 8, head budgets none, 64 and 4096)")
    return {k: max(e[k] for e in errs) for k in errs[0]}


def diff97(got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0 when ``got`` equals ``want`` bit for bit (float32: -0.0 is not
    +0.0; NaN where NaN), else their largest |difference| (inf where a
    NaN or inf differs)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return float("inf")
    if got.is_floating_point():
        if got.view(torch.int32).equal(want.view(torch.int32)):
            return 0.0
        d = (got.double() - want.double()).abs()
        return float(d.nan_to_num(float("inf")).max()) or float("inf")
    return float(max_abs_diff(got, want))


def compare_97(rng, dev) -> dict:
    """The 9/7 stages against their plain versions on the card, bit for
    bit: at SHAPES_97, the forward from each of SAMPLES_97 (the ICT where
    C >= 3), then the inverse of its coefficients in all three epilogues;
    then the covering of the launch models' tests (shapes 1×1 to 9×9 on
    three diagonals and 61×37, every origin parity, levels 0-6) at the
    card's strip geometry and at the tests' small one (strips of 4 lanes,
    segments of 4 rows). Returns each kernel's max |d|."""
    errs = {"j2k97_fwd_stage": 0.0, "j2k97_inv_stage": 0.0}
    cases = 0

    def one(shape, origin, levels, dtype, bits, shift):
        nonlocal cases
        mct = shape[1] >= 3
        if dtype == np.float32:
            x = rng.uniform(-2048, 2048, shape).astype(np.float32)
        else:
            x = rng.integers(0, 1 << bits, shape).astype(dtype)
        x = torch.as_tensor(x, device=dev)
        args = (shift, levels, *origin, mct)
        c = fwd97_stage(x, *args)
        errs["j2k97_fwd_stage"] = max(errs["j2k97_fwd_stage"], diff97(
            c, fwd97_stage_plain(x, *args)))
        for epilogue in ("coeffs", "pixels", "narrow"):
            args = (levels, *origin, bits, False, mct, epilogue)
            errs["j2k97_inv_stage"] = max(errs["j2k97_inv_stage"], diff97(
                inv97_stage(c, *args), inv97_stage_plain(c, *args)))
        cases += 1

    for shape, origin, levels in SHAPES_97:
        for dtype, bits, shift in SAMPLES_97:
            one(shape, origin, levels, dtype, bits, shift)
    small = sorted({(h, w) for h in range(1, 10)
                    for w in (h, 10 - h, (4 * h) % 9 + 1)})
    covering = [((2, 3) + hw, (i % 2, i // 2 % 2), i % 7)
                for i, hw in enumerate(small)]
    covering += [((2, 3, 61, 37), (lv % 2, lv // 2 % 2), lv)
                 for lv in range(7)]
    try:
        for lanes, seg in ((32, 64), (4, 4)):
            stage_tables(64, 64 * 64, lanes, seg)
            for shape, origin, levels in covering:
                one(shape, origin, levels, *SAMPLES_97[cases % 3])
    finally:
        stage_tables(64, 64 * 64)
    check(not any(errs.values()), f"the 9/7 stages differ from their plain "
          f"versions: {errs}")
    print(f"9/7 stages == plain, bit for bit, on {cases} cases: "
          f"{[s for s, _, _ in SHAPES_97]} from uint16, uint8 and float32 "
          f"(ICT where C >= 3), the inverse in coeffs, pixels and narrow; "
          f"the covering at the card's strip geometry and at strips of 4 "
          f"lanes and segments of 4 rows")
    return errs


def compare_islow(dev) -> dict:
    """The islow kernels against their plain versions on the card, bit for
    bit: the forward at [B, H, W] and ISLOW_RAGGED (block columns 1, 2, 3,
    6, 33, 70 and 512 across the CTA tiles) in both profiles and at every
    quality (uint8 or uint16 samples, int32 once a profile), the inverse
    on each forward's output from int32 and, where it fits, int16
    coefficients into the narrowest dtype and into int32; one inverse
    launch over a stack of three tables with a seeded index a plane, from
    int16 and int32; ``ISLOW_FOLD_PLANES`` 8×8 planes each way, past a
    grid dimension's 65535, the inverse also over the stack; 16-bit
    samples under the
    12-bit profile (coefficients past int16, products past int32), where
    both also equal the plain version on the CPU; the inverse of ±32768
    coefficients with a table of 65535s in both profiles, also against the
    CPU. Returns each kernel's max |d|."""
    rng = np.random.default_rng(SEED + 2)
    errs = {"jpeg_fdct_islow": 0, "jpeg_idct_islow": 0}
    cases = 0

    def against_plain(name, got, want, cpu=None):
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)}")
        errs[name] = max(errs[name], max_abs_diff(got, want))
        if cpu is not None:
            check(want.cpu().equal(cpu), f"{name}: the plain version on "
                  f"the card differs from the CPU's")

    def inverse(zz, q, level, max_val, on_cpu, index=None):
        want = idct_islow_plain(zz, q, level, max_val, index)
        cpu = (idct_islow_plain(zz.cpu(), q, level, max_val, index)
               if on_cpu else None)
        ins = [zz]
        if int(zz.min()) >= -32768 and int(zz.max()) <= 32767:
            ins.append(zz.to(torch.int16))
        for src in ins:
            for dt in (plane_dtype(max_val), torch.int32):
                got = idct_islow(src, q, level, max_val, dt,
                                 table_index=index)
                check(got.dtype == dt, f"jpeg_idct_islow gives {got.dtype}")
                against_plain("jpeg_idct_islow", got, want, cpu)

    def both(x, q, level, max_val, on_cpu=False):
        nonlocal cases
        want = encode_plane_to_zigzag(x, q, level)
        cpu = encode_plane_to_zigzag(x.cpu(), q, level) if on_cpu else None
        against_plain("jpeg_fdct_islow", fdct_islow(x, q, level), want, cpu)
        inverse(want, q, level, max_val, on_cpu)
        cases += 1
        return want

    for bits, level, dtype in ISLOW_PROFILES:
        for quality in ISLOW_QUALITIES:
            q = scale_quant_table(LUMA_QUANT, quality, 255)
            for shape in ((B, H, W),) + ISLOW_RAGGED:
                x = torch.as_tensor(rng.integers(0, 1 << bits, shape)
                                    .astype(dtype), device=dev)
                both(x, q, level, (1 << bits) - 1)
        both(x.to(torch.int32), q, level, (1 << bits) - 1)
        # a table stack: a chunk's luma and chroma, frames of their own DQT
        tables = np.stack([scale_quant_table(LUMA_QUANT, k, 255)
                           .reshape(64) for k in (10, 50, 95)])
        zz = both(torch.as_tensor(rng.integers(0, 1 << bits, (24, 40, 56))
                                  .astype(dtype), device=dev), tables[1],
                  level, (1 << bits) - 1)
        inverse(zz, tables, level, (1 << bits) - 1, False,
                tuple(int(t) for t in rng.integers(0, 3, 24)))
        # past 65535 planes: one launch each way
        x = torch.as_tensor(rng.integers(0, 1 << bits, (ISLOW_FOLD_PLANES,
                                                        8, 8))
                            .astype(dtype), device=dev)
        zz = both(x, tables[0], level, (1 << bits) - 1)
        inverse(zz, tables, level, (1 << bits) - 1, False,
                tuple(int(t) for t in rng.integers(0, 3, len(zz))))
        cases += 2
    # 16-bit samples under the 12-bit profile, the extreme blocks planted
    x16 = rng.integers(0, 1 << 16, (4, 64, 64)).astype(np.uint16)
    x16[0, :8, :8] = np.where(np.arange(8) % 2, 65535, 0)[None]
    x16[1, :8, 8:16] = 65535
    for quality in ISLOW_QUALITIES:
        q = scale_quant_table(LUMA_QUANT, quality, 255)
        zz = both(torch.as_tensor(x16, device=dev), q, 2048, 65535, True)
        check(quality != 100 or int(zz.abs().max()) > 32767,
              "the wrap case did not pass int16")
    # hostile coefficients with a 16-bit table
    zz = torch.as_tensor(rng.choice(np.array([-32768, 32767, 0, 1, -1],
                                             np.int32), (2, 16, 16, 64)),
                         device=dev)
    q = np.full(64, 65535, np.int32)
    for bits, level, _ in ISLOW_PROFILES:
        inverse(zz, q, level, (1 << bits) - 1, True)
        cases += 1
    check(not any(errs.values()), f"islow kernels differ from their plain "
          f"versions: {errs}")
    print(f"islow kernels == plain on {cases} cases: [{B}, {H}, {W}] and "
          f"{list(ISLOW_RAGGED)}, 8- and 12-bit profiles, qualities "
          f"{list(ISLOW_QUALITIES)}, int16 and int32 coefficients in, a "
          f"stack of 3 tables, {ISLOW_FOLD_PLANES} planes in one launch, "
          f"16-bit samples at level 2048, ±32768 coefficients × "
          f"65535")
    return errs


def launched(fn):
    """fn's result and the kernel launches it made, read as differences:
    the counts are not reset."""
    before = dict(_kernels.launch_counts)
    r = fn()
    torch.cuda.synchronize()
    return r, {k: v - before[k] for k, v in _kernels.launch_counts.items()}


def only(lc: dict, name: str, n: int) -> bool:
    """True when the launches ``lc`` are ``n`` of kernel ``name`` and none
    of any other."""
    return lc[name] == n and not any(v for k, v in lc.items() if k != name)


def long_lines(rng, dev) -> None:
    """``LONG_SHAPES`` forward and back in place, each way one launch of a
    fused stage and no other kernel, bit-exact against the plain lane;
    the narrow forward stage of 16- and 8-bit samples ``NARROW_WIDTHS``
    wide, then the narrow decode stage; the pipelines' narrow stages of
    [2, 16, 65535]; an RGB frame 60001 wide with the DC shift and RCT
    fused, forward and back."""
    for shape, (x0, y0) in LONG_SHAPES:
        x = torch.as_tensor(rng.integers(-2048, 2048, shape, dtype=np.int32),
                            device=dev)
        fwd, lc = launched(lambda: fwd53_multilevel_(x.clone(), LEVELS, x0,
                                                     y0))
        check(only(lc, "j2k_fwd_stage", 1), f"long-line forward {shape}: "
              f"launches {lc}")
        check(fwd.equal(fwd53_multilevel_plain_(x.clone(), LEVELS, x0, y0)),
              f"long-line forward {shape} differs from the plain lane")
        inv, lc = launched(lambda: inv53_multilevel_(fwd.clone(), LEVELS, x0,
                                                     y0))
        check(only(lc, "j2k_inv_stage", 1), f"long-line inverse {shape}: "
              f"launches {lc}")
        check(inv.equal(inv53_multilevel_plain_(fwd.clone(), LEVELS, x0, y0))
              and inv.equal(x), f"long-line inverse {shape} differs")
    for w in NARROW_WIDTHS:
        for bits, dtype in ((12, np.uint16), (8, np.uint8)):
            x = torch.as_tensor(rng.integers(0, 1 << bits, (2, 8, w))
                                .astype(dtype), device=dev)
            shift = 1 << (bits - 1)
            got, lc = launched(lambda: fwd_stage(x, shift, LEVELS,
                                                 epilogue="narrow"))
            want = fwd_stage_plain(x, shift, LEVELS, epilogue="narrow")
            check(only(lc, "j2k_fwd_stage", 1) and got[0].equal(want[0])
                  and got[1].equal(want[1]),
                  f"the narrow stage of {bits}-bit [2, 8, {w}] differs")
            px, lc = launched(lambda: P._j2k_decode_device_stage(
                got[0][:, None], LEVELS, 0, 0, bits, False, mct=False,
                narrow=True))
            check(only(lc, "j2k_inv_stage", 1)
                  and px[:, 0].to(torch.int32).equal(x.to(torch.int32)),
                  f"the decode stage of {bits}-bit [2, 8, {w}] differs")
    x16 = torch.as_tensor(rng.integers(0, 1 << 12, (2, 16, 65535),
                                       dtype=np.uint16), device=dev)
    got = P._pipeline_device_stage(x16, 12, False, LEVELS, narrow=True)
    want = fwd_stage_plain(x16, 2048, LEVELS, epilogue="narrow")
    check(got[0].equal(want[0]) and got[1].equal(want[1]),
          "the pipelines' narrow stage of a long-line frame differs")
    px = P._j2k_decode_device_stage(got[0][:, None], LEVELS, 0, 0, 12, False,
                                    mct=False, narrow=True)
    check(px[:, 0].equal(x16), "the decode stage of a long-line frame differs")
    rgb = torch.as_tensor(rng.integers(0, 256, (1, 3, 8, 60001))
                          .astype(np.uint8), device=dev)
    got, lc = launched(lambda: fwd_stage(rgb, 128, LEVELS, epilogue="narrow",
                                         mct=True))
    want = fwd_stage_plain(rgb, 128, LEVELS, epilogue="narrow", mct=True)
    check(only(lc, "j2k_fwd_stage", 1) and got[0].equal(want[0])
          and got[1].equal(want[1]),
          "the RGB narrow stage of [1, 3, 8, 60001] differs")
    px, lc = launched(lambda: P._j2k_decode_device_stage(
        got[0], LEVELS, 0, 0, 8, False, mct=True, narrow=True))
    check(only(lc, "j2k_inv_stage", 1)
          and px.to(torch.int32).equal(rgb.to(torch.int32)),
          "the RGB decode stage of [1, 3, 8, 60001] differs")
    print(f"long lines {[s for s, _ in LONG_SHAPES]} (the last at origin "
          f"(1, 1)): one stage launch each way, == plain lane; narrow "
          f"stages of 12- and 8-bit [2, 8, w], w in {list(NARROW_WIDTHS)}, "
          f"of the pipelines at [2, 16, 65535] and of RGB [1, 3, 8, 60001] "
          f"(RCT fused) == plain, decodes bit-exact")


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


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S
          ) -> dict:
    """The least time the card could take: {"bound_ms", "bound_by": "bytes"
    or "operations"}, the bytes over HBM's rate against the operations
    over ``ops_per_s`` (by default the float32 rate outside the tensor
    cores, for stages that mix integer and float operations)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    by = "bytes" if t_bytes >= t_ops else "operations"
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": by}


def timing(fn, n: int = 1) -> dict:
    """One call of ``fn`` over its ``n`` launches: the CUDA-event time of
    ten calls in a row (``ms``), the host time to issue one call
    (``host_ms``) and the device time torch.profiler records
    (``device_ms``), each divided by ``n``, and the device operations a
    call (``device_ops``). A profile that misses some of the ``n``
    launches is taken again; if none is whole, ``device_ms`` is None."""
    ms, host = device_bench.time_ms(fn)
    dev_ms, _, ops = device_bench.device_ms(fn, launches=n)
    return {"ms": ms / n, "host_ms": host / n,
            "device_ms": None if dev_ms is None else dev_ms / n,
            "device_ops": ops}


def lifted(shape) -> int:
    """The samples each 1D lifting pass of a 5/3 of ``LEVELS`` levels
    touches, summed over its passes (one along each side longer than one
    sample a level), for planes [..., H, W]."""
    planes = int(np.prod(shape[:-2]))
    return sum(planes * h * w * ((h > 1) + (w > 1))
               for w, h, _, _ in _level_windows(shape[-1], shape[-2], LEVELS,
                                                0, 0))


def time_97(dev, rng) -> dict:
    """The 9/7 stages' times (``timing``), plain ms, the plain version's
    device operations a call, bound ms and bound by: the forward stage of
    [B, 1, H, W] 12-bit uint16 frames to float32 coefficients (2 bytes in
    and 4 out a sample; ~7 float operations a sample and 1D pass of a
    level, 2 to widen), beside it [RGB_FRAMES, 3, H, W] uint8 with the ICT
    (1 byte in, 4 out; the ICT 5 operations a sample), [2, 1, 16, 65535]
    (``long``) and [2, 1, 65535, 16] (``long_col``: 16-sample rows, a
    strip's worth across); the decode stage of their coefficients,
    quantized with the device bench's step and dequantized, to uint16
    ("narrow": 4 bytes in and 2 out a sample; ~10 operations a sample and
    pass, 4 in the epilogue, the inverse ICT 5 more)."""
    x16 = torch.as_tensor(rng.integers(0, 1 << 12, (B, 1, H, W))
                          .astype(np.uint16), device=dev)
    rgb = torch.as_tensor(rng.integers(0, 256, (RGB_FRAMES, 3, H, W))
                          .astype(np.uint8), device=dev)
    long16 = torch.as_tensor(rng.integers(0, 1 << 12, (2, 1, 16, 65535))
                             .astype(np.uint16), device=dev)
    col16 = torch.as_tensor(rng.integers(0, 1 << 12, (2, 1, 65535, 16))
                            .astype(np.uint16), device=dev)
    out = {"j2k97_fwd_stage": {}, "j2k97_inv_stage": {}}
    for key, x, bits, mct in (("gray", x16, 12, False), ("rgb", rgb, 8, True),
                              ("long", long16, 12, False),
                              ("long_col", col16, 12, False)):
        shift, n = 1 << (bits - 1), x.numel()
        window = lifted(x.shape)
        fwd = lambda: fwd97_stage(x, shift, LEVELS, mct=mct)
        fwd_plain = lambda: fwd97_stage_plain(x, shift, LEVELS, mct=mct)
        c = fwd()
        f = (torch.sign(c) * torch.floor(c.abs() / device_bench.STEP_97)
             * device_bench.STEP_97)
        args = (LEVELS, 0, 0, bits, False, mct, "narrow")
        inv = lambda: inv97_stage(f, *args)
        inv_plain = lambda: inv97_stage_plain(f, *args)
        rows = {
            "j2k97_fwd_stage": (fwd, fwd_plain, (x.element_size() + 4) * n,
                                7 * window + (7 if mct else 2) * n),
            "j2k97_inv_stage": (inv, inv_plain, 6 * n,
                                10 * window + (9 if mct else 4) * n)}
        for name, (kernel, plain, nbytes, nops) in rows.items():
            row = {**timing(kernel),
                   "plain_ms": device_bench.time_ms(plain)[0],
                   "plain_device_ops": device_bench.device_ms(plain)[2],
                   "shape": list(x.shape), **bound(nbytes, nops)}
            if key == "gray":
                out[name].update(row)
            else:
                out[name][key] = row
    for name, tk in out.items():
        print(f"{name}: one call {tk['device_ops']} device operation(s), "
              f"its plain version {tk['plain_device_ops']:.0f}; event "
              f"{tk['ms']:.4f} ms, device {tk['device_ms']} ms, host "
              f"{tk['host_ms']:.4f} ms, plain {tk['plain_ms']:.4f} ms, bound "
              f"{tk['bound_ms']:.4f} ms ({tk['bound_by']})")
    return out


def time_kernels(dev, rng, qt) -> dict:
    """Each kernel's times (``timing``), plain ms, bound ms and bound by
    at the main path's shapes. The fused forward stage: the pipelines'
    narrow stage of [B, H, W] uint16 (reads 2 bytes and writes 2 a sample;
    ~4 operations a sample and 1D pass of a level, 3 in the epilogue), and
    beside it the RGB narrow stage of [RGB_FRAMES, 3, H, W] uint8 (reads 1
    byte and writes 2 a sample; the RCT ~5 operations a sample) and the
    narrow stage of [2, 16, 65535] (``long``). The fused inverse stage: the
    pipeline's narrow decode stage of [B, 1, H, W] int16 coefficients (2
    bytes in and 2 out a sample; ~4 operations a sample and pass, 4 in the
    epilogue), and beside it that of [2, 1, 16, 65535] (``long``). The
    DCT: [B, H, W] int32 in and out, 35 operations a sample, beside an x+1
    copy of the same tensor. The islow kernels at the main path's
    shapes: the forward of a JPEG encode chunk, [ISLOW_CHUNK, H, W] uint8
    samples to int32 coefficients (about 40 int32 operations a sample),
    the inverse of a .50 decode chunk's int16 coefficients back to uint8
    (about 32); beside them the forward of 12-bit uint16 samples (the .51
    encode chunk), the inverse of an RGB 4:4:4 decode chunk (3 ×
    RGB_FRAMES planes, luma and chroma tables, ``rgb_stack``), and at
    [B, H, W] the forward (``b32``, ``b32_uint16_12bit``) and the inverse
    from int32 and int16 (``b32``, ``b32_int16``), and the inverse of one
    frame from int32 (``per_frame``: the launch a frame and component
    decoded before the pipelined decode)."""
    x16 = torch.as_tensor(rng.integers(0, 1 << 12, (B, H, W),
                                       dtype=np.uint16), device=dev)
    window = lifted(x16.shape)
    t = {}
    t["j2k_fwd_stage"] = {
        **timing(lambda: fwd_stage(x16, 2048, LEVELS, epilogue="narrow")),
        "plain_ms": device_bench.time_ms(lambda: fwd_stage_plain(
            x16, 2048, LEVELS, epilogue="narrow"))[0],
        **bound(4 * x16.numel() + 4, 4 * window + 3 * x16.numel())}
    rgb = torch.as_tensor(rng.integers(0, 256, (RGB_FRAMES, 3, H, W))
                          .astype(np.uint8), device=dev)
    t["j2k_fwd_stage"]["rgb"] = {
        **timing(lambda: P._pipeline_device_stage_rgb(rgb, 8, LEVELS, True)),
        "plain_ms": device_bench.time_ms(lambda: fwd_stage_plain(
            rgb, 128, LEVELS, epilogue="narrow", mct=True))[0],
        **bound(3 * rgb.numel() + 4,
                4 * window * rgb.numel() // x16.numel() + 5 * rgb.numel())}
    pk = fwd_stage(x16, 2048, LEVELS, epilogue="narrow")[0][:, None]
    args = (LEVELS, 0, 0, 12, False, False, "narrow")
    t["j2k_inv_stage"] = {
        **timing(lambda: inv_stage(pk, *args)),
        "plain_ms": device_bench.time_ms(
            lambda: inv_stage_plain(pk, *args))[0],
        **bound(4 * pk.numel(), 4 * window + 4 * pk.numel())}
    long16 = torch.as_tensor(rng.integers(0, 1 << 12, (2, 16, 65535),
                                          dtype=np.uint16), device=dev)
    long_pk = fwd_stage(long16, 2048, LEVELS, epilogue="narrow")[0][:, None]
    t["j2k_fwd_stage"]["long"] = {
        **timing(lambda: fwd_stage(long16, 2048, LEVELS, epilogue="narrow")),
        "plain_ms": device_bench.time_ms(lambda: fwd_stage_plain(
            long16, 2048, LEVELS, epilogue="narrow"))[0],
        **bound(4 * long16.numel() + 4,
                4 * lifted(long16.shape) + 3 * long16.numel())}
    t["j2k_inv_stage"]["long"] = {
        **timing(lambda: inv_stage(long_pk, *args)),
        "plain_ms": device_bench.time_ms(
            lambda: inv_stage_plain(long_pk, *args))[0],
        **bound(4 * long_pk.numel(),
                4 * lifted(long16.shape) + 4 * long_pk.numel())}
    t.update(time_97(dev, rng))
    for tk in (t["j2k_fwd_stage"], t["j2k_fwd_stage"]["rgb"],
               t["j2k_fwd_stage"]["long"], t["j2k_inv_stage"],
               t["j2k_inv_stage"]["long"], t["j2k97_fwd_stage"],
               t["j2k97_inv_stage"],
               *(t[k][sub] for k in ("j2k97_fwd_stage", "j2k97_inv_stage")
                 for sub in ("rgb", "long", "long_col"))):
        check(tk["device_ms"] is None or tk["device_ops"] == 1,
              f"a fused stage call ran {tk['device_ops']} device operations")
    x = torch.as_tensor(rng.integers(0, 1 << 12, (B, H, W), dtype=np.int32),
                        device=dev)
    copy = timing(lambda: x + 1)
    t["fdct8x8_quant"] = {
        **timing(lambda: fdct8x8_quant(x, qt, DCT_SHIFT)),
        "plain_ms": device_bench.time_ms(
            lambda: fdct8x8_quant_plain(x, qt, DCT_SHIFT))[0],
        **bound(8 * B * H * W, 35 * B * H * W),
        "xplus1_ms": copy["ms"], "xplus1_device_ms": copy["device_ms"]}
    q = scale_quant_table(LUMA_QUANT, 90, 255)
    tables = np.stack([q, scale_quant_table(CHROMA_QUANT, 90, 255)])
    x8 = torch.as_tensor(rng.integers(0, 256, (B, H, W)).astype(np.uint8),
                         device=dev)
    x16 = torch.as_tensor(rng.integers(0, 4096, (B, H, W)).astype(np.uint16),
                          device=dev)
    rgb = torch.as_tensor(rng.integers(0, 256, (3 * RGB_FRAMES, H, W))
                          .astype(np.uint8), device=dev)
    zz = fdct_islow(x8, q, 128)
    zz16, zz_rgb = zz.to(torch.int16), fdct_islow(rgb, q, 128).to(
        torch.int16)
    rgb_index = (0, 1, 1) * RGB_FRAMES
    c = ISLOW_CHUNK
    n8, n = c * H * W, B * H * W
    steps = {
        # the main path's launches: the encode pipeline's chunk, the
        # decode pipeline's gray chunk (int16 in) and RGB 4:4:4 chunk
        "jpeg_fdct_islow": (
            lambda: fdct_islow(x8[:c], q, 128),
            lambda: encode_plane_to_zigzag(x8[:c], q, 128), 5 * n8, 40 * n8),
        "jpeg_idct_islow": (
            lambda: idct_islow(zz16[:c], q, 128, 255, torch.uint8),
            lambda: decode_zigzag_to_plane(zz16[:c], q, 128, 255).to(
                torch.uint8), 3 * n8, 32 * n8),
        "fdct_uint16_12bit": (
            lambda: fdct_islow(x16[:c], q, 2048),
            lambda: encode_plane_to_zigzag(x16[:c], q, 2048), 6 * n8,
            40 * n8),
        "idct_rgb_stack": (
            lambda: idct_islow(zz_rgb, tables, 128, 255, torch.uint8,
                               table_index=rgb_index),
            lambda: idct_islow_plain(zz_rgb, tables, 128, 255,
                                     rgb_index).to(torch.uint8),
            3 * zz_rgb.numel(), 32 * rgb.numel()),
        # beside them: [B, H, W] (the earlier rows), int32 in, one frame
        "fdct_b32": (
            lambda: fdct_islow(x8, q, 128),
            lambda: encode_plane_to_zigzag(x8, q, 128), 5 * n, 40 * n),
        "fdct_b32_uint16_12bit": (
            lambda: fdct_islow(x16, q, 2048),
            lambda: encode_plane_to_zigzag(x16, q, 2048), 6 * n, 40 * n),
        "idct_b32": (
            lambda: idct_islow(zz, q, 128, 255, torch.uint8),
            lambda: decode_zigzag_to_plane(zz, q, 128, 255).to(torch.uint8),
            5 * n, 32 * n),
        "idct_b32_int16": (
            lambda: idct_islow(zz16, q, 128, 255, torch.uint8),
            lambda: decode_zigzag_to_plane(zz16, q, 128, 255).to(
                torch.uint8), 3 * n, 32 * n),
        "per_frame": (
            lambda: idct_islow(zz[:1], q, 128, 255, torch.uint8),
            lambda: decode_zigzag_to_plane(zz[:1], q, 128, 255).to(
                torch.uint8), 5 * n // B, 32 * n // B)}
    for name, (kernel, plain, nbytes, nops) in steps.items():
        t[name] = {**timing(kernel),
                   "plain_ms": device_bench.time_ms(plain)[0],
                   **bound(nbytes, nops, INT32_OPS_PER_S)}
    for name, key in (("fdct_uint16_12bit", "uint16_12bit"),
                      ("fdct_b32", "b32"),
                      ("fdct_b32_uint16_12bit", "b32_uint16_12bit")):
        t["jpeg_fdct_islow"][key] = t.pop(name)
    for name, key in (("idct_rgb_stack", "rgb_stack"), ("idct_b32", "b32"),
                      ("idct_b32_int16", "b32_int16"),
                      ("per_frame", "per_frame")):
        t["jpeg_idct_islow"][key] = t.pop(name)
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


def sample_dtype(bits: int) -> np.dtype:
    """The stored sample type of ``bits``-bit frames."""
    return np.dtype(np.uint8 if bits <= 8 else "<u2")


def pixel_data(frames: np.ndarray, bits: int, rgb: bool):
    info = gdc.FrameInfo(width=frames.shape[2], height=frames.shape[1],
                         bits_allocated=8 * sample_dtype(bits).itemsize,
                         bits_stored=bits, samples_per_pixel=3 if rgb else 1)
    src = gdc.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.astype(sample_dtype(bits)).tobytes())
    return info, src


def timed(fn):
    """fn's result and its wall seconds, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def rates(calls: dict, n: int, rounds: int = ROUNDS) -> dict:
    """Frames/s of each named call of n frames, the calls run in turns
    ``rounds`` times: median, slowest and fastest round."""
    secs = {k: [] for k in calls}
    for _ in range(rounds):
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
    check(launches["encode"]["fdct8x8_quant"] == 0
          and launches["decode"]["fdct8x8_quant"] == 0,
          f"the codec path launched the float DCT {launches}")
    runs = pipeline_runs()
    n = len(frames)
    streams = [enc.get_frame(i) for i in range(n)]
    decoded = np.stack([np.frombuffer(dec.get_frame(i), sample_dtype(bits))
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


def device_share(label: str, call) -> None:
    """One line of where a warm registry call spends its time: wall ms,
    device ms and device operations (torch.profiler), the device's share
    and the largest device operations."""
    call()
    wall = timed(call)[1]
    dev_ms, top, ops = device_bench.device_ms(call, iters=1)
    share = None if dev_ms is None else dev_ms / (wall * 1e3)
    print(f"{label}: wall {wall * 1e3:.1f} ms, device {dev_ms} ms in "
          f"{ops:.0f} device operations, device share {share}; "
          f"top kernels {json.dumps(top)}")


@contextlib.contextmanager
def counted_rct():
    """Counts the calls of the plain-torch forward RCT (ops/mct.py and its
    imports in the forward stage's plain lane and the scalar codec) inside
    the ``with``: {"calls": n}."""
    from go_dicom_codec_torch.codecs import jpeg2000
    from go_dicom_codec_torch.ops import j2k_fwd_stage, mct

    count = {"calls": 0}
    saved = [(mod, mod.rct_forward) for mod in (mct, j2k_fwd_stage,
                                                 jpeg2000)]

    def rct(*args):
        count["calls"] += 1
        return saved[0][1](*args)
    for mod, _ in saved:
        mod.rct_forward = rct
    try:
        yield count
    finally:
        for mod, fn in saved:
            mod.rct_forward = fn


def rgb_chunk_ops(registry, frames: np.ndarray, bits: int, chunks: int,
                  dev) -> None:
    """The RGB encode's device work: one registry encode of ``frames``
    runs one ``j2k_fwd_stage`` launch a chunk and no other kernel (the
    profiler may drop some events, C5, so only their names are held); one
    chunk as the pipeline uploads it ([F, 3, H, W] 8-bit samples) is
    exactly one device operation, the forward stage's kernel."""
    info, src = pixel_data(frames, bits, True)
    codec = registry.get_codec(gdc.uids.JPEG_2000_LOSSLESS)
    _kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        codec.encode(src, gdc.MemoryPixelData(info=info, encapsulated=True))
        torch.cuda.synchronize()
    launched = _kernels.launch_counts["j2k_fwd_stage"]
    kernels = {e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))}
    check(launched == chunks and kernels
          and all("fwd_stage_kernel" in k for k in kernels),
          f"an RGB encode ran {launched} stage launches for {chunks} "
          f"chunks and the kernels {kernels}")
    size = -(-len(frames) // chunks)
    x = torch.as_tensor(np.ascontiguousarray(np.moveaxis(
        frames[:size], -1, 1).astype(sample_dtype(bits))), device=dev)
    stage = lambda: P._pipeline_device_stage_rgb(x, bits, LEVELS, True)
    # one kind of device operation, at most one a call: torch.profiler
    # may drop an event of the ten calls (C5), never add one
    ms, top, ops = device_bench.device_ms(stage)
    check(len(top) == 1 and "fwd_stage_kernel" in top[0][0] and ops <= 1,
          f"an RGB encode chunk ran {ops} device operations: {top}")
    print(f"RGB .90 encode: {launched} j2k_fwd_stage launches for {chunks} "
          f"chunks, no other kernel; a chunk [{size}, 3, {H}, {W}] "
          f"{x.dtype} is 1 device operation ({ops} recorded a call), "
          f"{ms} ms")


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
        with counted_rct() as rcts:
            streams, decoded, lc, calls, runs = registry_round_trip(
                registry, host_registry, uid, frames, bits, rgb)
        check(rcts["calls"] == 0, f"{name}: the registry ran the plain-torch "
              f"RCT {rcts['calls']} times")
        check(runs == {"pipeline.encode": (1, "device"),
                       "pipeline.decode": (1, "device")},
              f"{name}: the pipelines did not run on the device {runs}")
        chunks = profiling.EVENTS["pipeline.encode"]["chunks"]
        dchunks = profiling.EVENTS["pipeline.decode"]["chunks"]
        host_streams, host_dec = host_lane(frames, bits, dev, streams)
        check(streams == host_streams,
              f"{name}: registry codestreams differ from the host lane's")
        check(np.array_equal(decoded, frames),
              f"{name}: registry decode is not bit-exact")
        check(np.array_equal(host_dec.reshape(frames.shape), frames),
              f"{name}: host lane decode is not bit-exact")
        check(only(lc["encode"], "j2k_fwd_stage", chunks),
              f"{name}: the encode did not run one j2k_fwd_stage launch a "
              f"chunk ({chunks}) and no other kernel")
        check(only(lc["decode"], "j2k_inv_stage", dchunks),
              f"{name}: the decode did not run one j2k_inv_stage launch a "
              f"chunk ({dchunks}) and no other kernel")
        launches[name] = lc
        if rgb:
            rgb_chunk_ops(registry, frames, bits, chunks, dev)
        print(f"{name} .90 [{n}, {H}, {W}]: codestreams == host lane, "
              f"decode bit-exact; launches {json.dumps(lc)}")
        measured[name] = rates(host_checked(calls), n)

    # frames 60001 samples wide: the fused stages inside the registry
    # calls, one launch a chunk, byte-identical to the host lane
    frames = phantom(rng, 2, 12, shape=(16, 60001))
    streams, decoded, lc, _, runs = registry_round_trip(
        registry, host_registry, gdc.uids.JPEG_2000_LOSSLESS, frames, 12,
        False)
    chunks = profiling.EVENTS["pipeline.encode"]["chunks"]
    dchunks = profiling.EVENTS["pipeline.decode"]["chunks"]
    host_streams, host_dec = host_lane(frames, 12, dev, streams)
    check(runs == {"pipeline.encode": (1, "device"),
                   "pipeline.decode": (1, "device")}
          and streams == host_streams and np.array_equal(decoded, frames)
          and np.array_equal(host_dec.reshape(frames.shape), frames),
          f"long lines: the .90 round trip failed {runs}")
    check(only(lc["encode"], "j2k_fwd_stage", chunks)
          and only(lc["decode"], "j2k_inv_stage", dchunks),
          f"long lines: not one stage launch a chunk ({chunks}, {dchunks}) "
          f"and no other kernel {lc}")
    print(f"long-line .90 [2, 16, 60001]: codestreams == host lane, decode "
          f"bit-exact; launches {json.dumps(lc)}")

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
            lossy = uid == gdc.uids.JPEG_2000_MC_LOSSY
            fwd_name, inv_name = (("j2k97_fwd_stage", "j2k97_inv_stage")
                                  if lossy else ("j2k_fwd_stage",
                                                 "j2k_inv_stage"))
            _kernels.reset_launch_counts()
            reg.get_codec(uid).encode(src, enc, params)
            fwd = _kernels.launch_counts[fwd_name]
            dct = _kernels.launch_counts["fdct8x8_quant"]
            _kernels.reset_launch_counts()
            reg.get_codec(uid).decode(enc, dec)
            inv = _kernels.launch_counts[inv_name]
            check(dct == _kernels.launch_counts["fdct8x8_quant"] == 0,
                  f"{uid}: the codec path launched the float DCT")
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
        check(fwd > 0 and inv > 0, f"{uid}: the forward or the inverse "
              f"stage did not launch ({fwd}, {inv})")
        if uid == gdc.uids.JPEG_2000_MC_LOSSLESS:
            check(err <= 1, f"{uid}: round trip off by {err}")
        print(f"{uid} Part-2 matrix, 2 × [{H}, {W}, 3]: card == CPU, "
              f"codestreams and decode; max |decode - source| {err}; "
              f"{fwd} {fwd_name} and {inv} {inv_name} launches")

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

    # the device's share of one registry encode and one registry decode of
    # the gray frames
    frames = phantom(rng, B, 12)
    info, src = pixel_data(frames, 12, False)
    codec = registry.get_codec(gdc.uids.JPEG_2000_LOSSLESS)
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    for name, call in (
            ("encode", lambda: codec.encode(
                src, gdc.MemoryPixelData(info=info, encapsulated=True))),
            ("decode", lambda: codec.decode(enc,
                                            gdc.MemoryPixelData(info=info)))):
        device_share(f"registry {name} of [{B}, {H}, {W}]", call)
    for name, r in measured.items():
        print("RATE " + json.dumps({"path": name, "card": card, **r}))
    return launches


# ---- the lossy main path: the 9/7 stages ----------------------------------

PART2_MATRIX = [[0.6, 0.5, 0.5], [0.5, 0.6, -0.5], [0.5, -0.5, 0.6]]


def lossy_phase(rng, dev) -> dict:
    """The 9/7 stages' main path through ``make_registry(cuda:0)``: .91 of
    B gray 512² 12-bit frames (the encode on the native host 9/7, as the
    reference; the decode one ``j2k97_inv_stage`` launch a chunk of 8 and
    no other kernel), of RGB_FRAMES RGB 8-bit frames (one launch, the
    inverse ICT in it), each within ±1 of the native host lane; then .93
    (a Part-2 matrix) on 2 RGB frames: one ``j2k97_fwd_stage`` launch an
    encoded frame after the matrix, one "coeffs" ``j2k97_inv_stage`` launch
    a decoded frame before it, equal to the same registry on the CPU. Each
    call is counted from 0 just before it (``registry_round_trip``).
    Returns the phase's launches, summed over its calls."""
    registry = gdc.make_registry(dev)
    host_registry = gdc.make_registry(dev, engine="host")
    cpu_registry = gdc.make_registry(torch.device("cpu"))
    profiling.enable_global_timer()
    total = dict.fromkeys(_kernels.launch_counts, 0)

    def add(lc):
        for way in lc.values():
            for k, v in way.items():
                total[k] += v
    t0 = time.perf_counter()
    for name, n, bits, rgb in (("gray", B, 12, False),
                               ("rgb", RGB_FRAMES, 8, True)):
        frames = (np.stack([phantom(rng, n, bits) for _ in range(3)],
                           axis=-1) if rgb else phantom(rng, n, bits))
        streams, decoded, lc, _, runs = registry_round_trip(
            registry, host_registry, U.JPEG_2000_LOSSY, frames, bits, rgb)
        add(lc)
        dchunks = profiling.EVENTS["pipeline.decode"]["chunks"]
        check(runs == {"pipeline.decode": (1, "device")},
              f".91 {name}: the decode pipeline did not run on the device "
              f"{runs}")
        check(not any(lc["encode"].values()), f".91 {name}: the encode "
              f"(native host 9/7) launched {lc['encode']}")
        check(dchunks == -(-n // 8)
              and only(lc["decode"], "j2k97_inv_stage", dchunks),
              f".91 {name}: the decode did not run one j2k97_inv_stage "
              f"launch a chunk ({dchunks}) and no other kernel "
              f"{lc['decode']}")
        host_dec = np.stack(P.decode_frames_pipelined(
            streams, engine="host", device=dev)).reshape(frames.shape)
        err = int(np.abs(decoded.astype(np.int64) - host_dec).max())
        check(err <= 1, f".91 {name}: the decode differs from the host "
              f"lane by {err}")
        mse = float(np.mean((decoded.astype(np.float64) - frames) ** 2))
        print(f".91 {name} [{n}, {H}, {W}{', 3' if rgb else ''}]: "
              f"{lc['decode']['j2k97_inv_stage']} j2k97_inv_stage launches "
              f"for {dchunks} decode chunks, no other kernel; max |registry "
              f"- host lane| {err}; PSNR "
              f"{10 * np.log10(((1 << bits) - 1) ** 2 / mse):.2f} dB")
    rgb = np.stack([phantom(rng, 2, 8) for _ in range(3)], axis=-1)
    params = gdc.Parameters(mct_matrix=PART2_MATRIX,
                            mct_inverse=np.linalg.inv(PART2_MATRIX).tolist())
    got = []
    for reg in (registry, cpu_registry):
        info, src = pixel_data(rgb, 8, True)
        enc = gdc.MemoryPixelData(info=info, encapsulated=True)
        dec = gdc.MemoryPixelData(info=info)
        _kernels.reset_launch_counts()
        reg.get_codec(U.JPEG_2000_MC_LOSSY).encode(src, enc, params)
        lc = {"encode": dict(_kernels.launch_counts)}
        _kernels.reset_launch_counts()
        reg.get_codec(U.JPEG_2000_MC_LOSSY).decode(enc, dec)
        torch.cuda.synchronize()
        lc["decode"] = dict(_kernels.launch_counts)
        got.append(([enc.get_frame(i) for i in range(2)],
                    [dec.get_frame(i) for i in range(2)], lc))
    (card_enc, card_dec, lc), (cpu_enc, cpu_dec, cpu_lc) = got
    add(lc)
    check(only(lc["encode"], "j2k97_fwd_stage", 2)
          and only(lc["decode"], "j2k97_inv_stage", 2),
          f".93: not one 9/7 stage launch a frame each way {lc}")
    check(not any(v for way in cpu_lc.values() for v in way.values()),
          ".93: the CPU registry launched a kernel")
    check(card_enc == cpu_enc and card_dec == cpu_dec,
          ".93: the card's codestreams or decode differ from the CPU's")
    print(f".93 Part-2 matrix 2 × [{H}, {W}, 3]: card == CPU, codestreams "
          f"and decode; launches {json.dumps(lc)}")
    check(total["j2k97_fwd_stage"] > 0 and total["j2k97_inv_stage"] > 0,
          "a 9/7 stage never launched on its main path")
    print(f"lossy main path {time.perf_counter() - t0:.2f} s, launches "
          f"{total}")
    return total


# ---- the other codec families ---------------------------------------------

U = gdc.uids
PORT_UIDS = sorted([
    U.RLE_LOSSLESS, U.JPEG_BASELINE_8BIT, U.JPEG_EXTENDED_12BIT,
    U.JPEG_LOSSLESS_P14, U.JPEG_LOSSLESS_SV1,
    U.JPEG_LS_LOSSLESS, U.JPEG_LS_NEAR_LOSSLESS, U.JPEG_2000_LOSSLESS,
    U.JPEG_2000_LOSSY, U.JPEG_2000_MC_LOSSLESS, U.JPEG_2000_MC_LOSSY,
    U.HTJ2K_LOSSLESS, U.HTJ2K_LOSSLESS_RPCL, U.HTJ2K])
HOST_CODECS = (U.JPEG_LOSSLESS_P14, U.JPEG_LOSSLESS_SV1, U.JPEG_LS_LOSSLESS,
               U.JPEG_LS_NEAR_LOSSLESS)
FAMILY_ROUNDS = 3
GOLDEN = "test-data/htj2k_interop"
CLINICAL = "test-data/clinical_pixels.npz"
SV1 = "test-data/us_fodicom_sv1.jpg"
SV1_PIXEL_SHA = ("bae1813f165ae41351acbffb87ee982c"
                 "e80ea942c1c88f5ee83b0824ab5e377a")


def host_round_trip(host_registry, uid, frames, bits, rgb):
    """Encode then decode through the host-engine registry, which must
    launch no kernel. Returns (streams, decoded)."""
    info, src = pixel_data(frames, bits, rgb)
    codec = host_registry.get_codec(uid)
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    dec = gdc.MemoryPixelData(info=info)
    before = dict(_kernels.launch_counts)
    codec.encode(src, enc)
    codec.decode(enc, dec)
    check(_kernels.launch_counts == before,
          f"{uid}: the host engine launched a kernel")
    return ([enc.get_frame(i) for i in range(len(frames))],
            np.stack([np.frombuffer(dec.get_frame(i), sample_dtype(bits))
                      for i in range(len(frames))]).reshape(frames.shape))


def htj2k_phase(rng, dev, registry, host_registry) -> dict:
    """.201 and .202: 32 gray 512² 12-bit frames through the card registry
    and the host engine, codestreams byte-identical and decodes bit-exact;
    one forward stage launch a frame on encode, one inverse stage launch a
    decode chunk, no lifting pass, no DCT. .203: 8 frames at quality 85,
    decodes within ±1 of the host engine's. Returns the .201 calls for
    ``rates`` and the launches."""
    frames = phantom(rng, B, 12)
    launches, out_calls = {}, None
    for uid in (U.HTJ2K_LOSSLESS, U.HTJ2K_LOSSLESS_RPCL):
        streams, decoded, lc, calls, runs = registry_round_trip(
            registry, host_registry, uid, frames, 12, False)
        check(runs == {"pipeline.decode": (1, "device")},
              f"{uid}: the decode pipeline did not run on the device {runs}")
        dchunks = profiling.EVENTS["pipeline.decode"]["chunks"]
        host_streams, host_dec = host_round_trip(host_registry, uid, frames,
                                                 12, False)
        check(streams == host_streams,
              f"{uid}: card codestreams differ from the host engine's")
        check(np.array_equal(decoded, frames)
              and np.array_equal(host_dec, frames),
              f"{uid}: a decode is not bit-exact")
        enc, dec = lc["encode"], lc["decode"]
        check(only(enc, "j2k_fwd_stage", B),
              f"{uid}: the encode did not run one j2k_fwd_stage launch a "
              f"frame and no other kernel {enc}")
        check(only(dec, "j2k_inv_stage", dchunks),
              f"{uid}: the decode did not run one j2k_inv_stage launch a "
              f"chunk ({dchunks}) and no other kernel {dec}")
        launches[uid] = lc
        print(f"HTJ2K {uid} [{B}, {H}, {W}] 12-bit: codestreams == host "
              f"engine, decodes bit-exact; j2k_fwd_stage launches per "
              f"encode {enc['j2k_fwd_stage']} (one a frame), j2k_inv_stage "
              f"per decode {dec['j2k_inv_stage']} ({dchunks} chunks of 8), "
              f"no other kernel; "
              f"{sum(len(s) for s in streams) / B:.0f} bytes/frame")
        out_calls = out_calls or calls
    frames = phantom(rng, RGB_FRAMES, 12)
    params = gdc.Parameters(quality=85)
    info, src = pixel_data(frames, 12, False)
    got = []
    for reg in (registry, host_registry):
        enc = gdc.MemoryPixelData(info=info, encapsulated=True)
        dec = gdc.MemoryPixelData(info=info)
        _kernels.reset_launch_counts()
        reg.get_codec(U.HTJ2K).encode(src, enc, params)
        reg.get_codec(U.HTJ2K).decode(enc, dec)
        got.append(([enc.get_frame(i) for i in range(RGB_FRAMES)],
                    np.stack([np.frombuffer(dec.get_frame(i), "<u2")
                              for i in range(RGB_FRAMES)]).astype(np.int64),
                    dict(_kernels.launch_counts)))
    (card_s, card_d, lc), (host_s, host_d, host_lc) = got
    err = int(np.abs(card_d - host_d).max())
    check(err <= 1, f"{U.HTJ2K}: decode differs from the host engine's by "
          f"{err}")
    check(lc["fdct8x8_quant"] == 0 and not any(host_lc.values()),
          f"{U.HTJ2K}: launches {lc}, host engine {host_lc}")
    print(f"HTJ2K {U.HTJ2K} [{RGB_FRAMES}, {H}, {W}] quality 85: max |card "
          f"- host engine| {err}, codestreams equal "
          f"{card_s == host_s}; launches {json.dumps(lc)}")
    return {"calls": out_calls, "launches": launches}


def golden_phase(registry) -> int:
    """The OpenJPH golden codestreams decode through the card registry to
    their input.raw, each by the scalar decode's one launch of the fused
    inverse stage. Returns the inverse stage launches they took."""
    with open(f"{GOLDEN}/manifest.json") as f:
        fixtures = json.load(f)["fixtures"]
    uid_of = {"htj2k_lossless": U.HTJ2K_LOSSLESS,
              "htj2k_lossless_rpcl": U.HTJ2K_LOSSLESS_RPCL}
    n = 0
    _kernels.reset_launch_counts()
    for fx in fixtures:
        w, h, nc, ba = (fx["width"], fx["height"], fx["components"],
                        fx["bitsAllocated"])
        dt = np.uint8 if ba == 8 else np.dtype("<i2" if fx["signed"]
                                               else "<u2")
        with open(f"{GOLDEN}/{fx['inputRaw']}", "rb") as f:
            raw = f.read()
        info = gdc.FrameInfo(width=w, height=h, bits_allocated=ba,
                             bits_stored=fx["bitsStored"],
                             samples_per_pixel=nc,
                             pixel_representation=int(fx["signed"]))
        for key, cs in fx["codestreams"].items():
            with open(f"{GOLDEN}/{cs['path']}", "rb") as f:
                stream = f.read()
            enc = gdc.MemoryPixelData(info=info, encapsulated=True)
            enc.add_frame(stream)
            dec = gdc.MemoryPixelData(info=info)
            registry.get_codec(uid_of[key]).decode(enc, dec)
            check(np.array_equal(np.frombuffer(dec.get_frame(0), dt),
                                 np.frombuffer(raw, dt)),
                  f"golden {fx['name']} {key} differs from its input.raw")
            n += 1
    check(n == 14, f"{n} golden codestreams, not 14")
    inv = _kernels.launch_counts["j2k_inv_stage"]
    check(only(_kernels.launch_counts, "j2k_inv_stage", n),
          f"golden decodes: launches {_kernels.launch_counts} for {n} "
          f"streams, want {n} of the inverse stage alone")
    print(f"OpenJPH golden codestreams: {n} decoded through the card "
          f"registry == input.raw; launches "
          f"{json.dumps(dict(_kernels.launch_counts))}")
    return inv


def planes_profile(dev, frames: np.ndarray, ba: int, spp: int,
                   card: str) -> dict:
    """The RLE byte planes on the card: split and merge of the stacked
    frames against an x+1 over the same bytes, event and device ms."""
    from go_dicom_codec_torch.ops.planes import (merge_byte_planes,
                                                 split_byte_planes)
    batch = torch.as_tensor(np.ascontiguousarray(frames).view(np.uint8)
                            .reshape(len(frames), -1), device=dev)
    planes = split_byte_planes(batch, ba, spp)
    check(merge_byte_planes(planes, ba, spp).equal(batch),
          "merge_byte_planes does not invert split_byte_planes")
    line = {"bytes": batch.numel(), "frames": len(frames),
            "bound_ms": 2 * batch.numel() / HBM_BYTES_PER_S * 1e3,
            "gpu": card}
    for name, fn in (("split", lambda: split_byte_planes(batch, ba, spp)),
                     ("merge", lambda: merge_byte_planes(planes, ba, spp)),
                     ("xplus1", lambda: batch + 1)):
        t = timing(fn)
        line[name] = {"event_ms": t["ms"], "device_ms": t["device_ms"],
                      "host_ms": t["host_ms"]}
    return line


def rle_phase(rng, dev, card: str) -> dict:
    """.5: 32 gray 512² 16-bit frames and 8 RGB 512² 8-bit frames through
    ``engine="device"`` (the byte planes on the card) and ``"host"``
    (numpy): streams and frames byte-identical; the planes' device time
    beside an x+1 over the same bytes. Returns the gray calls for
    ``rates``."""
    device_reg = gdc.make_registry(dev, engine="device")
    host_reg = gdc.make_registry(dev, engine="host")
    gray_calls = None
    for name, frames, bits, rgb, ba, spp in (
            ("gray", phantom(rng, B, 16), 16, False, 2, 1),
            ("rgb", np.stack([phantom(rng, RGB_FRAMES, 8) for _ in range(3)],
                             axis=-1), 8, True, 1, 3)):
        streams, decoded, lc, calls, _ = registry_round_trip(
            device_reg, host_reg, U.RLE_LOSSLESS, frames, bits, rgb)
        host_streams, host_dec = host_round_trip(host_reg, U.RLE_LOSSLESS,
                                                 frames, bits, rgb)
        check(streams == host_streams,
              f"RLE {name}: device-plane streams differ from the host's")
        check(np.array_equal(decoded, frames)
              and np.array_equal(host_dec, frames),
              f"RLE {name}: a decode is not bit-exact")
        check(not any(lc["encode"].values()) and not any(
            lc["decode"].values()), f"RLE {name}: a kernel launched {lc}")
        prof = planes_profile(dev, frames.astype(np.uint8 if rgb else "<u2"),
                              ba, spp, card)
        print(f"RLE .5 {name} {list(frames.shape)}: device planes == host, "
              f"streams and frames; "
              f"{sum(len(s) for s in streams) / len(frames):.0f} "
              f"bytes/frame")
        print("PLANES " + json.dumps({"frames": name, **prof}))
        gray_calls = gray_calls or calls
    return gray_calls


def host_codecs_phase(dev, registry) -> None:
    """.57, .70, .80, .81 through the card registry: the clinical frames
    round-trip (near-lossless within its NEAR of 2), the fo-dicom SV1
    stream decodes to its pinned pixels, and no call launches a kernel or
    allocates on the card."""
    import gc
    import hashlib

    z = np.load(CLINICAL)
    gc.collect()   # no earlier phase's garbage may be freed in between
    torch.cuda.synchronize()
    before = (dict(_kernels.launch_counts), torch.cuda.memory_allocated(dev))
    for key in ("mr_s16", "xr_u8", "ct_u12"):
        arr = z[key]
        bits, signed = (int(v) for v in z[key + "_meta"])
        h, w = arr.shape
        info = gdc.FrameInfo(width=w, height=h,
                             bits_allocated=arr.dtype.itemsize * 8,
                             bits_stored=bits,
                             pixel_representation=int(signed))
        src = gdc.MemoryPixelData(info=info)
        src.add_frame(np.ascontiguousarray(arr).tobytes())
        for uid in HOST_CODECS:
            codec = registry.get_codec(uid)
            enc = gdc.MemoryPixelData(info=info, encapsulated=True)
            codec.encode(src, enc)
            dec = gdc.MemoryPixelData(info=info)
            codec.decode(enc, dec)
            got = np.frombuffer(dec.get_frame(0), arr.dtype).astype(np.int64)
            err = int(np.abs(got - arr.reshape(-1)).max())
            tol = 2 if uid == U.JPEG_LS_NEAR_LOSSLESS else 0
            check(err <= tol, f"{uid} {key}: round trip off by {err}")
    with open(SV1, "rb") as f:
        stream = f.read()
    info = gdc.FrameInfo(width=512, height=512, bits_allocated=16,
                         bits_stored=12)
    enc = gdc.MemoryPixelData(info=info, encapsulated=True)
    enc.add_frame(stream)
    dec = gdc.MemoryPixelData(info=info)
    registry.get_codec(U.JPEG_LOSSLESS_SV1).decode(enc, dec)
    check(hashlib.sha256(dec.get_frame(0)).hexdigest() == SV1_PIXEL_SHA,
          "the fo-dicom SV1 stream does not decode to its pinned pixels")
    gc.collect()
    torch.cuda.synchronize()
    after = (dict(_kernels.launch_counts), torch.cuda.memory_allocated(dev))
    check(after == before, f"the host codecs touched the card: {before} → "
          f"{after}")
    print(f"host codecs {HOST_CODECS}: clinical mr_s16, xr_u8, ct_u12 round "
          f"trips, SV1 golden sha256 pinned; no launch, card memory "
          f"{after[1]} bytes before and after")


def families_phase(rng, dev, card: str) -> dict:
    """The codec families beyond J2K, through ``make_registry(cuda:0)``:
    the registry's fourteen UIDs, HTJ2K, the golden streams, RLE, the host
    codecs, then the ``RATE`` lines of .201 and .5 (three rounds in
    turns). Returns the HTJ2K launches."""
    registry = gdc.make_registry(dev)
    host_registry = gdc.make_registry(dev, engine="host")
    check(registry.registered_transfer_syntaxes() == PORT_UIDS,
          f"make_registry holds {registry.registered_transfer_syntaxes()}")
    check(gdc.registry.get_global_registry().registered_transfer_syntaxes()
          == [], "the port's global registry is not empty")
    print(f"registry: {len(PORT_UIDS)} UIDs {PORT_UIDS}; global registry "
          f"empty")
    ht = htj2k_phase(rng, dev, registry, host_registry)
    golden = golden_phase(registry)
    rle_calls = rle_phase(rng, dev, card)
    host_codecs_phase(dev, registry)
    for path, calls in (("htj2k_201", ht["calls"]), ("rle_5", rle_calls)):
        r = rates(host_checked(calls), B, FAMILY_ROUNDS)
        print("RATE " + json.dumps({"path": path, "card": card, **r}))
        for name in ("encode", "decode"):
            device_share(f"{path} registry {name} of [{B}, {H}, {W}]",
                         calls[f"registry_{name}"])
    return {"htj2k": ht["launches"], "golden_inv_stage": golden}


def jpeg_phase(rng, dev, card: str) -> dict:
    """.50 and .51 through ``make_registry(cuda:0)`` against the host
    engine: 32 gray 512² frames at 8 bits (.50) and 12 bits (.51, CT-like)
    take the pipelined encode, one ``jpeg_fdct_islow`` launch an encode
    chunk and its ``pipeline.encode`` event on the device engine, and the
    pipelined decode, one ``jpeg_idct_islow`` launch a decode chunk (4 for
    32 frames) and its ``pipeline.decode`` event; 8 RGB 4:4:4 frames (.50)
    the per-frame native encode and one inverse launch for the decode's
    one chunk, luma and chroma tables together. Streams byte-identical,
    decodes bit-identical, no float DCT, then the ``RATE`` (three rounds
    in turns) and device-share lines. Returns the launches of the registry
    calls, each counted from 0 just before its call."""
    registry = gdc.make_registry(dev)
    host_registry = gdc.make_registry(dev, engine="host")
    launches = {"jpeg_fdct_islow": 0, "jpeg_idct_islow": 0}
    cases = (("gray_50", U.JPEG_BASELINE_8BIT, phantom(rng, B, 8), 8, False),
             ("rgb_50", U.JPEG_BASELINE_8BIT,
              np.stack([phantom(rng, RGB_FRAMES, 8) for _ in range(3)],
                       axis=-1), 8, True),
             ("gray_51", U.JPEG_EXTENDED_12BIT, phantom(rng, B, 12), 12,
              False))
    for name, uid, frames, bits, rgb in cases:
        n = len(frames)
        streams, decoded, lc, calls, runs = registry_round_trip(
            registry, host_registry, uid, frames, bits, rgb)
        host_streams, host_dec = host_round_trip(host_registry, uid, frames,
                                                 bits, rgb)
        check(streams == host_streams,
              f"{name}: card streams differ from the host engine's")
        check(np.array_equal(decoded, host_dec),
              f"{name}: the card decode differs from the host engine's")
        enc, dec = lc["encode"], lc["decode"]
        want_runs = {"pipeline.decode": (1, "device")}
        chunks, dec_chunks = 0, -(-n // ISLOW_CHUNK)
        if not rgb:
            want_runs["pipeline.encode"] = (1, "device")
            chunks = profiling.EVENTS["pipeline.encode"]["chunks"]
        check(runs == want_runs, f"{name}: pipeline runs {runs}")
        check(profiling.EVENTS["pipeline.decode"]["chunks"] == dec_chunks,
              f"{name}: decode chunks {profiling.EVENTS['pipeline.decode']}")
        check(enc["jpeg_fdct_islow"] == chunks
              and dec["jpeg_idct_islow"] == dec_chunks
              and dec_chunks == (1 if rgb else 4)
              and enc["jpeg_idct_islow"] == dec["jpeg_fdct_islow"] == 0,
              f"{name}: launches {lc} ({chunks} encode chunks, "
              f"{dec_chunks} decode chunks, {n} frames)")
        for k in launches:
            launches[k] += enc[k] + dec[k]
        err = int(np.abs(decoded.astype(np.int64) - frames).max())
        print(f"JPEG {uid} {name} {list(frames.shape)}: streams == host "
              f"engine, decode == host engine (max |decode - source| "
              f"{err}); jpeg_fdct_islow per encode {enc['jpeg_fdct_islow']} "
              f"({chunks} chunks), jpeg_idct_islow per decode "
              f"{dec['jpeg_idct_islow']} ({dec_chunks} chunks), DCT "
              f"{enc['fdct8x8_quant'] + dec['fdct8x8_quant']}; "
              f"{sum(len(s) for s in streams) / n:.0f} bytes/frame")
        if rgb:
            continue
        r = rates(host_checked(calls), n, FAMILY_ROUNDS)
        print("RATE " + json.dumps({"path": name, "card": card, **r}))
        for call in ("encode", "decode"):
            device_share(f"{name} registry {call} of {list(frames.shape)}",
                         calls[f"registry_{call}"])
    return launches


# ---- the mesh phase ------------------------------------------------------

MESH_ROUNDS = 3
MESH_STAGES = ("j2k_fwd_stage", "j2k_inv_stage", "j2k97_fwd_stage",
               "j2k97_inv_stage")


def counted(fn):
    """fn's result and the launches it made: every count set to 0 just
    before the call and read just after it."""
    _kernels.reset_launch_counts()
    r = fn()
    torch.cuda.synchronize()
    return r, dict(_kernels.launch_counts)


def check_stage_launches(label: str, lc: dict, fwd: int, inv: int,
                         lossy: bool = False) -> None:
    """The fused 5/3 stages (the 9/7's where ``lossy``) launched ``fwd``
    and ``inv`` times and no other kernel launched."""
    names = (("j2k97_fwd_stage", "j2k97_inv_stage") if lossy
             else ("j2k_fwd_stage", "j2k_inv_stage"))
    check(lc[names[0]] == fwd and lc[names[1]] == inv
          and not any(v for k, v in lc.items() if k not in names),
          f"{label}: launches {lc}, want {fwd} {names[0]}, {inv} "
          f"{names[1]}")


def blocks(n: int, positions: int) -> int:
    """The non-empty blocks of n frames cut into equal contiguous blocks of
    ceil(n / positions), as the reference splits its padded batch (1, 2 and
    4 for 32 frames on 1, 2 and 4 positions; 8 for 8 frames on 8 or more):
    counted here, not taken from the mesh code under test."""
    size = -(-n // positions)
    return -(-n // size)


def remux_coc(frame_a: np.ndarray, frame_b: np.ndarray, levels_b: int,
              dev) -> bytes:
    """One 2-component codestream from two gray frames, component 1 at its
    own level count by COC (and QCC): the packets of two single-component
    streams interleaved by resolution (LRCP, one layer, one precinct)."""
    from go_dicom_codec_torch.codecs.j2k_geometry import build_tile_geometry
    from go_dicom_codec_torch.codecs.jpeg2000 import (J2KEncodeParams,
                                                      J2KEncoder, band_mb)
    from go_dicom_codec_torch.codestream import j2k
    from go_dicom_codec_torch.t2.packets import (BlockState, PrecinctState,
                                                 decode_packet,
                                                 progression_order)

    def split(cs):
        cod, qcd = cs.cod, cs.qcd
        body, rect = cs.tiles[0].data, cs.siz.tile_rect(0, 0)
        res_list = build_tile_geometry(*rect, cod.num_levels, cod.cb_width,
                                       cod.cb_height, cod.precinct_exp)
        states = {(res.r, p.index): [
            PrecinctState(ncbw=pb.ncbw, ncbh=pb.ncbh,
                          blocks=[BlockState(cbx=g.cbx, cby=g.cby)
                                  for g in pb.blocks],
                          mb=band_mb(qcd, res.r, pb.band.band,
                                     cod.num_levels))
            for pb in p.bands] for res in res_list for p in res.precincts}

        def pinfo(c, r):
            lv = cod.num_levels
            return [(p.index, p.x0 << (lv - r), p.y0 << (lv - r))
                    for p in res_list[r].precincts]

        out, pos = [], 0
        for (lay, r, c, pidx) in progression_order(
                cod.progression, cod.num_layers, cod.num_levels + 1, 1,
                pinfo):
            start = pos
            pos = decode_packet(body, pos, states[(r, pidx)], lay,
                                cod.cb_style)
            out.append((r, body[start:pos]))
        return out

    h, w = frame_a.shape
    css = [j2k.parse_codestream(J2KEncoder(
        J2KEncodeParams(num_levels=lv), device=dev).encode(
            f.astype("<u2").tobytes(), w, h, 1, 16))
        for f, lv in ((frame_a, LEVELS), (frame_b, levels_b))]
    tagged = sorted([(r, c, blob) for c, cs in enumerate(css)
                     for (r, blob) in split(cs)], key=lambda t: t[:2])
    siz = j2k.SizInfo(xsiz=w, ysiz=h, xtsiz=w, ytsiz=h,
                      components=[css[0].siz.components[0]] * 2)
    cod_b = css[1].cod
    out = bytearray(b"\xff\x4f") + j2k.write_siz(siz)
    out += j2k.write_cod(css[0].cod)
    out += j2k.write_coc(j2k.CocInfo(
        comp=1, num_levels=cod_b.num_levels, cb_width=cod_b.cb_width,
        cb_height=cod_b.cb_height, cb_style=cod_b.cb_style,
        transform=cod_b.transform), 2)
    out += j2k.write_qcd(css[0].qcd) + j2k.write_qcc(1, css[1].qcd, 2)
    out += j2k.write_tile_part(0, b"".join(b for (_, _, b) in tagged))
    return bytes(out + j2k.EOC.to_bytes(2, "big"))


class DeviceLaneEncoder(J2KEncoder):
    """The scalar encoder with every tile transformed on its device lane
    (``_tile_coeffs_device``, one frame at a time on the card), where its
    lossy host fast path would take the native 9/7 (float, but not
    bit-pinned to torch's). No ROI."""

    def _tile_coeffs(self, arr, rect, cod, qcd, bit_depth, signed,
                     use_mct, roi_shifts=None,
                     precomputed_coeffs=None) -> np.ndarray:
        check(not roi_shifts and precomputed_coeffs is None,
              "DeviceLaneEncoder: no ROI or precomputed tiles")
        tx0, ty0, tx1, ty1 = rect
        return self._tile_coeffs_device(arr[ty0:ty1, tx0:tx1, :], rect, cod,
                                        qcd, bit_depth, signed, use_mct,
                                        arr.shape[2])


def mesh_profile(call) -> dict:
    """Wall ms of one warm call, and the device ms, device operations and
    largest device operations torch.profiler records over one more; None
    where the profile recorded no device event (not measured)."""
    wall = timed(call)[1] * 1e3
    dev_ms, top, ops = device_bench.device_ms(call, iters=1)
    if not ops:
        return {"wall_ms": wall, "device_ms": None, "device_share": None}
    return {"wall_ms": wall, "device_ms": dev_ms, "device_operations": ops,
            "device_share": dev_ms / wall, "top": top}


def mesh_phase(rng, dev, card: str, cards: list) -> dict:
    """The port's multi-device scale-out (``parallel/``) at full width, on
    a mesh of ``cards`` (every visible card) and on two shards of ``dev``
    (cuda:0; tiles of 2):
    32 gray 512² 12-bit frames (5 levels, lossless) whose sharded streams
    equal ``encode_frames_pipelined`` on cuda:0 and the host engine's and
    decode bit-exact, with one forward stage launch per tile and shard on
    encode and one inverse per tile and shard on decode; 8 RGB 512² 8-bit
    frames in four 256² tiles equal to the scalar ``J2KEncoder`` on cuda:0
    (the RCT fused into the inverse stage); 8 gray 12-bit frames lossy at
    quality 85 equal to the scalar encoder's device lane and decoding
    within ±1 of the scalar decoder's, one 9/7 stage launch per shard each
    way; a COC batch
    (component 1 at 4 levels) through the heterogeneous decode, equal to
    ``J2KDecoder`` a frame; the dry run on four shards of cuda:0 (and on
    every card where there are two or more); the two-process run; then
    ``MESH`` lines of frames/s (three rounds in turns with the pipelines on
    cuda:0) and of the device time of one sharded call. Returns the fused
    stages' launches, each call counted from 0 just before it."""
    import subprocess

    from go_dicom_codec_torch.codecs.jpeg2000 import (J2KDecoder,
                                                      J2KEncodeParams,
                                                      J2KEncoder)
    from go_dicom_codec_torch.parallel import (decode_frames_sharded,
                                               encode_frames_sharded,
                                               make_mesh)
    from go_dicom_codec_torch.parallel.dryrun import dryrun_multichip

    # name: (mesh, its positions)
    meshes = {f"cards{len(cards)}": (make_mesh(cards), len(cards)),
              "cuda0x2": (make_mesh([dev, dev], tile_parallel=2), 2)}
    launches = {"encode": dict.fromkeys(MESH_STAGES, 0),
                "decode": dict.fromkeys(MESH_STAGES, 0)}

    def tally(lc: dict, way: str) -> None:
        for k in MESH_STAGES:
            launches[way][k] += lc[k]

    gray = phantom(rng, B, 12)
    pipelined = P.encode_frames_pipelined(gray, bit_depth=12, levels=LEVELS,
                                          engine="device", device=dev)
    host = P.encode_frames_pipelined(gray, bit_depth=12, levels=LEVELS,
                                     engine="host", device=dev)
    check(pipelined == host, "mesh: the pipelined streams differ from the "
          "host engine's")
    rgb = np.stack([phantom(rng, RGB_FRAMES, 8) for _ in range(3)], axis=-1)
    p_rgb = J2KEncodeParams(num_levels=LEVELS, tile_width=H // 2,
                            tile_height=W // 2)
    scalar_rgb = [J2KEncoder(p_rgb, device=dev).encode(f, W, H, 3, 8)
                  for f in rgb]
    lossy = phantom(rng, RGB_FRAMES, 12)
    p_lossy = J2KEncodeParams(num_levels=LEVELS, lossless=False, quality=85)
    scalar_lossy = [DeviceLaneEncoder(p_lossy, device=dev).encode(
        f, W, H, 1, 12) for f in lossy]
    coc = [remux_coc(a, b, LEVELS - 1, dev) for a, b in zip(
        phantom(rng, RGB_FRAMES, 16), phantom(rng, RGB_FRAMES, 16))]
    coc_want = [J2KDecoder(device=dev).decode(s)[0] for s in coc]
    profiles = {}
    for name, (mesh, positions) in meshes.items():
        nb = blocks(B, positions)
        gray_streams, lc = counted(lambda: encode_frames_sharded(
            gray, 12, False, LEVELS, mesh=mesh))
        check(gray_streams == pipelined, f"mesh {name}: gray streams differ "
              f"from the pipelined encoder's")
        check_stage_launches(f"mesh {name} gray encode", lc, nb, 0)
        tally(lc, "encode")
        dec, lc = counted(lambda: decode_frames_sharded(gray_streams,
                                                        mesh=mesh))
        check(np.array_equal(np.stack(dec)[..., 0], gray),
              f"mesh {name}: gray decode is not bit-exact")
        check_stage_launches(f"mesh {name} gray decode", lc, 0, nb)
        tally(lc, "decode")

        nb_rgb = blocks(RGB_FRAMES, positions)
        streams, lc = counted(lambda: encode_frames_sharded(
            rgb, 8, mesh=mesh, params=p_rgb))
        check(streams == scalar_rgb, f"mesh {name}: RGB streams differ from "
              f"the scalar encoder's")
        check_stage_launches(f"mesh {name} RGB encode", lc, 4 * nb_rgb, 0)
        tally(lc, "encode")
        dec, lc = counted(lambda: decode_frames_sharded(streams, mesh=mesh))
        check(np.array_equal(np.stack(dec), rgb),
              f"mesh {name}: RGB decode is not bit-exact")
        check_stage_launches(f"mesh {name} RGB decode", lc, 0, 4 * nb_rgb)
        tally(lc, "decode")

        nb_lossy = blocks(RGB_FRAMES, positions)
        streams, lc = counted(lambda: encode_frames_sharded(
            lossy, 12, mesh=mesh, params=p_lossy))
        check(streams == scalar_lossy, f"mesh {name}: lossy streams differ "
              f"from the scalar encoder's")
        check_stage_launches(f"mesh {name} lossy encode", lc, nb_lossy, 0,
                             lossy=True)
        tally(lc, "encode")
        dec, lc = counted(lambda: decode_frames_sharded(streams, mesh=mesh))
        dec = np.stack(dec)
        check_stage_launches(f"mesh {name} lossy decode", lc, 0, nb_lossy,
                             lossy=True)
        tally(lc, "decode")
        want = np.stack([J2KDecoder(device=dev).decode(s)[0]
                         for s in streams])
        lossy_err = int(np.abs(dec.astype(np.int64) - want).max())
        check(lossy_err <= 1, f"mesh {name}: lossy decode off by "
              f"{lossy_err} from the scalar decoder's")
        src_err = int(np.abs(dec[..., 0].astype(np.int64) - lossy).max())

        dec, lc = counted(lambda: decode_frames_sharded(coc, mesh=mesh))
        check(all(np.array_equal(d, w) for d, w in zip(dec, coc_want)),
              f"mesh {name}: COC decode differs from J2KDecoder's")
        check_stage_launches(f"mesh {name} COC decode", lc, 0,
                             2 * blocks(len(coc), positions))
        tally(lc, "decode")
        for way, call in (("encode", lambda: encode_frames_sharded(
                gray, 12, False, LEVELS, mesh=mesh)),
                ("decode", lambda: decode_frames_sharded(gray_streams,
                                                         mesh=mesh))):
            profiles[f"{name}_{way}"] = mesh_profile(call)
        print(f"mesh {name} {mesh}: {B} gray {H}² streams == pipelined == "
              f"host engine, decode bit-exact, {nb} forward and {nb} inverse "
              f"launches; {RGB_FRAMES} RGB in 4 tiles == scalar encoder, "
              f"decode bit-exact, {4 * nb_rgb} launches each way; lossy "
              f"q85 streams == scalar encoder, decode within {lossy_err} "
              f"of the scalar decoder, {nb_lossy} 9/7 stage launches each "
              f"way "
              f"(max |decode - source| {src_err}); COC batch == J2KDecoder")

    summaries = [dryrun_multichip([dev] * 4)]
    if len(cards) >= 2:
        summaries.append(dryrun_multichip(cards))
    for sm in summaries:
        print(f"dry run on {sm['devices']}: mesh {sm['mesh']}, step "
              f"{sm['step']}, cross-shard bit-plane sum {sm['cb_bits_total']}, "
              f"{sm['frames']} frames byte-identical; passed")
    mp = subprocess.run([sys.executable, "-m",
                         "go_dicom_codec_torch.tools.multiproc_dryrun",
                         "--device", dev.type],
                        capture_output=True, text=True, timeout=300)
    lines = [ln for ln in mp.stdout.splitlines() if ln.startswith("MP|")]
    print(*lines, sep="\n")
    check(mp.returncode == 0 and len(lines) == 1
          and json.loads(lines[0][3:])["ok"],
          f"the two-process run failed (rc {mp.returncode}): "
          f"{mp.stdout[-2000:]} {mp.stderr[-2000:]}")

    # rates: the sharded calls on each mesh in turns with the pipelines on
    # cuda:0 (device engine)
    calls = {"pipelined_encode": lambda: P.encode_frames_pipelined(
        gray, bit_depth=12, levels=LEVELS, engine="device", device=dev),
        "pipelined_decode": lambda: P.decode_frames_pipelined(
            pipelined, engine="device", device=dev)}
    for name, (mesh, _) in meshes.items():
        calls[f"{name}_encode"] = lambda mesh=mesh: encode_frames_sharded(
            gray, 12, False, LEVELS, mesh=mesh)
        calls[f"{name}_decode"] = lambda mesh=mesh: decode_frames_sharded(
            pipelined, mesh=mesh)
    r = rates(calls, B, MESH_ROUNDS)
    print("MESH " + json.dumps({"path": "gray_j2k_lossless_512", "frames": B,
                                "card": card, "rounds": MESH_ROUNDS, **r}))
    for name, line in profiles.items():
        print("MESH " + json.dumps({"call": name, "card": card, **line}))
    return launches


# ---- the tools phase ----------------------------------------------------

FUZZ_TRIALS = 400
FUZZ_SEED_BASE = 77000
TOOLS_DEVICE = ("--device", "cuda:0")
# transcode chains: (fixture key, crop, steps of (target, extra argv),
# largest |decode - source| allowed: interop's tolerance for the lossy row)
TRANSCODE_CHAINS = (
    ("ct_u12", None, (("j2k", ("--bits", "12")), ("htj2k", ()), ("jls", ()),
                      ("npy", ())), 0),
    ("xr_u8", 512, (("baseline", ()), ("npy", ())), 64),
)
BENCH_EXTRA_UIDS = (U.JPEG_2000_MC_LOSSLESS, U.JPEG_2000_MC_LOSSY,
                    U.HTJ2K_LOSSLESS_RPCL)


def tool(main_fn, argv) -> tuple:
    """A tool's ``main(argv)`` in this process: (exit code, its stdout)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(list(argv))
    return rc, out.getvalue()


def fuzz_phase(rng, dev) -> dict:
    """400 trials of every family on the card's device engine from seed base
    77000: no failure, the inverse stage and the islow inverse launched by
    the trials themselves; then a known-good .90 decode of a 512² frame is
    bit-exact (the CUDA context survived the campaign)."""
    from go_dicom_codec_torch.codecs.jpeg2000 import (J2KDecoder,
                                                      J2KEncodeParams)
    from go_dicom_codec_torch.tools import fuzz

    (rc, out), lc = counted(lambda: tool(fuzz.main, (
        "--trials", str(FUZZ_TRIALS), "--seed-base", str(FUZZ_SEED_BASE),
        *TOOLS_DEVICE, "--engine", "device")))
    print(out.strip())
    summary = json.loads(out.strip().splitlines()[-1].split("|", 1)[1])
    check(rc == 0 and summary["failures"] == 0
          and summary["trials"] == FUZZ_TRIALS, f"fuzz: exit {rc}")
    print(f"FUZZ launches {json.dumps(lc)}")
    check(lc["j2k_inv_stage"] > 0 and lc["jpeg_idct_islow"] > 0,
          "the fuzz campaign reached neither inverse kernel")
    frame = phantom(rng, 1, 12)[0]
    stream = J2KEncoder(J2KEncodeParams(), device=dev,
                        engine="host").encode(frame, W, H, 1, 12)
    (got, _, _), alive = counted(lambda: J2KDecoder(
        device=dev, engine="device").decode(stream))
    check(np.array_equal(got[:, :, 0], frame) and alive["j2k_inv_stage"] == 1,
          "the .90 decode after the fuzz campaign is not bit-exact")
    print(f"FUZZ alive: a .90 {H}x{W} frame decodes bit-exact after the "
          f"campaign, {alive['j2k_inv_stage']} j2k_inv_stage launch")
    return lc


def transcode_phase(workdir: str) -> dict:
    """The clinical CT (288² 12-bit) as .npy through j2k → htj2k → jls →
    npy, bit-exact, and the XR (512² crop, 8-bit) through baseline → npy
    within 64, on the card's device engine; every step's file equal to
    the same chain in this process on the CPU."""
    import io
    import os

    from go_dicom_codec_torch.tools import transcode

    z = np.load(CLINICAL)
    total = {}
    for key, crop, steps, tol in TRANSCODE_CHAINS:
        img = z[key] if crop is None else z[key][:crop, :crop]
        buf = io.BytesIO()
        np.save(buf, img)
        src = os.path.join(workdir, f"{key}.npy")
        with open(src, "wb") as f:
            f.write(buf.getvalue())
        cur = {"card": src, "cpu": src}
        for i, (target, extra) in enumerate(steps):
            for lane, dev_arg in (("card", TOOLS_DEVICE),
                                  ("cpu", ("--device", "cpu"))):
                nxt = os.path.join(workdir, f"{key}.{i}.{lane}.{target}")
                argv = (cur[lane], nxt, "--to", target, *extra, *dev_arg,
                        "--engine", "device")
                if lane == "card":
                    (rc, out), lc = counted(lambda: tool(transcode.main,
                                                         argv))
                    for k, v in lc.items():
                        total[k] = total.get(k, 0) + v
                    print(out.strip() + f" (card, launches "
                          f"{json.dumps({k: v for k, v in lc.items() if v})})")
                else:
                    rc, out = tool(transcode.main, argv)
                check(rc == 0, f"transcode {key} → {target} on {lane}")
                cur[lane] = nxt
            with open(cur["card"], "rb") as a, open(cur["cpu"], "rb") as b:
                check(a.read() == b.read(), f"transcode {key} → {target}: "
                      f"the card's file differs from the CPU's")
        with open(cur["card"], "rb") as f:
            back = np.load(io.BytesIO(f.read()))
        err = int(np.abs(back.astype(np.int64) - img).max())
        check(back.shape == img.shape and err <= tol,
              f"transcode {key}: off by {err}")
        print(f"TRANSCODE {key} {list(img.shape)} "
              f"{' → '.join(t for t, _ in steps)}: max |out - in| {err} "
              f"(≤ {tol}), every step equal to the CPU lane's bytes")
    check(all(total[k] > 0 for k in ("j2k_fwd_stage", "j2k_inv_stage",
                                     "jpeg_fdct_islow", "jpeg_idct_islow")),
          f"transcode launches {total}")
    return total


def interop_phase() -> None:
    """``python -m go_dicom_codec_torch.tools.interop --fixture clinical
    --parallel 2`` on cuda:0: all 18 rows pass, the five rows of .90, .92,
    .201 and .202 with their multi-frame lane."""
    import os
    import subprocess

    from go_dicom_codec_torch.tools.interop import FORMAT_DEFINITIONS

    multi = sum(row[1] in (U.JPEG_2000_LOSSLESS, U.JPEG_2000_MC_LOSSLESS,
                           U.HTJ2K_LOSSLESS, U.HTJ2K_LOSSLESS_RPCL)
                for row in FORMAT_DEFINITIONS)

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "go_dicom_codec_torch.tools.interop",
         "--fixture", "clinical", "--parallel", "2", *TOOLS_DEVICE],
        capture_output=True, text=True, cwd=root, env=env, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("INTEROP|")]
    print("\n".join(lines))
    passed = [ln for ln in lines if ln.startswith("INTEROP|pass|")]
    check(proc.returncode == 0 and len(passed) == 18 == len(lines) - 1
          and sum("mf=3frames-ok" in ln for ln in passed) == multi == 5
          and lines[-1] == "INTEROP|done|formats=18|failures=0",
          f"interop: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    print(f"INTEROP clinical, 2 workers on {TOOLS_DEVICE[1]}: 18/18 pass, "
          f"{multi} multi-frame lanes, {time.perf_counter() - t0:.1f} s")


def benchmarks_phase() -> dict:
    """The per-UID table at 512², 4 frames: the default 11 UIDs and the
    other three through ``make_registry(cuda:0)``, all 14 on the host
    engine; the pipeline row at 512², 8 frames; ``perf_check --emit-json``
    at 256² over the 14 UIDs (printed, no gate). Returns the launches."""
    from go_dicom_codec_torch.tools import benchmarks, perf_check

    base = ("--size", "512", "--frames", "4", "--repeats", "3",
            *TOOLS_DEVICE)
    runs = (("registry", base),
            ("registry", (*base, "--uids", ",".join(BENCH_EXTRA_UIDS))),
            ("host", (*base, "--engine", "host", "--uids",
                      ",".join(PORT_UIDS))),
            ("pipeline", ("--pipeline", "--size", "512", "--frames", "8",
                          *TOOLS_DEVICE)))
    total = {}
    for name, argv in runs:
        (rc, out), lc = counted(lambda: tool(benchmarks.main, argv))
        check(rc == 0, f"benchmarks {argv}: exit {rc}")
        bench = [ln for ln in out.splitlines() if ln.startswith("BENCH|")]
        print("\n".join(bench))
        for ln in bench:
            row = json.loads(ln.split("|", 1)[1])
            check(row.get("lossless_exact") is not False,
                  f"benchmarks: {row.get('name')} not exact")
        for k, v in lc.items():
            total[f"{name}_{k}"] = total.get(f"{name}_{k}", 0) + v
    check(all(v == 0 for k, v in total.items() if k.startswith("host_")),
          "the host engine's benchmark launched a kernel")
    rc, out = tool(perf_check.main, ("--emit-json", "--size", "256",
                                     *TOOLS_DEVICE))
    line = json.loads(out.strip().splitlines()[-1])
    check(rc == 0 and len(line["codecs"]) == 14, "perf_check --emit-json")
    print("PERF|" + json.dumps(line))
    return {k: v for k, v in total.items() if v}


def trace_phase(rng, dev, workdir: str) -> None:
    """``torch_trace`` around ``TRACE_XPLUS1`` torch ``x + 1`` launches,
    one registry .90 encode of 32 gray 512² frames and ``TRACE_XPLUS1``
    torch ``x * 3`` launches: a Chrome trace that names the forward
    stage's kernel. The count of its events is printed beside the
    launches, and beside the torch kernels' events before and after the
    encode, not held to them: torch.profiler drops some kernel events on
    the card's machine (PERF.md, C5)."""
    import glob
    import os

    frames = phantom(rng, B, 12)
    info, src = pixel_data(frames, 12, False)
    codec = gdc.make_registry(dev).get_codec(U.JPEG_2000_LOSSLESS)
    codec.encode(src, gdc.MemoryPixelData(info=info, encapsulated=True))
    log_dir = os.path.join(workdir, "trace")
    y = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    y.add_(1)
    y.mul_(3)
    _kernels.reset_launch_counts()
    with profiling.torch_trace(log_dir):
        for _ in range(TRACE_XPLUS1):
            y.add_(1)
        codec.encode(src, gdc.MemoryPixelData(info=info, encapsulated=True))
        for _ in range(TRACE_XPLUS1):
            y.mul_(3)
    launched = _kernels.launch_counts["j2k_fwd_stage"]
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"torch_trace wrote {files}")
    with open(files[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    stage = [n for n in names if "fwd_stage_kernel" in n]
    # torch's own kernels before the encode (add) and after it (mul)
    before = sum("elementwise" in n and "add" in n for n in names)
    after = sum("elementwise" in n and "Mul" in n for n in names)
    check(launched > 0 and 0 < len(stage) <= launched,
          f"the trace holds {len(stage)} forward stage kernels of "
          f"{launched} launches")
    print(f"TRACE {os.path.basename(files[0])}: {len(names)} kernel "
          f"events, {len(stage)} of them {stage[0][:60]!r}, of "
          f"{launched} j2k_fwd_stage launches in one registry .90 encode "
          f"of {B} frames; in the same trace {before} events of "
          f"{TRACE_XPLUS1} torch x + 1 launches before the encode and "
          f"{after} of {TRACE_XPLUS1} x * 3 after it")


def tools_phase(rng, dev) -> dict:
    """The port's tools on the card, each phase's launches counted from 0
    (interop's run in its own worker processes, uncounted)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="gdct_tools_")
    try:
        launches = {"fuzz": fuzz_phase(rng, dev),
                    "transcode": transcode_phase(workdir)}
        interop_phase()
        launches["benchmarks"] = benchmarks_phase()
        trace_phase(rng, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"tools phase {time.perf_counter() - t0:.1f} s")
    return launches


def run_port_bench(card: str) -> None:
    """The port bench's ``main()`` once at its full size; its JSON line
    goes out prefixed ``BENCH``."""
    import contextlib
    import io

    from go_dicom_codec_torch.tools import bench

    with contextlib.redirect_stdout(io.StringIO()):
        line = bench.main()
    check(line["gpu"] == card, "the bench names another card")
    print("BENCH " + json.dumps(line))


def main() -> int:
    card = device_bench.card_info()
    print(card)
    check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda", 0)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
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
    saturation(dev, qt)
    rgb = torch.as_tensor(rng.integers(0, 256, (RGB_FRAMES, 3, H, W))
                          .astype(np.uint8), device=dev)
    errs["j2k_fwd_stage"] = max(errs["j2k_fwd_stage"],
                                compare_stage(x.to(torch.uint16), rgb))
    errs["j2k_inv_stage"] = max(errs["j2k_inv_stage"], compare_inv_stage(
        fwd_stage_plain(x, 2048, LEVELS)))
    errs.update(compare_islow(dev))
    errs.update(compare_97(rng, dev))
    torch.cuda.synchronize()

    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    round_trip_gray(rng, dev)
    round_trip_rgb(rng, dev)
    long_lines(rng, dev)
    rows = device_bench.run_bench(B, H, W, seed=SEED, card=card)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    print(f"main path {time.perf_counter() - t0:.2f} s, launches {launches}")
    check(all(n > 0 for n in launches.values()), "a kernel never launched")
    for r in rows:
        print("BENCH|" + json.dumps(r))

    host_build.join()
    print(f"native host library ready after "
          f"{time.perf_counter() - t_native:.2f} s")
    # before the profiler-heavy phases, after which torch.profiler drops
    # more of the kernel events the device times are read from
    times = time_kernels(dev, np.random.default_rng(SEED), qt)
    # the 9/7 stages' own main path, counted from 0 call by call
    lossy = lossy_phase(rng, dev)
    for name in ("j2k97_fwd_stage", "j2k97_inv_stage"):
        launches[name] = lossy[name]
    codec_phase(rng, dev, card)
    families = families_phase(rng, dev, card)
    launches.update(jpeg_phase(rng, dev, card))
    mesh_launches = mesh_phase(rng, dev, card, cards)
    tools_launches = tools_phase(rng, dev)
    run_port_bench(card)
    ht = families["htj2k"][U.HTJ2K_LOSSLESS]
    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        tk = times[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": tk["ms"],
                        "device_ms": tk["device_ms"],
                        "device_ops": tk["device_ops"],
                        "host_ms": tk["host_ms"], "plain_ms": tk["plain_ms"],
                        "bound_ms": tk["bound_ms"],
                        "bound_by": tk["bound_by"], "library_ms": None})
        for extra in ("xplus1_ms", "xplus1_device_ms", "uint16_12bit",
                      "per_frame", "rgb", "long", "long_col",
                      "plain_device_ops", "b32", "b32_uint16_12bit",
                      "b32_int16", "rgb_stack"):
            if extra in tk:
                kernels[-1][extra] = tk[extra]
        if name in ("j2k_fwd_stage", "j2k_inv_stage"):
            kernels[-1]["htj2k_201_launches"] = {
                "encode": ht["encode"][name], "decode": ht["decode"][name],
                "frames": B}
        if name in MESH_STAGES:
            kernels[-1]["mesh_launches"] = {
                way: mesh_launches[way][name] for way in mesh_launches}
        kernels[-1]["tools_launches"] = {
            "fuzz": tools_launches["fuzz"][name],
            "transcode": tools_launches["transcode"][name],
            "benchmarks": {k[:-len(name) - 1]: v for k, v in
                           tools_launches["benchmarks"].items()
                           if k.endswith(name)}}
    check(not set(RETIRED) & set(_kernels.launch_counts),
          "a retired kernel is still counted")
    print("retired: " + ", ".join(f"{k} (replaced {v})" for k, v in
                                  RETIRED.items())
          + ": csrc/dwt53.cu is gone; every line length runs in the fused "
          "stages' tile pass (a 64² tile and its halo of 2 in shared memory "
          "whatever the line length), so no frame leaves j2k_fwd_stage and "
          "j2k_inv_stage")
    print(card)
    print(json.dumps({"kernels": kernels, "gpu": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
