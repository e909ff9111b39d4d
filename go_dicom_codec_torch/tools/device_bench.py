"""Device bench of the port: the J2K lossless transform, the fused DCT,
the JPEG codecs' islow DCT stages, the 9/7 lossy stages and the color
transforms.

Counterpart of part of ``go_dicom_codec_tpu/tools/device_bench.py`` and
of ``bench.py:47-98``. Rows:

  - ``dwt53_stats``: DC shift + 5-level 5/3 + fixed-point deadzone quant +
    64×64 code-block max/bitplane stats (the bench.py encode step);
  - ``idwt53``: dequant ×2 + inverse 5/3 + inverse DC shift + clip to
    16 bits (the bench.py decode step; its 5/3, unshift and clip are the
    inverse stage);
  - ``j2k_stage_narrow``: the pipelines' encode stage, 12-bit uint16
    frames → int16 coefficients and the max |coeff|;
  - ``j2k_stage_stats``: ``j2k_lossless_encode_transform``, int32 frames →
    coefficients and 64×64 code-block stats;
  - ``j2k_stage_narrow_rgb``: the RGB pipelines' encode stage, 8-bit uint8
    [B, 3, H, W] frames → DC shift and RCT (fused into the stage) → int16
    coefficients and the max |coeff|;
  - ``dct8x8_quant_pallas``: the fused 8×8 DCT + quant kernel, the port of
    the Pallas kernel;
  - ``dct8x8_quant_zigzag``: the JPEG codecs' forward stage, 12-bit uint16
    samples → islow DCT + quant + zigzag, int32 coefficients (the .51
    pipelined encode's chunk);
  - ``idct8x8_dequant``: its inverse, int32 zigzag coefficients → dequant +
    islow IDCT + shift + clamp, uint16 samples (the .51 decode);
  - ``j2k97_fwd_stage``: the lossy encode's device stage, 12-bit uint16
    frames → DC shift, float32 and 5-level 9/7 (one launch of the 9/7
    forward stage) → float32 coefficients;
  - ``j2k97_fwd_stage_rgb``: the same of 8-bit uint8 [B, 3, H, W] frames,
    the ICT fused into the stage;
  - ``j2k97_inv_stage``: the lossy decode's device stage, float32
    coefficients of 12-bit frames → inverse 9/7, round, unshift, clip →
    uint16 (one launch of the 9/7 inverse stage);
  - ``j2k97_inv_stage_rgb``: the same of 8-bit [B, 3, H, W] frames, the
    inverse ICT fused into the stage;
  - ``dwt97_deadzone_quant``: float32 samples → 5-level 9/7 → deadzone
    quant with one representative step (per-band slicing is a host-side
    gather; the arithmetic is the same), the lossy encode stage;
  - ``idwt97_dequant``: its inverse, dequant multiply → inverse 9/7;
  - ``rct_forward``: the reversible color transform of int32 (x, x+1, x+2);
  - ``ict_forward``: the irreversible one of float32 (x, x+1, x+2);
  - ``xplus1_ceiling``: ``x + 1``, the memory-bound ceiling of this shape.

The ``dwt97_deadzone_quant``, ``idwt97_dequant`` and color rows are the
reference's arithmetic (``go_dicom_codec_tpu/tools/device_bench.py``) in
plain torch only (the 9/7 through its plain lane); the two 9/7 stage rows
are their kernel lane's counterparts. Each other row runs in the kernel lane
(the hand-written kernels: one launch of the fused forward stage for every
forward 5/3, of the fused inverse stage for every inverse) and the plain
lane (the same step in plain torch), except the ceiling, which is plain
torch only; the two islow rows run one launch of their kernel of
csrc/jpeg_islow.cu in the kernel lane. Inputs are device-resident 12-bit
samples from ``numpy.random.default_rng(seed)``. A run is ``iters`` calls
back to back between two CUDA events; a row reports the median over
``RUNS`` runs after one warm-up run, as ms per call and Mpx/s, and beside
it the host time it took to issue one call in the same runs
(``host_ms``).

The command line then shows, in the same process, where the time goes
(``run_profile``): for every row and lane, and for the 5-level forward
and inverse alone (fused, plain), the device time per call (the kernel
time torch.profiler records over ``iters`` calls), the device operations
per call, its largest kernels and the device's idle share, 1 − device
time / event time; the narrow decode stage (int16 coefficients → uint16
pixels: the fused inverse stage and plain torch) of gray 12-bit and RGB
8-bit frames; the four 9/7 stage rows with their bound; the stage, decode
and 9/7 stage rows again at batches of
``DECODE_SMALL_BATCH`` (the decode pipeline's chunk) and
``STAGE_SMALL_BATCH`` (the encode pipeline's); the two islow rows with
their bound (``jpeg_profile``); then the inverse stage's head budgets
(``head_profile``: none, 64² and 128² samples at both batches, and at
each ``LONG_SHAPES`` frame the head with and without a bound on its
sides, ``HEAD|``); then the fused stages at ``LONG_SHAPES``, frames with
a 65535-sample side (``long_profile``): the 5-level forward and inverse
in place, the forward stage with the "coeffs" and "narrow" epilogues and
the narrow decode stage, and the 9/7 forward and narrow decode stages,
with the kernel launches of one call. Each stage and long line carries
its bound: the bytes it must move (input read once, outputs written
once) over the H100's 3.35 TB/s.

``--levels`` prints what each level adds (``LEVELS|``: the 5/3 and 9/7
stages at 0-5 levels), ``--long`` the long lines alone, ``--stage97`` the
9/7 stage rows alone at ``--batch`` and at the decode pipeline's chunk.

Usage:
    python -m go_dicom_codec_torch.tools.device_bench [--batch N]
        [--size WxH] [--iters N] [--levels] [--trace N] [--long]

Prints the card, one ``BENCH|`` JSON line per row and lane, one
``PROFILE|`` line per step, one ``HEAD|`` line per head budget and batch
(or long shape and head rule) and one ``LONG|`` line per long-line step
and lane. ``--levels`` and ``--trace`` print, instead, what each level of the
fused stages adds (``level_profile``, ``LEVELS|`` lines: the narrow
forward and decode stages of ``--batch`` gray frames at 0-5 levels), and
``N`` pairs of ``utils.profiling.torch_trace`` windows with the kernel
events each holds beside the launches (``trace_counts``, ``TRACE|``
lines). ``--long`` prints the ``LONG|`` lines alone; they call only
the 5/3 and stage functions every checkout of the port has, so this
file, put in another checkout, times that checkout's code. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.blockstats import codeblock_max_abs, max_bitplane
from ..ops.dct8x8 import LUMA_QUANT, scale_quant_table
from .. import _kernels
from ..ops.dwt53 import (fwd53_multilevel_, fwd53_multilevel_plain_,
                         inv53_multilevel_, inv53_multilevel_plain_)
from ..ops.dct8x8 import decode_zigzag_to_plane, encode_plane_to_zigzag
from ..ops.fdct8x8_quant import fdct8x8_quant, fdct8x8_quant_plain
from ..ops.jpeg_islow import fdct_islow, idct_islow
from ..ops import dwt53
from ..ops import j2k_inv_stage as istage
from ..ops.j2k_fwd_stage import fwd_stage, fwd_stage_plain
from ..codecs.j2k_quant import step_sizes_97
from ..ops.dwt97 import fwd97_multilevel_plain, inv97_multilevel_plain
from ..ops.j2k97_fwd_stage import fwd97_stage, fwd97_stage_plain
from ..ops.j2k97_inv_stage import inv97_stage, inv97_stage_plain
from ..ops.mct import dc_level_shift, ict_forward, rct_forward
from ..pipeline import _pipeline_device_stage_rgb

LEVELS = 5
RUNS = 5  # timed runs per measurement, after one warm-up run
STAGE_SMALL_BATCH = 4  # frames per chunk of the encode pipeline
DECODE_SMALL_BATCH = 8  # frames per chunk of the decode pipeline
HEAD_BUDGETS = (0, 64 * 64, 128 * 128)  # samples in the inverse stage's head
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
LANES = {"kernel": (fwd53_multilevel_, inv53_multilevel_, fdct8x8_quant),
         "plain": (fwd53_multilevel_plain_, inv53_multilevel_plain_,
                   fdct8x8_quant_plain)}
# frames with DICOM's longest side: along rows, along columns
LONG_SHAPES = ((2, 16, 65535), (2, 65535, 16))
JPEG_LEVEL = 2048  # the islow rows' 12-bit profile, as the reference's
# the 9/7 rows' one deadzone step: the first band's at quality 85, in
# 12-bit units, a float32 value as the reference's
STEP_97 = float(np.float32(step_sizes_97(LEVELS, 85)[0] * 4096))


def card_info() -> str:
    """``name, power.limit`` of GPU 0, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def dwt53_stats(x: torch.Tensor, lane: str = "kernel"):
    """One bench.py encode step: shift, 5/3, deadzone quant, stats.

    ``(mag * 32768) >> 16`` stays torch int32, wraparound included.
    """
    fwd = LANES[lane][0]
    c = fwd(dc_level_shift(x, 16, False), LEVELS)
    q = torch.sign(c) * ((c.abs() * 32768) >> 16)
    return q, max_bitplane(codeblock_max_abs(q, 64, 64))


def idwt53(q: torch.Tensor, lane: str = "kernel") -> torch.Tensor:
    """One bench.py decode step: dequant, then the inverse stage (inverse
    5/3, unshift, clip to 16 bits)."""
    stage = istage.inv_stage if lane == "kernel" else istage.inv_stage_plain
    return stage(q * 2, LEVELS, bits=16, epilogue="narrow")


def dwt97_deadzone_quant(x: torch.Tensor) -> torch.Tensor:
    """float32 [B, H, W] → 5-level 9/7 (the plain lane) → sign(c) ·
    floor(|c| / step)."""
    c = fwd97_multilevel_plain(x, LEVELS)
    return torch.sign(c) * torch.floor(c.abs() / STEP_97)


def idwt97_dequant(q: torch.Tensor) -> torch.Tensor:
    """Quantized float32 [B, H, W] → × step → 5-level inverse 9/7 (the
    plain lane)."""
    return inv97_multilevel_plain(q * STEP_97, LEVELS)


def rct_step(x: torch.Tensor):
    """The RCT of (x, x + 1, x + 2): (Y, U, V)."""
    return rct_forward(x, x + 1, x + 2)


def ict_step(x: torch.Tensor):
    """The ICT of float32 (x, x + 1, x + 2): (Y, Cb, Cr)."""
    return ict_forward(x, x + 1.0, x + 2.0)


def time_ms(fn, iters: int = 10) -> tuple:
    """Median over ``RUNS`` runs of ``iters`` calls of ``fn`` back to back,
    after one warm-up run: (CUDA-event ms per call, host ms to issue one
    call). The event time is the device's wall time; where the host time
    is as long, the host, not the device, sets the rate."""
    dev, host = [], []
    for r in range(RUNS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        t1 = time.perf_counter()
        end.synchronize()
        if r:
            dev.append(start.elapsed_time(end) / iters)
            host.append((t1 - t0) * 1e3 / iters)
    return statistics.median(dev), statistics.median(host)


def device_ms(fn, iters: int = 10, launches: int = 1) -> tuple:
    """Kernel time per call of ``fn`` on the device, from torch.profiler
    over ``iters`` calls after one warm-up call: (ms, the six largest
    kernels as [name, µs per call], device operations per call: kernels,
    copies and fills). Only device events count: a torch op on the host
    reports its kernels' time as its own as well. torch.profiler drops
    device events now and then, so a profile that holds fewer than
    ``launches`` device operations a call (the kernels ``fn`` is known to
    launch) is taken again, up to five times in all; then ms is None."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        ops = sum(e.count for e in events) / iters
        if ops >= launches:
            break
    us = sorted(((e.self_device_time_total / iters, e.key) for e in events),
                reverse=True)
    top = [[k[:72], t] for t, k in us[:6]]
    ms = sum(t for t, _ in us) / 1e3 if ops >= launches else None
    return ms, top, ops


def _inputs(batch: int, height: int, width: int, seed: int):
    if not torch.cuda.is_available():
        raise RuntimeError("device_bench needs a CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(0, 1 << 12, (batch, height, width),
                                     dtype=np.int32), device=dev)
    qt = torch.as_tensor(scale_quant_table(LUMA_QUANT, 90, 255),
                         dtype=torch.float32, device=dev)
    return x, qt


def _stage_steps(x: torch.Tensor) -> dict:
    """The three stage rows: {row: ({lane: step}, bound ms)}."""
    def lanes(a, epilogue, shift=2048, mct=False):
        return {"kernel": lambda: fwd_stage(a, shift, LEVELS,
                                            epilogue=epilogue, mct=mct),
                "plain": lambda: fwd_stage_plain(a, shift, LEVELS,
                                                 epilogue=epilogue, mct=mct)}
    cb = 64
    blocks = x.shape[0] * -(-x.shape[1] // cb) * -(-x.shape[2] // cb)
    rng = np.random.default_rng(x.shape[0])
    rgb = torch.as_tensor(rng.integers(0, 256, (x.shape[0], 3) + x.shape[1:])
                          .astype(np.uint8), device=x.device)
    # bytes: uint16 in, int16 out and one int32; int32 in and out and two
    # int32 a code-block; uint8 in, int16 out and one int32
    return {"j2k_stage_narrow": (lanes(x.to(torch.uint16), "narrow"),
                                 (x.numel() * 4 + 4) / HBM_BYTES_PER_S * 1e3),
            "j2k_stage_stats": (lanes(x, "stats"),
                                (x.numel() * 8 + blocks * 8)
                                / HBM_BYTES_PER_S * 1e3),
            "j2k_stage_narrow_rgb": (lanes(rgb, "narrow", 128, True),
                                     (rgb.numel() * 3 + 4)
                                     / HBM_BYTES_PER_S * 1e3)}


def _decode_steps(x: torch.Tensor) -> dict:
    """The narrow decode stage rows of gray 12-bit frames and RGB 8-bit
    frames: {row: ({lane: step}, bound ms)}. The input is each frame's int16
    coefficients from the forward stage; the bound: int16 read and uint16
    written once."""
    rng = np.random.default_rng(x.shape[0])
    rgb = torch.as_tensor(rng.integers(0, 256, (x.shape[0], 3) + x.shape[1:],
                                       dtype=np.int32), device=x.device)
    inputs = {"gray": (fwd_stage(x.to(torch.uint16), 2048, LEVELS,
                                 epilogue="narrow")[0][:, None], 12, False),
              "rgb": (_pipeline_device_stage_rgb(rgb, 8, LEVELS, True)[0], 8,
                      True)}
    rows = {}
    for name, (pk, bits, mct) in inputs.items():
        def lanes(pk=pk, bits=bits, mct=mct):
            args = (LEVELS, 0, 0, bits, False, mct, "narrow")
            return {"kernel": lambda: istage.inv_stage(pk, *args),
                    "plain": lambda: istage.inv_stage_plain(pk, *args)}
        rows[f"j2k_decode_narrow_{name}"] = (
            lanes(), pk.numel() * 4 / HBM_BYTES_PER_S * 1e3)
    return rows


def _quantized97(c: torch.Tensor) -> torch.Tensor:
    """9/7 coefficients quantized and dequantized with ``STEP_97``: the
    decode stage's input in the bench rows."""
    return torch.sign(c) * torch.floor(c.abs() / STEP_97) * STEP_97


def _stage97_steps(x: torch.Tensor) -> dict:
    """The 9/7 stage rows of gray 12-bit frames and RGB 8-bit frames (as
    many as x holds), forward and decode: {row: ({lane: step}, bound
    ms)}. The decode's input is the forward's coefficients, quantized and
    dequantized with ``STEP_97``. Bound: uint16 (gray) or uint8 (RGB) in
    and float32 out once; float32 in and uint16 out once."""
    rng = np.random.default_rng(x.shape[0])
    rgb = torch.as_tensor(rng.integers(0, 256, (x.shape[0], 3) + x.shape[1:])
                          .astype(np.uint8), device=x.device)
    rows = {}
    for name, a, bits, mct in (("", x.to(torch.uint16)[:, None], 12, False),
                               ("_rgb", rgb, 8, True)):
        def lanes(a=a, bits=bits, mct=mct):
            shift = 1 << (bits - 1)
            f = _quantized97(fwd97_stage(a, shift, LEVELS, mct=mct))
            dec = (LEVELS, 0, 0, bits, False, mct, "narrow")
            return ({"kernel": lambda: fwd97_stage(a, shift, LEVELS,
                                                   mct=mct),
                     "plain": lambda: fwd97_stage_plain(a, shift, LEVELS,
                                                        mct=mct)},
                    {"kernel": lambda: inv97_stage(f, *dec),
                     "plain": lambda: inv97_stage_plain(f, *dec)})
        fwd, inv = lanes()
        n = a.numel()
        rows[f"j2k97_fwd_stage{name}"] = (
            fwd, n * (a.element_size() + 4) / HBM_BYTES_PER_S * 1e3)
        rows[f"j2k97_inv_stage{name}"] = (inv, n * 6 / HBM_BYTES_PER_S * 1e3)
    return rows


def _jpeg_steps(x: torch.Tensor) -> dict:
    """The islow rows: {row: ({lane: step}, bound ms)}, the forward of
    12-bit uint16 samples to int32 coefficients, its inverse back to
    uint16 from int32 coefficients and from int16 ones (the decode
    pipeline's upload). Bound: the samples and the coefficients, each
    read or written once."""
    x16 = x.to(torch.uint16)
    q = scale_quant_table(LUMA_QUANT, 90, 255)
    zz = fdct_islow(x16, q, JPEG_LEVEL)
    zz16 = zz.to(torch.int16)
    n = x.numel()
    return {
        "dct8x8_quant_zigzag": ({
            "kernel": lambda: fdct_islow(x16, q, JPEG_LEVEL),
            "plain": lambda: encode_plane_to_zigzag(x16, q, JPEG_LEVEL)},
            n * 6 / HBM_BYTES_PER_S * 1e3),
        "idct8x8_dequant": ({
            "kernel": lambda: idct_islow(zz, q, JPEG_LEVEL, 4095,
                                         torch.uint16),
            "plain": lambda: decode_zigzag_to_plane(
                zz, q, JPEG_LEVEL, 4095).to(torch.uint16)},
            n * 6 / HBM_BYTES_PER_S * 1e3),
        "idct8x8_dequant_int16": ({
            "kernel": lambda: idct_islow(zz16, q, JPEG_LEVEL, 4095,
                                         torch.uint16),
            "plain": lambda: decode_zigzag_to_plane(
                zz16, q, JPEG_LEVEL, 4095).to(torch.uint16)},
            n * 4 / HBM_BYTES_PER_S * 1e3)}


# the islow kernels' rows at the main paths' shapes (``islow_profile``):
# (row, profile bits, coefficient dtype of the inverse)
ISLOW_ROWS = (("fdct_u8", 8, None), ("fdct_u16_12bit", 12, None),
              ("idct_int32_u8", 8, torch.int32),
              ("idct_int16_u8", 8, torch.int16),
              ("idct_int16_u16_12bit", 12, torch.int16),
              ("idct_int32_u16_12bit", 12, torch.int32))


def _islow_steps(frames: int, size: int, seed: int) -> dict:
    """{row: (kernel step, bound ms)} of ``ISLOW_ROWS`` on ``frames``
    frames of size² samples, plus the RGB decode chunk's one launch over
    luma and chroma (``idct_rgb_stack_u8``: 3 planes a frame, a table
    index a plane) where this checkout's ``idct_islow`` takes a table
    index. Calls only ``fdct_islow`` and ``idct_islow``, so this file, put
    in an earlier checkout, times that checkout's kernels (whose inverse
    reads int32: an int16 row there includes the cast). Bound: each input
    and output byte moved once over 3.35 TB/s."""
    import inspect

    from ..codecs.jpeg_common import CHROMA_QUANT

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    q = scale_quant_table(LUMA_QUANT, 90, 255)
    rows = {}
    for name, bits, coef in ISLOW_ROWS:
        dt = torch.uint8 if bits == 8 else torch.uint16
        x = torch.as_tensor(rng.integers(0, 1 << bits, (frames, size, size)),
                            device=dev).to(dt)
        level, top = 1 << (bits - 1), (1 << bits) - 1
        n = x.numel()
        if coef is None:
            rows[name] = (lambda x=x, level=level: fdct_islow(x, q, level),
                          n * (x.element_size() + 4) / HBM_BYTES_PER_S * 1e3)
            continue
        zz = fdct_islow(x, q, level).to(coef)
        rows[name] = (lambda zz=zz, level=level, top=top, dt=dt:
                      idct_islow(zz, q, level, top, dt),
                      n * (zz.element_size() + x.element_size())
                      / HBM_BYTES_PER_S * 1e3)
    if "table_index" in inspect.signature(idct_islow).parameters:
        tables = np.stack([q, scale_quant_table(CHROMA_QUANT, 90, 255)])
        x = torch.as_tensor(rng.integers(0, 256, (3 * frames, size, size)),
                            device=dev).to(torch.uint8)
        zz = fdct_islow(x, q, 128).to(torch.int16)
        index = (0, 1, 1) * frames
        rows["idct_rgb_stack_u8"] = (
            lambda: idct_islow(zz, tables, 128, 255, torch.uint8,
                               table_index=index),
            x.numel() * 3 / HBM_BYTES_PER_S * 1e3)
    return rows


def islow_profile(batches=(32, DECODE_SMALL_BATCH, 1), size: int = 512,
                  iters: int = 10, seed: int = 0, card: str = "") -> list:
    """``ISLOW|`` lines: every ``_islow_steps`` row at each batch, with its
    event, host and device ms, device operations and bound."""
    card = card or card_info()
    return [_line(fn, iters, card, step=name, batch=batch, bound_ms=bound)
            for batch in batches
            for name, (fn, bound) in _islow_steps(batch, size, seed).items()]


def sass_counts(lib: str) -> list:
    """``SASS|`` lines: for every islow kernel instance in the shared
    library ``lib``, its SASS instructions, the MUFU.RCP and CALL among
    them (an integer division's reciprocal estimate or subroutine), and
    its registers (``cuobjdump -res-usage``). A warp runs a kernel's code
    once for its four 8×8 blocks (once a plane it walks), so instructions
    / 4 is its count a block."""
    import re

    cuobjdump = str(Path(_kernels._find_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    res = subprocess.run([cuobjdump, "-res-usage", lib], capture_output=True,
                         text=True, check=True).stdout
    regs = dict(re.findall(r"Function (\S+):\s*\n?\s*REG:(\d+)", res))
    lines = []
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        if "jpeg_" not in name:
            continue
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);", block)
        lines.append({"kernel": name, "instructions": len(ins),
                      "per_block": len(ins) / 4,
                      "mufu_rcp": sum("MUFU.RCP" in i for i in ins),
                      "calls": sum(i.split()[0].startswith("CALL")
                                   for i in ins if i.split()),
                      "registers": int(regs.get(name, -1)), "lib": lib})
    return lines


def _steps(x: torch.Tensor, qt: torch.Tensor) -> dict:
    """The bench.py rows in each lane: {row: {lane: step}}."""
    q = dwt53_stats(x)[0]
    return {"dwt53_stats": {lane: (lambda lane=lane: dwt53_stats(x, lane))
                            for lane in LANES},
            "idwt53": {lane: (lambda lane=lane: idwt53(q, lane))
                       for lane in LANES},
            "dct8x8_quant_pallas": {
                lane: (lambda lane=lane: LANES[lane][2](x, qt, 2048))
                for lane in LANES}}


def _plain_steps(x: torch.Tensor) -> dict:
    """The 9/7 and color rows, plain torch only: {row: {"plain": step}}."""
    xf = x.to(torch.float32)
    q = dwt97_deadzone_quant(xf)
    return {"dwt97_deadzone_quant": {"plain": lambda: dwt97_deadzone_quant(
                xf)},
            "idwt97_dequant": {"plain": lambda: idwt97_dequant(q)},
            "rct_forward": {"plain": lambda: rct_step(x)},
            "ict_forward": {"plain": lambda: ict_step(xf)}}


def run_bench(batch: int = 32, height: int = 512, width: int = 512,
              iters: int = 10, seed: int = 0, card: str = "") -> list:
    """Measure every row and lane on CUDA device 0; returns the rows."""
    x, qt = _inputs(batch, height, width, seed)
    card = card or card_info()
    px = batch * height * width
    rows = []

    def row(name, lane, fn):
        ms, host = time_ms(fn, iters)
        rows.append({"row": name, "lane": lane, "ms": ms,
                     "mpx_per_s": px / ms / 1e3, "host_ms": host,
                     "batch": batch, "size": f"{width}x{height}",
                     "runs": RUNS, "iters": iters, "gpu": card})

    stages = {name: lanes for name, (lanes, _) in
              {**_stage_steps(x), **_stage97_steps(x),
               **_jpeg_steps(x)}.items()}
    for name, lanes in {**_steps(x, qt), **stages,
                        **_plain_steps(x)}.items():
        for lane, fn in lanes.items():  # the lanes of a row run back to back
            row(name, lane, fn)
    row("xplus1_ceiling", "plain", lambda: x + 1)
    return rows


def _line(fn, iters: int, card: str, **key) -> dict:
    """One profile line of ``fn``: event and host time from ``time_ms``,
    device time, device operations and largest kernels from
    ``device_ms``, unprofiled runs first."""
    ms, host = time_ms(fn, iters)
    dev, top, ops = device_ms(fn, iters)
    return {**key, "event_ms": ms, "host_ms": host, "device_ms": dev,
            "idle_share": None if dev is None else 1 - dev / ms,
            "device_ops_per_call": ops,
            "top_kernels_us": top, "gpu": card}


def stage_profile(batch: int, height: int = 512, width: int = 512,
                  iters: int = 10, seed: int = 0, card: str = "") -> list:
    """Profile lines of the two stage rows in every lane, with bounds."""
    x, _ = _inputs(batch, height, width, seed)
    card = card or card_info()
    return [_line(fn, iters, card, step=f"{name}/{lane}", batch=batch,
                  bound_ms=bound)
            for name, (lanes, bound) in _stage_steps(x).items()
            for lane, fn in lanes.items()]


def decode_profile(batch: int, height: int = 512, width: int = 512,
                   iters: int = 10, seed: int = 0, card: str = "") -> list:
    """Profile lines of the narrow decode stage rows in every lane, with
    bounds."""
    x, _ = _inputs(batch, height, width, seed)
    card = card or card_info()
    return [_line(fn, iters, card, step=f"{name}/{lane}", batch=batch,
                  bound_ms=bound)
            for name, (lanes, bound) in _decode_steps(x).items()
            for lane, fn in lanes.items()]


def stage97_profile(batch: int, height: int = 512, width: int = 512,
                    iters: int = 10, seed: int = 0, card: str = "") -> list:
    """Profile lines of the 9/7 stage rows in both lanes, with bounds; the
    kernel lane checked against the plain lane first."""
    x, _ = _inputs(batch, height, width, seed)
    card = card or card_info()
    lines = []
    for name, (lanes, bound) in _stage97_steps(x).items():
        got, want = lanes["kernel"](), lanes["plain"]()
        if got.is_floating_point():  # bit for bit: -0.0 is not 0.0
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: the stage differs from its plain "
                               f"version")
        lines += [_line(fn, iters, card, step=f"{name}/{lane}",
                        batch=batch, bound_ms=bound)
                  for lane, fn in lanes.items()]
    return lines


def jpeg_profile(batch: int, height: int = 512, width: int = 512,
                 iters: int = 10, seed: int = 0, card: str = "") -> list:
    """Profile lines of the two islow rows in both lanes, with bounds."""
    x, _ = _inputs(batch, height, width, seed)
    card = card or card_info()
    return [_line(fn, iters, card, step=f"{name}/{lane}", batch=batch,
                  bound_ms=bound)
            for name, (lanes, bound) in _jpeg_steps(x).items()
            for lane, fn in lanes.items()]


def _long_frames(shape, seed: int) -> tuple:
    """A ``LONG_SHAPES`` frame's 12-bit samples as uint16 and its narrow
    coefficients (int16, [B, 1, H, W]) on CUDA device 0."""
    dev = torch.device("cuda", 0)
    x16 = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 1 << 12, shape).astype(np.uint16), device=dev)
    return x16, fwd_stage(x16, 2048, LEVELS, epilogue="narrow")[0][:, None]


def head_profile(batches=(DECODE_SMALL_BATCH, 32), height: int = 512,
                 width: int = 512, iters: int = 10, seed: int = 0,
                 card: str = "") -> list:
    """The inverse stage's head: the narrow decode stage of gray frames
    launched with the schedule of each of ``HEAD_BUDGETS`` at each batch,
    then of each ``LONG_SHAPES`` frame with the head of 64² samples and
    sides unbounded or bounded (``_HEAD_SIDE``); each checked against the
    plain version. One line per schedule with its head's extent, grid
    levels and shared memory a block."""
    card = card or card_info()
    cases = []
    for batch in batches:
        x, _ = _inputs(batch, height, width, seed)
        pk = fwd_stage(x.to(torch.uint16), 2048, LEVELS,
                       epilogue="narrow")[0]
        cases += [(pk, {"batch": batch, "head_samples": budget},
                   dwt53._inv_schedule(width, height, LEVELS, 0, 0, budget))
                  for budget in HEAD_BUDGETS]
    for shape in LONG_SHAPES:
        pk = _long_frames(shape, seed)[1][:, 0]
        cases += [(pk, {"shape": list(shape), "head_samples": 64 * 64,
                        "head_side": side},
                   dwt53._inv_schedule(shape[2], shape[1], LEVELS, 0, 0,
                                       64 * 64, side))
                  for side in (None, dwt53._HEAD_SIDE)]
    lines = []
    for pk, key, sched in cases:
        want = istage.inv_stage_plain(pk, LEVELS, bits=12, epilogue="narrow")
        out = torch.empty(pk.shape, dtype=torch.uint16, device=pk.device)

        def step(sched=sched, out=out, pk=pk):
            _kernels.j2k_inv_stage(pk, out, sched, 1, "narrow", False, 12,
                                   False)
        step()
        if not torch.equal(out, want):
            raise RuntimeError(f"head {key}: the stage differs from its "
                               f"plain version")
        head = [r[1:3] for r in sched[2] if r[0] == dwt53.ROW_KINDS["block"]]
        extent = max(head, default=(0, 0))
        lines.append(_line(
            step, iters, card, step="inv_stage_head", **key,
            head=f"{extent[0]}x{extent[1]}",
            grid_levels=len(sched[2]) - len(head),
            smem_bytes=_kernels.stage_smem_bytes(sched[0], False),
            bound_ms=pk.numel() * 4 / HBM_BYTES_PER_S * 1e3))
    return lines


def run_profile(batch: int = 32, height: int = 512, width: int = 512,
                iters: int = 10, seed: int = 0, card: str = "") -> list:
    """Where the time goes, on CUDA device 0: the step lines.

    Every time of a line comes from this one call.
    """
    x, qt = _inputs(batch, height, width, seed)
    card = card or card_info()
    buf = x - 2048
    fns = {f"{name}/{lane}": fn for name, lanes in _steps(x, qt).items()
           for lane, fn in lanes.items()}
    for lane, (fwd, inv, _) in LANES.items():
        fns[f"fwd53_{LEVELS}lv/{lane}"] = lambda fwd=fwd: fwd(buf, LEVELS)
        fns[f"inv53_{LEVELS}lv/{lane}"] = lambda inv=inv: inv(buf, LEVELS)
    fns["xplus1/plain"] = lambda: x + 1

    steps = [_line(fn, iters, card, step=name, batch=batch)
             for name, fn in fns.items()]
    steps += stage_profile(batch, height, width, iters, seed, card)
    steps += decode_profile(batch, height, width, iters, seed, card)
    steps += stage97_profile(batch, height, width, iters, seed, card)
    steps += jpeg_profile(batch, height, width, iters, seed, card)
    return steps


def _launches(fn) -> int:
    """The kernel launches of one call of fn."""
    before = sum(_kernels.launch_counts.values())
    fn()
    return sum(_kernels.launch_counts.values()) - before


def long_steps(seed: int = 0) -> list:
    """The fused stages at each ``LONG_SHAPES`` frame, 5 levels: the
    forward and inverse 5/3 in place on an int32 buffer (a copy and a
    launch each), the forward stage of the int32 samples with the
    "coeffs" epilogue and of uint16 ones with "narrow", and the narrow
    decode stage of its int16 coefficients; the 9/7 forward stage of the
    uint16 samples and the 9/7 narrow decode stage of its coefficients,
    quantized with ``STEP_97``; each in the kernel and plain lanes. Each
    step is a dict of its ``name``, ``shape``, the bytes its bound moves
    (``bytes``: int32 in and out, 8 a sample; narrow, 4; the 9/7 stages,
    float32 on one side and uint16 on the other, 6) and its ``kernel``
    and ``plain`` calls."""
    steps = []
    for shape in LONG_SHAPES:
        x16, pk = _long_frames(shape, seed)
        x = x16.to(torch.int32)
        buf = x - 2048
        n = x.numel()
        dec = (LEVELS, 0, 0, 12, False, False, "narrow")
        g16 = x16[:, None]
        f = _quantized97(fwd97_stage(g16, 2048, LEVELS))
        for name, nbytes, kernel, plain in (
                (f"fwd53_{LEVELS}lv_long", 8 * n,
                 lambda b=buf: fwd53_multilevel_(b, LEVELS),
                 lambda b=buf: fwd53_multilevel_plain_(b, LEVELS)),
                (f"inv53_{LEVELS}lv_long", 8 * n,
                 lambda b=buf: inv53_multilevel_(b, LEVELS),
                 lambda b=buf: inv53_multilevel_plain_(b, LEVELS)),
                ("j2k_stage_coeffs_long", 8 * n,
                 lambda a=x: fwd_stage(a, 2048, LEVELS),
                 lambda a=x: fwd_stage_plain(a, 2048, LEVELS)),
                ("j2k_stage_narrow_long", 4 * n + 4,
                 lambda a=x16: fwd_stage(a, 2048, LEVELS, epilogue="narrow"),
                 lambda a=x16: fwd_stage_plain(a, 2048, LEVELS,
                                               epilogue="narrow")),
                ("j2k_decode_narrow_long", 4 * n,
                 lambda p=pk: istage.inv_stage(p, *dec),
                 lambda p=pk: istage.inv_stage_plain(p, *dec)),
                ("j2k97_fwd_stage_long", 6 * n,
                 lambda a=g16: fwd97_stage(a, 2048, LEVELS),
                 lambda a=g16: fwd97_stage_plain(a, 2048, LEVELS)),
                ("j2k97_inv_stage_long", 6 * n,
                 lambda c=f: inv97_stage(c, *dec),
                 lambda c=f: inv97_stage_plain(c, *dec))):
            steps.append({"name": name, "shape": list(shape),
                          "bytes": nbytes, "kernel": kernel, "plain": plain})
    return steps


def long_profile(iters: int = 10, seed: int = 0, card: str = "") -> list:
    """Profile lines of ``long_steps``: each step in the kernel and plain
    lanes, with its bound and kernel launches a call; the stage rows'
    kernel lane checked against the plain lane first."""
    card = card or card_info()
    lines = []
    for s in long_steps(seed):
        if not s["name"].endswith("lv_long"):
            got, want = s["kernel"](), s["plain"]()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{s['name']} {s['shape']}: the stage "
                                   f"differs from its plain version")
        for lane in ("kernel", "plain"):
            lines.append(_line(
                s[lane], iters, card, step=f"{s['name']}/{lane}",
                shape=s["shape"], launches=_launches(s[lane]),
                bound_ms=s["bytes"] / HBM_BYTES_PER_S * 1e3))
    return lines


def level_profile(batch: int = 32, height: int = 512, width: int = 512,
                  iters: int = 10, seed: int = 0, card: str = "") -> list:
    """What each level adds: the device ms of the fused narrow forward
    stage of ``batch`` gray 12-bit frames, and of the narrow decode stage
    of its coefficients, then the same of the 9/7 forward stage of those
    frames as uint16 and of the 9/7 narrow decode stage of its quantized
    coefficients, at 0 to ``LEVELS`` levels; one line a count."""
    x, _ = _inputs(batch, height, width, seed)
    x16 = x.to(torch.uint16)
    g16 = x16[:, None]
    card = card or card_info()
    lines = []
    for levels in range(LEVELS + 1):
        pk = fwd_stage(x16, 2048, levels, epilogue="narrow")[0]
        f = _quantized97(fwd97_stage(g16, 2048, levels))
        lines.append({
            "levels": levels, "batch": batch,
            "fwd_device_ms": device_ms(lambda: fwd_stage(
                x16, 2048, levels, epilogue="narrow"), iters)[0],
            "inv_device_ms": device_ms(lambda: istage.inv_stage(
                pk, levels, bits=12, epilogue="narrow"), iters)[0],
            "fwd97_device_ms": device_ms(lambda: fwd97_stage(
                g16, 2048, levels), iters)[0],
            "inv97_device_ms": device_ms(lambda: inv97_stage(
                f, levels, bits=12, epilogue="narrow"), iters)[0],
            "gpu": card})
    return lines


def _kernel_events(log_dir: str) -> list:
    """The names of the kernel events of the one Chrome trace in log_dir."""
    import glob
    import os

    path, = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def trace_counts(frames: int = 32, size: int = 512, seed: int = 1) -> dict:
    """Two ``utils.profiling.torch_trace`` windows and the kernel events
    each holds beside the launches (does the profiler drop events?):

    - ``encode``: one registry .90 encode of ``frames`` gray size² 12-bit
      frames, the forward stage's events beside its launches;
    - ``mixed``: eight rounds of one narrow forward stage launch of
      ``STAGE_SMALL_BATCH`` frames (through ctypes) and one torch
      ``x + 1`` on one side stream, 40 ms of host time between rounds (as
      the host's entropy coding leaves between chunks): the events of
      each kind.
    """
    import tempfile

    import go_dicom_codec_torch as gdc
    from ..utils import profiling

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    info = gdc.FrameInfo(width=size, height=size, bits_allocated=16,
                         bits_stored=12)
    src = gdc.MemoryPixelData(info=info)
    for f in rng.integers(0, 1 << 12, (frames, size, size)):
        src.add_frame(f.astype("<u2").tobytes())
    codec = gdc.make_registry(dev).get_codec(gdc.uids.JPEG_2000_LOSSLESS)
    codec.encode(src, gdc.MemoryPixelData(info=info, encapsulated=True))
    out = {}
    with tempfile.TemporaryDirectory() as log_dir:
        before = _kernels.launch_counts["j2k_fwd_stage"]
        with profiling.torch_trace(log_dir):
            codec.encode(src, gdc.MemoryPixelData(info=info,
                                                  encapsulated=True))
        names = _kernel_events(log_dir)
        out["encode"] = {
            "fwd_stage_kernel_events": sum("fwd_stage_kernel" in k
                                           for k in names),
            "j2k_fwd_stage_launches":
                _kernels.launch_counts["j2k_fwd_stage"] - before,
            "other_kernel_events": sum("fwd_stage_kernel" not in k
                                       for k in names)}
    x = torch.as_tensor(rng.integers(0, 1 << 12, (STAGE_SMALL_BATCH, size,
                                                  size)).astype(np.uint16),
                        device=dev)
    y = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)

    def round_():
        with torch.cuda.stream(side):
            fwd_stage(x, 2048, LEVELS, epilogue="narrow")
            y.add_(1)
    round_()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.torch_trace(log_dir):
            for _ in range(8):
                round_()
                time.sleep(0.04)
        names = _kernel_events(log_dir)
        out["mixed"] = {
            "fwd_stage_kernel_events": sum("fwd_stage_kernel" in k
                                           for k in names),
            "xplus1_events": sum("elementwise" in k for k in names),
            "rounds": 8}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=str, default="512x512")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--levels", action="store_true",
                    help="only the LEVELS| lines")
    ap.add_argument("--trace", type=int, default=0,
                    help="only N pairs of TRACE| windows")
    ap.add_argument("--long", action="store_true",
                    help="only the LONG| lines")
    ap.add_argument("--islow", action="store_true",
                    help="only the ISLOW| lines: the islow kernels at "
                         "--batch, the decode pipeline's chunk and one "
                         "frame")
    ap.add_argument("--sass", nargs="?", const=str(_kernels.LIB_PATH),
                    help="only the SASS| lines of the islow kernels in a "
                         "built library (default: this checkout's)")
    ap.add_argument("--stage97", action="store_true",
                    help="only the 9/7 stage rows' PROFILE| lines, at "
                         "--batch and at the decode pipeline's chunk")
    opts = ap.parse_args(argv)
    w, h = (int(v) for v in opts.size.split("x"))
    card = card_info()
    print(card)
    if opts.sass:
        for r in sass_counts(opts.sass):
            print("SASS|" + json.dumps(r), flush=True)
        return 0
    if opts.islow:
        for r in islow_profile((opts.batch, DECODE_SMALL_BATCH, 1), w,
                               opts.iters, card=card):
            print("ISLOW|" + json.dumps(r), flush=True)
        return 0
    if opts.stage97:
        for batch in (opts.batch, DECODE_SMALL_BATCH):
            for r in stage97_profile(batch, h, w, opts.iters, card=card):
                print("PROFILE|" + json.dumps(r), flush=True)
        return 0
    if opts.long:
        for r in long_profile(opts.iters, card=card):
            print("LONG|" + json.dumps(r), flush=True)
        return 0
    if opts.levels or opts.trace:
        if opts.levels:
            for r in level_profile(opts.batch, h, w, opts.iters, card=card):
                print("LEVELS|" + json.dumps(r), flush=True)
        for _ in range(opts.trace):
            print("TRACE|" + json.dumps({**trace_counts(opts.batch, w),
                                         "gpu": card}), flush=True)
        return 0
    for r in run_bench(opts.batch, h, w, opts.iters, card=card):
        print("BENCH|" + json.dumps(r))
    steps = run_profile(opts.batch, h, w, opts.iters, card=card)
    for small in (DECODE_SMALL_BATCH, STAGE_SMALL_BATCH):
        steps += stage_profile(small, h, w, opts.iters, card=card)
        steps += decode_profile(small, h, w, opts.iters, card=card)
    steps += stage97_profile(DECODE_SMALL_BATCH, h, w, opts.iters,
                             card=card)
    for r in steps:
        print("PROFILE|" + json.dumps(r))
    for r in head_profile((DECODE_SMALL_BATCH, opts.batch), h, w, opts.iters,
                          card=card):
        print("HEAD|" + json.dumps(r))
    for r in long_profile(opts.iters, card=card):
        print("LONG|" + json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
