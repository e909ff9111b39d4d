"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` into one shared library with a
plain C interface at first use (never at import) and bound with
``ctypes``. Every C entry returns ``cudaGetLastError()`` after its launch;
a non-zero code raises here. Kernels run on PyTorch's current stream and
allocate nothing: the callers pass outputs they allocated.

``launch_counts`` holds one plain integer per kernel, raised by one at
each launch, so that a run can show which kernels it went through.

A wrapper that refuses a launch raises ``KernelLaunchError``, never
``ValueError``: the codecs fall back to their scalar path on a
``ValueError`` of the pipelines, and a kernel that cannot run must not
send the work to the host unnoticed.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "libgdct_torch.so"

# No --use_fast_math: the DCT's IEEE divide and rounding must stay exact.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Shared memory one block may use on Hopper (227 KB).
SMEM_MAX_BYTES = 232448

launch_counts = {"fdct8x8_quant": 0, "dwt53_fwd_pass": 0,
                 "dwt53_inv_pass": 0}

_lib = None


class KernelLaunchError(RuntimeError):
    """A kernel wrapper refused its arguments and launched nothing."""


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(force: bool = False) -> dict:
    """Compile ``csrc/*.cu`` into ``LIB_PATH`` unless it is newer than
    every source. Returns {"path", "seconds", "built", "log"}."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    newest = max(p.stat().st_mtime for p in sources + headers)
    if (not force and LIB_PATH.is_file()
            and LIB_PATH.stat().st_mtime >= newest):
        return {"path": str(LIB_PATH), "seconds": 0.0, "built": False,
                "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return {"path": str(LIB_PATH), "seconds": seconds, "built": True,
            "log": proc.stdout + proc.stderr}


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.gdct_dwt53_fwd_pass.argtypes = [p, ll, ll, i, ll, i, ll, i, i, p]
    lib.gdct_dwt53_inv_pass.argtypes = [p, ll, ll, i, ll, i, ll, i, i, p]
    lib.gdct_fdct8x8_quant.argtypes = [p, p, p, p, ll, i, i, f, p]
    for fn in (lib.gdct_dwt53_fwd_pass, lib.gdct_dwt53_inv_pass,
               lib.gdct_fdct8x8_quant):
        fn.restype = ctypes.c_int
    lib.gdct_error_string.argtypes = [ctypes.c_int]
    lib.gdct_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.gdct_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _require(x: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if x.device.type != "cuda":
        raise KernelLaunchError(f"{name}: expected a CUDA tensor, got "
                                f"{x.device}")
    if x.dtype != dtype:
        raise KernelLaunchError(f"{name}: expected {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise KernelLaunchError(f"{name}: expected a contiguous tensor")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def dwt53_smem_bytes(lines_per_block: int, line_len: int) -> int:
    """Shared memory of one lifting block: its lines at the odd pitch of
    csrc/dwt53.cu (``line_pitch``)."""
    return lines_per_block * (line_len | 1) * 4


def dwt53_pass(x: torch.Tensor, n_lines: int, line_stride: int,
               line_len: int, elem_stride: int, lines_per_block: int,
               even: bool, inverse: bool) -> None:
    """One in-place 1D 5/3 lifting pass over ``n_lines`` lines of every
    [H, W] plane of the contiguous int32 tensor ``x`` [B, H, W].

    Line j's sample i sits at ``j * line_stride + i * elem_stride`` from
    the plane's origin. ``lines_per_block`` lines share one block's
    shared memory; the caller keeps ``dwt53_smem_bytes`` of them within
    ``SMEM_MAX_BYTES``.
    """
    if dwt53_smem_bytes(lines_per_block, line_len) > SMEM_MAX_BYTES:
        raise KernelLaunchError(f"dwt53_pass: {lines_per_block} lines of "
                                f"{line_len} samples exceed "
                                f"{SMEM_MAX_BYTES} bytes of shared memory")
    _require(x, torch.int32, "dwt53_pass")
    nb = x.shape[0]
    if nb == 0 or n_lines == 0 or line_len == 0:
        return
    lib = _load()
    name = "dwt53_inv_pass" if inverse else "dwt53_fwd_pass"
    fn = lib.gdct_dwt53_inv_pass if inverse else lib.gdct_dwt53_fwd_pass
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), nb, x.shape[1] * x.shape[2], n_lines,
                 line_stride, line_len, elem_stride, lines_per_block,
                 int(even), _stream(x))
    launch_counts[name] += 1
    _check(lib, err, name)


def fdct8x8_quant(x: torch.Tensor, out: torch.Tensor, d: torch.Tensor,
                  qtable: torch.Tensor, level_shift: float) -> None:
    """Launch the fused 8×8 DCT + quant kernel: int32 ``x`` [B, H, W]
    (H % 8 == W % 8 == 0) → int32 ``out`` of the same shape, raster order
    within each 8×8 block. ``d`` and ``qtable`` are float32 [64]."""
    _require(x, torch.int32, "fdct8x8_quant")
    _require(out, torch.int32, "fdct8x8_quant out")
    _require(d, torch.float32, "fdct8x8_quant d")
    _require(qtable, torch.float32, "fdct8x8_quant qtable")
    if x.dim() != 3 or out.shape != x.shape:
        raise KernelLaunchError(f"fdct8x8_quant: bad shapes "
                                f"{tuple(x.shape)} → {tuple(out.shape)}")
    b, h, w = x.shape
    if h % 8 or w % 8:
        raise KernelLaunchError(f"fdct8x8_quant: H and W must be multiples "
                                f"of 8, got {h}×{w}")
    if d.numel() != 64 or qtable.numel() != 64:
        raise KernelLaunchError("fdct8x8_quant: d and qtable need 64 "
                                "entries")
    if b == 0 or h == 0 or w == 0:
        return
    lib = _load()
    with torch.cuda.device(x.device):
        err = lib.gdct_fdct8x8_quant(x.data_ptr(), out.data_ptr(),
                                     d.data_ptr(), qtable.data_ptr(), b, h,
                                     w, float(level_shift), _stream(x))
    launch_counts["fdct8x8_quant"] += 1
    _check(lib, err, "fdct8x8_quant")
