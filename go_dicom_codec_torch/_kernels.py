"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` into one shared library with a
plain C interface at first use (never at import) and bound with
``ctypes``. Every C entry returns ``cudaGetLastError()`` after its launch;
a non-zero code raises here. Kernels run on PyTorch's current stream and
allocate nothing: the callers pass outputs they allocated, and a wrapper
that needs scratch takes it from torch.

``launch_counts`` holds one plain integer per kernel, raised by one at
each launch, so that a run can show which kernels it went through.

A wrapper that refuses a launch raises ``KernelLaunchError``, never
``ValueError``: the codecs fall back to their scalar path on a
``ValueError`` of the pipelines, and a kernel that cannot run must not
send the work to the host unnoticed.
"""

from __future__ import annotations

import ctypes
import functools
import math
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts = {"fdct8x8_quant": 0, "j2k_fwd_stage": 0,
                 "j2k_inv_stage": 0, "j2k97_fwd_stage": 0,
                 "j2k97_inv_stage": 0, "jpeg_fdct_islow": 0,
                 "jpeg_idct_islow": 0, "j2k_t1_decode": 0,
                 "j2k_ht_decode": 0}

_lib = None


class KernelLaunchError(RuntimeError):
    """A kernel wrapper refused its arguments, or the card refused or
    failed the launch."""


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
    every source: one nvcc per source, all started together, then one
    link. Returns {"path", "seconds", "built", "log"}."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    newest = max(p.stat().st_mtime for p in sources + headers)
    if (not force and LIB_PATH.is_file()
            and LIB_PATH.stat().st_mtime >= newest):
        return {"path": str(LIB_PATH), "seconds": 0.0, "built": False,
                "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _find_nvcc(), os.getpid()
    t0 = time.perf_counter()
    objects = [BUILD_DIR / f"{src.stem}.{pid}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = LIB_PATH.with_suffix(f".{pid}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objects)]
    try:
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{log}")
        link = subprocess.run(cmd, capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{' '.join(cmd)}\n{link.stdout}"
                               f"{link.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp, LIB_PATH)
    return {"path": str(LIB_PATH), "seconds": time.perf_counter() - t0,
            "built": True, "log": "".join(logs)}


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.gdct_fdct8x8_quant.argtypes = [p, p, p, p, ll, i, i, f, p]
    lib.gdct_j2k_fwd_stage.argtypes = [p, i, p, p, i, i, i, i, i, i, p, i, i,
                                       i, i, i, p, p, p, p, p]
    lib.gdct_j2k_inv_stage.argtypes = [p, i, p, p, i, i, i, i, p, i, i, i, i,
                                       i, i, i, i, p]
    lib.gdct_j2k97_fwd_stage.argtypes = [p, i, p, p, i, i, i, i, i, i, p, i,
                                         i, p]
    lib.gdct_j2k97_inv_stage.argtypes = [p, p, p, i, i, i, i, p, i, i, i, i,
                                         i, i, i, p]
    lib.gdct_j2k97_fwd_warps.argtypes = [i, i, p, p]
    lib.gdct_j2k97_inv_warps.argtypes = [i, p, p]
    lib.gdct_jpeg_fdct_islow.argtypes = [p, i, p, p, ll, i, i, i, i, p]
    lib.gdct_jpeg_idct_islow.argtypes = [p, i, p, i, p, p, ll, i, i, i, i,
                                         i, p]
    lib.gdct_j2k_t1_decode.argtypes = [p, i, ll, ll, p, i, ll, i, i, i, p, p]
    lib.gdct_j2k_ht_decode.argtypes = [p, i, ll, p, i, ll, i, i, p, i, p]
    for fn in (lib.gdct_fdct8x8_quant, lib.gdct_j2k_fwd_stage,
               lib.gdct_j2k_inv_stage, lib.gdct_j2k97_fwd_stage,
               lib.gdct_j2k97_inv_stage, lib.gdct_j2k97_fwd_warps,
               lib.gdct_j2k97_inv_warps, lib.gdct_jpeg_fdct_islow,
               lib.gdct_jpeg_idct_islow, lib.gdct_j2k_t1_decode,
               lib.gdct_j2k_ht_decode):
        fn.restype = ctypes.c_int
    lib.gdct_error_string.argtypes = [ctypes.c_int]
    lib.gdct_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.gdct_error_string(err).decode()
        raise KernelLaunchError(f"{name}: CUDA error {err} ({msg})")


def _require(x: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if x.device.type != "cuda":
        raise KernelLaunchError(f"{name}: expected a CUDA tensor, got "
                                f"{x.device}")
    if x.dtype != dtype:
        raise KernelLaunchError(f"{name}: expected {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise KernelLaunchError(f"{name}: expected a contiguous tensor")


def aligned16(x: torch.Tensor) -> bool:
    """True when ``x``'s first element sits on a 16-byte boundary, as a
    kernel's 16-byte vector loads and stores need."""
    return x.data_ptr() % 16 == 0


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


# dtypes the forward stage reads as they are (others are cast to int32
# first), with their code in csrc/j2k_fwd_stage.cu
FWD_STAGE_DTYPES = {torch.uint16: 0, torch.int16: 1, torch.int32: 2,
                    torch.uint8: 3}
FWD_STAGE_EPILOGUES = {"coeffs": 0, "narrow": 1, "stats": 2}
STAGE_MAX_ROWS = 64   # kMaxRows of both stages: one row a level
STAGE_MAX_TILE = 64   # kMaxTile of csrc/lifting.cuh
# The longest side the stages index in int: the symmetric fold's period
# 2(n - 1) (csrc/lifting.cuh::fold) must stay an int.
STAGE_MAX_SIDE = 1 << 30
INT32_MAX = (1 << 31) - 1


def stage_smem_bytes(tile: int, rct: bool) -> int:
    """Shared memory of one block of a fused stage: a buffer of the tile
    and its halo of 2, (tile + 4)² int32 words, three with the RCT."""
    return (3 if rct else 1) * (tile + 4) ** 2 * 4


@functools.lru_cache(maxsize=256)
def _stage_table(name: str, schedule: tuple):
    """A stage's level rows as the int32 array the kernel reads, once
    checked: (tile, scratch words a plane, rows)."""
    tile, words, rows = schedule
    if len(rows) > STAGE_MAX_ROWS:
        raise KernelLaunchError(f"{name}: {len(rows)} levels")
    if not 2 <= tile <= STAGE_MAX_TILE or tile % 2:
        raise KernelLaunchError(f"{name}: a tile of {tile} samples")
    flat = [int(v) for row in rows for v in row]
    if any(not -(1 << 31) <= v <= INT32_MAX for v in flat + [words]):
        raise KernelLaunchError(f"{name}: a table entry exceeds int32")
    return (ctypes.c_int * max(1, len(flat)))(*flat)


def _stage_plane(name: str, h: int, w: int, schedule, cb: int = 0):
    """``_stage_table`` of a launch over [H, W] planes, refused where an
    index of the kernel, an int, could pass 2^31 - 1: a side over
    ``STAGE_MAX_SIDE``, a level of more tiles than that, or (``cb``) a
    plane of more code-blocks. Offsets within a plane and across planes
    are long long in the kernels."""
    table = _stage_table(name, tuple(schedule))
    tile = schedule[0]
    if max(h, w) > STAGE_MAX_SIDE:
        raise KernelLaunchError(f"{name}: a side of {max(h, w)} samples "
                                f"exceeds {STAGE_MAX_SIDE}")
    if (-(-h // tile) * -(-w // tile) > INT32_MAX
            or (cb and -(-h // cb) * -(-w // cb) > INT32_MAX)):
        raise KernelLaunchError(f"{name}: {h}×{w} planes have more tiles "
                                f"or code-blocks than an int32 counts")
    return table


def _scratch(words: int, planes: int, like, dtype):
    """A stage's scratch (int32 for the 5/3, float32 for the 9/7): P ×
    its schedule's ``words`` a plane; None when the schedule needs none."""
    words *= planes
    return (torch.empty(words, dtype=dtype, device=like.device)
            if words else None)


def j2k_fwd_stage(src: torch.Tensor, coef: torch.Tensor, schedule,
                  shift: int, epilogue: str, cb: int = 0,
                  narrow: torch.Tensor = None, maxabs: torch.Tensor = None,
                  cb_max: torch.Tensor = None, cb_bits: torch.Tensor = None,
                  comps: int = 1, mct: bool = False) -> None:
    """Launch the forward stage once: ``src`` [P, H, W] (a dtype of
    ``FWD_STAGE_DTYPES``; never ``coef`` itself) → widened, less
    ``shift``, the RCT of components 0-2 of each frame of ``comps`` planes
    when ``mct`` and ``comps`` >= 3 → the levels of ``schedule`` → the
    epilogue's outputs.

    ``schedule`` is ``ops/dwt53.py:fwd_schedule``'s (tile, scratch words a
    plane, rows). Epilogue "coeffs" writes the int32 ``coef`` [P, H, W];
    "narrow" writes ``narrow`` (int16 [P, H, W]) and ``maxabs`` (int32, one
    element), ``coef`` unused (may be None); "stats" writes ``coef``,
    ``cb_max`` and ``cb_bits`` (int32 [P, ceil(H/cb), ceil(W/cb)]). The
    levels pass their LL through an int32 scratch of P × the schedule's
    words.

    The largest plane: every side DICOM allows, up to 65535 × 65535, whose
    two LL areas take at most 1,342,177,280 scratch words a plane (within
    the table's int32). A plane whose table, tiles or code-blocks an int32
    cannot count is refused before the launch (``_stage_plane``).
    """
    if src.dtype not in FWD_STAGE_DTYPES:
        raise KernelLaunchError(f"j2k_fwd_stage: no route for {src.dtype}")
    _require(src, src.dtype, "j2k_fwd_stage src")
    if epilogue not in FWD_STAGE_EPILOGUES:
        raise KernelLaunchError(f"j2k_fwd_stage: no epilogue {epilogue!r}")
    if (src.dim() != 3 or src.numel() == 0 or comps < 1
            or src.shape[0] % comps):
        raise KernelLaunchError(f"j2k_fwd_stage: bad shape "
                                f"{tuple(src.shape)} of {comps} components")
    if epilogue == "stats" and cb < 1:
        raise KernelLaunchError(f"j2k_fwd_stage: code-block size {cb}")
    p, h, w = src.shape
    table = _stage_plane("j2k_fwd_stage", h, w, schedule,
                         cb if epilogue == "stats" else 0)
    want = {}
    if epilogue != "narrow" or coef is not None:
        want["coef"] = (coef, torch.int32, (p, h, w))
    if epilogue == "narrow":
        want.update(narrow=(narrow, torch.int16, (p, h, w)),
                    maxabs=(maxabs, torch.int32, (1,)))
    elif epilogue == "stats":
        grid = (p, -(-h // cb), -(-w // cb))
        want.update(cb_max=(cb_max, torch.int32, grid),
                    cb_bits=(cb_bits, torch.int32, grid))
    for name, (t, dtype, shape) in want.items():
        _require(t, dtype, f"j2k_fwd_stage {name}")
        if t.numel() != math.prod(shape) or t.device != src.device:
            raise KernelLaunchError(f"j2k_fwd_stage: {name} needs "
                                    f"{shape} on {src.device}, got "
                                    f"{tuple(t.shape)} on {t.device}")
    if coef is not None and coef.data_ptr() == src.data_ptr():
        raise KernelLaunchError("j2k_fwd_stage: src is coef; the stage "
                                "never writes its input")
    scratch = _scratch(schedule[1], p, src, torch.int32)
    ptrs = [0 if t is None else t.data_ptr()
            for t in (coef, scratch, narrow, maxabs, cb_max, cb_bits)]
    lib = _load()
    with torch.cuda.device(src.device):
        err = lib.gdct_j2k_fwd_stage(
            src.data_ptr(), FWD_STAGE_DTYPES[src.dtype], ptrs[0], ptrs[1],
            p // comps, comps, h, w, _int32(shift), int(bool(mct)), table,
            len(schedule[2]), schedule[0], schedule[1],
            FWD_STAGE_EPILOGUES[epilogue], int(cb), *ptrs[2:], _stream(src))
    launch_counts["j2k_fwd_stage"] += 1
    _check(lib, err, "j2k_fwd_stage")


# dtypes the inverse stage reads as they are, with their code in
# csrc/j2k_inv_stage.cu
INV_STAGE_DTYPES = {torch.int16: 1, torch.int32: 2}
INV_STAGE_EPILOGUES = {"coeffs": 0, "pixels": 1, "narrow": 2}


def _int32(v: int) -> int:
    """v wrapped to int32, as the kernel adds it."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def j2k_inv_stage(src: torch.Tensor, out: torch.Tensor, schedule,
                  comps: int, epilogue: str, mct: bool = False,
                  bits: int = 16, signed: bool = False) -> None:
    """Launch the inverse stage once: packed coefficients ``src``
    [P, H, W] (a dtype of ``INV_STAGE_DTYPES``; never ``out`` itself) →
    the levels of ``schedule`` → the epilogue into ``out`` [P, H, W]. The
    P planes are frames of ``comps`` components each.

    ``schedule`` is ``ops/dwt53.py:inv_schedule``'s (tile, scratch words a
    plane, rows). Epilogue "coeffs" writes the int32 reconstruction;
    "pixels" int32 samples and "narrow" 16-bit ones (uint16, or int16 when
    ``signed``, clipped to the ``bits``-bit range): the inverse RCT of
    components 0-2 when ``mct`` and ``comps`` >= 3, then + 2^(bits-1)
    unless ``signed``. The levels pass their reconstruction through an
    int32 scratch of P × the schedule's words.

    The largest plane: every side DICOM allows, up to 65535 × 65535, whose
    two finest reconstructions below the output take at most 1,342,177,280
    scratch words a plane (within the table's int32). A plane whose table
    or tiles an int32 cannot count is refused before the launch
    (``_stage_plane``).
    """
    if src.dtype not in INV_STAGE_DTYPES:
        raise KernelLaunchError(f"j2k_inv_stage: no route for {src.dtype}")
    _require(src, src.dtype, "j2k_inv_stage src")
    if (src.dim() != 3 or src.numel() == 0 or comps < 1
            or src.shape[0] % comps):
        raise KernelLaunchError(f"j2k_inv_stage: bad shape "
                                f"{tuple(src.shape)} of {comps} components")
    p, h, w = src.shape
    table = _stage_plane("j2k_inv_stage", h, w, schedule)
    if epilogue not in INV_STAGE_EPILOGUES:
        raise KernelLaunchError(f"j2k_inv_stage: no epilogue {epilogue!r}")
    lo = hi = 0
    if epilogue == "narrow":
        if not 1 <= bits <= 16:
            raise KernelLaunchError(f"j2k_inv_stage: {bits} bits do not "
                                    f"narrow to 16")
        want = torch.int16 if signed else torch.uint16
        lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
                  else (0, (1 << bits) - 1))
    else:
        want = torch.int32
    _require(out, want, "j2k_inv_stage out")
    if out.shape != src.shape or out.device != src.device:
        raise KernelLaunchError(f"j2k_inv_stage: out needs "
                                f"{tuple(src.shape)} on {src.device}, got "
                                f"{tuple(out.shape)} on {out.device}")
    if out.data_ptr() == src.data_ptr():
        raise KernelLaunchError("j2k_inv_stage: src is out; the stage "
                                "never writes its input")
    scratch = _scratch(schedule[1], p, src, torch.int32)
    dc = 0 if signed else 1 << (bits - 1)
    lib = _load()
    with torch.cuda.device(src.device):
        err = lib.gdct_j2k_inv_stage(
            src.data_ptr(), INV_STAGE_DTYPES[src.dtype], out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), p // comps, comps,
            h, w, table, len(schedule[2]), schedule[0], schedule[1],
            INV_STAGE_EPILOGUES[epilogue], int(bool(mct)), _int32(dc), lo,
            hi, _stream(src))
    launch_counts["j2k_inv_stage"] += 1
    _check(lib, err, "j2k_inv_stage")


# The 9/7 stages' halos (csrc/lifting97.cuh): a sample a lifting step,
# four forward and six inverse.
FWD97_HALO, INV97_HALO = 4, 6
# dtypes the 9/7 forward stage reads as they are, with their code in
# csrc/j2k97_fwd_stage.cu (float32: shifted already, shift 0)
FWD97_STAGE_DTYPES = {torch.uint16: 0, torch.int16: 1, torch.int32: 2,
                      torch.uint8: 3, torch.float32: 4}
STRIP_LANES = (4, 8, 16, 32)  # the lanes a strip of csrc/lifting97.cuh takes
STRIP_PAIRS = 2  # its kPairs: pairs of columns a lane holds


@functools.lru_cache(maxsize=256)
def _stage97_table(name: str, schedule: tuple, halo: int):
    """A 9/7 stage's level rows as the int32 array the kernel reads, once
    checked as csrc/lifting97.cuh::read_schedule97 checks them: (scratch
    words a plane, rows of (kind, w, h, even_x, even_y, in_off, out_off,
    lanes, seg))."""
    words, rows = schedule
    if len(rows) > STAGE_MAX_ROWS:
        raise KernelLaunchError(f"{name}: {len(rows)} levels")
    for row in rows:
        if len(row) != 9:
            raise KernelLaunchError(f"{name}: a table row of {len(row)} "
                                    f"columns")
        lanes, seg = row[7], row[8]
        if (lanes not in STRIP_LANES or 2 * STRIP_PAIRS * lanes <= 2 * halo
                or seg < 2 or seg % 2):
            raise KernelLaunchError(f"{name}: a level of strips of {lanes} "
                                    f"lanes and segments of {seg} rows")
    flat = [int(v) for row in rows for v in row]
    if any(not -(1 << 31) <= v <= INT32_MAX for v in flat + [words]):
        raise KernelLaunchError(f"{name}: a table entry exceeds int32")
    return (ctypes.c_int * max(1, len(flat)))(*flat)


def _stage97_plane(name: str, h: int, w: int, schedule, halo: int):
    """``_stage97_table`` of a launch over [H, W] planes, refused where a
    side passes ``STAGE_MAX_SIDE`` (the fold's period, an int in the
    kernel). A level's strips and segments are fewer than its samples,
    and item counts are long long in the kernel."""
    if max(h, w) > STAGE_MAX_SIDE:
        raise KernelLaunchError(f"{name}: a side of {max(h, w)} samples "
                                f"exceeds {STAGE_MAX_SIDE}")
    return _stage97_table(name, tuple(schedule), halo)


def _planes97(name: str, src: torch.Tensor, out: torch.Tensor, comps: int,
              out_dtype: torch.dtype):
    """The checks both 9/7 wrappers make of ``src`` [P, H, W] and ``out``
    (``out_dtype``, src's shape and device, never src itself)."""
    if (src.dim() != 3 or src.numel() == 0 or comps < 1
            or src.shape[0] % comps):
        raise KernelLaunchError(f"{name}: bad shape {tuple(src.shape)} of "
                                f"{comps} components")
    _require(out, out_dtype, f"{name} out")
    if out.shape != src.shape or out.device != src.device:
        raise KernelLaunchError(f"{name}: out needs {tuple(src.shape)} on "
                                f"{src.device}, got {tuple(out.shape)} on "
                                f"{out.device}")
    if out.data_ptr() == src.data_ptr():
        raise KernelLaunchError(f"{name}: src is out; the stage never "
                                f"writes its input")


@functools.lru_cache(maxsize=64)
def _warps97(entry: str, device: int, *variant: int):
    lib = _load()
    grid, block = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*variant, ctypes.byref(grid),
                                  ctypes.byref(block))
    _check(lib, err, entry)
    return grid.value, block.value


def j2k97_fwd_warps(src: torch.Tensor, ict: bool = False):
    """(grid warps, block warps) of the kernel that ``j2k97_fwd_stage``
    launches for ``src`` (its dtype; with the ICT or without): the warps
    that ``src``'s card holds at once, as the launch sizes its grid, and
    the warps of one block. ``ops/dwt97.fwd97_schedule`` chooses its
    segment heights for them."""
    if src.dtype not in FWD97_STAGE_DTYPES:
        raise KernelLaunchError(f"j2k97_fwd_stage: no route for {src.dtype}")
    _require(src, src.dtype, "j2k97_fwd_stage src")
    return _warps97("gdct_j2k97_fwd_warps", src.get_device(),
                    FWD97_STAGE_DTYPES[src.dtype], int(ict))


def j2k97_inv_warps(src: torch.Tensor, ict: bool = False):
    """``j2k97_fwd_warps`` of the kernel that ``j2k97_inv_stage`` launches
    with the inverse ICT or without, for ``ops/dwt97.inv97_schedule``."""
    _require(src, torch.float32, "j2k97_inv_stage src")
    return _warps97("gdct_j2k97_inv_warps", src.get_device(), int(ict))


def j2k97_fwd_stage(src: torch.Tensor, out: torch.Tensor, schedule,
                    shift: int, comps: int = 1, mct: bool = False) -> None:
    """Launch the 9/7 forward stage once: samples ``src`` [P, H, W] (a
    dtype of ``FWD97_STAGE_DTYPES``; never ``out`` itself) → less
    ``shift`` in wrapping int32, rounded to float32 (a float32 ``src`` is
    taken as it is, with ``shift`` 0) → the ICT of components 0-2 of each
    frame of ``comps`` planes when ``mct`` and ``comps`` >= 3 → the levels
    of ``schedule`` → the float32 packed coefficients ``out`` [P, H, W].

    ``schedule`` is ``ops/dwt97.py:fwd97_schedule``'s (scratch words a
    plane, rows); the levels pass their LL through a float32 scratch of
    P × the schedule's words. The largest plane is the 5/3 stage's
    (``j2k_fwd_stage``), the table's checks ``_stage97_plane``'s.
    """
    if src.dtype not in FWD97_STAGE_DTYPES:
        raise KernelLaunchError(f"j2k97_fwd_stage: no route for {src.dtype}")
    _require(src, src.dtype, "j2k97_fwd_stage src")
    if src.dtype == torch.float32 and shift:
        raise KernelLaunchError("j2k97_fwd_stage: float32 samples take no "
                                "shift")
    _planes97("j2k97_fwd_stage", src, out, comps, torch.float32)
    p, h, w = src.shape
    table = _stage97_plane("j2k97_fwd_stage", h, w, schedule, FWD97_HALO)
    scratch = _scratch(schedule[0], p, src, torch.float32)
    lib = _load()
    with torch.cuda.device(src.device):
        err = lib.gdct_j2k97_fwd_stage(
            src.data_ptr(), FWD97_STAGE_DTYPES[src.dtype], out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), p // comps, comps,
            h, w, _int32(shift), int(bool(mct)), table, len(schedule[1]),
            schedule[0], _stream(src))
    launch_counts["j2k97_fwd_stage"] += 1
    _check(lib, err, "j2k97_fwd_stage")


def j2k97_inv_stage(src: torch.Tensor, out: torch.Tensor, schedule,
                    comps: int, epilogue: str, mct: bool = False,
                    bits: int = 16, signed: bool = False) -> None:
    """Launch the 9/7 inverse stage once: dequantized float32 coefficients
    ``src`` [P, H, W] (never ``out`` itself) → the levels of ``schedule``
    → the epilogue into ``out`` [P, H, W]. The P planes are frames of
    ``comps`` components each.

    ``schedule`` is ``ops/dwt97.py:inv97_schedule``'s (scratch words a
    plane, rows). Epilogue "coeffs" writes the float32 reconstruction;
    "pixels" int32 samples and "narrow" 16-bit ones (uint16, or int16 when
    ``signed``, clipped to the ``bits``-bit range): the inverse ICT of
    components 0-2 when ``mct`` and ``comps`` >= 3, round half to even
    (saturating, NaN → 0), then + 2^(bits-1) unless ``signed``. The levels
    pass their reconstruction through a float32 scratch of P × the
    schedule's words. The largest plane is the 5/3 stage's
    (``j2k_inv_stage``), the table's checks ``_stage97_plane``'s.
    """
    _require(src, torch.float32, "j2k97_inv_stage src")
    if epilogue not in INV_STAGE_EPILOGUES:
        raise KernelLaunchError(f"j2k97_inv_stage: no epilogue {epilogue!r}")
    lo = hi = 0
    if epilogue == "narrow":
        if not 1 <= bits <= 16:
            raise KernelLaunchError(f"j2k97_inv_stage: {bits} bits do not "
                                    f"narrow to 16")
        want = torch.int16 if signed else torch.uint16
        lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
                  else (0, (1 << bits) - 1))
    else:
        want = torch.float32 if epilogue == "coeffs" else torch.int32
    _planes97("j2k97_inv_stage", src, out, comps, want)
    p, h, w = src.shape
    table = _stage97_plane("j2k97_inv_stage", h, w, schedule, INV97_HALO)
    scratch = _scratch(schedule[0], p, src, torch.float32)
    dc = 0 if signed else 1 << (bits - 1)
    lib = _load()
    with torch.cuda.device(src.device):
        err = lib.gdct_j2k97_inv_stage(
            src.data_ptr(), out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), p // comps, comps,
            h, w, table, len(schedule[1]), schedule[0],
            INV_STAGE_EPILOGUES[epilogue], int(bool(mct)), _int32(dc), lo,
            hi, _stream(src))
    launch_counts["j2k97_inv_stage"] += 1
    _check(lib, err, "j2k97_inv_stage")


def fdct8x8_quant(x: torch.Tensor, out: torch.Tensor, d: torch.Tensor,
                  qtable: torch.Tensor, level_shift: float) -> None:
    """Launch the fused 8×8 DCT + quant kernel: int32 ``x`` [B, H, W]
    (H % 8 == W % 8 == 0) → int32 ``out`` of the same shape, raster order
    within each 8×8 block. ``d`` and ``qtable`` are float32 [64]. The
    kernel moves rows in 16-byte pieces: ``x`` and ``out`` must start on a
    16-byte boundary (a fresh tensor does; a view may not)."""
    _require(x, torch.int32, "fdct8x8_quant")
    _require(out, torch.int32, "fdct8x8_quant out")
    _require(d, torch.float32, "fdct8x8_quant d")
    _require(qtable, torch.float32, "fdct8x8_quant qtable")
    if not (aligned16(x) and aligned16(out)):
        raise KernelLaunchError("fdct8x8_quant: x and out must start on a "
                                "16-byte boundary")
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


# sample dtypes of the islow kernels, with their code in csrc/jpeg_islow.cu
JPEG_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2}
JPEG_MAX = {dtype: torch.iinfo(dtype).max for dtype in JPEG_DTYPES}
# coefficient dtypes the inverse reads, with their code
JPEG_COEF_DTYPES = {torch.int16: 0, torch.int32: 1}
JPEG_MAX_SIDE = 65535  # samples a side (DICOM's): 32-bit offsets in a plane


def _jpeg_refuse(name: str, what: str) -> None:
    raise KernelLaunchError(f"{name}: {what}")


def jpeg_fdct_islow(x: torch.Tensor, out: torch.Tensor,
                    recip: torch.Tensor, level_shift: int) -> None:
    """Launch the forward islow stage once: samples ``x`` [P, H, W] (a
    dtype of ``JPEG_DTYPES``, sides up to ``JPEG_MAX_SIDE``) → ``x -
    level_shift`` edge-replicated to whole 8×8 blocks → islow DCT →
    quantized by d = 8q through ``recip`` (int32 [64, 2], each zigzag
    index's {m, (d/2) << 5 | s}: ``ops.jpeg_islow._tables``; the caller
    checks the values, which lie on the device here) → the int32 ``out``
    [P, ceil(H/8), ceil(W/8), 64] in zigzag order, which must start on a
    16-byte boundary (a fresh tensor does). ``level_shift`` >= 1024 takes
    the 12-bit profile."""
    name = "jpeg_fdct_islow"
    code = JPEG_DTYPES.get(x.dtype)
    if code is None:
        _jpeg_refuse(name, f"no route for {x.dtype}")
    dev = x.device
    for t, dt, what in ((x, x.dtype, "x"), (out, torch.int32, "out"),
                        (recip, torch.int32, "recip")):
        _require(t, dt, f"{name} {what}")
        if t.device != dev:
            _jpeg_refuse(name, f"{what} is on {t.device}, x on {dev}")
    if recip.numel() != 128 or not aligned16(recip):
        _jpeg_refuse(name, "recip needs 64 × 2 entries on a 16-byte "
                           "boundary")
    if not aligned16(out):
        _jpeg_refuse(name, "out must start on a 16-byte boundary")
    if x.dim() != 3 or out.dim() != 4:
        _jpeg_refuse(name, f"bad shapes {tuple(x.shape)} → "
                           f"{tuple(out.shape)}")
    p, h, w = x.shape
    want = (p, -(-h // 8), -(-w // 8), 64)
    if tuple(out.shape) != want:
        _jpeg_refuse(name, f"out needs {want}, got {tuple(out.shape)}")
    if h > JPEG_MAX_SIDE or w > JPEG_MAX_SIDE:
        _jpeg_refuse(name, f"a side of {h}×{w} passes {JPEG_MAX_SIDE}")
    if x.numel() == 0:
        return
    err = _load().gdct_jpeg_fdct_islow(
        x.data_ptr(), code, out.data_ptr(), recip.data_ptr(), p, h, w,
        _int32(level_shift), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    launch_counts[name] += 1
    _check(_lib, err, name)


def jpeg_idct_islow(zz: torch.Tensor, out: torch.Tensor,
                    qtables: torch.Tensor, level_shift: int, max_val: int,
                    table_index: torch.Tensor | None = None) -> None:
    """Launch the inverse islow stage once: int16 or int32 zigzag
    coefficients ``zz`` [P, nby, nbx, 64] (on a 16-byte boundary) → plane
    p dequantized by table ``table_index[p]`` of ``qtables`` (int32 [T,
    64], zigzag order; table 0 for every plane without ``table_index``, an
    int32 [P] tensor whose values the caller checks to lie in [0, T)) →
    islow IDCT → + ``level_shift`` → clamped to [0, ``max_val``] in
    ``out`` [P, nby * 8, nbx * 8] (a dtype of ``JPEG_DTYPES`` that holds
    ``max_val``; it must start on a 32-byte boundary, as a fresh tensor
    does). ``level_shift`` >= 1024 takes the 12-bit profile."""
    name = "jpeg_idct_islow"
    code = JPEG_DTYPES.get(out.dtype)
    coef = JPEG_COEF_DTYPES.get(zz.dtype)
    if code is None or coef is None:
        _jpeg_refuse(name, f"no route for {zz.dtype} → {out.dtype}")
    dev = zz.device
    tensors = [(zz, zz.dtype, "zz"), (out, out.dtype, "out"),
               (qtables, torch.int32, "qtables")]
    if table_index is not None:
        tensors.append((table_index, torch.int32, "table_index"))
    for t, dt, what in tensors:
        _require(t, dt, f"{name} {what}")
        if t.device != dev:
            _jpeg_refuse(name, f"{what} is on {t.device}, zz on {dev}")
    if qtables.dim() != 2 or qtables.shape[1] != 64 or not qtables.shape[0]:
        _jpeg_refuse(name, f"qtables needs [T, 64], got "
                           f"{tuple(qtables.shape)}")
    if not 0 <= max_val <= JPEG_MAX[out.dtype]:
        _jpeg_refuse(name, f"max_val {max_val} does not fit {out.dtype}")
    if out.data_ptr() % 32 or not aligned16(zz) or not aligned16(qtables):
        _jpeg_refuse(name, "out must start on a 32-byte boundary, zz and "
                           "qtables on a 16-byte one")
    if zz.dim() != 4 or zz.shape[-1] != 64 or out.dim() != 3:
        _jpeg_refuse(name, f"bad shapes {tuple(zz.shape)} → "
                           f"{tuple(out.shape)}")
    p, nby, nbx, _ = zz.shape
    if tuple(out.shape) != (p, nby * 8, nbx * 8):
        _jpeg_refuse(name, f"out needs {(p, nby * 8, nbx * 8)}, got "
                           f"{tuple(out.shape)}")
    if table_index is not None and table_index.shape != (p,):
        _jpeg_refuse(name, f"table_index needs ({p},), got "
                           f"{tuple(table_index.shape)}")
    if max(nby, nbx) > -(-JPEG_MAX_SIDE // 8):
        _jpeg_refuse(name, f"a side of {nby}×{nbx} blocks passes "
                           f"{JPEG_MAX_SIDE} samples")
    if zz.numel() == 0:
        return
    err = _load().gdct_jpeg_idct_islow(
        zz.data_ptr(), coef, out.data_ptr(), code, qtables.data_ptr(),
        None if table_index is None else table_index.data_ptr(), p, nby,
        nbx, _int32(level_shift), int(max_val), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    launch_counts[name] += 1
    _check(_lib, err, name)


# The T1 kernel's plan records: int32 fields a code-block
# (ops/j2k_t1_decode.py). The most 32-bit words a code-block takes in its
# shared memory (ops/j2k_t1_decode.py:block_words of 1024 columns by 4
# rows, the widest block T.800 allows).
T1_RECORD = 13
T1_MAX_WORDS = 3 * 1026 + 4 * 1024


def j2k_t1_decode(plan: torch.Tensor, out: torch.Tensor, launch,
                  times: torch.Tensor = None) -> None:
    """Launch the T1 decode once: the ``launch.blocks`` code-blocks of the
    plan bytes ``plan`` (uint8, laid out by ``ops/j2k_t1_decode.make_plan``,
    which checked every record) → their coefficients in ``out`` (int16 when
    ``launch.narrow``, else int32, ``launch.shape``), zeroed first where no
    block lands. ``times``: None, or int64 [blocks, 2] for each block's
    start and end on the card's globaltimer (ns), in the plan's order."""
    name = "j2k_t1_decode"
    _require(plan, torch.uint8, f"{name} plan")
    _require(out, torch.int16 if launch.narrow else torch.int32,
             f"{name} out")
    if out.device != plan.device or tuple(out.shape) != launch.shape:
        raise KernelLaunchError(f"{name}: out needs {launch.shape} on "
                                f"{plan.device}, got {tuple(out.shape)} on "
                                f"{out.device}")
    if (launch.blocks < 0 or launch.seg_at != 4 * T1_RECORD * launch.blocks
            or not launch.seg_at <= launch.data_at <= plan.numel()
            or not 0 <= launch.max_words <= T1_MAX_WORDS):
        raise KernelLaunchError(f"{name}: a plan of {plan.numel()} bytes "
                                f"does not hold {launch}")
    if times is not None:
        _require(times, torch.int64, f"{name} times")
        if times.shape != (launch.blocks, 2) or times.device != plan.device:
            raise KernelLaunchError(f"{name}: times needs "
                                    f"({launch.blocks}, 2) on {plan.device}")
    _, th, tw = launch.shape
    lib = _load()
    with torch.cuda.device(plan.device):
        err = lib.gdct_j2k_t1_decode(
            plan.data_ptr(), launch.blocks, launch.seg_at, launch.data_at,
            out.data_ptr(), int(launch.narrow), out.numel(), th, tw,
            launch.max_words, None if times is None else times.data_ptr(),
            _stream(plan))
    launch_counts[name] += 1
    _check(lib, err, name)


# The HT kernel's plan records: int32 fields a code-block
# (ops/j2k_ht_decode.py). The most 32-bit words of shared memory a
# code-block takes (ops/j2k_ht_decode.py:block_words, over every size
# T.800 allows and a Scup of 4079, 8,636), under the 48 KiB a launch
# gets without opting in.
HT_RECORD = 10
HT_MAX_WORDS = 11 * 1024


def j2k_ht_decode(plan: torch.Tensor, out: torch.Tensor,
                  status: torch.Tensor, launch) -> None:
    """Launch the HT cleanup decode once: the ``launch.blocks`` code-blocks
    of the plan bytes ``plan`` (uint8, laid out by
    ``ops/j2k_ht_decode.make_plan``, which checked every record) → their
    coefficients in ``out`` (int16 when ``launch.narrow``, else int32,
    ``launch.shape``), zeroed first where no block lands; ``status``
    (int32 [1]) zeroed, then set where a block's stream breaks T.814's
    bound on U_q."""
    name = "j2k_ht_decode"
    _require(plan, torch.uint8, f"{name} plan")
    _require(out, torch.int16 if launch.narrow else torch.int32,
             f"{name} out")
    _require(status, torch.int32, f"{name} status")
    if (out.device != plan.device or status.device != plan.device
            or tuple(out.shape) != launch.shape or status.numel() != 1):
        raise KernelLaunchError(f"{name}: out needs {launch.shape} and "
                                f"status one int32, on {plan.device}")
    if (launch.blocks < 0 or launch.data_at != 4 * HT_RECORD * launch.blocks
            or launch.data_at > plan.numel()
            or not 0 <= launch.max_words <= HT_MAX_WORDS):
        raise KernelLaunchError(f"{name}: a plan of {plan.numel()} bytes "
                                f"does not hold {launch}")
    _, th, tw = launch.shape
    lib = _load()
    with torch.cuda.device(plan.device):
        err = lib.gdct_j2k_ht_decode(
            plan.data_ptr(), launch.blocks, launch.data_at, out.data_ptr(),
            int(launch.narrow), out.numel(), th, tw, status.data_ptr(),
            launch.max_words, _stream(plan))
    launch_counts[name] += 1
    _check(lib, err, name)
