"""Reversible 5/3 lifting DWT (ISO/IEC 15444-1 Annex F).

Port of ``go_dicom_codec_tpu/ops/dwt53.py:37-344``, in two lanes:

- the plain lane (``fwd53_1d`` … ``inv53_2d``, ``*_multilevel_plain_``):
  torch functions with the reference's lifting arithmetic, shifted slices
  with edge clamps, on any device;
- the kernel lane: for a CUDA tensor the whole forward transform is one
  launch of ``csrc/j2k_fwd_stage.cu`` and the whole inverse one launch of
  ``csrc/j2k_inv_stage.cu`` (``fwd_schedule`` and ``inv_schedule`` are
  their pass tables); lines too long for shared memory run one 2D level
  as two launches of the lifting passes of ``csrc/dwt53.cu``, one along
  columns and one along rows.

``fwd53_multilevel_``/``inv53_multilevel_`` pick the kernel lane for a
CUDA tensor and the plain lane for a CPU tensor; any other device raises.

Layout: packed Mallat, ``[L | H]`` per axis in the window; after one 2D
level the window is [[LL, HL], [LH, HH]] and the next level works on the
LL window at the top-left. Unlike the reference, whose concat recursion
and even/even reshape paths are XLA lowering choices, the port transforms
each level's window in place: the multilevel functions overwrite their
input (callers that keep it pass a clone). Parity comes from the window
origin: an even origin is OpenJPEG cas=0.

int32 arithmetic with arithmetic ``>>``, bit-exact with the reference.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import torch

from .. import _kernels


# ---- geometry (copied: importing the reference would import jax) ----------

def low_len(n: int, even: bool) -> int:
    """Low-pass sample count (reference wavelet/parity.go splitLengths)."""
    return (n + 1) // 2 if even else n // 2


def next_window(w: int, h: int, x0: int, y0: int) -> Tuple[int, int, int, int]:
    """Next-level LL window (reference wavelet/layout.go nextLowpassWindow)."""
    return (low_len(w, x0 % 2 == 0), low_len(h, y0 % 2 == 0),
            (x0 + 1) >> 1, (y0 + 1) >> 1)


def ll_dimensions(width: int, height: int, levels: int,
                  x0: int = 0, y0: int = 0) -> Tuple[int, int]:
    """LL subband dims after `levels` (reference wavelet/layout.go:14-41)."""
    if width <= 0 or height <= 0:
        return 0, 0
    w, h = width, height
    for _ in range(max(levels, 0)):
        if w <= 1 and h <= 1:
            break
        w, h, x0, y0 = next_window(w, h, x0, y0)
    return w, h


def _level_windows(width: int, height: int, levels: int, x0: int, y0: int):
    """Per-level (w, h, x0, y0) windows, finest first."""
    wins: List[Tuple[int, int, int, int]] = []
    w, h = width, height
    for _ in range(levels):
        if w == 0 or h == 0:
            break
        # 1-sample windows still run: at odd origins Annex B puts the
        # sample in the HIGH band of this level (the ×2 rule)
        wins.append((w, h, x0, y0))
        w, h, x0, y0 = next_window(w, h, x0, y0)
    return wins


# ---- plain lane -------------------------------------------------------------

def _edge_left(a):
    """a[i-1] with left-edge clamp along the last axis."""
    return torch.cat([a[..., :1], a[..., :-1]], dim=-1)


def _edge_right(a):
    """a[i+1] with right-edge clamp along the last axis."""
    return torch.cat([a[..., 1:], a[..., -1:]], dim=-1)


def fwd53_1d(x: torch.Tensor, even: bool) -> torch.Tensor:
    """Forward 5/3 lifting along the last axis → [L | H] packed."""
    w = x.shape[-1]
    if w <= 1:
        return x if even else x * 2
    if even:
        s = x[..., 0::2]
        d = x[..., 1::2]
        sn, dn = s.shape[-1], d.shape[-1]
        # predict: h[i] = d[i] - ((s[i] + s[i+1 clamped]) >> 1)
        s_next = _edge_right(s)[..., :dn]
        h = d - ((s[..., :dn] + s_next) >> 1)
        # update: l[i] = s[i] + ((h[i-1 clamped] + h[i clamped] + 2) >> 2)
        h_prev = _edge_left(h)
        h_cur = h
        if sn == dn + 1:
            h_prev = torch.cat([h_prev, h[..., -1:]], dim=-1)
            h_cur = torch.cat([h_cur, h[..., -1:]], dim=-1)
        l = s + ((h_prev + h_cur + 2) >> 2)
    else:
        d = x[..., 0::2]
        s = x[..., 1::2]
        sn, dn = s.shape[-1], d.shape[-1]
        # predict: h[i] = d[i] - ((s[i-1 clamped] + s[i clamped]) >> 1)
        if dn == sn:
            s_im1, s_i = _edge_left(s), s
        else:
            s_im1 = torch.cat([s[..., :1], s], dim=-1)
            s_i = torch.cat([s, s[..., -1:]], dim=-1)
        h = d - ((s_im1 + s_i) >> 1)
        # update: l[i] = s[i] + ((h[i] + h[i+1 clamped] + 2) >> 2)
        h_i = h[..., :sn]
        h_ip1 = h[..., 1:sn + 1] if dn >= sn + 1 else _edge_right(h)
        l = s + ((h_i + h_ip1 + 2) >> 2)
    return torch.cat([l, h], dim=-1)


def inv53_1d(x: torch.Tensor, even: bool) -> torch.Tensor:
    """Inverse 5/3 lifting along the last axis from [L | H] packed."""
    w = x.shape[-1]
    if w <= 1:
        # the forward doubled a lone odd-parity sample; it is always even
        return x if even else (x >> 1)
    out = torch.empty_like(x)
    if even:
        sn = (w + 1) // 2
        l, h = x[..., :sn], x[..., sn:]
        dn = w - sn
        # s[i] = l[i] - ((h[i-1 cl] + h[i cl] + 2) >> 2)
        h_prev, h_cur = _edge_left(h), h
        if sn == dn + 1:
            h_prev = torch.cat([h_prev, h[..., -1:]], dim=-1)
            h_cur = torch.cat([h_cur, h[..., -1:]], dim=-1)
        s = l - ((h_prev + h_cur + 2) >> 2)
        # x_odd[i] = h[i] + ((s[i] + s[i+1 cl]) >> 1)
        s_ip1 = s[..., 1:sn] if sn == dn + 1 else _edge_right(s)
        out[..., 0::2] = s
        out[..., 1::2] = h + ((s[..., :dn] + s_ip1[..., :dn]) >> 1)
    else:
        sn = w // 2
        l, h = x[..., :sn], x[..., sn:]
        dn = w - sn
        # s[i] = l[i] - ((h[i cl] + h[i+1 cl] + 2) >> 2)
        if dn == sn:
            h_i, h_ip1 = h, _edge_right(h)
        else:
            h_i, h_ip1 = h[..., :sn], h[..., 1:sn + 1]
        s = l - ((h_i + h_ip1 + 2) >> 2)
        # x_even[i] = h[i] + ((s[i-1 cl] + s[i cl]) >> 1)
        if dn == sn:
            s_im1, s_i = _edge_left(s), s
        else:
            s_im1 = torch.cat([s[..., :1], s], dim=-1)
            s_i = torch.cat([s, s[..., -1:]], dim=-1)
        out[..., 0::2] = h + ((s_im1 + s_i) >> 1)
        out[..., 1::2] = s
    return out


def _along_cols(fn, x, even):
    return fn(x.transpose(-1, -2), even).transpose(-1, -2)


def fwd53_2d(x: torch.Tensor, even_row: bool = True,
             even_col: bool = True) -> torch.Tensor:
    """One 2D level: vertical pass first, then horizontal.

    A size-1 dimension still passes through the 1D op at odd parity (its
    single sample is a HIGH coefficient); at even parity it is skipped.
    """
    h, w = x.shape[-2], x.shape[-1]
    if h > 1 or (h == 1 and not even_col):
        x = _along_cols(fwd53_1d, x, even_col)
    if w > 1 or (w == 1 and not even_row):
        x = fwd53_1d(x, even_row)
    return x


def inv53_2d(x: torch.Tensor, even_row: bool = True,
             even_col: bool = True) -> torch.Tensor:
    """Inverse 2D level: horizontal first, then vertical."""
    h, w = x.shape[-2], x.shape[-1]
    if w > 1 or (w == 1 and not even_row):
        x = inv53_1d(x, even_row)
    if h > 1 or (h == 1 and not even_col):
        x = _along_cols(inv53_1d, x, even_col)
    return x


def _fwd_level_plain_(x, h, w, even_row, even_col):
    x[..., :h, :w] = fwd53_2d(x[..., :h, :w], even_row, even_col)


def _inv_level_plain_(x, h, w, even_row, even_col):
    x[..., :h, :w] = inv53_2d(x[..., :h, :w], even_row, even_col)


# ---- kernel lane ------------------------------------------------------------

_ROW_SAMPLES_PER_BLOCK = 2048   # rows share a block up to this many samples
_COLS_PER_BLOCK = 32            # 32 int32 columns = one 128-byte segment
# The fused stage takes 8 columns (one 32-byte sector) a work item: with
# 4 frames of 512² its level-1 column pass has 4× the items of 32, and its
# one shared-memory size for every pass drops from 65.7 to 16.4 KB, so
# more blocks are co-resident. On the H100, 8 ran the narrow stage faster
# than 16 or 32 at 4 and at 32 frames of 512² (PERF.md §5).
_STAGE_COLS_PER_BLOCK = 8


def _level_passes(h: int, w: int, even_row: bool,
                  even_col: bool) -> List[Tuple[bool, bool]]:
    """The 1D passes of one forward level, in order, as (vertical, even).

    A size-1 dimension still passes at odd parity (its single sample is a
    HIGH coefficient); at even parity it is skipped. The inverse runs
    them in reverse.
    """
    passes = []
    if h > 1 or not even_col:
        passes.append((True, even_col))
    if w > 1 or not even_row:
        passes.append((False, even_row))
    return passes


def _pass_geometry(width: int, h: int, w: int, vertical: bool,
                   cols_per_block: int = _COLS_PER_BLOCK
                   ) -> Tuple[int, int, int, int, int]:
    """(n_lines, line_stride, n, elem_stride, lines_per_block) of one pass
    over the top-left h×w window of planes ``width`` samples wide."""
    if vertical:
        n_lines, line_stride, n, elem_stride = w, 1, h, width
        lpb = cols_per_block
    else:
        n_lines, line_stride, n, elem_stride = h, width, w, 1
        lpb = _ROW_SAMPLES_PER_BLOCK // n
    # a line too long for shared memory leaves lpb = 1; the launch wrapper
    # then takes the long-line route
    fit = _kernels.SMEM_MAX_BYTES // _kernels.dwt53_smem_bytes(1, n)
    return n_lines, line_stride, n, elem_stride, max(1, min(lpb, n_lines, fit))


@functools.lru_cache(maxsize=256)
def fwd_schedule(width: int, height: int, levels: int, x0: int = 0,
                 y0: int = 0) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """The forward transform of [H, W] planes as the pass table of
    csrc/j2k_fwd_stage.cu: rows of (n_lines, line_stride, n, elem_stride,
    lines_per_block, even), finest level first. None when a line is too
    long for shared memory: the transform then runs pass by pass."""
    table = []
    for (w, h, lx0, ly0) in _level_windows(width, height, levels, x0, y0):
        for vertical, even in _level_passes(h, w, lx0 % 2 == 0,
                                            ly0 % 2 == 0):
            geom = _pass_geometry(width, h, w, vertical,
                                  _STAGE_COLS_PER_BLOCK)
            if _kernels.dwt53_long_line(geom[2]):
                return None
            table.append(geom + (int(even),))
    return tuple(table)


# The inverse stage's head: the coarsest levels whose window holds at most
# this many samples run in one block a plane, in shared memory, before the
# first grid barrier (csrc/j2k_inv_stage.cu). Chosen on the H100 from none,
# 64² and 128² (the HEAD| lines of tools/device_bench.py, PERF.md).
_HEAD_SAMPLES = 64 * 64


def _head_rows(wins) -> list:
    """The passes of the head levels ``wins`` (finest first), coarsest
    first, on a tile of the finest window; lpb lines of ~2048 samples."""
    head = []
    for (w, h, lx0, ly0) in reversed(wins):
        for vertical, even in reversed(_level_passes(h, w, lx0 % 2 == 0,
                                                     ly0 % 2 == 0)):
            n_lines, line_stride, n, elem_stride, _ = _pass_geometry(
                wins[0][0], h, w, vertical)
            lpb = max(1, min(n_lines, _ROW_SAMPLES_PER_BLOCK // n))
            head.append((n_lines, line_stride, n, elem_stride, lpb,
                         int(even)))
    return head


def _inv_schedule(width: int, height: int, levels: int, x0: int, y0: int,
                  head_samples: int):
    """``inv_schedule`` with a head of at most ``head_samples`` samples."""
    wins = _level_windows(width, height, levels, x0, y0)
    n_head = 0
    while (n_head < len(wins)
           and wins[-1 - n_head][0] * wins[-1 - n_head][1] <= head_samples):
        n_head += 1
    # fewer head levels where the tile and its lines exceed shared memory
    while n_head and _kernels.inv_stage_smem_bytes(
            wins[-n_head][:2] + (_head_rows(wins[-n_head:]), (), 0, 0)) > \
            _kernels.SMEM_MAX_BYTES:
        n_head -= 1
    head_wins, grid_wins = wins[len(wins) - n_head:], wins[:len(wins) - n_head]
    head_w, head_h = head_wins[0][:2] if head_wins else (0, 0)
    rows, (done_w, done_h) = [], (head_w, head_h)
    for (w, h, lx0, ly0) in reversed(grid_wins):
        for vertical, even in reversed(_level_passes(h, w, lx0 % 2 == 0,
                                                     ly0 % 2 == 0)):
            geom = _pass_geometry(width, h, w, vertical,
                                  _STAGE_COLS_PER_BLOCK)
            if _kernels.dwt53_long_line(geom[2]):
                return None
            done = (done_w, done_h) if vertical else (done_h, done_w)
            rows.append(geom + (int(even),) + done)
            done_w, done_h = w, h
    return (head_w, head_h, tuple(_head_rows(head_wins)), tuple(rows),
            done_w, done_h)


@functools.lru_cache(maxsize=256)
def inv_schedule(width: int, height: int, levels: int, x0: int = 0,
                 y0: int = 0):
    """The inverse transform of [H, W] planes as csrc/j2k_inv_stage.cu
    runs it: (head_w, head_h, head rows, grid rows, final_w, final_h), or
    None when a line is too long for shared memory (the transform then
    runs pass by pass).

    The head is the top-left head_w × head_h window of the coarsest levels
    whose windows hold at most ``_HEAD_SAMPLES`` samples; its rows (n_lines,
    line_stride, n, elem_stride, lines_per_block, even), coarsest first,
    address a tile of that window. The grid rows follow, coarsest first,
    with two more columns: the window that earlier passes wrote, as
    (lines, samples) in the pass's own order. final_w × final_h is the
    window the whole schedule writes.
    """
    return _inv_schedule(width, height, levels, x0, y0, _HEAD_SAMPLES)


def _pass_kernel_(x3: torch.Tensor, h: int, w: int, vertical: bool,
                  even: bool, inverse: bool) -> None:
    """One 1D lifting pass over the top-left h×w window of every plane of
    the contiguous int32 [B, H, W] tensor ``x3``, in place."""
    n_lines, line_stride, n, elem_stride, lpb = _pass_geometry(
        x3.shape[-1], h, w, vertical)
    _kernels.dwt53_pass(x3, n_lines, line_stride, n, elem_stride, lpb,
                        even, inverse)


def _planes(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] → [B, H, W] view; the launch wrapper checks the rest."""
    return x.view(-1, x.shape[-2], x.shape[-1])


def _fwd_level_kernel_(x, h, w, even_row, even_col):
    x3 = _planes(x)
    for vertical, even in _level_passes(h, w, even_row, even_col):
        _pass_kernel_(x3, h, w, vertical, even, inverse=False)


def _inv_level_kernel_(x, h, w, even_row, even_col):
    x3 = _planes(x)
    for vertical, even in reversed(_level_passes(h, w, even_row, even_col)):
        _pass_kernel_(x3, h, w, vertical, even, inverse=True)


# ---- multilevel -------------------------------------------------------------

LevelFn = Callable[[torch.Tensor, int, int, bool, bool], None]
MultilevelFn = Callable[[torch.Tensor, int, int, int], torch.Tensor]


def _lane(x: torch.Tensor, kernel: MultilevelFn,
          plain: MultilevelFn) -> MultilevelFn:
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"5/3 DWT: no lane for device {x.device}")


def _multilevel_(x: torch.Tensor, levels: int, x0: int, y0: int,
                 level: LevelFn, inverse: bool) -> torch.Tensor:
    wins = _level_windows(x.shape[-1], x.shape[-2], levels, x0, y0)
    for (w, h, lx0, ly0) in (reversed(wins) if inverse else wins):
        level(x, h, w, lx0 % 2 == 0, ly0 % 2 == 0)
    return x


def _fwd_multilevel_kernel_(x: torch.Tensor, levels: int, x0: int,
                            y0: int) -> torch.Tensor:
    """One launch of the fused forward stage, or pass by pass where a line
    is too long for shared memory."""
    sched = fwd_schedule(x.shape[-1], x.shape[-2], levels, x0, y0)
    if sched is None:
        return _multilevel_(x, levels, x0, y0, _fwd_level_kernel_,
                            inverse=False)
    if x.numel():
        x3 = _planes(x)
        _kernels.j2k_fwd_stage(x3, x3, sched, 0, "coeffs")
    return x


def _inv_multilevel_kernel_(x: torch.Tensor, levels: int, x0: int,
                            y0: int) -> torch.Tensor:
    """One launch of the inverse stage, in place, or pass by pass where a
    line is too long for shared memory."""
    sched = inv_schedule(x.shape[-1], x.shape[-2], levels, x0, y0)
    if sched is None:
        return _multilevel_(x, levels, x0, y0, _inv_level_kernel_,
                            inverse=True)
    if x.numel():
        x3 = _planes(x)
        _kernels.j2k_inv_stage(x3, x3, sched, 1, "coeffs")
    return x


def fwd53_multilevel_(x: torch.Tensor, levels: int, x0: int = 0,
                      y0: int = 0) -> torch.Tensor:
    """Multilevel packed decomposition of [..., H, W] int32, in place.

    Finest level first; each level transforms the current LL window at the
    top-left. A CUDA tensor takes one launch of csrc/j2k_fwd_stage.cu
    (lines over 58111 samples: two launches of csrc/dwt53.cu per level); a
    CPU tensor takes the plain lane.
    """
    return _lane(x, _fwd_multilevel_kernel_,
                 fwd53_multilevel_plain_)(x, levels, x0, y0)


def inv53_multilevel_(x: torch.Tensor, levels: int, x0: int = 0,
                      y0: int = 0) -> torch.Tensor:
    """Multilevel packed reconstruction of [..., H, W] int32, in place,
    coarsest level first. A CUDA tensor takes one launch of
    csrc/j2k_inv_stage.cu (lines over 58111 samples: two launches of
    csrc/dwt53.cu per level); a CPU tensor takes the plain lane."""
    return _lane(x, _inv_multilevel_kernel_,
                 inv53_multilevel_plain_)(x, levels, x0, y0)


def fwd53_multilevel_plain_(x: torch.Tensor, levels: int, x0: int = 0,
                            y0: int = 0) -> torch.Tensor:
    """The plain lane on any device, in place: the kernel lane's reference."""
    return _multilevel_(x, levels, x0, y0, _fwd_level_plain_, inverse=False)


def inv53_multilevel_plain_(x: torch.Tensor, levels: int, x0: int = 0,
                            y0: int = 0) -> torch.Tensor:
    """The plain lane on any device, in place: the kernel lane's reference."""
    return _multilevel_(x, levels, x0, y0, _inv_level_plain_, inverse=True)
