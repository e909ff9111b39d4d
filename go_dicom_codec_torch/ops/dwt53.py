"""Reversible 5/3 lifting DWT (ISO/IEC 15444-1 Annex F).

Port of ``go_dicom_codec_tpu/ops/dwt53.py:37-344``, in two lanes:

- the plain lane (``fwd53_1d`` … ``inv53_2d``, ``*_multilevel_plain_``):
  torch functions with the reference's lifting arithmetic, shifted slices
  with edge clamps, on any device;
- the kernel lane: for a CUDA tensor of any shape the whole forward
  transform is one launch of ``csrc/j2k_fwd_stage.cu`` and the whole
  inverse one launch of ``csrc/j2k_inv_stage.cu`` (``fwd_schedule`` and
  ``inv_schedule`` are their level tables: one 2D-tiled pass a level,
  whose tile and halo fit in shared memory whatever the line length).

``fwd53_multilevel_``/``inv53_multilevel_`` pick the kernel lane for a
CUDA tensor and the plain lane for a CPU tensor; any other device raises.
The fused stages never write their input, so on a CUDA tensor these
in-place forms launch the stage on a copy; the codecs call the
out-of-place ``ops/j2k_fwd_stage.fwd_stage`` and
``ops/j2k_inv_stage.inv_stage`` instead, which copy nothing.

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
from typing import Callable, List, Tuple

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


# ---- the fused stages' level tables ------------------------------------------

# The side of the stages' output tiles (csrc/lifting.cuh, the tile pass): a
# tile of 64² and its halo of 2 take 18.5 KB of shared memory a buffer,
# three buffers (the RCT's components) 55.5 KB.
_TILE = 64
# The inverse stage's head: the coarsest levels whose window holds at most
# this many samples run in one block a plane (block rows), before the
# first grid barrier. Chosen on the H100 from none, 64² and 128² (the
# HEAD| lines of tools/device_bench.py, PERF.md).
_HEAD_SAMPLES = 64 * 64
# The head also bounds each side of a window by this many samples, the
# card's tile side, so that a long, thin coarse window (4096×1 at 5 levels
# of a 16-row frame: 64 tiles) spreads its tiles over the grid rather than
# leaving one block a plane to walk them in turn: 2.3× faster at 5 levels
# of [2, 16, 65535], 3.2× at [2, 65535, 16], the same tables at 512² (the
# HEAD| lines of tools/device_bench.py on the H100, PERF.md).
_HEAD_SIDE = 64

ROW_KINDS = {"grid": 0, "block": 1}


def _stage_windows(width: int, height: int, levels: int, x0: int, y0: int):
    """The level windows of a stage, finest first, less those that change
    nothing (1×1 at even parity both ways)."""
    return [(w, h, lx0, ly0)
            for (w, h, lx0, ly0) in _level_windows(width, height, levels,
                                                   x0, y0)
            if not (w == 1 and h == 1 and lx0 % 2 == 0 and ly0 % 2 == 0)]


def _ll_size(w: int, h: int, lx0: int, ly0: int) -> int:
    return low_len(w, lx0 % 2 == 0) * low_len(h, ly0 % 2 == 0)


def _scratch(sizes: List[int]) -> Tuple[List[int], int]:
    """Offsets of the areas of ``sizes`` (in the order the levels write
    them, the largest first): two areas in turn, so that no level writes
    where it reads; and the words a plane's scratch takes."""
    slots = [0, sizes[0] if sizes else 0]
    return ([slots[i % 2] for i in range(len(sizes))],
            sum(sizes[:2]))


@functools.lru_cache(maxsize=256)
def fwd_schedule(width: int, height: int, levels: int, x0: int = 0,
                 y0: int = 0):
    """The forward transform of [H, W] planes as csrc/j2k_fwd_stage.cu
    runs it: (tile, scratch words a plane, rows), for every side and
    origin (a tile and its halo fit in shared memory whatever the line
    length). At 65535² and three levels or more the scratch is the most
    it gets, 32768² + 16384² = 1,342,177,280 words: within the int32 of the
    kernel's table (``_kernels._stage_plane`` checks every launch).

    One row a level, finest first: (kind, w, h, even_x, even_y, in_off,
    out_off). kind "grid" spreads the level's tiles over the grid, "block"
    (the levels whose window fits one tile) runs in one block a plane;
    in_off is -1 for the stage's input (the first level), else where the
    level's w×h input lies in a plane's scratch; out_off is where its LL
    goes there, -1 for the output (the last level).
    """
    return fwd_table(_stage_windows(width, height, levels, x0, y0))


def fwd_table(wins):
    """A forward stage's (tile, scratch words a plane, rows) for its level
    windows ``wins``, finest first (``fwd_schedule``; the 9/7's
    ``fwd97_schedule`` extends its rows)."""
    outs, words = _scratch([_ll_size(*win) for win in wins[:-1]])
    rows = []
    for i, (w, h, lx0, ly0) in enumerate(wins):
        kind = "block" if w <= _TILE and h <= _TILE else "grid"
        rows.append((ROW_KINDS[kind], w, h, int(lx0 % 2 == 0),
                     int(ly0 % 2 == 0), outs[i - 1] if i else -1,
                     outs[i] if i < len(wins) - 1 else -1))
    return (_TILE, words, tuple(rows))


def _inv_schedule(width: int, height: int, levels: int, x0: int, y0: int,
                  head_samples: int, head_side=None):
    """``inv_schedule`` with a head of windows of at most ``head_samples``
    samples and, unless ``head_side`` is None, sides of at most
    ``head_side`` samples."""
    return inv_table(_stage_windows(width, height, levels, x0, y0),
                     head_samples, head_side)


def inv_table(wins, head_samples: int, head_side):
    """An inverse stage's (tile, scratch words a plane, rows) for its level
    windows ``wins``, finest first (``_inv_schedule``; the 9/7's
    ``inv97_schedule`` extends its rows)."""
    wins = wins[::-1]
    # coarsest first; a level's reconstruction is the next one's LL: the
    # last-but-one is the largest, so the areas are handed out from the
    # finest level up
    outs, words = _scratch([w * h for (w, h, _, _) in wins[-2::-1]])
    outs = outs[::-1]
    rows = []
    for i, (w, h, lx0, ly0) in enumerate(wins):
        head = w * h <= head_samples and (head_side is None
                                          or max(w, h) <= head_side)
        kind = "block" if head else "grid"
        rows.append((ROW_KINDS[kind], w, h, int(lx0 % 2 == 0),
                     int(ly0 % 2 == 0), outs[i - 1] if i else -1,
                     outs[i] if i < len(wins) - 1 else -1))
    return (_TILE, words, tuple(rows))


@functools.lru_cache(maxsize=256)
def inv_schedule(width: int, height: int, levels: int, x0: int = 0,
                 y0: int = 0):
    """The inverse transform of [H, W] planes as csrc/j2k_inv_stage.cu
    runs it: (tile, scratch words a plane, rows), for every side and
    origin, as ``fwd_schedule`` (the same scratch at most).

    One row a level, coarsest first, as in ``fwd_schedule``: (kind, w, h,
    even_x, even_y, in_off, out_off). The head is the coarsest levels
    whose window holds at most ``_HEAD_SAMPLES`` samples, with sides of at
    most ``_HEAD_SIDE`` ("block" rows);
    in_off is -1 where the level's LL lies in the input (the coarsest
    level), else where the level above wrote it in a plane's scratch;
    out_off is where the level's w×h reconstruction goes there, -1 for
    the output (the finest level).
    """
    return _inv_schedule(width, height, levels, x0, y0, _HEAD_SAMPLES,
                         _HEAD_SIDE)


def _planes(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] → [B, H, W] view; the launch wrapper checks the rest."""
    return x.view(-1, x.shape[-2], x.shape[-1])


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
    """One launch of the fused forward stage."""
    sched = fwd_schedule(x.shape[-1], x.shape[-2], levels, x0, y0)
    if x.numel():
        x3 = _planes(x)
        # the stage never writes its input: it reads a copy
        _kernels.j2k_fwd_stage(x3.clone(), x3, sched, 0, "coeffs")
    return x


def _inv_multilevel_kernel_(x: torch.Tensor, levels: int, x0: int,
                            y0: int) -> torch.Tensor:
    """One launch of the inverse stage."""
    sched = inv_schedule(x.shape[-1], x.shape[-2], levels, x0, y0)
    if x.numel():
        x3 = _planes(x)
        # the stage never writes its input: it reads a copy
        _kernels.j2k_inv_stage(x3.clone(), x3, sched, 1, "coeffs")
    return x


def fwd53_multilevel_(x: torch.Tensor, levels: int, x0: int = 0,
                      y0: int = 0) -> torch.Tensor:
    """Multilevel packed decomposition of [..., H, W] int32, in place.

    Finest level first; each level transforms the current LL window at the
    top-left. A CUDA tensor of any shape takes one launch of
    csrc/j2k_fwd_stage.cu, or raises; a CPU tensor takes the plain lane.
    """
    return _lane(x, _fwd_multilevel_kernel_,
                 fwd53_multilevel_plain_)(x, levels, x0, y0)


def inv53_multilevel_(x: torch.Tensor, levels: int, x0: int = 0,
                      y0: int = 0) -> torch.Tensor:
    """Multilevel packed reconstruction of [..., H, W] int32, in place,
    coarsest level first. A CUDA tensor of any shape takes one launch of
    csrc/j2k_inv_stage.cu, or raises; a CPU tensor takes the plain lane."""
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
