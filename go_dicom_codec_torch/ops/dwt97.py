"""Irreversible 9/7 CDF lifting DWT (ISO/IEC 15444-1 Annex F), float32.

Port of ``go_dicom_codec_tpu/ops/dwt97.py``: α/β/γ/δ lifting with edge
clamps, K/invK normalization, vertical-first 2D, parity-aware windows. The
inverse is the exact mirror (low×K, high×1/K, then the negated lifting
steps). The multilevel functions return a new tensor and leave their
input as it was. Two lanes:

- the plain lane (``fwd97_1d`` … ``inv97_2d``,
  ``*_multilevel_plain``): torch functions with the reference's float32
  ops in the reference's order, on any device;
- the kernel lane: for a CUDA tensor the whole forward transform is one
  launch of ``csrc/j2k97_fwd_stage.cu`` and the whole inverse one launch
  of ``csrc/j2k97_inv_stage.cu`` (``fwd97_schedule`` and
  ``inv97_schedule`` are their level tables: one strip pass a level,
  register-resident, ``csrc/lifting97.cuh``), bit-exact against the
  plain lane.

``fwd97_multilevel``/``inv97_multilevel`` pick the kernel lane for a CUDA
tensor and the plain lane for a CPU tensor; any other device raises. The
codecs call ``ops/j2k97_fwd_stage.fwd97_stage`` and
``ops/j2k97_inv_stage.inv97_stage``, which fuse the DC shift, the ICT and
the decode's round, unshift and clip into the same launches.
"""

from __future__ import annotations

import functools

import torch

from .. import _kernels
from . import dwt53
from .dwt53 import _edge_left, _edge_right, _level_windows

ALPHA = -1.586134342
BETA = -0.052980118
GAMMA = 0.882911075
DELTA = 0.443506852
K = 1.230174105
INV_K = 0.812893066


def _predict_update(s, d, sn, dn, even: bool, c_pred: float, c_upd: float):
    """One (predict, update) lifting pair with OpenJPEG edge clamps."""
    if even:
        # d[i] += cp*(s[i] + s[i+1 clamped])
        s_next = _edge_right(s)[..., :dn]
        d = d + c_pred * (s[..., :dn] + s_next)
        # s[i] += cu*(d[i-1 clamped] + d[i clamped])
        d_prev, d_cur = _edge_left(d), d
        if sn == dn + 1:
            d_prev = torch.cat([d_prev, d[..., -1:]], dim=-1)
            d_cur = torch.cat([d_cur, d[..., -1:]], dim=-1)
        s = s + c_upd * (d_prev + d_cur)
    else:
        # d[i] += cp*(s[i-1 cl] + s[i cl])
        if dn == sn:
            s_im1, s_i = _edge_left(s), s
        else:  # dn == sn + 1
            s_im1 = torch.cat([s[..., :1], s], dim=-1)
            s_i = torch.cat([s, s[..., -1:]], dim=-1)
        d = d + c_pred * (s_im1 + s_i)
        # s[i] += cu*(d[i] + d[i+1 cl])
        d_i = d[..., :sn]
        d_ip1 = d[..., 1:sn + 1] if dn >= sn + 1 else _edge_right(d)
        s = s + c_upd * (d_i + d_ip1)
    return s, d


def fwd97_1d(x: torch.Tensor, even: bool) -> torch.Tensor:
    """Forward 9/7 along the last axis → [L | H] packed, float32."""
    w = x.shape[-1]
    x = x.to(torch.float32)
    if w <= 1:
        return x
    if even:
        s, d = x[..., 0::2], x[..., 1::2]
    else:
        d, s = x[..., 0::2], x[..., 1::2]
    sn, dn = s.shape[-1], d.shape[-1]
    s, d = _predict_update(s, d, sn, dn, even, ALPHA, BETA)
    s, d = _predict_update(s, d, sn, dn, even, GAMMA, DELTA)
    return torch.cat([s * INV_K, d * K], dim=-1)


def inv97_1d(x: torch.Tensor, even: bool) -> torch.Tensor:
    """Exact inverse of fwd97_1d."""
    w = x.shape[-1]
    x = x.to(torch.float32)
    if w <= 1:
        return x
    sn = (w + 1) // 2 if even else w // 2
    dn = w - sn
    s = x[..., :sn] * K
    d = x[..., sn:] * INV_K
    s, d = _predict_update(s, d, sn, dn, even, 0.0, -DELTA)
    s, d = _predict_update(s, d, sn, dn, even, -GAMMA, -BETA)
    s, d = _predict_update(s, d, sn, dn, even, -ALPHA, 0.0)
    out = torch.empty_like(x)
    if even:
        out[..., 0::2] = s
        out[..., 1::2] = d
    else:
        out[..., 0::2] = d
        out[..., 1::2] = s
    return out


def _cols(fn, x, even):
    return fn(x.transpose(-1, -2), even).transpose(-1, -2)


def fwd97_2d(x, even_row=True, even_col=True):
    """Vertical pass first, then horizontal."""
    if x.shape[-2] > 1:
        x = _cols(fwd97_1d, x, even_col)
    if x.shape[-1] > 1:
        x = fwd97_1d(x, even_row)
    return x


def inv97_2d(x, even_row=True, even_col=True):
    if x.shape[-1] > 1:
        x = inv97_1d(x, even_row)
    if x.shape[-2] > 1:
        x = _cols(inv97_1d, x, even_col)
    return x


def _multilevel(x: torch.Tensor, levels: int, x0: int, y0: int,
                level, inverse: bool) -> torch.Tensor:
    x = x.to(torch.float32, copy=True)
    wins = _level_windows(x.shape[-1], x.shape[-2], levels, x0, y0)
    for (w, h, lx0, ly0) in (reversed(wins) if inverse else wins):
        x[..., :h, :w] = level(x[..., :h, :w], lx0 % 2 == 0, ly0 % 2 == 0)
    return x


def fwd97_multilevel_plain(x: torch.Tensor, levels: int, x0: int = 0,
                           y0: int = 0) -> torch.Tensor:
    """The plain lane on any device: the kernel lane's reference."""
    return _multilevel(x, levels, x0, y0, fwd97_2d, inverse=False)


def inv97_multilevel_plain(x: torch.Tensor, levels: int, x0: int = 0,
                           y0: int = 0) -> torch.Tensor:
    """The plain lane on any device: the kernel lane's reference."""
    return _multilevel(x, levels, x0, y0, inv97_2d, inverse=True)


# ---- the 9/7 stages' level tables ---------------------------------------------

# The strip pass of csrc/lifting97.cuh: a strip is ``lanes`` lanes of a
# warp (8, 16 or 32 here; the kernel takes 4 too; a warp runs 32 / lanes
# strips side by side), each lane ``_PAIRS`` pairs of ext columns (a low
# one, the high one right of it: the kernel's kPairs), and yields
# 2·_PAIRS·lanes - 2·halo output columns: 120 forward and 116 inverse at
# 32 lanes. A level takes the fewest lanes whose strip covers its
# window's width, at most ``_LANES``.
_PAIRS = _kernels.STRIP_PAIRS
_LANES = 32
_MIN_LANES = 8
# The output rows of a segment, the vertical unit of a strip (even), one
# of ``_SEGS`` up to ``_SEG`` and never taller than the window. A segment
# also lifts a halo of rows above and below it, and its steps are a chain
# of S/2 + halo pairs of rows: a level takes the height whose rounds of
# work items over the warps that run it, times that chain, is the least,
# the tallest of equals. A grid level's items (all plane groups: a plane
# each, but a frame's components 0-2 one group at the level that runs the
# ICT) run on the kernel's resident warps, a head level's (one plane
# group) on one block's warps: both as the launch measures them for the
# kernel variant (``_kernels.j2k97_fwd_warps``, ``j2k97_inv_warps``),
# passed in as ``warps`` = (grid warps, block warps).
_SEG = 64
_SEGS = (64, 32, 16, 8, 4)
# The coarse levels whose window is at most ``_HEAD_SIDE`` samples each
# way run in the stage's head: one block a plane group, with block
# barriers only.
_HEAD_SIDE = 64
# The stages' halos: a sample a lifting step, four forward, six inverse
# (the reference's six, two of them with a coefficient of 0.0).
FWD97_HALO, INV97_HALO = _kernels.FWD97_HALO, _kernels.INV97_HALO


def strip_lanes(w: int, halo: int) -> int:
    """The lanes of a strip of a window ``w`` wide: the fewest whose
    2·_PAIRS·lanes - 2·halo output columns cover it, at most ``_LANES``."""
    lanes = min(_MIN_LANES, _LANES)
    while lanes < _LANES and 2 * _PAIRS * lanes - 2 * halo < w:
        lanes *= 2
    return lanes


def strip_items(w: int, h: int, lanes: int, seg: int, halo: int):
    """(strips, segments) of a level window: its work items."""
    return -(-w // (2 * _PAIRS * lanes - 2 * halo)), -(-h // seg)


def _seg_rows(w: int, h: int, lanes: int, halo: int, groups: int,
              warps: int) -> int:
    """The segment height of a level window over ``groups`` plane groups
    run by ``warps`` warps: the one of ``_SEGS`` (at most ``_SEG`` and the
    window's height rounded up to even) whose rounds of items times its
    chain of pairs is the least, the tallest of equals."""
    top = h + (h & 1)
    best = None
    for seg in sorted({min(s, top) for s in _SEGS if s <= _SEG}
                      or {min(_SEG, top)}, reverse=True):
        strips, segs = strip_items(w, h, lanes, seg, halo)
        per_round = warps * (32 // lanes)
        cost = -(-groups * strips * segs // per_round) * (seg // 2 + halo)
        if best is None or cost < best[0]:
            best = (cost, seg)
    return best[1]


def _strip_table(table53, halo: int, planes: int, warps, ict_row: int,
                 ict_groups: int):
    """A 9/7 stage's (scratch words a plane, rows) from the 5/3 stage's
    table of the same level windows (``dwt53.fwd_table``/``inv_table``):
    its scratch, order and columns 1-6, the kind by the 9/7's head rule,
    and each level's strip lanes and segment rows appended, for
    ``planes`` planes (``ict_groups`` plane groups at row ``ict_row``)
    on ``warps`` = (grid warps, block warps)."""
    _, words, rows53 = table53
    rows = []
    for i, row in enumerate(rows53):
        w, h = row[1], row[2]
        lanes = strip_lanes(w, halo)
        head = max(w, h) <= _HEAD_SIDE
        groups = ict_groups if i == ict_row else planes
        seg = (_seg_rows(w, h, lanes, halo, 1, warps[1]) if head else
               _seg_rows(w, h, lanes, halo, groups, warps[0]))
        rows.append((dwt53.ROW_KINDS["block" if head else "grid"],)
                    + tuple(row[1:]) + (lanes, seg))
    return (words, tuple(rows))


def _ict_groups(planes: int, comps: int, ict: bool) -> int:
    """The plane groups of the level that runs the ICT (the kernels'
    ``gdct::groups``): a frame's components 0-2 are one, each other
    component one more."""
    return planes // comps * (comps - 2) if ict else planes


def _stage_windows(width: int, height: int, levels: int, x0: int, y0: int):
    """The level windows of a 9/7 stage, finest first, less every 1×1
    window: the 9/7 leaves an axis of one sample as it is, at either
    parity (``fwd97_2d``, ``inv97_2d``), so such a window changes nothing
    (the 5/3 keeps those at odd parity: its ×2 rule)."""
    return [win for win in _level_windows(width, height, levels, x0, y0)
            if win[:2] != (1, 1)]


@functools.lru_cache(maxsize=256)
def fwd97_schedule(width: int, height: int, levels: int, x0: int = 0,
                   y0: int = 0, planes: int = 1, *, warps, comps: int = 1,
                   ict: bool = False):
    """The forward 9/7 of ``planes`` [H, W] planes, frames of ``comps``
    components (their components 0-2 one plane group at the first level
    when ``ict``), as csrc/j2k97_fwd_stage.cu runs it on ``warps`` = (grid
    warps, block warps) (``_kernels.j2k97_fwd_warps``): (scratch words a
    plane, rows), one row a level, finest first: (kind, w, h, even_x,
    even_y, in_off, out_off, lanes, seg).

    Each level is one strip pass (csrc/lifting97.cuh) over its window's
    strips of ``lanes`` lanes and segments of ``seg`` output rows. kind
    "grid" spreads them over the grid's warps, a grid barrier after the
    level; "block" (the coarse levels whose window is at most
    ``_HEAD_SIDE`` samples each way) runs in one block a plane group,
    with block barriers only. in_off is -1 for the stage's input (the
    first level), else where the level's w×h input lies in a plane's
    scratch; out_off is where its LL goes there, -1 for the output (the
    last level). The scratch is the 5/3 stage's (``dwt53.fwd_table``):
    two areas in turns, so that no level writes where it reads.
    """
    return _strip_table(
        dwt53.fwd_table(_stage_windows(width, height, levels, x0, y0)),
        FWD97_HALO, planes, warps, 0, _ict_groups(planes, comps, ict))


@functools.lru_cache(maxsize=256)
def inv97_schedule(width: int, height: int, levels: int, x0: int = 0,
                   y0: int = 0, planes: int = 1, *, warps, comps: int = 1,
                   ict: bool = False):
    """The inverse 9/7 of ``planes`` [H, W] planes as
    csrc/j2k97_inv_stage.cu runs it on ``warps``
    (``_kernels.j2k97_inv_warps``; with ``ict``, the inverse ICT at the
    finest level): (scratch words a plane, rows), one
    row a level, coarsest first, as ``fwd97_schedule``: the head is the
    coarsest levels ("block" rows); in_off is -1 where the level's LL lies
    in the input (the coarsest level), else where the level above wrote
    it in a plane's scratch; out_off is where the level's w×h
    reconstruction goes there, -1 for the output (the finest level). The
    scratch is the 5/3 stage's (``dwt53.inv_table``, whose head arguments
    give kinds that this table replaces)."""
    wins = _stage_windows(width, height, levels, x0, y0)
    return _strip_table(dwt53.inv_table(wins, 0, None), INV97_HALO, planes,
                        warps, len(wins) - 1, _ict_groups(planes, comps,
                                                          ict))


# ---- multilevel ---------------------------------------------------------------

def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"9/7 DWT: no lane for device {x.device}")


def _fwd97_kernel(x: torch.Tensor, levels: int, x0: int,
                  y0: int) -> torch.Tensor:
    """One launch of the 9/7 forward stage, shift 0 and no ICT (a type
    the stage does not read is cast to float32, as the plain lane)."""
    from .j2k97_fwd_stage import _fwd97_stage_kernel

    if x.dtype not in _kernels.FWD97_STAGE_DTYPES:
        x = x.to(torch.float32)
    return _fwd97_stage_kernel(x, 0, levels, x0, y0)


def _inv97_kernel(x: torch.Tensor, levels: int, x0: int,
                  y0: int) -> torch.Tensor:
    """One launch of the 9/7 inverse stage's "coeffs" form."""
    from .j2k97_inv_stage import _inv97_stage_kernel

    return _inv97_stage_kernel(x, levels, x0, y0, epilogue="coeffs")


def fwd97_multilevel(x: torch.Tensor, levels: int, x0: int = 0,
                     y0: int = 0) -> torch.Tensor:
    """Multilevel packed decomposition of [..., H, W] into a new float32
    tensor, finest level first. A CUDA tensor takes one launch of
    csrc/j2k97_fwd_stage.cu, or raises; a CPU tensor the plain lane."""
    return (_fwd97_kernel if _on_cuda(x) else fwd97_multilevel_plain)(
        x, levels, x0, y0)


def inv97_multilevel(x: torch.Tensor, levels: int, x0: int = 0,
                     y0: int = 0) -> torch.Tensor:
    """Multilevel packed reconstruction into a new float32 tensor,
    coarsest level first. A CUDA tensor takes one launch of
    csrc/j2k97_inv_stage.cu, or raises; a CPU tensor the plain lane."""
    return (_inv97_kernel if _on_cuda(x) else inv97_multilevel_plain)(
        x, levels, x0, y0)


# OpenJPEG 9/7 per-band L2 norms, used for step-size derivation.
DWT97_NORMS = (
    (1.000, 1.965, 4.177, 8.403, 16.90, 33.84, 67.69, 135.3, 270.6, 540.9),
    (2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0, 0.0),
    (2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0, 0.0),
    (2.080, 3.865, 8.307, 17.18, 34.71, 69.59, 139.3, 278.6, 557.2, 0.0),
)


def dwt97_norm(level: int, orient: int) -> float:
    level = max(level, 0)
    if orient == 0:
        level = min(level, 9)
    else:
        level = min(level, 8)
    if not (0 <= orient <= 3):
        return 1.0
    return DWT97_NORMS[orient][level]


# OpenJPEG 5/3 per-band L2 norms (opj_dwt_norms), used for NMSEDEC
# distortion weighting.
DWT53_NORMS = (
    (1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3),
    (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9, 0.0),
    (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9, 0.0),
    (.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93, 0.0),
)


def dwt53_norm(level: int, orient: int) -> float:
    level = max(level, 0)
    if orient == 0:
        level = min(level, 9)
    else:
        level = min(level, 8)
    if not (0 <= orient <= 3):
        return 1.0
    return DWT53_NORMS[orient][level]
