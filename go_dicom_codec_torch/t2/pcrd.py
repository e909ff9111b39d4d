"""Post-compression rate-distortion layer allocation (Taubman PCRD-opt).

Role of reference jpeg2000/rate_distortion.go: convex-hull pass slopes,
lambda/threshold bisection against layer byte budgets, and layer-rate →
budget conversion (ComputeLayerBudgets / AllocateLayersRateDistortionPasses).

Distortion uses the T.800 J.4 NMSEDEC sums accumulated per coding pass by
the T1 encoder (entropy/ebcot.py tables; reference t1/nmsedec.go +
encoder_layered.go:120-130), weighted per band by (norm·Δ/gain)²/8192
(reference openJPEGDistortionWeight encoder.go:3455). A bitplane-energy
proxy (4^bitplane · coded bytes) remains as fallback for callers without
NMSEDEC data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass(slots=True)
class PassPoint:
    rate: int          # cumulative bytes at end of this pass
    slope: float       # distortion decrease per byte (convex-hulled)


# exact in binary float, so table lookup == 4.0 ** bp for every plane
_POW4 = [4.0 ** i for i in range(64)]


def pass_slopes(pass_rates: Sequence[int], pass_bitplanes: Sequence[int],
                pass_nmsedecs: Optional[Sequence[int]] = None,
                weight: float = 1.0) -> List[PassPoint]:
    """Convex-hull slopes for one block's passes
    (reference rate_distortion.go:207-407 computeIncrementals).

    With pass_nmsedecs, distortion decrease per pass is the real NMSEDEC
    measure nmsedec·weight·4^bitplane; otherwise a bitplane-energy proxy.
    """
    n = len(pass_rates)
    if n == 0:
        return []
    rates = list(pass_rates)
    dvals = [0.0] * n  # cumulative distortion drop through pass i
    cum = 0.0
    prev_rate = 0
    nms_len = len(pass_nmsedecs) if pass_nmsedecs is not None else -1
    for i in range(n):
        ri = rates[i]
        d_rate = ri - prev_rate
        if d_rate < 0:
            d_rate = 0
        prev_rate = ri
        bp = pass_bitplanes[i]
        p4 = _POW4[bp] if 0 <= bp < 64 else 4.0 ** bp
        if i < nms_len:
            cum += float(pass_nmsedecs[i]) * weight * p4
        else:
            cum += p4 * (d_rate if d_rate > 0.01 else 0.01)
        dvals[i] = cum
    # convex hull: slopes must be decreasing; merge violating passes
    hull: List[int] = []
    for i in range(n):
        hull.append(i)
        while len(hull) >= 2:
            i2, i1 = hull[-1], hull[-2]
            r1, d1 = rates[i1], dvals[i1]
            r2, d2 = rates[i2], dvals[i2]
            if len(hull) == 2:
                r0, d0 = 0, 0.0
            else:
                i0 = hull[-3]
                r0, d0 = rates[i0], dvals[i0]
            s_prev = (d1 - d0) / max(r1 - r0, 1)
            s_cur = (d2 - d1) / max(r2 - r1, 1)
            if s_cur > s_prev:
                hull.pop(-2)  # previous point is below the hull
            else:
                break
    on_hull = bytearray(n)
    for i in hull:
        on_hull[i] = 1
    out: List[PassPoint] = [None] * n  # type: ignore[list-item]
    prev_r, prev_d = 0, 0.0
    cur_slope = float("inf")
    for i in range(n):
        if on_hull[i]:
            r, d = rates[i], dvals[i]
            cur_slope = (d - prev_d) / max(r - prev_r, 1)
            prev_r, prev_d = r, d
        out[i] = PassPoint(rate=rates[i], slope=cur_slope)
    return out


def allocate_layers(blocks: List[List[PassPoint]], budgets: List[int],
                    measure=None) -> List[List[int]]:
    """Threshold allocation: per block, cumulative pass counts per layer.

    budgets: cumulative byte targets per layer (last = total available).
    Mirrors reference FindOptimalLambda bisection (:408-540).

    measure: optional callable(counts_by_layer) → measured cumulative
    bytes through the candidate layer, where counts_by_layer[l][bi] is
    block bi's cumulative pass count at layer l. When given, the
    bisection targets actual emitted bytes — packet headers included —
    like OpenJPEG's measured-packet threshold search (reference
    rate_distortion.go "OpenJPEG threshold w/ measured packet bytes").
    Default measures pass bytes only.
    """
    n_layers = len(budgets)
    slopes = sorted({p.slope for b in blocks for p in b if p.slope > 0},
                    reverse=True)
    result = [[0] * n_layers for _ in blocks]

    def take_at(thr: float) -> List[int]:
        counts = []
        for b in blocks:
            take = 0
            for i, p in enumerate(b):
                if p.slope >= thr:
                    take = i + 1
            counts.append(take)
        return counts

    layer_counts: List[List[int]] = []  # finalized per-layer counts
    prev_counts = [0] * len(blocks)

    def size_of(counts: List[int]) -> int:
        counts = [max(c, p) for c, p in zip(counts, prev_counts)]
        if measure is not None:
            return measure(layer_counts + [counts])
        return sum(b[c - 1].rate for b, c in zip(blocks, counts) if c)

    for li, budget in enumerate(budgets):
        if li == n_layers - 1 and budget <= 0:
            # final layer: everything
            counts = [len(b) for b in blocks]
            for bi in range(len(blocks)):
                result[bi][li] = counts[bi]
            layer_counts.append(counts)
            continue
        # bisect over distinct slopes for the largest threshold fitting
        lo, hi = 0, len(slopes)
        best = None
        while lo < hi:
            mid = (lo + hi) // 2
            thr = slopes[mid] if mid < len(slopes) else 0.0
            if size_of(take_at(thr)) <= budget:
                best = thr
                lo = mid + 1
            else:
                hi = mid
        counts = list(prev_counts) if best is None else take_at(best)
        for bi in range(len(blocks)):
            counts[bi] = max(counts[bi], prev_counts[bi])
            result[bi][li] = counts[bi]
        layer_counts.append(counts)
        prev_counts = counts
    # an unbudgeted final layer (rate 0 / take-all) ships everything;
    # a budgeted one keeps its bisected truncation (target-ratio mode)
    if budgets[-1] <= 0:
        for bi, b in enumerate(blocks):
            result[bi][-1] = len(b)
    return result


def layer_budgets_from_rates(total_pixels: int, bit_depth: int,
                             layer_rates: Sequence[float],
                             available: int) -> List[int]:
    """Compression ratios → cumulative byte budgets
    (reference ComputeLayerBudgets :438 / openJPEGLayerRates)."""
    raw = total_pixels * bit_depth / 8.0
    out = []
    for r in layer_rates:
        if r <= 0:
            out.append(0)  # 0 = no budget (take all)
        else:
            out.append(int(raw / r))
    # monotone nondecreasing, capped at available; a trailing 0 stays 0
    # (take-all sentinel for allocate_layers — a budgeted final layer
    # truncates, target-ratio mode)
    prev = 0
    for i in range(len(out)):
        if out[i] == 0:
            if i == len(out) - 1:
                break
            out[i] = available
        out[i] = max(prev, min(out[i], available))
        prev = out[i]
    return out
