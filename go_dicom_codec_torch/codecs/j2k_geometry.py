"""JPEG 2000 tile/resolution/band/precinct/code-block geometry (Annex B).

Role of reference jpeg2000/encoder.go:3059-3286 (getSubbandsForResolution,
partitionIntoCodeBlocks, precinct index math) and t2/geometry.go — but
computed from the ISO B.5/B.6/B.7 coordinate formulas, parity-aware, and
mapped onto the packed-Mallat layout produced by ops/dwt53.py so whole
subbands can be sliced out of the device array in one step.

Band numbering: 0=LL (resolution 0 only), 1=HL, 2=LH, 3=HH.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..ops.dwt53 import low_len


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def resolution_rect(tx0: int, ty0: int, tx1: int, ty1: int,
                    num_levels: int, r: int) -> Tuple[int, int, int, int]:
    """Tile bounds in resolution-r coordinates (B.5 eq B-14)."""
    s = num_levels - r
    d = 1 << s
    return (ceil_div(tx0, d), ceil_div(ty0, d),
            ceil_div(tx1, d), ceil_div(ty1, d))


def band_rect(tx0: int, ty0: int, tx1: int, ty1: int, num_levels: int,
              r: int, band: int) -> Tuple[int, int, int, int]:
    """Band bounds in band coordinates (B.5 eq B-15)."""
    if r == 0:
        assert band == 0
        d = 1 << num_levels
        return (ceil_div(tx0, d), ceil_div(ty0, d),
                ceil_div(tx1, d), ceil_div(ty1, d))
    n = num_levels - r  # decomposition levels remaining after this one
    xob = 1 if band in (1, 3) else 0
    yob = 1 if band in (2, 3) else 0
    d = 1 << (n + 1)
    ox = (1 << n) * xob
    oy = (1 << n) * yob
    return (ceil_div(tx0 - ox, d), ceil_div(ty0 - oy, d),
            ceil_div(tx1 - ox, d), ceil_div(ty1 - oy, d))


def band_gain(band: int) -> int:
    """log2 gain of the reversible transform per band (0/1/1/2)."""
    return {0: 0, 1: 1, 2: 1, 3: 2}[band]


@dataclass
class BandGeom:
    resolution: int      # resolution level r (0..num_levels)
    band: int            # 0 LL / 1 HL / 2 LH / 3 HH
    x0: int
    y0: int
    x1: int
    y1: int
    # location of this band inside the packed-Mallat tile array
    row_off: int
    col_off: int

    @property
    def width(self) -> int:
        return self.x1 - self.x0

    @property
    def height(self) -> int:
        return self.y1 - self.y0

    @property
    def orient(self) -> int:
        return self.band


@dataclass
class BlockGeom:
    """One code-block inside a precinct band."""
    cbx: int             # column index within the precinct's block grid
    cby: int
    x0: int              # band coordinates
    y0: int
    x1: int
    y1: int

    @property
    def width(self) -> int:
        return self.x1 - self.x0

    @property
    def height(self) -> int:
        return self.y1 - self.y0


@dataclass
class PrecinctBandGeom:
    band: BandGeom
    ncbw: int            # code-block grid dims within this precinct band
    ncbh: int
    blocks: List[BlockGeom] = field(default_factory=list)  # raster order


@dataclass
class PrecinctGeom:
    index: int           # raster index within the resolution's precinct grid
    px: int              # precinct grid position
    py: int
    x0: int              # resolution coordinates (clipped to resolution rect)
    y0: int
    x1: int
    y1: int
    bands: List[PrecinctBandGeom] = field(default_factory=list)


@dataclass
class ResolutionGeom:
    r: int
    x0: int
    y0: int
    x1: int
    y1: int
    bands: List[BandGeom] = field(default_factory=list)
    precincts: List[PrecinctGeom] = field(default_factory=list)
    npw: int = 0         # precinct grid dims
    nph: int = 0


def packed_band_layout(tx0: int, ty0: int, tx1: int, ty1: int,
                       num_levels: int) -> List[BandGeom]:
    """All bands with their offsets into the packed-Mallat array.

    The packed layout after ops/dwt53.fwd53_multilevel: at each level the
    current LL window [0:h, 0:w] splits into [[LL, HL], [LH, HH]] with the
    low-pass count given by the window origin parity (dwt53.low_len).
    """
    bands: List[BandGeom] = []
    w = tx1 - tx0
    h = ty1 - ty0
    x0, y0 = tx0, ty0
    for level in range(1, num_levels + 1):
        r = num_levels - level + 1  # bands of this decomposition sit at res r
        # zero-size windows fall through: low_len(0)=0 gives empty bands
        # with matching Annex-B rects; 1-sample windows keep splitting
        # (odd origins move the sample into this level's high band —
        # mirrors ops/dwt53._level_windows)
        snx = low_len(w, x0 % 2 == 0)
        sny = low_len(h, y0 % 2 == 0)
        for band in (1, 2, 3):
            bx0, by0, bx1, by1 = band_rect(tx0, ty0, tx1, ty1, num_levels,
                                           r, band)
            row_off = 0 if band == 1 else sny
            col_off = snx if band in (1, 3) else 0
            bw, bh = bx1 - bx0, by1 - by0
            exp_w = (w - snx) if band in (1, 3) else snx
            exp_h = sny if band == 1 else (h - sny)
            assert (bw, bh) == (exp_w, exp_h), (
                f"band geometry mismatch r={r} band={band}: "
                f"rect {bw}x{bh} vs packed {exp_w}x{exp_h}")
            bands.append(BandGeom(r, band, bx0, by0, bx1, by1,
                                  row_off, col_off))
        w, h = snx, sny
        x0 = (x0 + 1) >> 1
        y0 = (y0 + 1) >> 1
    # LL at resolution 0
    bx0, by0, bx1, by1 = band_rect(tx0, ty0, tx1, ty1, num_levels, 0, 0)
    assert (bx1 - bx0, by1 - by0) == (w, h)
    bands.append(BandGeom(0, 0, bx0, by0, bx1, by1, 0, 0))
    return bands


_GEOM_CACHE: dict = {}
_GEOM_CACHE_MAX = 64


def build_tile_geometry(tx0: int, ty0: int, tx1: int, ty1: int,
                        num_levels: int, cb_w: int, cb_h: int,
                        precinct_exps) -> List[ResolutionGeom]:
    """Full geometry for one tile component: resolutions → precincts →
    bands → code-blocks (reference encoder.go:3059-3286 equivalents).

    precinct_exps: callable r → (ppx, ppy).

    Memoized: the result is pure geometry that no consumer mutates
    (per-call coder state lives in BlockState/PrecinctState built FROM
    it), and multi-frame encode/decode rebuilds the identical layout
    for every frame.
    """
    exps = tuple(precinct_exps(r) for r in range(num_levels + 1))
    key = (tx0, ty0, tx1, ty1, num_levels, cb_w, cb_h, exps)
    cached = _GEOM_CACHE.get(key)
    if cached is not None:
        return cached
    precinct_exps = lambda r: exps[r]  # noqa: E731
    all_bands = packed_band_layout(tx0, ty0, tx1, ty1, num_levels)
    resolutions: List[ResolutionGeom] = []
    for r in range(num_levels + 1):
        rx0, ry0, rx1, ry1 = resolution_rect(tx0, ty0, tx1, ty1,
                                             num_levels, r)
        res = ResolutionGeom(r=r, x0=rx0, y0=ry0, x1=rx1, y1=ry1)
        res.bands = [b for b in all_bands if b.resolution == r]
        ppx, ppy = precinct_exps(r)
        if rx1 > rx0 and ry1 > ry0:
            p0x = rx0 >> ppx
            p1x = ceil_div(rx1, 1 << ppx)
            p0y = ry0 >> ppy
            p1y = ceil_div(ry1, 1 << ppy)
            res.npw = p1x - p0x
            res.nph = p1y - p0y
        else:
            res.npw = res.nph = 0
            p0x = p0y = 0
        # effective codeblock dims (capped by precinct size; B.7)
        shift = 1 if r > 0 else 0
        eff_cb_w = min(cb_w, 1 << max(ppx - shift, 0))
        eff_cb_h = min(cb_h, 1 << max(ppy - shift, 0))
        idx = 0
        for pj in range(res.nph):
            for pi in range(res.npw):
                px = p0x + pi
                py = p0y + pj
                gx0 = max(px << ppx, rx0)
                gy0 = max(py << ppy, ry0)
                gx1 = min((px + 1) << ppx, rx1)
                gy1 = min((py + 1) << ppy, ry1)
                prec = PrecinctGeom(index=idx, px=px, py=py, x0=gx0, y0=gy0,
                                    x1=gx1, y1=gy1)
                idx += 1
                for band in res.bands:
                    # precinct bounds in band coordinates
                    if r == 0:
                        bpx0, bpy0, bpx1, bpy1 = gx0, gy0, gx1, gy1
                    else:
                        bpx0 = ceil_div(gx0, 2)
                        bpy0 = ceil_div(gy0, 2)
                        bpx1 = ceil_div(gx1, 2)
                        bpy1 = ceil_div(gy1, 2)
                        # precinct grid aligns to powers of two, so floor
                        # division also lands on the band-precinct origin
                        bpx0 = gx0 >> 1
                        bpy0 = gy0 >> 1
                        bpx1 = ceil_div(gx1, 2)
                        bpy1 = ceil_div(gy1, 2)
                    bx0 = max(band.x0, bpx0)
                    by0 = max(band.y0, bpy0)
                    bx1 = min(band.x1, bpx1)
                    by1 = min(band.y1, bpy1)
                    pb = PrecinctBandGeom(band=band, ncbw=0, ncbh=0)
                    if bx1 > bx0 and by1 > by0:
                        c0x = bx0 // eff_cb_w
                        c1x = ceil_div(bx1, eff_cb_w)
                        c0y = by0 // eff_cb_h
                        c1y = ceil_div(by1, eff_cb_h)
                        pb.ncbw = c1x - c0x
                        pb.ncbh = c1y - c0y
                        for cy in range(c0y, c1y):
                            for cx in range(c0x, c1x):
                                blk_x0 = max(cx * eff_cb_w, bx0)
                                blk_y0 = max(cy * eff_cb_h, by0)
                                blk_x1 = min((cx + 1) * eff_cb_w, bx1)
                                blk_y1 = min((cy + 1) * eff_cb_h, by1)
                                pb.blocks.append(BlockGeom(
                                    cbx=cx - c0x, cby=cy - c0y,
                                    x0=blk_x0, y0=blk_y0,
                                    x1=blk_x1, y1=blk_y1))
                    prec.bands.append(pb)
                res.precincts.append(prec)
        resolutions.append(res)
    if len(_GEOM_CACHE) >= _GEOM_CACHE_MAX:
        _GEOM_CACHE.clear()
    _GEOM_CACHE[key] = resolutions
    return resolutions
