"""JPEG 2000 region-of-interest coding (MaxShift, ISO 15444-1 Annex H).

Role of reference jpeg2000/roi.go, roi_config.go, roi_mask.go, roi_geom.go:
Rectangle/Polygon/Mask regions, full-resolution bitmap rasterization
(polygon scanline), downsample-to-subband masks, RGN marker shifts.

Encode: ROI wavelet coefficients are scaled up by 2^Srgn (Srgn chosen so
every background magnitude stays below 2^Srgn); the RGN marker carries
Srgn per component. Decode is mask-free: any magnitude ≥ 2^Srgn is ROI
and shifts back down (tile_decoder.go:723-742 equivalent).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ROIRegion:
    """One region: rectangle, polygon, or explicit mask
    (reference roi_config.go:28-120 shapes)."""
    shape: str = "rect"                      # rect | polygon | mask
    rect: Optional[Tuple[int, int, int, int]] = None   # x, y, w, h
    polygon: Optional[Sequence[Tuple[int, int]]] = None
    mask: Optional[np.ndarray] = None        # bool [H, W] full-res
    style: str = "maxshift"                  # maxshift | general
    components: Optional[List[int]] = None   # None = all components

    def rasterize(self, width: int, height: int) -> np.ndarray:
        if self.shape == "rect":
            x, y, w, h = self.rect
            m = np.zeros((height, width), dtype=bool)
            m[max(y, 0):min(y + h, height), max(x, 0):min(x + w, width)] = True
            return m
        if self.shape == "polygon":
            return rasterize_polygon(self.polygon, width, height)
        if self.shape == "mask":
            m = np.asarray(self.mask, dtype=bool)
            if m.shape != (height, width):
                raise ValueError("ROI mask shape mismatch")
            return m
        raise ValueError(f"unknown ROI shape {self.shape!r}")


def rasterize_polygon(points: Sequence[Tuple[int, int]], width: int,
                      height: int) -> np.ndarray:
    """Even-odd scanline fill (reference roi_mask.go:180 rasterizePolygon)."""
    mask = np.zeros((height, width), dtype=bool)
    pts = [(float(x), float(y)) for (x, y) in points]
    n = len(pts)
    if n < 3:
        return mask
    for y in range(height):
        yc = y + 0.5
        xs: List[float] = []
        for i in range(n):
            x1, y1 = pts[i]
            x2, y2 = pts[(i + 1) % n]
            if (y1 <= yc < y2) or (y2 <= yc < y1):
                xs.append(x1 + (yc - y1) * (x2 - x1) / (y2 - y1))
        xs.sort()
        for i in range(0, len(xs) - 1, 2):
            a = max(int(np.ceil(xs[i] - 0.5)), 0)
            b = min(int(np.floor(xs[i + 1] - 0.5)) + 1, width)
            if b > a:
                mask[y, a:b] = True
    return mask


def combined_mask(regions: Sequence[ROIRegion], width: int,
                  height: int, component: Optional[int] = None
                  ) -> np.ndarray:
    m = np.zeros((height, width), dtype=bool)
    for r in regions:
        if component is not None and r.components is not None \
                and component not in r.components:
            continue
        m |= r.rasterize(width, height)
    return m


# ---- private ROI COM metadata ("JP2ROI" v1 — reference encoder.go
#      writeCOM :1819-1914, decoder.go parseROIFromCOMData :964-1060) --------

ROI_COM_MAGIC = b"JP2ROI"


def write_roi_com(regions: Sequence[ROIRegion], ncomp: int) -> bytes:
    """COM payload (after Rcom) carrying ROI geometry so a decoder can
    rebuild General-Scaling masks without external parameters."""
    import struct
    out = bytearray(ROI_COM_MAGIC)
    out.append(1)  # version
    out += struct.pack(">H", len(regions))
    for r in regions:
        shape = {"rect": 0, "polygon": 1, "mask": 2}[r.shape]
        out.append(shape)
        comps = list(r.components) if r.components else list(range(ncomp))
        out.append(len(comps))
        out += bytes(comps)
        if shape == 0:
            x, y, w, h = r.rect
            out += struct.pack(">IIII", x, y, x + w, y + h)
        elif shape == 1:
            out += struct.pack(">H", len(r.polygon))
            for (x, y) in r.polygon:
                out += struct.pack(">II", int(x), int(y))
        else:
            # mask: dimensions only (raw mask too large for COM; the
            # reference does the same — decoder needs an external mask)
            mh, mw = r.mask.shape
            out += struct.pack(">II", mw, mh)
    return bytes(out)


def parse_roi_com(payload: bytes) -> Optional[List[ROIRegion]]:
    """Parse a JP2ROI COM payload → regions, or None if not ours."""
    import struct
    if len(payload) < 9 or payload[:6] != ROI_COM_MAGIC or payload[6] != 1:
        return None
    n = struct.unpack_from(">H", payload, 7)[0]
    off = 9
    regions: List[ROIRegion] = []
    try:
        for _ in range(n):
            shape = payload[off]
            ncomps = payload[off + 1]
            off += 2
            comps = list(payload[off : off + ncomps])
            off += ncomps
            if shape == 0:
                x0, y0, x1, y1 = struct.unpack_from(">IIII", payload, off)
                off += 16
                regions.append(ROIRegion(shape="rect",
                                         rect=(x0, y0, x1 - x0, y1 - y0),
                                         components=comps))
            elif shape == 1:
                npts = struct.unpack_from(">H", payload, off)[0]
                off += 2
                pts = []
                for _ in range(npts):
                    x, y = struct.unpack_from(">II", payload, off)
                    off += 8
                    pts.append((x, y))
                regions.append(ROIRegion(shape="polygon", polygon=pts,
                                         components=comps))
            else:
                off += 8  # mask placeholder: dimensions only
    except struct.error:
        return None
    return regions


def band_roi_mask(full_mask: np.ndarray, tx0: int, ty0: int,
                  num_levels: int, resolution: int, band: int,
                  band_rect_: Tuple[int, int, int, int]) -> np.ndarray:
    """Project the tile's full-res mask onto one subband (OR-pooled over
    each coefficient's step×step image block — reference
    roi_mask.go:60-110 downsample semantics, no filter-support dilation;
    MaxShift stays losslessly invertible because the decoder unshifts by
    magnitude, and keeping the shifted set tight preserves the rate
    advantage of the background).

    full_mask is the tile-local mask [th, tw]; returns [bh, bw] bool.
    """
    bx0, by0, bx1, by1 = band_rect_
    bw, bh = bx1 - bx0, by1 - by0
    if bw <= 0 or bh <= 0:
        return np.zeros((max(bh, 0), max(bw, 0)), dtype=bool)
    # Subbands at resolution r > 0 come from DWT level num_levels−r+1 and
    # decimate the image grid by 2^level; the r = 0 LL band by 2^num_levels.
    n = num_levels - resolution + 1 if resolution > 0 else num_levels
    step = 1 << n
    th, tw = full_mask.shape
    out = np.zeros((bh, bw), dtype=bool)
    # band sample (bx, by) draws on tile samples in
    # ((bx*2^n .. (bx+1)*2^n) − tile offset), offset by the band's
    # half-step phase (HL/HH in x, LH/HH in y)
    xob = (1 << n) // 2 if band in (1, 3) and resolution > 0 else 0
    yob = (1 << n) // 2 if band in (2, 3) and resolution > 0 else 0
    for by in range(bh):
        y_lo = max((by0 + by) * step + yob - ty0, 0)
        y_hi = min((by0 + by + 1) * step + yob - ty0, th)
        if y_hi <= y_lo:
            continue
        rowband = full_mask[y_lo:y_hi]
        for bx in range(bw):
            x_lo = max((bx0 + bx) * step + xob - tx0, 0)
            x_hi = min((bx0 + bx + 1) * step + xob - tx0, tw)
            if x_hi <= x_lo:
                continue
            if rowband[:, x_lo:x_hi].any():
                out[by, bx] = True
    return out


def apply_maxshift(coeffs_band: np.ndarray, mask_band: np.ndarray,
                   shift: int) -> np.ndarray:
    """Scale ROI coefficients up by 2^shift (encoder side)."""
    out = coeffs_band.astype(np.int64)
    out[mask_band] <<= shift
    return out


def unshift_maxshift(coeffs_band: np.ndarray, shift: int) -> np.ndarray:
    """Scale any magnitude ≥ 2^shift back down (decoder side)."""
    v = coeffs_band.astype(np.int64)
    mag = np.abs(v)
    is_roi = mag >= (1 << shift)
    down = np.sign(v) * (mag >> shift)
    return np.where(is_roi, down, v).astype(np.int32)


def unshift_general(coeffs_band: np.ndarray, mask_band: np.ndarray,
                    shift: int) -> np.ndarray:
    """General Scaling inverse: divide masked coefficients by 2^shift,
    truncating toward zero (reference
    applyInverseGeneralScalingMasked tile_decoder.go:1092-1110)."""
    v = coeffs_band.astype(np.int64)
    mag = np.abs(v)
    down = np.sign(v) * (mag >> shift)
    return np.where(mask_band, down, v)
