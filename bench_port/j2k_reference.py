"""A plain decoder of reversible JPEG 2000 codestreams (ISO/IEC 15444-1),
written from the standard to judge what an encode produced.

It reads what a lossless DICOM encode of one gray frame writes: one tile,
one component, any number of layers in any progression with one precinct
a resolution, code-blocks coded with or without the arithmetic coder
bypass (Table A.19 bit 0), no quantization and the reversible 5/3. It
refuses anything else. Tier-2 (B.10), the MQ decoder (C.3), the three
coding passes (D.3) and the inverse 5/3 (F.3) are plain Python and NumPy;
nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

# (Qe, NMPS, NLPS, SWITCH) of T.800 Table C.2
_QE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))

CTX_RL, CTX_UNI = 17, 18


class StreamError(ValueError):
    """The codestream is not one this decoder reads."""


# ---- the entropy decoders --------------------------------------------------

class MQDecoder:
    """T.800 C.3, over one codeword segment; the contexts belong to the
    code-block and outlive the segment."""

    def __init__(self, data: bytes, index: list, mps: list) -> None:
        self.d = bytes(data) + b"\xff\xff"
        self.index, self.mps = index, mps
        self.bp = 0
        self.c = self.d[0] << 16
        self.ct = 0
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self) -> None:
        d, bp = self.d, self.bp
        if d[bp] == 0xFF:
            if d[bp + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += d[bp + 1] << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += d[bp + 1] << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        i = self.index[cx]
        qe, nmps, nlps, switch = _QE[i]
        a = self.a - qe
        if (self.c >> 16) < qe:
            if a < qe:
                d = self.mps[cx]
                self.index[cx] = nmps
            else:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] = d
                self.index[cx] = nlps
            a = qe
        else:
            self.c -= qe << 16
            if a & 0x8000:
                self.a = a
                return self.mps[cx]
            if a < qe:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] = d
                self.index[cx] = nlps
            else:
                d = self.mps[cx]
                self.index[cx] = nmps
        c, ct = self.c, self.ct
        while True:
            if ct == 0:
                self.c, self.ct = c, ct
                self._bytein()
                c, ct = self.c, self.ct
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a & 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct
        return d


class RawDecoder:
    """A bypassed segment (D.6): bits MSB first, seven from a byte that
    follows 0xFF."""

    def __init__(self, data: bytes) -> None:
        self.d = bytes(data)
        self.pos = 0
        self.buf = 0
        self.n = 0
        self.last = 0

    def bit(self) -> int:
        if self.n == 0:
            b = self.d[self.pos] if self.pos < len(self.d) else 0xFF
            self.pos += 1
            self.n = 7 if self.last == 0xFF else 8
            self.buf, self.last = b, b
        self.n -= 1
        return (self.buf >> self.n) & 1


# ---- contexts (T.800 Tables D.1, D.3) --------------------------------------

def _zc(h: int, v: int, d: int, orient: int) -> int:
    if orient == 1:          # HL: the roles of H and V swap
        h, v = v, h
    if orient != 3:          # LL, LH and HL
        if h == 2:
            return 8
        if h == 1:
            return 7 if v else (6 if d else 5)
        if v:
            return 4 if v == 2 else 3
        return 2 if d >= 2 else d
    hv = h + v
    if d >= 3:
        return 8
    if d == 2:
        return 7 if hv else 6
    if d == 1:
        return 5 if hv >= 2 else (4 if hv == 1 else 3)
    return 2 if hv >= 2 else hv


# [orient][(h * 3 + v) * 5 + min(d, 4)]
ZC = [[_zc(h, v, d, o) for h in range(3) for v in range(3) for d in range(5)]
      for o in range(4)]
# [(hc + 1) * 3 + (vc + 1)] -> (context, xor bit)
SC = [(13, 1), (12, 1), (11, 1), (10, 1), (9, 0), (10, 0), (11, 0),
      (12, 0), (13, 0)]


def decode_block(segments: List[bytes], passes: int, planes: int, w: int,
                 h: int, orient: int, bypass: bool) -> np.ndarray:
    """Decode one code-block's ``passes`` coding passes of ``planes``
    magnitude bit-planes: [h, w] int64 coefficients."""
    W = w + 2
    size = (h + 2) * W
    sig = [0] * size          # 1 when significant
    sgn = [0] * size          # +1 / -1 once significant
    mag = [0] * size
    visited = [0] * size      # coded in this bit-plane's first pass
    refined = [0] * size
    index = [0] * 19
    mps = [0] * 19
    index[0], index[CTX_RL], index[CTX_UNI] = 4, 3, 46
    zc = ZC[orient]
    order = []                # the stripe scan: (position, stripe top)
    for y0 in range(0, h, 4):
        for x in range(w):
            for y in range(y0, min(y0 + 4, h)):
                order.append(((y + 1) * W + x + 1, y == y0 and y0 + 4 <= h))

    def counts(p):
        hh = sig[p - 1] + sig[p + 1]
        vv = sig[p - W] + sig[p + W]
        dd = sig[p - W - 1] + sig[p - W + 1] + sig[p + W - 1] + sig[p + W + 1]
        return hh, vv, dd

    def sign_of(p, dec, raw):
        if raw is not None:
            return -1 if raw.bit() else 1
        hc = sgn[p - 1] + sgn[p + 1]
        vc = sgn[p - W] + sgn[p + W]
        hc = 1 if hc > 0 else (-1 if hc < 0 else 0)
        vc = 1 if vc > 0 else (-1 if vc < 0 else 0)
        ctx, xor = SC[(hc + 1) * 3 + vc + 1]
        return -1 if dec.decode(ctx) ^ xor else 1

    def significant(p, bit_value, s):
        sig[p], sgn[p] = 1, s
        mag[p] = bit_value

    # codeword segments: passes a segment (bypass: 10, then 2, 1, 2, 1 ...)
    seg_passes = []
    if bypass:
        left, size_next = passes, 10
        while left > 0:
            seg_passes.append(min(left, size_next))
            left -= size_next
            size_next = 2 if size_next in (10, 1) else 1
    else:
        seg_passes = [passes]
    if len(segments) < len(seg_passes):
        raise StreamError("fewer codeword segments than passes need")
    pass_no, seg_no = 0, 0
    for plane in range(planes - 1, -1, -1):
        bit_value = 1 << plane
        kinds = ("cu",) if plane == planes - 1 else ("sp", "mr", "cu")
        for kind in kinds:
            if pass_no >= passes:
                break
            # which segment this pass lies in, and its decoder
            first = sum(seg_passes[:seg_no])
            if pass_no == first:
                data = segments[seg_no]
                raw_seg = bypass and pass_no >= 10 and kind != "cu"
                dec = None if raw_seg else MQDecoder(data, index, mps)
                raw = RawDecoder(data) if raw_seg else None
            if pass_no + 1 == first + seg_passes[seg_no]:
                seg_no += 1
            if kind == "sp":
                for p, _ in order:
                    if sig[p]:
                        continue
                    hh, vv, dd = counts(p)
                    if not (hh or vv or dd):
                        continue
                    visited[p] = 1
                    b = raw.bit() if raw else dec.decode(
                        zc[(hh * 3 + vv) * 5 + min(dd, 4)])
                    if b:
                        significant(p, bit_value, sign_of(p, dec, raw))
            elif kind == "mr":
                for p, _ in order:
                    if not sig[p] or visited[p]:
                        continue
                    if raw:
                        b = raw.bit()
                    else:
                        if refined[p]:
                            ctx = 16
                        else:
                            hh, vv, dd = counts(p)
                            ctx = 15 if (hh or vv or dd) else 14
                        b = dec.decode(ctx)
                    refined[p] = 1
                    if b:
                        mag[p] |= bit_value
            else:
                k, n = 0, len(order)
                while k < n:
                    p, top = order[k]
                    if top and not any(
                            sig[q] or visited[q] or any(counts(q))
                            for q, _ in order[k:k + 4]):
                        # run-length mode over the stripe's column
                        if not dec.decode(CTX_RL):
                            k += 4
                            continue
                        r = dec.decode(CTX_UNI) << 1
                        r |= dec.decode(CTX_UNI)
                        q = order[k + r][0]
                        significant(q, bit_value, sign_of(q, dec, None))
                        k += r + 1
                        continue
                    if not sig[p] and not visited[p]:
                        hh, vv, dd = counts(p)
                        if dec.decode(zc[(hh * 3 + vv) * 5 + min(dd, 4)]):
                            significant(p, bit_value, sign_of(p, dec, None))
                    k += 1
                for p, _ in order:
                    visited[p] = 0
            pass_no += 1
    out = np.zeros((h, w), dtype=np.int64)
    for y in range(h):
        row = (y + 1) * W + 1
        out[y] = [sgn[q] * mag[q] for q in range(row, row + w)]
    return out


# ---- codestream and tier-2 -------------------------------------------------

class _Bits:
    """Packet-header bits (B.10.1): after 0xFF a byte gives seven."""

    def __init__(self, data: bytes, pos: int) -> None:
        self.d, self.pos = data, pos
        self.buf = self.n = self.last = 0

    def bit(self) -> int:
        if self.n == 0:
            b = self.d[self.pos]
            self.pos += 1
            self.n = 7 if self.last == 0xFF else 8
            self.buf, self.last = b, b
        self.n -= 1
        return (self.buf >> self.n) & 1

    def bits(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.bit()
        return v

    def end(self) -> int:
        """The position after the header (a stuffed byte after 0xFF)."""
        return self.pos + (1 if self.last == 0xFF else 0)


class _TagTree:
    """B.10.2."""

    def __init__(self, w: int, h: int) -> None:
        self.levels = []
        while True:
            self.levels.append((w, h))
            if w == 1 and h == 1:
                break
            w, h = -(-w // 2), -(-h // 2)
        n = sum(a * b for a, b in self.levels)
        self.value = [1 << 30] * n
        self.low = [0] * n

    def _path(self, x: int, y: int) -> list:
        path, base = [], 0
        for lw, lh in self.levels:
            path.append(base + y * lw + x)
            base += lw * lh
            x, y = x // 2, y // 2
        return path[::-1]

    def decode(self, bits: _Bits, x: int, y: int, threshold: int) -> bool:
        low = 0
        for node in self._path(x, y):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
        return self.value[node] < threshold

    def value_of(self, bits: _Bits, x: int, y: int) -> int:
        t = 1
        while not self.decode(bits, x, y, t):
            t += 1
        return t - 1


def _u16(b: bytes, i: int) -> int:
    return (b[i] << 8) | b[i + 1]


def _u32(b: bytes, i: int) -> int:
    return (_u16(b, i) << 16) | _u16(b, i + 2)


def main_header(data: bytes) -> tuple:
    """The main header's SIZ, COD and QCD fields of a one-component
    codestream, and the position of its first SOT: (fields, position)."""
    if _u16(data, 0) != 0xFF4F:
        raise StreamError("no SOC")
    pos, hdr = 2, {}
    while True:
        marker = _u16(data, pos)
        if marker == 0xFF90:
            break
        length = _u16(data, pos + 2)
        seg = data[pos + 4: pos + 2 + length]
        if marker == 0xFF51:
            csiz = _u16(seg, 34)
            if csiz != 1:
                raise StreamError(f"{csiz} components")
            hdr["size"] = [_u32(seg, 2 + 4 * k) for k in range(8)]
            ssiz = seg[36]
            hdr["bits"], hdr["signed"] = (ssiz & 0x7F) + 1, bool(ssiz & 0x80)
            if seg[37] != 1 or seg[38] != 1:
                raise StreamError("subsampled component")
        elif marker == 0xFF52:
            scod = seg[0]
            if scod & ~0x01:
                raise StreamError(f"COD style {scod:#x}")
            hdr["precincts"] = bool(scod & 1)
            hdr["progression"], hdr["layers"] = seg[1], _u16(seg, 2)
            hdr["levels"] = seg[5]
            hdr["cb"] = (seg[6] + 2, seg[7] + 2)
            hdr["cb_style"], hdr["transform"] = seg[8], seg[9]
            hdr["pp"] = ([(v & 0xF, v >> 4) for v in seg[10:]]
                         if scod & 1 else [(15, 15)] * (seg[5] + 1))
        elif marker == 0xFF5C:
            sqcd = seg[0]
            if sqcd & 0x1F:
                raise StreamError("quantized (not reversible)")
            hdr["guard"] = sqcd >> 5
            hdr["exponents"] = [v >> 3 for v in seg[1:]]
        elif marker in (0xFF53, 0xFF5D, 0xFF5E, 0xFF5F, 0xFF60, 0xFF63):
            raise StreamError(f"marker {marker:#x} is not read here")
        pos += 2 + length
    return hdr, pos


def parse(data: bytes) -> dict:
    """The main header and the tile's data, of a one-tile codestream."""
    hdr, pos = main_header(data)
    tiles = []
    while _u16(data, pos) == 0xFF90:
        psot = _u32(data, pos + 6)
        tile = _u16(data, pos + 4)
        start = pos + 2 + _u16(data, pos + 2)
        while _u16(data, start) != 0xFF93:
            start += 2 + _u16(data, start + 2)
        end = pos + psot if psot else len(data) - 2
        tiles.append((tile, data[start + 2: end]))
        pos = end
    if len({t for t, _ in tiles}) != 1:
        raise StreamError("more than one tile")
    hdr["body"] = b"".join(body for _, body in tiles)
    if hdr.get("transform") != 1:
        raise StreamError("not the reversible 5/3")
    if hdr["cb_style"] & ~0x01:
        raise StreamError(f"code-block style {hdr['cb_style']:#x}")
    return hdr


def _bands(hdr: dict) -> list:
    """Per resolution, its bands: (band, x0, y0, x1, y1) in band
    coordinates (B.5)."""
    xs, ys, x0, y0 = hdr["size"][0], hdr["size"][1], hdr["size"][2], \
        hdr["size"][3]
    nl = hdr["levels"]
    out = []
    for r in range(nl + 1):
        if r == 0:
            d = 1 << nl
            out.append([(0, -(-x0 // d), -(-y0 // d), -(-xs // d),
                         -(-ys // d))])
            continue
        n = nl - r
        res = []
        for b in (1, 2, 3):
            ox, oy = (1 << n) * (b & 1), (1 << n) * (b >> 1)
            d = 1 << (n + 1)
            res.append((b, -(-(x0 - ox) // d), -(-(y0 - oy) // d),
                        -(-(xs - ox) // d), -(-(ys - oy) // d)))
        out.append(res)
    return out


def decode(data: bytes) -> np.ndarray:
    """Decode a codestream to its samples, clipped to the component's
    range: [rows, columns] int64."""
    hdr = parse(data)
    nl, bands = hdr["levels"], _bands(hdr)
    for r, (ppx, ppy) in enumerate(hdr["pp"]):
        rx0 = -(-hdr["size"][2] // (1 << (nl - r)))
        rx1 = -(-hdr["size"][0] // (1 << (nl - r)))
        ry0 = -(-hdr["size"][3] // (1 << (nl - r)))
        ry1 = -(-hdr["size"][1] // (1 << (nl - r)))
        if (rx0 >> ppx != (rx1 - 1) >> ppx
                or ry0 >> ppy != (ry1 - 1) >> ppy):
            raise StreamError("more than one precinct a resolution")
    cbw, cbh = hdr["cb"]
    blocks: Dict[tuple, dict] = {}
    grids = {}
    for r, res in enumerate(bands):
        pp = hdr["pp"][r]
        xcb = min(cbw, pp[0] - (1 if r else 0))
        ycb = min(cbh, pp[1] - (1 if r else 0))
        for b, bx0, by0, bx1, by1 in res:
            if bx1 <= bx0 or by1 <= by0:
                grids[r, b] = None
                continue
            gx0, gy0 = bx0 >> xcb, by0 >> ycb
            gx1, gy1 = -(-bx1 // (1 << xcb)), -(-by1 // (1 << ycb))
            grids[r, b] = {"x": (gx0, gx1), "y": (gy0, gy1),
                           "size": (xcb, ycb), "rect": (bx0, by0, bx1, by1),
                           "incl": _TagTree(gx1 - gx0, gy1 - gy0),
                           "zero": _TagTree(gx1 - gx0, gy1 - gy0)}
            for gy in range(gy0, gy1):
                for gx in range(gx0, gx1):
                    blocks[r, b, gx, gy] = {"included": False, "lblock": 3,
                                            "passes": 0, "zero": 0,
                                            "segs": []}
    bypass = bool(hdr["cb_style"] & 1)
    # the packets' order: layer-major (LRCP) or resolution-major (the
    # others, with one component and one precinct a resolution)
    layers = hdr["layers"]
    if hdr["progression"] == 0:
        packets = [(l, r) for l in range(layers) for r in range(nl + 1)]
    else:
        packets = [(l, r) for r in range(nl + 1) for l in range(layers)]
    body, pos = hdr["body"], 0
    for layer, r in packets:
        bits = _Bits(body, pos)
        contrib = []
        if bits.bit():
            for b, *_ in bands[r]:
                g = grids[r, b]
                if g is None:
                    continue
                for gy in range(*g["y"]):
                    for gx in range(*g["x"]):
                        blk = blocks[r, b, gx, gy]
                        lx, ly = gx - g["x"][0], gy - g["y"][0]
                        if not blk["included"]:
                            if not g["incl"].decode(bits, lx, ly, layer + 1):
                                continue
                            blk["zero"] = g["zero"].value_of(bits, lx, ly)
                        elif not bits.bit():
                            continue
                        n = _pass_count(bits)
                        while bits.bit():
                            blk["lblock"] += 1
                        for k in _chunks(blk["passes"], n, bypass):
                            length = bits.bits(blk["lblock"]
                                               + int(math.log2(k[1])))
                            contrib.append((blk, k[0], length))
                        blk["passes"] += n
                        blk["included"] = True
        pos = bits.end()
        for blk, new_seg, length in contrib:
            piece = body[pos: pos + length]
            if len(piece) != length:
                raise StreamError("a code-block runs past the tile")
            if new_seg or not blk["segs"]:
                blk["segs"].append(piece)
            else:
                blk["segs"][-1] += piece
            pos += length
    # tier-1 and the band planes
    planes_of = _magnitude_planes(hdr)
    recon = {}
    for r, res in enumerate(bands):
        for b, bx0, by0, bx1, by1 in res:
            plane = np.zeros((by1 - by0, bx1 - bx0), dtype=np.int64)
            g = grids[r, b]
            if g is not None:
                xcb, ycb = g["size"]
                for (rr, bb, gx, gy), blk in blocks.items():
                    if (rr, bb) != (r, b) or not blk["passes"]:
                        continue
                    cx0 = max(bx0, gx << xcb)
                    cx1 = min(bx1, (gx + 1) << xcb)
                    cy0 = max(by0, gy << ycb)
                    cy1 = min(by1, (gy + 1) << ycb)
                    planes = planes_of[r, b] - blk["zero"]
                    if planes <= 0:
                        continue
                    coef = decode_block(blk["segs"], blk["passes"], planes,
                                        cx1 - cx0, cy1 - cy0,
                                        0 if r == 0 else b, bypass)
                    plane[cy0 - by0: cy1 - by0, cx0 - bx0: cx1 - bx0] = coef
            recon[r, b] = plane
    samples = _inverse_53(hdr, recon)
    bits = hdr["bits"]
    if hdr["signed"]:
        return np.clip(samples, -(1 << (bits - 1)), (1 << (bits - 1)) - 1)
    return np.clip(samples + (1 << (bits - 1)), 0, (1 << bits) - 1)


def _pass_count(bits: _Bits) -> int:
    """Table B.4."""
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    v = bits.bits(2)
    if v < 3:
        return 3 + v
    v = bits.bits(5)
    if v < 31:
        return 6 + v
    return 37 + bits.bits(7)


def _chunks(done: int, new: int, bypass: bool) -> list:
    """The codeword segments that passes [done, done + new) touch:
    (starts a new segment, passes in it)."""
    if not bypass:
        return [(done == 0, new)]
    out, p, end = [], done, done + new
    while p < end:
        if p < 10:
            seg_start, seg_end = 0, 10
        else:
            k = (p - 10) // 3
            seg_start = 10 + 3 * k if (p - 10) % 3 < 2 else 12 + 3 * k
            seg_end = seg_start + (2 if seg_start == 10 + 3 * k else 1)
        stop = min(end, seg_end)
        out.append((p == seg_start, stop - p))
        p = stop
    return out


def _magnitude_planes(hdr: dict) -> dict:
    """Mb of each band (E-2): guard bits + exponent - 1."""
    out, k = {}, 0
    exps = hdr["exponents"]
    for r in range(hdr["levels"] + 1):
        for b in ((0,) if r == 0 else (1, 2, 3)):
            out[r, b] = hdr["guard"] + exps[k] - 1
            k += 1
    return out


def _pse(i: np.ndarray, n: int) -> np.ndarray:
    """Whole-sample symmetric extension (F.3.7) of offsets into [0, n)."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    j = np.mod(i, period)
    return np.where(j >= n, period - j, j)


def _inverse_53_1d(y: np.ndarray, i0: int) -> np.ndarray:
    """1D_SR of the reversible 5/3 (F.3.8, F-5 and F-6) along the last
    axis, for a signal starting at absolute position ``i0``."""
    n = y.shape[-1]
    if n == 1:
        return y.copy() if i0 % 2 == 0 else y // 2
    pad = 4
    ext = y[..., _pse(np.arange(-pad, n + pad), n)]
    start = i0 - pad                      # absolute position of ext[0]
    x = ext.copy()
    e = (start % 2)                       # first even index in ext
    evens = np.arange(e, ext.shape[-1], 2)
    evens = evens[(evens > 0) & (evens < ext.shape[-1] - 1)]
    x[..., evens] = ext[..., evens] - np.floor_divide(
        ext[..., evens - 1] + ext[..., evens + 1] + 2, 4)
    odds = np.arange(1 - e, ext.shape[-1], 2)
    odds = odds[(odds > 1) & (odds < ext.shape[-1] - 2)]
    x[..., odds] = ext[..., odds] + np.floor_divide(
        x[..., odds - 1] + x[..., odds + 1], 2)
    return x[..., pad: pad + n]


def _inverse_53(hdr: dict, recon: dict) -> np.ndarray:
    """2D_SR over the levels: interleave, then each row, then each
    column (F.3.2)."""
    nl = hdr["levels"]
    xs, ys, x0, y0 = hdr["size"][:4]
    a = recon[0, 0]
    for r in range(1, nl + 1):
        d = 1 << (nl - r)
        u0, u1 = -(-x0 // d), -(-xs // d)
        v0, v1 = -(-y0 // d), -(-ys // d)
        out = np.zeros((v1 - v0, u1 - u0), dtype=np.int64)
        ex, ey = u0 % 2, v0 % 2            # the first low row and column
        out[ey::2, ex::2] = a
        out[ey::2, 1 - ex::2] = recon[r, 1]
        out[1 - ey::2, ex::2] = recon[r, 2]
        out[1 - ey::2, 1 - ex::2] = recon[r, 3]
        out = _inverse_53_1d(out, u0)
        a = _inverse_53_1d(out.T, v0).T
    return a

