"""Spec-direct test-stream and pattern generators (importable library).

Role of reference jpeg2000/testdata/ (simple_generator.go,
multilevel_generator.go, multitile_generator.go, rgb_generator.go,
encoded_generator.go): reusable generators that hand-pack J2K
codestreams byte-by-byte — raw struct.pack, NOT the library's
codestream/j2k.py writers — so decoders are exercised on inputs no
repo encoder produced and cannot share a compensating bug with the
encode path. Also hosts the shared synthetic image patterns used by
tests, tools/benchmarks and tools/foreign_ab.

The SpecMQEncoder here is written from the ISO/IEC 15444-1 Annex C
flowcharts (software conventions), independent of entropy/mq.py; the
spec-direct cleanup-pass coder in encoded_j2k() follows the T.800
Annex D flowcharts and re-derives its zero-coding/sign-coding
contexts from Tables D.1-D.3 without importing entropy/ebcot.py.
"""

from __future__ import annotations

import struct

import numpy as np

# ------------------------------------------------------------------
# synthetic image patterns (shared content classes)
# ------------------------------------------------------------------


def gradient_image(w: int, h: int, bits: int = 8) -> np.ndarray:
    """Smooth diagonal ramp — maximally compressible content."""
    y, x = np.mgrid[0:h, 0:w]
    return (((x + y) * ((1 << bits) - 1)) // max(w + h - 2, 1)
            ).astype(np.int64)


def dense_noise_image(w: int, h: int, bits: int = 12,
                      seed: int = 7) -> np.ndarray:
    """Uniform noise — the worst case for every entropy coder (the
    'dense' benchmark content class)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, size=(h, w)).astype(np.int64)


def textured_image(w: int, h: int, bits: int = 12) -> np.ndarray:
    """Smooth sinusoidal texture + mild deterministic dither — the
    'textured' (clinical-like) benchmark content class."""
    y, x = np.mgrid[0:h, 0:w]
    mid = 1 << (bits - 1)
    amp = 1 << (bits - 3)
    img = (np.sin(x / 9.0) + np.cos(y / 13.0)) * amp + mid
    img = img + ((x * 7 + y * 13) % 5)  # deterministic dither
    return np.clip(img, 0, (1 << bits) - 1).astype(np.int64)


def checkerboard_image(w: int, h: int, bits: int = 8,
                       cell: int = 4) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    return (((x // cell + y // cell) & 1) * ((1 << bits) - 1)
            ).astype(np.int64)


def rgb_pattern_image(w: int, h: int, bits: int = 8) -> np.ndarray:
    """[h, w, 3] with distinct per-channel structure."""
    r = gradient_image(w, h, bits)
    g = textured_image(w, h, bits)
    b = checkerboard_image(w, h, bits)
    return np.stack([r, g, b], axis=-1)


# ------------------------------------------------------------------
# hand-packed J2K codestream builders (bytes only)
# ------------------------------------------------------------------


def seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def siz(w, h, bits, ncomp=1, tw=None, th=None, signed=False):
    tw = tw or w
    th = th or h
    p = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, tw, th, 0, 0, ncomp)
    ssiz = (bits - 1) | (0x80 if signed else 0)
    for _ in range(ncomp):
        p += bytes([ssiz, 1, 1])  # no subsampling
    return seg(0xFF51, p)


def cod(levels, mct=0, cb_exp=(4, 4)):
    # LRCP, 1 layer, 2^cb_exp code-blocks, no precincts, 5/3 reversible
    p = bytes([0, 0]) + struct.pack(">H", 1) + bytes(
        [mct, levels, cb_exp[0], cb_exp[1], 0, 1])
    return seg(0xFF52, p)


def qcd(levels, bits):
    # style 0 (no quantization), 2 guard bits, reversible 5/3 exponents
    p = bytes([0 | (2 << 5)])
    p += bytes([(bits + 0) << 3])  # LL
    for _ in range(levels):
        p += bytes([(bits + 1) << 3, (bits + 1) << 3, (bits + 2) << 3])
    return seg(0xFF5C, p)


def tile(index: int, body: bytes) -> bytes:
    sot = struct.pack(">HHHIBB", 0xFF90, 10, index, 12 + 2 + len(body),
                      0, 1)
    return sot + struct.pack(">H", 0xFF93) + body


def empty_packets(levels: int, ncomp: int = 1) -> bytes:
    """One 0 bit per packet, padded to a byte → 0x00 per packet
    (LRCP, 1 layer: one packet per resolution per component)."""
    return b"\x00" * ((levels + 1) * ncomp)


def stream(w, h, bits, levels, body_per_tile, ncomp=1, mct=0,
           tw=None, th=None, ntiles=1, signed=False, cb_exp=(4, 4)):
    s = b"\xff\x4f" + siz(w, h, bits, ncomp, tw, th, signed) + \
        cod(levels, mct, cb_exp) + qcd(levels, bits)
    for t in range(ntiles):
        s += tile(t, body_per_tile)
    return s + b"\xff\xd9"


def simple_j2k(w: int, h: int, bits: int) -> bytes:
    """Role of GenerateSimpleJ2K: single tile, gray, 0 levels, empty
    packet — decodes to the all-zero coefficient plane (DC midpoint)."""
    return stream(w, h, bits, 0, empty_packets(0))


def multilevel_j2k(w: int, h: int, bits: int, levels: int) -> bytes:
    """Role of GenerateMultilevelJ2K: configurable decomposition with
    all-empty packets."""
    return stream(w, h, bits, levels, empty_packets(levels))


def multitile_j2k(w: int, h: int, tw: int, th: int, bits: int,
                  levels: int, ncomp: int = 1) -> bytes:
    """Role of GenerateMultiTileJ2K (and the 2x2/3x2 helpers)."""
    nx = -(-w // tw)
    ny = -(-h // th)
    return stream(w, h, bits, levels, empty_packets(levels, ncomp),
                  ncomp=ncomp, tw=tw, th=th, ntiles=nx * ny)


def rgb_j2k(w: int, h: int, bits: int, levels: int = 1,
            mct: int = 1) -> bytes:
    """Role of GenerateRGBJ2K: 3 components, optional RCT."""
    return stream(w, h, bits, levels, empty_packets(levels, 3),
                  ncomp=3, mct=mct)


# ------------------------------------------------------------------
# independent MQ encoder (ISO/IEC 15444-1 Annex C flowcharts,
# software conventions — NOT entropy/mq.py)
# ------------------------------------------------------------------

# Table C.2 (spec constants)
QE = [0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
      0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
      0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
      0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
      0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
      0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601]
NMPS = [1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18,
        19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
        35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46]
NLPS = [1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15,
        16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
        31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46]
SWITCH = [1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0,
          0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
          0, 0, 0, 0, 0, 0, 0]


class SpecMQEncoder:
    """Annex C software-conventions encoder (C.3.1-C.3.4 flowcharts)."""

    def __init__(self, nctx):
        self.I = [0] * nctx
        self.MPS = [0] * nctx
        # INITENC
        self.A = 0x8000
        self.C = 0
        self.CT = 12
        self.B = []  # BP points at B[-1]; B starts "before" the data

    # BYTEOUT (C.3.2, software conventions)
    def _byteout(self):
        if self.B and self.B[-1] == 0xFF:
            self.B.append((self.C >> 20) & 0xFF)
            self.C &= 0xFFFFF
            self.CT = 7
        else:
            if self.C < 0x8000000:
                self.B.append((self.C >> 19) & 0xFF)
                self.C &= 0x7FFFF
                self.CT = 8
            else:
                if self.B:
                    self.B[-1] += 1
                else:
                    self.B.append(1)  # carry into the leading byte
                if self.B[-1] == 0xFF:
                    self.C &= 0x7FFFFFF
                    self.B.append((self.C >> 20) & 0xFF)
                    self.C &= 0xFFFFF
                    self.CT = 7
                else:
                    self.B.append((self.C >> 19) & 0xFF)
                    self.C &= 0x7FFFF
                    self.CT = 8

    def _renorme(self):
        while True:
            self.A <<= 1
            self.C <<= 1
            self.CT -= 1
            if self.CT == 0:
                self._byteout()
            if self.A & 0x8000:
                break

    def encode(self, d, cx):
        i = self.I[cx]
        qe = QE[i]
        self.A -= qe
        if d == self.MPS[cx]:  # CODEMPS
            if self.A & 0x8000:
                self.C += qe
                return
            if self.A < qe:
                self.A = qe
            else:
                self.C += qe
            self.I[cx] = NMPS[i]
            self._renorme()
        else:  # CODELPS
            if self.A < qe:
                self.C += qe
            else:
                self.A = qe
            if SWITCH[i]:
                self.MPS[cx] = 1 - self.MPS[cx]
            self.I[cx] = NLPS[i]
            self._renorme()

    def flush(self):
        # SETBITS + FLUSH (C.3.4)
        tempc = self.C + self.A
        self.C |= 0xFFFF
        if self.C >= tempc:
            self.C -= 0x8000
        self.C <<= self.CT
        self._byteout()
        self.C <<= self.CT
        self._byteout()
        if self.B and self.B[-1] == 0xFF:
            self.B.pop()
        return bytes(self.B)


# ------------------------------------------------------------------
# spec-direct single-plane cleanup coder + non-empty packet
# (role of encoded_generator.go: real entropy-coded tile data)
# ------------------------------------------------------------------

# context numbering used by the repo decoder: ZC 0-8, SC 9-13,
# MR 14-16, UNI 18, RL 17 (entropy/ebcot.py module constants — the
# ASSIGNMENT is implementation-chosen; the repo decoder's mapping is
# part of its MQ-context ABI, so the generator targets it while
# deriving the CLASSIFICATION below from T.800 Tables D.1-D.3 itself)
_CTX_RL, _CTX_UNI = 17, 18


def _zc_context(h_, v, d, orient):
    """T.800 Table D.1, re-derived (not imported). Orientation
    numbering: 0=LL, 1=HL (h/v roles swapped), 2=LH, 3=HH."""
    if orient == 1:
        h_, v = v, h_
    if orient != 3:  # LL / LH / HL-after-swap share one table
        if h_ == 2:
            return 8
        if h_ == 1:
            return 7 if v >= 1 else (6 if d >= 1 else 5)
        if v == 2:
            return 4
        if v == 1:
            return 3
        return min(d, 2)
    # HH
    if d >= 3:
        return 8
    if d == 2:
        return 7 if h_ + v >= 1 else 6
    if d == 1:
        return 5 if h_ + v >= 2 else (4 if h_ + v == 1 else 3)
    return min(h_ + v, 2)


def _sc_context(hc, vc):
    """T.800 Table D.3: contribution pairs → (context 9-13, xorbit)."""
    tbl = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0),
           (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
           (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}
    return tbl[(hc, vc)]


def _cleanup_encode_plane(coeffs: np.ndarray, orient: int = 0) -> bytes:
    """One cleanup pass over a single-bitplane block (coeffs in
    {-1, 0, 1}), written from the T.800 D.4 flowchart: stripe-oriented
    scan, run-length mode, ZC/SC coding. Returns the MQ codeword."""
    h, w = coeffs.shape
    sig = np.zeros((h, w), dtype=bool)
    sgn = coeffs < 0
    mag = np.abs(coeffs)
    enc = SpecMQEncoder(19)
    # repo/spec initial states: UNI=46, RL=3, ZC0=4
    enc.I[_CTX_UNI] = 46
    enc.I[_CTX_RL] = 3
    enc.I[0] = 4

    def neighbors(y, x):
        hs = vs = ds = 0
        for dx in (-1, 1):
            if 0 <= x + dx < w and sig[y, x + dx]:
                hs += 1
        for dy in (-1, 1):
            if 0 <= y + dy < h and sig[y + dy, x]:
                vs += 1
        for dy in (-1, 1):
            for dx in (-1, 1):
                if 0 <= y + dy < h and 0 <= x + dx < w and \
                        sig[y + dy, x + dx]:
                    ds += 1
        return hs, vs, ds

    def sign_contrib(y, x):
        def c(yy, xx):
            if not (0 <= yy < h and 0 <= xx < w) or not sig[yy, xx]:
                return 0
            return -1 if sgn[yy, xx] else 1
        hc = max(-1, min(1, c(y, x - 1) + c(y, x + 1)))
        vc = max(-1, min(1, c(y - 1, x) + c(y + 1, x)))
        return hc, vc

    def code_sig(y, x):
        ctx, xorbit = _sc_context(*sign_contrib(y, x))
        enc.encode(int(sgn[y, x]) ^ xorbit, ctx)
        sig[y, x] = True

    for y0 in range(0, h, 4):
        for x in range(w):
            rows = range(y0, min(y0 + 4, h))
            # run-length mode: full stripe, all 4 insignificant with
            # entirely insignificant neighborhoods
            rl = (len(rows) == 4)
            if rl:
                for y in rows:
                    if sig[y, x] or any(neighbors(y, x)):
                        rl = False
                        break
            start = y0
            if rl:
                hits = [y for y in rows if mag[y, x]]
                if not hits:
                    enc.encode(0, _CTX_RL)
                    continue
                enc.encode(1, _CTX_RL)
                r = hits[0] - y0
                enc.encode((r >> 1) & 1, _CTX_UNI)
                enc.encode(r & 1, _CTX_UNI)
                code_sig(hits[0], x)
                start = hits[0] + 1
            for y in range(start, min(y0 + 4, h)):
                s = int(mag[y, x])
                enc.encode(s, _zc_context(*neighbors(y, x), orient))
                if s:
                    code_sig(y, x)
    return enc.flush()


class _BitPacker:
    """MSB-first packet-header bit packer with T.800 B.10.1 stuffing
    (a 0 bit is inserted after any 0xFF byte)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0
        self.cap = 8  # 7 for the byte following an 0xFF (stuff bit)

    def put(self, bit):
        self.acc = (self.acc << 1) | bit
        self.n += 1
        if self.n == self.cap:
            self.out.append(self.acc)
            self.cap = 7 if self.acc == 0xFF else 8
            self.acc = 0
            self.n = 0

    def put_bits(self, val, nbits):
        for i in range(nbits - 1, -1, -1):
            self.put((val >> i) & 1)

    def done(self):
        while self.n:
            self.put(0)
        return bytes(self.out)


def encoded_j2k(w: int = 8, h: int = 8, bits: int = 8,
                pattern: str = "cross"):
    """Role of GenerateSimpleEncodedJ2K: a 0-level single-codeblock
    stream with REAL entropy-coded data (one cleanup pass at bitplane
    0, coefficients in {-1, 0, +1}) and a hand-packed non-empty packet
    header. Returns (stream_bytes, expected_coefficients)."""
    assert w <= 16 and h <= 16, "single 16x16 code-block only"
    coeffs = np.zeros((h, w), dtype=np.int64)
    if pattern == "cross":
        coeffs[h // 2, :] = 1
        coeffs[:, w // 2] = -1
        coeffs[h // 2, w // 2] = 1
    elif pattern == "corners":
        coeffs[0, 0] = 1
        coeffs[0, w - 1] = -1
        coeffs[h - 1, 0] = -1
        coeffs[h - 1, w - 1] = 1
    else:
        raise ValueError(pattern)

    body = _cleanup_encode_plane(coeffs, orient=0)
    # packet header (T.800 B.10): non-empty; single code-block
    # inclusion tag tree (leaf value 0 → one 1 bit); zero-bitplanes
    # tag tree (value = missing bitplanes); 1 pass; Lblock=3 length
    # bits (no commas) — len(body) must fit
    # Mb = guard(2) + QCD exponent(bits) - 1; our data has numbps=1
    missing = (2 + bits - 1) - 1
    bp = _BitPacker()
    bp.put(1)                      # packet non-empty
    bp.put(1)                      # inclusion tag tree: 0 < 1
    for _ in range(missing):       # zero-bitplanes: `missing` thresholds
        bp.put(0)
    bp.put(1)
    bp.put(0)                      # numpasses = 1
    nlen = len(body)
    k = max(0, nlen.bit_length() - 3)  # Lblock 3 → 3+k length bits
    for _ in range(k):
        bp.put(1)                  # Lblock increment commas
    bp.put(0)
    bp.put_bits(nlen, 3 + k)
    header = bp.done()
    return stream(w, h, bits, 0, header + body), coeffs
