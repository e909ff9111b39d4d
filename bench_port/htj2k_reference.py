"""A plain decoder of HTJ2K lossless codestreams (ITU-T T.814 | ISO/IEC
15444-15), written from the standard to judge what the program decodes.

It reads what a lossless DICOM HTJ2K encode of one gray frame writes: one
tile, one component, one precinct a resolution, code-blocks of the HT
block coder (code-block style bit 6) each coded by one cleanup pass, no
quantization and the reversible 5/3. It refuses anything else. The main
header, the tag trees, the pass counts, the band geometry and the inverse
5/3 are those of the plain T.800 decoder beside it (``j2k_reference``);
the packet walk is written out again here (the T.800 one decodes each
block with the MQ coder as it goes), and the cleanup pass (7.3) is plain
Python, one quad at a time, clause by clause:

- 7.1: the segment's three byte streams, MagSgn forward from its start,
  MEL forward from Pcup = Lcup − Scup, VLC backward from its end, each
  with its own bit-unstuffing rule;
- 7.3.3: the MEL's adaptive run-length symbols;
- 7.3.4-7.3.5: each quad's context c_q from the significance already
  decoded, and its CxtVLC codeword (rho, u_off, e_k, e_1) found in the
  standard's tables, kept here as data of their own (Annex C, Tables C.20
  and C.21, in the byte packing OpenJPH's table0.h/table1.h use);
- 7.3.6: the U-VLC of a quad pair, with the initial line pair's MEL event;
- 7.3.7: the exponent bound U_q = u_q + κ_q, κ_q from the line pair above;
- 7.3.8: the MagSgn bits of each significant sample, μ_n and s_n.

Where it departs from the text (each marked "Departure" below):

- the reconstruction of a block whose cleanup pass is not at bit-plane 0
  (P = numbps − 1 > 0) adds half of the lowest coded step, 2^(P−1), to a
  non-zero magnitude (the text leaves r to the decoder; this is the
  program's choice). A lossless encode codes every block at P = 0;
- the U-VLC extension (u_ext, for u_sfx of 28 or more) is not read: with
  a band's Mb of 30 or less, U_q stays at 31 or less, so u_q never needs
  it;
- a codeword that no table entry matches is refused, where a decoder may
  treat it as the text's insignificant quad.

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import base64
from typing import Dict, List

import numpy as np

from .j2k_reference import (StreamError, _bands, _Bits, _inverse_53,
                            _magnitude_planes, _pass_count, _TagTree, _u16,
                            _u32, main_header)

# Annex C, Tables C.20 (initial line pair) and C.21 (the others): each
# entry 4 bytes, [c_q << 5 | rho << 1 | u_off, e_k << 4 | e_1, codeword,
# codeword length], the codeword's bits LSB first as the VLC stream
# carries them.
_TABLE_C20 = (
    "AgAGBAMRPwcEAAADBSJ/BwYAEQUHIl8HBzEfBwgAAgMJRBMGCgAOBQtEIwYLUQ8HDAADBg0A"
    "bwcOAC8HDyJPBw8gDQYQAAQDEYg9BhIAHQYTAC0GFAABBRWINQYVoncHFgA3BxcRVwcXEAkG"
    "GAAeBRnMFwcZxBUGGcglBhoAZwcbEScHG1RHBxvYBwccAHsHHSJLBx2oBQYd5DsHHgBbBx+Z"
    "GwcfumsHH/wrBx/4OQYf5nMHH+IZBh/1Cwcf9CkGH/EzByAAAAIiAA4EIxEfByQABgQlIjsG"
    "JgAbBicAPQYoAAoEKUQrBioACwYrRDMGK1F/BywAEwYtACMGLgA/By8iXwcvIAMGMAACBDGI"
    "HQYyAC0GMwANBjQANQY1iBUGNaJvBzYALwc3EU8HNxARBjgAAQU5iCUGOcQFBjoADwc7ERcH"
    "O1Q5BjvYdwc8ADcHPSJXBz2oGQY95GcHPgAHBz+4KQY/iCcHP6IJBj/kMQY/8UcHQAAAAkIA"
    "DgRDERsGRAAGBEUiPwdGACsGRxEzBkcyfwdIAAoESUQLBkoAAQVLVS8HS1ETBktUIwZMAAMG"
    "TQBfB04AHwdPIm8HTzERBk90NwdQAAIEUYhPB1IAPQZTAB0GVAAtBlUADQZWAA8HVyJ3B1cg"
    "NQZYABUGWUQlBlnIVwdaABcHW4gFBlvEOQZb0WcHXAAnB10iewddIBkGXgBHB1/xKQZfEQkG"
    "XzIHB190MQZf+DsHYAAAA2IABARjET0GZAAMBWUiTwdmAB0GZxEFBmcyfwdoABYFaUQtBmoA"
    "BgVrVRoFa1ENBmtUNQZsAD8HbURfB21iHwduAG8Hb2YvB29kFQZvc3cHb3ElBm9yDwdwAAoF"
    "cYgHB3IAOQZzETcHc5hXB3QAGQZ1iCkGdaIXB3YAZwd3sScHdxFHB3cyCQZ3uHsHeAAxBnlE"
    "EQZ5yDsHegBbB3uZGwd71SsHe9EhBnvcawd71AEGe9hLB3wACwd95HMHfUQTB33IPgZ94jMH"
    "fgBTB3+qDgZ/uWMHf/wDB3/4EgV/5iMHf/UeBn/0AgV/80MHf/EcBX/yLgaAAAACggAOBIMR"
    "PweEAAYEhSIbBoYAKwaHIj0GhzF/B4gACgSJRF8HigALBosAMwaMABMGjQAjBo4AHwePRG8H"
    "j0ADBpAAAgSRiB0GkgARBpMAdweUAAEFlaovB5WiLQaVqA0GlgBPB5eyDweXADUGmAAVBpmI"
    "JQaZxDcHmgBXB5sRBwebEAUGnAAXB51EOQadyBkGneJnB54AJwefmUcHn5EpBp92ewefcgkG"
    "n7gxBp/0OwegAAADogAaBaMRfwekAAoFpSIdBqYALQanM18HpzI5BqcxPweoABIFqUQfB6oA"
    "DQarRDUGq1FvB6wAFQatIiUGrWQvB64ATwevZlcHr2QFBq9zDwevcncHr3E3B7AAAgWxiBkG"
    "sgAmBrOIFwezkWcHtAAcBbWqKQa1ogkGtagxBrYAJwe3mQcHt5gRBrezRwe3siEGt7F7B7gA"
    "AQa5iD4GucQ7B7oAWwe7mWsHu5geBrvVGwe71C4Gu9ErB7wASwe9ZgsHveozB73iDga97HMH"
    "veg2Br3kUwe+ABMHv3dDB792Fga/dWMHv/wjB7/0DAW/2QMHv/o9B7/4FAW/830Hv/IEBb/x"
    "BgbAAAADwgAEBMMRAwbEAAwFxSINBsYAGgXHMz0GxzEdBscyLQbIAAoFyUQ/B8oANQbLERUG"
    "y1R/B8wAJQbNIl8HzWQfB84AbwfPZk8Hz2QFBs9zLwfPcTYGz3J3B9AAEgXRiA8H0gA5BtMR"
    "NwfTmFcH1AAZBtUiKQbVqBcH1gBnB9eZRwfXkQkG17onB9eyMQbXuHsH2AARBtnMBwfZyCEG"
    "2cQ7B9oAWwfbVTMH21QBBtvIGwfb0WsH3AArB93iSwfdIgsH3exzB93oPgbd5FMH3gATB99m"
    "Hgbf6i4G3/MOBt/yAgXfuWMH3/wWBt/4Bgbf9SMH3/EcBd/0JgbgABIF4gAFBuMRfwfkADkG"
    "5SI/B+YAXwfnMx8H5zJvB+cxLwfoAE8H6UQPB+oAVwfrERkG61R3B+wANwftACkG7gAXB+9m"
    "ZwfvcycH73JHB+91GwfvcQkG73QHB/AAewfxiDsH8gBbB/MAMQb0AFMH9SIRBvWoawf2ACsH"
    "95lLB/ezCwf3sXMH97ozB/eyIQb3uBMH+ABjB/mIIwf5xEMH+gADB/uZfQf71V0H+9EBBvvc"
    "PQf71D4G+9gdB/wAbQf9Zi0H/eoNB/3iHgb97E0H/egOBv3kdQf+ABUH//8GBf/9NQf/91UH"
    "//UaBf/7JQf/8woF//kuBv/xAAT//mUH//Y2Bv/6AgX/8gwE//wWBv/4BAT/9AgE"
)
_TABLE_C21 = (
    "AgAAAwMRJwYEAAYDBSIXBgYADQUHADsGCAACAwlEBwYKABUFCwArBgwAAQUNAH8HDgAfBw8A"
    "GwYQAAQDEYgFBRIAGQUTABMGFAAJBRWICwYVoj8HFgBfBxcAMwYYABEFGYgjBhnEbwcaAA8H"
    "GwADBhwALwcdRE8HHUA9Bh4AdwcfETcHHxAdBiAAAAEiAAUEIxF/ByQACQQlIh8HJgAdBScR"
    "PwcnMl8HKAANBSlENwcqAAMGKwBvBywALwctAE8HLgAPBy8AdwcwAAEEMYgXBzIACwYzAFcH"
    "NAAzBjUAZwc2ACcHNwArBzgAEwY5AEcHOgAHBzsAewc8ADsHPQBbBz4AGwc/RGsHP0AjBkAA"
    "AAFCAAkEQxF/B0QAAQRFIiMGRgA9BkciPwdHMR8HSAAVBUlEXwdKAAMGSwBvB0wALwdNAE8H"
    "TgAPB08AFwdQAAUFUYh3B1IANwdTAFcHVAAdBlWqewdVoi0GVahnB1YAJwdXskcHVwAHB1gA"
    "DQZZADsHWgBbB1sAGwdcAGsHXUQrB11ASwdeAAsHX0RzB19RMwdfclMHX/gTB2AAAAJiAAoE"
    "YxELBmQAAgRlIiMGZgAOBWczfwdnMjMGZzETBmgAFgVpRD8HagADBmsRPQZrVB8HbAAdBm0A"
    "XwduAC0Gb0QvB29RHgZvcm8HcAAGBXGITwdyAA0GcwA1BnQAFQZ1IiUGdagPB3YABQZ3iDkG"
    "d7MXB3eyGQZ3sXcHeAApBnkACQZ6ADcHe0RXB3tAMQZ8AGcHfUQnB33IRwd94msHfgARBn9m"
    "Bwd/c3sHf/o7B3/yIQZ/+AEGf6hbB3/1Gwd/8T4Gf/QrB4AAAAGCAA0FgxF/B4QAFQWFIj8H"
    "hgBfB4cAbweIAAkEiUQjBooAMwaLAB8HjAATBo0ALweOAE8HjwBXB5AAAQSRiA8HkgB3B5MA"
    "NweUAB0GlQAXB5YAZweXAGsHmAAFBZnMJweZyEcHmcQHB5oAewebADsHnABbB50iGwedIAMG"
    "ngArB58RSwefMgsHnzA9BqAAAAKiAB4FoxE7BqQACgWlIj8HpgAbBqcACwaoAAIEqUQrBqoA"
    "DgWrRDMGq1F/B6wAEwatAG8HrgAjBq8iXwevIBUGsAAWBbGIAwayAD0GswAfB7QAHQa1AC0G"
    "tgANBrcRTwe3EDUGuAAGBblEJQa5yC8HugAFBrsRdwe7VDkGu9gPB7wAGQa9IlcHvagBBr3k"
    "Nwe+ABoFv5kXB7/VZwe/8wcHv/EpBr92Jwe//AkGv/QxBr/6Rwe/+BEGv/IhBsAAAAPCAAIE"
    "wxEDBsQADATFIj0GxgAdBsciDQbHMX8HyAAEBMlELQbKAAoFy0Q1BstRLwfMABUGzSI/B81k"
    "XwfOACUGzyIpBs8xHwfPdG8H0AAWBdGIBQbSADkG0wAZBtQABgXVqg8H1aIJBtWoTwfWAA4G"
    "17J3B9ciNwfXqFcH17FHB9gAGgXZzBcH2chnB9nEJwfaADEG29QHB9tEewfbyDsH29ErB9wA"
    "EQbd5FsH3UQbB93qawfd6CEG3eIzB94AAQbfM0sH33YLB9/6cwff8j4G37lTB9/8Ywff+B4G"
    "3/UTB9/0Lgbf8SMH4AAEBOIAMwbjERMG5AAjBuUifwfmAAMG5xE/B+cybwfoAC0G6URfB+oA"
    "FgXrET0G61QfB+wAHQbtAHcH7gAGBe90LwfvRE8H73MPB+9xDQbvclcH8AA1BvGINwfyABUG"
    "8wAnB/QAJQb1ACkG9gAaBfexFwf3EWcH9zIFBve4ewf4ADkG+QAZBvoADAX70UcH+xEHB/tU"
    "CQb72BsH/AAxBv3iOwf9IlsH/ag+Bv3kCwf+AAAD//9rB//3Kwf/+0sH//MRBv92IQb/+gEG"
    "//IKBf+5Hgb//A4G//gSBf/1Lgb/8QIF//QcBQ=="
)
_MEL_E = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)   # Table 2


def _table(blob: str) -> list:
    """(c_q, rho, u_off, e_k, e_1, codeword, length) of each entry."""
    raw = base64.b64decode(blob)
    return [(raw[i] >> 5, (raw[i] >> 1) & 0xF, raw[i] & 1, raw[i + 1] >> 4,
             raw[i + 1] & 0xF, raw[i + 2], raw[i + 3])
            for i in range(0, len(raw), 4)]


TABLE_C20 = _table(_TABLE_C20)
TABLE_C21 = _table(_TABLE_C21)


# ---- 7.1: the three byte streams of a cleanup segment ---------------------

class _MagSgnBits:
    """importMagSgnBit: forward from the segment's start, LSB first; a byte
    after 0xFF carries 7 bits; past Pcup the stream reads 0xFF bytes."""

    def __init__(self, data: bytes, pcup: int) -> None:
        self.d, self.n = data, pcup
        self.pos = self.bits = self.tmp = 0
        self.last = 0

    def bit(self) -> int:
        if self.bits == 0:
            self.bits = 7 if self.last == 0xFF else 8
            self.tmp = self.d[self.pos] if self.pos < self.n else 0xFF
            self.pos += 1
            self.last = self.tmp
        b = self.tmp & 1
        self.tmp >>= 1
        self.bits -= 1
        return b

    def bits_lsb_first(self, m: int) -> int:
        v = 0
        for i in range(m):
            v |= self.bit() << i
        return v


class _MelBits:
    """importMELBit: forward from Pcup, MSB first; a byte after 0xFF
    carries 7 bits. The MEL owns the segment's bytes but its last: the
    second last, whose low nibble holds Scup's, reads with that nibble set
    to 1s; past them the stream reads 1s."""

    def __init__(self, cleanup: bytes) -> None:
        self.d, self.end = cleanup, len(cleanup) - 1
        self.pos = self.bits = self.tmp = 0
        self.unstuff = False

    def bit(self) -> int:
        if self.bits == 0:
            if self.pos >= self.end:
                return 1
            byte = self.d[self.pos]
            if self.pos == self.end - 1:
                byte |= 0x0F
            self.pos += 1
            self.bits = 7 if self.unstuff else 8
            self.tmp = byte & ((1 << self.bits) - 1)
            self.unstuff = byte == 0xFF
        self.bits -= 1
        return (self.tmp >> self.bits) & 1


class _VlcBits:
    """importVLCBit: backward from the segment's second last byte, LSB
    first; that byte gives its high nibble alone (3 bits where the
    nibble's low three are 1s), and a byte after one above 0x8F whose low
    7 bits are 1s carries 7 bits; below the segment's start the stream
    reads 0xFF bytes."""

    def __init__(self, cleanup: bytes) -> None:
        self.d = cleanup
        self.pos = len(cleanup) - 2
        self.queue: List[int] = []
        self.first, self.unstuff = True, False

    def _load(self) -> None:
        byte = self.d[self.pos] if self.pos >= 0 else 0xFF
        self.pos -= 1
        if self.first:
            self.first = False
            nib = byte >> 4
            n = 3 if nib & 7 == 7 else 4
            value = nib
            self.unstuff = (byte | 0x0F) > 0x8F
        else:
            n = 7 if self.unstuff and byte & 0x7F == 0x7F else 8
            value = byte
            self.unstuff = byte > 0x8F
        self.queue.extend((value >> i) & 1 for i in range(n))

    def peek(self, n: int) -> int:
        while len(self.queue) < n:
            self._load()
        return sum(b << i for i, b in enumerate(self.queue[:n]))

    def take(self, n: int) -> int:
        v = self.peek(n)
        del self.queue[:n]
        return v


# ---- 7.3.3: the MEL symbols -----------------------------------------------

class _Mel:
    def __init__(self, bits: _MelBits) -> None:
        self.bits = bits
        self.k = self.run = self.one = 0

    def symbol(self) -> int:
        if self.run == 0 and self.one == 0:
            e = _MEL_E[self.k]
            if self.bits.bit():
                self.run = 1 << e
                self.k = min(12, self.k + 1)
            else:
                self.run = 0
                for _ in range(e):
                    self.run = 2 * self.run + self.bits.bit()
                self.k = max(0, self.k - 1)
                self.one = 1
        if self.run > 0:
            self.run -= 1
            return 0
        self.one = 0
        return 1


# ---- 7.3.4-7.3.6: a quad's codeword and a pair's U-VLC ----------------------

def _codeword(vlc: _VlcBits, table: list, cq: int) -> tuple:
    """The first entry of context ``cq`` whose codeword the stream holds:
    (rho, u_off, e_k, e_1), the codeword consumed."""
    for tcq, rho, u_off, ek, e1, cwd, length in table:
        if tcq == cq and vlc.peek(length) == cwd:
            vlc.take(length)
            return rho, u_off, ek, e1
    raise StreamError(f"no CxtVLC codeword of context {cq}")


def _u_prefix(vlc: _VlcBits) -> int:
    if vlc.take(1):
        return 1
    if vlc.take(1):
        return 2
    return 3 if vlc.take(1) else 5


def _u_suffix(vlc: _VlcBits, prefix: int) -> int:
    if prefix < 3:
        return 0
    return vlc.take(1) if prefix == 3 else vlc.take(5)


# ---- the cleanup pass ---------------------------------------------------------

def decode_cleanup(segment: bytes, w: int, h: int, mb: int,
                   missing: int) -> np.ndarray:
    """The coefficients [h, w] (int64) of a code-block coded by one HT
    cleanup pass: ``segment`` its Lcup bytes, ``mb`` its band's Mb and
    ``missing`` its missing MSBs (the packet header's zero bit-planes)."""
    lcup = len(segment)
    if lcup < 2:
        raise StreamError("an HT cleanup segment under 2 bytes")
    scup = (segment[-1] << 4) | (segment[-2] & 0x0F)
    if scup < 2 or scup > lcup or scup > 4079:
        raise StreamError(f"Scup {scup} of a segment of {lcup} bytes")
    if not 0 <= missing < mb <= 30:
        raise StreamError(f"Mb {mb}, missing MSBs {missing}")
    pcup = lcup - scup
    cleanup = segment[pcup:]
    magsgn = _MagSgnBits(segment, pcup)
    mel, vlc = _Mel(_MelBits(cleanup)), _VlcBits(cleanup)
    nq, npairs = (w + 1) // 2, (h + 1) // 2
    # significance and the exponents' values v_n = 2 mu_n - 1 (0 where
    # insignificant), on the quads' grid with one column either side
    sig = np.zeros((2 * npairs, 2 * nq + 4), dtype=np.int64)
    vval = np.zeros((2 * npairs, 2 * nq + 4), dtype=np.int64)
    mag = np.zeros((2 * npairs, 2 * nq), dtype=np.int64)
    neg = np.zeros((2 * npairs, 2 * nq), dtype=bool)
    for pair in range(npairs):
        y = 2 * pair
        initial = pair == 0
        table = TABLE_C20 if initial else TABLE_C21
        quads = []
        for q0 in range(0, nq, 2):
            got = []
            for q in range(q0, min(q0 + 2, nq)):
                c = 2 * q + 2                      # column of the quad's x
                if initial:                        # the west quad alone
                    cq = ((sig[y, c - 2] | sig[y + 1, c - 2])
                          + 2 * sig[y, c - 1] + 4 * sig[y + 1, c - 1])
                else:                              # west and the row above
                    cq = ((sig[y - 1, c - 1] | sig[y - 1, c])
                          + 2 * (sig[y, c - 1] | sig[y + 1, c - 1])
                          + 4 * (sig[y - 1, c + 1] | sig[y - 1, c + 2]))
                if cq == 0 and mel.symbol() == 0:
                    rho = u_off = ek = e1 = 0      # an insignificant quad
                else:
                    rho, u_off, ek, e1 = _codeword(vlc, table, int(cq))
                for n in range(4):                 # n: (0,0) (0,1) (1,0) (1,1)
                    sig[y + (n & 1), c + (n >> 1)] = (rho >> n) & 1
                got.append([q, rho, u_off, ek, e1, 0])
            # U-VLC of the pair
            offs = [g[2] for g in got]
            if initial and len(got) == 2 and all(offs):
                if mel.symbol():
                    p0, p1 = _u_prefix(vlc), _u_prefix(vlc)
                    got[0][5] = 2 + p0 + _u_suffix(vlc, p0)
                    got[1][5] = 2 + p1 + _u_suffix(vlc, p1)
                else:
                    p0 = _u_prefix(vlc)
                    if p0 > 2:
                        got[1][5] = 1 + vlc.take(1)
                        got[0][5] = p0 + _u_suffix(vlc, p0)
                    else:
                        p1 = _u_prefix(vlc)
                        got[0][5] = p0 + _u_suffix(vlc, p0)
                        got[1][5] = p1 + _u_suffix(vlc, p1)
            else:
                prefixes = [_u_prefix(vlc) if g[2] else 0 for g in got]
                for g, p in zip(got, prefixes):
                    if g[2]:
                        g[5] = p + _u_suffix(vlc, p)
            quads.extend(got)
        # 7.3.7-7.3.8: exponents and MagSgn, quad by quad
        for q, rho, _, ek, e1, u in quads:
            c = 2 * q + 2
            if initial:
                kappa = 1
            else:
                gamma = bin(rho).count("1") > 1
                above = vval[y - 1, c - 1:c + 3]
                emax = max(int(v).bit_length() - 1 for v in above) \
                    if above.any() else 0
                kappa = max(emax, 1) if gamma else 1
            uq = u + kappa
            if uq > missing + 2:
                raise StreamError(f"U_q {uq} past its bound {missing + 2}")
            for n in range(4):
                if not (rho >> n) & 1:
                    continue
                m = uq - ((ek >> n) & 1)
                v = magsgn.bits_lsb_first(m) | (((e1 >> n) & 1) << m)
                yy, xx = y + (n & 1), 2 * q + (n >> 1)
                mag[yy, xx] = (v >> 1) + 1
                neg[yy, xx] = bool(v & 1)
                vval[yy, c + (n >> 1)] = 2 * mag[yy, xx] - 1
    # the cleanup pass codes bit-plane P = numbps - 1 (numbps = Mb - missing)
    p = mb - missing - 1
    if p > 0:   # Departure: the program's half-step reconstruction
        mag = np.where(mag > 0, (mag << p) + (1 << (p - 1)), 0)
    coef = np.where(neg, -mag, mag)
    return coef[:h, :w]


# ---- tier-2 and the whole frame ---------------------------------------------

def parse(data: bytes) -> dict:
    """The main header and the tile's data of a one-tile codestream whose
    code-blocks are HT."""
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
    if hdr["cb_style"] & ~0x48 or not hdr["cb_style"] & 0x40:
        raise StreamError(f"code-block style {hdr['cb_style']:#x}")
    return hdr


def decode(data: bytes) -> np.ndarray:
    """Decode an HTJ2K codestream to its samples, clipped to the
    component's range: [rows, columns] int64."""
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
                           "size": (xcb, ycb),
                           "incl": _TagTree(gx1 - gx0, gy1 - gy0),
                           "zero": _TagTree(gx1 - gx0, gy1 - gy0)}
            for gy in range(gy0, gy1):
                for gx in range(gx0, gx1):
                    blocks[r, b, gx, gy] = {"included": False, "lblock": 3,
                                            "passes": 0, "zero": 0,
                                            "data": b""}
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
                        if blk["passes"] + n != 1:
                            raise StreamError("an HT code-block of more "
                                              "than its cleanup pass")
                        length = bits.bits(blk["lblock"])
                        contrib.append((blk, length))
                        blk["passes"] += n
                        blk["included"] = True
        pos = bits.end()
        for blk, length in contrib:
            piece = body[pos: pos + length]
            if len(piece) != length:
                raise StreamError("a code-block runs past the tile")
            blk["data"] = piece
            pos += length
    mbs = _magnitude_planes(hdr)
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
                    if mbs[r, b] - blk["zero"] <= 0:
                        continue
                    cx0 = max(bx0, gx << xcb)
                    cx1 = min(bx1, (gx + 1) << xcb)
                    cy0 = max(by0, gy << ycb)
                    cy1 = min(by1, (gy + 1) << ycb)
                    plane[cy0 - by0: cy1 - by0, cx0 - bx0: cx1 - bx0] = \
                        decode_cleanup(blk["data"], cx1 - cx0, cy1 - cy0,
                                       mbs[r, b], blk["zero"])
            recon[r, b] = plane
    samples = _inverse_53(hdr, recon)
    depth = hdr["bits"]
    if hdr["signed"]:
        return np.clip(samples, -(1 << (depth - 1)), (1 << (depth - 1)) - 1)
    return np.clip(samples + (1 << (depth - 1)), 0, (1 << depth) - 1)
