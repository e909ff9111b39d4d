"""HTJ2K cleanup-pass block coder (ISO/IEC 15444-15, OpenJPH-parity).

Role of reference jpeg2000/htj2k/{openjph_cleanup_encoder,_decoder}.go,
mel.go, magsgn.go, vlc_*.go, uvlc_*.go: quad-pair scan with fused
MEL / CxtVLC / UVLC / MagSgn streams, Scup locator in the last two bytes,
forward MagSgn + forward MEL + backward-grown VLC segments.

The UVLC joint pair coding is decoded algorithmically (mirror of the
encoder's three initial-pair cases) instead of via the spec's combined
lookup tables.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..codecs.ht_tables import (DEC_LUT0, DEC_LUT1, ENC_LUT0, ENC_LUT1,
                                MEL_E)
from ..errors import CorruptStreamError


# ---- writers ----------------------------------------------------------------

class MELWriter:
    """Adaptive run-length coder (mel.go / cleanup_encoder.go:8-63)."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.tmp = 0
        self.rem = 8
        self.run = 0
        self.k = 0
        self.threshold = 1

    def encode(self, bit: bool) -> None:
        if not bit:
            self.run += 1
            if self.run >= self.threshold:
                self._emit(1)
                self.run = 0
                if self.k < 12:
                    self.k += 1
                self.threshold = 1 << MEL_E[self.k]
            return
        self._emit(0)
        t = MEL_E[self.k]
        while t > 0:
            t -= 1
            self._emit((self.run >> t) & 1)
        self.run = 0
        if self.k > 0:
            self.k -= 1
        self.threshold = 1 << MEL_E[self.k]

    def _emit(self, v: int) -> None:
        self.tmp = ((self.tmp << 1) | (v & 1)) & 0xFF
        self.rem -= 1
        if self.rem == 0:
            self.buf.append(self.tmp)
            self.rem = 7 if self.tmp == 0xFF else 8
            self.tmp = 0


class VLCWriter:
    """Backward-grown VLC writer (cleanup_encoder.go:65-116)."""

    def __init__(self) -> None:
        self.buf = bytearray([0xFF])
        self.used = 4
        self.tmp = 0xF
        self.last_gt_8f = True

    def encode(self, cwd: int, n: int) -> None:
        while n > 0:
            avail = 8 - (1 if self.last_gt_8f else 0) - self.used
            t = min(avail, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            avail -= t
            n -= t
            cwd >>= t
            if avail == 0:
                if self.last_gt_8f and self.tmp != 0x7F:
                    self.last_gt_8f = False
                    continue
                self.buf.append(self.tmp & 0xFF)
                self.last_gt_8f = self.tmp > 0x8F
                self.tmp = 0
                self.used = 0

    def bytes_reversed(self) -> bytes:
        """Final VLC segment: bytes after index 0 reversed, 0xFF last."""
        return bytes(self.buf[:0:-1]) + bytes(self.buf[:1])


class MagSgnWriter:
    """LSB-first bit packer with 0xFF→7-bit stuffing (cleanup_encoder.go:118-164)."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.maxbits = 8
        self.used = 0
        self.tmp = 0

    def encode(self, cwd: int, n: int) -> None:
        while n > 0:
            t = min(self.maxbits - self.used, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            cwd >>= t
            n -= t
            if self.used >= self.maxbits:
                b = self.tmp & 0xFF
                self.buf.append(b)
                self.maxbits = 7 if b == 0xFF else 8
                self.tmp = 0
                self.used = 0

    def terminate(self) -> None:
        if self.used:
            t = self.maxbits - self.used
            self.tmp |= (0xFF & ((1 << t) - 1)) << self.used
            if (self.tmp & 0xFF) != 0xFF:
                self.buf.append(self.tmp & 0xFF)
        elif self.maxbits == 7 and self.buf:
            self.buf.pop()


def _uvlc_code(code: int) -> Tuple[int, int, int, int]:
    """(pre, pre_len, suf, suf_len) for u codes (cleanup_encoder.go:172-194)."""
    if code <= 0:
        return 0, 0, 0, 0
    if code == 1:
        return 1, 1, 0, 0
    if code == 2:
        return 2, 2, 0, 0
    if code <= 4:
        return 4, 3, code - 3, 1
    # cap at 36 like the reference (extension words unsupported)
    return 0, 3, code - 5, 5


# ---- encoder ----------------------------------------------------------------

class HTCleanupEncoder:
    """Cleanup-pass-only HT block encoder (cleanup_encoder.go:196-530)."""

    def __init__(self, width: int, height: int, kmax: int) -> None:
        self.w = width
        self.h = height
        self.kmax = kmax

    def encode(self, data: np.ndarray) -> Optional[bytes]:
        """[h, w] int32 → codeblock bytes (None if all-zero)."""
        if not (0 < self.kmax < 31):
            raise CorruptStreamError(f"invalid HTJ2K Kmax {self.kmax}")
        w, h = self.w, self.h
        flat = np.asarray(data, dtype=np.int64).reshape(h, w)
        shift = 31 - self.kmax
        mag = np.abs(flat).astype(np.uint64) << np.uint64(shift)
        sign = (flat < 0).astype(np.uint64) << np.uint64(31)
        cb = (sign | mag).astype(np.uint32)
        if int(mag.max(initial=0)) < (1 << shift):
            return None

        p = 30 - (self.kmax - 1)
        mel = MELWriter()
        vlc = VLCWriter()
        ms = MagSgnWriter()
        npairs = (w + 1) // 2 + 2
        e_val = [0] * (npairs + 2)
        cx_val = [0] * (npairs + 2)

        self._rows(cb, p, mel, vlc, ms, e_val, cx_val, initial=True)
        self._rows(cb, p, mel, vlc, ms, e_val, cx_val, initial=False)

        mel_bytes, vlc_bytes = self._terminate(mel, vlc)
        ms.terminate()
        out = bytearray(ms.buf) + mel_bytes + vlc_bytes
        if len(mel_bytes) + len(vlc_bytes) == 0:
            raise CorruptStreamError("empty HT cleanup suffix")
        scup = len(mel_bytes) + len(vlc_bytes)
        out[-1] = (scup >> 4) & 0xFF
        out[-2] = (out[-2] & 0xF0) | (scup & 0x0F)
        return bytes(out)

    def _sample(self, cb, p, x, y, idx, q):
        """One sample's (rho-bit, exponent, magsgn value) (encoder :394-412)."""
        if x >= self.w or y >= self.h:
            return
        t = int(cb[y, x])
        val = ((t + t) & 0xFFFFFFFF) >> p
        val &= ~1
        if val == 0:
            return
        q["rho"] |= 1 << (idx % 4)
        val -= 1
        e = val.bit_length()
        q["eq"][idx % 4] = e
        q["eqmax"] = max(q["eqmax"], e)
        val -= 1
        q["s"][idx % 4] = val + (t >> 31)

    def _quad(self, cb, p, x, y):
        q = {"rho": 0, "eqmax": 0, "eq": [0, 0, 0, 0], "s": [0, 0, 0, 0]}
        self._sample(cb, p, x, y, 0, q)
        self._sample(cb, p, x, y + 1, 1, q)
        self._sample(cb, p, x + 1, y, 2, q)
        self._sample(cb, p, x + 1, y + 1, 3, q)
        return q

    @staticmethod
    def _eps(eq, eqmax, u):
        if u <= 0:
            return 0
        return sum(1 << i for i, v in enumerate(eq) if v == eqmax)

    @staticmethod
    def _tuple(initial, cq, rho, eps):
        if rho == 0 and cq == 0:
            return 0
        lut = ENC_LUT0 if initial else ENC_LUT1
        return lut[(cq << 8) | (rho << 4) | eps]

    def _magsgn(self, ms, rho, uq, tup, s):
        for i in range(4):
            if not (rho & (1 << i)):
                continue
            m = max(uq - ((tup >> i) & 1), 0)
            ms.encode(s[i] & ((1 << m) - 1), m)

    def _uvlc_initial(self, vlc, u0, u1):
        if u0 > 2 and u1 > 2:
            c0 = _uvlc_code(u0 - 2)
            c1 = _uvlc_code(u1 - 2)
            vlc.encode(c0[0], c0[1])
            vlc.encode(c1[0], c1[1])
            vlc.encode(c0[2], c0[3])
            vlc.encode(c1[2], c1[3])
        elif u0 > 2 and u1 > 0:
            c0 = _uvlc_code(u0)
            vlc.encode(c0[0], c0[1])
            vlc.encode(u1 - 1, 1)
            vlc.encode(c0[2], c0[3])
        else:
            c0 = _uvlc_code(u0)
            c1 = _uvlc_code(u1)
            vlc.encode(c0[0], c0[1])
            vlc.encode(c1[0], c1[1])
            vlc.encode(c0[2], c0[3])
            vlc.encode(c1[2], c1[3])

    def _uvlc_noninitial(self, vlc, u0, u1):
        c0 = _uvlc_code(u0)
        c1 = _uvlc_code(u1)
        vlc.encode(c0[0], c0[1])
        vlc.encode(c1[0], c1[1])
        vlc.encode(c0[2], c0[3])
        vlc.encode(c1[2], c1[3])

    def _rows(self, cb, p, mel, vlc, ms, e_val, cx_val, initial):
        w, h = self.w, self.h
        ys = [0] if initial else range(2, h, 2)
        for y in ys:
            lep = 0
            lcxp = 0
            if initial:
                e_val[0] = 0
                cx_val[0] = 0
                cq0 = 0
                max_e = 0
            else:
                max_e = max(e_val[0], e_val[1]) - 1
                e_val[0] = 0
                cq0 = cx_val[0] + (cx_val[1] << 2)
                cx_val[0] = 0
            x = 0
            while x < w:
                q0 = self._quad(cb, p, x, y)
                rho0 = q0["rho"]
                if initial:
                    uq0 = max(q0["eqmax"], 1)
                    u0 = uq0 - 1
                else:
                    kappa = max(1, max_e) if rho0 & (rho0 - 1) else 1
                    uq0 = max(q0["eqmax"], kappa)
                    u0 = uq0 - kappa
                eps0 = self._eps(q0["eq"], q0["eqmax"], u0)
                e_val[lep] = max(e_val[lep], q0["eq"][1])
                lep += 1
                if not initial:
                    max_e = max(e_val[lep], e_val[lep + 1]) - 1
                e_val[lep] = q0["eq"][3]
                cx_val[lcxp] |= (rho0 & 2) >> 1
                lcxp += 1
                if not initial:
                    cq1 = cx_val[lcxp] + (cx_val[lcxp + 1] << 2)
                cx_val[lcxp] = (rho0 & 8) >> 3

                tup0 = self._tuple(initial, cq0, rho0, eps0)
                vlc.encode(tup0 >> 8, (tup0 >> 4) & 7)
                if cq0 == 0:
                    mel.encode(rho0 != 0)
                self._magsgn(ms, rho0, uq0, tup0, q0["s"])

                u1 = 0
                rho1 = 0
                if x + 2 < w:
                    q1 = self._quad(cb, p, x + 2, y)
                    rho1 = q1["rho"]
                    if initial:
                        cq1 = (rho0 >> 1) | (rho0 & 1)
                        uq1 = max(q1["eqmax"], 1)
                        u1 = uq1 - 1
                    else:
                        cq1 |= ((rho0 & 4) >> 1) | ((rho0 & 8) >> 2)
                        kappa = max(1, max_e) if rho1 & (rho1 - 1) else 1
                        uq1 = max(q1["eqmax"], kappa)
                        u1 = uq1 - kappa
                    eps1 = self._eps(q1["eq"], q1["eqmax"], u1)
                    e_val[lep] = max(e_val[lep], q1["eq"][1])
                    lep += 1
                    if not initial:
                        max_e = max(e_val[lep], e_val[lep + 1]) - 1
                    e_val[lep] = q1["eq"][3]
                    cx_val[lcxp] |= (rho1 & 2) >> 1
                    lcxp += 1
                    if not initial:
                        cq0 = cx_val[lcxp] + (cx_val[lcxp + 1] << 2)
                    cx_val[lcxp] = (rho1 & 8) >> 3

                    tup1 = self._tuple(initial, cq1, rho1, eps1)
                    vlc.encode(tup1 >> 8, (tup1 >> 4) & 7)
                    if cq1 == 0:
                        mel.encode(rho1 != 0)
                    self._magsgn(ms, rho1, uq1, tup1, q1["s"])

                if initial:
                    if u0 > 0 and u1 > 0:
                        mel.encode(min(u0, u1) > 2)
                    self._uvlc_initial(vlc, u0, u1)
                    cq0 = (rho1 >> 1) | (rho1 & 1)
                else:
                    self._uvlc_noninitial(vlc, u0, u1)
                    cq0 |= ((rho1 & 4) >> 1) | ((rho1 & 8) >> 2)
                x += 4
            if initial:
                e_val[lep + 1] = 0

    @staticmethod
    def _terminate(mel: MELWriter, vlc: VLCWriter) -> Tuple[bytes, bytes]:
        """Fuse the trailing MEL/VLC bytes when possible (encoder :532-553)."""
        if mel.run > 0:
            mel._emit(1)
        mel_tmp = (mel.tmp << mel.rem) & 0xFF
        mel_mask = (0xFF << mel.rem) & 0xFF
        vlc_mask = (0xFF >> (8 - vlc.used)) if vlc.used > 0 else 0
        if (mel_mask | vlc_mask) == 0:
            return bytes(mel.buf), vlc.bytes_reversed()
        fuse = mel_tmp | vlc.tmp
        if ((((fuse ^ mel_tmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask)) == 0
                and fuse != 0xFF and len(vlc.buf) > 1):
            mel.buf.append(fuse & 0xFF)
        else:
            mel.buf.append(mel_tmp)
            vlc.buf.append(vlc.tmp & 0xFF)
        return bytes(mel.buf), vlc.bytes_reversed()


# ---- readers ----------------------------------------------------------------

class MELReader:
    """Run decoder (cleanup_decoder.go:8-99)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.size = len(data) - 1
        self.unstuff = False
        self.k = 0
        self.bits: List[int] = []

    def _read_bit(self) -> int:
        while not self.bits:
            if self.size <= 0:
                return 1
            d = 0xFF
            if self.pos < len(self.data):
                d = self.data[self.pos]
                self.pos += 1
                if self.size == 1:
                    d |= 0x0F
                self.size -= 1
            valid = 7 if self.unstuff else 8
            for i in range(valid - 1, -1, -1):
                self.bits.append((d >> i) & 1)
            self.unstuff = d == 0xFF
        return self.bits.pop(0)

    def get_run(self) -> int:
        e = MEL_E[self.k]
        if self._read_bit() == 1:
            run = ((1 << e) - 1) << 1
            if self.k < 12:
                self.k += 1
            return run
        run = 0
        for _ in range(e):
            run = (run << 1) | self._read_bit()
        if self.k > 0:
            self.k -= 1
        return (run << 1) + 1


class VLCReader:
    """Backward VLC reader, mirror of VLCWriter (OpenJPH rev vlc_init).

    Operates on the REVERSED cleanup segment: byte 0 is the stream's last
    byte (Scup high — skipped), byte 1's top nibble holds the first 4 VLC
    bits (low nibble is Scup low; the writer pre-filled it with 0xF and
    the Scup locator overwrote it), then full bytes with the >0x8F/0x7F
    unstuffing rule.
    """

    def __init__(self, segment_reversed: bytes) -> None:
        self.data = segment_reversed
        self.pos = 1  # skip the Scup-high byte (writer's initial 0xFF)
        self.bitpool = 0
        self.nbits = 0
        self.unstuff = False
        self._first = True

    def _load_byte(self) -> None:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
        else:
            b = 0xFF  # exhausted: ones
        if self._first:
            self._first = False
            nib = b >> 4
            n = 4 - (1 if (nib & 7) == 7 else 0)
            bits = nib & ((1 << n) - 1)
            self.unstuff = (b | 0x0F) > 0x8F
        else:
            n = 8
            if self.unstuff and (b & 0x7F) == 0x7F:
                n = 7
            bits = b & ((1 << n) - 1)
            self.unstuff = b > 0x8F
        self.bitpool |= bits << self.nbits
        self.nbits += n

    def peek(self, n: int = 7) -> int:
        while self.nbits < n:
            self._load_byte()
        return self.bitpool & ((1 << n) - 1)

    def advance(self, n: int) -> None:
        while self.nbits < n:
            self._load_byte()
        self.bitpool >>= n
        self.nbits -= n

    def read_bits(self, n: int) -> int:
        v = self.peek(n) if n else 0
        self.advance(n)
        return v


class MagSgnReader:
    """LSB-first reader with 0xFF stuffing (magsgn.go)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.bitpool = 0
        self.nbits = 0
        self.prev_ff = False

    def fetch(self, n: int) -> int:
        while self.nbits < n:
            if self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
            else:
                b = 0xFF
            valid = 7 if self.prev_ff else 8
            self.bitpool |= (b & ((1 << valid) - 1)) << self.nbits
            self.nbits += valid
            self.prev_ff = b == 0xFF
        v = self.bitpool & ((1 << n) - 1) if n else 0
        self.bitpool >>= n
        self.nbits -= n
        return v


class HTCleanupDecoder:
    """Cleanup-pass decoder (cleanup_decoder.go:114-368)."""

    def __init__(self, width: int, height: int, kmax: int,
                 missing_msbs: int) -> None:
        self.w = width
        self.h = height
        self.kmax = kmax
        self.missing = missing_msbs

    def decode(self, codeblock: bytes) -> np.ndarray:
        w, h = self.w, self.h
        if not codeblock:
            return np.zeros((h, w), dtype=np.int32)
        if self.kmax <= 0 or self.missing < 0 or self.missing >= 30:
            raise CorruptStreamError("invalid HT Kmax/missing MSBs")
        if len(codeblock) < 2:
            raise CorruptStreamError("HT codeblock too short")
        scup = ((codeblock[-1] << 4) | (codeblock[-2] & 0x0F))
        if scup < 2 or scup > len(codeblock):
            raise CorruptStreamError(f"invalid HT Scup {scup}")
        magsgn = codeblock[: len(codeblock) - scup]
        cleanup = codeblock[len(codeblock) - scup:]

        p = 30 - self.missing
        mel = MELReader(cleanup)
        vlc = VLCReader(cleanup[::-1])
        self._run = mel.get_run()
        self._mel = mel

        nq_w = (w + 3) // 4 * 4  # quads along x, padded
        npairs = nq_w // 2 + 2
        # per quad: (info tuple, uq)
        rows_info = []

        # initial row
        info0, cx_sig = self._decode_vlc_row(vlc, None, w, initial=True)
        rows_info.append(info0)
        prev = cx_sig
        for y in range(2, h, 2):
            info, cx_sig = self._decode_vlc_row(vlc, prev, w, initial=False)
            rows_info.append(info)
            prev = cx_sig

        return self._decode_magsgn(magsgn, rows_info, p)

    # -- VLC/UVLC stage ---------------------------------------------------

    def _zero_run(self, entry: int) -> int:
        self._run -= 2
        if self._run != -1:
            entry = 0
        if self._run < 0:
            self._run = self._mel.get_run()
        return entry

    def _uvlc_prefix(self, vlc) -> int:
        """Read a u prefix class: 1, 2, 3 (1-bit suffix) or 5 (5-bit)."""
        if vlc.read_bits(1):
            return 1
        if vlc.read_bits(1):
            return 2
        return 3 if vlc.read_bits(1) else 5

    def _uvlc_suffix(self, vlc, cls: int) -> int:
        if cls == 1:
            return 1
        if cls == 2:
            return 2
        if cls == 3:
            return 3 + vlc.read_bits(1)
        return 5 + vlc.read_bits(5)

    def _decode_pair_u(self, vlc, initial: bool, u0_off: bool, u1_off: bool,
                       mel_event: Optional[bool]) -> Tuple[int, int]:
        """Mirror of the encoder's UVLC pair cases."""
        if initial and u0_off and u1_off:
            if mel_event:
                c0 = self._uvlc_prefix(vlc)
                c1 = self._uvlc_prefix(vlc)
                u0 = self._uvlc_suffix(vlc, c0) + 2
                u1 = self._uvlc_suffix(vlc, c1) + 2
                return u0, u1
            c0 = self._uvlc_prefix(vlc)
            if c0 >= 3:
                # encoder case 2: u0>2, u1 in {1,2} via one bit
                u1 = vlc.read_bits(1) + 1
                u0 = self._uvlc_suffix(vlc, c0)
                return u0, u1
            c1 = self._uvlc_prefix(vlc)
            u0 = self._uvlc_suffix(vlc, c0)
            u1 = self._uvlc_suffix(vlc, c1)
            return u0, u1
        u0 = u1 = 0
        c0 = self._uvlc_prefix(vlc) if u0_off else 0
        c1 = self._uvlc_prefix(vlc) if u1_off else 0
        if u0_off:
            u0 = self._uvlc_suffix(vlc, c0)
        if u1_off:
            u1 = self._uvlc_suffix(vlc, c1)
        return u0, u1

    def _decode_vlc_row(self, vlc, prev_sig, w, initial: bool):
        """Decode one quad-row's VLC/UVLC info.

        prev_sig: per-quad (rho) info of the previous quad row (for context)
        Returns (list of (rho, u_off, ek, e1, uq_raw) per quad, rho list).
        """
        nq = (w + 1) // 2
        info = []
        rhos = []
        lut = DEC_LUT0 if initial else DEC_LUT1
        cq = 0
        qx = 0
        while qx < nq:
            entries = []
            for k in range(2):
                if qx + k >= nq:
                    entries.append((0, 0))
                    continue
                if not initial:
                    cq = self._context_noninitial(rhos, prev_sig, qx + k)
                e = lut[(cq << 7) | vlc.peek(7)]
                if cq == 0:
                    if qx + k < nq:
                        e = self._zero_run(e)
                vlc.advance(e & 0x7)
                rho = (e >> 4) & 0xF
                rhos.append(rho)
                entries.append((e, rho))
                if initial:
                    cq = (rho >> 1) | (rho & 1)
            (e0, rho0), (e1, rho1) = entries
            u0_off = bool(e0 & 0x8)
            u1_off = bool(e1 & 0x8)
            mel_event = None
            if initial and u0_off and u1_off:
                self._run -= 2
                mel_event = self._run == -1
                if self._run < 0:
                    self._run = self._mel.get_run()
            u0, u1 = self._decode_pair_u(vlc, initial, u0_off, u1_off,
                                         mel_event)
            info.append((e0, u0))
            if qx + 1 < nq:
                info.append((e1, u1))
            qx += 2
        return info, rhos

    def _context_noninitial(self, cur_rhos, prev_sig, qidx):
        """Causal context for non-initial rows (15444-15 §7.3.2 / OpenJPH).

        Built from the previous quad-row's rho bits (south edge of the quads
        above) and the previous quad in this row.
        """
        cq = 0
        # west: previous quad in this row: its NE/SE bits
        if qidx > 0 and len(cur_rhos) >= 1:
            rw = cur_rhos[qidx - 1]
            cq |= ((rw & 4) >> 1) | ((rw & 8) >> 2)  # bits 1,1? per encoder
        if prev_sig is not None:
            # above: quad above's south bits; above-left's SE; above-right's SW
            def sig_s(q):
                if 0 <= q < len(prev_sig):
                    r = prev_sig[q]
                    return ((r & 2) >> 1) | ((r & 8) >> 3)
                return 0

            r_above = prev_sig[qidx] if qidx < len(prev_sig) else 0
            # bit0: above-left SE contribution | above SW
            nw = prev_sig[qidx - 1] if qidx > 0 else 0
            ne = prev_sig[qidx + 1] if qidx + 1 < len(prev_sig) else 0
            c_nw = (nw & 8) >> 3
            c_n_sw = (r_above & 2) >> 1
            c_n_se = (r_above & 8) >> 3
            c_ne = (ne & 2) >> 1
            cq |= (c_nw | c_n_sw)          # bit 0
            cq |= (c_n_se | c_ne) << 2     # bit 2
        return cq

    # -- MagSgn stage ------------------------------------------------------

    def _decode_magsgn(self, magsgn: bytes, rows_info, p) -> np.ndarray:
        w, h = self.w, self.h
        mmsbp2 = self.missing + 2
        ms = MagSgnReader(magsgn)
        out = np.zeros((h, w), dtype=np.uint32)
        nq = (w + 1) // 2
        vn_prev = [0] * (nq + 2)

        for row_i, info in enumerate(rows_info):
            y = row_i * 2
            vn_cur = [0] * (nq + 2)
            prev_vn = 0
            for qi, (inf, u) in enumerate(info):
                x = qi * 2
                if row_i == 0:
                    uq = 1 + u
                else:
                    gamma = (inf & 0xF0) & ((inf & 0xF0) - 0x10)
                    emax = (((vn_prev[qi] | vn_prev[qi + 1]) | 2)
                            .bit_length() - 1)
                    kappa = emax if gamma else 1
                    uq = u + kappa
                if uq > mmsbp2:
                    raise CorruptStreamError(
                        f"HT U_q {uq} exceeds missingMSBs+2 {mmsbp2}")
                vals = [0, 0, 0, 0]
                vns = [0, 0, 0, 0]
                for bit in range(4):
                    if not (inf & (1 << (4 + bit))):
                        continue
                    mn = uq - ((inf >> (12 + bit)) & 1)
                    msval = ms.fetch(mn)
                    val = (msval & 1) << 31
                    vn = msval & ((1 << mn) - 1)
                    vn |= ((inf >> (8 + bit)) & 1) << mn
                    vn |= 1
                    val |= ((vn + 2) << (p - 1)) & 0x7FFFFFFF
                    vals[bit] = val
                    vns[bit] = vn
                # quad layout: bit0=(x,y), 1=(x,y+1), 2=(x+1,y), 3=(x+1,y+1)
                if x < w:
                    out[y, x] = vals[0]
                    if y + 1 < h:
                        out[y + 1, x] = vals[1]
                if x + 1 < w:
                    out[y, x + 1] = vals[2]
                    if y + 1 < h:
                        out[y + 1, x + 1] = vals[3]
                # staggered scratch: vn[q] = SE(q-1) | SW(q)
                # (cleanup_decoder.go:292-321 prevVN scheme)
                vn_cur[qi] = prev_vn | vns[1]
                prev_vn = vns[3]
            vn_cur[len(info)] = prev_vn
            vn_prev = vn_cur

        shift = 31 - self.kmax
        mag = ((out & 0x7FFFFFFF) >> np.uint32(shift)).astype(np.int32)
        neg = (out & 0x80000000) != 0
        return np.where(neg, -mag, mag).astype(np.int32)
