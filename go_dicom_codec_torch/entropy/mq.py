"""MQ arithmetic coder (ISO/IEC 15444-1:2019 Annex C), host-side.

Covers the role of reference jpeg2000/mqc/ (encoder.go, mqc.go): the
47-state Qe/NMPS/NLPS/SWITCH machine, OpenJPEG byte-out/byte-in with 0xFF
stuffing, Elias flush, predictable termination (ERTERM), bypass (raw)
mode, per-pass RESTART re-init, and context save/restore across terminated
passes. The tables are the ISO Table C.2 constants.

This is the serial entropy stage of the J2K pipeline (SURVEY.md
[hot-serial]); a C++ fast path mirrors this interface.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# ISO/IEC 15444-1 Table C.2
QE = (
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
    0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
    0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
    0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601,
)
NMPS = (
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46,
)
NLPS = (
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14,
    15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46,
)
SWITCH = (
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
)

_RAW_CT_INIT = -1


class MQEncoder:
    """MQ encoder with OpenJPEG byteout/flush semantics."""

    def __init__(self, num_contexts: int = 19) -> None:
        self.buf = bytearray(1)  # index 0 is the dummy byte
        self.bp = 0
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.ctx = [0] * num_contexts  # low 7 bits state, bit 7 MPS

    # -- context management ---------------------------------------------
    def reset_contexts(self) -> None:
        for i in range(len(self.ctx)):
            self.ctx[i] = 0

    def set_context_state(self, cx: int, state: int) -> None:
        self.ctx[cx] = state

    def get_contexts(self) -> List[int]:
        return list(self.ctx)

    # -- MQ coding -------------------------------------------------------
    def encode(self, bit: int, cx: int) -> None:
        s = self.ctx[cx]
        state = s & 0x7F
        mps = s >> 7
        qe = QE[state]
        if bit == mps:
            self.a -= qe
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.ctx[cx] = NMPS[state] | (mps << 7)
                self._renorme()
            else:
                self.c += qe
        else:
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            nm = (1 - mps) if SWITCH[state] else mps
            self.ctx[cx] = NLPS[state] | (nm << 7)
            self._renorme()

    def _renorme(self) -> None:
        while self.a < 0x8000:
            self.a = (self.a << 1) & 0xFFFFFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()

    def _ensure(self, idx: int) -> None:
        while len(self.buf) <= idx:
            self.buf.append(0)

    def _byteout(self) -> None:
        self._ensure(self.bp)
        if self.buf[self.bp] == 0xFF:
            self.bp += 1
            self._ensure(self.bp)
            self.buf[self.bp] = (self.c >> 20) & 0xFF
            self.c &= 0xFFFFF
            self.ct = 7
            return
        if (self.c & 0x8000000) == 0:
            self.bp += 1
            self._ensure(self.bp)
            self.buf[self.bp] = (self.c >> 19) & 0xFF
            self.c &= 0x7FFFF
            self.ct = 8
            return
        self.buf[self.bp] = (self.buf[self.bp] + 1) & 0xFF
        if self.buf[self.bp] == 0xFF:
            self.c &= 0x7FFFFFF
            self.bp += 1
            self._ensure(self.bp)
            self.buf[self.bp] = (self.c >> 20) & 0xFF
            self.c &= 0xFFFFF
            self.ct = 7
            return
        self.bp += 1
        self._ensure(self.bp)
        self.buf[self.bp] = (self.c >> 19) & 0xFF
        self.c &= 0x7FFFF
        self.ct = 8

    def _setbits(self) -> None:
        tmp = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tmp:
            self.c -= 0x8000

    def flush(self) -> None:
        """Elias termination (opj_mqc_flush); call once at end of stream."""
        self._setbits()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self._ensure(self.bp)
        if self.buf[self.bp] != 0xFF:
            self.bp += 1

    def erterm(self) -> None:
        """Predictable termination (PTERM; opj_mqc_erterm_enc)."""
        k = 11 - self.ct + 1
        while k > 0:
            self.c = (self.c << self.ct) & 0xFFFFFFFF
            self.ct = 0
            self._byteout()
            k -= self.ct
        self._ensure(self.bp)
        if self.buf[self.bp] != 0xFF:
            self._byteout()

    def restart_init(self) -> None:
        """Re-init after a terminated pass (opj_mqc_restart_init_enc)."""
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        if self.bp > 0:
            self.bp -= 1
        self._ensure(self.bp)
        if self.buf[self.bp] == 0xFF:
            self.ct = 13

    # -- bypass (raw) mode ------------------------------------------------
    def bypass_init(self) -> None:
        self.c = 0
        self.ct = _RAW_CT_INIT

    def bypass_encode(self, bit: int) -> None:
        if self.ct == _RAW_CT_INIT:
            self.ct = 8
        self.ct -= 1
        self.c += bit << self.ct
        if self.ct == 0:
            self._ensure(self.bp)
            self.buf[self.bp] = self.c & 0xFF
            self.ct = 7 if (self.c & 0xFF) == 0xFF else 8
            self.bp += 1
            self.c = 0

    def bypass_flush(self, erterm: bool) -> None:
        if self.ct == _RAW_CT_INIT:
            return  # no raw bits written (matches Go bypassCtInit guard)
        if self.ct < 7 or (self.ct == 7 and (
                erterm or (self.bp > 0 and self.buf[self.bp - 1] != 0xFF))):
            bit = 0
            while self.ct > 0:
                self.ct -= 1
                self.c += bit << self.ct
                bit = 1 - bit
            self._ensure(self.bp)
            self.buf[self.bp] = self.c & 0xFF
            self.bp += 1
        elif self.ct == 7 and self.bp > 0 and self.buf[self.bp - 1] == 0xFF:
            if not erterm:
                self.bp -= 1
        elif (self.ct == 8 and not erterm and self.bp > 1
              and self.buf[self.bp - 1] == 0x7F
              and self.buf[self.bp - 2] == 0xFF):
            self.bp -= 2

    # -- output -----------------------------------------------------------
    def num_bytes(self) -> int:
        return max(self.bp - 1, 0)

    def get_buffer(self) -> bytes:
        if self.bp < 1:
            return b""
        return bytes(self.buf[1 : self.bp])


class MQDecoder:
    """MQ decoder with OpenJPEG bytein/sentinel semantics."""

    def __init__(self, data: bytes, num_contexts: int = 19,
                 contexts: Optional[List[int]] = None) -> None:
        self.data = bytes(data) + b"\xff\xff"
        self.datalen = len(data)
        self.bp = 0
        self.a = 0x8000
        self.c = 0
        self.ct = 0
        if contexts is not None:
            self.ctx = list(contexts)
        else:
            self.ctx = [0] * num_contexts
        self._init()

    def _init(self) -> None:
        if self.datalen == 0:
            self.c = 0xFF << 16
        else:
            self.c = self.data[0] << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def set_context_state(self, cx: int, state: int) -> None:
        self.ctx[cx] = state

    def get_contexts(self) -> List[int]:
        return list(self.ctx)

    def reset_contexts(self) -> None:
        for i in range(len(self.ctx)):
            self.ctx[i] = 0

    def decode(self, cx: int) -> int:
        s = self.ctx[cx]
        state = s & 0x7F
        mps = s >> 7
        qe = QE[state]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:
                self.a = qe
                d = mps
                self.ctx[cx] = NMPS[state] | (mps << 7)
            else:
                self.a = qe
                d = 1 - mps
                nm = (1 - mps) if SWITCH[state] else mps
                self.ctx[cx] = NLPS[state] | (nm << 7)
            self._renormd()
        else:
            self.c -= qe << 16
            if (self.a & 0x8000) != 0:
                return mps
            if self.a < qe:
                d = 1 - mps
                nm = (1 - mps) if SWITCH[state] else mps
                self.ctx[cx] = NLPS[state] | (nm << 7)
            else:
                d = mps
                self.ctx[cx] = NMPS[state] | (mps << 7)
            self._renormd()
        return d

    def _renormd(self) -> None:
        while self.a < 0x8000:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFFFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1

    def _bytein(self) -> None:
        nxt = self.data[self.bp + 1]
        if self.data[self.bp] == 0xFF:
            if nxt > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += nxt << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += nxt << 8
            self.ct = 8


class RawDecoder:
    """Bypass-mode bit reader (opj_mqc_raw_decode)."""

    def __init__(self, data: bytes) -> None:
        self.data = bytes(data) + b"\xff\xff"
        self.bp = 0
        self.c = 0
        self.ct = 0

    def decode(self) -> int:
        if self.ct == 0:
            if self.c == 0xFF:
                nxt = self.data[self.bp]
                if nxt > 0x8F:
                    self.c = 0xFF
                    self.ct = 8
                else:
                    self.c = nxt
                    self.bp += 1
                    self.ct = 7
            else:
                self.c = self.data[self.bp]
                self.bp += 1
                self.ct = 8
        self.ct -= 1
        return (self.c >> self.ct) & 1
