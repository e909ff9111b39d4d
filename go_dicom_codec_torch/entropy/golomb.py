"""Golomb-Rice bit IO with JPEG-LS marker stuffing (ITU-T T.87 A.1).

Role of reference jpegls/lossless/golomb.go: MSB-first writer where a byte
after 0xFF carries only 7 bits, limited-length Golomb coding with the
escape form (limit/qbpp), and the mirror reader (CharLS semantics).
"""

from __future__ import annotations

from ..errors import CorruptStreamError


class GolombWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.bitbuf = 0
        self.free = 32
        self.ff_written = False

    def write_bits(self, bits: int, n: int) -> None:
        self.free -= n
        if self.free >= 0:
            self.bitbuf = (self.bitbuf | (bits << self.free)) & 0xFFFFFFFF
        else:
            self.bitbuf = (self.bitbuf | (bits >> -self.free)) & 0xFFFFFFFF
            self._flush()
            if self.free < 0:
                self.bitbuf = (self.bitbuf | (bits >> -self.free)) & 0xFFFFFFFF
                self._flush()
            self.bitbuf = (self.bitbuf | (bits << self.free)) & 0xFFFFFFFF

    def write_bit(self, bit: int) -> None:
        self.write_bits(bit & 1, 1)

    def _flush(self) -> None:
        for _ in range(4):
            if self.free >= 32:
                self.free = 32
                break
            if self.ff_written:
                b = (self.bitbuf >> 25) & 0x7F
                self.bitbuf = (self.bitbuf << 7) & 0xFFFFFFFF
                self.free += 7
            else:
                b = (self.bitbuf >> 24) & 0xFF
                self.bitbuf = (self.bitbuf << 8) & 0xFFFFFFFF
                self.free += 8
            self.buf.append(b)
            self.ff_written = b == 0xFF

    def finish(self) -> bytes:
        """CharLS end_scan: flush, pad after 0xFF, flush again."""
        self._flush()
        if self.ff_written:
            self.write_bits(0, (self.free - 1) % 8)
        self._flush()
        return bytes(self.buf)

    def write_unary(self, n: int) -> None:
        """n zeros then a 1."""
        while n + 1 > 31:
            self.write_bits(0, 31)
            n -= 31
        self.write_bits(1, n + 1)

    def write_zeros(self, n: int) -> None:
        while n > 0:
            c = min(n, 31)
            self.write_bits(0, c)
            n -= c

    def encode_mapped(self, k: int, mapped: int, limit: int, qbpp: int) -> None:
        """Limited Golomb code (golomb.go:183-234 / CharLS)."""
        high = mapped >> k
        if high < limit - (qbpp + 1):
            if high + 1 > 31:
                self.write_zeros(high // 2)
                high -= high // 2
            self.write_unary(high)
            if k > 0:
                self.write_bits(mapped & ((1 << k) - 1), k)
            return
        escape = limit - qbpp
        if escape > 31:
            self.write_zeros(31)
            self.write_unary(escape - 31 - 1)
        else:
            self.write_unary(escape - 1)
        self.write_bits((mapped - 1) & ((1 << qbpp) - 1), qbpp)


class GolombReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.cache = 0
        self.valid = 0

    def _fill(self) -> None:
        while self.valid < 56:
            if self.pos >= len(self.data):
                if self.valid <= 0:
                    # feed 1-bits at EOF like a terminating marker boundary
                    self.cache = (self.cache << 8) | 0xFF
                    self.valid += 8
                    continue
                break
            b = self.data[self.pos]
            prev_ff = self.pos > 0 and self.data[self.pos - 1] == 0xFF
            self.pos += 1
            if prev_ff:
                # stuffed byte: only 7 valid bits
                self.cache = (self.cache << 7) | (b & 0x7F)
                self.valid += 7
            else:
                self.cache = (self.cache << 8) | b
                self.valid += 8

    def read_bit(self) -> int:
        if self.valid == 0:
            self._fill()
            if self.valid == 0:
                raise CorruptStreamError("JPEG-LS scan data exhausted")
        self.valid -= 1
        return (self.cache >> self.valid) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def decode_value(self, k: int, limit: int, qbpp: int) -> int:
        """Limited Golomb decode (golomb.go:283-330 / CharLS)."""
        high = 0
        while self.read_bit() == 0:
            high += 1
            if high > 100000:
                raise CorruptStreamError("runaway unary code")
        if high >= limit - (qbpp + 1):
            return self.read_bits(qbpp) + 1
        if k == 0:
            return high
        return (high << k) + self.read_bits(k)
