"""Packet-header bit IO with JPEG 2000 bit-stuffing (ISO B.10.1).

Role of reference jpeg2000/t2/packet_header_bitio.go: MSB-first bit
writer/reader where a byte equal to 0xFF is followed by a 7-bit byte
(the stuffed 0 bit), matching OpenJPEG opj_bio.
"""

from __future__ import annotations

from ..errors import CorruptStreamError


class BioWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.out = 0
        self.ct = 8

    def write_bit(self, bit: int) -> None:
        if self.ct == 0:
            self._byte_out()
        self.ct -= 1
        if bit:
            self.out |= 1 << self.ct

    def write_bits(self, value: int, n: int) -> None:
        # bulk fill: pack up to `ct` bits per iteration (byte-identical
        # to the bit-at-a-time loop; stuffing happens in _byte_out)
        while n > 0:
            if self.ct == 0:
                self._byte_out()
            take = self.ct if self.ct < n else n
            n -= take
            self.ct -= take
            self.out |= ((value >> n) & ((1 << take) - 1)) << self.ct

    def _byte_out(self) -> None:
        self.out = (self.out << 8) & 0xFFFF
        self.ct = 7 if self.out == 0xFF00 else 8
        self.buf.append((self.out >> 8) & 0xFF)

    def flush(self) -> bytes:
        self._byte_out()
        if self.ct == 7:
            self._byte_out()
        return bytes(self.buf)


class BioReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.buf = 0
        self.ct = 0

    def read_bit(self) -> int:
        if self.ct == 0:
            self._byte_in()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read_bits(self, n: int) -> int:
        # bulk extract: take up to `ct` bits per iteration (identical
        # to the bit-at-a-time loop; de-stuffing happens in _byte_in)
        v = 0
        while n > 0:
            if self.ct == 0:
                self._byte_in()
            take = self.ct if self.ct < n else n
            self.ct -= take
            v = (v << take) | ((self.buf >> self.ct) & ((1 << take) - 1))
            n -= take
        return v

    def align_to_byte(self) -> None:
        """opj_bio_inalign: consume the stuffed byte after a trailing
        0xFF — even when the bit count is already exhausted (the writer's
        flush emits that byte whenever the last data byte is 0xFF,
        regardless of how many of its bits were used)."""
        if (self.buf & 0xFF) == 0xFF:
            self._byte_in()
        self.ct = 0

    def bytes_read(self) -> int:
        return self.pos

    def _byte_in(self) -> None:
        if self.pos >= len(self.data):
            raise CorruptStreamError("packet header bit reader: end of data")
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.buf |= self.data[self.pos]
        self.pos += 1
