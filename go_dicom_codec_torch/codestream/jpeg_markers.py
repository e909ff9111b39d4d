"""JPEG marker-level IO (ITU-T T.81 Annex B).

Role of reference jpeg/standard/{markers.go,reader.go,writer.go}: marker
constants, segment reader (big-endian length includes itself), segment
writer. Host-side byte plumbing shared by all four classic-JPEG codecs and
JPEG-LS (which reuses SOF55/SOS framing, reference jpegls/lossless/
encoder.go:105-160).
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

from ..errors import CorruptStreamError

# Marker codes (second byte after 0xFF)
SOI = 0xD8
EOI = 0xD9
SOS = 0xDA
DQT = 0xDB
DNL = 0xDC
DRI = 0xDD
DHP = 0xDE
COM = 0xFE

SOF0 = 0xC0   # Baseline DCT
SOF1 = 0xC1   # Extended sequential DCT
SOF2 = 0xC2   # Progressive DCT
SOF3 = 0xC3   # Lossless (sequential)
DHT = 0xC4
SOF5 = 0xC5
SOF6 = 0xC6
SOF7 = 0xC7
JPG = 0xC8
SOF9 = 0xC9
SOF10 = 0xCA
SOF11 = 0xCB
DAC = 0xCC
SOF13 = 0xCD
SOF14 = 0xCE
SOF15 = 0xCF
SOF55 = 0xF7  # JPEG-LS
LSE = 0xF8    # JPEG-LS parameters

RST0 = 0xD0
RST7 = 0xD7

APP0 = 0xE0
APP15 = 0xEF

_STANDALONE = {SOI, EOI} | set(range(RST0, RST7 + 1)) | {0x01}  # TEM


def is_rst(marker: int) -> bool:
    return RST0 <= marker <= RST7


def has_length(marker: int) -> bool:
    """Whether the marker is followed by a 2-byte length segment."""
    return marker not in _STANDALONE


class JpegWriter:
    """Accumulates a JPEG interchange stream."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def write_marker(self, marker: int) -> None:
        self._parts.append(bytes((0xFF, marker)))

    def write_segment(self, marker: int, payload: bytes) -> None:
        if len(payload) + 2 > 0xFFFF:
            raise ValueError("JPEG segment too long")
        self._parts.append(bytes((0xFF, marker)))
        self._parts.append(struct.pack(">H", len(payload) + 2))
        self._parts.append(payload)

    def write_bytes(self, data: bytes) -> None:
        self._parts.append(data)

    def get_bytes(self) -> bytes:
        return b"".join(self._parts)


class JpegReader:
    """Walks markers/segments of a JPEG stream."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def read_marker(self) -> int:
        """Scan to the next 0xFF-marker, skipping fill bytes."""
        d, n = self.data, len(self.data)
        i = self.pos
        while i < n and d[i] != 0xFF:
            i += 1
        while i + 1 < n and d[i + 1] == 0xFF:  # fill bytes
            i += 1
        if i + 1 >= n:
            raise CorruptStreamError("unexpected end of JPEG stream")
        self.pos = i + 2
        return d[i + 1]

    def read_segment(self) -> bytes:
        if self.pos + 2 > len(self.data):
            raise CorruptStreamError("truncated JPEG segment length")
        (length,) = struct.unpack_from(">H", self.data, self.pos)
        if length < 2 or self.pos + length > len(self.data):
            raise CorruptStreamError("truncated JPEG segment")
        payload = self.data[self.pos + 2 : self.pos + length]
        self.pos += length
        return payload

    def find_scan_end(self, ls_mode: bool = False) -> Tuple[bytes, int]:
        """From pos (just after SOS payload), return (entropy bytes incl.
        RSTn markers, new pos at next non-RST marker).

        ls_mode: JPEG-LS bit-stuffing (T.87 A.1) allows 0xFF followed by
        any byte < 0x80 inside the scan; only 0xFF + >=0x80 is a marker.
        Classic JPEG only stuffs 0xFF 0x00.
        """
        d, n = self.data, len(self.data)
        start = self.pos
        # vectorized: the scan ends at the first 0xFF whose next byte is a
        # real marker (not 0x00 stuffing / RSTn / LS-stuffed <0x80). The
        # second byte of a consumed pair is never 0xFF in any mode, so the
        # first such candidate IS the boundary — no pair-shadowing.
        import numpy as np
        a = np.frombuffer(d, dtype=np.uint8, count=n)
        ffs = np.nonzero(a[start:n - 1] == 0xFF)[0] + start
        nxt = a[ffs + 1]
        if ls_mode:
            stuffed = nxt < 0x80
        else:
            stuffed = (nxt == 0x00) | ((nxt >= 0xD0) & (nxt <= 0xD7))
        cand = ffs[~stuffed]
        i = int(cand[0]) if cand.size else n
        scan = d[start:i]
        self.pos = i
        return scan, i
