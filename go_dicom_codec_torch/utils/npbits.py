"""Vectorized bit packing/unpacking utilities (host side, numpy).

The reference writes entropy streams bit-by-bit through stateful writers
(jpeg/standard/huffman_encoder.go WriteBits with 0xFF→0xFF00 stuffing).
Here whole symbol streams are packed in one vectorized pass: grouped-arange
expansion → np.packbits → stuffing via a single insert scan.
"""

from __future__ import annotations

import numpy as np

from ..errors import CorruptStreamError


def grouped_arange(lengths: np.ndarray) -> np.ndarray:
    """[3,2] -> [0,1,2,0,1]; per-group arange, fully vectorized."""
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.size == 0:
        return np.zeros(0, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lengths)
    out = np.ones(total, dtype=np.int64)
    out[0] = 0
    nz = lengths > 0
    # start positions of each nonempty group in the flat output
    starts = ends[nz] - lengths[nz]
    out[starts[1:]] = 1 - lengths[nz][:-1]
    return np.cumsum(out)


def pack_bits_msb(values: np.ndarray, lengths: np.ndarray,
                  pad_bit: int = 1) -> np.ndarray:
    """Pack (value, bit-length) pairs MSB-first into a byte array.

    values: uint32/int64 LSB-aligned codes; lengths: bits per value (0 ok).
    Stream is padded to a byte boundary with pad_bit (JPEG pads with 1s).
    """
    values = np.asarray(values, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    from ..native import pack_bits_msb_native
    native = pack_bits_msb_native(values, lengths, pad_bit)
    if native is not None:
        return native
    nz = lengths > 0
    values, lengths = values[nz], lengths[nz]
    if lengths.size == 0:
        return np.zeros(0, dtype=np.uint8)
    sym_idx = np.repeat(np.arange(lengths.size), lengths)
    within = grouped_arange(lengths)
    shift = lengths[sym_idx] - 1 - within
    bits = ((values[sym_idx] >> shift) & 1).astype(np.uint8)
    rem = (-bits.size) % 8
    if rem:
        bits = np.concatenate([bits, np.full(rem, pad_bit, dtype=np.uint8)])
    return np.packbits(bits)


def stuff_ff(data: np.ndarray) -> bytes:
    """Insert 0x00 after every 0xFF (JPEG entropy byte stuffing)."""
    data = np.asarray(data, dtype=np.uint8)
    ff = np.nonzero(data == 0xFF)[0]
    if ff.size == 0:
        return data.tobytes()
    out = np.insert(data, ff + 1, 0)
    return out.tobytes()


def destuff_ff(data: bytes) -> np.ndarray:
    """Remove the 0x00 after every 0xFF; strip any RSTn pairs too.

    Returns the raw entropy bytes for bit reading.
    """
    a = np.frombuffer(data, dtype=np.uint8)
    if a.size == 0:
        return a
    from ..native import jpg_destuff_native
    nat = jpg_destuff_native(a)
    if nat is not None:
        return nat
    ff = a == 0xFF
    nxt = np.zeros_like(ff)
    nxt[1:] = ff[:-1]
    # drop 0x00 stuffing bytes and both bytes of any embedded RST marker
    drop = nxt & (a == 0)
    rst = nxt & (a >= 0xD0) & (a <= 0xD7)
    drop_ff = np.zeros_like(drop)
    drop_ff[:-1] = rst[1:]
    keep = ~(drop | rst | (ff & drop_ff))
    return np.ascontiguousarray(a[keep])


class BitReader:
    """MSB-first bit reader over destuffed entropy bytes.

    O(1) random window access via a precomputed 32-bit sliding window
    (bits beyond the stream read as 1s, matching JPEG padding).
    """

    def __init__(self, data: np.ndarray) -> None:
        data = np.asarray(data, dtype=np.uint8)
        ext = np.concatenate([data, np.full(4, 0xFF, dtype=np.uint8)])
        self.win32 = ((ext[:-3].astype(np.uint64) << 24)
                      | (ext[1:-2].astype(np.uint64) << 16)
                      | (ext[2:-1].astype(np.uint64) << 8)
                      | ext[3:].astype(np.uint64))
        self.nbits = data.size * 8
        self.pos = 0

    def peek16(self) -> int:
        p = self.pos
        b = p >> 3
        if b >= self.win32.size:   # past the end: JPEG 1-bit padding
            return 0xFFFF
        return int(self.win32[b] >> np.uint64(16 - (p & 7))) & 0xFFFF

    def take(self, n: int) -> int:
        """Read n (<= 24) bits MSB-first."""
        if n > 24:
            raise CorruptStreamError(f"bit read of {n} > 24 bits")
        p = self.pos
        b = p >> 3
        self.pos = p + n
        if b >= self.win32.size:   # past the end: JPEG 1-bit padding
            return (1 << n) - 1
        v = int(self.win32[b] >> np.uint64(32 - (p & 7) - n)) & ((1 << n) - 1)
        return v

    def skip(self, n: int) -> None:
        self.pos += n

    def align_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def exhausted(self) -> bool:
        return self.pos >= self.nbits
