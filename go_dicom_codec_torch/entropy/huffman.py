"""JPEG Huffman coding (ITU-T T.81 Annex C/K), host-side, vectorized.

Covers the roles of reference jpeg/standard/{huffman.go, huffman_codec.go,
huffman_encoder.go, optimal_huffman.go, tables.go}: canonical table build,
the Annex K default tables, libjpeg-style optimal (length-limited) table
construction, category/extend value coding, and scan-level encode — but the
encode path emits whole symbol arrays packed in one numpy pass instead of a
per-bit state machine, and decode uses a 16-bit window LUT.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..errors import CorruptStreamError
from ..utils.npbits import BitReader, grouped_arange


@dataclass
class HuffmanTable:
    """Canonical JPEG Huffman table: counts per code length + values."""

    bits: Sequence[int]          # 16 counts, code lengths 1..16
    values: np.ndarray           # symbols in canonical order

    code_of: np.ndarray = field(init=False)   # [256] canonical code
    len_of: np.ndarray = field(init=False)    # [256] code length (0 if unused)
    lut16: Optional[np.ndarray] = field(init=False, default=None)

    def __post_init__(self) -> None:
        # exactly sum(bits) symbols are defined; drop any trailing bytes
        # so DHT emission and canonical assignment agree
        self.values = np.asarray(self.values,
                                 dtype=np.uint8)[:sum(self.bits)]
        self.code_of = np.zeros(256, dtype=np.int64)
        self.len_of = np.zeros(256, dtype=np.int64)
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(self.bits[length - 1]):
                sym = int(self.values[k])
                self.code_of[sym] = code
                self.len_of[sym] = length
                code += 1
                k += 1
            code <<= 1

    # -- decoding -----------------------------------------------------------
    def build_lut(self) -> np.ndarray:
        """65536-entry LUT: 16-bit window → (length << 8) | symbol."""
        if self.lut16 is not None:
            return self.lut16
        lut = np.zeros(1 << 16, dtype=np.int32)
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(self.bits[length - 1]):
                sym = int(self.values[k])
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                lut[lo:hi] = (length << 8) | sym
                code += 1
                k += 1
            code <<= 1
        self.lut16 = lut
        return lut

    def decode(self, br: BitReader) -> int:
        lut = self.build_lut()
        entry = int(lut[br.peek16()])
        if entry == 0:
            raise CorruptStreamError("invalid Huffman code in stream")
        br.skip(entry >> 8)
        return entry & 0xFF


# ---- Annex K default tables (ITU-T T.81 Tables K.3-K.6) --------------------

DC_LUMA = HuffmanTable(
    bits=[0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
    values=np.arange(12, dtype=np.uint8))
DC_CHROMA = HuffmanTable(
    bits=[0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    values=np.arange(12, dtype=np.uint8))

_AC_LUMA_VALUES = bytes.fromhex(
    "010203000411051221314106135161071422711432818191a1082342b1c11552"
    "d1f02433627282090a161718191a25262728292a3435363738393a4344454647"
    "48494a535455565758595a636465666768696a737475767778797a8384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6"
    "f7f8f9fa")
AC_LUMA = HuffmanTable(
    bits=[0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    values=np.frombuffer(_AC_LUMA_VALUES, dtype=np.uint8))

_AC_CHROMA_VALUES = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c10923335215"
    "62f0246434d17282e1f1156272d10a162434e125f11718191a262728292a3536"
    "3738393a434445464748494a535455565758595a636465666768696a73747576"
    "7778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2"
    "b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7"
    "e8e9eaf2f3f4f5f6f7f8f9fa")
AC_CHROMA = HuffmanTable(
    bits=[0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
    values=np.frombuffer(_AC_CHROMA_VALUES, dtype=np.uint8))


# ---- optimal table construction (libjpeg jpeg_gen_optimal_table) ----------

def _huffman_code_sizes(freq257, maxlen):
    """K.2 two-smallest merge with the 'others' chain → per-symbol code
    sizes; ok=False when any size exceeds maxlen (caller rescales)."""
    freq = list(freq257)
    codesize = [0] * 257
    others = [-1] * 257
    alive = [sym for sym in range(257) if freq[sym]]
    while True:
        # smallest nonzero frequency; ties → highest symbol (libjpeg rule)
        c1 = c2 = -1
        v1 = v2 = None
        for sym in alive:
            f = freq[sym]
            if v1 is None or f <= v1:
                c2, v2 = c1, v1
                c1, v1 = sym, f
            elif v2 is None or f <= v2:
                c2, v2 = sym, f
        if c2 < 0:
            break

        freq[c1] += freq[c2]
        freq[c2] = 0
        alive.remove(c2)
        s = c1
        while True:
            codesize[s] += 1
            if others[s] < 0:
                break
            s = others[s]
        others[s] = c2
        s = c2
        while s >= 0:
            codesize[s] += 1
            s = others[s]
    return codesize, max(codesize) <= maxlen


def build_optimal_table(freq256: np.ndarray) -> HuffmanTable:
    """Length-limited (16) optimal table per T.81 Annex K.2 / libjpeg.

    Role of reference jpeg/standard/optimal_huffman.go:7 — two-smallest
    merge with the 'others' chain, pseudo-symbol 256 reserving the all-ones
    code, then the >16-bit reshuffle.
    """
    MAXLEN = 32
    # plain-Python lists: only ~#nonzero-symbols merge rounds happen, so
    # per-call numpy dispatch overhead dominated the array formulation
    base_freq = [0] * 257
    for i, v in enumerate(np.asarray(freq256, dtype=np.int64).tolist()):
        base_freq[i] = v
    base_freq[256] = 1  # reserve all-ones code

    while True:  # retry with halved counts if the tree exceeds MAXLEN
        codesize, ok = _huffman_code_sizes(base_freq, MAXLEN)
        if ok:
            break
        # pathological skew (libjpeg would raise JERR_HUFF_CLEN_OVERFLOW
        # here): flatten the distribution and rebuild
        base_freq = [(f + 1) // 2 if f else 0 for f in base_freq]
        base_freq[256] = max(base_freq[256], 1)
    bits = [0] * (MAXLEN + 1)
    for size in codesize:
        if size > 0:
            bits[size] += 1

    for size in range(MAXLEN, 16, -1):
        while bits[size] > 0:
            j = size - 2
            while bits[j] == 0:
                j -= 1
            bits[size] -= 2
            bits[size - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1

    for size in range(MAXLEN, 0, -1):
        if bits[size] > 0:
            bits[size] -= 1  # drop the pseudo-symbol
            break

    values: List[int] = []
    for size in range(1, MAXLEN + 1):
        for sym in range(256):
            if codesize[sym] == size:
                values.append(sym)
    return HuffmanTable(bits=[int(b) for b in bits[1:17]],
                        values=np.array(values, dtype=np.uint8))


# ---- value category coding (T.81 F.1.2.1/F.2.2.1) --------------------------

def categories(values: np.ndarray) -> np.ndarray:
    """Bit category of each value: 0 for 0, else bitlength(|v|)."""
    a = np.abs(np.asarray(values, dtype=np.int64))
    cat = np.zeros(a.shape, dtype=np.int64)
    nz = a > 0
    cat[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    # log2 can misround near 2^k boundaries at huge magnitudes; correct:
    too_hi = nz & (a < (1 << np.maximum(cat - 1, 0)))
    cat[too_hi] -= 1
    too_lo = nz & (a >= (1 << cat))
    cat[too_lo] += 1
    return cat


def extend_bits(values: np.ndarray, cats: np.ndarray) -> np.ndarray:
    """Low 'cat' bits encoding the signed value (negatives: v-1 pattern)."""
    v = np.asarray(values, dtype=np.int64)
    return np.where(v >= 0, v, v + (1 << cats) - 1)


def receive_extend(v: int, s: int) -> int:
    """Inverse of extend_bits for one decoded value (huffman.go:189)."""
    if s == 0:
        return 0
    if v < (1 << (s - 1)):
        return v - (1 << s) + 1
    return v


def dht_payload(tables: Sequence[Tuple[int, int, HuffmanTable]]) -> bytes:
    """Build a DHT payload for (class, id, table) triples."""
    out = bytearray()
    for cls, tid, t in tables:
        out.append((cls << 4) | tid)
        out.extend(int(b) for b in t.bits)
        out.extend(t.values.tobytes())
    return bytes(out)


def parse_dht(payload: bytes):
    """Parse a DHT payload → list of (class, id, HuffmanTable)."""
    out = []
    off = 0
    while off < len(payload):
        tc_th = payload[off]
        off += 1
        bits = list(payload[off : off + 16])
        if len(bits) != 16:
            raise CorruptStreamError("truncated DHT bits table")
        off += 16
        total = sum(bits)
        vals = np.frombuffer(payload[off : off + total], dtype=np.uint8)
        if vals.size != total:
            raise CorruptStreamError("truncated DHT")
        off += total
        out.append((tc_th >> 4, tc_th & 0x0F, HuffmanTable(bits=bits, values=vals)))
    return out
