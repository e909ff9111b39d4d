"""PackBits-style run coder for DICOM RLE Lossless (PS3.5 Annex G).

Behavioral contract from reference rle/rle.go:
  - encoder: literal runs (control 0..127 = n-1 bytes follow) and replicate
    runs (control 257-n two's-complement, one byte follows), runs capped at
    128 (rle/rle.go:208-284);
  - decoder: control>=0 literal, -127<=control<0 replicate, -128 no-op
    (rle/rle.go:353-409).

Unlike the reference's per-byte state machine, the encoder here is fully
vectorized over numpy run-length decomposition: repeat runs of length>=3
become replicate ops, everything between becomes chunked literals. The
bytestream differs from the reference encoder's greedy choices but decodes
identically on any Annex G decoder (the DICOM contract is decode-exactness,
which the roundtrip test matrix pins).
"""

from __future__ import annotations

import numpy as np

from ..errors import CorruptStreamError


def _grouped_arange(lengths: np.ndarray) -> np.ndarray:
    """[3,2] -> [0,1,2,0,1]; vectorized per-group arange."""
    if lengths.size == 0:
        return np.zeros(0, dtype=np.int64)
    total = int(lengths.sum())
    ends = np.cumsum(lengths)
    out = np.ones(total, dtype=np.int64)
    out[0] = 0
    out[ends[:-1]] = 1 - lengths[:-1]
    return np.cumsum(out)


def _chunk_runs(starts: np.ndarray, lengths: np.ndarray, cap: int = 128):
    """Split runs into <=cap chunks. Returns (chunk_starts, chunk_lens)."""
    if starts.size == 0:
        return starts.astype(np.int64), lengths.astype(np.int64)
    n_chunks = (lengths + cap - 1) // cap
    rep_starts = np.repeat(starts, n_chunks)
    rep_lens = np.repeat(lengths, n_chunks)
    within = _grouped_arange(n_chunks)
    chunk_starts = rep_starts + within * cap
    chunk_lens = np.minimum(rep_lens - within * cap, cap)
    return chunk_starts.astype(np.int64), chunk_lens.astype(np.int64)


def packbits_encode(seg: np.ndarray) -> bytes:
    """Encode one byte segment with PackBits (vectorized)."""
    seg = np.ascontiguousarray(seg, dtype=np.uint8)
    n = seg.size
    if n == 0:
        return b""
    from ..native import packbits_encode_native
    native = packbits_encode_native(seg)
    if native is not None:
        return native

    # Run-length decomposition.
    change = np.nonzero(np.diff(seg))[0] + 1
    run_starts = np.concatenate(([0], change)).astype(np.int64)
    run_ends = np.concatenate((change, [n])).astype(np.int64)
    run_lens = run_ends - run_starts
    is_rep = run_lens >= 3

    # Replicate ops (chunked to <=128).
    rep_starts, rep_lens = _chunk_runs(run_starts[is_rep], run_lens[is_rep])

    # Literal regions: maximal spans of consecutive non-repeat runs.
    lit_run_starts = run_starts[~is_rep]
    lit_run_ends = run_ends[~is_rep]
    if lit_run_starts.size:
        # A new literal region starts where the previous literal run does not
        # touch this one (a repeat run sits in between).
        new_region = np.ones(lit_run_starts.size, dtype=bool)
        new_region[1:] = lit_run_starts[1:] != lit_run_ends[:-1]
        region_starts = lit_run_starts[new_region]
        region_ends_idx = np.nonzero(new_region)[0]
        region_ends = np.concatenate((lit_run_ends[region_ends_idx[1:] - 1],
                                      lit_run_ends[-1:]))
        region_lens = region_ends - region_starts
        lit_starts, lit_lens = _chunk_runs(region_starts, region_lens)
    else:
        lit_starts = np.zeros(0, dtype=np.int64)
        lit_lens = np.zeros(0, dtype=np.int64)

    # Merge ops in source order.
    op_starts = np.concatenate((rep_starts, lit_starts))
    op_lens = np.concatenate((rep_lens, lit_lens))
    op_is_rep = np.concatenate(
        (np.ones(rep_starts.size, dtype=bool), np.zeros(lit_starts.size, dtype=bool))
    )
    order = np.argsort(op_starts, kind="stable")
    op_starts, op_lens, op_is_rep = op_starts[order], op_lens[order], op_is_rep[order]

    out_sizes = np.where(op_is_rep, 2, 1 + op_lens)
    out_offs = np.concatenate(([0], np.cumsum(out_sizes)[:-1]))
    out = np.empty(int(out_sizes.sum()), dtype=np.uint8)

    # Replicate ops: header 257-len, then the value byte.
    r_off = out_offs[op_is_rep]
    r_len = op_lens[op_is_rep]
    out[r_off] = ((257 - r_len) & 0xFF).astype(np.uint8)
    out[r_off + 1] = seg[op_starts[op_is_rep]]

    # Literal ops: header len-1, then the raw bytes (vectorized gather).
    l_off = out_offs[~op_is_rep]
    l_len = op_lens[~op_is_rep]
    l_src = op_starts[~op_is_rep]
    out[l_off] = (l_len - 1).astype(np.uint8)
    if l_len.size:
        within = _grouped_arange(l_len)
        dst_idx = np.repeat(l_off + 1, l_len) + within
        src_idx = np.repeat(l_src, l_len) + within
        out[dst_idx] = seg[src_idx]

    return out.tobytes()


def packbits_decode(data: bytes, expected_len: int) -> np.ndarray:
    """Decode one PackBits segment to exactly expected_len bytes.

    Mirrors reference rle/rle.go:353-409: control>=0 literal of control+1
    bytes, control in [-127,-1] replicate of -control+1 copies, -128 skipped.
    Short streams pad with zeros (the reference's resilient stride-write
    leaves untouched bytes zero).
    """
    from ..native import packbits_decode_native
    native = packbits_decode_native(data, expected_len)
    if isinstance(native, tuple):  # ("corrupt", code) — same errors as below
        if native[1] == -1:
            raise CorruptStreamError("RLE literal run exceeds input buffer")
        raise CorruptStreamError("RLE replicate run missing value byte")
    if native is not None:
        return native
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(expected_len, dtype=np.uint8)
    i, pos, n, end = 0, 0, expected_len, src.size
    while i < end and pos < n:
        control = int(src[i])
        i += 1
        if control < 128:  # literal
            length = control + 1
            if end - i < length:
                raise CorruptStreamError("RLE literal run exceeds input buffer")
            length = min(length, n - pos)
            out[pos : pos + length] = src[i : i + length]
            i += control + 1
            pos += length
        elif control > 128:  # replicate (two's complement -127..-1)
            length = 257 - control
            if i >= end:
                raise CorruptStreamError("RLE replicate run missing value byte")
            length = min(length, n - pos)
            out[pos : pos + length] = src[i]
            i += 1
            pos += length
        # control == 128 (-128): no-op, per Annex G / reference :382
    return out
