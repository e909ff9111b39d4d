"""Shared machinery for the sequential-DCT JPEG codecs (Baseline/Extended).

Covers the role of reference jpeg/standard/tables.go (Annex K quant tables
+ quality scaling) and the scan-level entropy layer that baseline/extended
share (reference jpeg/baseline/encoder.go:260-438, decoder.go:359-498).

Encode is fully vectorized: the device returns whole zigzag coefficient
grids ([..., nblocks, 64] int32, ops/dct8x8.py), and the (runlength,
category) symbol stream for ALL blocks is assembled with numpy array ops —
no per-coefficient Python — then bit-packed in one pass (utils/npbits.py).
Decode is a table-driven sequential loop (the format is serial).

Port of ``go_dicom_codec_tpu/codecs/jpeg_common.py``: only
``idct_and_assemble`` differs. It takes the ``torch.device`` and the
transform engine of the codec calling it: the native host IDCT where the
engine rule of the J2K codecs says native (always without a device, as the
progressive decoder calls it), else one launch of the islow inverse kernel
(ops/jpeg_islow.py) on the device. Its tail is ``assemble_plane``, and
``group_grids`` / ``idct_group`` gather the component grids of a frame
or of a chunk of frames into one inverse launch per grid shape and
precision (the baseline decode and ``pipeline.decode_frames_pipelined_jpeg``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..entropy import huffman as hf
from ..errors import CorruptStreamError, InvalidQualityError
from ..utils.npbits import (BitReader, destuff_ff, grouped_arange,
                            pack_bits_msb, stuff_ff)
from ..codestream import jpeg_markers as mk

# Annex K quantization tables (T.81 Tables K.1/K.2)
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32).reshape(8, 8)

CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32).reshape(8, 8)


def scale_quant_table(base: np.ndarray, quality: int,
                      max_val: int = 255) -> np.ndarray:
    """IJG quality curve (reference jpeg/standard/tables.go:30-58)."""
    if not (1 <= quality <= 100):
        raise InvalidQualityError(f"quality={quality} out of [1, 100]")
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    t = (base.astype(np.int64) * scale + 50) // 100
    return np.clip(t, 1, max_val).astype(np.int32)


from ..ops.dct8x8 import ZIGZAG  # raster position of zigzag index


def dqt_payload(table_id: int, qtable: np.ndarray) -> bytes:
    """8- or 16-bit precision DQT payload, zigzag ordered."""
    zz = qtable.reshape(64)[ZIGZAG]
    if int(zz.max()) <= 255:
        return bytes([table_id]) + zz.astype(np.uint8).tobytes()
    return bytes([0x10 | table_id]) + zz.astype(">u2").tobytes()


def parse_dqt(payload: bytes, out: Dict[int, np.ndarray]) -> None:
    off = 0
    while off < len(payload):
        pq, tq = payload[off] >> 4, payload[off] & 0x0F
        off += 1
        n = 128 if pq else 64
        if off + n > len(payload):
            raise CorruptStreamError("truncated DQT")
        if pq:
            zz = np.frombuffer(payload[off : off + 128], dtype=">u2")
        else:
            zz = np.frombuffer(payload[off : off + 64], dtype=np.uint8)
        t = np.zeros(64, dtype=np.int32)
        t[ZIGZAG] = zz
        out[tq] = t.reshape(8, 8)
        off += n


def sof_payload(precision: int, width: int, height: int,
                comps: Sequence[Tuple[int, int, int, int]]) -> bytes:
    """comps: (component_id, h, v, quant_table_id)."""
    out = bytearray([precision, height >> 8, height & 0xFF,
                     width >> 8, width & 0xFF, len(comps)])
    for cid, h, v, tq in comps:
        out += bytes([cid, (h << 4) | v, tq])
    return bytes(out)


def sos_payload(comps: Sequence[Tuple[int, int, int]],
                ss: int = 0, se: int = 63, ah_al: int = 0) -> bytes:
    """comps: (component_id, dc_table, ac_table)."""
    out = bytearray([len(comps)])
    for cid, td, ta in comps:
        out += bytes([cid, (td << 4) | ta])
    out += bytes([ss, se, ah_al])
    return bytes(out)


# ---- vectorized sequential-DCT symbol stream --------------------------------

@dataclass
class _SymbolStream:
    """Flat arrays describing every emitted Huffman symbol + extra bits."""
    sym: np.ndarray        # uint8 RS byte / DC category
    ebits: np.ndarray      # extra-bits value
    elen: np.ndarray       # extra-bits length
    is_dc: np.ndarray      # bool: DC symbol (selects table class)
    tbl: np.ndarray        # table id per symbol (0 luma / 1 chroma)
    block: np.ndarray      # MCU/block index (ordering key, primary)
    comp: np.ndarray       # component slot within MCU (secondary)
    seq: np.ndarray        # within-component-block order (tertiary)


def _component_symbols(zz: np.ndarray, table_id: int, comp_slot: int,
                       restart_interval: int = 0) -> _SymbolStream:
    """Symbols for one component's zigzag blocks [N, 64] (MCU order)."""
    n = zz.shape[0]
    dc = zz[:, 0].astype(np.int64)
    prev = np.concatenate(([0], dc[:-1]))
    if restart_interval:
        # DC prediction resets at every restart boundary
        reset = np.arange(n) % restart_interval == 0
        prev = np.where(reset, 0, prev)
    dcdiff = dc - prev
    dccat = hf.categories(dcdiff)
    dceb = hf.extend_bits(dcdiff, dccat)

    dc_stream = _SymbolStream(
        sym=dccat.astype(np.uint8), ebits=dceb, elen=dccat,
        is_dc=np.ones(n, dtype=bool),
        tbl=np.full(n, table_id, dtype=np.int8),
        block=np.arange(n, dtype=np.int64),
        comp=np.full(n, comp_slot, dtype=np.int8),
        seq=np.zeros(n, dtype=np.int64))

    # AC: nonzeros of positions 1..63
    ac = zz[:, 1:].astype(np.int64)
    bl, pos = np.nonzero(ac)          # sorted by (block, pos)
    vals = ac[bl, pos]
    pos = pos + 1                     # zigzag index 1..63
    # previous nonzero position within the same block
    prev_pos = np.concatenate(([0], pos[:-1]))
    first_in_block = np.concatenate(([True], bl[1:] != bl[:-1]))
    prev_pos = np.where(first_in_block, 0, prev_pos)
    run = pos - prev_pos - 1
    nzrl = run // 16
    rem = run % 16
    cat = hf.categories(vals)
    eb = hf.extend_bits(vals, cat)
    rs = (rem << 4) | cat

    # expand: nzrl ZRL symbols then the RS symbol, per nonzero
    counts = nzrl + 1
    src = np.repeat(np.arange(bl.size), counts)
    w = grouped_arange(counts)
    is_zrl = w < nzrl[src]
    ac_sym = np.where(is_zrl, 0xF0, rs[src]).astype(np.uint8)
    ac_eb = np.where(is_zrl, 0, eb[src])
    ac_el = np.where(is_zrl, 0, cat[src])
    ac_bl = bl[src]
    # order within block: expansion preserves (pos, w) order; rank items
    total = ac_sym.size
    if total:
        idx = np.arange(total, dtype=np.int64)
        newblk = np.concatenate(([True], ac_bl[1:] != ac_bl[:-1]))
        starts = np.where(newblk, idx, 0)
        ac_seq = idx - np.maximum.accumulate(starts) + 1
    else:
        ac_seq = np.zeros(0, dtype=np.int64)

    ac_stream = _SymbolStream(
        sym=ac_sym, ebits=ac_eb, elen=ac_el,
        is_dc=np.zeros(total, dtype=bool),
        tbl=np.full(total, table_id, dtype=np.int8),
        block=ac_bl.astype(np.int64),
        comp=np.full(total, comp_slot, dtype=np.int8),
        seq=ac_seq)

    # EOB: any block whose last nonzero is before position 63 (or all-zero)
    last_nz = np.zeros(n, dtype=np.int64)
    if bl.size:
        np.maximum.at(last_nz, bl, pos)
    eob_blocks = np.nonzero(last_nz < 63)[0]
    m = eob_blocks.size
    eob_stream = _SymbolStream(
        sym=np.zeros(m, dtype=np.uint8), ebits=np.zeros(m, dtype=np.int64),
        elen=np.zeros(m, dtype=np.int64), is_dc=np.zeros(m, dtype=bool),
        tbl=np.full(m, table_id, dtype=np.int8),
        block=eob_blocks.astype(np.int64),
        comp=np.full(m, comp_slot, dtype=np.int8),
        seq=np.full(m, 1 << 20, dtype=np.int64))

    return _merge_streams([dc_stream, ac_stream, eob_stream], sort=False)


def _merge_streams(streams: List[_SymbolStream], sort: bool) -> _SymbolStream:
    cat = lambda f: np.concatenate([getattr(s, f) for s in streams])
    out = _SymbolStream(sym=cat("sym"), ebits=cat("ebits"), elen=cat("elen"),
                        is_dc=cat("is_dc"), tbl=cat("tbl"),
                        block=cat("block"), comp=cat("comp"), seq=cat("seq"))
    if sort:
        order = np.lexsort((out.seq, out.comp, out.block))
        for f in ("sym", "ebits", "elen", "is_dc", "tbl", "block", "comp",
                  "seq"):
            setattr(out, f, getattr(out, f)[order])
    return out


def build_scan_symbols(comp_zz: Sequence[np.ndarray],
                       table_ids: Sequence[int],
                       restart_interval: int = 0) -> _SymbolStream:
    """Interleaved scan symbols for components' zigzag blocks [N, 64].

    All components must have equal N (1:1:1 sampling — the only layout the
    reference encoder emits, jpeg/baseline/encoder.go:306-333).
    """
    streams = [
        _component_symbols(zz, table_ids[i], i, restart_interval)
        for i, zz in enumerate(comp_zz)
    ]
    return _merge_streams(streams, sort=True)


def count_frequencies(stream: _SymbolStream, n_tables: int):
    """Per-table DC/AC symbol histograms (for optimal Huffman tables)."""
    dc = np.zeros((n_tables, 256), dtype=np.int64)
    ac = np.zeros((n_tables, 256), dtype=np.int64)
    for t in range(n_tables):
        sel = stream.tbl == t
        d = sel & stream.is_dc
        a = sel & ~stream.is_dc
        dc[t] = np.bincount(stream.sym[d], minlength=256)
        ac[t] = np.bincount(stream.sym[a], minlength=256)
    return dc, ac


def encode_scan(stream: _SymbolStream,
                dc_tables: Sequence[hf.HuffmanTable],
                ac_tables: Sequence[hf.HuffmanTable],
                restart_interval: int = 0,
                n_mcus: int = 0) -> bytes:
    """Huffman-code the symbol stream → stuffed entropy bytes (+RSTn)."""
    n = stream.sym.size
    codes = np.zeros(n, dtype=np.int64)
    lens = np.zeros(n, dtype=np.int64)
    for t in range(len(dc_tables)):
        for is_dc, tab in ((True, dc_tables[t]), (False, ac_tables[t])):
            sel = (stream.tbl == t) & (stream.is_dc == is_dc)
            if not sel.any():
                continue
            codes[sel] = tab.code_of[stream.sym[sel]]
            lens[sel] = tab.len_of[stream.sym[sel]]
            if (lens[sel] == 0).any():
                raise CorruptStreamError("symbol missing from Huffman table")

    # interleave code and extra-bit entries
    vals = np.stack([codes, stream.ebits], axis=1).reshape(-1)
    vl = np.stack([lens, stream.elen], axis=1).reshape(-1)

    if not restart_interval:
        return stuff_ff(pack_bits_msb(vals, vl))

    # split the stream at restart boundaries; emit RSTn between intervals
    out = bytearray()
    n_intervals = (n_mcus + restart_interval - 1) // restart_interval
    interval_of_sym = stream.block // restart_interval
    # vals/vl entries are symbol-paired
    iv2 = np.repeat(interval_of_sym, 2)
    for i in range(n_intervals):
        sel = iv2 == i
        out += stuff_ff(pack_bits_msb(vals[sel], vl[sel]))
        if i + 1 < n_intervals:
            out += bytes((0xFF, mk.RST0 + (i % 8)))
    return bytes(out)


# ---- sequential scan decode -------------------------------------------------

def decode_scan(scan_bytes: bytes,
                comp_layout: Sequence[Tuple[int, int, int, int, int]],
                dc_tables: Dict[int, hf.HuffmanTable],
                ac_tables: Dict[int, hf.HuffmanTable],
                mcu_cols: int, mcu_rows: int,
                restart_interval: int = 0) -> List[np.ndarray]:
    """Decode an interleaved sequential-DCT scan.

    comp_layout: per component (h, v, dc_tid, ac_tid, blocks_per_row).
    Returns per-component zigzag coefficient arrays [nblocks, 64] int32
    where block index = by * blocks_per_row + bx (padded MCU grid).

    Mirrors reference jpeg/baseline/decoder.go:359-498 but with proper
    restart handling (byte-align + DC predictor reset at RSTn).
    """
    destuffed = destuff_ff(scan_bytes)
    from ..native import jpg_decode_scan_native

    native = jpg_decode_scan_native(destuffed, comp_layout, dc_tables,
                                    ac_tables, mcu_cols, mcu_rows,
                                    restart_interval)
    if native is not None:
        return native

    br = BitReader(destuffed)
    ncomp = len(comp_layout)
    out = []
    for (h, v, _, _, bpr) in comp_layout:
        out.append(np.zeros((mcu_rows * v * bpr, 64), dtype=np.int32))

    dc_pred = [0] * ncomp
    mcu_index = 0
    for my in range(mcu_rows):
        for mx in range(mcu_cols):
            if restart_interval and mcu_index > 0 and \
                    mcu_index % restart_interval == 0:
                br.align_byte()
                dc_pred = [0] * ncomp
            mcu_index += 1
            for ci, (h, v, dct_id, act_id, bpr) in enumerate(comp_layout):
                dct = dc_tables.get(dct_id)
                act = ac_tables.get(act_id)
                if dct is None or act is None:
                    raise CorruptStreamError("missing Huffman table")
                for bv in range(v):
                    for bh in range(h):
                        bx = mx * h + bh
                        by = my * v + bv
                        blk = _decode_block(br, dct, act, dc_pred, ci)
                        if bx < bpr:
                            out[ci][by * bpr + bx] = blk
    return out


def _decode_block(br: BitReader, dct: hf.HuffmanTable, act: hf.HuffmanTable,
                  dc_pred: List[int], ci: int) -> np.ndarray:
    coef = np.zeros(64, dtype=np.int32)
    s = dct.decode(br)
    diff = hf.receive_extend(br.take(s), s) if s else 0
    dc_pred[ci] += diff
    coef[0] = dc_pred[ci]
    k = 1
    while k < 64:
        rs = act.decode(br)
        r, s = rs >> 4, rs & 0x0F
        if s == 0:
            if r == 15:
                k += 16
                continue
            break  # EOB
        k += r
        if k >= 64:
            raise CorruptStreamError("AC coefficient index out of range")
        coef[k] = hf.receive_extend(br.take(s), s)
        k += 1
    return coef


def idct_and_assemble(cf: np.ndarray, qtable: np.ndarray, precision: int,
                      ch: int, cv: int, max_h: int, max_v: int,
                      height: int, width: int, *,
                      device: Optional[torch.device] = None,
                      engine: str = "auto") -> np.ndarray:
    """Dequant + IDCT one component's zigzag block grid ([rows, cols, 64]
    int32) — the native host IDCT where ``device`` and ``engine`` say
    native (``jpeg2000._native_53``: no device, "host", or "auto" where
    the device's measured transfer policy does not prefer it), else one
    launch on ``device`` (the plain torch version on the CPU) — then bring
    it to full image resolution: crop at full rate, nearest-neighbor for
    non-integer ratios, libjpeg-style upsample otherwise.

    Shared by the sequential (jpeg_baseline) and progressive
    (jpeg_progressive) decoders. Unlike the codecs' ``encode`` and
    ``decode``, ``device`` keeps its default of None (the native lane):
    jpeg_progressive.py is a verbatim copy of the reference and calls this
    without a device (its line 156). The device lane reads the plane back in
    the narrowest unsigned dtype that holds it: the same values as the
    native lane's int32.
    """
    from .jpeg2000 import _native_53

    if _native_53(device, engine):
        plane = idct_native(cf, qtable, precision)
    else:
        from ..ops.jpeg_islow import idct_islow, plane_dtype

        max_val = (1 << precision) - 1
        plane = idct_islow(torch.as_tensor(cf, device=device), qtable,
                           1 << (precision - 1), max_val,
                           plane_dtype(max_val)).cpu().numpy()
    return assemble_plane(plane, ch, cv, max_h, max_v, height, width)


def idct_native(cf: np.ndarray, qtable: np.ndarray,
                precision: int) -> np.ndarray:
    """Dequant + IDCT + shift + clamp of one component grid on the host:
    the native library's, else (where it did not build) the numpy
    mirror."""
    from ..native import jpg_idct_native

    level = 1 << (precision - 1)
    max_val = (1 << precision) - 1
    plane = jpg_idct_native(cf, qtable, level, max_val)
    if plane is None:
        from ..ops.dct8x8 import decode_zigzag_to_plane_np

        plane = decode_zigzag_to_plane_np(cf, qtable, level, max_val)
    return plane


def assemble_plane(plane: np.ndarray, ch: int, cv: int, max_h: int,
                   max_v: int, height: int, width: int) -> np.ndarray:
    """A component's dequantized, inverse-transformed plane at full image
    resolution: cropped at full rate, nearest-neighbor for non-integer
    ratios, libjpeg-style upsampled otherwise (``idct_and_assemble``'s
    tail)."""
    if ch == max_h and cv == max_v:
        return plane[:height, :width]
    if max_h % ch or max_v % cv:
        ys = (np.arange(height) * cv) // max_v
        xs = (np.arange(width) * ch) // max_h
        return plane[np.ix_(ys, xs)]
    cw = -(-width * ch // max_h)
    chh = -(-height * cv // max_v)
    return fancy_upsample(plane[:chh, :cw], max_h // ch, max_v // cv,
                          height, width)


def group_grids(grids: Sequence[np.ndarray], tables: Sequence[np.ndarray],
                precisions: Sequence[int]) -> List[tuple]:
    """The inverse launches of a set of component grids ([rows, cols, 64]
    each, with its quant table and sample precision): one a (rows, cols,
    precision), in order of first appearance, as (precision, member
    positions, int32 [T, 64] stack of the group's distinct tables, each
    member's index into it)."""
    groups: Dict[tuple, tuple] = {}
    for pos, (grid, table, prec) in enumerate(zip(grids, tables,
                                                  precisions)):
        key = (grid.shape[0], grid.shape[1], prec)
        members, distinct, index = groups.setdefault(key, ([], {}, []))
        t = np.ascontiguousarray(table, dtype=np.int32).reshape(64)
        members.append(pos)
        index.append(distinct.setdefault(t.tobytes(), len(distinct)))
    return [(key[2], members,
             np.stack([np.frombuffer(b, np.int32) for b in distinct]),
             tuple(index))
            for key, (members, distinct, index) in groups.items()]


def idct_group(zz: torch.Tensor, tables: np.ndarray, index: tuple,
               precision: int) -> torch.Tensor:
    """Dequant + IDCT of a group's grids ``zz`` [P, rows, cols, 64] (int16
    or int32) on their device, plane p by ``tables[index[p]]``: one launch
    of the islow inverse kernel on a GPU (its plain version on the CPU),
    into the narrowest unsigned dtype that holds ``precision`` bits."""
    from ..ops import jpeg_islow

    max_val = (1 << precision) - 1
    return jpeg_islow.idct_islow(zz, tables, 1 << (precision - 1), max_val,
                                 jpeg_islow.plane_dtype(max_val),
                                 table_index=index)


def fancy_upsample(plane: np.ndarray, fh: int, fv: int, height: int,
                   width: int) -> np.ndarray:
    """libjpeg-style triangular chroma upsampling (jdsample.c
    h2v1/h2v2_fancy_upsample semantics) for the fh==2 cases; every other
    factor combination — including 4:4:0 (fh==1, fv==2) — replicates
    samples like libjpeg's int_upsample, which is what jinit_upsampler
    selects for them. plane: [ch, cw] int; → [height, width] int32.

    Matches what the PIL/libjpeg foreign oracle computes, so decoded
    subsampled streams agree with it to IDCT rounding.
    """
    p = plane.astype(np.int32)
    ch, cw = p.shape
    if fh == 2 and fv in (1, 2):
        if fv == 2:
            iy = np.arange(height) >> 1
            oy = np.where((np.arange(height) & 1) == 0, iy - 1, iy + 1)
            np.clip(iy, 0, ch - 1, out=iy)
            np.clip(oy, 0, ch - 1, out=oy)
            s = 3 * p[iy] + p[oy]      # [height, cw], 2 fraction bits
            sh = 2
        else:
            s = p[np.minimum(np.arange(height), ch - 1)]
            sh = 0
        ix = np.arange(width) >> 1
        ox = np.where((np.arange(width) & 1) == 0, ix - 1, ix + 1)
        np.clip(ix, 0, cw - 1, out=ix)
        np.clip(ox, 0, cw - 1, out=ox)
        even = (np.arange(width) & 1) == 0
        # jdsample.c: h2v2 rounds +8 even / +7 odd, h2v1 +1 even / +2 odd
        bias = np.where(even, 8, 7) if sh == 2 else np.where(even, 1, 2)
        return (3 * s[:, ix] + s[:, ox] + bias) >> (sh + 2)
    ys = np.minimum(np.arange(height) // max(fv, 1), ch - 1)
    xs = np.minimum(np.arange(width) // max(fh, 1), cw - 1)
    return p[np.ix_(ys, xs)]
