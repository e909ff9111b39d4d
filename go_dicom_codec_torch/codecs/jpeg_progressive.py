"""Progressive JPEG (SOF2) decoder — T.81 Annex G, decode only.

Role of the reference's Extended 8-bit decode path, which rides Go
stdlib ``image/jpeg`` and therefore accepts progressive scans
(reference jpeg/extended/encoder_simple.go:35-46): third-party
progressive .50/.51 DICOM streams must decode. Encoding stays
sequential (like the reference, which never emits SOF2).

Structure: the marker loop collects every scan (spectral selection
Ss..Se, successive approximation Ah/Al) into per-component zigzag
coefficient planes, then one dequant+IDCT pass (native host fast path,
ops/dct8x8 device fallback) reconstructs the image. Restart intervals
are handled by splitting the entropy bytes at RSTn markers: each
segment gets a fresh bit reader, DC predictors and EOB run reset.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from ..codestream import jpeg_markers as mk
from ..entropy import huffman as hf
from ..errors import CorruptStreamError, UnsupportedFormatError
from ..utils.npbits import BitReader, destuff_ff
from . import jpeg_common as jc

_RST_RE = re.compile(b"\xff[\xd0-\xd7]")


def _split_restarts(scan_bytes: bytes) -> List[np.ndarray]:
    """Entropy bytes → destuffed segments, one per restart interval."""
    parts = _RST_RE.split(scan_bytes)
    return [destuff_ff(p) for p in parts]


class _Scan:
    def __init__(self, comps, ss, se, ah, al, segments, restart):
        self.comps = comps      # [(comp_index, dc_tid, ac_tid)]
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.segments = segments
        self.restart = restart


def decode(data: bytes):
    """→ (pixels bytes, width, height, components).

    8-bit only (PIL/libjpeg progressive is 8-bit; 12-bit progressive
    does not occur in DICOM practice).
    """
    r = mk.JpegReader(data)
    if r.read_marker() != mk.SOI:
        raise CorruptStreamError("missing SOI")

    qtables: Dict[int, np.ndarray] = {}
    dc_tables: Dict[int, hf.HuffmanTable] = {}
    ac_tables: Dict[int, hf.HuffmanTable] = {}
    restart = 0
    frame = None
    scans: List[_Scan] = []

    while True:
        marker = r.read_marker()
        if marker == mk.SOF2:
            p = r.read_segment()
            if len(p) < 6:
                raise CorruptStreamError("truncated SOF2 header")
            precision = p[0]
            if precision != 8:
                raise UnsupportedFormatError(
                    f"progressive precision {precision} unsupported")
            h = (p[1] << 8) | p[2]
            w = (p[3] << 8) | p[4]
            nc = p[5]
            if w < 1 or h < 1 or nc < 1:
                raise CorruptStreamError("invalid SOF2 dimensions")
            if len(p) < 6 + nc * 3:
                raise CorruptStreamError("truncated SOF2 component table")
            comps = []
            for i in range(nc):
                off = 6 + i * 3
                ch, cv = p[off + 1] >> 4, p[off + 1] & 0x0F
                if not (1 <= ch <= 4 and 1 <= cv <= 4):  # T.81 B.2.2
                    raise CorruptStreamError(
                        f"invalid sampling factors {ch}x{cv}")
                comps.append((p[off], ch, cv, p[off + 2]))
            frame = (precision, w, h, comps)
        elif marker == mk.DQT:
            jc.parse_dqt(r.read_segment(), qtables)
        elif marker == mk.DHT:
            for cls, tid, tab in hf.parse_dht(r.read_segment()):
                (dc_tables if cls == 0 else ac_tables)[tid] = tab
        elif marker == mk.DRI:
            p = r.read_segment()
            restart = (p[0] << 8) | p[1]
        elif marker == mk.SOS:
            if frame is None:
                raise CorruptStreamError("SOS before SOF2")
            p = r.read_segment()
            if len(p) < 4 or len(p) < 4 + p[0] * 2:
                raise CorruptStreamError("truncated SOS header")
            ns = p[0]
            sel = []
            for i in range(ns):
                cid = p[1 + i * 2]
                idx = [j for j, c in enumerate(frame[3]) if c[0] == cid]
                if not idx:
                    raise CorruptStreamError(
                        f"scan references unknown component {cid}")
                sel.append((idx[0], p[2 + i * 2] >> 4, p[2 + i * 2] & 0x0F))
            ss, se = p[1 + ns * 2], p[2 + ns * 2]
            ahal = p[3 + ns * 2]
            scan_bytes, _ = r.find_scan_end()
            # snapshot the tables valid for THIS scan
            scans.append(_Scan(sel, ss, se, ahal >> 4, ahal & 0x0F,
                               _split_restarts(scan_bytes), restart))
        elif marker == mk.EOI:
            break
        else:
            if mk.has_length(marker):
                r.read_segment()
        if marker == mk.SOS:
            # tables may be redefined between scans; bind now
            scans[-1].dc_tables = dict(dc_tables)
            scans[-1].ac_tables = dict(ac_tables)

    if frame is None or not scans:
        raise CorruptStreamError("missing SOF2/SOS")
    precision, width, height, comps = frame
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    mcu_cols = -(-width // (8 * max_h))
    mcu_rows = -(-height // (8 * max_v))

    # per-component padded coefficient grids in zigzag order
    coef = []
    nblocks = []  # true (non-padded) block dims per component
    for (_, ch, cv, _) in comps:
        cw = -(-width * ch // max_h)
        chh = -(-height * cv // max_v)
        nblocks.append((-(-chh // 8), -(-cw // 8)))
        coef.append(np.zeros((mcu_rows * cv, mcu_cols * ch, 64),
                             dtype=np.int32))

    for sc in scans:
        _decode_scan(sc, comps, coef, nblocks, mcu_cols, mcu_rows,
                     max_h, max_v)

    # dequant + IDCT + assemble
    planes = []
    for (_, ch, cv, tq), cf in zip(comps, coef):
        if tq not in qtables:
            raise CorruptStreamError(f"missing quant table {tq}")
        planes.append(jc.idct_and_assemble(
            cf, qtables[tq], precision, ch, cv, max_h, max_v,
            height, width))

    if len(planes) == 1:
        return planes[0].astype(np.uint8).tobytes(), width, height, 1
    from ..ops.dct8x8 import ycbcr_to_rgb_np

    ycc = np.stack(planes, axis=-1).astype(np.uint8)
    return ycbcr_to_rgb_np(ycc).tobytes(), width, height, 3


def _decode_scan(sc: _Scan, comps, coef, nblocks, mcu_cols, mcu_rows,
                 max_h, max_v) -> None:
    if sc.ss == 0:
        if sc.se != 0:
            raise CorruptStreamError("progressive scan mixes DC and AC")
        _decode_dc_scan(sc, comps, coef, nblocks, mcu_cols, mcu_rows)
    else:
        if len(sc.comps) != 1:
            raise CorruptStreamError("progressive AC scan must be "
                                     "non-interleaved")
        _decode_ac_scan(sc, comps, coef, nblocks)


def _decode_dc_scan(sc, comps, coef, nblocks, mcu_cols, mcu_rows) -> None:
    first = sc.ah == 0
    tabs = []
    for (ci, td, _) in sc.comps:
        t = sc.dc_tables.get(td)
        if first and t is None:
            raise CorruptStreamError("missing DC Huffman table")
        tabs.append(t)

    if len(sc.comps) == 1:
        # non-interleaved: one data unit per MCU over the component's
        # own (non-padded) block grid (T.81 A.2.2)
        ci = sc.comps[0][0]
        nby, nbx = nblocks[ci]
        units = [(0, ci, bx, by) for by in range(nby) for bx in range(nbx)]
        n_per_mcu = 1
    else:
        units = None

    seg_iter = iter(sc.segments)
    br = BitReader(next(seg_iter))
    pred = [0] * len(sc.comps)
    interval = sc.restart if sc.restart else (1 << 30)
    mcu = 0

    def _unit(si, ci, bx, by):
        blk = coef[ci][by, bx]
        if first:
            s = tabs[si].decode(br)
            diff = hf.receive_extend(br.take(s), s) if s else 0
            pred[si] += diff
            blk[0] = pred[si] << sc.al
        else:
            if br.take(1):
                blk[0] |= 1 << sc.al

    if units is not None:
        for i, (si, ci, bx, by) in enumerate(units):
            if i > 0 and i % interval == 0:
                try:
                    br = BitReader(next(seg_iter))
                except StopIteration:
                    raise CorruptStreamError("missing restart segment")
                pred = [0] * len(sc.comps)
            _unit(si, ci, bx, by)
        return

    for my in range(mcu_rows):
        for mx in range(mcu_cols):
            if mcu > 0 and mcu % interval == 0:
                try:
                    br = BitReader(next(seg_iter))
                except StopIteration:
                    raise CorruptStreamError("missing restart segment")
                pred = [0] * len(sc.comps)
            mcu += 1
            for si, (ci, _, _) in enumerate(sc.comps):
                _, ch, cv, _ = comps[ci]
                for bv in range(cv):
                    for bh in range(ch):
                        _unit(si, ci, mx * ch + bh, my * cv + bv)


def _decode_ac_scan(sc, comps, coef, nblocks) -> None:
    ci, _, ta = sc.comps[0]
    act = sc.ac_tables.get(ta)
    if act is None:
        raise CorruptStreamError("missing AC Huffman table")
    nby, nbx = nblocks[ci]
    cf = coef[ci]
    first = sc.ah == 0

    seg_iter = iter(sc.segments)
    br = BitReader(next(seg_iter))
    eobrun = 0
    interval = sc.restart if sc.restart else nby * nbx + 1
    blocknum = 0
    for by in range(nby):
        for bx in range(nbx):
            if blocknum > 0 and blocknum % interval == 0:
                try:
                    br = BitReader(next(seg_iter))
                except StopIteration:
                    raise CorruptStreamError("missing restart segment")
                eobrun = 0
            blocknum += 1
            blk = cf[by, bx]
            if first:
                eobrun = _ac_first_block(br, act, blk, sc.ss, sc.se,
                                         sc.al, eobrun)
            else:
                eobrun = _ac_refine_block(br, act, blk, sc.ss, sc.se,
                                          sc.al, eobrun)


def _ac_first_block(br, act, blk, ss, se, al, eobrun) -> int:
    if eobrun > 0:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = act.decode(br)
        r, s = rs >> 4, rs & 0x0F
        if s == 0:
            if r < 15:
                eobrun = (1 << r) - 1
                if r:
                    eobrun += br.take(r)
                return eobrun
            k += 16  # ZRL
            continue
        k += r
        if k > se:
            raise CorruptStreamError("AC index out of band")
        blk[k] = hf.receive_extend(br.take(s), s) << al
        k += 1
    return 0


def _ac_refine_block(br, act, blk, ss, se, al, eobrun) -> int:
    """T.81 G.7.2.3 / libjpeg decode_mcu_AC_refine semantics."""
    p1 = 1 << al
    m1 = -1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = act.decode(br)
            r, s = rs >> 4, rs & 0x0F
            val = 0
            if s == 0:
                if r < 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += br.take(r)
                    break  # fall through to EOB correction below
                # r == 15: ZRL, skip 16 zero-history coefficients
            else:
                if s != 1:
                    raise CorruptStreamError(
                        "invalid refinement magnitude")
                val = p1 if br.take(1) else m1
            # advance past r zero-history coeffs, correcting nonzeros
            while k <= se:
                c = blk[k]
                if c != 0:
                    if br.take(1) and (c & p1) == 0:
                        blk[k] = c + (p1 if c >= 0 else m1)
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if val and k <= se:
                blk[k] = val
            k += 1
    if eobrun > 0:
        # correct remaining nonzero coefficients in the band
        while k <= se:
            c = blk[k]
            if c != 0:
                if br.take(1) and (c & p1) == 0:
                    blk[k] = c + (p1 if c >= 0 else m1)
            k += 1
        eobrun -= 1
    return eobrun
