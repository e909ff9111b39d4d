"""JPEG 2000 codestream marker IO (ISO/IEC 15444-1 Annex A).

Role of reference jpeg2000/codestream/ (markers.go, parser.go, types.go)
and the main-header writers in jpeg2000/encoder.go:1098-1822: SOC/SIZ/COD/
COC/QCD/QCC/RGN/COM/CAP/POC main header, SOT/SOD tile-parts (merged by
Isot/TPsot), EOC. The parser returns typed segments; per-tile COD/QCD
overrides resolve against main-header defaults.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..errors import CorruptStreamError

# Marker codes (full 16-bit values)
SOC = 0xFF4F
SOT = 0xFF90
SOD = 0xFF93
EOC = 0xFFD9
SIZ = 0xFF51
COD = 0xFF52
COC = 0xFF53
TLM = 0xFF55
PLM = 0xFF57
PLT = 0xFF58
QCD = 0xFF5C
QCC = 0xFF5D
RGN = 0xFF5E
POC = 0xFF5F
PPM = 0xFF60
PPT = 0xFF61
CRG = 0xFF63
COM = 0xFF64
CAP = 0xFF50
SOP = 0xFF91
EPH = 0xFF92

# Progression orders (Table A.16)
PROG_LRCP = 0
PROG_RLCP = 1
PROG_RPCL = 2
PROG_PCRL = 3
PROG_CPRL = 4
PROG_NAMES = {0: "LRCP", 1: "RLCP", 2: "RPCL", 3: "PCRL", 4: "CPRL"}


@dataclass
class SizInfo:
    xsiz: int
    ysiz: int
    xosiz: int = 0
    yosiz: int = 0
    xtsiz: int = 0
    ytsiz: int = 0
    xtosiz: int = 0
    ytosiz: int = 0
    # per component: (depth, signed, xrsiz, yrsiz)
    components: List[Tuple[int, bool, int, int]] = field(default_factory=list)

    @property
    def num_tiles(self) -> Tuple[int, int]:
        ntx = -(-(self.xsiz - self.xtosiz) // self.xtsiz)
        nty = -(-(self.ysiz - self.ytosiz) // self.ytsiz)
        return ntx, nty

    def tile_rect(self, ti: int, tj: int) -> Tuple[int, int, int, int]:
        """Tile (ti, tj) bounds on the reference grid (B.3)."""
        tx0 = max(self.xtosiz + ti * self.xtsiz, self.xosiz)
        ty0 = max(self.ytosiz + tj * self.ytsiz, self.yosiz)
        tx1 = min(self.xtosiz + (ti + 1) * self.xtsiz, self.xsiz)
        ty1 = min(self.ytosiz + (tj + 1) * self.ytsiz, self.ysiz)
        return tx0, ty0, tx1, ty1


@dataclass
class CodInfo:
    progression: int = PROG_LRCP
    num_layers: int = 1
    mct: int = 0                 # 1 = RCT/ICT applied to components 0-2
    num_levels: int = 5
    cb_width: int = 64
    cb_height: int = 64
    cb_style: int = 0            # Table A.18 flags; 0x40 ⇒ HT (Part 15)
    transform: int = 1           # 1 = 5/3 reversible, 0 = 9/7 irreversible
    precinct_exps: Optional[List[Tuple[int, int]]] = None  # (PPx, PPy)/res
    use_sop: bool = False
    use_eph: bool = False

    def precinct_exp(self, res: int) -> Tuple[int, int]:
        if self.precinct_exps is None or res >= len(self.precinct_exps):
            return 15, 15
        return self.precinct_exps[res]


@dataclass
class QcdInfo:
    style: int = 0               # 0 none, 1 scalar derived, 2 scalar expounded
    guard_bits: int = 2
    exponents: List[int] = field(default_factory=list)       # style 0
    steps: List[Tuple[int, int]] = field(default_factory=list)  # (expn, mant)

    def num_bands_encoded(self) -> int:
        return len(self.exponents) if self.style == 0 else len(self.steps)


@dataclass
class CocInfo:
    """Per-component coding style (COC, T.800 A.6.2) — overrides only the
    SPcod half of COD; progression/layers/MCT stay with COD (reference
    codestream/types.go TileCOD fallback logic)."""
    comp: int = 0
    num_levels: int = 5
    cb_width: int = 64
    cb_height: int = 64
    cb_style: int = 0
    transform: int = 1
    precinct_exps: Optional[List[Tuple[int, int]]] = None


@dataclass
class PocEntry:
    """One progression-order change (POC, T.800 A.6.6)."""
    rs: int      # RSpoc: first resolution
    cs: int      # CSpoc: first component
    lye: int     # LYEpoc: layer bound (exclusive)
    re: int      # REpoc: resolution bound (exclusive)
    ce: int      # CEpoc: component bound (exclusive)
    prog: int    # Ppoc: progression order for this span


@dataclass
class TileInfo:
    index: int
    data: bytes = b""
    cod: Optional[CodInfo] = None
    qcd: Optional[QcdInfo] = None
    coc: Dict[int, CocInfo] = field(default_factory=dict)
    qcc: Dict[int, QcdInfo] = field(default_factory=dict)
    poc: List[PocEntry] = field(default_factory=list)
    # packed packet headers (T.800 A.7.4/A.7.5): merged PPT payloads in
    # (tile-part, Zppt) order, or this tile's share of the main-header
    # PPM stream. None = packet headers live in the bitstream. The
    # reference defines the PPM/PPT constants but never implements them
    # (codestream/markers.go:69-72 only); this decoder accepts both.
    ppt: Optional[bytes] = None
    # PLT packet lengths (T.800 A.8.2), merged across tile-parts in
    # (TPsot, Zplt) order — varints re-parsed over the join so lengths
    # split between segments survive. None = no PLT in the stream.
    # The decoder uses these to skip dropped-resolution packets under
    # reduced-resolution decode without bit-parsing their headers.
    plt: Optional[List[int]] = None


def _overlay_coc(base: CodInfo, coc: CocInfo) -> CodInfo:
    """COD with its coding-style half replaced by a COC override."""
    import dataclasses
    return dataclasses.replace(
        base, num_levels=coc.num_levels, cb_width=coc.cb_width,
        cb_height=coc.cb_height, cb_style=coc.cb_style,
        transform=coc.transform, precinct_exps=coc.precinct_exps)


@dataclass
class Codestream:
    siz: SizInfo
    cod: CodInfo
    qcd: QcdInfo
    tiles: Dict[int, TileInfo] = field(default_factory=dict)
    comments: List[bytes] = field(default_factory=list)
    rgn_shifts: Dict[int, int] = field(default_factory=dict)  # comp → SPrgn
    rgn_styles: Dict[int, int] = field(default_factory=dict)  # comp → Srgn
    cap: Optional[bytes] = None
    mct_segments: List[bytes] = field(default_factory=list)
    mcc_segments: List[bytes] = field(default_factory=list)
    mco_segments: List[bytes] = field(default_factory=list)
    coc: Dict[int, CocInfo] = field(default_factory=dict)
    qcc: Dict[int, QcdInfo] = field(default_factory=dict)
    poc: List[PocEntry] = field(default_factory=list)

    def cod_for(self, comp: int, tile: Optional[TileInfo] = None) -> CodInfo:
        """Effective coding style for a component (T.800 precedence:
        tile COC > tile COD > main COC > main COD; reference
        codestream/types.go:200-280 resolution chain)."""
        if tile is not None and comp in tile.coc:
            return _overlay_coc(tile.cod or self.cod, tile.coc[comp])
        if tile is not None and tile.cod is not None:
            return tile.cod
        if comp in self.coc:
            return _overlay_coc(self.cod, self.coc[comp])
        return self.cod

    def qcd_for(self, comp: int, tile: Optional[TileInfo] = None) -> QcdInfo:
        """Effective quantization for a component (tile QCC > tile QCD >
        main QCC > main QCD)."""
        if tile is not None and comp in tile.qcc:
            return tile.qcc[comp]
        if tile is not None and tile.qcd is not None:
            return tile.qcd
        if comp in self.qcc:
            return self.qcc[comp]
        return self.qcd

    def poc_for(self, tile: Optional[TileInfo] = None) -> List[PocEntry]:
        """Effective progression-order changes (tile POC replaces main)."""
        if tile is not None and tile.poc:
            return tile.poc
        return self.poc


# ---- writers ---------------------------------------------------------------

def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def write_siz(siz: SizInfo) -> bytes:
    payload = struct.pack(">HIIIIIIIIH", 0, siz.xsiz, siz.ysiz, siz.xosiz,
                          siz.yosiz, siz.xtsiz, siz.ytsiz, siz.xtosiz,
                          siz.ytosiz, len(siz.components))
    for depth, signed, xr, yr in siz.components:
        ssiz = (depth - 1) | (0x80 if signed else 0)
        payload += struct.pack(">BBB", ssiz, xr, yr)
    return _seg(SIZ, payload)


def write_cod(cod: CodInfo) -> bytes:
    scod = 0
    if cod.precinct_exps is not None:
        scod |= 0x01
    if cod.use_sop:
        scod |= 0x02
    if cod.use_eph:
        scod |= 0x04
    payload = struct.pack(">BBHB", scod, cod.progression, cod.num_layers,
                          cod.mct)
    payload += struct.pack(
        ">BBBBB", cod.num_levels,
        cod.cb_width.bit_length() - 3, cod.cb_height.bit_length() - 3,
        cod.cb_style, cod.transform)
    if cod.precinct_exps is not None:
        for (ppx, ppy) in cod.precinct_exps:
            payload += struct.pack(">B", (ppy << 4) | ppx)
    return _seg(COD, payload)


def write_qcd(qcd: QcdInfo) -> bytes:
    sqcd = (qcd.guard_bits << 5) | (qcd.style & 0x1F)
    payload = struct.pack(">B", sqcd)
    if qcd.style == 0:
        for e in qcd.exponents:
            payload += struct.pack(">B", (e << 3) & 0xFF)
    else:
        for (e, m) in qcd.steps:
            payload += struct.pack(">H", ((e & 0x1F) << 11) | (m & 0x7FF))
    return _seg(QCD, payload)


def _comp_fmt(num_components: int) -> str:
    return ">B" if num_components < 257 else ">H"


def write_coc(coc: CocInfo, num_components: int) -> bytes:
    """COC segment (T.800 A.6.2)."""
    payload = struct.pack(_comp_fmt(num_components), coc.comp)
    payload += struct.pack(">B", 0x01 if coc.precinct_exps is not None else 0)
    payload += struct.pack(
        ">BBBBB", coc.num_levels,
        coc.cb_width.bit_length() - 3, coc.cb_height.bit_length() - 3,
        coc.cb_style, coc.transform)
    if coc.precinct_exps is not None:
        for (ppx, ppy) in coc.precinct_exps:
            payload += struct.pack(">B", (ppy << 4) | ppx)
    return _seg(COC, payload)


def write_qcc(comp: int, qcd: QcdInfo, num_components: int) -> bytes:
    """QCC segment (T.800 A.6.5): Cqcc + the QCD body."""
    payload = struct.pack(_comp_fmt(num_components), comp)
    payload += struct.pack(">B", (qcd.guard_bits << 5) | (qcd.style & 0x1F))
    if qcd.style == 0:
        for e in qcd.exponents:
            payload += struct.pack(">B", (e << 3) & 0xFF)
    else:
        for (e, m) in qcd.steps:
            payload += struct.pack(">H", ((e & 0x1F) << 11) | (m & 0x7FF))
    return _seg(QCC, payload)


def write_poc(entries: List[PocEntry], num_components: int) -> bytes:
    """POC segment (T.800 A.6.6)."""
    cf = _comp_fmt(num_components)
    payload = b""
    for e in entries:
        payload += struct.pack(">B", e.rs) + struct.pack(cf, e.cs)
        payload += struct.pack(">HB", e.lye, e.re) + struct.pack(cf, e.ce)
        payload += struct.pack(">B", e.prog)
    return _seg(POC, payload)


def write_plt(zplt: int, packet_lengths: List[int]) -> bytes:
    """PLT segment (T.800 A.8.2): 7-bit big-endian varint packet lengths."""
    payload = bytearray([zplt & 0xFF])
    for n in packet_lengths:
        chunk = bytearray([n & 0x7F])
        n >>= 7
        while n:
            chunk.insert(0, 0x80 | (n & 0x7F))
            n >>= 7
        payload += chunk
    return _seg(PLT, bytes(payload))


def write_plt_segments(packet_lengths: List[int],
                       max_chunk: int = 65532) -> bytes:
    """One or more PLT segments (T.800 A.8.2) covering a tile-part's
    packet lengths, split BETWEEN varints at the segment-length limit
    with ascending Zplt (write_plt emits a single segment; real tiles
    can exceed 65535 bytes of varints)."""
    out = bytearray()
    z = 0
    cur = bytearray()
    step = min(max_chunk, 65532)

    def flush():
        nonlocal z, cur
        if z > 255:
            raise ValueError(
                "packet lengths exceed 256 PLT segments (Zplt is 8-bit)")
        out.extend(_seg(PLT, bytes([z]) + bytes(cur)))
        z += 1
        cur = bytearray()

    for n in packet_lengths:
        chunk = bytearray([n & 0x7F])
        n >>= 7
        while n:
            chunk.insert(0, 0x80 | (n & 0x7F))
            n >>= 7
        if len(cur) + len(chunk) > step and cur:
            flush()
        cur += chunk
    flush()
    return bytes(out)


def write_ppt(headers: bytes, max_chunk: int = 65532) -> bytes:
    """PPT segments (T.800 A.7.5) carrying one tile's packed packet
    headers, split at the 16-bit segment-length limit with ascending
    Zppt (max_chunk is lowerable for split-coverage tests). The
    reference never writes PPM/PPT (markers.go:69-72 defines the
    constants only); this writer exists for the packed_headers encode
    option and for building decoder test vectors."""
    out = bytearray()
    z = 0
    pos = 0
    step = min(max_chunk, 65532)  # Lppt <= 65535 = L(2) + Zppt(1) + data
    while True:
        if z > 255:
            raise ValueError(
                "packed packet headers exceed 256 PPT segments "
                "(Zppt is 8-bit)")
        chunk = headers[pos:pos + step]
        out += _seg(PPT, bytes([z]) + chunk)
        pos += len(chunk)
        z += 1
        if pos >= len(headers):
            break
    return bytes(out)


def write_ppm(records: List[bytes], max_chunk: int = 65532) -> bytes:
    """PPM segments (T.800 A.7.4): one [Nppm u32][Ippm] record per
    tile-part in codestream order, split across Zppm segments at the
    16-bit length limit (records may straddle segment boundaries —
    lower max_chunk to exercise that in tests)."""
    stream = bytearray()
    for rec in records:
        stream += struct.pack(">I", len(rec)) + rec
    out = bytearray()
    z = 0
    pos = 0
    step = min(max_chunk, 65532)
    while True:
        if z > 255:
            raise ValueError(
                "packed packet headers exceed 256 PPM segments "
                "(Zppm is 8-bit)")
        chunk = stream[pos:pos + step]
        out += _seg(PPM, bytes([z]) + bytes(chunk))
        pos += len(chunk)
        z += 1
        if pos >= len(stream):
            break
    return bytes(out)


def write_tlm(ztlm: int, entries: List[Tuple[int, int]]) -> bytes:
    """TLM segment (T.800 A.7.1): (Ttlm, Ptlm) with ST=2, SP=1
    (16-bit tile index, 32-bit tile-part length — reference
    encoder.go writeTLM)."""
    stlm = (2 << 4) | (1 << 6)
    payload = struct.pack(">BB", ztlm & 0xFF, stlm)
    for (ttlm, ptlm) in entries:
        payload += struct.pack(">HI", ttlm, ptlm)
    return _seg(TLM, payload)


def parse_coc(payload: bytes, num_components: int) -> CocInfo:
    wide = num_components >= 257
    off = 2 if wide else 1
    if len(payload) < off + 6:
        raise CorruptStreamError("COC too short")
    comp = struct.unpack_from(_comp_fmt(num_components), payload, 0)[0]
    scoc = payload[off]
    levels, cbw_e, cbh_e, cb_style, transform = struct.unpack_from(
        ">BBBBB", payload, off + 1)
    coc = CocInfo(comp=comp, num_levels=levels, cb_width=1 << (cbw_e + 2),
                  cb_height=1 << (cbh_e + 2), cb_style=cb_style,
                  transform=transform)
    if scoc & 0x01:
        exps = []
        for i in range(levels + 1):
            p = off + 6 + i
            if p >= len(payload):
                break
            b = payload[p]
            exps.append((b & 0x0F, b >> 4))
        coc.precinct_exps = exps
    return coc


def parse_qcc(payload: bytes, num_components: int) -> Tuple[int, QcdInfo]:
    wide = num_components >= 257
    off = 2 if wide else 1
    if len(payload) < off + 1:
        raise CorruptStreamError("QCC too short")
    comp = struct.unpack_from(_comp_fmt(num_components), payload, 0)[0]
    return comp, parse_qcd(payload[off:])


def parse_poc(payload: bytes, num_components: int) -> List[PocEntry]:
    cf = _comp_fmt(num_components)
    cw = 2 if num_components >= 257 else 1
    step = 1 + cw + 2 + 1 + cw + 1
    entries = []
    off = 0
    while off + step <= len(payload):
        rs = payload[off]
        cs = struct.unpack_from(cf, payload, off + 1)[0]
        lye, re = struct.unpack_from(">HB", payload, off + 1 + cw)
        ce = struct.unpack_from(cf, payload, off + 4 + cw)[0]
        prog = payload[off + 4 + 2 * cw]
        entries.append(PocEntry(rs=rs, cs=cs, lye=lye, re=re, ce=ce,
                                prog=prog))
        off += step
    return entries


def _plt_varints(data: bytes) -> List[int]:
    """7-bit big-endian varint run → packet lengths (T.800 A.8.2)."""
    lengths = []
    n = 0
    for b in data:
        n = (n << 7) | (b & 0x7F)
        if not (b & 0x80):
            lengths.append(n)
            n = 0
    return lengths


def parse_plt(payload: bytes) -> Tuple[int, List[int]]:
    """→ (Zplt, packet lengths)."""
    if not payload:
        raise CorruptStreamError("PLT empty")
    return payload[0], _plt_varints(payload[1:])


def parse_tlm(payload: bytes) -> Tuple[int, List[Tuple[int, int]]]:
    """→ (Ztlm, [(Ttlm, Ptlm)])."""
    if len(payload) < 2:
        raise CorruptStreamError("TLM too short")
    ztlm, stlm = payload[0], payload[1]
    st = (stlm >> 4) & 0x3
    sp = 4 if (stlm >> 6) & 0x1 else 2
    entries = []
    off = 2
    i = 0
    while off + st + sp <= len(payload):
        if st == 0:
            ttlm = i
        elif st == 1:
            ttlm = payload[off]
        else:
            ttlm = struct.unpack_from(">H", payload, off)[0]
        ptlm = struct.unpack_from(">I" if sp == 4 else ">H",
                                  payload, off + st)[0]
        entries.append((ttlm, ptlm))
        off += st + sp
        i += 1
    return ztlm, entries


def write_com(text: bytes, binary: bool = False) -> bytes:
    return _seg(COM, struct.pack(">H", 0 if binary else 1) + text)


def write_rgn(comp: int, shift: int, num_components: int,
              style: int = 0) -> bytes:
    """RGN segment; style (Srgn): 0 = implicit MaxShift, 1 = General
    Scaling (reference encoder.go:1765-1775)."""
    if num_components <= 256:
        payload = struct.pack(">BBB", comp, style, shift)
    else:
        payload = struct.pack(">HBB", comp, style, shift)
    return _seg(RGN, payload)


def write_tile_part(index: int, tile_data: bytes, tpsot: int = 0,
                    tnsot: int = 1, head_segments: bytes = b"") -> bytes:
    """SOT + optional tile-part-header segments (e.g. PPT) + SOD + data
    (reference encoder.go:2105-2133 framing)."""
    # SOT segment + header segments + SOD marker + body
    psot = 12 + len(head_segments) + 2 + len(tile_data)
    sot = struct.pack(">HHHIBB", SOT, 10, index, psot, tpsot, tnsot)
    return sot + head_segments + struct.pack(">H", SOD) + tile_data


def write_cap(pcap: int, ccap: List[int]) -> bytes:
    payload = struct.pack(">I", pcap)
    for c in ccap:
        payload += struct.pack(">H", c)
    return _seg(CAP, payload)


# ---- Part 2 multi-component transform markers (ISO 15444-2 Annex A) --------

MCT_MARKER = 0xFF74
MCC_MARKER = 0xFF75
MCO_MARKER = 0xFF77

MCT_ARRAY_DECORRELATE = 0
MCT_ARRAY_OFFSET = 2
MCT_ELEM_I16, MCT_ELEM_I32, MCT_ELEM_F32, MCT_ELEM_F64 = 0, 1, 2, 3

_ELEM_FMT = {MCT_ELEM_I16: ">h", MCT_ELEM_I32: ">i",
             MCT_ELEM_F32: ">f", MCT_ELEM_F64: ">d"}


def write_mct_record(index: int, array_type: int, elem_type: int,
                     values: List[float]) -> bytes:
    """MCT segment (reference encoder.go:863-882 layout)."""
    fmt = _ELEM_FMT[elem_type]
    data = b"".join(struct.pack(fmt, int(v) if elem_type < 2 else float(v))
                    for v in values)
    imct = (index & 0xFF) | (array_type << 8) | (elem_type << 10)
    payload = struct.pack(">HHH", 0, imct, 0) + data
    return _seg(MCT_MARKER, payload)


def write_mcc_record(index: int, comp_ids: List[int], reversible: bool,
                     deco_index: int, offset_index: int) -> bytes:
    """MCC segment (reference encoder.go:884-942 layout)."""
    wide = any(c > 255 for c in comp_ids)
    payload = struct.pack(">HBHHB", 0, index, 0, 1, 1)
    n = len(comp_ids) | (0x8000 if wide else 0)
    ids = b"".join(struct.pack(">H" if wide else ">B", c) for c in comp_ids)
    payload += struct.pack(">H", n) + ids
    payload += struct.pack(">H", n) + ids
    tmcc = (deco_index & 0xFF) | ((offset_index & 0xFF) << 8) | \
        ((1 << 16) if reversible else 0)
    payload += bytes([(tmcc >> 16) & 0xFF, (tmcc >> 8) & 0xFF, tmcc & 0xFF])
    return _seg(MCC_MARKER, payload)


def write_mco_record(order: List[int]) -> bytes:
    """MCO segment (reference encoder.go:944-964)."""
    return _seg(MCO_MARKER, bytes([len(order)]) + bytes(order))


def parse_mct_segment(payload: bytes):
    """→ (index, array_type, elem_type, [values])."""
    if len(payload) < 6:
        raise CorruptStreamError("MCT segment too short")
    _, imct, _ = struct.unpack_from(">HHH", payload, 0)
    index = imct & 0xFF
    array_type = (imct >> 8) & 0x3
    elem_type = (imct >> 10) & 0x3
    fmt = _ELEM_FMT[elem_type]
    size = struct.calcsize(fmt)
    body = payload[6:]
    vals = [struct.unpack_from(fmt, body, i)[0]
            for i in range(0, len(body) - size + 1, size)]
    return index, array_type, elem_type, vals


def parse_mcc_segment(payload: bytes):
    """→ (index, comp_ids, reversible, deco_index, offset_index)."""
    if len(payload) < 8:
        raise CorruptStreamError("MCC segment too short")
    _, index, _, _, _ = struct.unpack_from(">HBHHB", payload, 0)
    off = 8
    n = struct.unpack_from(">H", payload, off)[0]
    off += 2
    wide = bool(n & 0x8000)
    count = n & 0x7FFF
    ids = []
    for _ in range(count):
        if wide:
            ids.append(struct.unpack_from(">H", payload, off)[0])
            off += 2
        else:
            ids.append(payload[off])
            off += 1
    # skip the mirrored Mmcci list
    m = struct.unpack_from(">H", payload, off)[0]
    off += 2 + (m & 0x7FFF) * (2 if m & 0x8000 else 1)
    if off + 3 > len(payload):
        raise CorruptStreamError("MCC segment truncated")
    tmcc = (payload[off] << 16) | (payload[off + 1] << 8) | payload[off + 2]
    return (index, ids, bool(tmcc & 0x10000), tmcc & 0xFF,
            (tmcc >> 8) & 0xFF)


def parse_mco_segment(payload: bytes) -> List[int]:
    if not payload:
        return []
    n = payload[0]
    return list(payload[1 : 1 + n])


# ---- parser ----------------------------------------------------------------

def parse_codestream(data: bytes) -> Codestream:
    """Parse main header + tile-parts (reference codestream/parser.go:24-520).

    Tile-part bodies with the same Isot are concatenated in TPsot order.
    Any struct-level short-buffer error from corrupted segment payloads
    surfaces as CorruptStreamError.
    """
    try:
        return _parse_codestream(data)
    except struct.error as e:
        raise CorruptStreamError(f"corrupt marker payload: {e}") from e


_JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"


def unwrap_jp2(data: bytes) -> bytes:
    """The contiguous codestream (jp2c box payload) of a JP2/JPH file
    (ISO 15444-1 Annex I box structure; 15444-15 JPH shares it).

    DICOM transports raw codestreams, and the reference only handles
    those — but real-world J2K files are usually JP2-wrapped (PIL and
    OpenJPEG write JP2 by default), so the decoder accepts both."""
    pos = 0
    n = len(data)
    while pos + 8 <= n:
        lbox = struct.unpack_from(">I", data, pos)[0]
        tbox = data[pos + 4:pos + 8]
        payload = pos + 8
        if lbox == 1:  # XLBox: 64-bit length
            if payload + 8 > n:
                raise CorruptStreamError("truncated JP2 XLBox")
            end = pos + struct.unpack_from(">Q", data, payload)[0]
            payload += 8
        elif lbox == 0:  # to end of file
            end = n
        else:
            end = pos + lbox
        if end < payload or end > n:
            raise CorruptStreamError(f"JP2 box {tbox!r} overruns file")
        if tbox == b"jp2c":
            return data[payload:end]
        pos = end
    raise CorruptStreamError("JP2 file has no jp2c codestream box")


def _jp2_box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def wrap_jp2(codestream: bytes, brand: str = "jp2") -> bytes:
    """Wrap a raw codestream in a JP2 (ISO 15444-1 Annex I) or JPH
    (ISO 15444-15 Annex A) file: signature + ftyp + jp2h(ihdr [+ bpcc]
    + colr) + jp2c. Image geometry, component count and bit depths are
    derived from the codestream's own SIZ marker.

    Write direction of `unwrap_jp2` (the reference transports raw
    codestreams only — containers are beyond it); output round-trips
    through PIL/OpenJPEG and OpenJPH file tooling. Use brand="jph" for
    HTJ2K codestreams (a Part-15 file is not "jp2 "-compatible).

    Colour specification: enumerated sRGB for >= 3 components,
    greyscale otherwise; for component counts other than 1 or 3 the
    ihdr UnkC flag is set (colourspace not reliably known).
    """
    if brand not in ("jp2", "jph"):
        raise ValueError(f"brand must be 'jp2' or 'jph', got {brand!r}")
    if len(codestream) < 8 or struct.unpack_from(">H", codestream, 0)[0] \
            != SOC or struct.unpack_from(">H", codestream, 2)[0] != SIZ:
        raise CorruptStreamError("not a J2K codestream (no SOC+SIZ)")
    # SIZ segment spans offsets [4, 4+Lsiz): Lsiz counts itself but not
    # the marker, payload follows the 2-byte length field
    lsiz = struct.unpack_from(">H", codestream, 4)[0]
    if lsiz < 2 or 4 + lsiz > len(codestream):
        raise CorruptStreamError("SIZ overruns codestream")
    siz = parse_siz(codestream[6:4 + lsiz])

    width = siz.xsiz - siz.xosiz
    height = siz.ysiz - siz.yosiz
    nc = len(siz.components)
    depth_sign = [(d, s) for (d, s, _, _) in siz.components]
    uniform = all(ds == depth_sign[0] for ds in depth_sign)
    if uniform:
        d, s = depth_sign[0]
        bpc = (d - 1) | (0x80 if s else 0)
    else:
        bpc = 255  # per-component depths live in a bpcc box
    unkc = 0 if nc in (1, 3) else 1
    ihdr = struct.pack(">IIHBBBB", height, width, nc, bpc, 7, unkc, 0)
    enumcs = 16 if nc >= 3 else 17  # sRGB / greyscale
    colr = struct.pack(">BBBI", 1, 0, 0, enumcs)
    jp2h = _jp2_box(b"ihdr", ihdr)
    if not uniform:
        jp2h += _jp2_box(b"bpcc", bytes(
            (d - 1) | (0x80 if s else 0) for d, s in depth_sign))
    jp2h += _jp2_box(b"colr", colr)

    btag = b"jp2 " if brand == "jp2" else b"jph "
    ftyp = btag + struct.pack(">I", 0) + btag  # brand, minor, compat list
    return (_JP2_SIGNATURE + _jp2_box(b"ftyp", ftyp)
            + _jp2_box(b"jp2h", jp2h) + _jp2_box(b"jp2c", codestream))


def _parse_codestream(data: bytes) -> Codestream:
    if data.startswith(_JP2_SIGNATURE):
        data = unwrap_jp2(data)
    if len(data) < 4 or struct.unpack_from(">H", data, 0)[0] != SOC:
        raise CorruptStreamError("missing SOC marker")
    pos = 2
    siz = cod = qcd = None
    comments: List[bytes] = []
    rgn: Dict[int, int] = {}
    rgn_style: Dict[int, int] = {}
    cap = None
    mct_segments: List[bytes] = []
    mcc_segments: List[bytes] = []
    mco_segments: List[bytes] = []
    main_coc: Dict[int, CocInfo] = {}
    main_qcc: Dict[int, QcdInfo] = {}
    main_poc: List[PocEntry] = []
    tiles: Dict[int, Dict[int, TileInfo]] = {}
    ppm_segs: List[Tuple[int, bytes]] = []          # (Zppm, payload)
    ppt_parts: Dict[int, Dict[int, List[Tuple[int, bytes]]]] = {}
    plt_parts: Dict[int, Dict[int, List[Tuple[int, bytes]]]] = {}
    part_order: List[int] = []  # Isot per tile-part, stream order (PPM)

    def ncomp():
        if siz is None:
            raise CorruptStreamError("COC/QCC/POC before SIZ")
        return len(siz.components)

    def read_seg(p):
        if p + 4 > len(data):
            raise CorruptStreamError("truncated marker segment")
        marker, length = struct.unpack_from(">HH", data, p)
        if length < 2 or p + 2 + length > len(data):
            raise CorruptStreamError(f"truncated segment 0x{marker:04X}")
        return marker, data[p + 4 : p + 2 + length], p + 2 + length

    while pos < len(data):
        if pos + 2 > len(data):
            raise CorruptStreamError("truncated codestream")
        try:
            marker = _next_marker(data, pos)
        except struct.error as e:
            raise CorruptStreamError(f"truncated codestream: {e}") from e
        if marker == EOC:
            break
        if marker == SOT:
            _, payload, body_start = read_seg(pos)
            if len(payload) < 8 or body_start + 2 > len(data):
                raise CorruptStreamError("truncated SOT segment")
            # unpack_from: a corrupt Lsot can legally exceed 10 bytes
            isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", payload)
            tcod = tqcd = None
            tcoc: Dict[int, CocInfo] = {}
            tqcc: Dict[int, QcdInfo] = {}
            tpoc: List[PocEntry] = []
            if struct.unpack_from(">H", data, body_start)[0] != SOD:
                # per-tile segments (COD/COC/QCD/QCC/POC/COM…) before SOD
                p = body_start
                while struct.unpack_from(">H", data, p)[0] != SOD:
                    m, pl, p = read_seg(p)
                    if m == COD:
                        tcod = parse_cod(pl)
                    elif m == QCD:
                        tqcd = parse_qcd(pl)
                    elif m == COC:
                        ci = parse_coc(pl, ncomp())
                        tcoc[ci.comp] = ci
                    elif m == QCC:
                        cc, qq = parse_qcc(pl, ncomp())
                        tqcc[cc] = qq
                    elif m == POC:
                        tpoc = parse_poc(pl, ncomp())
                    elif m == PPT:
                        if not pl:
                            raise CorruptStreamError("empty PPT segment")
                        ppt_parts.setdefault(isot, {}).setdefault(
                            tpsot, []).append((pl[0], pl[1:]))
                    elif m == PLT:
                        if not pl:
                            raise CorruptStreamError("PLT empty")
                        plt_parts.setdefault(isot, {}).setdefault(
                            tpsot, []).append((pl[0], pl[1:]))
                body_start = p
            part_order.append(isot)
            body_end = pos + psot if psot else len(data)
            if body_end > len(data):
                body_end = len(data)
            body = data[body_start + 2 : body_end]
            part = TileInfo(index=isot, data=body, cod=tcod, qcd=tqcd,
                            coc=tcoc, qcc=tqcc, poc=tpoc)
            tiles.setdefault(isot, {})[tpsot] = part
            pos = body_end
            continue
        m, payload, pos = read_seg(pos)
        if m == SIZ:
            siz = parse_siz(payload)
        elif m == COD:
            cod = parse_cod(payload)
        elif m == QCD:
            qcd = parse_qcd(payload)
        elif m == COM:
            comments.append(payload[2:])
        elif m == RGN:
            if len(payload) >= 3:
                rgn[payload[0]] = payload[2]
                rgn_style[payload[0]] = payload[1]
        elif m == CAP:
            cap = payload
        elif m == 0xFF74:
            mct_segments.append(payload)
        elif m == 0xFF75:
            mcc_segments.append(payload)
        elif m == 0xFF77:
            mco_segments.append(payload)
        elif m == COC:
            ci = parse_coc(payload, ncomp())
            main_coc[ci.comp] = ci
        elif m == QCC:
            cc, qq = parse_qcc(payload, ncomp())
            main_qcc[cc] = qq
        elif m == POC:
            main_poc = parse_poc(payload, ncomp())
        elif m == PPM:
            if not payload:
                raise CorruptStreamError("empty PPM segment")
            ppm_segs.append((payload[0], payload[1:]))
        # TLM/PLM informational segments skipped (parse_tlm available
        # for tooling); PLT lives in tile-part headers and is captured
        # above into TileInfo.plt for decode-side packet skipping

    if siz is None or cod is None or qcd is None:
        raise CorruptStreamError("codestream missing SIZ/COD/QCD")

    # PPM (A.7.4): Zppm-ordered payloads form one stream of
    # [Nppm u32][Ippm bytes] records, the i-th record carrying the
    # packet headers of the i-th tile-part in codestream order (records
    # may split across segments, so framing is walked on the join).
    ppm_tile: Dict[int, bytearray] = {}
    if ppm_segs:
        joined = b"".join(s for _, s in sorted(ppm_segs, key=lambda t: t[0]))
        p, i = 0, 0
        while p < len(joined):
            if p + 4 > len(joined):
                raise CorruptStreamError("truncated PPM record length")
            n = struct.unpack_from(">I", joined, p)[0]
            p += 4
            if p + n > len(joined):
                raise CorruptStreamError("PPM record overruns PPM data")
            if i >= len(part_order):
                raise CorruptStreamError("more PPM records than tile-parts")
            ppm_tile.setdefault(part_order[i], bytearray()).extend(
                joined[p:p + n])
            p += n
            i += 1

    merged: Dict[int, TileInfo] = {}
    for isot, parts in tiles.items():
        body = b"".join(parts[k].data for k in sorted(parts))
        first = parts[min(parts)]
        ppt = None
        if isot in ppt_parts:
            ppt = b"".join(
                seg for part in sorted(ppt_parts[isot])
                for _, seg in sorted(ppt_parts[isot][part],
                                     key=lambda t: t[0]))
        elif isot in ppm_tile:
            ppt = bytes(ppm_tile[isot])
        plt = None
        if isot in plt_parts:
            plt = _plt_varints(b"".join(
                seg for part in sorted(plt_parts[isot])
                for _, seg in sorted(plt_parts[isot][part],
                                     key=lambda t: t[0])))
        merged[isot] = TileInfo(index=isot, data=body, cod=first.cod,
                                qcd=first.qcd, coc=first.coc, qcc=first.qcc,
                                poc=first.poc, ppt=ppt, plt=plt)
    return Codestream(siz=siz, cod=cod, qcd=qcd, tiles=merged,
                      comments=comments, rgn_shifts=rgn,
                      rgn_styles=rgn_style, cap=cap,
                      mct_segments=mct_segments, mcc_segments=mcc_segments,
                      mco_segments=mco_segments, coc=main_coc, qcc=main_qcc,
                      poc=main_poc)


def _next_marker(data: bytes, pos: int) -> int:
    return struct.unpack_from(">H", data, pos)[0]


# Hostile-stream guard: reject SIZ grids whose decoded SAMPLE count
# (area × components) would exhaust host memory before any real data is
# seen (a 20-byte stream can otherwise claim Xsiz=Ysiz=2^30 and trigger
# a 4 EiB allocation). The decoder materializes int64 coefficient
# planes, so 2^28 samples ≈ 2 GiB — already beyond any DICOM frame.
MAX_DECODE_PIXELS = 1 << 28


def parse_siz(payload: bytes) -> SizInfo:
    if len(payload) < 36:
        raise CorruptStreamError("SIZ too short")
    (_, xsiz, ysiz, xo, yo, xt, yt, xto, yto, csiz) = struct.unpack_from(
        ">HIIIIIIIIH", payload, 0)
    if xsiz <= xo or ysiz <= yo:
        raise CorruptStreamError("SIZ: empty image region (Xsiz<=XOsiz)")
    if xt == 0 or yt == 0:
        raise CorruptStreamError("SIZ: zero tile size")
    if xto > xo or yto > yo:  # T.800 A.5.1: XTOsiz <= XOsiz
        raise CorruptStreamError("SIZ: tile origin beyond image origin")
    if csiz == 0:
        raise CorruptStreamError("SIZ: zero components")
    if (xsiz - xo) * (ysiz - yo) * max(csiz, 1) > MAX_DECODE_PIXELS:
        raise CorruptStreamError(
            f"SIZ: {(xsiz - xo)}x{(ysiz - yo)}x{csiz} samples exceed the "
            f"decode cap ({MAX_DECODE_PIXELS})")
    comps = []
    off = 36
    for _ in range(csiz):
        if off + 3 > len(payload):
            raise CorruptStreamError("SIZ truncated component table")
        ssiz, xr, yr = struct.unpack_from(">BBB", payload, off)
        depth = (ssiz & 0x7F) + 1
        if depth > 38:  # T.800 A.5.1: Ssiz precision is at most 38 bits
            raise CorruptStreamError(f"SIZ component depth {depth} > 38")
        if xr == 0 or yr == 0:
            raise CorruptStreamError("SIZ zero subsampling factor")
        comps.append((depth, bool(ssiz & 0x80), xr, yr))
        off += 3
    return SizInfo(xsiz=xsiz, ysiz=ysiz, xosiz=xo, yosiz=yo, xtsiz=xt,
                   ytsiz=yt, xtosiz=xto, ytosiz=yto, components=comps)


def parse_cod(payload: bytes) -> CodInfo:
    if len(payload) < 10:
        raise CorruptStreamError("COD too short")
    scod, prog, layers, mct = struct.unpack_from(">BBHB", payload, 0)
    levels, cbw_e, cbh_e, cb_style, transform = struct.unpack_from(
        ">BBBBB", payload, 5)
    cod = CodInfo(progression=prog, num_layers=layers, mct=mct,
                  num_levels=levels, cb_width=1 << (cbw_e + 2),
                  cb_height=1 << (cbh_e + 2), cb_style=cb_style,
                  transform=transform, use_sop=bool(scod & 2),
                  use_eph=bool(scod & 4))
    if scod & 0x01:
        exps = []
        for i in range(levels + 1):
            if 10 + i >= len(payload):
                break
            b = payload[10 + i]
            exps.append((b & 0x0F, b >> 4))
        cod.precinct_exps = exps
    return cod


def parse_qcd(payload: bytes) -> QcdInfo:
    if not payload:
        raise CorruptStreamError("QCD empty")
    sqcd = payload[0]
    style = sqcd & 0x1F
    guard = sqcd >> 5
    q = QcdInfo(style=style, guard_bits=guard)
    body = payload[1:]
    if style == 0:
        q.exponents = [b >> 3 for b in body]
    else:
        for i in range(0, len(body) - 1, 2):
            v = (body[i] << 8) | body[i + 1]
            q.steps.append((v >> 11, v & 0x7FF))
    return q
