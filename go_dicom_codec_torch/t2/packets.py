"""JPEG 2000 Tier-2 packets: header codec + progression iteration (B.9-B.12).

Role of reference jpeg2000/t2/packet_encoder.go, packet_header_tagtree.go,
packet_decoder.go, packet_progression.go: inclusion + zero-bitplane tag
trees, comma-coded pass counts, Lblock length signaling with per-segment
lengths under TERMALL/LAZY termination, single packet spanning all bands
of a precinct, and the five progression orders.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Iterator, List, Optional, Tuple

from ..entropy.ebcot import (STYLE_LAZY, STYLE_TERMALL, _is_lazy_raw,
                             _is_terminating)
from ..errors import CorruptStreamError
from .bitio import BioReader, BioWriter
from .tagtree import TagTree


@dataclass
class BlockState:
    """Per-code-block coding state persisting across layers.

    Encode: data/passes filled by T1. Decode: seg_data accumulates body
    bytes, seg_ends records terminated-segment boundaries for the T1
    decoder.
    """
    cbx: int
    cby: int
    numbps: int = 0
    zero_bitplanes: int = 0
    included: bool = False
    lblock: int = 3
    num_passes: int = 0
    # encode side
    data: bytes = b""
    pass_rates: List[int] = field(default_factory=list)   # cumulative bytes
    pass_terms: List[bool] = field(default_factory=list)
    pass_bitplanes: List[int] = field(default_factory=list)
    pass_nmsedecs: List[int] = field(default_factory=list)  # T.800 J.4 ints
    dist_weight: float = 1.0   # band weight: (norm·Δ/gain)²/8192
    layer_passes: List[int] = field(default_factory=list)  # cumulative/layer
    # decode side
    seg_data: bytearray = field(default_factory=bytearray)
    seg_ends: List[int] = field(default_factory=list)


@dataclass
class PrecinctState:
    """Tag trees + blocks for one precinct band."""
    ncbw: int
    ncbh: int
    blocks: List[BlockState]
    mb: int = 0            # max bitplanes for the band: guard + exponent - 1

    # tag trees build lazily: the native whole-tile T2 paths never
    # touch the Python trees, and eager construction was a measurable
    # share of per-frame state setup
    @property
    def incl_tree(self) -> TagTree:
        t = self.__dict__.get("_incl")
        if t is None:
            t = TagTree(max(self.ncbw, 1), max(self.ncbh, 1))
            self.__dict__["_incl"] = t
        return t

    @property
    def zbp_tree(self) -> TagTree:
        t = self.__dict__.get("_zbp")
        if t is None:
            t = TagTree(max(self.ncbw, 1), max(self.ncbh, 1))
            self.__dict__["_zbp"] = t
        return t


def _floor_log2(n: int) -> int:
    return max(n.bit_length() - 1, 0)


def _encode_num_passes(bw: BioWriter, n: int) -> None:
    """Comma code for pass counts (B.10.6; packet_header_tagtree.go:502)."""
    if n == 1:
        bw.write_bit(0)
    elif n == 2:
        bw.write_bits(2, 2)
    elif n <= 5:
        bw.write_bits(0x0C | (n - 3), 4)
    elif n <= 36:
        bw.write_bits(0x1E0 | (n - 6), 9)
    elif n <= 164:
        bw.write_bits(0xFF80 | (n - 37), 16)
    else:
        raise ValueError(f"number of passes {n} exceeds 164")


def _decode_num_passes(br: BioReader) -> int:
    if br.read_bit() == 0:
        return 1
    if br.read_bit() == 0:
        return 2
    v = br.read_bits(2)
    if v < 3:
        return 3 + v
    v = br.read_bits(5)
    if v < 31:
        return 6 + v
    return 37 + br.read_bits(7)


@lru_cache(maxsize=4096)
def _segments(style: int, numbps: int, start_pass: int, new_passes: int
              ) -> Tuple[int, ...]:
    """Pass counts per terminated segment for passes [start, start+new).

    Derived from the same termination pattern as the T1 coder
    (ebcot._is_terminating), so encoder/decoder and header agree.
    Memoized: decode calls this once per (block, layer) and the walk
    repeats the same few argument tuples thousands of times per frame
    (measured ~20% of dense-frame T2 decode time).

    HT blocks (style 0x40) follow ITU-T T.814 B.2 instead: the pass
    walk per HT set is [cleanup, SigProp, MagRef] and the segment set T
    terminates each cleanup pass and each refinement pair — boundaries
    at pass indices ≡ 0 and ≡ 2 (mod 3).
    """
    if style & 0x40:
        segs: List[int] = []
        count = 0
        for idx in range(start_pass, start_pass + new_passes):
            count += 1
            if idx % 3 != 1 or idx == start_pass + new_passes - 1:
                segs.append(count)
                count = 0
        return tuple(segs)
    if numbps <= 0:
        return (new_passes,) if new_passes else ()
    maxbp = numbps - 1
    # walk pass sequence to find types of each global pass index
    segs: List[int] = []
    count = 0
    pass_type, bitplane, idx = 2, maxbp, 0
    while idx < start_pass + new_passes and bitplane >= 0:
        if idx >= start_pass:
            count += 1
            last = idx == start_pass + new_passes - 1
            if _is_terminating(bitplane, maxbp, pass_type, style) or last:
                segs.append(count)
                count = 0
        idx += 1
        if pass_type == 2:
            pass_type = 0
            bitplane -= 1
        else:
            pass_type += 1
    if count:
        segs.append(count)
    return tuple(segs)


@lru_cache(maxsize=8192)
def _terminates_at(style: int, numbps: int, idx: int) -> bool:
    """Whether global pass `idx` is a terminating pass under `style`
    (same walk as _segments / ebcot._is_terminating)."""
    if style & 0x40:          # HT sets: cleanup and MagRef terminate
        return idx % 3 != 1   # (T.814 B.2), SigProp only when last
    if numbps <= 0:
        return False
    maxbp = numbps - 1
    pass_type, bitplane, i = 2, maxbp, 0
    while bitplane >= 0:
        if i == idx:
            return _is_terminating(bitplane, maxbp, pass_type, style)
        i += 1
        if pass_type == 2:
            pass_type = 0
            bitplane -= 1
        else:
            pass_type += 1
    return False


def encode_packet(bands: List[PrecinctState], layer: int,
                  style: int, num_layers: int = 1) -> Tuple[bytes, bytes]:
    """Encode one packet (header, body) for a precinct's bands.

    Mirrors packet_header_tagtree.go:15-162 multi-band composition: one
    non-empty bit, then per band per block: inclusion (tag tree on first
    inclusion, raw bit after), zero-bitplanes tag tree, pass count, and
    Lblock/segment lengths.
    """
    bw = BioWriter()
    body = bytearray()

    any_blocks = any(ps.blocks for ps in bands)
    if not any_blocks:
        bw.write_bit(0)
        return bw.flush(), b""

    # Which blocks contribute in this layer? (prev = passes already shipped)
    contributions = []
    nonempty = False
    for ps in bands:
        for blk in ps.blocks:
            total = (blk.layer_passes[layer]
                     if blk.layer_passes else len(blk.pass_rates))
            prev = blk.num_passes
            new_passes = total - prev
            if new_passes > 0:
                nonempty = True
            contributions.append((ps, blk, prev, new_passes))

    if layer == 0:
        for ps in bands:
            ps.incl_tree.reset()
            ps.zbp_tree.reset()
            for blk in ps.blocks:
                ps.zbp_tree.set_value(blk.cbx, blk.cby, blk.zero_bitplanes)

    # set inclusion-tree values for every first inclusion BEFORE any encode
    # call touches the tree (min-propagation; packet_header_tagtree.go:22-31)
    for (ps, blk, prev, new_passes) in contributions:
        if not blk.included and new_passes > 0:
            ps.incl_tree.set_value(blk.cbx, blk.cby, layer)

    if not nonempty:
        bw.write_bit(0)
        return bw.flush(), b""
    bw.write_bit(1)

    for (ps, blk, prev, new_passes) in contributions:
        included = new_passes > 0
        if not blk.included:
            ps.incl_tree.encode(bw, blk.cbx, blk.cby, layer + 1)
            if not included:
                continue
            ps.zbp_tree.encode(bw, blk.cbx, blk.cby, 999)
            blk.included = True
        else:
            bw.write_bit(1 if included else 0)
            if not included:
                continue

        _encode_num_passes(bw, new_passes)

        # segment lengths over the new passes
        seg_counts = _segments(style, blk.numbps, prev, new_passes)
        seg_lens = []
        p = prev
        for cnt in seg_counts:
            end = p + cnt
            start_b = blk.pass_rates[p - 1] if p > 0 else 0
            end_b = blk.pass_rates[end - 1]
            seg_lens.append(end_b - start_b)
            p = end

        increment = 0
        for cnt, ln in zip(seg_counts, seg_lens):
            need = (_floor_log2(ln) + 1) - (blk.lblock + _floor_log2(cnt))
            increment = max(increment, need)
        for _ in range(increment):
            bw.write_bit(1)
        bw.write_bit(0)
        blk.lblock += increment
        for cnt, ln in zip(seg_counts, seg_lens):
            bw.write_bits(ln, blk.lblock + _floor_log2(cnt))

        start_b = blk.pass_rates[prev - 1] if prev > 0 else 0
        end_b = blk.pass_rates[prev + new_passes - 1]
        body += blk.data[start_b:end_b]
        blk.num_passes = prev + new_passes

    return bw.flush(), bytes(body)


def decode_packet(data: bytes, pos: int, bands: List[PrecinctState],
                  layer: int, style: int,
                  use_sop: bool = False, use_eph: bool = False) -> int:
    """Decode one packet at data[pos:]; returns new position.

    Mirrors t2/packet_decoder.go / packet_header.go:302-506.
    """
    # optional SOP marker
    if use_sop and pos + 6 <= len(data) and data[pos:pos + 2] == b"\xff\x91":
        pos += 6
    _, pos = _decode_packet_core(data, pos, data, None, bands, layer,
                                 style, use_eph)
    return pos


def decode_packet_split(hdr: bytes, hpos: int, data: bytes, pos: int,
                        bands: List[PrecinctState], layer: int, style: int,
                        use_sop: bool = False,
                        use_eph: bool = False) -> Tuple[int, int]:
    """decode_packet with PACKED packet headers (T.800 A.7.4/A.7.5):
    the header bits come from the PPM/PPT stream at hdr[hpos:] (each
    packet header is an independently byte-aligned unit, EPH included
    when signalled), while the bodies stay in the bitstream at
    data[pos:] (where SOP markers, if any, still appear). Returns
    (new_hpos, new_pos)."""
    if use_sop and pos + 6 <= len(data) and data[pos:pos + 2] == b"\xff\x91":
        pos += 6
    return _decode_packet_core(hdr, hpos, data, pos, bands, layer,
                               style, use_eph)


def _decode_packet_core(hdr: bytes, hpos: int, data: bytes,
                        body_pos: Optional[int], bands: List[PrecinctState],
                        layer: int, style: int,
                        use_eph: bool) -> Tuple[int, int]:
    """Shared packet parse: header bits from hdr[hpos:], segment bodies
    from data (at body_pos, or immediately after the header + optional
    EPH when body_pos is None — the in-bitstream layout)."""
    br = BioReader(hdr[hpos:])
    if layer == 0:
        for ps in bands:
            ps.incl_tree.reset()
            ps.zbp_tree.reset()

    reads: List[Tuple[BlockState, int, List[int]]] = []
    if br.read_bit():
        for ps in bands:
            for blk in ps.blocks:
                if not blk.included:
                    incl_val = ps.incl_tree.decode(br, blk.cbx, blk.cby,
                                                   layer + 1)
                    included = incl_val <= layer
                    if not included:
                        continue
                    # zero-bitplanes: decode until known
                    thr = 1
                    while ps.zbp_tree.decode(br, blk.cbx, blk.cby, thr) >= thr:
                        thr += 1
                    blk.zero_bitplanes = ps.zbp_tree.decode(br, blk.cbx,
                                                            blk.cby, thr)
                    blk.numbps = ps.mb - blk.zero_bitplanes
                    if blk.numbps < 0:
                        raise CorruptStreamError(
                            f"negative bitplane count: Mb={ps.mb} "
                            f"zbp={blk.zero_bitplanes}")
                    blk.included = True
                else:
                    if not br.read_bit():
                        continue

                new_passes = _decode_num_passes(br)
                seg_counts = _segments(style, blk.numbps, blk.num_passes,
                                       new_passes)
                increment = 0
                while br.read_bit():
                    increment += 1
                blk.lblock += increment
                seg_lens = [br.read_bits(blk.lblock + _floor_log2(cnt))
                            for cnt in seg_counts]
                reads.append((blk, new_passes, seg_lens))

    br.align_to_byte()
    hpos += br.bytes_read()
    if use_eph:
        if hdr[hpos:hpos + 2] == b"\xff\x92":
            hpos += 2
    pos = hpos if body_pos is None else body_pos

    for blk, new_passes, seg_lens in reads:
        seg_counts = _segments(style, blk.numbps, blk.num_passes,
                               new_passes)
        p_end = blk.num_passes
        for cnt, ln in zip(seg_counts, seg_lens):
            if pos + ln > len(data):
                raise CorruptStreamError("packet body overruns tile data")
            blk.seg_data += data[pos:pos + ln]
            p_end += cnt
            # record a T1 segment boundary only at TRUE terminations —
            # a layer boundary mid-segment (non-terminated pass) is a
            # length-signaling split, not an MQ/raw coder restart
            if _terminates_at(style, blk.numbps, p_end - 1):
                blk.seg_ends.append(len(blk.seg_data))
            pos += ln
        blk.num_passes += new_passes
    if body_pos is None:
        hpos = pos  # in-bitstream layout: header stream IS the body stream
    return hpos, pos


# ---- progression iteration -------------------------------------------------

def progression_order(progression: int, num_layers: int, num_res: int,
                      num_comps: int,
                      precinct_info: Callable[[int, int], List[Tuple[int, int, int]]]
                      ) -> Iterator[Tuple[int, int, int, int]]:
    """Yield (layer, resolution, component, precinct_idx) in packet order.

    precinct_info(comp, res) → list of (precinct_idx, ref_x0, ref_y0) where
    ref coordinates project the precinct onto the reference grid (for the
    positional orders). Covers the five B.12 orders (reference
    t2/packet_progression.go:26-157).
    """
    entries = []
    for c in range(num_comps):
        for r in range(num_res):
            for (p, x, y) in precinct_info(c, r):
                entries.append((r, c, p, x, y))

    if progression == 0:      # LRCP
        keyed = sorted(entries, key=lambda e: (e[0], e[1], e[2]))
        for l in range(num_layers):
            for (r, c, p, _, _) in keyed:
                yield (l, r, c, p)
    elif progression == 1:    # RLCP
        keyed = sorted(entries, key=lambda e: (e[0], e[1], e[2]))
        for r in range(num_res):
            for l in range(num_layers):
                for (rr, c, p, _, _) in keyed:
                    if rr == r:
                        yield (l, r, c, p)
    elif progression == 2:    # RPCL
        keyed = sorted(entries, key=lambda e: (e[0], e[4], e[3], e[1]))
        for (r, c, p, _, _) in keyed:
            for l in range(num_layers):
                yield (l, r, c, p)
    elif progression == 3:    # PCRL
        keyed = sorted(entries, key=lambda e: (e[4], e[3], e[1], e[0]))
        for (r, c, p, _, _) in keyed:
            for l in range(num_layers):
                yield (l, r, c, p)
    elif progression == 4:    # CPRL
        keyed = sorted(entries, key=lambda e: (e[1], e[4], e[3], e[0]))
        for (r, c, p, _, _) in keyed:
            for l in range(num_layers):
                yield (l, r, c, p)
    else:
        raise CorruptStreamError(f"unknown progression order {progression}")


def poc_progression_order(entries, num_layers: int, num_res: int,
                          num_comps: int,
                          precinct_info: Callable[[int, int],
                                                  List[Tuple[int, int, int]]]
                          ) -> Iterator[Tuple[int, int, int, int]]:
    """Packet order under progression-order changes (T.800 A.6.6 / B.12.2).

    Each POC entry emits its Ppoc order restricted to
    layers [0, LYEpoc) × resolutions [RSpoc, REpoc) ×
    components [CSpoc, CEpoc); packets already emitted by an earlier
    entry are skipped (the reference parses POC at
    codestream/parser.go:104-306; the iteration semantics follow the
    spec since the reference decoder replays packets in stored order).
    """
    seen = set()
    for e in entries:
        re_ = min(e.re, num_res)
        ce = min(e.ce, num_comps)
        lye = min(e.lye, num_layers)

        def sub_info(c, r, _e=e, _re=re_, _ce=ce):
            if not (_e.rs <= r < _re and _e.cs <= c < _ce):
                return []
            return precinct_info(c, r)

        for (l, r, c, p) in progression_order(e.prog, lye, re_, ce,
                                              sub_info):
            key = (l, r, c, p)
            if key in seen:
                continue
            seen.add(key)
            yield key
