"""JPEG 2000 Part 1 codec core — encoder + decoder orchestration.

Role of reference jpeg2000/encoder.go (pipeline: pixel→planar int32, DC
shift, RCT, per-tile DWT, per-codeblock T1, T2 packets, SOT/SOD framing)
and jpeg2000/decoder.go + t2/tile_decoder.go (parse → packets → T1 →
assemble subbands → IDWT → inverse MCT → pixels).

TPU split per SURVEY.md §2.6: the transform stages (DC shift, RCT,
multilevel 5/3 DWT) run batched on device (ops/), subband extraction is a
slice of the packed-Mallat array, code-block stats come from one reduction
(ops/blockstats), and the serial EBCOT/MQ stages run host-side per block.
"""

from __future__ import annotations

import math
import struct

from dataclasses import dataclass, field, replace
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..codestream import j2k
from ..entropy.ebcot import T1Decoder, T1Encoder
from ..errors import CorruptStreamError, UnsupportedFormatError
from ..ops.dwt53 import fwd53_multilevel_, inv53_multilevel_
from ..ops.dwt97 import fwd97_multilevel, inv97_multilevel
from ..ops.mct import (dc_level_shift, dc_level_shift_np, ict_forward,
                       ict_inverse, inv_dc_level_shift,
                       inv_dc_level_shift_np, rct_forward, rct_forward_np,
                       rct_inverse, rct_inverse_np)
from ..t2.packets import (BlockState, PrecinctState, decode_packet,
                          decode_packet_split, encode_packet,
                          progression_order)
from . import j2k_quant as jq
from .j2k_geometry import (BandGeom, ResolutionGeom, build_tile_geometry,
                           band_gain, ceil_div)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A contiguous copy of ``a`` on ``device``, which the caller owns
    (the 5/3 transforms it in place)."""
    if device is None:
        raise ValueError("the J2K device stage needs a torch.device")
    return torch.tensor(np.ascontiguousarray(a), device=device)


class _AssembledTile(NamedTuple):
    """Tile packet assembly with optional side products: the PPT
    header stream (packed_headers) and per-packet bitstream lengths
    (plt_markers)."""
    headers: Optional[bytes]
    body: bytes
    pkt_lengths: Optional[List[int]]


@dataclass
class J2KEncodeParams:
    """Encoder configuration (role of reference EncodeParams,
    jpeg2000/encoder.go:17-99; lossless subset this round)."""
    num_levels: int = 5
    lossless: bool = True
    quality: int = 85          # lossy only: drives the step-size curve
    # lossy quantization overrides (reference encoder.go:46-48,
    # lossy/codec.go:247-272,485): explicit per-subband steps in QCD
    # band order (length 3*num_levels+1, same relative-step domain as
    # j2k_quant.step_sizes_97), and a global step multiplier
    custom_quant_steps: Optional[List[float]] = None
    quant_step_scale: float = 1.0
    cb_width: int = 64
    cb_height: int = 64
    progression: int = j2k.PROG_LRCP
    num_layers: int = 1
    tile_width: int = 0       # 0 = single tile covering the image
    tile_height: int = 0
    cb_style: int = 0
    htj2k: bool = False        # Part 15 HT block coding (cb_style 0x40)
    # HT SigProp+MagRef refinement passes (T.814 §7.3-7.5) — beyond the
    # reference's cleanup-only experiment (htj2k/encoder.go:55-68): the
    # cleanup pass codes |v|>>1 and the refinement pair codes plane 0,
    # giving PCRD three truncation points per code-block instead of
    # one. Blocks whose plane-0 ones are not SigProp-reachable fall
    # back to a full-precision cleanup (Z_blk=1) so the complete
    # stream stays bit-exact.
    ht_refinement: bool = False
    layer_rates: Optional[List[float]] = None  # compression ratios per layer
    target_ratio: float = 0.0  # orig/compressed; 0 = off (PCRD truncation)
    append_lossless_layer: bool = False  # final rate-0 layer after rates
    roi_regions: Optional[list] = None  # List[j2k_roi.ROIRegion]
    roi_shift: int = 0         # 0 = auto (MaxShift Srgn)
    roi_style: str = "maxshift"  # maxshift | general (Srgn 0 / 1)
    mct: Optional[bool] = None  # None = auto (RCT for 3 components)
    # Part 2 custom multi-component transform (MCT/MCC/MCO markers)
    mct_matrix: Optional[List[List[float]]] = None    # forward N×N
    mct_inverse: Optional[List[List[float]]] = None   # inverse N×N
    mct_offsets: Optional[List[float]] = None
    # multiple binding groups (reference MCTBindings encoder.go:111-121):
    # list of mct_builder.MCTBinding, applied in order on encode
    mct_bindings: Optional[list] = None
    # pluggable block coder (reference BlockEncoderFactory
    # encoder.go:94-103): callable(width, height) -> object with
    # encode(data[h,w] int) -> (stream, numbps, List[PassInfo]);
    # T1Encoder's interface. Overrides the native/Python T1 (non-HT).
    block_encoder_factory: Optional[object] = None
    # intermediate layer byte-budget curve (reference ComputeLayerBudgets
    # rate_distortion.go:438-464): EXPONENTIAL (default, pow 1.1),
    # EQUAL_RATE (linear), EQUAL_QUALITY (pow 0.9), ADAPTIVE (pow 1.05)
    layer_budget_strategy: str = "EXPONENTIAL"
    precincts: Optional[List[Tuple[int, int]]] = None
    # pixel-size precinct convention (reference PrecinctWidth/Height
    # encoder.go:36-37): ONE power-of-2 size, auto-scaled down one
    # exponent per lower resolution level (OpenJPEG convention,
    # reference getPrecinctSizeExponents encoder.go:1516-1569).
    # Explicit per-resolution `precincts` exponents win when both set.
    precinct_width: int = 0    # 0 = default (2^15, no Scod flag)
    precinct_height: int = 0
    comment: bytes = b"go-dicom-codec-tpu"
    guard_bits: int = 2
    # packed packet headers (T.800 A.7.5): move every packet header out
    # of the bitstream into PPT segments in the tile-part header. The
    # reference defines the PPM/PPT markers but neither writes nor
    # reads them (codestream/markers.go:69-72); this encoder writes
    # PPT and the decoder reads both PPT and PPM.
    packed_headers: bool = False
    # resync markers (T.800 A.8): SOP before every packet (Nsop counts
    # per tile, mod 65536), EPH after every packet header — with packed
    # headers the EPH rides in the PPT/PPM stream while SOP stays in
    # the bitstream. The reference decodes both flags but never writes
    # them (t2/packet_header.go); both decoders here accept them.
    use_sop: bool = False
    use_eph: bool = False
    # PLT packet-length pointers (T.800 A.8.2) in each tile-part
    # header; lengths count everything a packet puts in the bitstream
    # (SOP + header + EPH + body — body only under packed_headers).
    # The reference defines/skips the marker (markers.go:65-66,129).
    plt_markers: bool = False
    # TLM tile-part pointers (T.800 A.7.1) in the main header — always
    # on for HTJ2K (reference writeTLM); this flag adds them to classic
    # J2K streams too.
    tlm_markers: bool = False
    # file container: None = raw codestream (the DICOM transport and
    # the reference's only output), "jp2" = ISO 15444-1 Annex I file,
    # "jph" = ISO 15444-15 Annex A file (use for htj2k streams).
    # Decode unwraps either transparently (codestream/j2k.unwrap_jp2).
    container: Optional[str] = None

    def clamped_levels(self, w: int, h: int) -> int:
        """Clamp levels so the coarsest LL stays ≥1 px (lossy/codec.go:392)."""
        lv = self.num_levels
        while lv > 0 and (min(w, h) >> lv) < 1:
            lv -= 1
        return lv

    def resolved_precincts(self, levels: int) -> Optional[List[Tuple[int, int]]]:
        """Per-resolution (PPx, PPy) exponents, or None for maximal.

        Expands the pixel-size convention per the reference's
        getPrecinctSizeExponents (encoder.go:1516-1569): base exponent
        floor(log2(size)) (a non-positive dimension defaults to 2^15),
        reduced by (levels - res) per lower resolution, clamped [0, 15].
        """
        if self.precincts:
            return list(self.precincts)
        if self.precinct_width <= 0 and self.precinct_height <= 0:
            return None
        pw = self.precinct_width if self.precinct_width > 0 else (1 << 15)
        ph = self.precinct_height if self.precinct_height > 0 else (1 << 15)
        base_x = pw.bit_length() - 1
        base_y = ph.bit_length() - 1
        return [(min(15, max(0, base_x - (levels - r))),
                 min(15, max(0, base_y - (levels - r))))
                for r in range(levels + 1)]


# Layer-budget strategy → fraction-curve exponent (reference
# ComputeLayerBudgets rate_distortion.go:438-464)
_BUDGET_EXPONENTS = {"EQUAL_RATE": 1.0, "EQUAL_QUALITY": 0.9,
                     "ADAPTIVE": 1.05, "EXPONENTIAL": 1.1}


def _band_index(r: int, band: int) -> int:
    """QCD subband order: LL, then (HL, LH, HH) per resolution 1..L."""
    if r == 0:
        return 0
    return 1 + (r - 1) * 3 + (band - 1)


def _distortion_weight(cod: j2k.CodInfo, qcd: j2k.QcdInfo, r: int,
                       band: int, bit_depth: int) -> float:
    """Per-band NMSEDEC→MSE weight (reference encoder.go
    openJPEGDistortionWeight :3455-3473): lossless norm²/8192; lossy
    (norm·Δ/gain)²/8192 with the band's 2^log2gain."""
    from ..ops.dwt97 import dwt53_norm, dwt97_norm
    level = cod.num_levels - r if r > 0 else cod.num_levels
    if cod.transform == 1:
        n = dwt53_norm(level, band)
        return n * n / 8192.0
    steps = J2KEncoder._band_deltas(qcd, cod.num_levels, bit_depth)
    delta = steps[_band_index(r, band)]
    if delta <= 0:
        delta = 1.0
    gain = 4.0 if band == 3 else (2.0 if band != 0 else 1.0)
    w = dwt97_norm(level, band) * (delta / gain)
    return w * w / 8192.0


def band_mb(qcd: j2k.QcdInfo, r: int, band: int, num_levels: int) -> int:
    """Max bit-planes for a band: guard + ε_b − 1 (B.10.5 Mb)."""
    if qcd.style == 0:
        idx = _band_index(r, band)
        if idx < len(qcd.exponents):
            return qcd.guard_bits + qcd.exponents[idx] - 1
        return qcd.guard_bits + (qcd.exponents[-1] if qcd.exponents
                                 else 8) - 1
    if qcd.style == 1:
        # scalar derived: ε_b = ε_0 − num_levels + n_b (E-5)
        e0 = qcd.steps[0][0] if qcd.steps else 8
        nb = (num_levels - r + 1) if r > 0 else num_levels
        e = e0 - num_levels + nb if r > 0 else e0
        return qcd.guard_bits + max(e, 1) - 1
    idx = _band_index(r, band)
    if idx < len(qcd.steps):
        return qcd.guard_bits + qcd.steps[idx][0] - 1
    return qcd.guard_bits + 8


class J2KEncoder:
    def __init__(self, params: Optional[J2KEncodeParams] = None,
                 device: Optional[torch.device] = None) -> None:
        self.params = params or J2KEncodeParams()
        self.device = device  # where the device stage runs

    def encode(self, pixels, width: int, height: int, components: int,
               bit_depth: int, signed: bool = False,
               precomputed_tiles=None) -> bytes:
        """Full codestream encode.

        precomputed_tiles: optional sequence of per-tile packed
        coefficient arrays [C, th, tw] (raster tile order) computed
        elsewhere — e.g. the sharded multi-chip device stage
        (parallel/mesh.encode_frames_sharded) — which skip the transform
        stage while keeping the FULL header/entropy/PCRD path.
        """
        p = self.params
        if p.container not in (None, "jp2", "jph"):
            # fail before the (potentially multi-second) encode runs,
            # not inside wrap_jp2 at the very end
            raise ValueError(
                f"container must be 'jp2' or 'jph', got {p.container!r}")
        if components < 1:
            raise UnsupportedFormatError("components must be >= 1")
        # any N encodes (reference EncodeComponents takes [][]int32 of
        # arbitrary length; its mc codec suite uses 2-component frames)
        # — RCT/ICT auto-MCT stays 3-component-only, custom
        # matrices/bindings carry other N

        dt = (np.dtype("<i2") if signed else np.dtype("<u2")) \
            if bit_depth > 8 else (np.int8 if signed else np.uint8)
        if isinstance(pixels, (bytes, bytearray, memoryview)):
            arr = np.frombuffer(pixels, dtype=dt,
                                count=width * height * components)
        else:
            arr = np.asarray(pixels)
        arr = arr.reshape(height, width, components).astype(np.int32)

        levels = p.clamped_levels(width, height)
        use_mct = p.mct if p.mct is not None else (components == 3)
        if p.mct_matrix is not None:
            if len(p.mct_matrix) != components:
                raise UnsupportedFormatError(
                    "MCT matrix size must match component count")
            use_mct = False  # custom matrix replaces RCT/ICT
        if p.mct_bindings:
            use_mct = False  # bindings replace RCT/ICT (reference order:
            #                  bindings > custom matrix > RCT/ICT)
            for b in p.mct_bindings:
                ids = list(b.component_ids) or list(range(components))
                if any(not (0 <= c < components) for c in ids):
                    raise UnsupportedFormatError(
                        f"MCT binding references component out of range "
                        f"(ids {ids}, {components} components)")
                if b.matrix is None or len(b.matrix) != len(ids):
                    raise UnsupportedFormatError(
                        "MCT binding matrix size must match its "
                        "component count")
        tw = p.tile_width or width
        th = p.tile_height or height

        siz = j2k.SizInfo(
            xsiz=width, ysiz=height, xtsiz=tw, ytsiz=th,
            components=[(bit_depth, signed, 1, 1)] * components)
        # Layered streams rely on non-terminated truncation points with
        # +3-byte MQ lookahead widening at layer boundaries (OpenJPEG
        # semantics; the widened segment stays within the next pass's
        # bytes so the full stream is unchanged). TERMALL is NOT forced —
        # it costs ~2 bytes per pass across every block.
        cb_style = p.cb_style | (0x40 if p.htj2k else 0)
        # Resolve effective layers/rates: target_ratio fills in an
        # EXPONENTIAL rate ladder ending at the target (reference
        # LayerBudgetStrategy default + encodeFrameWithTargetRatio
        # lossy/codec.go:378-388); append_lossless_layer adds a final
        # rate-0 (take-all) layer (reference initRDLayerConfig
        # encoder.go:2674-2684).
        num_layers = p.num_layers
        eff_rates = list(p.layer_rates) if p.layer_rates else None
        if p.target_ratio > 0 and eff_rates is None:
            e = _BUDGET_EXPONENTS.get(p.layer_budget_strategy, 1.1)
            eff_rates = [
                p.target_ratio / (((i + 1) / num_layers) ** e)
                for i in range(num_layers)]
        if p.append_lossless_layer and eff_rates and eff_rates[-1] != 0:
            num_layers += 1
            eff_rates.append(0.0)
        self._eff_rates = eff_rates
        cod = j2k.CodInfo(
            progression=p.progression, num_layers=num_layers,
            mct=1 if (use_mct and components == 3) else 0,
            num_levels=levels, cb_width=p.cb_width, cb_height=p.cb_height,
            cb_style=cb_style, transform=1 if p.lossless else 0,
            precinct_exps=p.resolved_precincts(levels),
            use_sop=p.use_sop, use_eph=p.use_eph)
        qcd = self._build_qcd(levels, bit_depth, use_mct,
                              components)

        roi_shift = 0
        roi_style = 0
        if p.roi_regions:
            if p.htj2k:
                raise UnsupportedFormatError(
                    "MaxShift ROI is not supported with HT code-blocks "
                    "(Kmax bound)")
            if p.roi_style == "general":
                # General Scaling (Srgn=1): any shift works — the decoder
                # unshifts by the COM-carried geometry mask, not magnitude
                roi_style = 1
                roi_shift = p.roi_shift or 4
            else:
                # Srgn large enough that every background magnitude stays
                # below 2^Srgn (reference resolveROI, encoder.go:1047)
                roi_shift = p.roi_shift or (bit_depth + 3)
        # components covered by at least one region (RGN written per comp)
        roi_comps = set()
        if p.roi_regions:
            for rr in p.roi_regions:
                roi_comps |= set(rr.components if rr.components
                                 else range(components))

        out = bytearray(b"\xff\x4f")  # SOC
        out += j2k.write_siz(siz)
        if p.htj2k:
            # CAP: Pcap bit for Part 15 + Ccap15 flags (encoder.go:1187-1217)
            ccap15 = 0x0002
            if components > 1:
                ccap15 |= 0x0001
            if bit_depth > 8:
                ccap15 |= 0x0008
            if not p.lossless:
                ccap15 |= 0x0020
            out += j2k.write_cap(0x00020000, [ccap15])
        out += j2k.write_cod(cod)
        out += j2k.write_qcd(qcd)
        if p.comment:
            out += j2k.write_com(p.comment)
        if p.roi_regions:
            # private JP2ROI COM: geometry for mask-based decode
            # (reference writeCOM encoder.go:1819-1914)
            from .j2k_roi import write_roi_com
            out += j2k.write_com(write_roi_com(p.roi_regions, components),
                                 binary=True)
        if p.mct_bindings:
            # Part 2 multi-binding MCT: one decorrelation (+offset) MCT
            # record per binding, one MCC collection each, MCO order
            # (reference applyMCTBindings/writeMCTAndMCC encoder.go:527-784)
            next_idx = 1
            mcc_order = []
            for bi, b in enumerate(p.mct_bindings):
                ids = list(b.component_ids) or list(range(components))
                inv = b.inverse
                if inv is None:
                    inv = np.linalg.inv(np.asarray(b.matrix)).tolist()
                deco_idx = next_idx
                next_idx += 1
                out += j2k.write_mct_record(
                    deco_idx, j2k.MCT_ARRAY_DECORRELATE, j2k.MCT_ELEM_F32,
                    [v for row in inv for v in row])
                off_idx = 0
                if b.offsets:
                    off_idx = next_idx
                    next_idx += 1
                    out += j2k.write_mct_record(
                        off_idx, j2k.MCT_ARRAY_OFFSET, j2k.MCT_ELEM_F32,
                        list(b.offsets))
                out += j2k.write_mcc_record(bi, ids, p.lossless, deco_idx,
                                            off_idx)
                mcc_order.append(bi)
            out += j2k.write_mco_record(mcc_order)
        elif p.mct_matrix is not None:
            # Part 2 markers: MCT (inverse matrix + offsets), MCC, MCO
            # (reference writeMCTAndMCC, encoder.go:668-784)
            inv = p.mct_inverse
            if inv is None:
                inv = np.linalg.inv(np.asarray(p.mct_matrix)).tolist()
            flat_inv = [v for row in inv for v in row]
            out += j2k.write_mct_record(1, j2k.MCT_ARRAY_DECORRELATE,
                                        j2k.MCT_ELEM_F32, flat_inv)
            off_idx = 0
            next_idx = 2
            if p.mct_offsets:
                off_idx = next_idx
                next_idx += 1
                out += j2k.write_mct_record(off_idx, j2k.MCT_ARRAY_OFFSET,
                                            j2k.MCT_ELEM_F32,
                                            list(p.mct_offsets))
            mcc_idx = next_idx
            out += j2k.write_mcc_record(mcc_idx, list(range(components)),
                                        p.lossless, 1, off_idx)
            out += j2k.write_mco_record([mcc_idx])
        if roi_shift:
            for c in sorted(roi_comps):
                out += j2k.write_rgn(c, roi_shift, components,
                                     style=roi_style)

        ntx, nty = siz.num_tiles
        shifts = {c: roi_shift for c in roi_comps} if roi_shift else {}
        rects = [siz.tile_rect(ti, tj)
                 for tj in range(nty) for ti in range(ntx)]
        use_global_pcrd = len(rects) > 1 and (
            num_layers > 1 or (eff_rates and any(r > 0 for r in eff_rates)))
        bodies = []
        if use_global_pcrd:
            # Global multi-tile PCRD: pool every tile's coding passes and
            # allocate one shared byte budget so bits flow to the tiles
            # that need them (reference useGlobalPCRD encoder.go:2004).
            ctxs = []
            for tidx, rect in enumerate(rects):
                coeffs = self._tile_coeffs(
                    arr, rect, cod, qcd, bit_depth, signed, use_mct,
                    shifts,
                    precomputed_tiles[tidx] if precomputed_tiles else None)
                comp_res, comp_states = self._tile_block_states(
                    coeffs, rect, cod, qcd, bit_depth, shifts)
                ctxs.append((comp_res, comp_states, components))
            self._pcrd_allocate(ctxs, cod, bit_depth,
                                width * height * components)
            for (comp_res, comp_states, nc) in ctxs:
                bodies.append(self._assemble_tile_packets(
                    comp_res, comp_states, cod, nc,
                    split=p.packed_headers, want_plt=p.plt_markers))
        else:
            for tidx, rect in enumerate(rects):
                bodies.append(self._encode_tile(
                    arr, rect, cod, qcd, bit_depth, signed, use_mct,
                    shifts,
                    precomputed_tiles[tidx] if precomputed_tiles else None,
                    split=p.packed_headers, want_plt=p.plt_markers))
        if p.packed_headers or p.plt_markers:
            # (tile-part header segments, bitstream) per tile
            parts = []
            for at in bodies:
                head = b""
                if p.packed_headers:
                    head += j2k.write_ppt(at.headers)
                if p.plt_markers:
                    head += j2k.write_plt_segments(at.pkt_lengths)
                parts.append((head, at.body))
        else:
            parts = [(b"", b) for b in bodies]
        if p.htj2k or p.tlm_markers:
            # TLM tile-part index for fast HT tile access (encoder.go
            # writeTLM :1219-1244): Ptlm = SOT(12) + headers + SOD(2)
            # + body
            out += j2k.write_tlm(0, [(i, 14 + len(hs) + len(b))
                                     for i, (hs, b) in enumerate(parts)])
        for tile_index, (head_segs, body) in enumerate(parts):
            out += j2k.write_tile_part(tile_index, body,
                                       head_segments=head_segs)
        out += (j2k.EOC).to_bytes(2, "big")
        if p.container is not None:
            return j2k.wrap_jp2(bytes(out), brand=p.container)
        return bytes(out)

    def _build_qcd(self, levels: int, bit_depth: int, use_mct: bool,
                   components: int) -> j2k.QcdInfo:
        """QCD for the current params (factored so the sharded
        multi-chip path builds the identical marker - the quant
        steps applied after the sharded DWT must match it)."""
        p = self.params
        if p.htj2k:
            # OpenJPH param_qcd quantization for HT code-blocks
            # (reference encoder.go:1591, quantization.go:243-297)
            kind, guard, vals = jq.openjph_qcd_values(
                levels, bit_depth, p.lossless,
                uses_rct=(use_mct and components == 3 and p.lossless))
            if kind == "exponents":
                qcd = j2k.QcdInfo(style=0, guard_bits=guard,
                                  exponents=list(vals))
            else:
                qcd = j2k.QcdInfo(style=2, guard_bits=guard,
                                  steps=list(vals))
        elif p.lossless:
            qcd = j2k.QcdInfo(style=0, guard_bits=p.guard_bits)
            for r in range(levels + 1):
                for band in ([0] if r == 0 else [1, 2, 3]):
                    qcd.exponents.append(bit_depth + band_gain(band))
        else:
            # scalar expounded (style 2): (ε, μ) per subband
            # (reference writeQCD encoder.go:1719-1733, quantization.go);
            # custom_quant_steps overrides the quality curve when sized
            # 3*levels+1, with quant_step_scale multiplying every step
            # (reference lossy/codec.go:485 customQuantSteps)
            qcd = j2k.QcdInfo(style=2, guard_bits=p.guard_bits)
            steps = None
            if (p.custom_quant_steps
                    and len(p.custom_quant_steps) == 3 * levels + 1):
                steps = [float(s) for s in p.custom_quant_steps]
            quality = p.quality
            scale = p.quant_step_scale
            if scale and scale > 0 and scale != 1.0:
                if steps is not None:
                    steps = [s * scale for s in steps]
                else:
                    # scaling the base step by S == lowering quality by
                    # 12.5*log2(S) (reference lossy/codec.go:414-424;
                    # Go math.Round = half away from zero, not banker's)
                    adj = 12.5 * math.log2(scale)
                    adj = math.floor(adj + 0.5) if adj >= 0 \
                        else math.ceil(adj - 0.5)
                    quality = max(1, min(100, quality - int(adj)))
            if steps is None:
                steps = jq.step_sizes_97(levels, quality)
            for step, (r, band) in zip(steps, jq.band_sequence(levels)):
                rb = bit_depth + band_gain(band)
                qcd.steps.append(jq.encode_step(step, rb))
        return qcd

    def _encode_tile(self, arr: np.ndarray, rect, cod: j2k.CodInfo,
                     qcd: j2k.QcdInfo, bit_depth: int, signed: bool,
                     use_mct: bool,
                     roi_shifts: Optional[Dict[int, int]] = None,
                     precomputed_coeffs: Optional[np.ndarray] = None,
                     split: bool = False, want_plt: bool = False):
        coeffs = self._tile_coeffs(arr, rect, cod, qcd, bit_depth, signed,
                                   use_mct, roi_shifts, precomputed_coeffs)
        from ..utils.profiling import maybe_stage
        with maybe_stage("j2k.encode.entropy"):
            return self._encode_tile_entropy(coeffs, rect, cod, qcd,
                                             bit_depth, roi_shifts,
                                             split=split,
                                             want_plt=want_plt)

    def _tile_coeffs(self, arr: np.ndarray, rect, cod: j2k.CodInfo,
                     qcd: j2k.QcdInfo, bit_depth: int, signed: bool,
                     use_mct: bool,
                     roi_shifts: Optional[Dict[int, int]] = None,
                     precomputed_coeffs: Optional[np.ndarray] = None
                     ) -> np.ndarray:
        """Device stage for one tile: DC shift (+MCT) + DWT (+quant,
        +ROI pre-shift) → packed coefficient array [C, th, tw]."""
        from ..utils.profiling import maybe_stage
        with maybe_stage("j2k.encode.transform"):
            return self._tile_coeffs_timed(arr, rect, cod, qcd, bit_depth,
                                           signed, use_mct, roi_shifts,
                                           precomputed_coeffs)

    def _tile_coeffs_timed(self, arr, rect, cod, qcd, bit_depth, signed,
                           use_mct, roi_shifts=None,
                           precomputed_coeffs=None) -> np.ndarray:
        roi_shifts = roi_shifts or {}
        tx0, ty0, tx1, ty1 = rect
        ncomp = arr.shape[2] if arr is not None else \
            precomputed_coeffs.shape[0]
        if precomputed_coeffs is not None:
            # device stage ran elsewhere (pipelined/sharded batch path);
            # the host ROI pre-shift still applies on top
            coeffs = np.asarray(precomputed_coeffs)
            if roi_shifts:
                coeffs = self._roi_shift_coeffs(coeffs, arr, rect, cod,
                                                roi_shifts)
            return coeffs
        tile = arr[ty0:ty1, tx0:tx1, :]

        # single-tile host fast path: integer DC shift + RCT + native 5/3
        # mirror (bit-parity with the torch path, tests/test_native.py) —
        # avoids per-op device dispatch when encoding one frame at a time;
        # the batched pipeline path keeps the whole-array device stage
        coeffs = None
        if (cod.transform == 1 and not self.params.mct_bindings
                and self.params.mct_matrix is None):
            from .. import native as _nat
            if _nat.get_lib() is not None:
                comps_np = np.moveaxis(tile, -1, 0).astype(np.int32)
                comps_np = dc_level_shift_np(comps_np, bit_depth, signed)
                if use_mct and ncomp == 3:
                    y_, u_, v_ = rct_forward_np(comps_np[0], comps_np[1],
                                                comps_np[2])
                    comps_np = np.stack([y_, u_, v_])
                coeffs = np.stack([
                    _nat.dwt53_fwd_native(c, cod.num_levels, tx0, ty0)
                    for c in comps_np])
        elif (cod.transform == 0 and not self.params.mct_bindings
                and self.params.mct_matrix is None):
            # irreversible host fast path: float32 ICT + native 9/7 +
            # deadzone quant (same role/policy as the 5/3 branch above;
            # the native 9/7 is float32 like XLA but not bit-pinned —
            # a lossy stage, bounded by roundtrip/oracle tests)
            from .. import native as _nat
            if _nat.get_lib() is not None:
                comps_np = np.moveaxis(tile, -1, 0).astype(np.float32)
                comps_np = comps_np - (0.0 if signed
                                       else float(1 << (bit_depth - 1)))
                if use_mct and ncomp == 3:
                    from ..ops.mct import ict_forward_np
                    y_, cb_, cr_ = ict_forward_np(comps_np[0], comps_np[1],
                                                  comps_np[2])
                    comps_np = np.stack([y_, cb_, cr_])
                fcoeffs = np.stack([
                    _nat.dwt97_fwd_native(c, cod.num_levels, tx0, ty0)
                    for c in comps_np])
                coeffs = np.zeros(fcoeffs.shape, dtype=np.int32)
                band_steps = self._band_deltas(qcd, cod.num_levels,
                                               bit_depth)
                from .j2k_geometry import packed_band_layout
                for bg in packed_band_layout(tx0, ty0, tx1, ty1,
                                             cod.num_levels):
                    delta = band_steps[_band_index(bg.resolution,
                                                   bg.band)]
                    sl = (slice(None),
                          slice(bg.row_off, bg.row_off + bg.height),
                          slice(bg.col_off, bg.col_off + bg.width))
                    coeffs[sl] = jq.deadzone_quantize(fcoeffs[sl], delta)
        if coeffs is None:
            coeffs = self._tile_coeffs_device(
                tile, rect, cod, qcd, bit_depth, signed, use_mct, ncomp)

        if roi_shifts:
            coeffs = self._roi_shift_coeffs(coeffs, arr, rect, cod,
                                            roi_shifts)

        return coeffs

    def _roi_shift_coeffs(self, coeffs, arr, rect, cod: j2k.CodInfo,
                          roi_shifts: Dict[int, int]) -> np.ndarray:
        """ROI: scale region coefficients up by 2^Srgn per band, per
        component (MaxShift and General Scaling share this encode path;
        they differ only in how the decoder unshifts)."""
        from .j2k_geometry import packed_band_layout
        from .j2k_roi import band_roi_mask, combined_mask
        tx0, ty0, tx1, ty1 = rect
        coeffs = coeffs.astype(np.int64)
        for c, shift in roi_shifts.items():
            full_mask = combined_mask(self.params.roi_regions,
                                      arr.shape[1], arr.shape[0],
                                      component=c)
            tile_mask = full_mask[ty0:ty1, tx0:tx1]
            for bg in packed_band_layout(tx0, ty0, tx1, ty1,
                                         cod.num_levels):
                if bg.width <= 0 or bg.height <= 0:
                    continue
                bm = band_roi_mask(tile_mask, tx0, ty0, cod.num_levels,
                                   bg.resolution, bg.band,
                                   (bg.x0, bg.y0, bg.x1, bg.y1))
                region = coeffs[
                    c,
                    bg.row_off : bg.row_off + bg.height,
                    bg.col_off : bg.col_off + bg.width]
                region[bm] <<= shift
        return coeffs

    def _tile_coeffs_device(self, tile: np.ndarray, rect, cod: j2k.CodInfo,
                            qcd: j2k.QcdInfo, bit_depth: int, signed: bool,
                            use_mct: bool, ncomp: int) -> np.ndarray:
        """Device (torch) tile transform: DC shift (+MCT) + DWT (+quant)."""
        tx0, ty0, tx1, ty1 = rect
        comps = _to_device(np.moveaxis(tile, -1, 0), self.device)  # [C, H, W]
        comps = dc_level_shift(comps, bit_depth, signed)
        lossless = cod.transform == 1
        if self.params.mct_bindings:
            from ..ops.mct import mct_matrix_forward
            for b in self.params.mct_bindings:
                ids = list(b.component_ids) or list(range(ncomp))
                idx = torch.as_tensor(ids, device=comps.device)
                m = torch.as_tensor(np.asarray(b.matrix, dtype=np.float32))
                offs = (torch.as_tensor(np.asarray(b.offsets,
                                                   dtype=np.float32))
                        if b.offsets else None)
                sub = mct_matrix_forward(comps[idx].to(torch.float32),
                                         m, offs)
                comps = comps.to(torch.float32, copy=True)
                comps[idx] = sub
            if lossless:
                comps = torch.round(comps).to(torch.int32)
        elif self.params.mct_matrix is not None:
            from ..ops.mct import mct_matrix_forward
            m = torch.as_tensor(np.asarray(self.params.mct_matrix,
                                           dtype=np.float32))
            offs = (torch.as_tensor(np.asarray(self.params.mct_offsets,
                                               dtype=np.float32))
                    if self.params.mct_offsets else None)
            comps = mct_matrix_forward(comps, m, offs)
            if lossless:
                comps = torch.round(comps).to(torch.int32)
        if lossless:
            if use_mct and ncomp == 3 and self.params.mct_matrix is None:
                y, u, v = rct_forward(comps[0], comps[1], comps[2])
                comps = torch.stack([y, u, v])
            coeffs = fwd53_multilevel_(
                comps.to(torch.int32, copy=True,
                         memory_format=torch.contiguous_format),
                cod.num_levels, x0=tx0, y0=ty0).cpu().numpy()
        else:
            if use_mct and ncomp == 3 and self.params.mct_matrix is None:
                y, cb, cr = ict_forward(comps[0], comps[1], comps[2])
                comps = torch.stack([y, cb, cr])
            fcoeffs = fwd97_multilevel(comps, cod.num_levels,
                                       x0=tx0, y0=ty0).cpu().numpy()
            # per-band deadzone quantization with the QCD-encoded steps
            coeffs = np.zeros_like(fcoeffs, dtype=np.int32)
            band_steps = self._band_deltas(qcd, cod.num_levels, bit_depth)
            from .j2k_geometry import packed_band_layout
            for bg in packed_band_layout(tx0, ty0, tx1, ty1, cod.num_levels):
                delta = band_steps[_band_index(bg.resolution, bg.band)]
                sl = (slice(None),
                      slice(bg.row_off, bg.row_off + bg.height),
                      slice(bg.col_off, bg.col_off + bg.width))
                coeffs[sl] = jq.deadzone_quantize(fcoeffs[sl], delta)
        return coeffs

    def _encode_tile_entropy(self, coeffs: np.ndarray, rect,
                             cod: j2k.CodInfo, qcd: j2k.QcdInfo,
                             bit_depth: int,
                             roi_shifts: Optional[Dict[int, int]] = None,
                             split: bool = False, want_plt: bool = False):
        """Host stage: per component geometry + T1 + PCRD + packets."""
        ncomp = coeffs.shape[0]
        comp_res, comp_states = self._tile_block_states(
            coeffs, rect, cod, qcd, bit_depth, roi_shifts)
        tx0, ty0, tx1, ty1 = rect
        self._pcrd_allocate([(comp_res, comp_states, ncomp)], cod,
                            bit_depth,
                            (ty1 - ty0) * (tx1 - tx0) * ncomp)
        return self._assemble_tile_packets(comp_res, comp_states, cod,
                                           ncomp, split=split,
                                           want_plt=want_plt)

    def _apply_t1_result(self, st, mb: int, dw: float, stream: bytes,
                         numbps: int, rates, terms, bitplanes,
                         nmsedecs) -> None:
        """Fill a BlockState from one code-block's T1 output (shared by
        the batched-native, per-block-native, Python, and factory
        paths)."""
        if numbps > 0:
            st.numbps = numbps
            st.zero_bitplanes = mb - numbps
            if st.zero_bitplanes < 0:
                raise UnsupportedFormatError(
                    f"block numbps {numbps} exceeds Mb {mb}")
            st.data = stream
            st.pass_rates = list(rates)
            st.pass_terms = list(terms)
            st.pass_bitplanes = list(bitplanes)
            st.pass_nmsedecs = list(nmsedecs)
            st.dist_weight = dw
            # single flush: last rate = stream length
            if st.pass_rates:
                st.pass_rates[-1] = len(stream)
            # OpenJPEG lookahead correction: a non-terminated
            # truncation point needs ~3 extra bytes so the MQ
            # decoder's byte-ahead reads stay in-segment. Widening up
            # front keeps PCRD's measured packet bytes identical to
            # the final emission. The widened rate must NOT cross the
            # next pass's rate: termination boundaries define the
            # decoder's segment splits (crossing one scrambles
            # LAZY/TERMALL segment reassembly) — cap backward so each
            # cap sees the next pass's final rate.
            for _k in range(len(st.pass_rates) - 2, -1, -1):
                if not st.pass_terms[_k]:
                    st.pass_rates[_k] = min(st.pass_rates[_k] + 3,
                                            st.pass_rates[_k + 1])

    def _apply_ht_result(self, st, mb: int, blob, blk_data, width: int,
                         height: int, real_dist: bool = False,
                         dw: float = 1.0) -> None:
        """Fill a BlockState from one HT cleanup encode result; b"" =
        all-zero block (stays empty), None = native failure → Python
        reference coder. real_dist: use the actual block energy as the
        PCRD distortion (×128 at bit-plane 0) so Z=1 fallback blocks
        stay on the same slope scale as ht_refinement multipass blocks
        in the tile."""
        if blob == b"":
            return  # all-zero block
        if blob is None:
            from ..entropy.htcleanup import HTCleanupEncoder
            blob = HTCleanupEncoder(width, height, mb).encode(blk_data)
        if blob is not None:
            st.numbps = 1
            st.zero_bitplanes = mb - 1
            st.data = blob
            st.pass_rates = [len(blob)]
            st.pass_terms = [True]
            if real_dist:
                av = np.abs(blk_data.astype(np.int64))
                st.pass_bitplanes = [0]
                st.pass_nmsedecs = [128 * int((av * av).sum())]
                st.dist_weight = dw
            else:
                # single all-or-nothing cleanup pass: give PCRD a
                # top-bitplane slope so layered streams ship HT blocks
                # in the earliest fitting layer
                st.pass_bitplanes = [mb]

    @staticmethod
    def _prep_ht_refinement(blk_data: np.ndarray, cb_style: int):
        """Split a block for a 3-pass HT set (T.814 §7.3-7.5): the
        cleanup pass codes u = sign·(|v|>>1) positioned one plane up by
        signalling numbps=2 (S_blk = Mb-2, so the §7.6 refinement plane
        MSB_{S_blk+2} is plane 0 — verified against OpenJPEG), and
        SigProp/MagRef code plane 0. Returns (u, dref, sp_len,
        nmsedecs) or None when the block must stay a single
        full-precision cleanup pass: all-zero u (the first cleanup
        segment may not be empty, B.3) or a plane-0 one that SigProp
        cannot reach (exactness would be lost)."""
        av = np.abs(blk_data.astype(np.int64))
        if not (av > 1).any():
            return None
        causal = bool(cb_style & 0x08)
        from ..native import ht_refine_encode_native
        res = ht_refine_encode_native(blk_data, causal)
        if res is None:
            from ..entropy.htrefine import encode_refinement
            res = encode_refinement(blk_data, causal)
        dref, sp_len, exact, n_new, n_ref = res
        if not exact:
            return None
        u = ((av >> 1) * np.sign(blk_data)).astype(blk_data.dtype)
        # distortion deltas in T.800 J.4 fixed-point units (×128, at
        # bit-plane 0): cleanup leaves midpoint error (1-lsb)² on
        # significant samples and lsb on the rest; SigProp removes 1
        # per newly-significant sample; MagRef 1 per lsb=0 refinement
        lsb = (av & 1).astype(np.int64)
        energy = int((av * av).sum())
        after_cp = int((lsb[av > 1] ^ 1).sum()) + int(lsb[av <= 1].sum())
        nms = [128 * (energy - after_cp), 128 * n_new, 128 * n_ref]
        return u, dref, sp_len, nms

    def _apply_ht_multipass(self, st, mb: int, blob, u: np.ndarray,
                            width: int, height: int, dref: bytes,
                            sp_len: int, nms, dw: float) -> None:
        """Fill a BlockState for a 3-pass HT set: data = cleanup segment
        + refinement segment (SigProp bytes then reversed MagRef bytes);
        every PCRD truncation of the pass sequence is a byte prefix."""
        if blob is None:
            from ..entropy.htcleanup import HTCleanupEncoder
            blob = HTCleanupEncoder(width, height, mb).encode(u)
        if blob is None:   # degenerate geometry: keep the block empty
            return
        # numbps=2 (zbp = Mb-2): positions the cleanup payload one
        # plane up and the refinement plane at plane 0 (§7.6)
        st.numbps = 2
        st.zero_bitplanes = mb - 2
        st.data = blob + dref
        st.pass_rates = [len(blob), len(blob) + sp_len,
                         len(blob) + len(dref)]
        st.pass_terms = [True, False, True]
        st.pass_bitplanes = [0, 0, 0]
        st.pass_nmsedecs = nms
        st.dist_weight = dw

    def _tile_block_states(self, coeffs: np.ndarray, rect,
                           cod: j2k.CodInfo, qcd: j2k.QcdInfo,
                           bit_depth: int,
                           roi_shifts: Optional[Dict[int, int]] = None):
        """Geometry + T1 for one tile → (comp_res, comp_states).

        The default (no custom factory, non-HT) path defers every
        code-block and encodes the whole tile in ONE batched native
        call (native.t1_encode_blocks_native) — per-block ctypes
        round-trips measured ~10% of dense-frame encode."""
        roi_shifts = roi_shifts or {}
        tx0, ty0, tx1, ty1 = rect
        ncomp = coeffs.shape[0]
        # PCRD reads the distortion estimates only for layered/rated
        # streams — skip NMSEDEC accumulation otherwise
        eff = getattr(self, "_eff_rates", None)
        need_nmse = bool(cod.num_layers > 1
                         or (eff and any(r > 0 for r in eff)))
        pending = []   # (BlockState, block array, orient, mb, dw)
        pending_ht = []  # (BlockState, block array, mb, width, height)
        ht_refine = bool(self.params.ht_refinement)
        # id(BlockState) -> (dref, sp_len, nms, dw, original block) for
        # blocks taking the 3-pass HT set; absent = Z=1 cleanup
        ht_refine_info: Dict[int, tuple] = {}
        comp_res: List[List[ResolutionGeom]] = []
        comp_states: List[Dict[Tuple[int, int], List[PrecinctState]]] = []
        for c in range(ncomp):
            resolutions = build_tile_geometry(
                tx0, ty0, tx1, ty1, cod.num_levels, cod.cb_width,
                cod.cb_height, cod.precinct_exp)
            comp_res.append(resolutions)
            states: Dict[Tuple[int, int], List[PrecinctState]] = {}
            for res in resolutions:
                for prec in res.precincts:
                    plist = []
                    for pb in prec.bands:
                        bg = pb.band
                        mb = band_mb(qcd, res.r, bg.band,
                                     cod.num_levels) + roi_shifts.get(c, 0)
                        dw = _distortion_weight(cod, qcd, res.r, bg.band,
                                                bit_depth)
                        blocks = []
                        for g in pb.blocks:
                            blk_data = coeffs[
                                c,
                                bg.row_off + (g.y0 - bg.y0):
                                bg.row_off + (g.y1 - bg.y0),
                                bg.col_off + (g.x0 - bg.x0):
                                bg.col_off + (g.x1 - bg.x0)]
                            st = BlockState(cbx=g.cbx, cby=g.cby)
                            if cod.cb_style & 0x40:
                                # HT block: Kmax = Mb, zbp = Mb-1
                                # (encoder.go:3374-3383); int32 blocks
                                # defer into the batched native calls
                                # after the walk (incl. the
                                # ht_refinement SigProp/MagRef prep —
                                # eligible blocks cleanup-encode |v|>>1
                                # and carry a refinement pair).
                                if blk_data.dtype != np.int64:
                                    pending_ht.append((st, blk_data, mb,
                                                       g.width, g.height,
                                                       dw))
                                    blocks.append(st)
                                    continue
                                from ..native import ht_cleanup_encode_native
                                blob = ht_cleanup_encode_native(
                                    np.ascontiguousarray(blk_data), mb)
                                self._apply_ht_result(st, mb, blob,
                                                      blk_data, g.width,
                                                      g.height,
                                                      real_dist=ht_refine,
                                                      dw=dw)
                                blocks.append(st)
                                continue
                            factory = self.params.block_encoder_factory
                            if factory is not None:
                                be = factory(g.width, g.height)
                                stream, numbps, passes = be.encode(blk_data)
                                self._apply_t1_result(
                                    st, mb, dw, stream, numbps,
                                    [pi.rate for pi in passes],
                                    [pi.terminated for pi in passes],
                                    [pi.bitplane for pi in passes],
                                    [pi.nmsedec for pi in passes])
                            else:
                                pending.append((st, blk_data, bg.orient,
                                                mb, dw))
                            blocks.append(st)
                        plist.append(PrecinctState(
                            ncbw=pb.ncbw, ncbh=pb.ncbh, blocks=blocks,
                            mb=mb))
                    states[(res.r, prec.index)] = plist
            comp_states.append(states)

        if pending_ht:
            from ..native import (ht_cleanup_encode_blocks_native,
                                  ht_cleanup_encode_native,
                                  ht_refine_encode_blocks_native)
            if ht_refine:
                # batched SigProp/MagRef prep (one native round trip);
                # refined blocks swap their cleanup source for u
                preps = ht_refine_encode_blocks_native(
                    [p[1] for p in pending_ht],
                    bool(cod.cb_style & 0x08))
                for i, (st, blk_data, mb, w_, h_, dw_) in \
                        enumerate(pending_ht):
                    prep = preps[i] if preps is not None else \
                        self._prep_ht_refinement(blk_data, cod.cb_style)
                    if prep == "fallback":  # native segment overflow
                        prep = self._prep_ht_refinement(blk_data,
                                                        cod.cb_style)
                    if prep is not None:
                        u, dref, sp_len, nms = prep
                        ht_refine_info[id(st)] = (dref, sp_len, nms, dw_)
                        pending_ht[i] = (st, u, mb, w_, h_, dw_)
            results = ht_cleanup_encode_blocks_native(
                [p[1] for p in pending_ht], [p[2] for p in pending_ht])
            for i, (st, blk_data, mb, w_, h_, dw_) in enumerate(pending_ht):
                blob = results[i] if results is not None else \
                    ht_cleanup_encode_native(
                        np.ascontiguousarray(blk_data), mb)
                ref = ht_refine_info.get(id(st))
                if ref is not None:
                    dref, sp_len, nms, _dw = ref
                    self._apply_ht_multipass(st, mb, blob, blk_data,
                                             w_, h_, dref, sp_len, nms,
                                             dw_)
                else:
                    self._apply_ht_result(st, mb, blob, blk_data, w_, h_,
                                          real_dist=ht_refine, dw=dw_)

        if pending:
            from ..native import t1_encode_blocks_native, t1_encode_native
            # int64 blocks (deep-ROI magnitude discipline) can exceed
            # the batched entry's int32 source — per-block native call
            narrow = [p for p in pending if p[1].dtype != np.int64]
            wide = [p for p in pending if p[1].dtype == np.int64]
            fallback = []
            if narrow:
                results = t1_encode_blocks_native(
                    [p[1] for p in narrow], [p[2] for p in narrow],
                    cod.cb_style, need_nmse=need_nmse)
                if results is not None:
                    for (st, _, _, mb, dw), r in zip(narrow, results):
                        self._apply_t1_result(st, mb, dw, *r)
                else:
                    fallback += narrow
            for p in wide:
                r = t1_encode_native(np.ascontiguousarray(p[1]),
                                     cod.cb_style, p[2],
                                     need_nmse=need_nmse)
                if r is not None:
                    self._apply_t1_result(p[0], p[3], p[4], *r)
                else:
                    fallback.append(p)
            if fallback:
                # native unavailable: per-block Python reference coder
                for (st, blk_data, orient, mb, dw) in fallback:
                    enc = T1Encoder(blk_data.shape[1], blk_data.shape[0],
                                    style=cod.cb_style,
                                    orientation=orient)
                    stream, numbps, passes = enc.encode(blk_data)
                    self._apply_t1_result(
                        st, mb, dw, stream, numbps,
                        [pi.rate for pi in passes],
                        [pi.terminated for pi in passes],
                        [pi.bitplane for pi in passes],
                        [pi.nmsedec for pi in passes])
        return comp_res, comp_states

    @staticmethod
    def _precinct_info_fn(comp_res, cod):
        def precinct_info(c: int, r: int):
            res = comp_res[c][r]
            return [(prec.index, prec.x0 << (cod.num_levels - r),
                     prec.y0 << (cod.num_levels - r))
                    for prec in res.precincts]
        return precinct_info

    def _pcrd_allocate(self, tiles, cod: j2k.CodInfo, bit_depth: int,
                       total_pixels: int) -> None:
        """PCRD layer allocation over one or MANY tiles' blocks with one
        shared byte budget (reference useGlobalPCRD encoder.go:2004 —
        multi-tile streams pool every tile's passes so bits flow to the
        tiles that need them). tiles: [(comp_res, comp_states, ncomp)].

        No-op unless the stream is layered or carries a rate target.
        """
        eff_rates = getattr(self, "_eff_rates", None) or \
            self.params.layer_rates
        if not (cod.num_layers > 1 or (eff_rates
                                       and any(r > 0 for r in eff_rates))):
            return
        from ..t2.pcrd import (allocate_layers, layer_budgets_from_rates,
                               pass_slopes)
        all_blocks = []
        for (comp_res, comp_states, ncomp) in tiles:
            for states in comp_states:
                for plist in states.values():
                    for ps in plist:
                        all_blocks.extend(ps.blocks)
        slopes = [pass_slopes(b.pass_rates, b.pass_bitplanes,
                              b.pass_nmsedecs, b.dist_weight)
                  for b in all_blocks]
        total = sum(b.pass_rates[-1] if b.pass_rates else 0
                    for b in all_blocks)
        rates = eff_rates if eff_rates else [0.0] * cod.num_layers
        # fewer rates than layers: missing layers take everything left
        # (rate 0 = no budget); extra rates are ignored
        rates = (list(rates) + [0.0] * cod.num_layers)[:cod.num_layers]
        if any(r > 0 for r in rates):
            budgets = layer_budgets_from_rates(total_pixels, bit_depth,
                                               rates, total)
        else:
            e = _BUDGET_EXPONENTS.get(
                getattr(self.params, "layer_budget_strategy",
                        "EXPONENTIAL"), 1.1)
            budgets = [int(total * (((i + 1) / cod.num_layers) ** e))
                       for i in range(cod.num_layers - 1)] + [0]

        from ..native import T2AssembleContext
        trial_ctxs = [T2AssembleContext(comp_states, cod.cb_style)
                      for (_, comp_states, _) in tiles]
        trial_orders: dict = {}  # (tile index, nl) -> packet order

        def measured_bytes_native(counts_by_layer):
            # The native whole-tile assembler never mutates the Python
            # states, so a trial needs no deepcopy: set the candidate
            # layer_passes on the real blocks, size the stream
            # (measure-only: headers coded exactly, bodies counted,
            # nothing written), restore. Marshalling contexts and the
            # per-layer-count packet orders are built once for the
            # whole bisection.
            nl = len(counts_by_layer)
            saved = [blk.layer_passes for blk in all_blocks]
            for bi, blk in enumerate(all_blocks):
                blk.layer_passes = [counts_by_layer[li][bi]
                                    for li in range(nl)]
            try:
                total_b = 0
                for ti, (comp_res, comp_states, ncomp) in \
                        enumerate(tiles):
                    order = trial_orders.get((ti, nl))
                    if order is None:
                        pinfo = self._precinct_info_fn(comp_res, cod)
                        order = list(progression_order(
                            cod.progression, nl, cod.num_levels + 1,
                            ncomp, pinfo))
                        trial_orders[(ti, nl)] = order
                    n = trial_ctxs[ti].assemble(comp_states, order,
                                                measure_only=True)
                    if n is None:
                        return None
                    total_b += n
                    # SOP/EPH markers ride every packet (6 + 2 bytes)
                    total_b += (6 * cod.use_sop + 2 * cod.use_eph) \
                        * len(order)
                return total_b
            finally:
                for blk, lp in zip(all_blocks, saved):
                    blk.layer_passes = lp

        def measured_bytes(counts_by_layer):
            # Trial-encode packets for layers 0..li on cloned state so
            # the byte target covers real emitted bytes — packet headers
            # included (OpenJPEG measured-packet bisection).
            n = measured_bytes_native(counts_by_layer)
            if n is not None:
                return n
            import copy
            nl = len(counts_by_layer)
            total_b = 0
            bi = 0
            for (comp_res, comp_states, ncomp) in tiles:
                trial = copy.deepcopy(comp_states)
                tblocks = []
                for states in trial:
                    for plist in states.values():
                        for ps in plist:
                            tblocks.extend(ps.blocks)
                for blk in tblocks:
                    blk.layer_passes = [counts_by_layer[li][bi]
                                        for li in range(nl)]
                    bi += 1
                pinfo = self._precinct_info_fn(comp_res, cod)
                per_pkt = 6 * cod.use_sop + 2 * cod.use_eph
                for (l, r, c, pidx) in progression_order(
                        cod.progression, nl, cod.num_levels + 1, ncomp,
                        pinfo):
                    header, pbody = encode_packet(trial[c][(r, pidx)], l,
                                                  cod.cb_style,
                                                  cod.num_layers)
                    total_b += len(header) + len(pbody) + per_pkt
            return total_b

        alloc = allocate_layers(slopes, budgets, measure=measured_bytes)
        for blk, counts in zip(all_blocks, alloc):
            blk.layer_passes = counts

    def _assemble_tile_packets(self, comp_res, comp_states,
                               cod: j2k.CodInfo, ncomp: int,
                               split: bool = False,
                               want_plt: bool = False):
        precinct_info = self._precinct_info_fn(comp_res, cod)
        order = list(progression_order(
            cod.progression, cod.num_layers, cod.num_levels + 1,
            ncomp, precinct_info))
        if not split and not want_plt and not cod.use_sop \
                and not cod.use_eph:
            # native mirror assembles the whole tile (headers, tag
            # trees, Lblock, bodies) in one call; Python below is the
            # byte-identical behavioral reference / native-disabled path
            from ..native import t2_assemble_packets_native
            body_n = t2_assemble_packets_native(comp_states, order,
                                                cod.cb_style)
            if body_n is not None:
                return body_n
        # one loop for both layouts: with packed headers (split) the
        # header + EPH bytes go to their own stream and SOP stays with
        # the bodies; inline, everything lands in `body`. PLT lengths
        # count what each packet puts in the bitstream either way.
        body = bytearray()
        hdrs = bytearray() if split else body
        lengths = [] if want_plt else None
        for nsop, (l, r, c, pidx) in enumerate(order):
            header, pbody = encode_packet(comp_states[c][(r, pidx)], l,
                                          cod.cb_style, cod.num_layers)
            n0 = len(body)
            if cod.use_sop:
                # SOP segment (T.800 A.8.1): marker + Lsop=4 + Nsop
                body += struct.pack(">HHH", j2k.SOP, 4, nsop & 0xFFFF)
            hdrs += header
            if cod.use_eph:
                hdrs += struct.pack(">H", j2k.EPH)
            body += pbody
            if want_plt:
                lengths.append(len(body) - n0)
        if split:
            return _AssembledTile(bytes(hdrs), bytes(body), lengths)
        if want_plt:
            return _AssembledTile(None, bytes(body), lengths)
        return bytes(body)


    @staticmethod
    def _band_deltas(qcd: j2k.QcdInfo, num_levels: int,
                     bit_depth: int) -> List[float]:
        out = []
        for i, (r, band) in enumerate(jq.band_sequence(num_levels)):
            rb = bit_depth + band_gain(band)
            e, m = qcd.steps[i] if i < len(qcd.steps) else (rb, 0)
            out.append(jq.decode_step(e, m, rb))
        return out


def dequantize_packed(packed: np.ndarray, rect, levels: int,
                      deltas) -> np.ndarray:
    """Per-band dequantization of packed coefficients ([..., th, tw])
    into float32 with per-band absolute deltas (QCD band order) — the
    ONE host dequant stage shared by the scalar decoder and the
    batched/sharded decode paths (any drift here would break their
    ±1-tie parity)."""
    from .j2k_geometry import packed_band_layout
    tx0, ty0, tx1, ty1 = rect
    out = np.zeros(packed.shape, dtype=np.float32)
    for bg in packed_band_layout(tx0, ty0, tx1, ty1, levels):
        delta = deltas[_band_index(bg.resolution, bg.band)]
        rs = slice(bg.row_off, bg.row_off + bg.height)
        cs_ = slice(bg.col_off, bg.col_off + bg.width)
        out[..., rs, cs_] = jq.dequantize(packed[..., rs, cs_], delta)
    return out


def _extract_mct_inverse(cs, ncomp: int):
    """Part 2 custom MCT: decode inverse matrices + offsets from the
    markers (reference decoder.go:206-353 extractMCTFromMarkers /
    extractBindings). With MCC/MCO present, each collection binds a
    component subset to its MCT records; inverses apply in REVERSE MCO
    order. Without MCC, fall back to the first full-size decorrelation
    matrix. Returns [(ids, inv[N,N], offsets[N] | None), ...]."""
    mct_bindings_inv = []
    if not cs.mct_segments:
        return mct_bindings_inv
    mct_by_idx = {}
    for seg in cs.mct_segments:
        idx, atype, etype, vals = j2k.parse_mct_segment(seg)
        mct_by_idx[(atype, idx)] = vals
    if cs.mcc_segments:
        mccs = {}
        for seg in cs.mcc_segments:
            index, ids, rev, didx, oidx = j2k.parse_mcc_segment(seg)
            mccs[index] = (ids, didx, oidx)
        order = None
        if cs.mco_segments:
            order = j2k.parse_mco_segment(cs.mco_segments[0])
        if not order:
            order = sorted(mccs)
        for mcc_i in reversed(order):
            if mcc_i not in mccs:
                continue
            ids, didx, oidx = mccs[mcc_i]
            vals = mct_by_idx.get((j2k.MCT_ARRAY_DECORRELATE, didx))
            if not vals or len(vals) != len(ids) ** 2:
                continue
            inv = np.asarray(vals, dtype=np.float32
                             ).reshape(len(ids), len(ids))
            ovals = mct_by_idx.get((j2k.MCT_ARRAY_OFFSET, oidx)) \
                if oidx else None
            offs = (np.asarray(ovals, dtype=np.float32)
                    if ovals and len(ovals) == len(ids) else None)
            mct_bindings_inv.append((list(ids), inv, offs))
    if not mct_bindings_inv:
        custom_inv = None
        custom_offs = None
        for (atype, idx), vals in sorted(mct_by_idx.items(),
                                         key=lambda kv: kv[0][1]):
            if atype == j2k.MCT_ARRAY_DECORRELATE \
                    and custom_inv is None \
                    and len(vals) == ncomp * ncomp:
                custom_inv = np.asarray(vals, dtype=np.float32
                                        ).reshape(ncomp, ncomp)
            elif atype == j2k.MCT_ARRAY_OFFSET \
                    and custom_offs is None and len(vals) == ncomp:
                custom_offs = np.asarray(vals, dtype=np.float32)
        if custom_inv is not None:
            mct_bindings_inv.append((list(range(ncomp)), custom_inv,
                                     custom_offs))
    return mct_bindings_inv


def _apply_mct_bindings_inverse(rec, bindings):
    """Apply per-binding inverse matrices (+offsets) to component
    subsets, in the (already reversed) MCO order."""
    from ..ops.mct import mct_matrix_inverse
    recf = rec.to(torch.float32, copy=True)
    for (ids, inv, offs) in bindings:
        idx = torch.as_tensor(ids, device=recf.device)
        sub = mct_matrix_inverse(
            recf[idx], torch.as_tensor(inv),
            torch.as_tensor(offs) if offs is not None else None)
        recf[idx] = sub
    return recf


def _gs_roi_regions(cs):
    """Private JP2ROI COM geometry for the General-Scaling unshift
    (reference extractROIFromCOM decoder.go:167-204); None when the
    stream has no Srgn=1 component or carries no JP2ROI COM (the
    decoder then unshifts by magnitude, like the scalar else-branch)."""
    if not any(st == 1 for st in cs.rgn_styles.values()):
        return None
    from .j2k_roi import parse_roi_com
    for com in cs.comments:
        rr = parse_roi_com(com)
        if rr:
            return rr
    return None


def _gs_masks_for_tile(cs, gs_regions, rect):
    """Tile-local General-Scaling bool masks per styled component
    (reference tile_decoder.go:723-742 geometry rule). One shared
    helper for the scalar, packed-tile, and component-tile decode
    paths — the mask semantics must stay identical across them."""
    gs_masks = {}
    if gs_regions is None:
        return gs_masks
    from .j2k_roi import combined_mask
    siz = cs.siz
    fw, fh = siz.xsiz - siz.xosiz, siz.ysiz - siz.yosiz
    tx0, ty0, tx1, ty1 = rect
    for c, st in cs.rgn_styles.items():
        if st == 1 and cs.rgn_shifts.get(c, 0) > 0:
            fm = combined_mask(gs_regions, fw, fh, component=c)
            gs_masks[c] = fm[ty0 - siz.yosiz:ty1 - siz.yosiz,
                             tx0 - siz.xosiz:tx1 - siz.xosiz]
    return gs_masks


def _sop_resync(body, start: int, cur_idx: int, npackets: int):
    """Next SOP marker naming a packet after cur_idx → (pos, index).

    Resilient-decode recovery (T.800 A.8.1): Nsop counts packets per
    tile mod 65536, so the smallest order index j > cur_idx with
    j % 65536 == Nsop is the packet the marker opens. Scans from
    `start`; returns None when no usable SOP remains. The returned pos
    points AT the SOP marker (decode_packet re-consumes it).

    Aliasing caveat: in tiles with more than 65536 packets the mod-2^16
    Nsop can name an EARLIER congruent packet than the marker actually
    opens. This is best-effort resilient recovery only — a wrong
    candidate fails to parse and the caller's retry loop rescans from
    past it, so the cost is degraded recovery, never wrong strict
    output."""
    off = body.find(b"\xff\x91\x00\x04", start)
    while off != -1:
        if off + 6 > len(body):
            return None
        nsop = (body[off + 4] << 8) | body[off + 5]
        j = cur_idx + 1 + ((nsop - (cur_idx + 1)) % 65536)
        if j < npackets:
            return off, j
        off = body.find(b"\xff\x91\x00\x04", off + 1)
    return None


def _require_decodable_depths(siz: j2k.SizInfo) -> None:
    """Reject component depths the int32 reconstruction cannot carry.

    T.800 A.5.1 allows Ssiz precision up to 38 bits (the parser accepts
    that full range for inspection tools), but every decode path here
    reconstructs into int32 — the inverse DC shift alone adds
    1 << (depth-1), which leaves the int32 range at depth 32. A header
    declaring more (in practice only corrupted streams do; fuzz trial
    seed_base=26000000 --only 27624 found an OverflowError here) must
    fail typed at the entry point, not crash mid-decode.
    """
    for depth, _, _, _ in siz.components:
        if depth > 31:
            raise UnsupportedFormatError(
                f"component depth {depth} exceeds the int32 "
                "reconstruction range (max 31)")


class J2KDecoder:
    """Codestream decoder (reference decoder.go:91-124, tile_decoder.go).

    block_decoder_factory (reference SetBlockDecoderFactory,
    decoder.go:63-88 / t2.BlockDecoderFactory tile_decoder.go:14-24):
    callable(width, height, style, orient) returning an object with
    decode(stream: bytes, num_passes: int, numbps: int, seg_lengths,
    mb: int) -> [h, w] int array; overrides the built-in T1/HT block
    decoders for every code-block (mb = guard_bits + ε − 1, the HT
    Kmax input).
    """

    def __init__(self, resilient: bool = False,
                 block_decoder_factory=None, reduce: int = 0,
                 window=None, device: Optional[torch.device] = None) -> None:
        self.device = device  # where the inverse transforms run
        self.resilient = resilient
        self.block_decoder_factory = block_decoder_factory
        # reduced-resolution decode (OpenJPEG -r analogue, beyond the
        # reference): skip the top `reduce` resolutions — T1 runs only
        # on the kept code-blocks and the inverse DWT stops early, so a
        # thumbnail decode costs a fraction of the full one. Output
        # dims are the level-`reduce` LL window (ceil-div by 2^reduce).
        self.reduce = int(reduce)
        # spatial window decode (OpenJPEG -d analogue, beyond the
        # reference): decode only the (x0, y0, x1, y1) reference-grid
        # region — tiles outside it skip entirely and code-blocks whose
        # bands cannot influence it (Annex B ceil-div mapping plus a
        # conservative lifting-support margin) skip T1. decode()
        # returns just the window (composable with reduce: the output
        # is the window's level-R ceil-div). Pixels are identical to
        # cropping a full decode.
        self.window = tuple(window) if window is not None else None

    def set_block_decoder_factory(self, factory) -> None:
        """Reference decoder.go:76 SetBlockDecoderFactory."""
        self.block_decoder_factory = factory

    def decode(self, data: bytes):
        """→ (array [H, W, C] int32, SizInfo, CodInfo)."""
        cs = j2k.parse_codestream(data)
        siz = cs.siz
        _require_decodable_depths(siz)
        ncomp = len(siz.components)
        depth0, signed0, _, _ = siz.components[0]

        def rdiv(v):  # reduced-grid coordinate (level-R LL window)
            return -(-v // (1 << self.reduce))

        window = self.window
        if window is not None:
            wx0, wy0, wx1, wy1 = window
            wx0 = max(int(wx0), siz.xosiz)
            wy0 = max(int(wy0), siz.yosiz)
            wx1 = min(int(wx1), siz.xsiz)
            wy1 = min(int(wy1), siz.ysiz)
            if wx1 <= wx0 or wy1 <= wy0:
                raise UnsupportedFormatError(
                    f"decode window {window} does not intersect the "
                    f"image grid")
            window = (wx0, wy0, wx1, wy1)
            ox, oy = rdiv(wx0), rdiv(wy0)
            width = rdiv(wx1) - ox
            height = rdiv(wy1) - oy
        else:
            ox, oy = rdiv(siz.xosiz), rdiv(siz.yosiz)
            width = rdiv(siz.xsiz) - ox
            height = rdiv(siz.ysiz) - oy
        out = np.zeros((height, width, ncomp), dtype=np.int32)

        mct_bindings_inv = _extract_mct_inverse(cs, ncomp)

        roi_regions = _gs_roi_regions(cs)

        ntx, nty = siz.num_tiles
        for tidx, tile in sorted(cs.tiles.items()):
            ti, tj = tidx % ntx, tidx // ntx
            rect = siz.tile_rect(ti, tj)
            if window is not None and (
                    rect[2] <= window[0] or rect[0] >= window[2]
                    or rect[3] <= window[1] or rect[1] >= window[3]):
                continue  # tile entirely outside the decode window
            cods = [cs.cod_for(c, tile) for c in range(ncomp)]
            qcds = [cs.qcd_for(c, tile) for c in range(ncomp)]
            gs_masks = _gs_masks_for_tile(cs, roi_regions, rect)
            # per-component grids under XRsiz/YRsiz subsampling
            # (reference tile_decoder.go:330-392 ceilDiv component bounds)
            tx0, ty0, tx1, ty1 = rect
            comp_rects = []
            comp_windows = None
            if window is not None:
                comp_windows = []
            for c in range(ncomp):
                _, _, xr, yr = siz.components[c]
                xr, yr = max(xr, 1), max(yr, 1)
                comp_rects.append((-(-tx0 // xr), -(-ty0 // yr),
                                   -(-tx1 // xr), -(-ty1 // yr)))
                if window is not None:
                    comp_windows.append(
                        (window[0] // xr, window[1] // yr,
                         -(-window[2] // xr), -(-window[3] // yr)))
            tile_arr = self._decode_tile(tile.data, rect, cods, qcds, ncomp,
                                         depth0, signed0, cs.rgn_shifts,
                                         mct_bindings_inv,
                                         poc=cs.poc_for(tile),
                                         gs_masks=gs_masks,
                                         comp_rects=comp_rects,
                                         packed_hdrs=tile.ppt,
                                         comp_windows=comp_windows,
                                         plt_lengths=tile.plt)
            tx0, ty0, tx1, ty1 = rect
            if window is None:
                out[rdiv(ty0) - oy:rdiv(ty1) - oy,
                    rdiv(tx0) - ox:rdiv(tx1) - ox, :] = tile_arr
            else:
                # paste only the tile∩window slice of the tile array
                ix0 = max(rdiv(tx0), rdiv(window[0]))
                iy0 = max(rdiv(ty0), rdiv(window[1]))
                ix1 = min(rdiv(tx1), rdiv(window[2]))
                iy1 = min(rdiv(ty1), rdiv(window[3]))
                if ix1 <= ix0 or iy1 <= iy0:
                    continue  # reduced grid rounded the overlap away
                out[iy0 - oy:iy1 - oy, ix0 - ox:ix1 - ox, :] = \
                    tile_arr[iy0 - rdiv(ty0):iy1 - rdiv(ty0),
                             ix0 - rdiv(tx0):ix1 - rdiv(tx0), :]
        return out, siz, cs.cod

    def _decode_tile(self, body: bytes, rect, cods, qcds, ncomp: int,
                     depth: int, signed: bool,
                     rgn_shifts: Optional[Dict[int, int]] = None,
                     mct_bindings_inv=None,
                     poc=None, gs_masks=None,
                     comp_rects=None,
                     packed_hdrs: Optional[bytes] = None,
                     comp_windows=None,
                     plt_lengths: Optional[List[int]] = None,
                     _return_packed: bool = False,
                     _return_packed_list: bool = False) -> np.ndarray:
        """cods/qcds: effective per-component CodInfo/QcdInfo (COD+COC,
        QCD+QCC resolution done by Codestream.cod_for/qcd_for).
        gs_masks: tile-local bool masks per General-Scaling component.
        comp_rects: per-component grid bounds (XRsiz/YRsiz-subsampled
        tile rect); defaults to the tile rect for every component.
        packed_hdrs: this tile's PPM/PPT packed packet headers
        (TileInfo.ppt); packet headers then parse from this buffer
        while bodies stay in the tile bitstream.
        plt_lengths: this tile's PLT packet lengths (TileInfo.plt);
        under reduced-resolution decode the walk advances over
        dropped-resolution packets by their recorded length instead of
        bit-parsing their headers (random-access use of A.8.2 the
        reference's write-only PLT never gets)."""
        tx0, ty0, tx1, ty1 = rect
        cod0 = cods[0]  # progression/layers are COD-only fields
        rgn_shifts = rgn_shifts or {}
        comp_rects = comp_rects or [tuple(rect)] * ncomp
        uniform = all(tuple(cr) == tuple(rect) for cr in comp_rects)
        # reduced-resolution decode: geometry/packet parsing stay on the
        # full grid (headers are sequential), but coefficients assemble
        # into the level-R LL window and the inverse runs R levels short.
        # Band rects and packed offsets of the kept resolutions coincide
        # in both layouts (ceil-div composes: ceil(ceil(x/2^R)/2^k) ==
        # ceil(x/2^(R+k)), the Annex B window recursion).
        reduce = self.reduce
        if reduce:
            for cc in cods:
                if reduce > cc.num_levels:
                    raise UnsupportedFormatError(
                        f"reduce={reduce} exceeds the stream's "
                        f"decomposition levels ({cc.num_levels})")

        def _rd(t):
            return tuple(-(-v // (1 << reduce)) for v in t)

        etx0, ety0, etx1, ety1 = _rd(rect)
        eff_comp_rects = [_rd(cr) for cr in comp_rects]
        th, tw = ety1 - ety0, etx1 - etx0

        comp_res = []
        comp_states = []
        comp_prec = []  # per component: (r, pidx) → precinct geometry
        for c in range(ncomp):
            cod_c, qcd_c = cods[c], qcds[c]
            ctx0, cty0, ctx1, cty1 = comp_rects[c]
            resolutions = build_tile_geometry(
                ctx0, cty0, ctx1, cty1, cod_c.num_levels, cod_c.cb_width,
                cod_c.cb_height, cod_c.precinct_exp)
            comp_res.append(resolutions)
            comp_prec.append({(res.r, prec.index): prec
                              for res in resolutions
                              for prec in res.precincts})
            states = {}
            for res in resolutions:
                for prec in res.precincts:
                    plist = []
                    for pb in prec.bands:
                        mb = band_mb(qcd_c, res.r, pb.band.band,
                                     cod_c.num_levels) + rgn_shifts.get(c, 0)
                        blocks = [BlockState(cbx=g.cbx, cby=g.cby)
                                  for g in pb.blocks]
                        plist.append(PrecinctState(
                            ncbw=pb.ncbw, ncbh=pb.ncbh, blocks=blocks,
                            mb=mb))
                    states[(res.r, prec.index)] = plist
            comp_states.append(states)

        def precinct_info(c: int, r: int):
            if r >= len(comp_res[c]):
                return []
            res = comp_res[c][r]
            lv = cods[c].num_levels
            return [(prec.index, prec.x0 << (lv - r), prec.y0 << (lv - r))
                    for prec in res.precincts]

        max_res = max(cc.num_levels for cc in cods) + 1
        if poc:
            from ..t2.packets import poc_progression_order
            order = poc_progression_order(poc, cod0.num_layers, max_res,
                                          ncomp, precinct_info)
        else:
            order = progression_order(cod0.progression, cod0.num_layers,
                                      max_res, ncomp, precinct_info)

        order = list(order)
        # spatial window: per (component, resolution, band) rect the
        # window maps onto (Annex B ceil-div) expanded by a lifting-
        # support margin — 8 band samples covers the cumulative 5/3 and
        # 9/7 dependency widths; blocks outside it cannot influence any
        # window pixel and skip T1 (window exactness is pinned against
        # full-decode crops in tests/test_window_decode.py). Rects are
        # precomputed once per (c, r, band) — they don't vary by
        # precinct or tile position within the walk.
        win_rects = None
        if comp_windows is not None:
            from .j2k_geometry import band_rect
            _M = 8
            win_rects = {}
            for c in range(ncomp):
                cw = comp_windows[c]
                for r in range(cods[c].num_levels + 1):
                    for band in ((0,) if r == 0 else (1, 2, 3)):
                        b = band_rect(cw[0], cw[1], cw[2], cw[3],
                                      cods[c].num_levels, r, band)
                        win_rects[(c, r, band)] = (b[0] - _M, b[1] - _M,
                                                   b[2] + _M, b[3] + _M)

        def _prec_outside_window(c, r, pidx):
            """True iff every block of the precinct misses the window's
            band rects (same test T1 applies per block below — a
            skipped packet's blocks are exactly the T1-skipped ones).
            Blocks tile the precinct-band rect, so per-block overlap
            is equivalent to bbox overlap; the loop exits early."""
            prec = comp_prec[c].get((r, pidx))
            if prec is None:
                return False
            for pb in prec.bands:
                wb = win_rects.get((c, r, pb.band.band))
                if wb is None:
                    return False
                for g in pb.blocks:
                    if not (g.x1 <= wb[0] or g.x0 >= wb[2]
                            or g.y1 <= wb[1] or g.y0 >= wb[3]):
                        return False
            return True

        # PLT-assisted skip: with a PLT covering every packet, packets
        # the output cannot see — dropped resolutions under reduce=R,
        # precincts fully outside the decode window — advance by their
        # recorded length: no header bit-parse, no tag-tree updates
        # (their precinct states are never read; T1 skips the same
        # blocks below). A PLT that doesn't cover the packet count is
        # ignored.
        plt_skip = None
        if (plt_lengths is not None and packed_hdrs is None
                and len(plt_lengths) >= len(order)
                and (reduce or win_rects is not None)
                # hostile-PLT guard: no real packet outruns the tile
                # body (also keeps every value inside the native
                # int64 pkt_skip marshalling)
                and all(ln <= len(body) for ln in plt_lengths)
                # internal-consistency guard: the recorded lengths must
                # tile the body exactly (encoder output always does;
                # test_parse_codestream_captures_plt asserts it). An
                # inconsistent PLT would desync the KEPT packets and
                # silently decode wrong pixels, diverging from
                # PLT-ignoring decoders — fall back to bit-parsing.
                and sum(plt_lengths[:len(order)]) == len(body)):
            plt_skip = []
            for (_, r, c, pidx) in order:
                s = r > cods[c].num_levels - reduce
                if not s and win_rects is not None:
                    s = _prec_outside_window(c, r, pidx)
                plt_skip.append(s)
            if not any(plt_skip):
                plt_skip = None
        # native whole-tile packet parse (strict mode; any stream error
        # or resilient decode falls back to the Python reference, which
        # raises/recovers with exact semantics on untouched states)
        native_pos = None
        if not self.resilient and packed_hdrs is None:
            from ..native import t2_parse_packets_native
            native_pos = t2_parse_packets_native(
                bytes(body), comp_states, order,
                [cc.cb_style for cc in cods], cod0.use_sop, cod0.use_eph,
                pkt_skip=None if plt_skip is None else
                [plt_lengths[i] if plt_skip[i] else -1
                 for i in range(len(order))])
        if native_pos is None:
            pos = 0
            hpos = 0
            i = 0
            while i < len(order):
                l, r, c, pidx = order[i]
                # with packed headers, empty packets consume header
                # bytes but no body — truncation is header exhaustion,
                # except that rate truncation cuts the post-SOD bodies
                # while PPT headers stay whole: a layered packed stream
                # whose body is consumed takes the same graceful break
                # as the in-bitstream layout
                if packed_hdrs is not None:
                    exhausted = (hpos >= len(packed_hdrs)
                                 or (l > 0 and pos >= len(body)))
                else:
                    exhausted = pos >= len(body)
                if exhausted:
                    if self.resilient:
                        break
                    if l > 0:
                        break  # truncated layered stream
                    raise CorruptStreamError(
                        "tile body exhausted mid-packets")
                if plt_skip is not None and plt_skip[i]:
                    pos += plt_lengths[i]
                    i += 1
                    continue
                try:
                    if packed_hdrs is not None:
                        hpos, pos = decode_packet_split(
                            packed_hdrs, hpos, body, pos,
                            comp_states[c][(r, pidx)],
                            l, cods[c].cb_style,
                            use_sop=cod0.use_sop, use_eph=cod0.use_eph)
                    else:
                        pos = decode_packet(body, pos,
                                            comp_states[c][(r, pidx)],
                                            l, cods[c].cb_style,
                                            use_sop=cod0.use_sop,
                                            use_eph=cod0.use_eph)
                except CorruptStreamError:
                    if not self.resilient:
                        raise
                    # SOP resync (T.800 A.8.1, beyond the reference's
                    # flag-only decode): scan forward for the next SOP
                    # whose Nsop names a later packet of this tile and
                    # resume there — only the damaged packet's blocks
                    # are lost instead of every packet after it. The
                    # failed packet's partial state is kept; its blocks
                    # zero-fill at T1 if their data is inconsistent.
                    nxt = None
                    if cod0.use_sop and packed_hdrs is None:
                        nxt = _sop_resync(body, pos + 1, i, len(order))
                    if nxt is None:
                        break
                    pos, i = nxt
                    continue
                i += 1

        # T1 decode + assemble packed coefficient arrays per component
        # (int64: MaxShift-scaled ROI magnitudes can exceed 31 bits)
        for cr in comp_rects:
            # empty tile-components are conformant (T.800 B.3: a
            # subsampled grid can round a 1-column tile to nothing);
            # only inverted rects are corrupt
            if cr[2] < cr[0] or cr[3] < cr[1]:
                raise CorruptStreamError(
                    f"corrupt component rect {cr} (subsampling/tile grid)")
        # int32 carries every non-ROI stream (and the later
        # np.stack(...).astype(np.int32) becomes a plain copy); ROI
        # shifts can push magnitudes past 31 bits, so those tiles keep
        # the int64 headroom until the unshift below restores range
        _pdt = np.int64 if any((rgn_shifts or {}).values()) else np.int32
        packed_list = [
            np.zeros((cr[3] - cr[1], cr[2] - cr[0]), dtype=_pdt)
            for cr in eff_comp_rects]
        def _paste(c, bg, g, blk):
            packed_list[c][
                bg.row_off + (g.y0 - bg.y0):
                bg.row_off + (g.y1 - bg.y0),
                bg.col_off + (g.x0 - bg.x0):
                bg.col_off + (g.x1 - bg.x0)] = blk

        def _scalar_block(c, cod, is_ht, bg, ps, g, st):
            """One code-block through the scalar path (factory / HT /
            T1, native-or-Python) — exact per-block error semantics."""
            if self.block_decoder_factory is not None:
                dec = self.block_decoder_factory(
                    g.width, g.height, cod.cb_style, bg.orient)
                return np.asarray(dec.decode(
                    bytes(st.seg_data), st.num_passes, st.numbps,
                    seg_lengths=st.seg_ends, mb=ps.mb))
            if is_ht:
                from ..native import ht_cleanup_decode_native
                seg = bytes(st.seg_data)
                dref = b""
                if st.num_passes > 3:
                    # multiple HT sets per code-block (T.814 Annex B
                    # placeholder-pass machinery) are not implemented
                    raise CorruptStreamError(
                        f"{st.num_passes} HT passes: multiple HT sets "
                        "per code-block are not supported")
                if st.num_passes >= 2 and st.seg_ends:
                    cu_end = st.seg_ends[0]
                    seg, dref = seg[:cu_end], seg[cu_end:]
                blk = ht_cleanup_decode_native(
                    seg, g.width, g.height, ps.mb,
                    ps.mb - st.numbps)
                if isinstance(blk, tuple):
                    raise CorruptStreamError(
                        f"HT cleanup stream error {blk[1]}")
                if blk is None:
                    from ..entropy.htcleanup import HTCleanupDecoder
                    blk = HTCleanupDecoder(
                        g.width, g.height, ps.mb,
                        ps.mb - st.numbps).decode(seg)
                if dref:
                    # HT SigProp (+MagRef) refinement (T.814 §7.4-7.5);
                    # a zero-length refinement segment means Z_blk=1
                    # (B.3) and the cleanup output stands alone
                    from ..native import ht_refine_apply_native
                    causal = bool(cod.cb_style & 0x08)
                    w64 = np.asarray(blk, dtype=np.int64)
                    ref = ht_refine_apply_native(w64, dref,
                                                 st.num_passes, causal)
                    if ref is None or isinstance(ref, tuple):
                        # unavailable / stream error: the Python
                        # reference raises with exact semantics
                        from ..entropy.htrefine import apply_refinement
                        ref = apply_refinement(w64, dref, st.num_passes,
                                               causal)
                    blk = ref
                return blk
            import numpy as _np

            from ..native import t1_decode_native
            # int32 output skips a narrowing copy, but
            # MaxShift-ROI-scaled magnitudes (numbps up to Mb+Srgn)
            # can exceed 31 bits — those blocks must come back int64
            # (the ROI unshift below restores range)
            odt = _np.int32 if st.numbps <= 30 else _np.int64
            blk = t1_decode_native(
                bytes(st.seg_data), g.width, g.height, cod.cb_style,
                bg.orient, st.num_passes, st.numbps,
                seg_ends=st.seg_ends, ojp_recon=True, out_dtype=odt)
            if blk is None:
                dec = T1Decoder(g.width, g.height, style=cod.cb_style,
                                orientation=bg.orient,
                                openjpeg_reconstruction=True)
                blk = dec.decode(bytes(st.seg_data), st.num_passes,
                                 st.numbps, seg_lengths=st.seg_ends)
            return blk

        def _scalar_and_paste(c, cod, is_ht, bg, ps, g, st):
            try:
                blk = _scalar_block(c, cod, is_ht, bg, ps, g, st)
            except Exception:
                if not self.resilient:
                    raise
                blk = np.zeros((g.height, g.width), dtype=np.int64)
            _paste(c, bg, g, blk)

        # Walk once; defer native-eligible blocks into BATCHED calls
        # (one ctypes round-trip per style group per tile instead of
        # one per code-block — measured ~10% of dense-frame decode).
        # Factory blocks, deep-ROI (numbps>30) blocks, and any block
        # whose batched decode reports an error take the scalar path.
        from ..native import (get_lib, ht_cleanup_decode_blocks_native,
                              ht_decode_blocks_refined_native,
                              t1_decode_blocks_native)
        batch_ok = (get_lib() is not None
                    and self.block_decoder_factory is None)
        ht_items, ht_ctx = [], []
        htr_items, htr_ctx = [], []  # SigProp/MagRef multipass blocks
        t1_groups = {}  # cb_style -> (items, ctxs)
        # win_rects (computed above the packet walk) drives the same
        # per-block outside-window test here in T1
        for c in range(ncomp):
            cod = cods[c]
            is_ht = bool(cod.cb_style & 0x40)
            for res in comp_res[c]:
                if res.r > cod.num_levels - reduce:
                    continue  # discarded resolution (reduced decode)
                for prec in res.precincts:
                    plist = comp_states[c][(res.r, prec.index)]
                    for pb, ps in zip(prec.bands, plist):
                        bg = pb.band
                        wb = (None if win_rects is None else
                              win_rects[(c, res.r, bg.band)])
                        for g, st in zip(pb.blocks, ps.blocks):
                            if st.num_passes == 0 or st.numbps <= 0:
                                continue
                            if wb is not None and (
                                    g.x1 <= wb[0] or g.x0 >= wb[2]
                                    or g.y1 <= wb[1] or g.y0 >= wb[3]):
                                continue  # outside the decode window
                            ctx = (c, cod, is_ht, bg, ps, g, st)
                            if not batch_ok:
                                _scalar_and_paste(*ctx)
                            elif is_ht:
                                if st.num_passes > 3:
                                    # multiple HT sets: scalar path
                                    # raises with exact semantics
                                    _scalar_and_paste(*ctx)
                                    continue
                                if st.num_passes >= 2 and st.seg_ends:
                                    # SigProp/MagRef refinement rides
                                    # the batched cleanup+refine entry
                                    htr_items.append(
                                        (bytes(st.seg_data),
                                         st.seg_ends[0], g.width,
                                         g.height, ps.mb,
                                         ps.mb - st.numbps,
                                         st.num_passes,
                                         cod.cb_style & 0x08))
                                    htr_ctx.append(ctx)
                                    continue
                                ht_items.append(
                                    (bytes(st.seg_data), g.width,
                                     g.height, ps.mb, ps.mb - st.numbps))
                                ht_ctx.append(ctx)
                            elif st.numbps <= 30:
                                items, ctxs = t1_groups.setdefault(
                                    cod.cb_style, ([], []))
                                items.append(
                                    (bytes(st.seg_data), g.width,
                                     g.height, bg.orient, st.num_passes,
                                     st.numbps, st.seg_ends))
                                ctxs.append(ctx)
                            else:
                                _scalar_and_paste(*ctx)
        if ht_items:
            results = ht_cleanup_decode_blocks_native(ht_items)
            for i, ctx in enumerate(ht_ctx):
                blk = results[i] if results is not None else None
                if isinstance(blk, np.ndarray):
                    _paste(ctx[0], ctx[3], ctx[5], blk)
                else:
                    _scalar_and_paste(*ctx)
        if htr_items:
            results = ht_decode_blocks_refined_native(htr_items)
            for i, ctx in enumerate(htr_ctx):
                blk = results[i] if results is not None else None
                if isinstance(blk, np.ndarray):
                    _paste(ctx[0], ctx[3], ctx[5], blk)
                else:  # incl. status 900/901: exact error semantics
                    _scalar_and_paste(*ctx)
        for style, (items, ctxs) in t1_groups.items():
            results = t1_decode_blocks_native(items, style,
                                              ojp_recon=True)
            for i, ctx in enumerate(ctxs):
                blk = results[i] if results is not None else None
                if isinstance(blk, np.ndarray):
                    _paste(ctx[0], ctx[3], ctx[5], blk)
                else:
                    _scalar_and_paste(*ctx)

        # ROI unshift: MaxShift is mask-free (magnitude ≥ 2^Srgn ⇒ ROI);
        # General Scaling (Srgn=1) unshifts only coefficients under the
        # COM-carried geometry masks (reference tile_decoder.go:723-742)
        gs_masks = gs_masks or {}
        for c in range(ncomp):
            shift = rgn_shifts.get(c, 0)
            if not shift:
                continue
            if c in gs_masks and reduce:
                raise UnsupportedFormatError(
                    "reduced-resolution decode of General-Scaling ROI "
                    "streams is not supported (full-grid geometry masks)")
            if c in gs_masks and uniform:
                from .j2k_geometry import packed_band_layout
                from .j2k_roi import band_roi_mask, unshift_general
                for bg in packed_band_layout(tx0, ty0, tx1, ty1,
                                             cods[c].num_levels):
                    if bg.width <= 0 or bg.height <= 0:
                        continue
                    bm = band_roi_mask(gs_masks[c], tx0, ty0,
                                       cods[c].num_levels, bg.resolution,
                                       bg.band,
                                       (bg.x0, bg.y0, bg.x1, bg.y1))
                    region = packed_list[c][
                        bg.row_off : bg.row_off + bg.height,
                        bg.col_off : bg.col_off + bg.width]
                    region[:] = unshift_general(region, bm, shift)
            else:
                from .j2k_roi import unshift_maxshift
                packed_list[c] = unshift_maxshift(
                    packed_list[c], shift).astype(np.int64)
        if _return_packed_list:
            # decode_to_component_tiles: per-component host stage done
            # (post ROI unshift) — no uniform-grid requirement; each
            # component's packed subbands go to their own batched
            # inverse launch (parallel.mesh heterogeneous decode)
            return [p.astype(np.int32, copy=False) for p in packed_list]

        packed = None
        if uniform:
            packed = np.stack(packed_list).astype(np.int32,
                                              copy=False)

        if _return_packed:
            # pipeline.decode_frames_pipelined: host stage done — hand
            # the packed coefficient stack to the batched device IDWT
            if packed is None:
                raise UnsupportedFormatError(
                    "packed decode requires uniform component grids")
            return packed

        # device stage: inverse DWT (+ inverse MCT) + DC unshift.
        # Homogeneous tiles (no COC variation — the common case) run the
        # whole component stack in one launch; heterogeneous per-component
        # styles reconstruct each component separately first.
        cod = cod0
        eff_levels = cod0.num_levels - reduce
        homogeneous = uniform and all(
            cc.transform == cod0.transform
            and cc.num_levels == cod0.num_levels for cc in cods)
        if homogeneous and cod.transform == 1:
            from .. import native as _nat
            if _nat.get_lib() is not None and not mct_bindings_inv:
                # host fast path: native inverse 5/3 (bit-parity mirror)
                # + integer inverse RCT, no per-op device dispatch
                rec = np.stack([
                    _nat.dwt53_inv_native(p, eff_levels, etx0, ety0)
                    for p in packed])
                if cod.mct == 1 and ncomp >= 3:
                    r_, g_, b_ = rct_inverse_np(rec[0], rec[1], rec[2])
                    rec = np.stack([r_, g_, b_]
                                   + [rec[i] for i in range(3, ncomp)])
            else:
                rec = inv53_multilevel_(_to_device(packed, self.device),
                                        eff_levels, x0=etx0, y0=ety0)
                if mct_bindings_inv:
                    rec = torch.round(_apply_mct_bindings_inverse(
                        rec, mct_bindings_inv)).to(torch.int32)
                elif cod.mct == 1 and ncomp >= 3:
                    r_, g_, b_ = rct_inverse(rec[0], rec[1], rec[2])
                    rec = torch.stack([r_, g_, b_]
                                      + [rec[i] for i in range(3, ncomp)])
        elif homogeneous:
            # irreversible: per-band dequantization → float 9/7 inverse
            # (deltas build over the FULL level count — band indices in
            # the reduced layout are a prefix-stable subset)
            fpacked = np.stack([
                dequantize_packed(
                    packed[c], (etx0, ety0, etx1, ety1), eff_levels,
                    J2KEncoder._band_deltas(qcds[c], cod.num_levels,
                                            depth))
                for c in range(ncomp)])
            from .. import native as _nat
            if _nat.get_lib() is not None and not mct_bindings_inv:
                # host fast path: native float32 9/7 inverse + numpy
                # inverse ICT (no device dispatch; see encode-side note)
                rec = np.stack([
                    _nat.dwt97_inv_native(fpacked[c], eff_levels,
                                          etx0, ety0)
                    for c in range(ncomp)])
                if cod.mct == 1 and ncomp >= 3:
                    from ..ops.mct import ict_inverse_np
                    r_, g_, b_ = ict_inverse_np(rec[0], rec[1], rec[2])
                    rec = np.stack([r_, g_, b_]
                                   + [rec[i] for i in range(3, ncomp)])
                rec = np.round(rec).astype(np.int32)
            else:
                rec = inv97_multilevel(_to_device(fpacked, self.device),
                                       eff_levels, x0=etx0, y0=ety0)
                if mct_bindings_inv:
                    rec = _apply_mct_bindings_inverse(rec,
                                                      mct_bindings_inv)
                elif cod.mct == 1 and ncomp >= 3:
                    r_, g_, b_ = ict_inverse(rec[0], rec[1], rec[2])
                    rec = torch.stack([r_, g_, b_]
                                      + [rec[i] for i in range(3, ncomp)])
                rec = torch.round(rec).to(torch.int32)
        else:
            # COC-heterogeneous styles and/or XRsiz/YRsiz-subsampled
            # grids: per-component inverse transforms on each component's
            # own grid (MCT is undefined across mixed transforms —
            # components reconstruct independently, matching the
            # reference's per-component fallback in tile_decoder.go);
            # subsampled components upsample to the tile grid by sample
            # replication for interleaved output
            from .j2k_geometry import packed_band_layout
            recs = []
            for c in range(ncomp):
                cod_c = cods[c]
                lv_c = cod_c.num_levels - reduce
                ctx0, cty0, ctx1, cty1 = eff_comp_rects[c]
                cth, ctw = cty1 - cty0, ctx1 - ctx0
                if cth == 0 or ctw == 0:
                    # T.800 B.3: subsampling rounded this tile-component
                    # to nothing — contribute a zero plane
                    recs.append(np.zeros((th, tw), dtype=np.int32))
                    continue
                pk = packed_list[c].astype(np.int32, copy=False)
                if cod_c.transform == 1:
                    from .. import native as _nat
                    nat_rc = (_nat.dwt53_inv_native(pk, lv_c,
                                                    ctx0, cty0)
                              if _nat.get_lib() is not None else None)
                    rc = nat_rc if nat_rc is not None else inv53_multilevel_(
                        _to_device(pk[None], self.device), lv_c,
                        x0=ctx0, y0=cty0)[0].cpu().numpy()
                else:
                    fp = dequantize_packed(
                        pk, (ctx0, cty0, ctx1, cty1), lv_c,
                        J2KEncoder._band_deltas(qcds[c], cod_c.num_levels,
                                                depth))
                    rc = torch.round(inv97_multilevel(
                        _to_device(fp[None], self.device), lv_c,
                        x0=ctx0, y0=cty0)[0]).to(torch.int32).cpu().numpy()
                if (cth, ctw) != (th, tw):
                    up = np.asarray(rc)
                    ry = -(-th // max(cth, 1))
                    rx = -(-tw // max(ctw, 1))
                    up = np.repeat(np.repeat(up, ry, axis=0), rx, axis=1)
                    rc = up[:th, :tw]
                recs.append(rc)
            rec = np.stack(recs)
        if isinstance(rec, np.ndarray):
            rec = inv_dc_level_shift_np(rec, depth, signed)
        else:
            rec = inv_dc_level_shift(rec, depth, signed).cpu().numpy()
        tile_out = np.moveaxis(rec, 0, -1)
        return tile_out


def pack_decoded_pixels(arr: np.ndarray, depth: int, signed: bool,
                        widen16: bool = False) -> bytes:
    """Clip to the declared dynamic range and pack little-endian
    (reference decoder.go GetPixelData:777-947). widen16 forces a
    16-bit container for <=8-bit samples (DICOM BitsAllocated=16)."""
    lo, hi = (-(1 << (depth - 1)), (1 << (depth - 1)) - 1) if signed else \
        (0, (1 << depth) - 1)
    arr = np.clip(arr, lo, hi)
    if depth <= 8 and not widen16:
        dt = np.int8 if signed else np.uint8
    else:
        dt = np.dtype("<i2") if signed else np.dtype("<u2")
    return np.ascontiguousarray(arr.astype(dt)).tobytes()


def decode_to_pixels(data: bytes, reduce: int = 0, window=None,
                     device: Optional[torch.device] = None):
    """Decode a codestream → (pixel bytes, width, height, comps, depth,
    signed). reduce=R decodes at 1/2^R resolution; window=(x0,y0,x1,y1)
    decodes only that reference-grid region (J2KDecoder notes)."""
    arr, siz, cod = J2KDecoder(reduce=reduce, window=window,
                               device=device).decode(data)
    depth, signed, _, _ = siz.components[0]
    h, w, c = arr.shape
    return (pack_decoded_pixels(arr, depth, signed), w, h, c,
            depth, signed)


def decode_to_packed(data: bytes, return_qcd: bool = False,
                     reduce: int = 0):
    """Host stage only for a single-tile codestream: parse + T1 +
    subband assembly, stopping before the inverse DWT. Returns
    (packed [C, th, tw] int32, siz, cod) — the input the batched
    device IDWT in pipeline.decode_frames_pipelined consumes — or
    (packed, siz, cod, qcd) with return_qcd (the irreversible sharded
    decode needs the steps for host dequantization).

    Raises UnsupportedFormatError for multi-tile or non-uniform
    component grids (those decode through J2KDecoder.decode).
    """
    # cheap header-level rejection BEFORE any T1 work (the adapter
    # fallback would otherwise entropy-decode everything twice)
    cs = j2k.parse_codestream(data)
    if len(cs.tiles) != 1:
        raise UnsupportedFormatError("packed decode is single-tile only")
    if cs.mct_segments or cs.mcc_segments or cs.mco_segments:
        # Part-2 custom MCT inversion happens in the scalar device stage
        raise UnsupportedFormatError("packed decode: custom MCT streams "
                                     "use the scalar path")
    tiles, siz, cod, qcd, _ = decode_to_packed_tiles(data, reduce=reduce)
    packed = tiles[0][1]
    if return_qcd:
        return packed, siz, cod, qcd
    return packed, siz, cod


def decode_to_packed_tiles(data: bytes, reduce: int = 0):
    """Host stage for every tile of a codestream: parse + T1 + subband
    assembly, stopping before the inverse DWT. reduce=R skips the top
    R resolutions (J2KDecoder note) — rects and packed dims come back
    ceil-divided and the caller's inverse must run R levels short.
    Returns
    ([(rect, packed [C, th, tw] int32), ...] in raster tile order,
    siz, cod, qcd, mct_bindings_inv) — the per-tile input the
    multi-tile sharded decode batches across frames
    (parallel.mesh.decode_frames_sharded); mct_bindings_inv carries
    any Part-2 custom inverse matrices for the batched device stage.

    Raises UnsupportedFormatError for the stream classes whose inverse
    is not a uniform per-tile device program (per-component/tile COD
    overrides, subsampled components) — those decode through
    J2KDecoder.decode. ROI streams of both styles batch: MaxShift
    unshifts by magnitude, General-Scaling by the JP2ROI COM geometry
    masks, both on the packed host coefficients exactly like the
    scalar decoder.
    """
    cs = j2k.parse_codestream(data)
    siz = cs.siz
    _require_decodable_depths(siz)
    ncomp = len(siz.components)
    # General-Scaling ROI: the COM-carried geometry unshift runs on the
    # packed coefficients BEFORE the device stage (same site the scalar
    # decoder uses, _decode_tile), so GS streams batch like any other
    gs_regions = _gs_roi_regions(cs)
    for c in range(ncomp):
        _, _, xr, yr = siz.components[c]
        if max(xr, 1) != 1 or max(yr, 1) != 1:
            raise UnsupportedFormatError(
                "packed decode requires unsubsampled components")
    depth0, signed0, _, _ = siz.components[0]
    ntx, _ = siz.num_tiles
    dec = J2KDecoder(reduce=reduce)
    out = []
    # validate EVERY tile's header-level constraints before any entropy
    # work — these checks only need cod_for/qcd_for, and raising late
    # would waste a full T1 decode of the earlier tiles on every stream
    # the heterogeneous fallback then re-decodes
    cod0 = qcd0 = None
    plan = []
    for tidx, tile in sorted(cs.tiles.items()):
        rect = siz.tile_rect(tidx % ntx, tidx // ntx)
        cods = [cs.cod_for(c, tile) for c in range(ncomp)]
        qcds = [cs.qcd_for(c, tile) for c in range(ncomp)]
        if any(cc != cods[0] for cc in cods[1:]):
            raise UnsupportedFormatError("packed decode: per-component "
                                         "COD overrides use the scalar "
                                         "path")
        if cods[0].transform != 1 and any(qc != qcds[0]
                                          for qc in qcds[1:]):
            # the batched irreversible dequant uses ONE QCD; reversible
            # decode never reads it after entropy, so QCC only matters
            # here (the scalar path dequantizes per component)
            raise UnsupportedFormatError("packed decode: per-component "
                                         "QCC overrides use the scalar "
                                         "path")
        if cod0 is None:
            cod0, qcd0 = cods[0], qcds[0]
        elif cods[0] != cod0:
            raise UnsupportedFormatError("packed decode: per-tile COD "
                                         "overrides use the scalar path")
        elif cods[0].transform != 1 and qcds[0] != qcd0:
            raise UnsupportedFormatError("packed decode: per-tile QCD "
                                         "overrides use the scalar path")
        plan.append((tile, rect, cods, qcds))
    for tile, rect, cods, qcds in plan:
        tx0, ty0, tx1, ty1 = rect
        gs_masks = _gs_masks_for_tile(cs, gs_regions, rect)
        packed = dec._decode_tile(
            tile.data, rect, cods, qcds, ncomp, depth0, signed0,
            cs.rgn_shifts, None, poc=cs.poc_for(tile),
            gs_masks=gs_masks or None,
            comp_rects=[(tx0, ty0, tx1, ty1)] * ncomp,
            packed_hdrs=tile.ppt,
            plt_lengths=tile.plt,
            _return_packed=True)
        if reduce:
            # reduced decode: the packed arrays live on the level-R
            # window; report the matching ceil-div rect so the batched
            # inverse runs with the right origins/paste bounds
            rect = tuple(-(-v // (1 << reduce)) for v in rect)
        out.append((rect, packed))
    return out, siz, cod0, qcd0, _extract_mct_inverse(cs, ncomp)


def decode_to_component_tiles(data: bytes):
    """Host stage for the HETEROGENEOUS stream classes the packed path
    rejects — XRsiz/YRsiz-subsampled components, per-component COD/QCD
    (COC/QCC), per-tile overrides: parse + T1 + per-component subband
    assembly on each component's own ceil-divided grid (reference
    tile_decoder.go:330-392), stopping before the inverse DWT.

    Returns (tiles, siz) with tiles in raster tile order, one entry
    (rect, comp_rects, packed_list, cods, qcds) per tile: packed_list
    holds each component's packed subbands ([hc, wc] int32, ROI already
    unshifted), cods/qcds the effective per-component CodInfo/QcdInfo.
    The inverse of such a tile is per-component device programs with no
    cross-component math (MCT is undefined across mixed grids — the
    scalar decoder's heterogeneous branch reconstructs components
    independently, and so does parallel.mesh on top of this).

    Raises UnsupportedFormatError for Part-2 custom MCT streams (those
    are uniform by construction — decode_to_packed_tiles carries them).
    """
    cs = j2k.parse_codestream(data)
    siz = cs.siz
    _require_decodable_depths(siz)
    ncomp = len(siz.components)
    if cs.mct_segments or cs.mcc_segments or cs.mco_segments:
        raise UnsupportedFormatError(
            "component-tiles decode: custom MCT streams use the "
            "packed/scalar paths")
    gs_regions = _gs_roi_regions(cs)
    depth0, signed0, _, _ = siz.components[0]
    ntx, _ = siz.num_tiles
    dec = J2KDecoder()
    out = []
    for tidx, tile in sorted(cs.tiles.items()):
        rect = siz.tile_rect(tidx % ntx, tidx // ntx)
        tx0, ty0, tx1, ty1 = rect
        cods = [cs.cod_for(c, tile) for c in range(ncomp)]
        qcds = [cs.qcd_for(c, tile) for c in range(ncomp)]
        comp_rects = []
        for c in range(ncomp):
            _, _, xr, yr = siz.components[c]
            xr, yr = max(xr, 1), max(yr, 1)
            comp_rects.append((-(-tx0 // xr), -(-ty0 // yr),
                               -(-tx1 // xr), -(-ty1 // yr)))
        gs_masks = _gs_masks_for_tile(cs, gs_regions, rect)
        packed_list = dec._decode_tile(
            tile.data, rect, cods, qcds, ncomp, depth0, signed0,
            cs.rgn_shifts, None, poc=cs.poc_for(tile),
            gs_masks=gs_masks or None, comp_rects=comp_rects,
            packed_hdrs=tile.ppt,
            plt_lengths=tile.plt,
            _return_packed_list=True)
        out.append((rect, comp_rects, packed_list, cods, qcds))
    return out, siz
