"""EBCOT Tier-1 bit-plane coder (ISO/IEC 15444-1:2019 Annex D), host-side.

Covers the role of reference jpeg2000/t1/ (encoder.go, decoder.go,
context.go): stripe-ordered SPP/MRP/CP passes over a code-block, 19 MQ
contexts, code-block style flags (LAZY/RESET/TERMALL/VSC/PTERM/SEGSYM),
per-pass termination, and pass-boundary capture for rate allocation.

The context lookup tables are GENERATED from the T.800 Table D.1-D.3 rules
(zero-coding by (ΣH, ΣV, ΣD) per band orientation, sign coding by clamped
horizontal/vertical sign contributions) rather than hard-coded — the
generator doubles as documentation, and tests pin spot values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .mq import MQDecoder, MQEncoder, RawDecoder

# Context indices (Annex D / reference t1/context.go:10-36)
CTX_ZC_START = 0
CTX_SC_START = 9
CTX_MR_START = 14
CTX_RL = 17
CTX_UNI = 18
NUM_CONTEXTS = 19

# Code-block style flags (ISO Table A.18)
STYLE_LAZY = 0x01
STYLE_RESET = 0x02
STYLE_TERMALL = 0x04
STYLE_VSC = 0x08
STYLE_PTERM = 0x10
STYLE_SEGSYM = 0x20

# flag bits (one uint32 per padded sample)
F_SIG = 0x0001
F_REFINE = 0x0002
F_VISIT = 0x0004
F_SIG_N = 0x0010
F_SIG_S = 0x0020
F_SIG_W = 0x0040
F_SIG_E = 0x0080
F_SIG_NW = 0x0100
F_SIG_NE = 0x0200
F_SIG_SW = 0x0400
F_SIG_SE = 0x0800
F_SIG_NEIGH = (F_SIG_N | F_SIG_S | F_SIG_W | F_SIG_E |
               F_SIG_NW | F_SIG_NE | F_SIG_SW | F_SIG_SE)
F_SIGN = 0x1000
F_SIGN_N = 0x2000
F_SIGN_S = 0x4000
F_SIGN_W = 0x8000
F_SIGN_E = 0x10000


def _zc_context(h: int, v: int, d: int, orient: int) -> int:
    """T.800 Table D.1 zero-coding context from neighbor counts."""
    if orient == 1:  # HL: swap roles of h and v
        h, v = v, h
    if orient != 3:  # LL / LH / HL(after swap)
        if h == 2:
            return 8
        if h == 1:
            if v >= 1:
                return 7
            return 6 if d >= 1 else 5
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else (1 if d == 1 else 0)
    # HH
    hv = h + v
    if d >= 3:
        return 8
    if d == 2:
        return 7 if hv >= 1 else 6
    if d == 1:
        return 5 if hv >= 2 else (4 if hv == 1 else 3)
    return 2 if hv >= 2 else (1 if hv == 1 else 0)


def _build_zc_lut() -> np.ndarray:
    """[4, 512]: 9-bit neighbor-significance pattern → ZC context.

    Index bit layout (reference t1/context.go:277-308): 0=NW, 1=N, 2=NE,
    3=W, 5=E, 6=SW, 7=S, 8=SE.
    """
    lut = np.zeros((4, 512), dtype=np.uint8)
    for orient in range(4):
        for idx in range(512):
            nw, n, ne = idx & 1, (idx >> 1) & 1, (idx >> 2) & 1
            w, e = (idx >> 3) & 1, (idx >> 5) & 1
            sw, s, se = (idx >> 6) & 1, (idx >> 7) & 1, (idx >> 8) & 1
            lut[orient, idx] = _zc_context(w + e, n + s, nw + ne + sw + se,
                                           orient)
    return lut


def _build_sc_luts() -> Tuple[np.ndarray, np.ndarray]:
    """[256] sign-coding context + sign prediction (T.800 Table D.3).

    Index bit layout (reference t1/context.go:167-175): 0=W sign, 1=N sig,
    2=E sign, 3=W sig, 4=N sign, 5=E sig, 6=S sign, 7=S sig.
    """
    ctx = np.zeros(256, dtype=np.uint8)
    spb = np.zeros(256, dtype=np.uint8)
    table = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0),
             (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
             (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}
    for idx in range(256):
        def contrib(sig, neg):
            return 0 if not sig else (-1 if neg else 1)
        w = contrib((idx >> 3) & 1, idx & 1)
        e = contrib((idx >> 5) & 1, (idx >> 2) & 1)
        n = contrib((idx >> 1) & 1, (idx >> 4) & 1)
        s = contrib((idx >> 7) & 1, (idx >> 6) & 1)
        hc = max(-1, min(1, w + e))
        vc = max(-1, min(1, n + s))
        c, x = table[(hc, vc)]
        ctx[idx] = c
        spb[idx] = x
    return ctx, spb


ZC_LUT = _build_zc_lut()
SC_LUT, SPB_LUT = _build_sc_luts()


def _sc_index(flags: int) -> int:
    """Flags → 8-bit sign LUT index (reference context.go:236-272)."""
    idx = 0
    if flags & F_SIG_W:
        idx |= 1 << 3
        if flags & F_SIGN_W:
            idx |= 1 << 0
    if flags & F_SIG_N:
        idx |= 1 << 1
        if flags & F_SIGN_N:
            idx |= 1 << 4
    if flags & F_SIG_E:
        idx |= 1 << 5
        if flags & F_SIGN_E:
            idx |= 1 << 2
    if flags & F_SIG_S:
        idx |= 1 << 7
        if flags & F_SIGN_S:
            idx |= 1 << 6
    return idx


def _zc_index(flags: int) -> int:
    """Flags → 9-bit ZC LUT index."""
    idx = 0
    if flags & F_SIG_NW:
        idx |= 1
    if flags & F_SIG_N:
        idx |= 2
    if flags & F_SIG_NE:
        idx |= 4
    if flags & F_SIG_W:
        idx |= 8
    if flags & F_SIG_E:
        idx |= 32
    if flags & F_SIG_SW:
        idx |= 64
    if flags & F_SIG_S:
        idx |= 128
    if flags & F_SIG_SE:
        idx |= 256
    return idx


def _mr_context(flags: int) -> int:
    if flags & F_REFINE:
        return CTX_MR_START + 2
    if flags & F_SIG_NEIGH:
        return CTX_MR_START + 1
    return CTX_MR_START


# VSC (vertically stripe-causal, style 0x08): at the bottom row of each
# 4-row stripe, the stripe below is treated as insignificant when forming
# contexts (T.800 D.3; OpenJPEG opj_t1_getctxno_* vsc variants).
_VSC_MASK = ~(F_SIG_S | F_SIG_SW | F_SIG_SE | F_SIGN_S)


def _ctx_flags(f: int, y: int, vsc: bool) -> int:
    if vsc and (y & 3) == 3:
        return f & _VSC_MASK
    return f


@dataclass
class PassInfo:
    """One coding pass: type (0 SPP / 1 MRP / 2 CP), bitplane, whether the
    encoder terminated after it, cumulative byte length at its end, and the
    pass's NMSEDEC distortion-decrease sum (integer, 1/8192 units of
    4^bitplane — T.800 J.4 fixed point)."""
    pass_type: int
    bitplane: int
    terminated: bool
    rate: int
    nmsedec: int = 0


# ---- NMSEDEC distortion tables (T.800 J.4; same fixed point as
#      OpenJPEG t1_generate_luts / reference t1/nmsedec.go:84-112) ----------
# t = index/64 is the sample magnitude normalized to the current bitplane
# (1 integer bit + 6 fraction bits). Entries are round(64·f)·(8192/64):
#   sig  : f = t² − (t−1.5)²  = 3t − 2.25   (new significance, recon at 1.5)
#   sig0 : f = t²                           (bitplane-0 variant)
#   ref  : f = 0.75−t (t<1) / t−1.25 (t≥1)  (refinement recon midpoint move)
#   ref0 : f = (t−1)²                       (bitplane-0 variant)
_NMSEDEC_FRAC = 6


def _gen_nmsedec():
    n = 1 << 7
    sig = np.zeros(n, np.int32)
    sig0 = np.zeros(n, np.int32)
    ref = np.zeros(n, np.int32)
    ref0 = np.zeros(n, np.int32)
    for i in range(n):
        t = i / 64.0
        sig[i] = max(0, int(np.floor((3.0 * t - 2.25) * 64 + 0.5))) * 128
        sig0[i] = max(0, int(np.floor(t * t * 64 + 0.5))) * 128
        f = (0.75 - t) if t < 1.0 else (t - 1.25)
        ref[i] = max(0, int(np.floor(f * 64 + 0.5))) * 128
        u = t - 1.0
        ref0[i] = max(0, int(np.floor(u * u * 64 + 0.5))) * 128
    return sig, sig0, ref, ref0


NMSEDEC_SIG, NMSEDEC_SIG0, NMSEDEC_REF, NMSEDEC_REF0 = _gen_nmsedec()


def nmsedec_sig(av: int, bp: int) -> int:
    """Distortion decrease for a sample becoming significant at plane bp."""
    x = av << _NMSEDEC_FRAC
    if bp > 0:
        return int(NMSEDEC_SIG[(x >> bp) & 127])
    return int(NMSEDEC_SIG0[x & 127])


def nmsedec_ref(av: int, bp: int) -> int:
    """Distortion decrease for refining a significant sample at plane bp."""
    x = av << _NMSEDEC_FRAC
    if bp > 0:
        return int(NMSEDEC_REF[(x >> bp) & 127])
    return int(NMSEDEC_REF0[x & 127])


def _is_lazy_raw(bitplane: int, maxbp: int, pass_type: int, style: int) -> bool:
    """Lazy (bypass) passes: SPP/MRP below maxbp-3 (encoder.go:51-59)."""
    if not (style & STYLE_LAZY) or pass_type >= 2:
        return False
    return bitplane < maxbp - 3


def _is_terminating(bitplane: int, maxbp: int, pass_type: int, style: int) -> bool:
    """Termination rules (encoder.go:61-77)."""
    if pass_type == 2 and bitplane == 0:
        return True
    if style & STYLE_TERMALL:
        return True
    if style & STYLE_LAZY:
        if bitplane == maxbp - 3 and pass_type == 2:
            return True
        if bitplane < maxbp - 3 and pass_type > 0:
            return True
    return False


def max_bitplanes(data: np.ndarray) -> int:
    """Number of magnitude bit-planes (0 for an all-zero block)."""
    m = int(np.abs(data).max()) if data.size else 0
    return m.bit_length()


class T1Encoder:
    """Code-block encoder (reference t1/encoder.go:159-282 sequencing)."""

    def __init__(self, width: int, height: int, style: int = 0,
                 orientation: int = 0) -> None:
        self.w = width
        self.h = height
        self.style = style
        self.orient = orientation

    def encode(self, data: np.ndarray, roishift: int = 0,
               num_passes: Optional[int] = None
               ) -> Tuple[bytes, int, List[PassInfo]]:
        """Encode a [h, w] int32 block.

        Returns (stream bytes, max_bitplane_count aka numbps, pass list).
        """
        w, h = self.w, self.h
        pw = w + 2
        flags = np.zeros((h + 2) * pw, dtype=np.int64)
        d = np.zeros((h + 2) * pw, dtype=np.int64)
        dd = np.asarray(data, dtype=np.int64).reshape(h, w)
        for y in range(h):
            d[(y + 1) * pw + 1 : (y + 1) * pw + 1 + w] = dd[y]

        numbps = max_bitplanes(dd)
        mqe = MQEncoder(NUM_CONTEXTS)
        if numbps == 0:
            mqe.flush()
            return mqe.get_buffer(), 0, []
        maxbp = numbps - 1

        mqe.set_context_state(CTX_UNI, 46)
        mqe.set_context_state(CTX_RL, 3)
        mqe.set_context_state(CTX_ZC_START, 4)

        passes: List[PassInfo] = []
        limit = num_passes if num_passes is not None else 1 << 30
        pass_type = 2
        bitplane = maxbp
        prev_terminated = False
        pass_idx = 0
        while bitplane >= 0 and pass_idx < limit:
            if pass_type == 0 or (pass_type == 2 and pass_idx == 0):
                flags &= ~F_VISIT
                if roishift > 0 and bitplane >= roishift:
                    pass_type = 0
                    bitplane -= 1
                    continue

            raw = _is_lazy_raw(bitplane, maxbp, pass_type, self.style)
            if prev_terminated:
                if raw:
                    mqe.bypass_init()
                else:
                    mqe.restart_init()
                prev_terminated = False

            if pass_type == 0:
                nmsedec = self._spp(mqe, d, flags, bitplane, raw)
            elif pass_type == 1:
                nmsedec = self._mrp(mqe, d, flags, bitplane, raw)
            else:
                nmsedec = self._cp(mqe, d, flags, bitplane)
                if self.style & STYLE_SEGSYM:
                    for i in (1, 0, 1, 0):
                        mqe.encode(i, CTX_UNI)

            terminated = _is_terminating(bitplane, maxbp, pass_type, self.style)
            if terminated:
                if raw:
                    mqe.bypass_flush(bool(self.style & STYLE_PTERM))
                elif self.style & STYLE_PTERM:
                    mqe.erterm()
                else:
                    mqe.flush()
                prev_terminated = True

            passes.append(PassInfo(pass_type, bitplane, terminated,
                                   mqe.num_bytes(), nmsedec))

            if self.style & STYLE_RESET:
                mqe.reset_contexts()
                mqe.set_context_state(CTX_UNI, 46)
                mqe.set_context_state(CTX_RL, 3)
                mqe.set_context_state(CTX_ZC_START, 4)

            pass_idx += 1
            if pass_type == 2:
                pass_type = 0
                bitplane -= 1
            else:
                pass_type += 1

        if not prev_terminated:
            mqe.flush()
        if passes:
            passes[-1] = PassInfo(passes[-1].pass_type, passes[-1].bitplane,
                                  True, mqe.num_bytes())
        return mqe.get_buffer(), numbps, passes

    # -- passes (stripe order: 4-row groups, column-major within stripe) --

    def _spp(self, mqe, d, flags, bp, raw):
        w, h, pw = self.w, self.h, self.w + 2
        orient = self.orient
        vsc = bool(self.style & STYLE_VSC)
        zc = ZC_LUT[orient]
        nm = 0
        for k in range(0, h, 4):
            for x in range(w):
                for y in range(k, min(k + 4, h)):
                    idx = (y + 1) * pw + x + 1
                    f = int(flags[idx])
                    cf = _ctx_flags(f, y, vsc)
                    if f & F_SIG or not (cf & F_SIG_NEIGH):
                        continue
                    v = int(d[idx])
                    av = -v if v < 0 else v
                    sig = (av >> bp) & 1
                    if raw:
                        mqe.bypass_encode(sig)
                    else:
                        mqe.encode(sig, int(zc[_zc_index(cf)]))
                    flags[idx] |= F_VISIT
                    if sig:
                        sign = 1 if v < 0 else 0
                        if sign:
                            flags[idx] |= F_SIGN
                        if raw:
                            mqe.bypass_encode(sign)
                        else:
                            si = _sc_index(cf)
                            mqe.encode(sign ^ int(SPB_LUT[si]),
                                       int(SC_LUT[si]))
                        flags[idx] |= F_SIG
                        self._update_neighbors(flags, x, y, idx)
                        nm += nmsedec_sig(av, bp)
        return nm

    def _mrp(self, mqe, d, flags, bp, raw):
        w, h, pw = self.w, self.h, self.w + 2
        nm = 0
        for k in range(0, h, 4):
            for x in range(w):
                for y in range(k, min(k + 4, h)):
                    idx = (y + 1) * pw + x + 1
                    f = int(flags[idx])
                    if not (f & F_SIG) or (f & F_VISIT):
                        continue
                    v = int(d[idx])
                    av = -v if v < 0 else v
                    bit = (av >> bp) & 1
                    if raw:
                        mqe.bypass_encode(bit)
                    else:
                        mqe.encode(bit, _mr_context(
                            _ctx_flags(f, y, bool(self.style & STYLE_VSC))))
                    flags[idx] |= F_REFINE
                    nm += nmsedec_ref(av, bp)
        return nm

    def _cp(self, mqe, d, flags, bp):
        w, h, pw = self.w, self.h, self.w + 2
        orient = self.orient
        vsc = bool(self.style & STYLE_VSC)
        zc = ZC_LUT[orient]
        nm = 0
        for k in range(0, h, 4):
            for x in range(w):
                if k + 3 < h:
                    can_rl = True
                    rl_pos = -1
                    for dy in range(4):
                        idx = (k + dy + 1) * pw + x + 1
                        f = int(flags[idx])
                        cf = _ctx_flags(f, k + dy, vsc)
                        if f & (F_VISIT | F_SIG) or cf & F_SIG_NEIGH:
                            can_rl = False
                            break
                        if rl_pos < 0:
                            v = int(d[idx])
                            av = -v if v < 0 else v
                            if (av >> bp) & 1:
                                rl_pos = dy
                    if can_rl:
                        mqe.encode(1 if rl_pos >= 0 else 0, CTX_RL)
                        if rl_pos < 0:
                            continue
                        mqe.encode((rl_pos >> 1) & 1, CTX_UNI)
                        mqe.encode(rl_pos & 1, CTX_UNI)
                        partial = True
                        for dy in range(rl_pos, 4):
                            y = k + dy
                            idx = (y + 1) * pw + x + 1
                            f = int(flags[idx])
                            if f & (F_VISIT | F_SIG):
                                flags[idx] &= ~F_VISIT
                                continue
                            v = int(d[idx])
                            av = -v if v < 0 else v
                            if partial:
                                sig = 1
                                partial = False
                            else:
                                sig = (av >> bp) & 1
                                cf = _ctx_flags(f, y, vsc)
                                mqe.encode(sig, int(zc[_zc_index(cf)]))
                            if sig:
                                sign = 1 if v < 0 else 0
                                if sign:
                                    flags[idx] |= F_SIGN
                                si = _sc_index(_ctx_flags(f, y, vsc))
                                mqe.encode(sign ^ int(SPB_LUT[si]),
                                           int(SC_LUT[si]))
                                flags[idx] |= F_SIG
                                self._update_neighbors(flags, x, y, idx)
                                nm += nmsedec_sig(av, bp)
                            flags[idx] &= ~F_VISIT
                        continue
                for y in range(k, min(k + 4, h)):
                    idx = (y + 1) * pw + x + 1
                    f = int(flags[idx])
                    if f & (F_VISIT | F_SIG):
                        flags[idx] &= ~F_VISIT
                        continue
                    v = int(d[idx])
                    av = -v if v < 0 else v
                    sig = (av >> bp) & 1
                    cf = _ctx_flags(f, y, vsc)
                    mqe.encode(sig, int(zc[_zc_index(cf)]))
                    if sig:
                        sign = 1 if v < 0 else 0
                        if sign:
                            flags[idx] |= F_SIGN
                        si = _sc_index(cf)
                        mqe.encode(sign ^ int(SPB_LUT[si]), int(SC_LUT[si]))
                        flags[idx] |= F_SIG
                        self._update_neighbors(flags, x, y, idx)
                        nm += nmsedec_sig(av, bp)
                    flags[idx] &= ~F_VISIT
        return nm

    def _update_neighbors(self, flags, x, y, idx):
        pw = self.w + 2
        sign = int(flags[idx]) & F_SIGN
        n = y * pw + x + 1
        s = (y + 2) * pw + x + 1
        wi = (y + 1) * pw + x
        e = (y + 1) * pw + x + 2
        flags[n] |= F_SIG_S
        flags[s] |= F_SIG_N
        flags[wi] |= F_SIG_E
        flags[e] |= F_SIG_W
        if sign:
            flags[n] |= F_SIGN_S
            flags[s] |= F_SIGN_N
            flags[wi] |= F_SIGN_E
            flags[e] |= F_SIGN_W
        flags[y * pw + x] |= F_SIG_SE
        flags[y * pw + x + 2] |= F_SIG_SW
        flags[(y + 2) * pw + x] |= F_SIG_NE
        flags[(y + 2) * pw + x + 2] |= F_SIG_NW


class T1Decoder:
    """Code-block decoder (reference t1/decoder.go), pass-sequenced like
    the encoder; supports single-segment and TERMALL-segmented streams."""

    def __init__(self, width: int, height: int, style: int = 0,
                 orientation: int = 0,
                 openjpeg_reconstruction: bool = False) -> None:
        self.w = width
        self.h = height
        self.style = style
        self.orient = orientation
        self.ojp_recon = openjpeg_reconstruction

    def decode(self, data: bytes, num_passes: int, numbps: int,
               roishift: int = 0,
               seg_lengths: Optional[List[int]] = None) -> np.ndarray:
        """Decode → [h, w] int32 coefficients.

        numbps: magnitude bit-plane count (from T2 zero-bitplane info).
        seg_lengths: cumulative byte ends per terminated segment when the
        stream was TERMALL/lazy-terminated (None ⇒ single segment).
        """
        w, h = self.w, self.h
        pw = w + 2
        flags = np.zeros((h + 2) * pw, dtype=np.int64)
        d = np.zeros((h + 2) * pw, dtype=np.int64)
        if numbps <= 0 or num_passes <= 0:
            return np.zeros((h, w), dtype=np.int64)
        maxbp = numbps - 1

        # segmentation of the byte stream across terminated passes
        term_flags = self._termination_pattern(maxbp, num_passes)
        use_segs = seg_lengths is not None and any(term_flags[:-1])

        mqd = None
        rawd = None
        contexts = None
        seg_idx = 0
        seg_start = 0

        def new_mq(segment: bytes, inherit):
            m = MQDecoder(segment, NUM_CONTEXTS, contexts=inherit)
            if inherit is None:
                m.set_context_state(CTX_UNI, 46)
                m.set_context_state(CTX_RL, 3)
                m.set_context_state(CTX_ZC_START, 4)
            return m

        segment = data
        if use_segs:
            end = seg_lengths[seg_idx]
            segment = data[seg_start:end]
            seg_start_next = end
        pass_type = 2
        bitplane = maxbp
        pass_idx = 0
        need_new_coder = True
        while bitplane >= 0 and pass_idx < num_passes:
            if pass_type == 0 or (pass_type == 2 and pass_idx == 0):
                flags &= ~F_VISIT
                if roishift > 0 and bitplane >= roishift:
                    pass_type = 0
                    bitplane -= 1
                    continue

            raw = _is_lazy_raw(bitplane, maxbp, pass_type, self.style)
            if need_new_coder:
                if raw:
                    rawd = RawDecoder(segment)
                    mqd = None
                else:
                    reset = (self.style & STYLE_RESET) != 0
                    mqd = new_mq(segment,
                                 None if (contexts is None or reset) else contexts)
                    rawd = None
                need_new_coder = False

            if pass_type == 0:
                self._spp(mqd, rawd, d, flags, bitplane, raw)
            elif pass_type == 1:
                self._mrp(mqd, rawd, d, flags, bitplane, raw)
            else:
                self._cp(mqd, d, flags, bitplane)
                if self.style & STYLE_SEGSYM:
                    for _ in range(4):
                        mqd.decode(CTX_UNI)

            if self.style & STYLE_RESET:
                # encoder resets contexts after every pass (encoder.go:255-260)
                if mqd is not None:
                    mqd.reset_contexts()
                    mqd.set_context_state(CTX_UNI, 46)
                    mqd.set_context_state(CTX_RL, 3)
                    mqd.set_context_state(CTX_ZC_START, 4)
                contexts = None
            elif mqd is not None:
                contexts = mqd.get_contexts()

            if term_flags[pass_idx] and pass_idx + 1 < num_passes:
                if use_segs:
                    seg_idx += 1
                    if seg_idx < len(seg_lengths):
                        end = seg_lengths[seg_idx]
                        segment = data[seg_start_next:end]
                        seg_start_next = end
                    else:
                        segment = b""
                need_new_coder = True

            pass_idx += 1
            if pass_type == 2:
                pass_type = 0
                bitplane -= 1
            else:
                pass_type += 1

        out = np.zeros((h, w), dtype=np.int64)
        for y in range(h):
            out[y] = d[(y + 1) * pw + 1 : (y + 1) * pw + 1 + w]
        if self.ojp_recon:
            # halve out of the doubled domain, truncating toward zero
            out = np.sign(out) * (np.abs(out) >> 1)
        return out

    def _termination_pattern(self, maxbp: int, num_passes: int) -> List[bool]:
        """Which passes end with a terminated segment, given the style."""
        out = []
        pass_type = 2
        bitplane = maxbp
        for _ in range(num_passes):
            out.append(_is_terminating(bitplane, maxbp, pass_type, self.style))
            if pass_type == 2:
                pass_type = 0
                bitplane -= 1
            else:
                pass_type += 1
        return out

    def segment_boundaries(self, numbps: int, num_passes: int) -> List[int]:
        """Pass indices after which the encoder terminated (for T2 lengths)."""
        if numbps <= 0:
            return []
        t = self._termination_pattern(numbps - 1, num_passes)
        return [i for i, term in enumerate(t) if term]

    def _recon_sig(self, bp: int, sign: int) -> int:
        if self.ojp_recon:
            # doubled domain: one-plus-half at 2^(bp+1) | 2^bp; the
            # final halving in decode() makes complete blocks exact and
            # truncated ones mid-bin (reference t1/decoder.go:630-646 +
            # tile_decoder.go:989-993, transposed to our unshifted T1
            # coefficient domain)
            v = (1 << (bp + 1)) | (1 << bp)
        else:
            v = 1 << bp
        return -v if sign else v

    def _recon_ref(self, cur: int, bp: int, bit: int) -> int:
        if self.ojp_recon:
            poshalf = 1 << bp
            if (bit != 0) != (cur < 0):
                return cur + poshalf
            return cur - poshalf
        if bit == 0:
            return cur
        return cur + (1 << bp) if cur >= 0 else cur - (1 << bp)

    def _spp(self, mqd, rawd, d, flags, bp, raw):
        w, h, pw = self.w, self.h, self.w + 2
        vsc = bool(self.style & STYLE_VSC)
        zc = ZC_LUT[self.orient]
        for k in range(0, h, 4):
            for x in range(w):
                for y in range(k, min(k + 4, h)):
                    idx = (y + 1) * pw + x + 1
                    f = int(flags[idx])
                    cf = _ctx_flags(f, y, vsc)
                    if f & F_SIG or not (cf & F_SIG_NEIGH):
                        continue
                    if raw:
                        sig = rawd.decode()
                    else:
                        sig = mqd.decode(int(zc[_zc_index(cf)]))
                    flags[idx] |= F_VISIT
                    if sig:
                        if raw:
                            sign = rawd.decode()
                        else:
                            si = _sc_index(cf)
                            sign = mqd.decode(int(SC_LUT[si])) ^ int(SPB_LUT[si])
                        if sign:
                            flags[idx] |= F_SIGN
                        d[idx] = self._recon_sig(bp, sign)
                        flags[idx] |= F_SIG
                        self._update_neighbors(flags, x, y, idx)

    def _mrp(self, mqd, rawd, d, flags, bp, raw):
        w, h, pw = self.w, self.h, self.w + 2
        for k in range(0, h, 4):
            for x in range(w):
                for y in range(k, min(k + 4, h)):
                    idx = (y + 1) * pw + x + 1
                    f = int(flags[idx])
                    if not (f & F_SIG) or (f & F_VISIT):
                        continue
                    bit = rawd.decode() if raw else mqd.decode(_mr_context(
                        _ctx_flags(f, y, bool(self.style & STYLE_VSC))))
                    d[idx] = self._recon_ref(int(d[idx]), bp, bit)
                    flags[idx] |= F_REFINE

    def _cp(self, mqd, d, flags, bp):
        w, h, pw = self.w, self.h, self.w + 2
        vsc = bool(self.style & STYLE_VSC)
        zc = ZC_LUT[self.orient]
        for k in range(0, h, 4):
            for x in range(w):
                if k + 3 < h:
                    can_rl = True
                    for dy in range(4):
                        idx = (k + dy + 1) * pw + x + 1
                        f = int(flags[idx])
                        cf = _ctx_flags(f, k + dy, vsc)
                        if f & (F_VISIT | F_SIG) or cf & F_SIG_NEIGH:
                            can_rl = False
                            break
                    if can_rl:
                        if mqd.decode(CTX_RL) == 0:
                            continue
                        rl_pos = (mqd.decode(CTX_UNI) << 1) | mqd.decode(CTX_UNI)
                        partial = True
                        for dy in range(rl_pos, 4):
                            y = k + dy
                            idx = (y + 1) * pw + x + 1
                            f = int(flags[idx])
                            if f & (F_VISIT | F_SIG):
                                flags[idx] &= ~F_VISIT
                                continue
                            if partial:
                                sig = 1
                                partial = False
                            else:
                                sig = mqd.decode(int(zc[_zc_index(
                                    _ctx_flags(f, y, vsc))]))
                            if sig:
                                si = _sc_index(_ctx_flags(f, y, vsc))
                                sign = mqd.decode(int(SC_LUT[si])) ^ int(SPB_LUT[si])
                                if sign:
                                    flags[idx] |= F_SIGN
                                d[idx] = self._recon_sig(bp, sign)
                                flags[idx] |= F_SIG
                                self._update_neighbors(flags, x, y, idx)
                            flags[idx] &= ~F_VISIT
                        continue
                for y in range(k, min(k + 4, h)):
                    idx = (y + 1) * pw + x + 1
                    f = int(flags[idx])
                    if f & (F_VISIT | F_SIG):
                        flags[idx] &= ~F_VISIT
                        continue
                    sig = mqd.decode(int(zc[_zc_index(
                        _ctx_flags(f, y, vsc))]))
                    if sig:
                        si = _sc_index(_ctx_flags(f, y, vsc))
                        sign = mqd.decode(int(SC_LUT[si])) ^ int(SPB_LUT[si])
                        if sign:
                            flags[idx] |= F_SIGN
                        d[idx] = self._recon_sig(bp, sign)
                        flags[idx] |= F_SIG
                        self._update_neighbors(flags, x, y, idx)
                    flags[idx] &= ~F_VISIT

    _update_neighbors = T1Encoder._update_neighbors
