"""HT SigProp / MagRef refinement passes (ITU-T T.814 §7.3-7.5, B.2-B.3).

Beyond the reference: its HT block coder is cleanup-pass-only
(reference jpeg2000/htj2k/encoder.go:55-68), so foreign quality-scalable
HTJ2K streams whose code-blocks carry SigProp/MagRef passes lose those
passes. This module implements both directions:

- decode: apply an HT refinement segment (Dref) to cleanup-decoded
  coefficients, per the decodeSigPropMag/decodeSigPropSign (§7.4) and
  decodeMagRefValue (§7.5) procedures with the importSigPropBit /
  importMagRefBit bit-recovery state machines (§7.1.5-7.1.6).
- encode: produce the refinement segment with the emitSPBit/emitMRBit
  packers and the termSPPacker / termSPandMRPackers-compatible
  termination (Annex F.5; we terminate the SigProp stream standalone
  and append the reversed MagRef stream, which the spec explicitly
  allows — it keeps every truncation of the pass sequence a byte
  prefix, so PCRD layer splits need no re-termination).

Pass semantics (one HT set, Z_blk ≤ 3), per the T.800 pass
equivalence the spec states (§6.1: MagRef/SigProp are T.800's passes
in bypass mode with little-endian packing):
- The HT cleanup pass codes u = sign·(|v| >> 1); the packet header
  signals numbps=2 (S_blk = Mb-2) so the cleanup payload sits one
  plane up and the §7.6 refinement plane MSB_{S_blk+2} is plane 0
  (verified against OpenJPEG, which scales the cleanup magnitudes by
  the signalled zero-bit-planes).  SigProp then codes the plane-0 bit
  of samples insignificant after cleanup (u == 0, i.e. |v| ≤ 1) that
  have a significant or scan-causal newly-significant neighbour,
  followed by sign bits per column-group of four stripe columns;
  MagRef codes the plane-0 bit of every cleanup-significant sample.
- Samples with |v| == 1 and no eligible neighbour are NOT representable
  by a refinement pass (they belong to the next cleanup pass, which an
  HT set does not have); encode_refinement reports them so the caller
  can fall back to a full-precision cleanup-only encode (Z_blk = 1)
  and keep lossless exactness.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..errors import CorruptStreamError


class SigPropPacker:
    """emitSPBit / termSPPacker (T.814 F.5): LSB-first bits, a byte
    following an emitted 0xFF carries only 7 bits (MSB stuff = 0)."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.bits = 0
        self.max = 8
        self.tmp = 0

    def emit(self, bit: int) -> None:
        self.tmp |= (bit & 1) << self.bits
        self.bits += 1
        if self.bits == self.max:
            self.buf.append(self.tmp)
            self.max = 7 if self.tmp == 0xFF else 8
            self.tmp = 0
            self.bits = 0

    def terminate(self, followed_by_magref: bool = False) -> bytes:
        """Close the byte-stream. Standalone (Z=2) termination may drop
        an all-zero partial byte — the importSigPropBit reader
        synthesizes 0 bytes beyond Lref. When the reversed MagRef
        stream follows in the same segment, the partial byte MUST be
        flushed (the reader would otherwise consume a MagRef byte),
        and a 0xFF tail takes a 0x00 pad so no wire pair can form a
        false marker (termSPandMRPackers' fuse step is an optional
        byte-saving optimization we do not take)."""
        if self.bits and (self.tmp != 0 or followed_by_magref):
            self.buf.append(self.tmp)
        if self.buf and self.buf[-1] == 0xFF:
            self.buf.append(0x00)  # prevent a terminal FF
        return bytes(self.buf)


class MagRefPacker:
    """emitMRBit (T.814 F.5): LSB-first bits with the reverse-growth
    stuffing rule — when the previously flushed byte exceeds 0x8F and
    the 7 accumulated bits equal 0x7F, an extra (zero) bit pads the
    byte so its MSB stays 0. The byte-stream is emitted REVERSED into
    the refinement segment (it grows backwards from the segment end)."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.bits = 0
        self.tmp = 0
        self.last = 255

    def emit(self, bit: int) -> None:
        self.tmp |= (bit & 1) << self.bits
        self.bits += 1
        if self.last > 0x8F and self.tmp == 0x7F and self.bits == 7:
            self.bits += 1          # stuff: MSB stays 0
        if self.bits == 8:
            self.buf.append(self.tmp)
            self.last = self.tmp
            self.tmp = 0
            self.bits = 0

    def terminate(self) -> bytes:
        if self.bits:
            self.buf.append(self.tmp)
        return bytes(self.buf[::-1])


class SigPropReader:
    """importSigPropBit (§7.1.5): forward over Dref, 7 bits after an
    0xFF byte (the stuff bit must be 0), bytes beyond Lref read as 0."""

    def __init__(self, dref: bytes) -> None:
        self.d = dref
        self.pos = 0
        self.bits = 0
        self.tmp = 0
        self.last = 0

    def read(self) -> int:
        if self.bits == 0:
            self.bits = 7 if self.last == 0xFF else 8
            if self.pos < len(self.d):
                self.tmp = self.d[self.pos]
                self.pos += 1
                if self.tmp & (1 << self.bits):
                    raise CorruptStreamError("HT SigProp stuff bit set")
            else:
                self.tmp = 0
            self.last = self.tmp
        bit = self.tmp & 1
        self.tmp >>= 1
        self.bits -= 1
        return bit


class MagRefReader:
    """importMagRefBit (§7.1.6): backward from Dref[-1]; MR_last starts
    0xFF so the final byte's MSB is skipped when its 7 LSBs are all 1;
    bytes before the segment start read as 0."""

    def __init__(self, dref: bytes) -> None:
        self.d = dref
        self.pos = len(dref) - 1
        self.bits = 0
        self.tmp = 0
        self.last = 0xFF

    def read(self) -> int:
        if self.bits == 0:
            self.tmp = self.d[self.pos] if self.pos >= 0 else 0
            self.pos -= 1
            self.bits = 8
            if self.last > 0x8F and (self.tmp & 0x7F) == 0x7F:
                self.bits = 7
            self.last = self.tmp
        bit = self.tmp & 1
        self.tmp >>= 1
        self.bits -= 1
        return bit


def _sigprop_scan(sig: np.ndarray, causal: bool, on_mag, on_sign) -> None:
    """Drive the §7.4 stripe scan once, for either direction.

    sig: [h, w] bool, cleanup significance. on_mag(y, x) is called for
    every eligible sample (σ=0, mbr≠0) in scan order and returns the
    refinement bit r (decode: read it; encode: supply it); newly
    significant samples propagate through the scan-causal neighbourhood.
    on_sign(y, x) is called for each r=1 sample per column-group.
    """
    h, w = sig.shape
    # σ | r as one evolving map: r_m of samples later in the scan is
    # still 0 when sample n is processed, so OR-ing the current map
    # over the (possibly causal) propagation neighbourhood equals the
    # spec's σ-over-N_n | r-over-scan-causal-Ñ_n exactly.
    reach = sig.copy()
    for y0 in range(0, h, 4):
        sh = min(4, h - y0)
        for x0 in range(0, w, 4):
            gw = min(4, w - x0)
            group_new = []
            for dx in range(gw):
                x = x0 + dx
                for j in range(sh):
                    y = y0 + j
                    if sig[y, x]:
                        continue
                    # propagation neighbourhood: the 8 neighbours;
                    # causal mode excludes the row below the stripe
                    ylo = max(y - 1, 0)
                    yhi = y + 2 if (j < sh - 1 or not causal) else y + 1
                    yhi = min(yhi, h)
                    xlo, xhi = max(x - 1, 0), min(x + 2, w)
                    if not reach[ylo:yhi, xlo:xhi].any():
                        continue
                    r = on_mag(y, x)
                    if r:
                        reach[y, x] = True
                        group_new.append((y, x))
            for (y, x) in group_new:
                on_sign(y, x)


def encode_refinement(v: np.ndarray, causal: bool
                      ) -> Tuple[bytes, int, bool, int, int]:
    """Encode SigProp + MagRef for block values v (signed ints; the
    cleanup pass carries the even part w = sign(v)·(|v| & ~1)).

    Returns (dref, sigprop_len, exact, n_new_sig, n_magref_improved):
    dref = terminated SigProp bytes + reversed MagRef bytes;
    sigprop_len = byte length of the terminated SigProp prefix (the
    2-pass truncation point); exact = False when some |v|==1 sample was
    not eligible for SigProp (a Z=3 encode of this block would lose
    it); n_new_sig / n_magref_improved feed PCRD distortion deltas.
    """
    av = np.abs(v.astype(np.int64))
    sig = (av >> 1) > 0
    lsb = (av & 1).astype(np.int64)
    sp = SigPropPacker()
    covered = np.zeros_like(sig)
    n_new = 0

    def on_mag(y, x):
        covered[y, x] = True
        r = int(lsb[y, x])
        sp.emit(r)
        return r

    def on_sign(y, x):
        nonlocal n_new
        n_new += 1
        sp.emit(1 if v[y, x] < 0 else 0)

    _sigprop_scan(sig, causal, on_mag, on_sign)
    exact = not bool((~covered & ~sig & (lsb > 0)).any())
    sp_bytes = sp.terminate(followed_by_magref=bool(sig.any()))

    mr = MagRefPacker()
    n_ref = 0
    h, w = sig.shape
    for y0 in range(0, h, 4):
        sh = min(4, h - y0)
        for x in range(w):
            for j in range(sh):
                y = y0 + j
                if sig[y, x]:
                    mr.emit(int(lsb[y, x]))
                    if lsb[y, x] == 0:
                        n_ref += 1
    return (sp_bytes + mr.terminate(), len(sp_bytes), exact, n_new,
            n_ref)


def apply_refinement(w: np.ndarray, dref: bytes, zblk: int,
                     causal: bool) -> np.ndarray:
    """Apply a decoded HT refinement segment to cleanup output w.

    w is the cleanup decoder's output at the Z≥2 signalling (numbps=2,
    S_blk = Mb-2): magnitudes 2u+1 for significant samples — the
    plane-0 midpoint half-bit is already present. Returns the refined
    block:

    - σ=1 with MagRef (zblk==3): |v| = (|w| & ~1) | r, sign(w)
    - σ=1 without MagRef:        |v| = |w|  (the built-in midpoint,
      matching T.800 Annex E half-bit reconstruction)
    - σ=0, eligible, r=1:        |v| = 1, sign from the stream
    - otherwise 0.
    """
    sig = w != 0
    out = np.abs(w.astype(np.int64))
    neg = w < 0
    spr = SigPropReader(dref)

    def on_mag(y, x):
        return spr.read()

    def on_sign(y, x):
        if spr.read():
            neg[y, x] = True
        out[y, x] = 1

    _sigprop_scan(sig, causal, on_mag, on_sign)

    if zblk >= 3:
        mrr = MagRefReader(dref)
        h, w = sig.shape
        for y0 in range(0, h, 4):
            sh = min(4, h - y0)
            for x in range(w):
                for j in range(sh):
                    y = y0 + j
                    if sig[y, x]:
                        out[y, x] = (out[y, x] & ~np.int64(1)) | mrr.read()
    return np.where(neg, -out, out)
