"""JPEG-LS codecs (ITU-T T.87 / ISO 14495-1) — UIDs .4.80 / .4.81.

Role of reference jpegls/{lossless,nearlossless}/: LOCO-I MED prediction,
365-context gradient modeling with bias correction, limited Golomb-Rice
coding, run mode with the J[] run-index table, CharLS-compatible traits
(RANGE/qbpp/LIMIT/T1-T3/RESET), NEAR>0 quantized errors with the
|recon−orig|≤NEAR bound, LSE coding-parameter marker, SOF55/SOS framing.

Layout: grayscale encodes a single-component scan; RGB encodes a
sample-interleaved (ILV=2) scan (reference jpegls/lossless/encoder.go:
142-188). The scan is an adaptive per-pixel feedback loop — host-side by
design (SURVEY.md §2.5); the wavefront device kernels come later.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import uids
from ..codestream import jpeg_markers as mk
from ..entropy.golomb import GolombReader, GolombWriter
from ..errors import CorruptStreamError, UnsupportedFormatError
from ..frames import FrameInfo, PixelData, frame_to_array
from ..params import Parameters, require_range
from ..registry import Codec, get_global_registry

# J run-index table (T.87 A.2.1; reference jpegls/runmode/runmode.go:7-10)
J = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
     4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15)

MAX_C, MIN_C = 127, -128


def _log2_ceil(n: int) -> int:
    if n <= 1:
        return 1
    return (n - 1).bit_length()


@dataclass
class Traits:
    """Derived coding parameters (reference traits.go / context.go:184-254)."""
    maxval: int
    near: int
    reset: int = 64
    t1: int = 0
    t2: int = 0
    t3: int = 0

    def __post_init__(self):
        mv, near = self.maxval, self.near
        self.range = (mv + 1) if near == 0 else (mv + 2 * near) // (2 * near + 1) + 1
        self.qbpp = _log2_ceil(self.range)
        bpp = _log2_ceil(mv)
        self.limit = 2 * (bpp + max(8, bpp))
        if not self.t1:
            self.t1, self.t2, self.t3 = self._default_thresholds(mv, near)

    @staticmethod
    def _default_thresholds(maxval: int, near: int) -> Tuple[int, int, int]:
        clamp = lambda v, lo, hi: max(lo, min(v, hi))
        if maxval >= 128:
            f = (min(maxval, 4095) + 128) // 256
            t1 = clamp(f * (3 - 2) + 2 + 3 * near, near + 1, maxval)
            t2 = clamp(f * (7 - 3) + 3 + 5 * near, t1, maxval)
            t3 = clamp(f * (21 - 4) + 4 + 7 * near, t2, maxval)
        else:
            f = 256 // (maxval + 1)
            t1 = clamp(max(2, 3 // f + 3 * near), near + 1, maxval)
            t2 = clamp(max(3, 7 // f + 5 * near), t1, maxval)
            t3 = clamp(max(4, 21 // f + 7 * near), t2, maxval)
        return t1, t2, t3

    # -- error transforms (traits.go) ------------------------------------
    def quantize(self, e: int) -> int:
        if self.near == 0:
            return e
        if e > 0:
            return (e + self.near) // (2 * self.near + 1)
        # CharLS/Go divide with truncation toward zero: -(near - e) / d.
        # (near - e) is positive here, so negate its exact floor quotient.
        return -((self.near - e) // (2 * self.near + 1))

    def dequantize(self, e: int) -> int:
        return e * (2 * self.near + 1)

    def modulo_range(self, e: int) -> int:
        if e < 0:
            e += self.range
        if e >= (self.range + 1) // 2:
            e -= self.range
        return e

    def compute_error(self, e: int) -> int:
        return self.modulo_range(self.quantize(e))

    def correct_prediction(self, p: int) -> int:
        return 0 if p < 0 else (self.maxval if p > self.maxval else p)

    def fix_reconstructed(self, v: int) -> int:
        if self.near == 0 and (self.maxval + 1) & self.maxval == 0:
            return v & self.maxval
        if v < -self.near:
            v += self.range * (2 * self.near + 1)
        elif v > self.maxval + self.near:
            v -= self.range * (2 * self.near + 1)
        return self.correct_prediction(v)

    def reconstruct(self, pred: int, err: int) -> int:
        return self.fix_reconstructed(pred + self.dequantize(err))

    def quantize_gradient(self, d: int) -> int:
        if d <= -self.t3:
            return -4
        if d <= -self.t2:
            return -3
        if d <= -self.t1:
            return -2
        if d < -self.near:
            return -1
        if d <= self.near:
            return 0
        if d < self.t1:
            return 1
        if d < self.t2:
            return 2
        if d < self.t3:
            return 3
        return 4

    def is_near(self, a: int, b: int) -> bool:
        return abs(a - b) <= self.near


def _map_error(e: int) -> int:
    return (e << 1) ^ (e >> 63) if e < 0 else e << 1


def _unmap_error(v: int) -> int:
    return (v >> 1) ^ (-(v & 1))


def _apply_sign(i: int, sign: int) -> int:
    return (sign ^ i) - sign


class _Ctx:
    """Regular-mode context (reference context.go:5-113)."""
    __slots__ = ("a", "b", "c", "n")

    def __init__(self, range_val: int):
        self.a = max(2, (range_val + 32) // 64)
        self.b = 0
        self.c = 0
        self.n = 1

    def golomb_k(self) -> int:
        k = 0
        while (self.n << k) < self.a and k < 16:
            k += 1
        return k

    def error_correction(self, k: int, near: int) -> int:
        if k != 0 or near != 0:
            return 0
        return -1 if 2 * self.b + self.n - 1 < 0 else 0

    def update(self, err: int, near: int, reset: int) -> None:
        self.a += abs(err)
        self.b += err * (2 * near + 1)
        lim = 65536 * 256
        if self.a >= lim:
            self.a = lim - 1
        if self.b >= lim:
            self.b = lim - 1
        elif self.b <= -lim:
            self.b = -lim + 1
        if self.n == reset:
            self.a >>= 1
            self.b >>= 1  # arithmetic shift, matches Go (context.go:63-66)
            self.n >>= 1
        self.n += 1
        if self.b + self.n <= 0:
            self.b += self.n
            if self.b <= -self.n:
                self.b = -self.n + 1
            if self.c > MIN_C:
                self.c -= 1
        elif self.b > 0:
            self.b -= self.n
            if self.b > 0:
                self.b = 0
            if self.c < MAX_C:
                self.c += 1


class _RunCtx:
    """Run-interruption context (reference runmode.go:12-84)."""
    __slots__ = ("rtype", "a", "n", "nn")

    def __init__(self, rtype: int, range_val: int):
        self.rtype = rtype
        self.a = max(2, (range_val + 32) // 64)
        self.n = 1
        self.nn = 0

    def golomb_k(self) -> int:
        temp = self.a + (self.n >> 1) * self.rtype
        ntest = self.n
        k = 0
        while ntest < temp:
            ntest <<= 1
            k += 1
            if k > 32:
                break
        return k

    def compute_map(self, err: int, k: int) -> bool:
        if k == 0 and err > 0 and 2 * self.nn < self.n:
            return True
        if err < 0 and 2 * self.nn >= self.n:
            return True
        if err < 0 and k != 0:
            return True
        return False

    def error_from_mapped(self, temp: int, k: int) -> int:
        map_bit = temp & 1
        err_abs = (temp + map_bit) // 2
        cond = (k != 0) or (2 * self.nn >= self.n)
        if cond == (map_bit != 0):
            return -err_abs
        return err_abs

    def update(self, err: int, emapped: int, reset: int) -> None:
        if err < 0:
            self.nn += 1
        self.a += (emapped + 1 - self.rtype) >> 1
        if self.n == reset:
            self.a >>= 1
            self.n >>= 1
            self.nn >>= 1
        self.n += 1


class _Scan:
    """Shared scan state for encode/decode (mirrors CharLS scan.h)."""

    def __init__(self, traits: Traits):
        self.t = traits
        self.ctx = [_Ctx(traits.range) for _ in range(365)]
        self.rctx = [_RunCtx(0, traits.range), _RunCtx(1, traits.range)]
        self.run_index = 0

    def inc_run(self):
        if self.run_index < 31:
            self.run_index += 1

    def dec_run(self):
        if self.run_index > 0:
            self.run_index -= 1

    def context_id(self, ra, rb, rc, rd) -> int:
        t = self.t
        q1 = t.quantize_gradient(rd - rb)
        q2 = t.quantize_gradient(rb - rc)
        q3 = t.quantize_gradient(rc - ra)
        return (q1 * 9 + q2) * 9 + q3

    @staticmethod
    def predict(a, b, c) -> int:
        if c >= max(a, b):
            return min(a, b)
        if c <= min(a, b):
            return max(a, b)
        return a + b - c

    # -- regular mode -----------------------------------------------------
    def encode_regular(self, gw: GolombWriter, x: int, qs: int,
                       ra: int, rb: int, rc: int) -> int:
        t = self.t
        sign = -1 if qs < 0 else 0
        ctx = self.ctx[_apply_sign(qs, sign)]
        k = ctx.golomb_k()
        pred = t.correct_prediction(self.predict(ra, rb, rc)
                                    + _apply_sign(ctx.c, sign))
        err = t.compute_error(_apply_sign(x - pred, sign))
        mapped = _map_error(ctx.error_correction(k, t.near) ^ err)
        gw.encode_mapped(k, mapped, t.limit, t.qbpp)
        ctx.update(err, t.near, t.reset)
        return t.reconstruct(pred, _apply_sign(err, sign))

    def decode_regular(self, gr: GolombReader, qs: int,
                       ra: int, rb: int, rc: int) -> int:
        t = self.t
        sign = -1 if qs < 0 else 0
        ctx = self.ctx[_apply_sign(qs, sign)]
        k = ctx.golomb_k()
        pred = t.correct_prediction(self.predict(ra, rb, rc)
                                    + _apply_sign(ctx.c, sign))
        mapped = gr.decode_value(k, t.limit, t.qbpp)
        err = ctx.error_correction(k, t.near) ^ _unmap_error(mapped)
        ctx.update(err, t.near, t.reset)
        return t.reconstruct(pred, _apply_sign(err, sign))

    # -- run mode ---------------------------------------------------------
    def encode_run_length(self, gw: GolombWriter, run: int,
                          end_of_line: bool) -> None:
        while run >= (1 << J[self.run_index]):
            gw.write_bit(1)
            run -= 1 << J[self.run_index]
            self.inc_run()
        if end_of_line:
            if run != 0:
                gw.write_bit(1)
            return
        gw.write_bits(run, J[self.run_index] + 1)

    def decode_run_length(self, gr: GolombReader, remaining: int) -> int:
        run = 0
        while True:
            bit = gr.read_bit()
            if bit == 1:
                cnt = min(1 << J[self.run_index], remaining - run)
                run += cnt
                if cnt == (1 << J[self.run_index]):
                    self.inc_run()
                if run >= remaining:
                    return remaining
            else:
                break
        if J[self.run_index] > 0:
            run += gr.read_bits(J[self.run_index])
        if run > remaining:
            raise CorruptStreamError("run length exceeds line")
        return run

    def encode_run_interruption(self, gw: GolombWriter, rctx: _RunCtx,
                                err: int) -> None:
        t = self.t
        k = rctx.golomb_k()
        map_bit = rctx.compute_map(err, k)
        emapped = 2 * abs(err) - rctx.rtype - (1 if map_bit else 0)
        gw.encode_mapped(k, emapped, t.limit - J[self.run_index] - 1, t.qbpp)
        rctx.update(err, emapped, t.reset)

    def decode_run_interruption(self, gr: GolombReader, rctx: _RunCtx) -> int:
        t = self.t
        k = rctx.golomb_k()
        mapped = gr.decode_value(k, t.limit - J[self.run_index] - 1, t.qbpp)
        err = rctx.error_from_mapped(mapped + rctx.rtype, k)
        rctx.update(err, mapped, t.reset)
        return err


def _sign(n: int) -> int:
    return -1 if n < 0 else 1


# ---- single-component scan (reference encoder.go:330-447, decoder mirror) --

def _code_one_line(scan: _Scan, gio, row, above, prev_first: int,
                   prev_prev_first: int, encode: bool) -> None:
    """One line of one component (the T.87 main loop). `above` is the
    same component's previous reconstructed line (None on line 0);
    prev_first/prev_prev_first are that component's first samples of
    the previous two lines. Mutates `row` in place."""
    t = scan.t
    w = row.shape[0]
    has_above = above is not None
    x = 0
    while x < w:
        if x == 0:
            ra = prev_first
            rb = prev_first if has_above else 0
            rc = prev_prev_first
            rd = int(above[1]) if (has_above and w > 1) else rb
        else:
            ra = int(row[x - 1])
            rb = int(above[x]) if has_above else 0
            rc = int(above[x - 1]) if has_above else 0
            rd = (int(above[min(x + 1, w - 1)]) if has_above else rb)
        qs = scan.context_id(ra, rb, rc, rd)
        if qs != 0:
            if encode:
                row[x] = scan.encode_regular(gio, int(row[x]), qs,
                                             ra, rb, rc)
            else:
                row[x] = scan.decode_regular(gio, qs, ra, rb, rc)
            x += 1
            continue
        # run mode
        remaining = w - x
        if encode:
            run = 0
            while run < remaining and t.is_near(int(row[x + run]), ra):
                row[x + run] = ra
                run += 1
            scan.encode_run_length(gio, run, run == remaining)
            if run == remaining:
                x += run
                break
            xi = int(row[x + run])
            rb2 = int(above[x + run]) if has_above else 0
            if t.is_near(ra, rb2):
                err = t.compute_error(xi - ra)
                scan.encode_run_interruption(gio, scan.rctx[1], err)
                row[x + run] = t.reconstruct(ra, err)
            else:
                s = _sign(rb2 - ra)
                err = t.compute_error((xi - rb2) * s)
                scan.encode_run_interruption(gio, scan.rctx[0], err)
                row[x + run] = t.reconstruct(rb2, err * s)
            scan.dec_run()
            x += run + 1
        else:
            run = scan.decode_run_length(gio, remaining)
            row[x : x + run] = ra
            if run >= remaining:
                x += run
                break
            rb2 = int(above[x + run]) if has_above else 0
            if t.is_near(ra, rb2):
                err = scan.decode_run_interruption(gio, scan.rctx[1])
                err = t.modulo_range(err)
                row[x + run] = t.reconstruct(ra, err)
            else:
                err = scan.decode_run_interruption(gio, scan.rctx[0])
                err = t.modulo_range(err * _sign(rb2 - ra))
                row[x + run] = t.reconstruct(rb2, err)
            scan.dec_run()
            x += run + 1


def _code_component(scan: _Scan, gio, plane: np.ndarray, encode: bool):
    h, w = plane.shape
    prev_first = 0
    prev_prev_first = 0
    for y in range(h):
        _code_one_line(scan, gio, plane[y],
                       plane[y - 1] if y > 0 else None,
                       prev_first, prev_prev_first, encode)
        prev_prev_first = prev_first
        prev_first = int(plane[y, 0])


def _code_line_interleaved(scan: _Scan, gio, img: np.ndarray,
                           encode: bool):
    """ILV=1 (T.87 line interleaved): each line is coded per component
    in component order. One shared set of context counters (the scan),
    but RUNindex is maintained separately per component (T.87 A.2.1 /
    CharLS run_index save-restore)."""
    h, w, ncomp = img.shape
    prev_first = [0] * ncomp
    prev_prev_first = [0] * ncomp
    run_index = [0] * ncomp
    for y in range(h):
        for c in range(ncomp):
            plane = img[:, :, c]
            scan.run_index = run_index[c]
            _code_one_line(scan, gio, plane[y],
                           plane[y - 1] if y > 0 else None,
                           prev_first[c], prev_prev_first[c], encode)
            run_index[c] = scan.run_index
            prev_prev_first[c] = prev_first[c]
            prev_first[c] = int(plane[y, 0])


# ---- sample-interleaved scan (ILV=2; reference encoder.go:190-296) ---------

def _code_interleaved(scan: _Scan, gio, img: np.ndarray, encode: bool):
    t = scan.t
    h, w, ncomp = img.shape
    prev_first = [0] * ncomp
    prev_prev_first = [0] * ncomp

    def neighbors(x, y, comp):
        if x == 0:
            ra = prev_first[comp]
            rb = prev_first[comp] if y > 0 else 0
            rc = prev_prev_first[comp]
            rd = int(img[y - 1, 1, comp]) if (y > 0 and w > 1) else rb
            return ra, rb, rc, rd
        ra = int(img[y, x - 1, comp])
        rb = int(img[y - 1, x, comp]) if y > 0 else 0
        rc = int(img[y - 1, x - 1, comp]) if y > 0 else 0
        rd = int(img[y - 1, min(x + 1, w - 1), comp]) if y > 0 else rb
        return ra, rb, rc, rd

    for y in range(h):
        x = 0
        while x < w:
            nb = [neighbors(x, y, c) for c in range(ncomp)]
            qss = [scan.context_id(*nb[c]) for c in range(ncomp)]
            if any(q != 0 for q in qss):
                for c in range(ncomp):
                    ra, rb, rc, _ = nb[c]
                    if encode:
                        img[y, x, c] = scan.encode_regular(
                            gio, int(img[y, x, c]), qss[c], ra, rb, rc)
                    else:
                        img[y, x, c] = scan.decode_regular(
                            gio, qss[c], ra, rb, rc)
                x += 1
                continue
            remaining = w - x
            if encode:
                run = 0
                while run < remaining:
                    ok = True
                    for c in range(ncomp):
                        left = neighbors(x + run, y, c)[0]
                        if not t.is_near(int(img[y, x + run, c]), left):
                            ok = False
                            break
                    if not ok:
                        break
                    for c in range(ncomp):
                        left = neighbors(x + run, y, c)[0]
                        img[y, x + run, c] = left
                    run += 1
                scan.encode_run_length(gio, run, run == remaining)
                if run == remaining:
                    x += run
                    break
                for c in range(ncomp):
                    left, above, _, _ = neighbors(x + run, y, c)
                    xi = int(img[y, x + run, c])
                    s = _sign(above - left)
                    err = t.compute_error(s * (xi - above))
                    scan.encode_run_interruption(gio, scan.rctx[0], err)
                    img[y, x + run, c] = t.reconstruct(above, err * s)
                scan.dec_run()
                x += run + 1
            else:
                run = scan.decode_run_length(gio, remaining)
                for i in range(run):
                    for c in range(ncomp):
                        img[y, x + i, c] = neighbors(x + i, y, c)[0]
                if run >= remaining:
                    x += run
                    break
                for c in range(ncomp):
                    left, above, _, _ = neighbors(x + run, y, c)
                    s = _sign(above - left)
                    err = scan.decode_run_interruption(gio, scan.rctx[0])
                    err = t.modulo_range(err * s)
                    img[y, x + run, c] = t.reconstruct(above, err)
                scan.dec_run()
                x += run + 1
        for c in range(ncomp):
            prev_prev_first[c] = prev_first[c]
            prev_first[c] = int(img[y, 0, c])


# ---- byte-level API ---------------------------------------------------------

def encode(pixels: bytes, width: int, height: int, components: int,
           bit_depth: int, near: int = 0,
           ilv: Optional[int] = None) -> bytes:
    """Encode a frame (reference jpegls/lossless/encoder.go:46-188).

    ilv: T.87 interleave mode for multi-component frames — 2 (sample,
    the default and the reference's only mode), 1 (line interleaved),
    or 0 (one scan per component). The decoder reads all three."""
    if width <= 0 or height <= 0:
        raise UnsupportedFormatError("invalid dimensions")
    if components not in (1, 3):
        raise UnsupportedFormatError("components must be 1 or 3")
    if not (2 <= bit_depth <= 16):
        raise UnsupportedFormatError("bit depth out of [2, 16]")
    if near < 0 or near > min(255, (1 << bit_depth) - 1) // 2:
        raise UnsupportedFormatError(f"invalid NEAR {near}")
    if ilv is None:
        ilv = 2 if components > 1 else 0
    if components == 1:
        ilv = 0
    if ilv not in (0, 1, 2):
        raise UnsupportedFormatError(f"invalid ILV {ilv}")

    dt = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
    arr = np.frombuffer(pixels, dtype=dt, count=width * height * components)
    # astype already yields a fresh mutable buffer (the scan coders
    # write NEAR reconstructions into it) — no extra copy needed
    img = arr.reshape(height, width, components).astype(np.int64)

    maxval = (1 << bit_depth) - 1
    traits = Traits(maxval=maxval, near=near)

    def _plane_bytes(plane3, mode=2):
        from ..native import jls_encode_scan_native
        sb = jls_encode_scan_native(plane3, maxval, near, traits.reset,
                                    traits.t1, traits.t2, traits.t3,
                                    ilv=mode)
        if sb is None:
            scan = _Scan(traits)
            gw = GolombWriter()
            if plane3.shape[2] == 1:
                _code_component(scan, gw, plane3[:, :, 0], encode=True)
            elif mode == 1:
                _code_line_interleaved(scan, gw, plane3, encode=True)
            else:
                _code_interleaved(scan, gw, plane3, encode=True)
            sb = gw.finish()
        return sb

    if ilv == 0 and components > 1:
        # one scan per component, each with fresh coder state
        scans = [_plane_bytes(np.ascontiguousarray(img[:, :, c:c + 1]))
                 for c in range(components)]
    else:
        scans = [_plane_bytes(img, mode=ilv)]

    w = mk.JpegWriter()
    w.write_marker(mk.SOI)
    sof = bytearray([bit_depth, height >> 8, height & 0xFF,
                     width >> 8, width & 0xFF, components])
    for i in range(components):
        sof += bytes([i + 1, 0x11, 0])
    w.write_segment(mk.SOF55, bytes(sof))
    if near > 0:
        # LSE ID 1: MAXVAL, T1, T2, T3, RESET (T.87 C.2.4.1.1)
        lse = bytearray([1])
        for v in (maxval, traits.t1, traits.t2, traits.t3, traits.reset):
            lse += bytes([(v >> 8) & 0xFF, v & 0xFF])
        w.write_segment(mk.LSE, bytes(lse))
    if len(scans) > 1:  # ILV=0: one SOS + scan per component
        for i, sb in enumerate(scans):
            sos = bytearray([1, i + 1, 0, near, 0, 0])
            w.write_segment(mk.SOS, bytes(sos))
            w.write_bytes(sb)
    else:
        sos = bytearray([components])
        for i in range(components):
            sos += bytes([i + 1, 0])
        sos += bytes([near, ilv if components > 1 else 0, 0])
        w.write_segment(mk.SOS, bytes(sos))
        w.write_bytes(scans[0])
    w.write_marker(mk.EOI)
    return w.get_bytes()


def decode(data: bytes):
    """Decode → (pixels, width, height, components, bit_depth, near)."""
    r = mk.JpegReader(data)
    if r.read_marker() != mk.SOI:
        raise CorruptStreamError("missing SOI")
    frame = None
    lse = None
    near = 0
    ilv = 0
    comp_ids: List[int] = []
    scans: List[Tuple[List[int], bytes]] = []  # (component ids, bytes)
    while True:
        marker = r.read_marker()
        if marker == mk.SOF55:
            p = r.read_segment()
            if len(p) < 6:
                raise CorruptStreamError("truncated SOF55 header")
            depth = p[0]
            h = (p[1] << 8) | p[2]
            w = (p[3] << 8) | p[4]
            nc = p[5]
            if w < 1 or h < 1 or nc < 1 or not (2 <= depth <= 16):
                raise CorruptStreamError("invalid SOF55 dimensions")
            frame = (depth, w, h, nc)
            comp_ids = [p[6 + 3 * i] for i in range(nc)
                        if 6 + 3 * i < len(p)]
        elif marker == mk.LSE:
            p = r.read_segment()
            if p and p[0] == 1 and len(p) >= 11:
                vals = [(p[i] << 8) | p[i + 1] for i in range(1, 11, 2)]
                lse = vals  # MAXVAL, T1, T2, T3, RESET
        elif marker == mk.SOS:
            p = r.read_segment()
            if len(p) < 1 or len(p) < 3 + p[0] * 2:
                raise CorruptStreamError("truncated JPEG-LS SOS header")
            ns = p[0]
            near = p[1 + ns * 2]
            ilv = p[2 + ns * 2]
            cs_ids = [p[1 + 2 * i] for i in range(ns)]
            scan_bytes, _ = r.find_scan_end(ls_mode=True)
            scans.append((cs_ids, scan_bytes))
            if frame is None:
                raise CorruptStreamError("SOS before SOF55")
            # ILV=0 multi-component streams carry one scan per
            # component — keep reading until all are covered
            if sum(len(ids) for ids, _ in scans) >= frame[3]:
                break
        elif marker == mk.EOI:
            if scans:
                break  # fewer scans than components: decode what's there
            raise CorruptStreamError("EOI before scan")
        elif marker in (mk.SOF0, mk.SOF1, mk.SOF3):
            raise UnsupportedFormatError("not a JPEG-LS stream")
        else:
            if mk.has_length(marker):
                r.read_segment()

    if frame is None:
        raise CorruptStreamError("missing SOF55")
    depth, w, h, nc = frame
    maxval = (1 << depth) - 1
    if lse:
        maxval = lse[0]
        traits = Traits(maxval=maxval, near=near, reset=lse[4],
                        t1=lse[1], t2=lse[2], t3=lse[3])
    else:
        traits = Traits(maxval=maxval, near=near)
    if ilv not in (0, 1, 2):
        raise UnsupportedFormatError(f"invalid JPEG-LS ILV {ilv}")

    from ..native import jls_decode_scan_native

    def _decode_scan(scan_bytes, ncs, mode):
        out = jls_decode_scan_native(scan_bytes, w, h, ncs, traits.maxval,
                                     near, traits.reset, traits.t1,
                                     traits.t2, traits.t3, mode)
        if out is None:
            out = np.zeros((h, w, ncs), dtype=np.int64)
            gr = GolombReader(scan_bytes)
            if ncs == 1:
                _code_component(_Scan(traits), gr, out[:, :, 0],
                                encode=False)
            elif mode == 1:
                _code_line_interleaved(_Scan(traits), gr, out,
                                       encode=False)
            elif mode == 0:
                # non-conformant Ns>1 ILV=0 single scan: planar
                # components in sequence, fresh coder state each
                # (matches the native jls_decode_scan dispatch)
                for c in range(ncs):
                    _code_component(_Scan(traits), gr, out[:, :, c],
                                    encode=False)
            else:
                _code_interleaved(_Scan(traits), gr, out, encode=False)
        return out

    if len(scans) > 1 or (nc > 1 and len(scans[0][0]) == 1):
        # ILV=0: independent per-component scans (fresh coder state
        # each); scans map to planes by the SOF55 component-id list
        # (ids need not be 1-based — CharLS writes whatever the SOF
        # declares), falling back to arrival order for unknown ids
        img = np.zeros((h, w, nc), dtype=np.int64)
        id_to_plane = {cid: idx for idx, cid in enumerate(comp_ids)}
        for i, (ids, sb) in enumerate(scans):
            c = id_to_plane.get(ids[0], i)
            img[:, :, min(c, nc - 1)] = _decode_scan(sb, 1, 0)[:, :, 0]
    else:
        img = _decode_scan(scans[0][1], nc, ilv if nc > 1 else 0)

    dt = np.uint8 if depth <= 8 else np.dtype("<u2")
    return (np.ascontiguousarray(img.astype(dt)).tobytes(), w, h, nc,
            depth, near)


# ---- DICOM adapters ---------------------------------------------------------

class JPEGLSParameters(Parameters):
    """Reference jpegls/nearlossless/parameters.go:36-71."""

    def __init__(self, near: int = 0, **kw):
        super().__init__(near=near, **kw)

    @property
    def near(self) -> int:
        return int(self.get_parameter("near", 0))

    def with_near(self, n: int) -> "JPEGLSParameters":
        return self.with_("near", n)

    def validate(self) -> None:
        require_range("near", self.near, 0, 255)


class _JPEGLSBase(Codec):
    _near_default = 0

    def encode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        info = old_pixel_data.get_frame_info()
        near = self._near_default
        ilv = None
        if parameters is not None:
            nv = parameters.get_parameter("near")
            if isinstance(nv, int) and nv >= 0:
                near = nv
            iv = parameters.get_parameter("ilv")
            if isinstance(iv, int):
                ilv = iv
        if self._near_default == 0:
            near = 0  # lossless UID is always NEAR=0
        for i in range(old_pixel_data.frame_count()):
            frame = old_pixel_data.get_frame(i)
            if info.samples_per_pixel == 3 and info.planar_configuration == 1:
                frame = np.ascontiguousarray(
                    frame_to_array(frame, info)).tobytes()
            new_pixel_data.add_frame(encode(
                frame, info.width, info.height, info.samples_per_pixel,
                info.bits_stored, near, ilv=ilv))

    def decode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        for i in range(old_pixel_data.frame_count()):
            pixels, _, _, _, _, _ = decode(old_pixel_data.get_frame(i))
            new_pixel_data.add_frame(pixels)


class JPEGLSLosslessCodec(_JPEGLSBase):
    """UID .80 (reference jpegls/lossless/codec.go:154-161)."""

    def name(self) -> str:
        return "JPEG-LS Lossless"

    def transfer_syntax(self) -> str:
        return uids.JPEG_LS_LOSSLESS

    def get_default_parameters(self) -> Parameters:
        return JPEGLSParameters(near=0)


class JPEGLSNearLosslessCodec(_JPEGLSBase):
    """UID .81 (reference jpegls/nearlossless/codec.go:188-195)."""

    _near_default = 2

    def name(self) -> str:
        return "JPEG-LS Near-Lossless"

    def transfer_syntax(self) -> str:
        return uids.JPEG_LS_NEAR_LOSSLESS

    def get_default_parameters(self) -> Parameters:
        return JPEGLSParameters(near=self._near_default)


def register() -> None:
    reg = get_global_registry()
    reg.register_codec(uids.JPEG_LS_LOSSLESS, JPEGLSLosslessCodec())
    reg.register_codec(uids.JPEG_LS_NEAR_LOSSLESS, JPEGLSNearLosslessCodec())
