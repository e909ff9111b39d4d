"""Native (C++) fast paths for the serial entropy stages.

The Python implementations in entropy/ are the behavioral reference;
these C++ mirrors exist because the MQ/EBCOT bit loops are the
[hot-serial] host bottleneck (SURVEY.md §2). Built on first use with g++
(cached beside the source); everything falls back to Python if the
toolchain or build is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LIB = None
_LOCK = threading.Lock()
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "ebcot_native.cpp")
# GDCT_NATIVE_SO: alternate build output (sanitizer lanes keep their
# instrumented build beside the normal cache); GDCT_NATIVE_CFLAGS:
# extra compile flags, e.g. "-fsanitize=thread -O1 -g" for the TSAN CI
# lane over the per-codeblock thread pool.
_SO = os.environ.get(
    "GDCT_NATIVE_SO",
    os.path.join(os.path.dirname(__file__), "libebcot.so"))


def _build() -> bool:
    try:
        src_mtime = os.path.getmtime(_SRC)
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= src_mtime:
            return True
        # built on first use on the host machine, so -march=native is
        # safe; fall back to the portable baseline if it fails.
        # Compile to a private temp path and os.replace into place:
        # two processes racing `g++ -o libebcot.so` interleave writes
        # and produce a loadable-but-corrupt library (observed as a 2x
        # T1 slowdown when a test run and a benchmark rebuilt at once).
        tmp = f"{_SO}.tmp.{os.getpid()}"
        user_flags = os.environ.get("GDCT_NATIVE_CFLAGS", "").split()
        for extra in (["-march=native"], []):
            r = subprocess.run(
                ["g++", "-O3", "-fwrapv", *extra, "-shared", "-fPIC",
                 "-pthread", "-std=c++17", *user_flags, "-o", tmp, _SRC],
                capture_output=True, timeout=240)
            if r.returncode == 0 and os.path.exists(tmp):
                os.replace(tmp, _SO)
                return True
        return False
    except Exception:  # noqa: BLE001
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (Python fallback)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("GDCT_DISABLE_NATIVE"):
            return None
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        lib.t1_encode.restype = ctypes.c_int
        lib.t1_encode.argtypes = [
            i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            i32p, u8p, i32p, i32p, ctypes.c_int, ctypes.c_int]
        lib.t1_encode32.restype = ctypes.c_int
        lib.t1_encode32.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            i32p, u8p, i32p, i32p, ctypes.c_int, ctypes.c_int]
        lib.t1_encode_blocks.restype = ctypes.c_int
        lib.t1_encode_blocks.argtypes = [
            i32p, i64p, i32p, i32p, i32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p, ctypes.c_long, i64p, i32p, i32p,
            i32p, u8p, i32p, i32p, ctypes.c_int]
        lib.t1_decode_blocks.restype = ctypes.c_int
        lib.t1_decode_blocks.argtypes = [
            u8p, i64p, i32p, i32p, i32p, i32p, i32p, i32p, i64p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i64p, i32p]
        lib.ht_cleanup_encode_blocks.restype = ctypes.c_long
        lib.ht_cleanup_encode_blocks.argtypes = [
            i32p, i64p, i32p, i32p, i32p, ctypes.c_int, i32p, i32p,
            u8p, ctypes.c_long, i64p, i32p]
        lib.ht_cleanup_decode_blocks.restype = ctypes.c_int
        lib.ht_cleanup_decode_blocks.argtypes = [
            u8p, i64p, i32p, i32p, i32p, i32p, ctypes.c_int, i32p, i32p,
            i32p, i64p, i32p]
        lib.ht_decode_blocks_refined.restype = ctypes.c_int
        lib.ht_decode_blocks_refined.argtypes = [
            u8p, i64p, i64p, i32p, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int, i32p, i32p, i32p, i64p, i32p]
        lib.ht_refine_encode_blocks.restype = ctypes.c_int
        lib.ht_refine_encode_blocks.argtypes = [
            i32p, i64p, i32p, i32p, ctypes.c_int, ctypes.c_int, i32p,
            u8p, i64p, i64p, i32p, i64p, i32p]
        lib.t2_assemble_packets.restype = ctypes.c_long
        lib.t2_assemble_packets.argtypes = [
            i32p, i32p, i32p, i32p, i64p, i32p, u8p, i64p, i32p, i64p,
            u8p, ctypes.c_int, i32p, i32p, i32p, i32p, ctypes.c_int,
            i32p, i64p, i32p, ctypes.c_int, ctypes.c_int, u8p,
            ctypes.c_long, ctypes.c_int]
        lib.t2_parse_packets.restype = ctypes.c_long
        lib.t2_parse_packets.argtypes = [
            u8p, ctypes.c_long, i32p, i32p, ctypes.c_int, i32p, i32p,
            i32p, i32p, i32p, ctypes.c_int, i32p, i32p, i64p, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p, i32p,
            u8p, u8p, i64p, i32p, i32p, ctypes.c_int, i64p]
        lib.t1_decode.restype = ctypes.c_int
        lib.t1_decode.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, ctypes.c_int, ctypes.c_int, i64p]
        lib.t1_decode32.restype = ctypes.c_int
        lib.t1_decode32.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, ctypes.c_int, ctypes.c_int, i32p]
        lib.jls_encode_scan.restype = ctypes.c_int
        lib.jls_encode_scan.argtypes = [
            i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int]
        lib.jls_decode_scan.restype = ctypes.c_int
        lib.jls_decode_scan.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, i64p]
        lib.jpg_decode_scan.restype = ctypes.c_int
        lib.jpg_decode_scan.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, u8p, i32p, u8p, u8p, i32p, i32p, i64p]
        lib.jpg_lossless_decode_scan.restype = ctypes.c_int
        lib.jpg_lossless_decode_scan.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, u8p, u8p, i32p, i32p]
        lib.pack_bits_msb.restype = ctypes.c_int
        lib.pack_bits_msb.argtypes = [
            i64p, i64p, ctypes.c_long, ctypes.c_int, u8p, ctypes.c_long]
        lib.packbits_decode.restype = ctypes.c_int
        lib.packbits_decode.argtypes = [
            u8p, ctypes.c_long, u8p, ctypes.c_long]
        lib.jpg_destuff.restype = ctypes.c_long
        lib.jpg_destuff.argtypes = [u8p, ctypes.c_long, u8p]
        lib.packbits_encode.restype = ctypes.c_long
        lib.packbits_encode.argtypes = [
            u8p, ctypes.c_long, u8p, ctypes.c_long]
        lib.p14_pack_scan.restype = ctypes.c_long
        lib.p14_pack_scan.argtypes = [
            i64p, ctypes.c_long, i32p, i32p, u8p, ctypes.c_long]
        lib.p14_cat_hist.restype = None
        lib.p14_cat_hist.argtypes = [i64p, ctypes.c_long, i64p]
        lib.jpg_scan_hist.restype = None
        lib.jpg_scan_hist.argtypes = [
            i32p, ctypes.c_int, ctypes.c_long, i32p, ctypes.c_int,
            i64p, i64p]
        lib.jpg_encode_scan2.restype = ctypes.c_long
        lib.jpg_encode_scan2.argtypes = [
            i32p, ctypes.c_int, ctypes.c_long, i32p, ctypes.c_int,
            i32p, i32p, i32p, i32p, u8p, ctypes.c_long]
        lib.ht_cleanup_encode.restype = ctypes.c_long
        lib.ht_cleanup_encode.argtypes = [
            i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, i32p, u8p, ctypes.c_long]
        lib.ht_cleanup_decode.restype = ctypes.c_int
        lib.ht_cleanup_decode.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, i32p, i32p, i64p]
        lib.ht_refine_apply.restype = ctypes.c_int
        lib.ht_refine_apply.argtypes = [
            i64p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, i64p]
        lib.ht_refine_encode.restype = ctypes.c_long
        lib.ht_refine_encode.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
            ctypes.c_long, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.p14_diffs_hist.restype = ctypes.c_int
        lib.p14_diffs_hist.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, i64p]
        lib.p14_pack_scan32.restype = ctypes.c_long
        lib.p14_pack_scan32.argtypes = [
            i32p, ctypes.c_long, i32p, i32p, u8p, ctypes.c_long]
        lib.p14_reconstruct.restype = ctypes.c_int
        lib.p14_reconstruct.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p]
        lib.dwt53_fwd.restype = ctypes.c_int
        lib.dwt53_fwd.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.dwt53_inv.restype = ctypes.c_int
        lib.dwt53_inv.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        f32p = np.ctypeslib.ndpointer(dtype=np.float32,
                                      flags="C_CONTIGUOUS")
        lib.dwt97_fwd.restype = ctypes.c_int
        lib.dwt97_fwd.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.dwt97_inv.restype = ctypes.c_int
        lib.dwt97_inv.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.jpg_encode_frame.restype = ctypes.c_long
        lib.jpg_encode_frame.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
            ctypes.c_int, i32p, i32p, i32p, i32p, u8p, ctypes.c_long]
        lib.jpg_fdct_quant.restype = ctypes.c_int
        lib.jpg_fdct_quant.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
            ctypes.c_int, i32p]
        lib.jpg_idct.restype = ctypes.c_int
        lib.jpg_idct.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int,
            ctypes.c_int, i32p]
        _LIB = lib
        return _LIB


def _pack_tables(tables: dict):
    """4-slot Huffman table pack: ([4,16] bits, [4,256] vals, [4] counts)."""
    bits = np.zeros((4, 16), dtype=np.uint8)
    vals = np.zeros((4, 256), dtype=np.uint8)
    counts = np.zeros(4, dtype=np.int32)
    for tid, tab in tables.items():
        if not (0 <= tid < 4):
            return None
        bits[tid] = np.asarray(tab.bits, dtype=np.uint8)
        v = np.asarray(tab.values, dtype=np.uint8)
        if v.size > 256:
            return None
        vals[tid, : v.size] = v
        counts[tid] = v.size
    return bits.reshape(-1), vals.reshape(-1), counts


def jpg_decode_scan_native(destuffed: np.ndarray, comp_layout,
                           dc_tables: dict, ac_tables: dict,
                           mcu_cols: int, mcu_rows: int, restart: int):
    """Native sequential-DCT scan decode.

    comp_layout: per component (h, v, dc_tid, ac_tid, blocks_per_row).
    Returns list of [nblocks, 64] int32 arrays, or None if unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    dcp = _pack_tables(dc_tables)
    acp = _pack_tables(ac_tables)
    if dcp is None or acp is None:
        return None
    ncomp = len(comp_layout)
    ch = np.asarray([c[0] for c in comp_layout], dtype=np.int32)
    cv = np.asarray([c[1] for c in comp_layout], dtype=np.int32)
    cd = np.asarray([c[2] for c in comp_layout], dtype=np.int32)
    ca = np.asarray([c[3] for c in comp_layout], dtype=np.int32)
    cb = np.asarray([c[4] for c in comp_layout], dtype=np.int32)
    sizes = [mcu_rows * int(cv[i]) * int(cb[i]) * 64 for i in range(ncomp)]
    offsets = np.zeros(ncomp, dtype=np.int64)
    total = 0
    for i in range(ncomp):
        offsets[i] = total
        total += sizes[i]
    out = np.zeros(total, dtype=np.int32)
    buf = np.ascontiguousarray(destuffed, dtype=np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
    r = lib.jpg_decode_scan(buf, int(destuffed.size), ncomp, ch, cv, cd, ca,
                            cb, mcu_cols, mcu_rows, restart,
                            dcp[0], dcp[1], dcp[2], acp[0], acp[1], acp[2],
                            out, offsets)
    if r != 0:
        return None
    return [out[offsets[i] : offsets[i] + sizes[i]].reshape(-1, 64)
            for i in range(ncomp)]


def jpg_lossless_decode_scan_native(destuffed: np.ndarray, w: int, h: int,
                                    ncomp: int, comp_tids, tables: dict):
    """Native lossless-P14 difference decode → int64-ready int32 diffs
    [h*w*ncomp], or None."""
    lib = get_lib()
    if lib is None:
        return None
    packed = _pack_tables(tables)
    if packed is None:
        return None
    tid = np.asarray(comp_tids, dtype=np.int32)
    diffs = np.zeros(h * w * ncomp, dtype=np.int32)
    buf = np.ascontiguousarray(destuffed, dtype=np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
    r = lib.jpg_lossless_decode_scan(buf, int(destuffed.size), w, h, ncomp,
                                     tid, packed[0], packed[1], packed[2],
                                     diffs)
    if r != 0:
        return None
    return diffs


def pack_bits_msb_native(values: np.ndarray, lengths: np.ndarray,
                         pad_bit: int = 1):
    """Native MSB-first bit packing → uint8 array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, dtype=np.int64)
    ln = np.ascontiguousarray(lengths, dtype=np.int64)
    total_bits = int(ln[ln > 0].sum()) if ln.size else 0
    cap = total_bits // 8 + 2
    out = np.empty(max(cap, 1), dtype=np.uint8)
    n = lib.pack_bits_msb(v, ln, v.size, pad_bit, out, out.size)
    if n < 0:
        return None
    return out[:n]


def packbits_decode_native(data: bytes, expected_len: int):
    """Native PackBits segment decode → uint8 array, or None; raises
    nothing — error codes map to None so callers keep Python errors."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    src = np.ascontiguousarray(src)
    if src.size == 0:
        src = np.zeros(1, dtype=np.uint8)
    out = np.zeros(max(expected_len, 1), dtype=np.uint8)
    r = lib.packbits_decode(src, len(data), out, expected_len)
    if r != 0:
        return ("corrupt", r)
    return out[:expected_len]


def jpg_scan_hist_native(comp_zz, table_ids):
    """Per-table DC/AC symbol histograms over the interleaved scan →
    (dc[4,256], ac[4,256]) int64, or None."""
    lib = get_lib()
    if lib is None:
        return None
    if len(comp_zz) == 1:
        zz = np.ascontiguousarray(
            np.asarray(comp_zz[0], dtype=np.int32).reshape(-1, 64))
    else:
        zz = np.ascontiguousarray(np.concatenate(
            [np.asarray(z, dtype=np.int32).reshape(-1, 64)
             for z in comp_zz]))
    ncomp = len(comp_zz)
    nblocks = zz.shape[0] // ncomp
    tids = np.asarray(table_ids, dtype=np.int32)
    dc = np.zeros(4 * 256, dtype=np.int64)
    ac = np.zeros(4 * 256, dtype=np.int64)
    lib.jpg_scan_hist(zz.reshape(-1), ncomp, nblocks, tids, 0, dc, ac)
    return dc.reshape(4, 256), ac.reshape(4, 256)


def jpg_encode_scan2_native(comp_zz, table_ids, dc_tables, ac_tables,
                            restart: int = 0):
    """Native interleaved scan encode → stuffed bytes, or None.

    dc_tables/ac_tables: sequences of HuffmanTable indexed by table id.
    """
    lib = get_lib()
    if lib is None:
        return None
    if len(comp_zz) == 1:
        zz = np.ascontiguousarray(
            np.asarray(comp_zz[0], dtype=np.int32).reshape(-1, 64))
    else:
        zz = np.ascontiguousarray(np.concatenate(
            [np.asarray(z, dtype=np.int32).reshape(-1, 64)
             for z in comp_zz]))
    ncomp = len(comp_zz)
    nblocks = zz.shape[0] // ncomp
    tids = np.asarray(table_ids, dtype=np.int32)

    def pack(tabs):
        codes = np.zeros((4, 256), dtype=np.int32)
        lens = np.zeros((4, 256), dtype=np.int32)
        for t, tab in enumerate(tabs):
            if t >= 4:
                return None
            codes[t] = np.asarray(tab.code_of[:256], dtype=np.int32)
            lens[t] = np.asarray(tab.len_of[:256], dtype=np.int32)
        return codes.reshape(-1), lens.reshape(-1)

    dcp, acp = pack(dc_tables), pack(ac_tables)
    if dcp is None or acp is None:
        return None
    cap = zz.size * 4 + 65536
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jpg_encode_scan2(zz.reshape(-1), ncomp, nblocks, tids, restart,
                             dcp[0], dcp[1], acp[0], acp[1], out, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def jpg_encode_frame_native(plane: np.ndarray, qtable: np.ndarray,
                            level_shift: int, dc_table, ac_table):
    """Fused gray-frame DCT+quant+Huffman scan → stuffed bytes, or None.

    Single component, no restart markers; the coefficient block never
    leaves L1 (native jpg_encode_frame)."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(plane)
    if a.dtype == np.uint8:
        st = 1
    elif a.dtype == np.uint16:
        st = 2
    elif a.dtype == np.int32:
        st = 0
    else:
        a = a.astype(np.int32)
        st = 0
    h, w = a.shape
    q = np.ascontiguousarray(np.asarray(qtable, dtype=np.int32).reshape(-1))
    dcod = np.asarray(dc_table.code_of[:256], dtype=np.int32)
    dlen = np.asarray(dc_table.len_of[:256], dtype=np.int32)
    acod = np.asarray(ac_table.code_of[:256], dtype=np.int32)
    alen = np.asarray(ac_table.len_of[:256], dtype=np.int32)
    nblocks = ((h + 7) // 8) * ((w + 7) // 8)
    cap = nblocks * 64 * 4 + 65536
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jpg_encode_frame(a.reshape(-1).view(np.uint8), st, w, h, q,
                             level_shift, dcod, dlen, acod, alen, out, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


_HT_LUTS = None


def _ht_luts():
    """int32 copies of the HT VLC LUTs (codecs/ht_tables.py is the
    single source of truth; the native coder just consumes them)."""
    global _HT_LUTS
    if _HT_LUTS is None:
        from ..codecs.ht_tables import (DEC_LUT0, DEC_LUT1, ENC_LUT0,
                                        ENC_LUT1)
        _HT_LUTS = (np.ascontiguousarray(ENC_LUT0, dtype=np.int32),
                    np.ascontiguousarray(ENC_LUT1, dtype=np.int32),
                    np.ascontiguousarray(DEC_LUT0, dtype=np.int32),
                    np.ascontiguousarray(DEC_LUT1, dtype=np.int32))
    return _HT_LUTS


def ht_cleanup_encode_native(data: np.ndarray, kmax: int):
    """Native HT cleanup encode → bytes, b"" for all-zero block, or
    None when unavailable/failed."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = data.shape
    src = np.ascontiguousarray(data, dtype=np.int64)
    e0, e1, _, _ = _ht_luts()
    cap = w * h * 8 + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = lib.ht_cleanup_encode(src, w, h, kmax, e0, e1, out, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def ht_cleanup_decode_native(codeblock: bytes, w: int, h: int, kmax: int,
                             missing: int):
    """Native HT cleanup decode → int32 [h, w], ("corrupt", code) on a
    stream error (mapped to CorruptStreamError by the caller), or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.ascontiguousarray(np.frombuffer(codeblock, dtype=np.uint8))
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
    _, _, d0, d1 = _ht_luts()
    out = np.zeros(h * w, dtype=np.int64)
    r = lib.ht_cleanup_decode(buf, len(codeblock), w, h, kmax, missing,
                              d0, d1, out)
    if r != 0:
        return ("corrupt", r)
    return out.reshape(h, w).astype(np.int32)


def ht_refine_apply_native(w_arr: np.ndarray, dref: bytes, zblk: int,
                           causal: bool):
    """Native HT SigProp/MagRef apply → int64 [h, w], ("corrupt", code)
    on a stream error, or None when the library is unavailable
    (mirrors entropy/htrefine.apply_refinement)."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = w_arr.shape
    src = np.ascontiguousarray(w_arr, dtype=np.int64).reshape(-1)
    buf = np.frombuffer(dref, dtype=np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
    out = np.zeros(h * w, dtype=np.int64)
    r = lib.ht_refine_apply(src, w, h, np.ascontiguousarray(buf),
                            len(dref), zblk, int(causal), out)
    if r != 0:
        return ("corrupt", r)
    return out.reshape(h, w)


def ht_refine_encode_native(blk: np.ndarray, causal: bool):
    """Native HT SigProp/MagRef encode → (dref bytes, sp_len, exact,
    n_new, n_ref), or None when the library is unavailable (mirrors
    entropy/htrefine.encode_refinement)."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = blk.shape
    src = np.ascontiguousarray(blk, dtype=np.int32).reshape(-1)
    cap = 4 * h * w + 64
    out = np.zeros(cap, dtype=np.uint8)
    sp_len = ctypes.c_int()
    exact = ctypes.c_int()
    n_new = ctypes.c_int()
    n_ref = ctypes.c_int()
    n = lib.ht_refine_encode(src, w, h, int(causal), out, cap,
                             ctypes.byref(sp_len), ctypes.byref(exact),
                             ctypes.byref(n_new), ctypes.byref(n_ref))
    if n < 0:
        return None
    return (out[:n].tobytes(), int(sp_len.value), bool(exact.value),
            int(n_new.value), int(n_ref.value))


def ht_refine_encode_blocks_native(blks, causal: bool):
    """Batched HT refinement ENCODE prep. blks: sequence of int32 [h,w]
    arrays. Returns a per-block list of
        (u [h,w] int32, dref bytes, sp_len, [nms0, nms1, nms2])
    for refined blocks, None where the block keeps its single
    full-precision cleanup pass, or "fallback" where the caller must
    re-run the scalar prep; returns None overall when the native
    library is unavailable."""
    lib = get_lib()
    if lib is None or not blks:
        return None
    nb = len(blks)
    v_offs = np.zeros(nb + 1, dtype=np.int64)
    dref_offs = np.zeros(nb + 1, dtype=np.int64)
    ws = np.empty(nb, dtype=np.int32)
    hs = np.empty(nb, dtype=np.int32)
    srcs = []
    for i, b in enumerate(blks):
        h, w = b.shape
        srcs.append(np.ascontiguousarray(b, dtype=np.int32).reshape(-1))
        v_offs[i + 1] = v_offs[i] + w * h
        dref_offs[i + 1] = dref_offs[i] + 4 * w * h + 64
        ws[i], hs[i] = w, h
    v = np.concatenate(srcs) if srcs else np.zeros(1, dtype=np.int32)
    u = np.zeros(int(v_offs[-1]), dtype=np.int32)
    dref = np.zeros(int(dref_offs[-1]), dtype=np.uint8)
    dref_lens = np.zeros(nb, dtype=np.int64)
    sp_lens = np.zeros(nb, dtype=np.int32)
    nms = np.zeros(nb * 3, dtype=np.int64)
    status = np.zeros(nb, dtype=np.int32)
    lib.ht_refine_encode_blocks(v, v_offs, ws, hs, int(bool(causal)), nb,
                                u, dref, dref_offs, dref_lens, sp_lens,
                                nms, status)
    out = []
    for i in range(nb):
        if status[i] == 0:
            d0 = int(dref_offs[i])
            out.append((u[v_offs[i]:v_offs[i + 1]].reshape(
                            blks[i].shape),
                        dref[d0:d0 + int(dref_lens[i])].tobytes(),
                        int(sp_lens[i]),
                        [int(nms[i * 3]), int(nms[i * 3 + 1]),
                         int(nms[i * 3 + 2])]))
        elif status[i] == 1:
            out.append(None)
        else:
            out.append("fallback")
    return out


def p14_cat_hist_native(diffs: np.ndarray):
    """Native 17-bin category histogram, or None."""
    lib = get_lib()
    if lib is None:
        return None
    d = np.ascontiguousarray(diffs, dtype=np.int64)
    hist = np.zeros(17, dtype=np.int64)
    if d.size == 0:
        return hist
    lib.p14_cat_hist(d, d.size, hist)
    return hist


def packbits_encode_native(seg: np.ndarray):
    """Native PackBits segment encode → bytes, or None."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(seg, dtype=np.uint8)
    if s.size == 0:
        return b""
    out = np.empty(s.size + s.size // 128 + 16, dtype=np.uint8)
    n = lib.packbits_encode(s, s.size, out, out.size)
    if n < 0:
        return None
    return out[:n].tobytes()


def p14_pack_scan_native(diffs: np.ndarray, codes: np.ndarray,
                         lens: np.ndarray):
    """Native one-pass P14 symbol+extend packing with FF stuffing →
    bytes, or None."""
    lib = get_lib()
    if lib is None:
        return None
    d = np.ascontiguousarray(diffs, dtype=np.int64)
    c = np.ascontiguousarray(codes, dtype=np.int32)
    ln = np.ascontiguousarray(lens, dtype=np.int32)
    cap = d.size * 5 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = lib.p14_pack_scan(d, d.size, c, ln, out, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def t1_encode_native(data: np.ndarray, style: int, orient: int,
                     roishift: int = 0, need_nmse: bool = True):
    """Native T1 encode; returns (bytes, numbps, rates, terms, bitplanes,
    nmsedecs) or None when the native path is unavailable.

    need_nmse=False skips the NMSEDEC distortion accumulation (PCRD
    inputs) — the stream/rates are identical, nmsedecs come back as
    zeros; single-layer unrated encodes use this (measured ~15% of
    dense-block encode time)."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = data.shape
    max_passes = 3 * 40
    cap = max(w * h * 6 + 1024, 4096)
    out = np.empty(cap, dtype=np.uint8)
    rates = np.zeros(max_passes, dtype=np.int32)
    terms = np.zeros(max_passes, dtype=np.uint8)
    bps = np.zeros(max_passes, dtype=np.int32)
    nmse = np.zeros(max_passes, dtype=np.int32)
    numbps = ctypes.c_int(0)
    npasses = ctypes.c_int(0)
    if data.dtype == np.int32:  # skip the int64 widening copy
        src = np.ascontiguousarray(data)
        n = lib.t1_encode32(src, w, h, style, orient, roishift, out, cap,
                            ctypes.byref(numbps), ctypes.byref(npasses),
                            rates, terms, bps, nmse, max_passes,
                            1 if need_nmse else 0)
    else:
        src = np.ascontiguousarray(data, dtype=np.int64)
        n = lib.t1_encode(src, w, h, style, orient, roishift, out, cap,
                          ctypes.byref(numbps), ctypes.byref(npasses),
                          rates, terms, bps, nmse, max_passes,
                          1 if need_nmse else 0)
    if n < 0:
        return None
    k = npasses.value
    return (out[:n].tobytes(), numbps.value, rates[:k].tolist(),
            terms[:k].astype(bool).tolist(), bps[:k].tolist(),
            nmse[:k].tolist())


def t1_encode_blocks_native(blocks, orients, style: int,
                            need_nmse: bool = True):
    """Batched native T1 encode: one C call for a whole tile's
    code-blocks (vs one ctypes round-trip per block). blocks: sequence
    of int [h, w] arrays; orients: per-block subband orientation.
    Returns a list of per-block (bytes, numbps, rates, terms,
    bitplanes, nmsedecs) tuples — identical to t1_encode_native on
    each block — or None when the native path is unavailable."""
    lib = get_lib()
    if lib is None or not blocks:
        return None
    nb = len(blocks)
    offsets = np.zeros(nb + 1, dtype=np.int64)
    ws = np.empty(nb, dtype=np.int32)
    hs = np.empty(nb, dtype=np.int32)
    total = 0
    for i, b in enumerate(blocks):
        hs[i], ws[i] = b.shape
        total += b.size
        offsets[i + 1] = total
    src = np.empty(total, dtype=np.int32)
    for i, b in enumerate(blocks):
        np.copyto(src[offsets[i]:offsets[i + 1]].reshape(b.shape), b,
                  casting="unsafe")
    ors = np.ascontiguousarray(orients, dtype=np.int32)
    max_passes = 3 * 40
    cap = max(total * 6 + 1024 * nb, 4096)
    out = np.empty(cap, dtype=np.uint8)
    out_offsets = np.zeros(nb + 1, dtype=np.int64)
    numbps = np.zeros(nb, dtype=np.int32)
    npasses = np.zeros(nb, dtype=np.int32)
    rates = np.zeros((nb, max_passes), dtype=np.int32)
    terms = np.zeros((nb, max_passes), dtype=np.uint8)
    bps = np.zeros((nb, max_passes), dtype=np.int32)
    nmse = np.zeros((nb, max_passes), dtype=np.int32)
    n = lib.t1_encode_blocks(src, offsets, ws, hs, ors, nb, style,
                             1 if need_nmse else 0, out, cap, out_offsets,
                             numbps, npasses, rates.reshape(-1),
                             terms.reshape(-1), bps.reshape(-1),
                             nmse.reshape(-1), max_passes)
    if n < 0:
        return None
    results = []
    for i in range(nb):
        k = int(npasses[i])
        results.append((out[out_offsets[i]:out_offsets[i + 1]].tobytes(),
                        int(numbps[i]), rates[i, :k].tolist(),
                        terms[i, :k].astype(bool).tolist(),
                        bps[i, :k].tolist(), nmse[i, :k].tolist()))
    return results


def jls_encode_scan_native(img: np.ndarray, maxval: int, near: int,
                           reset: int, t1: int, t2: int, t3: int,
                           ilv: int = 2):
    """Native JPEG-LS scan encode. img: [h, w, comps] int; ilv is the
    T.87 interleave mode for multi-component frames (2 sample, 1 line);
    returns scan bytes (no markers) or None."""
    lib = get_lib()
    if lib is None:
        return None
    h, w, comps = img.shape
    buf = np.ascontiguousarray(img, dtype=np.int64).reshape(-1)
    cap = max(w * h * comps * 4 + 4096, 8192)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jls_encode_scan(buf, w, h, comps, maxval, near, reset,
                            t1, t2, t3, ilv, out, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def jpg_destuff_native(data: np.ndarray):
    """Native mirror of utils/npbits.destuff_ff → uint8 array or None."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(data, dtype=np.uint8)
    if src.size == 0:
        return src
    out = np.empty(src.size, dtype=np.uint8)
    n = lib.jpg_destuff(src, src.size, out)
    return out[:n]


def jls_decode_scan_native(data: bytes, w: int, h: int, comps: int,
                           maxval: int, near: int, reset: int,
                           t1: int, t2: int, t3: int, ilv: int):
    """Native JPEG-LS scan decode → int64 [h, w, comps], or None."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
    out = np.zeros(h * w * comps, dtype=np.int64)
    r = lib.jls_decode_scan(buf, len(data), w, h, comps, maxval, near,
                            reset, t1, t2, t3, ilv, out)
    if r != 0:
        return None
    return out.reshape(h, w, comps)


def t1_decode_native(stream: bytes, w: int, h: int, style: int, orient: int,
                     num_passes: int, numbps: int, roishift: int = 0,
                     seg_ends=None, ojp_recon: bool = False,
                     out_dtype=np.int64):
    """Native T1 decode → [h, w] array of out_dtype (int64 default;
    int32 skips a widening copy but the caller must guarantee decoded
    magnitudes fit — e.g. numbps ≤ 30, see the ROI note in
    codecs/jpeg2000.py), or None if unavailable.

    ojp_recon: OpenJPEG one-plus-half mid-bin reconstruction (exact on
    fully-decoded blocks; mid-bin at the lowest decoded plane for
    truncated ones) — what the codec decode path uses, mirroring the
    reference tile decoder (t2/tile_decoder.go:594)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(stream, dtype=np.uint8)
    buf = np.ascontiguousarray(buf)
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
    segs = np.asarray(seg_ends if seg_ends else [], dtype=np.int32)
    if segs.size == 0:
        segs = np.zeros(1, dtype=np.int32)
        n_segs = 0
    else:
        n_segs = segs.size
    if out_dtype == np.int32:
        out = np.zeros(h * w, dtype=np.int32)
        r = lib.t1_decode32(buf, len(stream), w, h, style, orient,
                            num_passes, numbps, roishift, segs, n_segs,
                            1 if ojp_recon else 0, out)
    else:
        out = np.zeros(h * w, dtype=np.int64)
        r = lib.t1_decode(buf, len(stream), w, h, style, orient,
                          num_passes, numbps, roishift, segs, n_segs,
                          1 if ojp_recon else 0, out)
    if r != 0:
        return None
    return out.reshape(h, w)


def t1_decode_blocks_native(items, style: int, ojp_recon: bool = True):
    """Batched native T1 decode: one C call for a whole tile's
    code-blocks. items: sequence of (stream bytes, w, h, orient,
    num_passes, numbps, seg_ends) with numbps <= 30 (int32 outputs).
    Returns a list of int32 [h, w] arrays with None at failed blocks
    (caller re-runs those through the scalar path for exact error
    semantics), or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not items:
        return None
    nb = len(items)
    stream_offsets = np.zeros(nb + 1, dtype=np.int64)
    seg_offsets = np.zeros(nb + 1, dtype=np.int64)
    out_offsets = np.zeros(nb + 1, dtype=np.int64)
    ws = np.empty(nb, dtype=np.int32)
    hs = np.empty(nb, dtype=np.int32)
    ors = np.empty(nb, dtype=np.int32)
    nps = np.empty(nb, dtype=np.int32)
    nbps = np.empty(nb, dtype=np.int32)
    for i, (s, w, h, orient, np_, bp, segs) in enumerate(items):
        stream_offsets[i + 1] = stream_offsets[i] + len(s)
        seg_offsets[i + 1] = seg_offsets[i] + len(segs or ())
        out_offsets[i + 1] = out_offsets[i] + w * h
        ws[i], hs[i], ors[i], nps[i], nbps[i] = w, h, orient, np_, bp
    streams = np.frombuffer(
        b"".join(s for (s, *_r) in items), dtype=np.uint8)
    if streams.size == 0:
        streams = np.zeros(1, dtype=np.uint8)
    all_segs = np.zeros(max(int(seg_offsets[-1]), 1), dtype=np.int32)
    for i, it in enumerate(items):
        segs = it[6]
        if segs:
            all_segs[seg_offsets[i]:seg_offsets[i + 1]] = segs
    out = np.zeros(int(out_offsets[-1]), dtype=np.int32)
    status = np.zeros(nb, dtype=np.int32)
    lib.t1_decode_blocks(streams, stream_offsets, ws, hs, ors, nps, nbps,
                         all_segs, seg_offsets, nb, style,
                         1 if ojp_recon else 0, out, out_offsets, status)
    return [out[out_offsets[i]:out_offsets[i + 1]].reshape(
                items[i][2], items[i][1]) if status[i] == 0 else None
            for i in range(nb)]


def ht_cleanup_encode_blocks_native(blocks, kmaxs):
    """Batched native HT cleanup encode: one C call for a tile's HT
    code-blocks (int32 source, no per-block widening copy). Returns a
    list of per-block bytes (b\"\" for all-zero, None on a per-block
    error), or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not blocks:
        return None
    nb = len(blocks)
    offsets = np.zeros(nb + 1, dtype=np.int64)
    ws = np.empty(nb, dtype=np.int32)
    hs = np.empty(nb, dtype=np.int32)
    total = 0
    for i, b in enumerate(blocks):
        hs[i], ws[i] = b.shape
        total += b.size
        offsets[i + 1] = total
    src = np.empty(total, dtype=np.int32)
    for i, b in enumerate(blocks):
        np.copyto(src[offsets[i]:offsets[i + 1]].reshape(b.shape), b,
                  casting="unsafe")
    km = np.ascontiguousarray(kmaxs, dtype=np.int32)
    e0, e1, _, _ = _ht_luts()
    cap = total * 8 + 4096 * nb
    out = np.empty(cap, dtype=np.uint8)
    out_offsets = np.zeros(nb + 1, dtype=np.int64)
    status = np.zeros(nb, dtype=np.int32)
    lib.ht_cleanup_encode_blocks(src, offsets, ws, hs, km, nb, e0, e1,
                                 out, cap, out_offsets, status)
    res = []
    for i in range(nb):
        if status[i] < 0:
            res.append(None)
        elif status[i] == 0:
            res.append(b"")
        else:
            res.append(out[out_offsets[i]:out_offsets[i + 1]].tobytes())
    return res


def ht_cleanup_decode_blocks_native(items):
    """Batched native HT cleanup decode. items: sequence of
    (codeblock bytes, w, h, kmax, missing). Returns a list of int32
    [h, w] arrays with (\"corrupt\", code) at failed blocks, or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not items:
        return None
    nb = len(items)
    offs = np.zeros(nb + 1, dtype=np.int64)
    out_offsets = np.zeros(nb + 1, dtype=np.int64)
    ws = np.empty(nb, dtype=np.int32)
    hs = np.empty(nb, dtype=np.int32)
    kms = np.empty(nb, dtype=np.int32)
    mis = np.empty(nb, dtype=np.int32)
    for i, (s, w, h, km, mi) in enumerate(items):
        offs[i + 1] = offs[i] + len(s)
        out_offsets[i + 1] = out_offsets[i] + w * h
        ws[i], hs[i], kms[i], mis[i] = w, h, km, mi
    data = np.frombuffer(b"".join(s for (s, *_r) in items),
                         dtype=np.uint8)
    if data.size == 0:
        data = np.zeros(1, dtype=np.uint8)
    _, _, d0, d1 = _ht_luts()
    out = np.zeros(int(out_offsets[-1]), dtype=np.int32)
    status = np.zeros(nb, dtype=np.int32)
    lib.ht_cleanup_decode_blocks(data, offs, ws, hs, kms, mis, nb, d0, d1,
                                 out, out_offsets, status)
    return [out[out_offsets[i]:out_offsets[i + 1]].reshape(
                items[i][2], items[i][1]) if status[i] == 0
            else ("corrupt", int(status[i])) for i in range(nb)]


def ht_decode_blocks_refined_native(items):
    """Batched native HT cleanup+refinement decode. items: sequence of
    (segment bytes, cleanup_len, w, h, kmax, missing, zblk, causal) —
    segment[cleanup_len:] is the SigProp/MagRef refinement (may be
    empty = Z_blk 1). Returns a list of int32 [h, w] arrays with
    ("corrupt", code) at failed blocks (900 = refinement error, the
    caller re-runs the scalar path for exact exception semantics), or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not items:
        return None
    nb = len(items)
    offs = np.zeros(nb + 1, dtype=np.int64)
    out_offsets = np.zeros(nb + 1, dtype=np.int64)
    cus = np.empty(nb, dtype=np.int64)
    ws = np.empty(nb, dtype=np.int32)
    hs = np.empty(nb, dtype=np.int32)
    kms = np.empty(nb, dtype=np.int32)
    mis = np.empty(nb, dtype=np.int32)
    zbs = np.empty(nb, dtype=np.int32)
    cas = np.empty(nb, dtype=np.int32)
    for i, (s, cu, w, h, km, mi, zb, ca) in enumerate(items):
        offs[i + 1] = offs[i] + len(s)
        out_offsets[i + 1] = out_offsets[i] + w * h
        cus[i], ws[i], hs[i] = cu, w, h
        kms[i], mis[i], zbs[i], cas[i] = km, mi, zb, int(bool(ca))
    data = np.frombuffer(b"".join(s for (s, *_r) in items),
                         dtype=np.uint8)
    if data.size == 0:
        data = np.zeros(1, dtype=np.uint8)
    _, _, d0, d1 = _ht_luts()
    out = np.zeros(int(out_offsets[-1]), dtype=np.int32)
    status = np.zeros(nb, dtype=np.int32)
    lib.ht_decode_blocks_refined(data, offs, cus, ws, hs, kms, mis, zbs,
                                 cas, nb, d0, d1, out, out_offsets, status)
    return [out[out_offsets[i]:out_offsets[i + 1]].reshape(
                items[i][3], items[i][2]) if status[i] == 0
            else ("corrupt", int(status[i])) for i in range(nb)]


class T2AssembleContext:
    """Reusable marshalling for the native whole-tile packet assembler.

    The PCRD measured-bytes bisection assembles the same tile dozens of
    times with only the per-block ``layer_passes`` (and the trial's
    packet order) changing; the block geometry, pass rates, and stream
    bytes are invariant. This context marshals the invariant tables
    once; :meth:`assemble` rebuilds only the per-call arrays.
    ``usable`` is False when the native library is unavailable.
    """

    def __init__(self, comp_states, style: int):
        self.lib = get_lib()
        self.style = style
        self.usable = self.lib is not None
        if not self.usable:
            return
        band_idx = {}
        bands = []
        blocks = []
        blk_start = []
        blk_count = []
        for states in comp_states:
            for plist in states.values():
                for ps in plist:
                    if id(ps) not in band_idx:
                        band_idx[id(ps)] = len(bands)
                        bands.append(ps)
                        blk_start.append(len(blocks))
                        blk_count.append(len(ps.blocks))
                        blocks.extend(ps.blocks)
        self.band_idx = band_idx
        # pin the PrecinctState objects for the context's lifetime: the
        # id()-keyed lookup in assemble() relies on these ids staying
        # unique, and CPython recycles ids of collected objects
        self.bands = bands
        self.blocks = blocks
        nblocks = len(blocks)
        self.nblocks = nblocks
        self.nbands = len(bands)
        cbx = np.empty(nblocks, dtype=np.int32)
        cby = np.empty(nblocks, dtype=np.int32)
        zbp = np.empty(nblocks, dtype=np.int32)
        numbps = np.empty(nblocks, dtype=np.int32)
        rate_offsets = np.zeros(nblocks + 1, dtype=np.int64)
        data_offsets = np.zeros(nblocks + 1, dtype=np.int64)
        rates_l = []
        datas = []
        for i, blk in enumerate(blocks):
            cbx[i] = blk.cbx
            cby[i] = blk.cby
            zbp[i] = blk.zero_bitplanes
            numbps[i] = blk.numbps
            rates_l.extend(blk.pass_rates)
            rate_offsets[i + 1] = len(rates_l)
            datas.append(bytes(blk.data) if blk.data else b"")
            data_offsets[i + 1] = data_offsets[i] + len(datas[-1])
        self.cbx, self.cby, self.zbp, self.numbps = cbx, cby, zbp, numbps
        self.rate_offsets = rate_offsets
        self.data_offsets = data_offsets
        self.rates = np.asarray(rates_l or [0], dtype=np.int32)
        self.data = np.frombuffer(b"".join(datas) or b"\0",
                                  dtype=np.uint8)
        self.terms = np.zeros(1, dtype=np.uint8)  # unused by the mirror
        self.ncbw = np.asarray([max(ps.ncbw, 1) for ps in bands] or [1],
                               dtype=np.int32)
        self.ncbh = np.asarray([max(ps.ncbh, 1) for ps in bands] or [1],
                               dtype=np.int32)
        self.blk_start = np.asarray(blk_start or [0], dtype=np.int32)
        self.blk_count = np.asarray(blk_count or [0], dtype=np.int32)

    def assemble(self, comp_states, order, measure_only: bool = False):
        """Assemble (or, with measure_only, exactly size) the tile body
        for ``order``. Returns bytes (or the byte count), or None when
        unavailable — the BlockStates are never mutated either way."""
        if not self.usable:
            return None
        band_idx = self.band_idx
        pkt_layer = np.empty(len(order), dtype=np.int32)
        pkt_band_offsets = np.zeros(len(order) + 1, dtype=np.int64)
        pkt_bands_l = []
        for p, (layer, r, c, pidx) in enumerate(order):
            pkt_layer[p] = layer
            for ps in comp_states[c][(r, pidx)]:
                b = band_idx.get(id(ps))
                if b is None:
                    return None  # unknown band: states changed shape
                pkt_bands_l.append(b)
            pkt_band_offsets[p + 1] = len(pkt_bands_l)
        nblocks = self.nblocks
        lp_offsets = np.zeros(nblocks + 1, dtype=np.int64)
        lp_l = []
        num_layers = 1
        for i, blk in enumerate(self.blocks):
            if blk.layer_passes:
                lp_l.extend(blk.layer_passes)
                num_layers = max(num_layers, len(blk.layer_passes))
            lp_offsets[i + 1] = len(lp_l)
        lp = np.asarray(lp_l or [0], dtype=np.int32)
        hdr_cap = 64 * nblocks * max(num_layers, 1) \
            + 16 * len(order) + 4096
        if measure_only:
            cap = hdr_cap  # headers are sized in scratch, nothing lands
            out = _MEASURE_DUMMY
        else:
            cap = int(self.data_offsets[-1]) + hdr_cap
            out = np.empty(cap, dtype=np.uint8)
        n = self.lib.t2_assemble_packets(
            self.cbx, self.cby, self.zbp, self.numbps,
            self.rate_offsets, self.rates, self.terms, lp_offsets, lp,
            self.data_offsets, self.data, nblocks, self.ncbw, self.ncbh,
            self.blk_start, self.blk_count, self.nbands,
            pkt_layer, pkt_band_offsets,
            np.asarray(pkt_bands_l or [0], dtype=np.int32), len(order),
            self.style, out, cap, 1 if measure_only else 0)
        if n < 0:
            return None
        if measure_only:
            return int(n)
        return out[:n].tobytes()


_MEASURE_DUMMY = np.zeros(1, dtype=np.uint8)


def t2_assemble_packets_native(comp_states, order, style: int):
    """Assemble every packet of a tile natively (headers, tag trees,
    Lblock state, body copies — mirror of t2/packets.encode_packet over
    the full progression). comp_states: per-component dict
    (r, pidx) -> [PrecinctState]; order: [(layer, r, c, pidx)].
    Returns the tile body bytes, or None when unavailable (caller runs
    the Python reference assembly).

    NOTE: does NOT mutate the BlockState objects (num_passes/included/
    lblock stay untouched) — callers discard the states after assembly.
    """
    return T2AssembleContext(comp_states, style).assemble(comp_states,
                                                          order)


def t2_parse_packets_native(body: bytes, comp_states, order,
                            styles, use_sop: bool, use_eph: bool,
                            pkt_skip=None):
    """Parse every packet of a tile body natively (STRICT mode only —
    resilient/corrupt paths stay on the Python reference). order:
    [(layer, r, c, pidx)]; styles: per-component cb_style. Mutates the
    BlockStates (numbps/zero_bitplanes/included/num_passes/seg_data/
    seg_ends) exactly like running t2/packets.decode_packet over the
    order, and returns the final body position — or None (unavailable
    or any stream error; the states are untouched then).
    pkt_skip: optional per-packet PLT length (or -1 = parse); a
    non-negative entry advances over that packet without reading it
    (reduced-resolution decode of dropped resolutions)."""
    lib = get_lib()
    if lib is None:
        return None
    band_idx = {}
    bands = []
    blocks = []
    blk_start = []
    blk_count = []
    pkt_layer = np.empty(len(order), dtype=np.int32)
    pkt_style = np.empty(len(order), dtype=np.int32)
    pkt_band_offsets = np.zeros(len(order) + 1, dtype=np.int64)
    pkt_bands_l = []
    for p, (layer, r, c, pidx) in enumerate(order):
        plist = comp_states[c][(r, pidx)]
        pkt_layer[p] = layer
        pkt_style[p] = styles[c]
        for ps in plist:
            b = band_idx.get(id(ps))
            if b is None:
                b = len(bands)
                band_idx[id(ps)] = b
                bands.append(ps)
                blk_start.append(len(blocks))
                blk_count.append(len(ps.blocks))
                blocks.extend(ps.blocks)
            pkt_bands_l.append(b)
        pkt_band_offsets[p + 1] = len(pkt_bands_l)
    nblocks = len(blocks)
    nbands = len(bands)
    cbx = np.asarray([blk.cbx for blk in blocks] or [0], dtype=np.int32)
    cby = np.asarray([blk.cby for blk in blocks] or [0], dtype=np.int32)
    bl = np.frombuffer(body or b"\0", dtype=np.uint8)
    max_segs = 3 * 40 + 2
    o_numbps = np.zeros(max(nblocks, 1), dtype=np.int32)
    o_zbp = np.zeros(max(nblocks, 1), dtype=np.int32)
    o_npasses = np.zeros(max(nblocks, 1), dtype=np.int32)
    o_included = np.zeros(max(nblocks, 1), dtype=np.uint8)
    o_segdata = np.empty(max(len(body), 1), dtype=np.uint8)
    o_data_offsets = np.zeros(nblocks + 1, dtype=np.int64)
    o_seg_ends = np.zeros(max(nblocks, 1) * max_segs, dtype=np.int32)
    o_seg_counts = np.zeros(max(nblocks, 1), dtype=np.int32)
    pos = lib.t2_parse_packets(
        bl, len(body), cbx, cby, nblocks,
        np.asarray([max(ps.ncbw, 1) for ps in bands] or [1],
                   dtype=np.int32),
        np.asarray([max(ps.ncbh, 1) for ps in bands] or [1],
                   dtype=np.int32),
        np.asarray([ps.mb for ps in bands] or [0], dtype=np.int32),
        np.asarray(blk_start or [0], dtype=np.int32),
        np.asarray(blk_count or [0], dtype=np.int32), nbands,
        pkt_layer, pkt_style, pkt_band_offsets,
        np.asarray(pkt_bands_l or [0], dtype=np.int32), len(order),
        1 if use_sop else 0, 1 if use_eph else 0,
        o_numbps, o_zbp, o_npasses, o_included, o_segdata,
        o_data_offsets, o_seg_ends, o_seg_counts, max_segs,
        np.full(max(len(order), 1), -1, dtype=np.int64)
        if pkt_skip is None
        else np.asarray(pkt_skip, dtype=np.int64))
    if pos < 0:
        return None
    for i, blk in enumerate(blocks):
        if o_included[i]:
            blk.included = True
            blk.numbps = int(o_numbps[i])
            blk.zero_bitplanes = int(o_zbp[i])
        blk.num_passes = int(o_npasses[i])
        blk.seg_data = bytearray(
            o_segdata[o_data_offsets[i]:o_data_offsets[i + 1]].tobytes())
        k = int(o_seg_counts[i])
        blk.seg_ends = o_seg_ends[i * max_segs:i * max_segs + k].tolist()
    return int(pos)


def dwt53_fwd_native(arr: np.ndarray, levels: int, x0: int = 0,
                     y0: int = 0):
    """Native in-place multilevel forward 5/3 DWT (mirror of
    ops/dwt53.fwd53_multilevel). Returns a new int32 array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.int32).copy()
    h, w = a.shape
    lib.dwt53_fwd(a.reshape(-1), w, h, levels, x0, y0)
    return a


def dwt53_inv_native(arr: np.ndarray, levels: int, x0: int = 0,
                     y0: int = 0):
    """Native in-place multilevel inverse 5/3 DWT (mirror of
    ops/dwt53.inv53_multilevel). Returns a new int32 array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.int32).copy()
    h, w = a.shape
    lib.dwt53_inv(a.reshape(-1), w, h, levels, x0, y0)
    return a


def dwt97_fwd_native(arr: np.ndarray, levels: int, x0: int = 0,
                     y0: int = 0):
    """Native in-place multilevel forward 9/7 (float32; mirror in role
    of ops/dwt97.fwd97_multilevel — same lifting, not bit-pinned vs
    XLA). Returns a new float32 array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.float32).copy()
    h, w = a.shape
    lib.dwt97_fwd(a.reshape(-1), w, h, levels, x0, y0)
    return a


def dwt97_inv_native(arr: np.ndarray, levels: int, x0: int = 0,
                     y0: int = 0):
    """Native in-place multilevel inverse 9/7 (float32). Returns a new
    float32 array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.float32).copy()
    h, w = a.shape
    lib.dwt97_inv(a.reshape(-1), w, h, levels, x0, y0)
    return a


def p14_diffs_hist_native(plane: np.ndarray, predictor: int,
                          precision: int):
    """Fused predict+diff+category-histogram (mirror of
    ops/lossless_predict.encode_diffs + p14 categories).
    Returns (diffs int32 [h, w], hist int64 [17]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(plane, dtype=np.int32)
    h, w = a.shape
    diffs = np.empty(h * w, dtype=np.int32)
    hist = np.zeros(17, dtype=np.int64)
    r = lib.p14_diffs_hist(a.reshape(-1), w, h, predictor, precision,
                           diffs, hist)
    if r != 0:
        return None
    return diffs.reshape(h, w), hist


def p14_pack_scan32_native(diffs: np.ndarray, codes: np.ndarray,
                           lengths: np.ndarray):
    """int32 fused-put variant of p14_pack_scan_native."""
    lib = get_lib()
    if lib is None:
        return None
    d = np.ascontiguousarray(diffs.reshape(-1), dtype=np.int32)
    cap = d.size * 4 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = lib.p14_pack_scan32(d, d.size,
                            np.ascontiguousarray(codes, dtype=np.int32),
                            np.ascontiguousarray(lengths, dtype=np.int32),
                            out, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def jpg_fdct_quant_native(plane: np.ndarray, qtable: np.ndarray,
                          level_shift: int):
    """Host DCT+quant+zigzag over the whole plane (integer islow
    butterflies — byte-identical mirror of
    ops/dct8x8.encode_plane_to_zigzag, the r4 determinism invariant;
    parity pinned in tests/test_native.py). plane: [h, w] int;
    qtable: [8, 8] raster. Returns [nby, nbx, 64] int32, or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(plane)
    if a.dtype == np.uint8:
        st = 1
    elif a.dtype == np.uint16:
        st = 2
    else:
        a = np.ascontiguousarray(a, dtype=np.int32)
        st = 0
    h, w = a.shape
    nby, nbx = -(-h // 8), -(-w // 8)
    q = np.ascontiguousarray(qtable, dtype=np.int32).reshape(-1)
    out = np.empty(nby * nbx * 64, dtype=np.int32)
    if lib.jpg_fdct_quant(a.reshape(-1).view(np.uint8), st, w, h, q,
                          level_shift, out) != 0:
        return None
    return out.reshape(nby, nbx, 64)


def jpg_idct_native(zz: np.ndarray, qtable: np.ndarray, level_shift: int,
                    max_val: int):
    """Host inv-zigzag+dequant+IDCT+clamp (role of
    ops/dct8x8.decode_zigzag_to_plane). zz: [nby, nbx, 64] int32.
    Returns [nby*8, nbx*8] int32, or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.ascontiguousarray(zz, dtype=np.int32)
    nby, nbx = z.shape[0], z.shape[1]
    q = np.ascontiguousarray(qtable, dtype=np.int32).reshape(-1)
    out = np.empty((nby * 8, nbx * 8), dtype=np.int32)
    if lib.jpg_idct(z.reshape(-1), nby, nbx, q, level_shift, max_val,
                    out.reshape(-1)) != 0:
        return None
    return out


def p14_reconstruct_native(diffs: np.ndarray, predictor: int,
                           precision: int):
    """Native inverse prediction (mirror of
    ops/lossless_predict.reconstruct). Returns int32 [h, w] or None."""
    lib = get_lib()
    if lib is None:
        return None
    d = np.ascontiguousarray(diffs, dtype=np.int32)
    h, w = d.shape
    out = np.empty((h, w), dtype=np.int32)
    if lib.p14_reconstruct(d.reshape(-1), w, h, predictor, precision,
                           out.reshape(-1)) != 0:
        return None
    return out
