"""HTJ2K (ITU-T T.814) cleanup-pass decode of a chunk's HT code-blocks,
into the chunk's packed coefficients.

Replaces no TPU kernel: the JAX package decodes HT code-blocks on the
host, in its native coder (``native/ebcot_native.cpp``,
``ht_cleanup_decode_impl``). ``ht_decode`` launches
``csrc/j2k_ht_decode.cu`` once for a plan on a CUDA device, or raises; a
plan on the CPU runs the plain version, ``ht_decode_plain``: the native
batched decode (``native.ht_cleanup_decode_blocks_native``) and the
plan's paste.

A plan is one uint8 buffer, so that it goes up in one copy:

- the records, int32 [n, ``RECORD``], one a code-block, sorted by work
  (quads, then bytes), largest first: the offset and length (Lcup) of its
  cleanup segment, w, h, kmax (the band's Mb) and missing (its missing
  MSBs) as the native decoder takes them, Scup (the MEL and VLC bytes at
  the segment's end, from its last two bytes), and where it lands: plane,
  row and column of the packed [planes, th, tw] output;
- the cleanup segments, one after the other.

A segment that T.814 forbids (Lcup or Scup under 2, Scup over Lcup or
over 4079) or a missing count outside 0-29 is refused here, as is a
block outside the output. The output is zero where no block lands; it is
int16 when every block's kmax is 15 or less, so every coefficient fits,
else int32. The decode's status is one int32: non-zero where a block's
stream broke T.814's bound on a quad's magnitude exponent (U_q), the
native decoder's stream error -3.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _kernels

RECORD = _kernels.HT_RECORD
(OFF, LEN, W, H, KMAX, MISSING, SCUP, PLANE, ROW, COL) = range(RECORD)
MAX_KMAX = 30       # the native decoder's 31-bit fixed point, and the kernel's
NARROW_KMAX = 15    # every coefficient of such a block fits int16
MAX_SCUP = 4079     # T.814: Scup of at most 4079 bytes


class HTLaunch(NamedTuple):
    """What a launch needs besides the plan's bytes."""
    blocks: int
    data_at: int      # byte offset of the cleanup segments
    shape: tuple      # (planes, th, tw) of the output
    narrow: bool      # int16 output
    max_words: int    # the most 32-bit words of shared memory a block takes


class HTPlan(NamedTuple):
    buf: np.ndarray   # uint8
    launch: HTLaunch


def block_words(w, h, lcup, scup):
    """32-bit words of shared memory one code-block takes in the kernel:
    its MEL and VLC bytes, one word a quad (its VLC entry and u), the
    unstuffed MagSgn bits (no more than the quads' 4 × 31 bits can read,
    at 7 bits a byte), two rows of the bottom samples' exponents and
    one spare word."""
    w, h = np.asarray(w, np.int64), np.asarray(h, np.int64)
    quads = ((w + 1) // 2) * ((h + 1) // 2)
    ms_bytes = np.minimum(np.asarray(lcup, np.int64) - scup,
                          quads * 4 * 31 // 7 + 8)
    return ((np.asarray(scup, np.int64) + 3) // 4 + quads
            + (ms_bytes + 3) // 4 + 2 + 2 * (2 * ((w + 1) // 2) + 2) + 1)


def make_plan(blocks: Sequence[tuple], shape) -> HTPlan:
    """The plan of ``blocks``: (cleanup segment, w, h, kmax, missing,
    plane, row, col) each, every one a kmax of 1 to ``MAX_KMAX``, landing
    inside ``shape`` (planes, th, tw). A block outside those limits, or
    whose segment T.814 forbids, is refused."""
    planes, th, tw = shape
    n = len(blocks)
    cols = list(zip(*blocks)) if n else [()] * 8
    rec = np.zeros((n, RECORD), dtype=np.int64)
    for field, col in ((W, 1), (H, 2), (KMAX, 3), (MISSING, 4), (PLANE, 5),
                       (ROW, 6), (COL, 7)):
        rec[:, field] = cols[col]
    rec[:, LEN] = [len(b) for b in cols[0]]
    rec[:, SCUP] = [(b[-1] << 4) | (b[-2] & 0x0F) if len(b) >= 2 else 0
                    for b in cols[0]]
    rec[:, OFF] = np.cumsum(rec[:, LEN]) - rec[:, LEN]
    w, h, lcup, scup = rec[:, W], rec[:, H], rec[:, LEN], rec[:, SCUP]
    if n and ((w < 1) | (h < 1) | (w > 1024) | (h > 1024) | (w * h > 4096)
              | (rec[:, KMAX] < 1) | (rec[:, KMAX] > MAX_KMAX)
              | (rec[:, PLANE] < 0) | (rec[:, PLANE] >= planes)
              | (rec[:, ROW] < 0) | (rec[:, ROW] + h > th) | (rec[:, COL] < 0)
              | (rec[:, COL] + w > tw)).any():
        raise _kernels.KernelLaunchError("j2k_ht_decode: a code-block "
                                         "outside the plan's limits")
    if n and ((lcup < 2) | (scup < 2) | (scup > lcup) | (scup > MAX_SCUP)
              | (rec[:, MISSING] < 0) | (rec[:, MISSING] > 29)).any():
        raise _kernels.KernelLaunchError("j2k_ht_decode: a malformed HT "
                                         "cleanup segment")
    data = b"".join(cols[0])
    if len(data) + 4 * n * RECORD > _kernels.INT32_MAX:
        raise _kernels.KernelLaunchError("j2k_ht_decode: a plan past int32 "
                                         "offsets")
    quads = ((w + 1) // 2) * ((h + 1) // 2)
    rec = rec[np.lexsort((-lcup, -quads))]
    data_at = 4 * n * RECORD
    buf = np.empty(data_at + len(data), dtype=np.uint8)
    buf[:data_at] = rec.astype("<i4").view(np.uint8).ravel()
    buf[data_at:] = np.frombuffer(data, dtype=np.uint8)
    words = block_words(rec[:, W], rec[:, H], rec[:, LEN], rec[:, SCUP])
    launch = HTLaunch(
        blocks=n, data_at=data_at, shape=(int(planes), int(th), int(tw)),
        narrow=bool(n == 0 or rec[:, KMAX].max() <= NARROW_KMAX),
        max_words=int(words.max()) if n else 0)
    return HTPlan(buf, launch)


def chunk_plan(frames: Sequence[Sequence[tuple]], shape) -> HTPlan:
    """The plan of a chunk: ``frames``, each frame's code-blocks as
    ``codecs.jpeg2000.ht_blocks`` gives them, their component in place of
    the plane, every frame's packed array of ``shape`` (C, th, tw);
    component c of frame f lands on plane f·C + c."""
    comps = shape[0]
    blocks = [b[:5] + (f * comps + b[5],) + b[6:]
              for f, bl in enumerate(frames) for b in bl]
    return make_plan(blocks, (len(frames) * comps,) + tuple(shape[1:]))


def records(buf: np.ndarray, launch: HTLaunch):
    """The records and the segments of a plan's buffer."""
    rec = buf[:launch.data_at].view("<i4").reshape(launch.blocks, RECORD)
    return rec, buf[launch.data_at:]


def ht_decode_plain(buf: torch.Tensor, launch: HTLaunch):
    """The plan in ``buf`` (a uint8 CPU tensor) decoded by the native
    batched HT decoder (the Python one without the native library) and
    pasted by the plan: the kernel's reference. Returns (coefficients,
    status), status int32 [1], 1 where a block's stream failed."""
    from ..entropy.htcleanup import HTCleanupDecoder
    from ..errors import CorruptStreamError
    from ..native import ht_cleanup_decode_blocks_native

    rec, data = records(buf.numpy(), launch)
    out = np.zeros(launch.shape,
                   dtype=np.int16 if launch.narrow else np.int32)
    status = np.zeros(1, dtype=np.int32)
    items = [(data[r[OFF]:r[OFF] + r[LEN]].tobytes(), int(r[W]), int(r[H]),
              int(r[KMAX]), int(r[MISSING])) for r in rec]
    got = ht_cleanup_decode_blocks_native(items) if items else []
    for r, item, blk in zip(rec, items, got or [None] * len(items)):
        if blk is None:
            try:
                blk = HTCleanupDecoder(*item[1:]).decode(item[0])
            except CorruptStreamError:
                blk = ("corrupt", -3)
        if isinstance(blk, tuple):
            status[0] = 1
            continue
        w, h = item[1], item[2]
        out[r[PLANE], r[ROW]:r[ROW] + h, r[COL]:r[COL] + w] = blk
    return torch.from_numpy(out), torch.from_numpy(status)


def ht_decode(buf: torch.Tensor, launch: HTLaunch):
    """The packed coefficients [planes, th, tw] of the plan in ``buf`` (a
    uint8 tensor) and the decode's status (int32 [1], non-zero where a
    block's stream failed). The kernel for a CUDA tensor, the plain
    version for a CPU tensor; any other device raises."""
    if buf.device.type == "cpu":
        return ht_decode_plain(buf, launch)
    if buf.device.type != "cuda":
        raise ValueError(f"HT decode: no lane for device {buf.device}")
    out = torch.empty(launch.shape, device=buf.device,
                      dtype=torch.int16 if launch.narrow else torch.int32)
    status = torch.empty(1, device=buf.device, dtype=torch.int32)
    _kernels.j2k_ht_decode(buf, out, status, launch)
    return out, status
