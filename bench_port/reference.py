"""The plain reference that decides ``correct``.

A lossless codec's guarantee is that a decode gives back, sample for
sample, the frames that were encoded. The reference of a decode is
therefore the benchmark's own frames (``phantom``), and a decoded frame is
judged by comparing it with them. An encoded frame is judged by decoding
it with the plain decoder of ``j2k_reference`` and comparing that with the
frame the encode was given. Nothing here imports the program or takes
anything it made but the outputs under judgement.
"""

from __future__ import annotations

import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np


def compare_frames(outputs: Iterable[Tuple[Sequence[bytes], np.ndarray]]
                   ) -> dict:
    """Judge decoded frames against the frames they should equal.

    ``outputs`` yields (the frames a call returned, as raw little-endian
    bytes; the reference frames of that call, [frames, rows, columns]).
    Returns the frames checked, the frames missing or of the wrong size,
    the samples that differ and the largest difference.
    """
    checked = missing = mismatched = 0
    worst = 0
    for got, want in outputs:
        want = np.asarray(want)
        missing += max(0, len(want) - len(got))
        for frame, ref in zip(got, want):
            arr = np.frombuffer(frame, dtype=ref.dtype.newbyteorder("<"))
            if arr.size != ref.size:
                missing += 1
                continue
            diff = np.abs(arr.astype(np.int64)
                          - ref.reshape(-1).astype(np.int64))
            mismatched += int(np.count_nonzero(diff))
            worst = max(worst, int(diff.max(initial=0)))
            checked += 1
    return {"frames_checked": checked, "frames_missing": missing,
            "mismatched_samples": mismatched, "max_abs_diff": worst}


def _decode_one(stream: bytes):
    """The plain decoder's samples of one codestream, or its refusal."""
    from . import j2k_reference
    try:
        return j2k_reference.decode(stream)
    except (j2k_reference.StreamError, IndexError) as exc:
        return f"{type(exc).__name__}: {exc}"


def compare_encoded(items: Sequence[Tuple[Optional[bytes], np.ndarray]],
                    workers: int = 1) -> dict:
    """Judge encoded frames: ``items`` holds (a codestream the program
    made, or None where it made none; the frame it was given). Each stream
    is decoded by the plain decoder, ``workers`` processes at a time, and
    compared with its frame. A stream that is missing or that the plain
    decoder refuses counts as missing."""
    streams = [s for s, _ in items if s is not None]
    if workers > 1 and len(streams) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, len(streams)),
                                 mp_context=ctx) as pool:
            frames = list(pool.map(_decode_one, streams))
    else:
        frames = [_decode_one(s) for s in streams]
    decoded, missing = [], 0
    it = iter(frames)
    for stream, want in items:
        frame = next(it) if stream is not None else "no codestream"
        if isinstance(frame, str):
            missing += 1
            print(f"reference: a stream unreadable: {frame}",
                  file=sys.stderr)
            continue
        want = np.asarray(want)
        decoded.append(([frame.astype(want.dtype.newbyteorder("<"))
                         .tobytes()], want[None]))
    found = compare_frames(decoded)
    found["frames_missing"] += missing
    return found


def encode_picks(seed: int, clients: int, objects: int, frames: int,
                 per_client: int) -> list:
    """Which encoded frames the plain decoder judges: (client, object,
    frame). The frames of a call are cut into clients x per_client strata
    of consecutive positions, and each stratum gives one frame, drawn from
    the seed, to a client drawn from the seed; a client's picks take its
    objects in turn. So every run judges every stretch of a call's frames
    (every chunk of the pipeline, for chunks of at least
    frames / strata frames) and every client."""
    rng = np.random.default_rng([int(seed), 4])
    n = clients * per_client
    owner = rng.permutation(np.repeat(np.arange(clients), per_client))
    picks, taken = [], [0] * clients
    for s in range(n):
        lo, hi = s * frames // n, (s + 1) * frames // n
        frame = int(rng.integers(lo, hi)) if hi > lo else s % frames
        c = int(owner[s])
        picks.append((c, taken[c] % objects, frame))
        taken[c] += 1
    return picks


def header_mismatches(stream: bytes, cfg: dict) -> list:
    """How a codestream's SIZ, COD and QCD differ from the configuration's
    frame and coding parameters: a list of "what: read, expected"."""
    from . import j2k_reference
    try:
        hdr, _ = j2k_reference.main_header(stream)
    except (j2k_reference.StreamError, IndexError) as exc:
        return [f"unreadable: {exc}"]
    absent = [m for m, key in (("SIZ", "size"), ("COD", "levels"),
                               ("QCD", "guard")) if key not in hdr]
    if absent:
        return [f"no {m}" for m in absent]
    frame, p = cfg["frame"], cfg["parameters"]
    size = hdr["size"]
    tile_w = p["tile_width"] or frame["columns"]
    tile_h = p["tile_height"] or frame["rows"]
    want = {
        "image": ([frame["columns"], frame["rows"], 0, 0],
                  size[0:4]),
        "tile covers": (True, size[4] >= tile_w and size[5] >= tile_h),
        "bits": (frame["bits_stored"], hdr["bits"]),
        "signed": (bool(frame["signed"]), hdr["signed"]),
        "levels": (p["num_levels"], hdr["levels"]),
        "code-block": ([p["cb_width"], p["cb_height"]],
                       [1 << e for e in hdr["cb"]]),
        "progression": (p["progression"], hdr["progression"]),
        "layers": (p["num_layers"], hdr["layers"]),
        "code-block style": (p["cb_style"], hdr["cb_style"]),
        "guard bits": (p["guard_bits"], hdr["guard"]),
        "precincts": (False, hdr["precincts"]),
        "reversible 5/3": (1, hdr["transform"]),
    }
    # a configuration may state what its syntax adds to the parameters,
    # such as the HT code-block style bit of HTJ2K
    for k, exp in cfg.get("codestream", {}).items():
        want[k] = (exp, want[k][1])
    return [f"{k}: {got}, expected {exp}" for k, (exp, got) in want.items()
            if exp != got]


# A lossless transfer syntax guarantees equal samples: every number is
# exact, so each limit is 0.
LOSSLESS_LIMITS = {"frames_missing": 0, "mismatched_samples": 0,
                   "max_abs_diff": 0}


def verdict(found: dict, limits: dict, failed_calls: int
            ) -> Tuple[bool, dict]:
    """``correct`` and {name: {"value", "limit"}} for each number that
    has a limit: a number above its limit, a failed call, or nothing
    checked makes the run not correct."""
    checks = {name: {"value": found[name], "limit": limit}
              for name, limit in limits.items()}
    checks["failed_calls"] = {"value": failed_calls, "limit": 0}
    ok = (found.get("frames_checked", 0) > 0
          and all(c["value"] <= c["limit"] for c in checks.values()))
    return ok, checks

