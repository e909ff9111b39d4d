"""JPEG Lossless (Process 14) prediction, batched.

Predictor formulas of reference jpeg/lossless/predictors.go:12-54 with
the STRICT T.81 H.1.2.2 boundary rules (round 5): the first sample is
predicted as 2^(P-1); the rest of the first line uses Ra regardless of
the selected predictor; the first sample of every other line uses Rb;
interior samples use the selected formula over real neighbors.
Differences wrap to int16, reconstruction wraps to [0, 2^P).

The reference instead substitutes 2^(P-1) for out-of-bounds neighbors
and applies the selected formula everywhere (encoder.go:219-282, with
a predictor-1 first-column exception) — a conformance bug that makes
its predictor-2..7 streams mis-decode the first row/column in
T.81-conformant decoders (SURVEY §7 "anomalies: don't replicate").
Predictor 1 coincides with the standard under both rule sets, so the
fo-dicom SV1 golden and every predictor-1 stream are byte-identical
across this change; spec-direct vectors in
tests/test_spec_direct_vectors.py pin the conformant behavior.

The encode direction is embarrassingly parallel: Ra/Rb/Rc are whole-plane
shifts, so diffs for a full [H, W] plane (or a batch) are one vector
expression. Decode is a 2D recurrence: predictors 1-5 reduce to per-row
cumsums / previous-row vector ops; 6-7 are true scans (scalar inner loop).
"""

from __future__ import annotations

import numpy as np


def _predict(p: int, ra, rb, rc):
    """Predictor formulas (predictors.go:12-54); numpy-elementwise."""
    if p == 1:
        return ra
    if p == 2:
        return rb
    if p == 3:
        return rc
    if p == 4:
        return ra + rb - rc
    if p == 5:
        return ra + ((rb - rc) >> 1)
    if p == 6:
        return rb + ((ra - rc) >> 1)
    if p == 7:
        return (ra + rb) >> 1
    return ra


def encode_diffs(plane: np.ndarray, predictor: int, precision: int
                 ) -> np.ndarray:
    """[H, W] samples → int16-wrapped prediction differences
    (T.81 H.1.2.2 boundary rules; see the module docstring)."""
    s = plane.astype(np.int64)
    h, w = s.shape
    default = 1 << (precision - 1)

    pred = np.empty_like(s)
    pred[0, 0] = default
    pred[0, 1:] = s[0, :-1]          # first line: Px = Ra
    if h > 1:
        pred[1:, 0] = s[:-1, 0]      # first column: Px = Rb
        pred[1:, 1:] = _predict(predictor, s[1:, :-1], s[:-1, 1:],
                                s[:-1, :-1])
    diff = s - pred
    return ((diff + 0x8000) & 0xFFFF).astype(np.int64) - 0x8000


def reconstruct(diffs: np.ndarray, predictor: int, precision: int
                ) -> np.ndarray:
    """Inverse of encode_diffs: [H, W] diffs → samples in [0, 2^P).

    Mirrors decoder.go:210-336 with per-row vectorization where the
    recurrence allows (predictors 1-5) and a scalar scan for 6-7.
    """
    d = diffs.astype(np.int64)
    h, w = d.shape
    default = 1 << (precision - 1)
    mod = 1 << precision
    s = np.zeros((h, w), dtype=np.int64)

    # first line: Px = Ra for every predictor (T.81 H.1.2.2) — one
    # left-to-right chain from the 2^(P-1) start
    s[0, :] = (default + np.cumsum(d[0, :])) % mod

    for r in range(1, h):
        above = s[r - 1]
        # first column: Px = Rb for every predictor
        s[r, 0] = (above[0] + d[r, 0]) % mod
        if w == 1:
            continue

        if predictor == 1:
            s[r, 1:] = (s[r, 0] + np.cumsum(d[r, 1:])) % mod
        elif predictor == 2:
            s[r, 1:] = (above[1:] + d[r, 1:]) % mod
        elif predictor == 3:
            s[r, 1:] = (above[:-1] + d[r, 1:]) % mod
        elif predictor == 4:
            inc = d[r, 1:] + above[1:] - above[:-1]
            s[r, 1:] = (s[r, 0] + np.cumsum(inc)) % mod
        elif predictor == 5:
            inc = d[r, 1:] + ((above[1:] - above[:-1]) >> 1)
            s[r, 1:] = (s[r, 0] + np.cumsum(inc)) % mod
        elif predictor == 6:
            for c in range(1, w):
                pred = above[c] + ((s[r, c - 1] - above[c - 1]) >> 1)
                s[r, c] = (pred + d[r, c]) % mod
        else:  # 7
            for c in range(1, w):
                pred = (s[r, c - 1] + above[c]) >> 1
                s[r, c] = (pred + d[r, c]) % mod
    return s


def select_best_predictor(planes, width: int, height: int) -> int:
    """Lowest prediction-error variance wins (predictors.go:80-96).

    Uses zero-valued out-of-bounds neighbors like the reference's variance
    scan (predictors.go:101-133), which differs from the scan's
    default-value rule — reproduced as-is since it only picks a predictor.
    """
    best, best_var = 1, None
    for p in range(1, 8):
        total = 0
        count = 0
        for plane in planes:
            s = plane.astype(np.int64)
            ra = np.zeros_like(s)
            ra[:, 1:] = s[:, :-1]
            rb = np.zeros_like(s)
            rb[1:, :] = s[:-1, :]
            rc = np.zeros_like(s)
            rc[1:, 1:] = s[:-1, :-1]
            diff = s - _predict(p, ra, rb, rc)
            total += int((diff * diff).sum())
            count += s.size
        var = total // count if count else 0
        if best_var is None or var < best_var:
            best, best_var = p, var
    return best
