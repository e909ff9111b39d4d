"""The plain T.814 decoder (``htj2k_reference.py``): its own tables, its
refusals, and whole .201 frames of the program's encoder read back to
their samples; the module imports nothing of the program."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from bench_port import htj2k_reference as R

CPU = torch.device("cpu")


def test_the_module_imports_nothing_of_the_program():
    tree = ast.parse(open(R.__file__).read())
    names = {n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    names |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
              for a in n.names}
    assert names <= {"__future__", "base64", "typing", "numpy",
                     "j2k_reference"}


@pytest.mark.parametrize("table", [R.TABLE_C20, R.TABLE_C21],
                         ids=["C.20", "C.21"])
def test_each_contexts_codewords_are_prefix_free(table):
    """Within one context no codeword is the start of another, so the
    first match is the only one."""
    for cq in range(8):
        words = {(cwd, n) for tcq, _, _, _, _, cwd, n in table if tcq == cq}
        for a, na in words:
            for b, nb in words:
                if (a, na) != (b, nb) and na <= nb:
                    assert b & ((1 << na) - 1) != a


def test_malformed_segments_are_refused():
    with pytest.raises(R.StreamError):
        R.decode_cleanup(b"\x00", 4, 4, 5, 4)
    with pytest.raises(R.StreamError):       # Scup 1
        R.decode_cleanup(b"\x00\x00\x01\x00", 4, 4, 5, 4)
    with pytest.raises(R.StreamError):       # Scup past Lcup
        R.decode_cleanup(b"\x00\x00\x0f\x01", 4, 4, 5, 4)
    with pytest.raises(R.StreamError):       # Mb past 30
        R.decode_cleanup(b"\x00\x00\x02\x00", 4, 4, 31, 30)


def _frames(seed, n, size, levels):
    from go_dicom_codec_torch.codecs.jpeg2000 import (J2KEncodeParams,
                                                      J2KEncoder)
    rng = np.random.default_rng(seed)
    enc = J2KEncoder(J2KEncodeParams(num_levels=levels, htj2k=True,
                                     lossless=True, progression=0),
                     device=CPU)
    out = []
    for _ in range(n):
        walk = np.cumsum(rng.integers(-60, 61, (size, size)), axis=1)
        px = ((walk + rng.integers(0, 4096)) % 4096).astype(np.int32)
        out.append((enc.encode(px[..., None], size, size, 1, 12, False), px))
    return out


@pytest.mark.parametrize("size,levels", [(64, 3), (128, 5), (48, 5)])
def test_frames_read_back_to_their_samples(size, levels):
    for stream, px in _frames(size, 2, size, levels):
        np.testing.assert_array_equal(R.decode(stream), px)


def test_other_streams_are_refused():
    from go_dicom_codec_torch.codecs.jpeg2000 import (J2KEncodeParams,
                                                      J2KEncoder)
    px = np.zeros((16, 16, 1), np.int32)
    mq = J2KEncoder(J2KEncodeParams(num_levels=2, lossless=True),
                    device=CPU).encode(px, 16, 16, 1, 12, False)
    with pytest.raises(R.StreamError):
        R.decode(mq)
