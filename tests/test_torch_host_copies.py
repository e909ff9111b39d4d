"""The port's host half is a set of byte-for-byte copies of the reference.

The JAX package is frozen, so a copy cannot drift; its sha256 must equal
its original's. Every file of the port that has a namesake in the
reference is either such a copy (``VERBATIM``) or a port (``PORTED``),
and the two lists say which.
"""

import hashlib
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "go_dicom_codec_tpu"
PORT = ROOT / "go_dicom_codec_torch"

# the files copied byte for byte (paths relative to each package)
VERBATIM = (
    "errors.py", "frames.py", "params.py", "uids.py", "registry.py",
    "codestream/__init__.py", "codestream/j2k.py",
    "entropy/__init__.py", "entropy/mq.py", "entropy/ebcot.py",
    "entropy/htcleanup.py", "entropy/htrefine.py",
    "t2/__init__.py", "t2/bitio.py", "t2/tagtree.py", "t2/packets.py",
    "t2/pcrd.py",
    "codecs/ht_tables.py", "codecs/j2k_geometry.py", "codecs/j2k_quant.py",
    "codecs/j2k_roi.py", "codecs/mct_builder.py",
    "utils/__init__.py",
    "native/__init__.py", "native/ebcot_native.cpp",
)

# the port's files whose namesakes differ: rewritten in torch, or (the
# profiling module) a copy less its jax trace hook
PORTED = (
    "__init__.py", "pipeline.py", "codecs/__init__.py",
    "codecs/jpeg2000.py", "codecs/j2k_adapters.py", "utils/profiling.py",
    "ops/__init__.py", "ops/blockstats.py", "ops/dct8x8.py",
    "ops/dwt53.py", "ops/dwt97.py", "ops/mct.py",
    "tools/__init__.py", "tools/device_bench.py",
)


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_matches_original(rel):
    assert _sha(PORT / rel) == _sha(REF / rel), rel


def test_lists_cover_every_namesake():
    namesakes = sorted(
        str(p.relative_to(PORT)) for p in PORT.rglob("*")
        if p.suffix in (".py", ".cpp") and (REF / p.relative_to(PORT))
        .is_file())
    assert sorted(VERBATIM + PORTED) == namesakes
    for rel in PORTED:
        assert _sha(PORT / rel) != _sha(REF / rel), rel


def test_port_sources_never_import_jax():
    banned = re.compile(r"^\s*(import|from)\s+(jax|go_dicom_codec_tpu)\b",
                        re.M)
    for p in PORT.rglob("*.py"):
        assert not banned.search(p.read_text()), p
