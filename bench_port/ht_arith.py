"""The bytes of the HT cleanup kernel's roofline (``j2k_ht_decode_roofline``),
counted from the configuration alone, so that a later change to the
kernel cannot change what they count.

The run's record holds the frames decoded and the kernel's device time,
not the codestreams' sizes, so the count is the kernel's output alone:
each coefficient of a frame written once, at the width the kernel writes
it (ops/j2k_ht_decode.py: int16 where every band's Mb is 15 or less,
else int32). The cleanup bytes it reads are left out.
"""

from __future__ import annotations

NARROW_MB = 15   # the kernel writes int16 up to this Mb


def largest_mb(bits_stored: int, guard_bits: int) -> int:
    """Mb of the reversible 5/3's HH band (T.800 E.1, Table E.1): the
    guard bits, the samples' bits and the band's gain of 2, less one."""
    return guard_bits + bits_stored + 2 - 1


def coeff_bytes(bits_stored: int, guard_bits: int) -> int:
    """Bytes of one coefficient as the kernel writes it."""
    return 2 if largest_mb(bits_stored, guard_bits) <= NARROW_MB else 4


def guard_bits(cfg: dict) -> int:
    """The guard bits the configuration's codestreams carry: what the
    syntax writes (``codestream``) where it says, else the parameters'."""
    return int(cfg.get("codestream", {}).get("guard bits",
                                             cfg["parameters"]["guard_bits"]))


def bytes_per_frame(cfg: dict) -> int:
    """Bytes the HT kernel writes for one frame of ``cfg``."""
    f = cfg["frame"]
    n = f["rows"] * f["columns"] * f["samples_per_pixel"]
    return n * coeff_bytes(f["bits_stored"], guard_bits(cfg))
