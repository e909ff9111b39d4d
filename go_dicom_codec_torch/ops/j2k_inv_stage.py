"""The JPEG 2000 reversible decode stage: packed 5/3 coefficients →
multilevel inverse 5/3 → inverse RCT → inverse DC shift → clip and narrow
cast.

Counterpart of ``go_dicom_codec_tpu/pipeline.py:433-457``
(``_j2k_decode_device_stage``) and ``ops/dwt53.py:315``
(``inv53_multilevel``), which XLA fuses into one program on the TPU.
``inv_stage`` launches ``csrc/j2k_inv_stage.cu`` once for a CUDA tensor
of any line length (the largest plane: ``_kernels.j2k_inv_stage``), or
raises; a CPU tensor runs the plain version, ``inv_stage_plain``.

The input is [B, C, H, W] (or [..., H, W] without the RCT), int16 or
int32 (other types are cast to int32 first). The epilogue returns:

- ``"coeffs"``: the int32 reconstruction of the 5/3 alone;
- ``"pixels"``: int32 samples: the inverse RCT of components 0-2 when
  ``mct`` is set and C >= 3 (components 3 and up pass through), then
  + 2^(bits-1) unless ``signed``, all in wrapping int32;
- ``"narrow"``: those samples clipped to the declared ``bits``-bit range
  (the identity for conformant streams; it stops hostile coefficients
  from wrapping through the cast) and cast to uint16, or int16 when
  ``signed``. The clip runs in int32: torch has no uint16 arithmetic.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .dwt53 import inv53_multilevel_plain_, inv_schedule
from .mct import inv_dc_level_shift, rct_inverse

EPILOGUES = ("coeffs", "pixels", "narrow")


def narrow_pixels(px: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """int32 samples clipped to the ``bits``-bit range, as int16/uint16."""
    lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
              else (0, (1 << bits) - 1))
    return px.clamp(lo, hi).to(torch.int16 if signed else torch.uint16)


def _widened(x: torch.Tensor) -> torch.Tensor:
    """x as int32 in a new contiguous tensor the transform may overwrite."""
    return x.to(torch.int32, copy=True, memory_format=torch.contiguous_format)


def _epilogue(rec: torch.Tensor, bits: int, signed: bool, mct: bool,
              epilogue: str) -> torch.Tensor:
    if epilogue == "coeffs":
        return rec
    if mct and rec.dim() == 4 and rec.shape[1] >= 3:
        rgb = torch.stack(rct_inverse(rec[:, 0], rec[:, 1], rec[:, 2]),
                          dim=1)
        rec = torch.cat([rgb, rec[:, 3:]], dim=1)
    px = inv_dc_level_shift(rec, bits, signed)
    return narrow_pixels(px, bits, signed) if epilogue == "narrow" else px


def inv_stage_plain(x: torch.Tensor, levels: int, x0: int = 0, y0: int = 0,
                    bits: int = 16, signed: bool = False, mct: bool = False,
                    epilogue: str = "pixels") -> torch.Tensor:
    """The stage in plain torch on x's device: the kernel's reference."""
    rec = inv53_multilevel_plain_(_widened(x), levels, x0, y0)
    return _epilogue(rec, bits, signed, mct, epilogue)


def inv_stage(x: torch.Tensor, levels: int, x0: int = 0, y0: int = 0,
              bits: int = 16, signed: bool = False, mct: bool = False,
              epilogue: str = "pixels") -> torch.Tensor:
    """Packed coefficients [B, C, H, W] at origin (x0, y0) → ``levels`` of
    inverse 5/3 → the ``epilogue``'s output (see the module note). The
    input is left as it was.

    The kernel for a CUDA tensor, the plain version for a CPU tensor; any
    other device raises.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"inverse stage: no epilogue {epilogue!r}")
    if x.device.type == "cpu":
        return inv_stage_plain(x, levels, x0, y0, bits, signed, mct,
                               epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"inverse stage: no lane for device {x.device}")
    return _inv_stage_kernel(x, levels, x0, y0, bits, signed, mct, epilogue)


def _inv_stage_kernel(x: torch.Tensor, levels: int, x0: int = 0, y0: int = 0,
                      bits: int = 16, signed: bool = False,
                      mct: bool = False,
                      epilogue: str = "pixels") -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    sched = inv_schedule(w, h, levels, x0, y0)
    if x.dtype not in _kernels.INV_STAGE_DTYPES:
        x = x.to(torch.int32)
    src = x.contiguous().view(-1, h, w)
    comps = x.shape[1] if mct and x.dim() == 4 else 1
    dtype = ((torch.int16 if signed else torch.uint16)
             if epilogue == "narrow" else torch.int32)
    out = torch.empty(src.shape, dtype=dtype, device=x.device)
    _kernels.j2k_inv_stage(src, out, sched, comps, epilogue, mct, bits,
                           signed)
    return out.view(x.shape)
