"""The JPEG 2000 irreversible decode stage: dequantized float32
coefficients → multilevel inverse 9/7 → inverse ICT → round half to even
→ inverse DC shift → clip and narrow cast.

Counterpart of ``go_dicom_codec_tpu/pipeline.py:460-485``
(``_j2k_decode_device_stage_97``) with ``ops/dwt97.py:76-139``
(``inv97_multilevel``) and ``ops/mct.py:72-78`` (``ict_inverse``), which
XLA fuses into one program on the TPU. ``inv97_stage`` launches
``csrc/j2k97_inv_stage.cu`` once for a CUDA tensor of any line length
(the largest plane: ``_kernels.j2k97_inv_stage``), or raises; a CPU tensor
runs the plain version, ``inv97_stage_plain``.

The input is [B, C, H, W] (or [..., H, W] without the ICT), float32 (other
types are cast to float32 first). The epilogue returns:

- ``"coeffs"``: the float32 reconstruction of the 9/7 alone (the Part-2
  inverse matrices follow it in plain torch);
- ``"pixels"``: int32 samples: the inverse ICT of components 0-2 when
  ``mct`` is set and C >= 3 (components 3 and up pass through), round
  half to even, saturating as the reference's cast (``ops/convert.py``),
  then + 2^(bits-1) unless ``signed``, in wrapping int32;
- ``"narrow"``: those samples clipped to the declared ``bits``-bit range
  (a lossy reconstruction overshoots it by a few codes, and an unclipped
  -1 would wrap to 65535) and cast to uint16, or int16 when ``signed``.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .convert import round_to_int32_sat
from .dwt97 import inv97_multilevel_plain, inv97_schedule
from .j2k_inv_stage import EPILOGUES, narrow_pixels
from .mct import ict_inverse, inv_dc_level_shift


def _ict(x: torch.Tensor, mct: bool) -> bool:
    """True when the stage runs the ICT on [B, C, H, W] ``x``."""
    return mct and x.dim() == 4 and x.shape[1] >= 3


def _epilogue(rec: torch.Tensor, bits: int, signed: bool, mct: bool,
              epilogue: str) -> torch.Tensor:
    if epilogue == "coeffs":
        return rec
    if _ict(rec, mct):
        rgb = torch.stack(ict_inverse(rec[:, 0], rec[:, 1], rec[:, 2]),
                          dim=1)
        rec = torch.cat([rgb, rec[:, 3:]], dim=1)
    px = inv_dc_level_shift(round_to_int32_sat(rec), bits, signed)
    return narrow_pixels(px, bits, signed) if epilogue == "narrow" else px


def inv97_stage_plain(x: torch.Tensor, levels: int, x0: int = 0,
                      y0: int = 0, bits: int = 16, signed: bool = False,
                      mct: bool = False,
                      epilogue: str = "pixels") -> torch.Tensor:
    """The stage in plain torch on x's device: the kernel's reference."""
    rec = inv97_multilevel_plain(x, levels, x0, y0)
    return _epilogue(rec, bits, signed, mct, epilogue)


def inv97_stage(x: torch.Tensor, levels: int, x0: int = 0, y0: int = 0,
                bits: int = 16, signed: bool = False, mct: bool = False,
                epilogue: str = "pixels") -> torch.Tensor:
    """Dequantized coefficients [B, C, H, W] at origin (x0, y0) →
    ``levels`` of inverse 9/7 → the ``epilogue``'s output (see the module
    note). The input is left as it was.

    The kernel for a CUDA tensor, the plain version for a CPU tensor; any
    other device raises.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"9/7 inverse stage: no epilogue {epilogue!r}")
    if x.device.type == "cpu":
        return inv97_stage_plain(x, levels, x0, y0, bits, signed, mct,
                                 epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"9/7 inverse stage: no lane for device {x.device}")
    return _inv97_stage_kernel(x, levels, x0, y0, bits, signed, mct,
                               epilogue)


def _inv97_stage_kernel(x: torch.Tensor, levels: int, x0: int = 0,
                        y0: int = 0, bits: int = 16, signed: bool = False,
                        mct: bool = False,
                        epilogue: str = "pixels") -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    src = x.to(torch.float32).contiguous().view(-1, h, w)
    comps = x.shape[1] if _ict(x, mct) else 1
    dtype = {"coeffs": torch.float32, "pixels": torch.int32,
             "narrow": torch.int16 if signed else torch.uint16}[epilogue]
    out = torch.empty(src.shape, dtype=dtype, device=x.device)
    if src.numel():
        ict = comps >= 3 and epilogue != "coeffs"
        _kernels.j2k97_inv_stage(src, out, inv97_schedule(
            w, h, levels, x0, y0, src.shape[0],
            warps=_kernels.j2k97_inv_warps(src, ict), comps=comps, ict=ict),
            comps, epilogue, mct, bits, signed)
    return out.view(x.shape)
