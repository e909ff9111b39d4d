"""The JPEG 2000 irreversible forward stage: samples → DC shift in int32
→ float32 → ICT of RGB → multilevel forward 9/7 → float32 packed
coefficients (not quantized: the deadzone quantizer runs on the host, as
in the reference).

Counterpart of ``go_dicom_codec_tpu/codecs/jpeg2000.py:699-704`` (the
lossy branch of the tile transform) with ``ops/mct.py:14-18, 57-69``
(``dc_level_shift``, ``ict_forward``) and ``ops/dwt97.py:60-127``
(``fwd97_multilevel``), which XLA fuses into one program on the TPU.
``fwd97_stage`` launches ``csrc/j2k97_fwd_stage.cu`` once for a CUDA
tensor of any line length, or raises; a CPU tensor runs the plain version,
``fwd97_stage_plain``.

Integer samples are less ``shift`` in wrapping int32, then float32 (round
to nearest). Float samples (the Part-2 path: shifted and matrixed
already) are taken as they are, with ``shift`` 0. With ``mct`` the input
is [B, C, H, W] and components 0-2 of each frame pass through the ICT
(components 3 and up do not).
"""

from __future__ import annotations

import torch

from .. import _kernels
from .dwt97 import fwd97_multilevel_plain, fwd97_schedule
from .j2k97_inv_stage import _ict
from .mct import ict_forward


def _check_shift(x: torch.Tensor, shift: int) -> None:
    if x.is_floating_point() and shift:
        raise ValueError("9/7 forward stage: float samples take no shift")


def _shifted(x: torch.Tensor, shift: int, mct: bool) -> torch.Tensor:
    """x less ``shift`` in int32 as float32 (a float x as float32), then
    the ICT of components 0-2 with ``mct``."""
    s = (x.to(torch.float32) if x.is_floating_point()
         else (x.to(torch.int32) - shift).to(torch.float32))
    if _ict(s, mct):
        ycc = torch.stack(ict_forward(s[:, 0], s[:, 1], s[:, 2]), dim=1)
        s = torch.cat([ycc, s[:, 3:]], dim=1)
    return s


def fwd97_stage_plain(x: torch.Tensor, shift: int, levels: int, x0: int = 0,
                      y0: int = 0, mct: bool = False) -> torch.Tensor:
    """The stage in plain torch on x's device: the kernel's reference."""
    _check_shift(x, shift)
    return fwd97_multilevel_plain(_shifted(x, shift, mct), levels, x0, y0)


def fwd97_stage(x: torch.Tensor, shift: int, levels: int, x0: int = 0,
                y0: int = 0, mct: bool = False) -> torch.Tensor:
    """[..., H, W] samples → ``x - shift`` → float32 → with ``mct`` the ICT
    of components 0-2 of [B, C, H, W] → ``levels`` of forward 9/7 at
    origin (x0, y0) → float32 packed coefficients of x's shape.

    The kernel for a CUDA tensor, the plain version for a CPU tensor; any
    other device raises.
    """
    if x.device.type == "cpu":
        return fwd97_stage_plain(x, shift, levels, x0, y0, mct)
    if x.device.type != "cuda":
        raise ValueError(f"9/7 forward stage: no lane for device {x.device}")
    return _fwd97_stage_kernel(x, shift, levels, x0, y0, mct)


def _fwd97_stage_kernel(x: torch.Tensor, shift: int, levels: int,
                        x0: int = 0, y0: int = 0,
                        mct: bool = False) -> torch.Tensor:
    _check_shift(x, shift)
    h, w = x.shape[-2], x.shape[-1]
    if x.is_floating_point():
        x = x.to(torch.float32)
    elif x.dtype not in _kernels.FWD97_STAGE_DTYPES:
        x = x.to(torch.int32)
    src = x.contiguous().view(-1, h, w)
    comps = x.shape[1] if _ict(x, mct) else 1
    out = torch.empty(src.shape, dtype=torch.float32, device=x.device)
    if src.numel():
        ict = comps >= 3
        _kernels.j2k97_fwd_stage(src, out, fwd97_schedule(
            w, h, levels, x0, y0, src.shape[0],
            warps=_kernels.j2k97_fwd_warps(src, ict), comps=comps, ict=ict),
            shift, comps, ict)
    return out.view(x.shape)
