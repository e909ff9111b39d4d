"""The JPEG 2000 lossless forward stage: widen → DC shift → RCT of RGB →
multilevel 5/3 → epilogue.

Counterpart of ``go_dicom_codec_tpu/pipeline.py:22-33``
(``j2k_lossless_encode_transform``), ``:43-52``
(``_pipeline_device_stage``), the RGB stages ``:56-63`` and ``:368-376``
and ``ops/dwt53.py:276`` (``fwd53_multilevel``), which XLA fuses into one
program on the TPU. With ``mct`` the input is [B, C, H, W] and components
0-2 of each frame pass through the RCT after the shift (components 3 and
up do not).
``fwd_stage`` launches ``csrc/j2k_fwd_stage.cu`` once for a CUDA tensor
of any line length (the largest plane: ``_kernels.j2k_fwd_stage``), or
raises; a CPU tensor runs the plain version, ``fwd_stage_plain``.

The epilogue returns:

- ``"coeffs"``: the int32 coefficients [..., H, W];
- ``"narrow"``: (the coefficients cast to int16, wrapping; the max |coeff|
  over all planes, int32, 0-d), the pipelines' narrow readback;
- ``"stats"``: (the coefficients, the per-code-block max |coeff| and its
  bit-plane count, each [..., ceil(H/cb), ceil(W/cb)] int32).
"""

from __future__ import annotations

import torch

from .. import _kernels
from .blockstats import codeblock_max_abs, max_bitplane
from .dwt53 import fwd53_multilevel_plain_, fwd_schedule
from .mct import rct_forward

EPILOGUES = ("coeffs", "narrow", "stats")


def _rct(x: torch.Tensor, mct: bool) -> bool:
    """True when the stage runs the RCT on [B, C, H, W] ``x``."""
    return mct and x.dim() == 4 and x.shape[1] >= 3


def _shifted(x: torch.Tensor, shift: int, mct: bool = False) -> torch.Tensor:
    """x widened to int32 less ``shift``, then the RCT of components 0-2
    with ``mct``, in a new tensor the transform may overwrite."""
    s = (x.to(torch.int32) - shift).contiguous()
    if _rct(s, mct):
        s[:, :3] = torch.stack(rct_forward(s[:, 0], s[:, 1], s[:, 2]), dim=1)
    return s


def _epilogue(c: torch.Tensor, epilogue: str, cb: int):
    if epilogue == "narrow":
        return c.to(torch.int16), c.abs().amax()
    if epilogue == "stats":
        m = codeblock_max_abs(c, cb, cb)
        return c, m, max_bitplane(m)
    return c


def fwd_stage_plain(x: torch.Tensor, shift: int, levels: int, x0: int = 0,
                    y0: int = 0, epilogue: str = "coeffs", cb: int = 64,
                    mct: bool = False):
    """The stage in plain torch on x's device: the kernel's reference."""
    c = fwd53_multilevel_plain_(_shifted(x, shift, mct), levels, x0, y0)
    return _epilogue(c, epilogue, cb)


def fwd_stage(x: torch.Tensor, shift: int, levels: int, x0: int = 0,
              y0: int = 0, epilogue: str = "coeffs", cb: int = 64,
              mct: bool = False):
    """[..., H, W] samples → ``x - shift`` in int32 → with ``mct`` the RCT
    of components 0-2 of [B, C, H, W] → ``levels`` of 5/3 at origin
    (x0, y0) → the ``epilogue``'s outputs (see the module note).

    The kernel for a CUDA tensor, the plain version for a CPU tensor; any
    other device raises.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"forward stage: no epilogue {epilogue!r}")
    if x.device.type == "cpu":
        return fwd_stage_plain(x, shift, levels, x0, y0, epilogue, cb, mct)
    if x.device.type != "cuda":
        raise ValueError(f"forward stage: no lane for device {x.device}")
    return _fwd_stage_kernel(x, shift, levels, x0, y0, epilogue, cb, mct)


def _fwd_stage_kernel(x: torch.Tensor, shift: int, levels: int, x0: int = 0,
                      y0: int = 0, epilogue: str = "coeffs", cb: int = 64,
                      mct: bool = False):
    h, w = x.shape[-2], x.shape[-1]
    sched = fwd_schedule(w, h, levels, x0, y0)
    if x.dtype not in _kernels.FWD_STAGE_DTYPES:
        x = x.to(torch.int32)
    src = x.contiguous().view(-1, h, w)
    comps = x.shape[1] if _rct(x, mct) else 1
    args = dict(comps=comps, mct=comps >= 3)
    lead = x.shape[:-2]
    if epilogue == "narrow":
        narrow = torch.empty(src.shape, dtype=torch.int16, device=x.device)
        maxabs = torch.empty((), dtype=torch.int32, device=x.device)
        _kernels.j2k_fwd_stage(src, None, sched, shift, epilogue,
                               narrow=narrow, maxabs=maxabs, **args)
        return narrow.view(x.shape), maxabs
    coef = torch.empty(src.shape, dtype=torch.int32, device=x.device)
    if epilogue == "stats":
        grid = (src.shape[0], -(-h // cb), -(-w // cb))
        cb_max = torch.empty(grid, dtype=torch.int32, device=x.device)
        cb_bits = torch.empty(grid, dtype=torch.int32, device=x.device)
        _kernels.j2k_fwd_stage(src, coef, sched, shift, epilogue, cb,
                               cb_max=cb_max, cb_bits=cb_bits, **args)
        return (coef.view(x.shape), cb_max.view(lead + grid[1:]),
                cb_bits.view(lead + grid[1:]))
    _kernels.j2k_fwd_stage(src, coef, sched, shift, epilogue, **args)
    return coef.view(x.shape)
