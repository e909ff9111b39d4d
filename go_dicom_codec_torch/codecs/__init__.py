"""Transfer-syntax codec adapters of the port.

Only the JPEG 2000 family (UIDs .90-.93) is ported. Nothing registers at
import: ``register_codecs`` fills a registry the caller made, with codecs
that run on the ``torch.device`` it names.
"""

from __future__ import annotations

import torch

from ..registry import CodecRegistry


def register_codecs(registry: CodecRegistry, device: torch.device,
                    engine: str = "auto") -> None:
    from . import j2k_adapters

    j2k_adapters.register(registry, device, engine)
