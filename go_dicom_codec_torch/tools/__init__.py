"""Command-line tools of the port (the reference's cmd/ surface).

Every tool takes ``--device`` (default ``cuda``, which is ``cuda:0``) and
runs there; ``cli_device`` turns the flag into a ``torch.device``.
"""

import torch


def cli_device(name: str) -> torch.device:
    """``--device``'s value as a ``torch.device``: "cuda" is cuda:0. A CUDA
    device that is not present raises; nothing falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        if (not torch.cuda.is_available()
                or dev.index >= torch.cuda.device_count()):
            raise RuntimeError(f"--device {name}: no such CUDA device")
    elif dev.type != "cpu":
        raise ValueError(f"--device {name}: only cpu and cuda devices run "
                         f"the port")
    return dev
