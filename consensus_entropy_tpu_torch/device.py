"""Where the port's entry points run.

The default is the card.  There is no silent fallback to the CPU: a caller
without CUDA must ask for ``device="cpu"`` (as the tests do), which runs the
plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); anything else is
    taken as given, and a CUDA device is checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch versions")
    return dev
