"""Device resolution: the device the caller names, or an error."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(name: Union[str, torch.device]) -> torch.device:
    """``torch.device(name)``, raising when CUDA is asked for and absent.

    There is no fallback: a run that asked for the card and cannot have
    it fails here instead of carrying on, slower, on the CPU.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
