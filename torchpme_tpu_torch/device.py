"""Where the port's entry points put their state when the caller does not say.

An entry point that builds state from host data (numpy arrays, Python
lists) and is given no ``device`` uses :func:`default_device`: the card.  A
tensor argument keeps its own device, and ``device="cpu"`` is the caller
asking for the CPU; nothing falls back to the CPU by itself.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """``cuda``; raises when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's state goes to the card unless the caller "
            "asks for another device; pass device=\"cpu\" (or CPU tensors) to run "
            "on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None, *like) -> torch.device:
    """The device of an entry point's state: ``device`` when given, else
    the device of the first tensor among ``like``, else
    :func:`default_device`."""
    if device is not None:
        return torch.device(device)
    for value in like:
        if isinstance(value, torch.Tensor):
            return value.device
    return default_device()
