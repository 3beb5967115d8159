"""Where the port's entry points put their state when the caller does not say.

An entry point that builds state from host data (numpy arrays, Python
lists) and is given no ``device`` uses :func:`default_device`.  A tensor
argument keeps its own device, and ``device="cpu"`` is the caller asking for
the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """``cuda`` when a CUDA device is present, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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
