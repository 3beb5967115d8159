"""Reciprocal-space vectors for the mesh calculators.

Counterpart of :mod:`torchpme_tpu.ops.kvectors` (the mesh half; the Ewald
k-sets come with the Ewald slice).  Mesh sizes are plain Python ints; the
cell values only rescale the k-vectors, which stay differentiable.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .math import inv3

__all__ = ["generate_kvectors_for_mesh", "get_ns_mesh"]


def get_ns_mesh(cell, mesh_spacing: float) -> tuple[int, int, int]:
    """Mesh size per axis for a target spacing, rounded up to powers of two
    (``ns = 2^ceil(log2(2·L/spacing + 1))``).

    Example
    -------
    >>> import numpy as np
    >>> get_ns_mesh(np.eye(3) * 10.0, mesh_spacing=1.0)
    (32, 32, 32)
    """
    if isinstance(cell, torch.Tensor):
        cell = cell.detach().cpu().numpy()
    basis_norms = np.linalg.norm(np.asarray(cell, dtype=np.float64), axis=1)
    ns_approx = 2 * basis_norms / mesh_spacing + 1
    return tuple(int(2 ** math.ceil(math.log2(n))) for n in ns_approx)


def generate_kvectors_for_mesh(cell: torch.Tensor, ns) -> torch.Tensor:
    """All k-vectors on the half-spectrum rFFT grid of an ``ns`` mesh.

    :return: ``(nx, ny, nz // 2 + 1, 3)``; entry ``[0, 0, 0]`` is zero.
    """
    ns = tuple(int(n) for n in ns)
    if len(ns) != 3:
        raise ValueError(f"ns of length {len(ns)} should have 3 entries")
    if cell.shape != (3, 3):
        raise ValueError(f"cell of shape {list(cell.shape)} should be of shape (3, 3)")
    opts = dict(dtype=cell.dtype, device=cell.device)
    reciprocal = 2 * math.pi * inv3(cell).T
    kx = (torch.fft.fftfreq(ns[0], **opts) * ns[0])[:, None] * reciprocal[0]
    ky = (torch.fft.fftfreq(ns[1], **opts) * ns[1])[:, None] * reciprocal[1]
    kz = (torch.fft.rfftfreq(ns[2], **opts) * ns[2])[:, None] * reciprocal[2]
    return kx[:, None, None] + ky[None, :, None] + kz[None, None, :]
