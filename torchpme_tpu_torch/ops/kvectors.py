"""Reciprocal-space vectors for the mesh calculators.

Counterpart of :mod:`torchpme_tpu.ops.kvectors`: the rFFT half-grid of the
mesh calculators and the full k-set of explicit Ewald sums.  Mesh sizes are
plain Python ints; the cell values only rescale the k-vectors, which stay
differentiable.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels as _k
from ..device import resolve_device
from .math import inv3

__all__ = [
    "compute_batched_kvectors",
    "generate_kvectors_for_ewald",
    "generate_kvectors_for_mesh",
    "get_ns_ewald",
    "get_ns_mesh",
]


def _cell_and_ns(cell, ns_mesh, device=None):
    """Checked ``(3, 3)`` cell tensor on ``device`` (by default, that of a
    tensor ``cell``, else :func:`~torchpme_tpu_torch.default_device`) and
    mesh shape as a tuple of 3 ints; ``None`` passes through."""
    if cell is not None:
        cell = torch.as_tensor(cell, device=resolve_device(device, cell))
        if cell.shape != (3, 3):
            raise ValueError(f"cell of shape {list(cell.shape)} should be of shape (3, 3)")
    if ns_mesh is not None:
        ns_mesh = tuple(int(n) for n in np.asarray(ns_mesh).reshape(-1))
        if len(ns_mesh) != 3:
            raise ValueError(f"shape {[len(ns_mesh)]} of `ns_mesh` has to be (3,)")
    return cell, ns_mesh


def _basis_norms(cell, static: str) -> np.ndarray:
    """Row norms of a cell whose values can be read on the host; under
    ``torch.func.vmap`` a batch of cells has none, and the error names the
    static argument that the caller passes instead (``static``)."""
    if isinstance(cell, torch.Tensor):
        if _k.is_batched(cell):
            raise ValueError(
                "Mesh and k-vector sizes must be static under torch.func.vmap: they "
                "cannot depend on a batched `cell`. Compute them outside the vmapped "
                f"function (e.g. from the largest cell) and pass them as {static}."
            )
        cell = _k.host_values(cell)
    return np.linalg.norm(np.asarray(cell, dtype=np.float64), axis=1)


def get_ns_mesh(cell, mesh_spacing: float) -> tuple[int, int, int]:
    """Mesh size per axis for a target spacing, rounded up to powers of two
    (``ns = 2^ceil(log2(2·L/spacing + 1))``).

    Example
    -------
    >>> import numpy as np
    >>> get_ns_mesh(np.eye(3) * 10.0, mesh_spacing=1.0)
    (32, 32, 32)
    """
    norms = _basis_norms(cell, "`ns_mesh=` (`ns_kvectors=` for PMECalculatorDipole)")
    ns_approx = 2 * norms / mesh_spacing + 1
    return tuple(int(2 ** math.ceil(math.log2(n))) for n in ns_approx)


def get_ns_ewald(cell, lr_wavelength: float) -> tuple[int, int, int]:
    """Number of reciprocal basis-vector multiples within the Ewald k-cutoff:
    ``k_cutoff = 2π / lr_wavelength``, and each axis keeps
    ``ceil(k_cutoff · |a_i| / 2π)`` harmonics."""
    k_cutoff = 2 * math.pi / lr_wavelength
    norms = _basis_norms(cell, "`ns_kvectors=`")
    return tuple(int(math.ceil(k_cutoff * n / (2 * math.pi))) for n in norms)


def _generate_kvectors(cell: torch.Tensor, ns, last_real: bool) -> torch.Tensor:
    """Broadcast sum of per-axis integer frequencies times reciprocal vectors."""
    ns = tuple(int(n) for n in ns)
    if len(ns) != 3:
        raise ValueError(f"ns of length {len(ns)} should have 3 entries")
    if cell.shape != (3, 3):
        raise ValueError(f"cell of shape {list(cell.shape)} should be of shape (3, 3)")
    opts = dict(dtype=cell.dtype, device=cell.device)
    reciprocal = 2 * math.pi * inv3(cell).T
    kx = (torch.fft.fftfreq(ns[0], **opts) * ns[0])[:, None] * reciprocal[0]
    ky = (torch.fft.fftfreq(ns[1], **opts) * ns[1])[:, None] * reciprocal[1]
    freq_z = torch.fft.rfftfreq if last_real else torch.fft.fftfreq
    kz = (freq_z(ns[2], **opts) * ns[2])[:, None] * reciprocal[2]
    return kx[:, None, None] + ky[None, :, None] + kz[None, None, :]


def generate_kvectors_for_mesh(cell: torch.Tensor, ns) -> torch.Tensor:
    """All k-vectors on the half-spectrum rFFT grid of an ``ns`` mesh.

    :return: ``(nx, ny, nz // 2 + 1, 3)``; entry ``[0, 0, 0]`` is zero.
    """
    return _generate_kvectors(cell, ns, last_real=True)


def generate_kvectors_for_ewald(cell: torch.Tensor, ns) -> torch.Tensor:
    """Full (flattened) k-vector set for explicit Ewald sums.

    :return: ``(nx · ny · nz, 3)``; entry 0 is the zero vector.
    """
    return _generate_kvectors(cell, ns, last_real=False).reshape(-1, 3)


def compute_batched_kvectors(lr_wavelength: float, cells, device=None) -> torch.Tensor:
    """Zero-padded per-system k-vectors for batched Ewald sums.

    Each cell's full Ewald k-set is generated and the batch right-padded
    with zero vectors to a common length: the ``k = 0`` entry is masked out
    of every kernel, so the padding adds nothing.

    :param lr_wavelength: spatial resolution of the reciprocal-space sum.
    :param cells: ``(B, 3, 3)`` batch of cells (a tensor keeps its dtype).
    :param device: device of the result (default: that of a tensor
        ``cells``, else :func:`torchpme_tpu_torch.default_device`).
    :return: ``(B, max_k, 3)``.
    """
    cells = torch.as_tensor(cells, device=resolve_device(device, cells))
    per_system = [
        generate_kvectors_for_ewald(cell, get_ns_ewald(cell, lr_wavelength)) for cell in cells
    ]
    max_k = max(kv.shape[0] for kv in per_system)
    return torch.stack(
        [torch.nn.functional.pad(kv, (0, 0, 0, max_k - kv.shape[0])) for kv in per_system]
    )
