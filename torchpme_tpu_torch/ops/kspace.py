"""Reciprocal-space filter and the Parseval quadratic form on cuFFT.

Counterpart of :mod:`torchpme_tpu.ops.kspace` for the MD energy step.  The
JAX package evaluates the quadratic form by DFT matmuls on the TPU (its 3D
rFFT has a latency floor there); here the transform is ``torch.fft.rfftn``.
"""

from __future__ import annotations

import numpy as np
import torch

from .kvectors import generate_kvectors_for_mesh

__all__ = ["compute_kspace_filter", "kspace_filter_quadratic"]


def compute_kspace_filter(kernel_from_k_sq, cell: torch.Tensor, ns) -> torch.Tensor:
    """Evaluate a kernel function of :math:`k^2` on the rFFT grid of ``ns``."""
    kvectors = generate_kvectors_for_mesh(cell, ns)
    k_sq = torch.sum(kvectors**2, dim=-1)
    return kernel_from_k_sq(k_sq)


def _hermitian_fold_weights(nz: int) -> np.ndarray:
    """Half-z-spectrum fold weights: 2 except at k_z = 0 and (even nz) Nyquist."""
    w = np.full(nz // 2 + 1, 2.0)
    w[0] = 1.0
    if nz % 2 == 0:
        w[-1] = 1.0
    return w


def kspace_filter_quadratic(mesh_values: torch.Tensor, kfilter: torch.Tensor):
    r"""Quadratic form :math:`\sum_x \rho\,(K \circledast \rho)` via Parseval.

    With the un-normalized forward transform,
    :math:`\sum_x \rho\,\phi = \sum_k w_{k_z}\,\hat K(k)\,|\hat\rho(k)|^2`,
    summed over channels; :math:`w_{k_z}` are the Hermitian fold weights.

    :param mesh_values: ``(C, nx, ny, nz)`` real density.
    :param kfilter: ``(nx, ny, nz//2+1)`` filter on the rFFT grid.
    :return: the form as a float64 scalar.
    """
    if mesh_values.ndim != 4:
        raise ValueError(
            f"`mesh_values` needs 4 dimensions, got {mesh_values.ndim}"
        )
    nz = mesh_values.shape[-1]
    rho_hat = torch.fft.rfftn(mesh_values, dim=(1, 2, 3), norm="backward")
    if rho_hat.shape[-3:] != kfilter.shape[-3:]:
        raise ValueError("The real-space mesh is inconsistent with the k-space grid.")
    weights = torch.as_tensor(
        _hermitian_fold_weights(nz), dtype=kfilter.dtype, device=kfilter.device
    )
    power = rho_hat.real**2 + rho_hat.imag**2
    # a million terms whose sum cancels against the self energy downstream:
    # accumulate in float64 (the result is float64)
    return torch.sum(power * (weights * kfilter), dtype=torch.float64)
