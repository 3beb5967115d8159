"""Reciprocal-space filter, its application to a mesh, and the Parseval
quadratic form, on cuFFT.

Counterpart of :mod:`torchpme_tpu.ops.kspace`.  The JAX package can run the
transforms as DFT matmuls on the TPU (its 3D rFFT has a latency floor
there); here every transform is ``torch.fft.rfftn`` / ``irfftn``.
"""

from __future__ import annotations

import numpy as np
import torch

from .kvectors import generate_kvectors_for_mesh

__all__ = ["apply_kspace_filter", "compute_kspace_filter", "kspace_filter_quadratic"]


def apply_kspace_filter(
    mesh_values: torch.Tensor,
    kfilter: torch.Tensor,
    fft_norm: str = "ortho",
    ifft_norm: str = "ortho",
) -> torch.Tensor:
    r"""Apply a scalar reciprocal-space filter to a real-space mesh:
    :math:`f \to \hat f \to \hat f\,\phi \to \tilde f` with a 3D rFFT over
    the last three axes.  Mesh calculators use the ``backward``/``forward``
    norm pair, which puts no :math:`1/n` factor in either direction.

    :param mesh_values: ``(C, nx, ny, nz)`` real-space field.
    :param kfilter: ``(nx, ny, nz//2+1)`` filter on the rFFT grid.
    """
    if mesh_values.ndim != 4:
        raise ValueError(
            "`mesh_values` needs to be a 4 dimensional tensor, got "
            f"{mesh_values.ndim}"
        )
    dims = (1, 2, 3)
    mesh_hat = torch.fft.rfftn(mesh_values, norm=fft_norm, dim=dims)
    if mesh_hat.shape[-3:] != kfilter.shape[-3:]:
        raise ValueError("The real-space mesh is inconsistent with the k-space grid.")
    # explicit output size: for odd mesh sizes the inverse rFFT is ambiguous
    return torch.fft.irfftn(
        mesh_hat * kfilter, norm=ifft_norm, dim=dims, s=mesh_values.shape[-3:]
    )


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
