"""Potential defined by cubic-spline interpolation of a numerical function.

Counterpart of :mod:`torchpme_tpu.potentials.spline`.  The splines (and the
Fourier kernel, computed from the real-space samples when not given) are
built once, at construction; the grids are buffers and are not trainable.
"""

from __future__ import annotations

import math

import torch

from ..ops.splines import (
    CubicSpline,
    CubicSplineReciprocal,
    compute_second_derivatives,
    compute_spline_ft,
)
from .potential import Potential

__all__ = ["SplinePotential"]


class SplinePotential(Potential):
    r"""Potential built from a spline through ``(r, y)`` samples.

    The potential is purely long range (``sr_from_dist`` is zero); its
    Fourier kernel is splined against :math:`k^2`, computed from the
    real-space samples by the analytic radial transform
    (:func:`~torchpme_tpu_torch.ops.splines.compute_spline_ft`) when not
    given.  The grids are fixed: no gradient reaches them.

    :param r_grid: radial grid of the real-space samples.
    :param y_grid: potential values on ``r_grid``.
    :param k_grid: radial grid of the k-space kernel; default :math:`2\pi/r`
        of the flipped real grid when ``reciprocal``, else ``r_grid``.
    :param yhat_grid: kernel values on ``k_grid``; computed when absent.
    :param reciprocal: spline on a ``1/r`` axis (suited to long-range tails);
        needs a strictly positive ``r_grid``.
    :param y_at_zero: value for :math:`r \to 0` (reciprocal spline).
    :param yhat_at_zero: value for :math:`k \to 0` of the kernel.
    :param smearing / exclusion_radius / exclusion_degree / prefactor: see
        :class:`Potential`.

    Example
    -------
    Spline the long-range part of a Coulomb potential and evaluate it back:

    >>> import torch
    >>> from torchpme_tpu_torch.potentials import CoulombPotential
    >>> coulomb = CoulombPotential(smearing=1.0)
    >>> r = torch.linspace(0.1, 20.0, 600, dtype=torch.float64)
    >>> spline = SplinePotential(r, coulomb.lr_from_dist(r), reciprocal=True)
    >>> x = torch.tensor([0.5, 2.0, 5.0], dtype=torch.float64)
    >>> print(bool(torch.allclose(spline.lr_from_dist(x), coulomb.lr_from_dist(x),
    ...                           atol=1e-5)))
    True
    """

    def __init__(
        self,
        r_grid: torch.Tensor,
        y_grid: torch.Tensor,
        k_grid: torch.Tensor | None = None,
        yhat_grid: torch.Tensor | None = None,
        reciprocal: bool = False,
        y_at_zero: float | None = None,
        yhat_at_zero: float | None = None,
        smearing: float | None = None,
        exclusion_radius: float | None = None,
        exclusion_degree: int = 1,
        prefactor: float = 1.0,
    ):
        super().__init__(smearing, exclusion_radius, exclusion_degree, prefactor)
        r_grid = torch.as_tensor(r_grid).detach()
        y_grid = torch.as_tensor(y_grid).detach()
        if y_grid.shape[0] != r_grid.shape[0]:
            raise ValueError("Length of radial grid and value array mismatch.")
        self.reciprocal = bool(reciprocal)
        self.register_buffer("r_grid", r_grid)
        self.register_buffer("y_grid", y_grid)
        if reciprocal:
            if float(torch.min(r_grid)) <= 0.0:
                raise ValueError(
                    "Positive-valued radial grid is needed for reciprocal axis spline."
                )
            self._spline = CubicSplineReciprocal(r_grid, y_grid, y_at_zero)
        else:
            self._spline = CubicSpline(r_grid, y_grid)
        if k_grid is None:
            k_grid = 2 * math.pi / r_grid.flip(0) if reciprocal else r_grid
        k_grid = torch.as_tensor(k_grid).detach()
        if yhat_grid is None:
            yhat_grid = compute_spline_ft(
                k_grid, r_grid, y_grid, compute_second_derivatives(r_grid, y_grid)
            )
        yhat_grid = torch.as_tensor(yhat_grid).detach()
        self.register_buffer("k_grid", k_grid)
        self.register_buffer("yhat_grid", yhat_grid)
        # the kernel is queried with k², so it is splined against k²
        if reciprocal:
            self._krn_spline = CubicSplineReciprocal(k_grid**2, yhat_grid, yhat_at_zero)
        else:
            self._krn_spline = CubicSpline(k_grid**2, yhat_grid)
        zero_r = torch.zeros((), dtype=r_grid.dtype)
        zero_k = torch.zeros((), dtype=k_grid.dtype)
        self.register_buffer(
            "_y_at_zero",
            self._spline(zero_r) if y_at_zero is None
            else torch.as_tensor(y_at_zero, dtype=r_grid.dtype),
        )
        self.register_buffer(
            "_yhat_at_zero",
            self._krn_spline(zero_k) if yhat_at_zero is None
            else torch.as_tensor(yhat_at_zero, dtype=k_grid.dtype),
        )

    def from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        # the sub-methods apply the prefactor once each (the upstream
        # torch-pme applies it twice here, a bug the JAX package does not copy)
        return self.lr_from_dist(dist) + self.sr_from_dist(dist)

    def sr_from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(dist)

    def lr_from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        return self.prefactor * self._spline(dist)

    def lr_from_k_sq(self, k_sq: torch.Tensor) -> torch.Tensor:
        return self.prefactor * self._krn_spline(k_sq)

    def self_contribution(self) -> torch.Tensor:
        return self.prefactor * self._y_at_zero

    def background_correction(self) -> torch.Tensor:
        return torch.zeros((), dtype=self.r_grid.dtype)
