"""Ewald parameter tuning: analytic error bounds + grid search.

Counterpart of :mod:`torchpme_tpu.tuning.ewald`.  The Kolafa–Perram-style
error bounds are plain functions of their scalar parameters (floats or
tensors), evaluated in float64 and differentiable by autograd.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..calculators import EwaldCalculator
from .tuner import (
    GridSearchTuner,
    TuningErrorBounds,
    _best_candidate,
    _f64,
    _min_dimension,
)

__all__ = ["tune_ewald", "EwaldErrorBounds", "ewald_error"]


def ewald_rspace_error(prefac, volume, smearing, cutoff):
    """Real-space truncation error of the Ewald sum."""
    prefac, volume, smearing, cutoff = _f64(prefac, volume, smearing, cutoff)
    return (
        prefac
        / torch.sqrt(cutoff * volume)
        * torch.exp(-(cutoff**2) / 2 / smearing**2)
    )


def ewald_kspace_error(prefac, volume, smearing, lr_wavelength):
    """Reciprocal-space truncation error of the Ewald sum."""
    prefac, volume, smearing, lr_wavelength = _f64(prefac, volume, smearing, lr_wavelength)
    return (
        prefac**0.5
        / smearing
        / math.pi
        / torch.sqrt(volume / lr_wavelength)
        * torch.exp(-2 * (math.pi * smearing / lr_wavelength) ** 2)
    )


def ewald_error(prefac, volume, smearing, lr_wavelength, cutoff):
    """Root-sum-square of the real- and reciprocal-space Ewald errors."""
    return torch.sqrt(
        ewald_kspace_error(prefac, volume, smearing, lr_wavelength) ** 2
        + ewald_rspace_error(prefac, volume, smearing, cutoff) ** 2
    )


class EwaldErrorBounds(TuningErrorBounds):
    r"""Error bound for :class:`~torchpme_tpu_torch.EwaldCalculator`,
    :math:`\sqrt{E_{real}^2 + E_{fourier}^2}`.

    Example
    -------
    >>> import torch
    >>> f64 = torch.float64
    >>> bounds = EwaldErrorBounds(
    ...     torch.tensor([[1.0], [-1.0]], dtype=f64),
    ...     torch.eye(3, dtype=f64),
    ...     torch.tensor([[0.0, 0.0, 0.0], [0.4, 0.4, 0.4]], dtype=f64),
    ... )
    >>> print(f"{float(bounds(smearing=1.0, lr_wavelength=0.5, cutoff=4.4)):.4e}")
    8.4304e-05
    """

    def err_kspace(self, smearing, lr_wavelength):
        """Reciprocal-space error for the given smearing and wavelength."""
        return ewald_kspace_error(self.prefac, self.volume, smearing, lr_wavelength)

    def err_rspace(self, smearing, cutoff):
        """Real-space error for the given smearing and cutoff."""
        return ewald_rspace_error(self.prefac, self.volume, smearing, cutoff)

    def error(self, smearing, lr_wavelength, cutoff):
        """Total RSS error bound (floats or tensors)."""
        return ewald_error(self.prefac, self.volume, smearing, lr_wavelength, cutoff)


def tune_ewald(
    charges,
    cell,
    positions,
    cutoff: float,
    neighbor_indices,
    neighbor_distances,
    full_neighbor_list: bool = False,
    prefactor: float = 1.0,
    exponent: int = 1,
    ns_lo: int = 1,
    ns_hi: int = 14,
    accuracy: float = 1e-3,
) -> tuple[float, dict[str, Any], float]:
    r"""Find optimal ``(smearing, lr_wavelength)`` for the Ewald calculator.

    Screens ``lr_wavelength = min_cell_dim / ns`` for ``ns = ns_lo..ns_hi``
    with the analytic error bound, times the candidates meeting
    ``accuracy`` and returns the fastest.

    :return: ``(smearing, {"lr_wavelength": ...}, seconds_per_step)``.
    """
    min_dimension = _min_dimension(cell)
    params = [{"lr_wavelength": min_dimension / ns} for ns in range(ns_lo, ns_hi + 1)]

    tuner = GridSearchTuner(
        charges=charges,
        cell=cell,
        positions=positions,
        cutoff=cutoff,
        exponent=exponent,
        neighbor_indices=neighbor_indices,
        neighbor_distances=neighbor_distances,
        full_neighbor_list=full_neighbor_list,
        prefactor=prefactor,
        calculator=EwaldCalculator,
        error_bounds=EwaldErrorBounds(charges=charges, cell=cell, positions=positions),
        params=params,
    )
    smearing = tuner.estimate_smearing(accuracy)
    errs, timings = tuner.tune(accuracy)
    return _best_candidate(params, errs, timings, smearing, accuracy)
