"""PME parameter tuning: Petersen-style error bound + grid search.

Counterpart of :mod:`torchpme_tpu.tuning.pme`.  Error formulas follow
Petersen, JCP 103, 3668 (1995); note the notation difference
``α = 1/(√2·smearing)``.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Any

import torch

from ..calculators import PMECalculator
from .ewald import ewald_rspace_error
from .tuner import (
    GridSearchTuner,
    TuningErrorBounds,
    _best_candidate,
    _f64,
    _min_dimension,
)

__all__ = ["tune_pme", "PMEErrorBounds", "pme_kspace_error"]

# RMS of the force-interpolation polynomial φ per interpolation order
# (Petersen 1995); entries for interpolation_nodes = 3..7
_RMS_PHI = (0.246, 0.404, 0.950, 2.51, 8.42)


def pme_kspace_error(
    prefac, volume, cell_dimensions, smearing, mesh_spacing, interpolation_nodes
):
    """Reciprocal-space (interpolation) error of PME; ``interpolation_nodes``
    (3–7) is an integer."""
    prefac, volume, cell_dimensions, smearing, mesh_spacing = _f64(
        prefac, volume, cell_dimensions, smearing, mesh_spacing
    )
    n = int(interpolation_nodes)
    n_t = torch.tensor(float(n), dtype=torch.float64, device=smearing.device)
    inv_sqrt2_smearing = 1.0 / (2**0.5 * smearing)
    actual_spacing = cell_dimensions / (2 * cell_dimensions / mesh_spacing + 1)
    h = torch.prod(actual_spacing) ** (1 / 3)
    n_factorial = torch.exp(torch.lgamma(n_t + 1.0))
    return (
        prefac
        * math.pi**0.25
        * (6 * inv_sqrt2_smearing / (2 * n + 1)) ** 0.5
        / volume ** (2 / 3)
        * (2**0.5 / smearing * h) ** n
        / n_factorial
        * torch.exp(n * (torch.log(n_t / 2.0) - 1) / 2)
        * _RMS_PHI[n - 3]
    )


class PMEErrorBounds(TuningErrorBounds):
    r"""Error bound for :class:`~torchpme_tpu_torch.PMECalculator`.

    Example
    -------
    >>> import torch
    >>> f64 = torch.float64
    >>> bounds = PMEErrorBounds(
    ...     torch.tensor([[1.0], [-1.0]], dtype=f64),
    ...     torch.eye(3, dtype=f64),
    ...     torch.tensor([[0.0, 0.0, 0.0], [0.4, 0.4, 0.4]], dtype=f64),
    ... )
    >>> err = bounds(smearing=1.0, mesh_spacing=0.5, cutoff=4.4, interpolation_nodes=3)
    >>> print(f"{float(err):.4e}")
    1.1180e-03
    """

    def err_kspace(self, smearing, mesh_spacing, interpolation_nodes):
        """Interpolation/aliasing error of the mesh part."""
        return pme_kspace_error(
            self.prefac,
            self.volume,
            self.cell_dimensions,
            smearing,
            mesh_spacing,
            interpolation_nodes,
        )

    def err_rspace(self, smearing, cutoff):
        """Real-space truncation error (same bound as Ewald)."""
        return ewald_rspace_error(self.prefac, self.volume, smearing, cutoff)

    def error(self, cutoff, smearing, mesh_spacing, interpolation_nodes):
        """Total RSS error bound (floats or tensors)."""
        return torch.sqrt(
            self.err_rspace(smearing, cutoff) ** 2
            + self.err_kspace(smearing, mesh_spacing, interpolation_nodes) ** 2
        )


def tune_pme(
    charges,
    cell,
    positions,
    cutoff: float,
    neighbor_indices,
    neighbor_distances,
    full_neighbor_list: bool = False,
    prefactor: float = 1.0,
    exponent: int = 1,
    nodes_lo: int = 3,
    nodes_hi: int = 7,
    mesh_lo: int = 2,
    mesh_hi: int = 7,
    accuracy: float = 1e-3,
) -> tuple[float, dict[str, Any], float]:
    r"""Find optimal ``(smearing, mesh_spacing, interpolation_nodes)`` for PME.

    Candidate grid: interpolation orders × mesh sizes ``2^mesh_lo..2^mesh_hi``
    along the shortest cell axis (``mesh_spacing = 2·min_dim/(2^ns − 1)``),
    error-screened, then timed.

    :return: ``(smearing, {"interpolation_nodes": ..., "mesh_spacing": ...},
        seconds_per_step)``.

    Example
    -------
    On the CPU, with CPU tensors (on a card, pass CUDA tensors or numpy):

    >>> import torch
    >>> from torchpme_tpu_torch.tuning import tune_pme
    >>> from torchpme_tpu_torch.utils.neighbors import neighbor_list
    >>> f64 = torch.float64
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=f64)
    >>> charges = torch.tensor([[1.0], [-1.0]], dtype=f64)
    >>> cell = torch.eye(3, dtype=f64)
    >>> idx, dist, _ = neighbor_list(positions, cell, cutoff=0.49)
    >>> smearing, params, seconds = tune_pme(
    ...     charges, cell, positions, 0.49, torch.as_tensor(idx), torch.as_tensor(dist),
    ...     nodes_lo=3, nodes_hi=4, mesh_lo=2, mesh_hi=4, accuracy=1e-1,
    ... )
    >>> sorted(params), seconds > 0
    (['interpolation_nodes', 'mesh_spacing'], True)
    """
    min_dimension = _min_dimension(cell)
    params = [
        {
            "interpolation_nodes": nodes,
            "mesh_spacing": 2 * min_dimension / (2**ns - 1),
        }
        for nodes, ns in product(
            range(nodes_lo, nodes_hi + 1), range(mesh_lo, mesh_hi + 1)
        )
    ]

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
        calculator=PMECalculator,
        error_bounds=PMEErrorBounds(charges=charges, cell=cell, positions=positions),
        params=params,
    )
    smearing = tuner.estimate_smearing(accuracy)
    errs, timings = tuner.tune(accuracy)
    return _best_candidate(params, errs, timings, smearing, accuracy)
