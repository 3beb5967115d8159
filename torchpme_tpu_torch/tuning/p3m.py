"""P3M parameter tuning: Deserno–Holm error bound + grid search.

Counterpart of :mod:`torchpme_tpu.tuning.p3m`.  The Fourier-error
coefficients are Table II of Deserno & Holm, JCP 109, 7694 (1998); notation
``α = 1/(√2·smearing)``.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Any

import torch

from ..calculators import P3MCalculator
from .ewald import ewald_rspace_error
from .tuner import (
    GridSearchTuner,
    TuningErrorBounds,
    _best_candidate,
    _f64,
    _min_dimension,
)

__all__ = ["tune_p3m", "P3MErrorBounds", "p3m_kspace_error"]

# a_{m}^{(n)} expansion coefficients of the P3M Fourier-space error
# (Deserno & Holm 1998, Table II); row m = 0..6, column n = interpolation order
_A_COEF = {
    (0, 1): 2 / 3,
    (0, 2): 1 / 50,
    (0, 3): 1 / 588,
    (0, 4): 1 / 4320,
    (0, 5): 1 / 23_232,
    (0, 6): 691 / 68_140_800,
    (0, 7): 1 / 345_600,
    (1, 2): 5 / 294,
    (1, 3): 7 / 1440,
    (1, 4): 3 / 1936,
    (1, 5): 7601 / 13_628_160,
    (1, 6): 13 / 57_600,
    (1, 7): 3617 / 35_512_320,
    (2, 3): 21 / 3872,
    (2, 4): 7601 / 2_271_360,
    (2, 5): 143 / 69_120,
    (2, 6): 47_021 / 35_512_320,
    (2, 7): 745_739 / 838_397_952,
    (3, 4): 143 / 28_800,
    (3, 5): 517_231 / 106_536_960,
    (3, 6): 9_694_607 / 2_095_994_880,
    (3, 7): 56_399_353 / 12_773_376_000,
    (4, 5): 106_640_677 / 11_737_571_328,
    (4, 6): 733_191_589 / 59_609_088_000,
    (4, 7): 25_091_609 / 1_560_084_480,
    (5, 6): 326_190_917 / 11_700_633_600,
    (5, 7): 1_755_948_832_039 / 36_229_939_200_000,
    (6, 7): 4_887_769_399 / 37_838_389_248,
}


def p3m_kspace_error(
    prefac, volume, cell_dimensions, smearing, mesh_spacing, interpolation_nodes
):
    """Reciprocal-space error of P3M; ``interpolation_nodes`` selects a
    coefficient row.  The series ``Σ_m a_m (hα)^{2m}`` is summed from
    ``m = 0`` up, the JAX package's order."""
    prefac, volume, cell_dimensions, smearing, mesh_spacing = _f64(
        prefac, volume, cell_dimensions, smearing, mesh_spacing
    )
    n = int(interpolation_nodes)
    alpha = 1.0 / (2**0.5 * smearing)
    actual_spacing = cell_dimensions / (2 * cell_dimensions / mesh_spacing + 1)
    h = torch.prod(actual_spacing) ** (1 / 3)
    ha = h * alpha
    series = sum(_A_COEF[(m, n)] * ha ** (2 * m) for m in range(n))
    return (
        prefac
        / volume ** (2 / 3)
        * ha**n
        * torch.sqrt(alpha * volume ** (1 / 3) * math.sqrt(2 * math.pi) * series)
    )


class P3MErrorBounds(TuningErrorBounds):
    r"""Error bound for :class:`~torchpme_tpu_torch.P3MCalculator`.

    Example
    -------
    >>> import torch
    >>> f64 = torch.float64
    >>> bounds = P3MErrorBounds(
    ...     torch.tensor([[1.0], [-1.0]], dtype=f64),
    ...     torch.eye(3, dtype=f64),
    ...     torch.tensor([[0.0, 0.0, 0.0], [0.4, 0.4, 0.4]], dtype=f64),
    ... )
    >>> err = bounds(smearing=1.0, mesh_spacing=0.5, cutoff=4.4, interpolation_nodes=3)
    >>> print(f"{float(err):.4e}")
    4.5968e-04
    """

    def err_kspace(self, smearing, mesh_spacing, interpolation_nodes):
        """Charge-assignment/aliasing error of the mesh part."""
        return p3m_kspace_error(
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

    def error(self, smearing, mesh_spacing, cutoff, interpolation_nodes):
        """Total RSS error bound (floats or tensors)."""
        return torch.sqrt(
            self.err_kspace(smearing, mesh_spacing, interpolation_nodes) ** 2
            + self.err_rspace(smearing, cutoff) ** 2
        )


def tune_p3m(
    charges,
    cell,
    positions,
    cutoff: float,
    neighbor_indices,
    neighbor_distances,
    full_neighbor_list: bool = False,
    prefactor: float = 1.0,
    exponent: int = 1,
    nodes_lo: int = 2,
    nodes_hi: int = 5,
    mesh_lo: int = 2,
    mesh_hi: int = 7,
    accuracy: float = 1e-3,
) -> tuple[float, dict[str, Any], float]:
    r"""Find optimal ``(smearing, mesh_spacing, interpolation_nodes)`` for P3M.

    Same candidate-grid shape as :func:`~torchpme_tpu_torch.tuning.tune_pme`
    but with P3M assignment orders 2–5.

    :return: ``(smearing, {"interpolation_nodes": ..., "mesh_spacing": ...},
        seconds_per_step)``.
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
        calculator=P3MCalculator,
        error_bounds=P3MErrorBounds(charges=charges, cell=cell, positions=positions),
        params=params,
    )
    smearing = tuner.estimate_smearing(accuracy)
    errs, timings = tuner.tune(accuracy)
    return _best_candidate(params, errs, timings, smearing, accuracy)
