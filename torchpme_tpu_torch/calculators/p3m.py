"""Particle-particle particle-mesh (P3M) calculator.

Counterpart of :mod:`torchpme_tpu.calculators.p3m`: the PME pipeline with
the P3M charge-assignment stencil (1–5 nodes) and the optimal influence
function multiplying the reciprocal-space filter.  Every mesh backend of
:class:`~torchpme_tpu_torch.PMECalculator` serves it: the scatter, the
tiled mesh (kernels D, E, F on a card) and the fused spread of the energy
path (kernels A, B), and :class:`~torchpme_tpu_torch.MDFastPath` runs its
MD step in aligned, fused and tiled mode.
"""

from __future__ import annotations

import torch

from ..ops.kspace import (
    _check_influence_options,
    compute_kspace_filter,
    p3m_influence_function,
)
from .pme import PMECalculator

__all__ = ["P3MCalculator"]


class P3MCalculator(PMECalculator):
    r"""P3M variant of the mesh calculator.

    :param potential: range-separated potential; ``smearing`` must be set.
    :param mesh_spacing: target mesh-plane spacing (rounded to powers of two).
    :param interpolation_nodes: P3M charge-assignment order, 1–5.
    :param full_neighbor_list: half (False) or full (True) neighbor list.
    :param mode: influence-function mode: 0 potential, 1 energy, 2 dipolar
        torque, 3 dipolar force (eq. 30 of Ballenegger 2008).
    :param differential_order: order (1–6) of the finite-difference
        approximation of the differential operator.
    :param mesh_backend: as for :class:`~torchpme_tpu_torch.PMECalculator`.
    :param tile_capacity: as for :class:`~torchpme_tpu_torch.PMECalculator`.

    Example
    -------
    CsCl Madelung constant (2.035361...) to mesh accuracy:

    >>> import torch
    >>> from torchpme_tpu_torch import CoulombPotential, P3MCalculator
    >>> from torchpme_tpu_torch.utils.neighbors import neighbor_list
    >>> f64 = torch.float64
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=f64)
    >>> charges = torch.tensor([[-1.0], [1.0]], dtype=f64)
    >>> cell = torch.eye(3, dtype=f64)
    >>> idx, dist, _ = neighbor_list(positions, cell, cutoff=1.2)
    >>> calc = P3MCalculator(CoulombPotential(smearing=0.25), mesh_spacing=0.1)
    >>> pot = calc(charges, cell, positions, torch.as_tensor(idx), torch.as_tensor(dist))
    >>> print(f"{float(-torch.sum(pot * charges)):.3f}")
    2.035
    """

    _method = "P3M"
    _NODES = (1, 5)

    def __init__(
        self,
        potential,
        mesh_spacing: float = 1.0,
        interpolation_nodes: int = 4,
        full_neighbor_list: bool = False,
        mode: int = 0,
        differential_order: int = 2,
        mesh_backend: str = "auto",
        tile_capacity: int | None = None,
    ):
        super().__init__(
            potential, mesh_spacing=mesh_spacing, interpolation_nodes=interpolation_nodes,
            full_neighbor_list=full_neighbor_list, mesh_backend=mesh_backend,
            tile_capacity=tile_capacity,
        )
        _check_influence_options(mode, differential_order)
        self.mode = int(mode)
        self.differential_order = int(differential_order)

    def extra_repr(self) -> str:
        return (
            f"{super().extra_repr()}, mode={self.mode}, "
            f"differential_order={self.differential_order}"
        )

    def _kspace_filter_f64(self, cell: torch.Tensor, ns) -> torch.Tensor:
        influence = p3m_influence_function(
            cell, ns, self.interpolation_nodes, self.mode, self.differential_order
        )
        return influence * compute_kspace_filter(self.potential.lr_from_k_sq, cell, ns)
