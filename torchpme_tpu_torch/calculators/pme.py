"""Particle-mesh Ewald calculator: the k-space energy of the MD step.

Counterpart of :mod:`torchpme_tpu.calculators.pme` (the quadratic-form
energy path that :class:`~torchpme_tpu_torch.md.MDFastPath` uses).
"""

from __future__ import annotations

import torch

from ..ops.kspace import compute_kspace_filter, kspace_filter_quadratic
from ..ops.kvectors import get_ns_mesh
from ..ops.math import det3
from .calculator import Calculator

__all__ = ["PMECalculator"]


class PMECalculator(Calculator):
    r"""Mesh Ewald with Lagrange interpolation (smooth PME).

    :param potential: range-separated potential; ``smearing`` must be set.
    :param mesh_spacing: target distance between mesh planes; the mesh is
        rounded up to powers of two per axis.
    :param interpolation_nodes: stencil size ``n`` per axis (3–7).
    """

    _method = "Lagrange"

    def __init__(self, potential, mesh_spacing: float = 1.0, interpolation_nodes: int = 4):
        super().__init__(potential)
        if potential.smearing is None:
            raise ValueError("Must specify smearing to use a potential with PMECalculator")
        if interpolation_nodes not in (3, 4, 5, 6, 7):
            raise ValueError(
                f"`interpolation_nodes` is {interpolation_nodes} but only "
                "values from 3 to 7 for method 'Lagrange' are allowed"
            )
        self.mesh_spacing = float(mesh_spacing)
        self.interpolation_nodes = int(interpolation_nodes)

    def extra_repr(self) -> str:
        return (
            f"mesh_spacing={self.mesh_spacing}, "
            f"interpolation_nodes={self.interpolation_nodes}"
        )

    def get_ns_mesh(self, cell) -> tuple[int, int, int]:
        """Static mesh shape for a concrete cell."""
        return get_ns_mesh(cell, self.mesh_spacing)

    def _kspace_filter(self, cell: torch.Tensor, ns) -> torch.Tensor:
        return compute_kspace_filter(self.potential.lr_from_k_sq, cell, ns)

    def _kspace_energy_from_rho(
        self,
        rho_mesh: torch.Tensor,
        cell: torch.Tensor,
        charges: torch.Tensor,
        positions: torch.Tensor,
        periodic,
        ns_mesh,
    ) -> torch.Tensor:
        r"""k-space energy :math:`\tfrac12[\sum_k w\hat K|\hat\rho|^2/V -
        q^2\text{ self} - \text{background}]` (+ the slab term when
        ``periodic`` is given) from a density mesh, in the mesh's dtype."""
        kfilter = self._kspace_filter(cell, ns_mesh)
        # the mesh and self terms nearly cancel: assemble them in float64
        f64 = torch.float64
        volume = torch.abs(det3(cell)).to(f64)
        e = kspace_filter_quadratic(rho_mesh, kfilter) / volume
        e = e - self.potential.self_contribution() * torch.sum(charges**2, dtype=f64)
        charge_tot = torch.sum(charges, dim=0, dtype=f64)
        e = e - 2 * self.potential.background_correction() * torch.sum(
            charge_tot**2
        ) / volume
        if periodic is not None:
            e = e + torch.sum(
                self.potential.pbc_correction(periodic, positions, cell, charges)
                * charges,
                dtype=f64,
            )
        # compensate double counting of pairs (i,j) and (j,i)
        return (e / 2).to(rho_mesh.dtype)
