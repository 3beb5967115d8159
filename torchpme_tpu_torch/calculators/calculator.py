"""Base calculator: real-space neighbor sum plus optional k-space long range.

Counterpart of :mod:`torchpme_tpu.calculators.calculator`.  A calculator is
an ``nn.Module`` around a pure forward function; autograd of the summed
output with respect to positions / charges / cell gives forces, charge
gradients and stress through the whole stack.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.rspace_cells import (
    _pair_values,
    cell_list_rspace_energy,
    cell_list_rspace_potentials,
)
from ..potentials.potential import Potential
from ..utils.validation import validate_parameters

__all__ = ["Calculator"]


class Calculator(nn.Module):
    r"""Evaluates :math:`V_i = \frac{1}{2}\sum_j q_j\, v(r_{ij})` per atom.

    Used directly it computes the real-space part only (a "direct" sum over
    the provided neighbor list); subclasses add a reciprocal-space
    long-range part by overriding :meth:`_compute_kspace`.

    :param potential: the pair potential; its ``smearing`` decides whether a
        k-space part is evaluated at all.
    :param full_neighbor_list: whether the neighbor list contains each pair
        twice (full) or once (half).

    Example
    -------
    Direct sum over a ±1 dimer at distance 1 (no periodicity):

    >>> import torch
    >>> from torchpme_tpu_torch import Calculator, CoulombPotential
    >>> from torchpme_tpu_torch.utils.neighbors import neighbor_list
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    >>> charges = torch.tensor([[1.0], [-1.0]])
    >>> idx, dist, _ = neighbor_list(positions, cutoff=1.5, periodic=False)
    >>> calc = Calculator(CoulombPotential())
    >>> pot = calc(charges, torch.eye(3), positions, torch.as_tensor(idx),
    ...            torch.as_tensor(dist, dtype=torch.float32))
    >>> print(f"{float(torch.sum(pot * charges)):.4f}")  # E = -1/r
    -1.0000
    """

    def __init__(self, potential: Potential, full_neighbor_list: bool = False):
        super().__init__()
        if not isinstance(potential, Potential):
            raise TypeError(
                f"Potential must be an instance of Potential, got {type(potential)}"
            )
        self.potential = potential
        self.full_neighbor_list = bool(full_neighbor_list)

    # -- real space -----------------------------------------------------------

    def _bare_pair_values(self, neighbor_distances, pair_mask=None) -> torch.Tensor:
        """Pair terms v(r): the full potential (direct mode) or the
        short-range part (the long range is summed in k-space); 0 on masked
        pairs."""
        values = _pair_values(self.potential, neighbor_distances)
        if pair_mask is not None:
            values = values * pair_mask
        return values

    def _compute_rspace(
        self, charges, neighbor_indices, neighbor_distances, pair_mask=None
    ) -> torch.Tensor:
        """Real-space neighbor sum.

        Two input layouts, dispatched on the distances' rank:

        * **pair list** ``indices (P, 2)`` / ``distances (P,)``: accumulated
          with ``index_add``;
        * **dense per-atom** ``indices (N, C)`` / ``distances (N, C)`` (from
          :func:`torchpme_tpu_torch.utils.neighbors.dense_neighbor_format`):
          a gather plus a dense reduction.  Dense lists are always "full";
          ``pair_mask`` flags the padded slots.
        """
        pair_values = self._bare_pair_values(neighbor_distances, pair_mask)
        if neighbor_distances.ndim == 2:
            neighbor_charges = charges.index_select(
                0, neighbor_indices.reshape(-1).long()
            ).reshape(*neighbor_indices.shape, -1)  # (N, C, channels)
            return torch.sum(neighbor_charges * pair_values[..., None], dim=1) / 2

        atom_is = neighbor_indices[:, 0].long()
        atom_js = neighbor_indices[:, 1].long()
        # q_j · v(r_ij) accumulated on atom i (index_select: its backward is
        # one atomic index_add instead of a sort of all pairs)
        potential = torch.zeros_like(charges).index_add(
            0, atom_is, charges.index_select(0, atom_js) * pair_values[:, None]
        )
        if not self.full_neighbor_list:
            # half lists store each pair once: add the mirrored (j, i) terms
            potential = potential.index_add(
                0, atom_js, charges.index_select(0, atom_is) * pair_values[:, None]
            )
        # compensate double counting of (i,j) and (j,i)
        return potential / 2

    # -- reciprocal space -----------------------------------------------------

    def _compute_kspace(self, charges, cell, positions, **kwargs) -> torch.Tensor:
        raise NotImplementedError(
            f"`_compute_kspace` not implemented for {type(self).__name__}"
        )

    # -- public forward -------------------------------------------------------

    def _rspace_from_inputs(
        self, charges, cell, positions, neighbor_indices, neighbor_distances, pair_mask,
        cell_list,
    ) -> torch.Tensor:
        """Dispatch the real-space sum: neighbor list or cell list (plain
        PyTorch per-atom windows,
        :func:`~torchpme_tpu_torch.ops.rspace_cells.cell_list_rspace_potentials`)."""
        if cell_list is not None:
            if neighbor_indices is not None or neighbor_distances is not None:
                raise ValueError("Pass either a neighbor list or a `cell_list`, not both")
            return cell_list_rspace_potentials(
                self.potential, charges, positions, cell, cell_list
            )
        if neighbor_indices is None or neighbor_distances is None:
            raise ValueError(
                "Provide `neighbor_indices` and `neighbor_distances`, or a "
                "`cell_list` from compute_cell_list"
            )
        return self._compute_rspace(
            charges, neighbor_indices, neighbor_distances, pair_mask
        )

    def forward(
        self,
        charges: torch.Tensor,
        cell: torch.Tensor,
        positions: torch.Tensor,
        neighbor_indices: torch.Tensor | None = None,
        neighbor_distances: torch.Tensor | None = None,
        periodic: torch.Tensor | None = None,
        node_mask: torch.Tensor | None = None,
        pair_mask: torch.Tensor | None = None,
        kvectors: torch.Tensor | None = None,
        cell_list=None,
        **kspace_kwargs,
    ) -> torch.Tensor:
        r"""Compute the per-atom potential "energy".

        :param charges: ``(n_atoms, n_channels)`` (pseudo-)charges; several
            channels evaluate several potentials at once.
        :param cell: ``(3, 3)`` cell matrix, rows are basis vectors.
        :param positions: ``(n_atoms, 3)`` Cartesian coordinates.
        :param neighbor_indices: ``(n_pairs, 2)`` ``i, j`` indices of the
            (externally computed) neighbor list, or the dense ``(N, C)``
            layout.
        :param neighbor_distances: ``(n_pairs,)`` pair distances (dense:
            ``(N, C)``).
        :param periodic: optional ``(3,)`` bool mask of periodic directions
            (the slab correction activates when exactly two are true).
        :param node_mask: optional ``(n_atoms,)`` bool mask for padded batches.
        :param pair_mask: optional bool mask for padded pairs.
        :param kvectors: precomputed k-vectors (Ewald only; mesh calculators
            refuse them).
        :param cell_list: a
            :class:`~torchpme_tpu_torch.ops.rspace_cells.CellList` from
            :func:`~torchpme_tpu_torch.ops.rspace_cells.compute_cell_list`,
            instead of a neighbor list: the real-space sum runs over the
            27-cell windows with distances recomputed from ``positions``
            (NaN once an atom has left its cell; refresh it like a neighbor
            list).
        :param kspace_kwargs: forwarded to the k-space part of a subclass
            (``ns_mesh``, ``tiled_interp``).
        :return: ``(n_atoms, n_channels)`` per-atom potentials; multiply by
            the charges and sum for the total energy.
        """
        validate_parameters(
            charges=charges,
            cell=cell,
            positions=positions,
            neighbor_indices=neighbor_indices,
            neighbor_distances=neighbor_distances,
            periodic=periodic,
            pair_mask=pair_mask,
            node_mask=node_mask,
            kvectors=kvectors,
        )
        potential_sr = self._rspace_from_inputs(
            charges, cell, positions, neighbor_indices, neighbor_distances, pair_mask,
            cell_list,
        )
        if self.potential.smearing is None:
            return potential_sr
        potential_lr = self._compute_kspace(
            charges=charges,
            cell=cell,
            positions=positions,
            periodic=periodic,
            kvectors=kvectors,
            node_mask=node_mask,
            **kspace_kwargs,
        )
        return potential_sr + potential_lr

    def energy(
        self,
        charges: torch.Tensor,
        cell: torch.Tensor,
        positions: torch.Tensor,
        neighbor_indices: torch.Tensor | None = None,
        neighbor_distances: torch.Tensor | None = None,
        pair_mask: torch.Tensor | None = None,
        cell_list=None,
        plain: bool = False,
        **kspace_kwargs,
    ) -> torch.Tensor:
        r"""Total energy :math:`E = \sum_i q_i V_i` (scalar).

        Same value as ``sum(calc(...) * charges)``.  Mesh calculators
        evaluate the k-space part as a quadratic form (Parseval: no inverse
        transform and no mesh→points gather).  ``kspace_kwargs`` are
        forwarded to the k-space part (``ns_mesh``, ``tiled_interp``,
        ``periodic``, ...).  With ``cell_list`` (a
        :class:`~torchpme_tpu_torch.ops.rspace_cells.CellList`, instead of a
        neighbor list) the real-space sum runs over the cell windows in
        bucket order: kernel C on a card, its unsmeared variant for a
        potential without smearing (direct mode).

        :param plain: run the kernels' plain versions on any device (the
            reference path of the comparisons).
        """
        validate_parameters(
            charges=charges,
            cell=cell,
            positions=positions,
            neighbor_indices=neighbor_indices,
            neighbor_distances=neighbor_distances,
            pair_mask=pair_mask,
        )
        if cell_list is not None:
            if neighbor_indices is not None or neighbor_distances is not None:
                raise ValueError("Pass either a neighbor list or a `cell_list`, not both")
            e_sr = cell_list_rspace_energy(
                self.potential, charges, positions, cell, cell_list, plain=plain
            )
        elif neighbor_indices is None or neighbor_distances is None:
            raise ValueError(
                "Provide `neighbor_indices` and `neighbor_distances`, or a "
                "`cell_list` from compute_cell_list"
            )
        else:
            pot_sr = self._compute_rspace(
                charges, neighbor_indices, neighbor_distances, pair_mask
            )
            e_sr = torch.sum(pot_sr * charges)
        if self.potential.smearing is None:
            return e_sr
        # per-atom node_mask semantics need the potential path
        kspace_energy = getattr(self, "_compute_kspace_energy", None)
        if kspace_energy is not None and kspace_kwargs.get("node_mask") is None:
            kspace_kwargs.pop("node_mask", None)
            return e_sr + kspace_energy(
                charges=charges, cell=cell, positions=positions, plain=plain,
                **kspace_kwargs,
            )
        pot_lr = self._compute_kspace(
            charges=charges, cell=cell, positions=positions, plain=plain, **kspace_kwargs
        )
        return e_sr + torch.sum(pot_lr * charges)
