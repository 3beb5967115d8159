"""Dipolar direct + Ewald calculator.

Counterpart of :mod:`torchpme_tpu.calculators.dipole`.  Takes neighbor
*vectors* (not distances): the real-space kernel is a 3×3 tensor per pair
contracted with the neighbor dipoles, the k-space part projects the dipoles
on the k-vectors.  The pair tensors are never materialized: every kernel is
``B(r)·I − C(r)·r⊗r``, so the contraction with a dipole is
``B μ − C (μ·r) r`` from the potential's scalar forms.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kvectors import generate_kvectors_for_ewald, get_ns_ewald
from ..ops.math import det3
from ..ops.rspace_cells_dipole import cell_list_rspace_dipole_energy
from ..potentials.dipole import PotentialDipole
from ..utils.validation import validate_parameters

__all__ = ["CalculatorDipole"]

# k-vectors per pass of the structure-factor sums: bounds the (n_k, N) trig
# planes that are live at once
_K_CHUNK = 16384


class CalculatorDipole(nn.Module):
    r"""Evaluates :math:`\vec V_i = \frac12\sum_j \mathbf v(\vec r_{ij})\,\vec\mu_j`.

    :param potential: a :class:`~torchpme_tpu_torch.potentials.PotentialDipole`;
        its ``smearing`` decides whether the Ewald k-space part is evaluated.
    :param full_neighbor_list: half (False) or full (True) neighbor list.
    :param lr_wavelength: reciprocal-space resolution; must be set together
        with the potential's ``smearing`` (or both unset for direct mode).

    Example
    -------
    Two parallel unit dipoles at distance 2 (direct mode,
    :math:`E = \mu^2/r^3 = 1/8`):

    >>> import torch
    >>> from torchpme_tpu_torch import CalculatorDipole, PotentialDipole
    >>> dipoles = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    >>> idx = torch.tensor([[0, 1]])
    >>> vec = positions[idx[:, 1]] - positions[idx[:, 0]]
    >>> calc = CalculatorDipole(PotentialDipole())
    >>> pot = calc(dipoles, torch.eye(3) * 10, positions, idx, vec)
    >>> print(f"{float(torch.sum(pot * dipoles)):.4f}")
    0.1250
    """

    def __init__(
        self,
        potential: PotentialDipole,
        full_neighbor_list: bool = False,
        lr_wavelength: float | None = None,
    ):
        super().__init__()
        if not isinstance(potential, PotentialDipole):
            raise TypeError(
                f"Potential must be an instance of PotentialDipole, got {type(potential)}"
            )
        self.potential = potential
        self.full_neighbor_list = bool(full_neighbor_list)
        self.lr_wavelength = None if lr_wavelength is None else float(lr_wavelength)
        self._check_lr_wavelength()

    def _check_lr_wavelength(self) -> None:
        if (self.lr_wavelength is None) != (self.potential.smearing is None):
            raise ValueError(
                "Either both `lr_wavelength` and `smearing` must be set or both "
                "must be None"
            )

    # -- real space -----------------------------------------------------------

    def _pair_fields(self, vectors: torch.Tensor, neighbor_dipoles: torch.Tensor):
        """``K(r)·μ = B μ − C (μ·r) r`` per pair (any leading shape)."""
        dist = torch.linalg.norm(vectors, dim=-1)
        if self.potential.smearing is None:
            b, c = self.potential.scalar_kernels(dist)
        else:
            b, c = self.potential.sr_scalar_kernels(dist)
        mu_r = torch.sum(neighbor_dipoles * vectors, dim=-1)
        return b[..., None] * neighbor_dipoles - (c * mu_r)[..., None] * vectors

    def _compute_rspace(
        self, dipoles, neighbor_indices, neighbor_vectors, pair_mask=None
    ) -> torch.Tensor:
        """Real-space neighbor sum, ``(N, 3)``.

        * **pair list** ``indices (P, 2)`` / ``vectors (P, 3)``: gathered with
          ``index_select`` and accumulated with ``index_add`` (advanced
          indexing's backward sorts all pairs);
        * **dense per-atom** ``indices (N, C)`` / ``vectors (N, C, 3)``: a
          gather plus a dense reduction; padded slots get a unit vector so the
          ``1/r^k`` kernels stay finite, then are masked.  Dense lists are
          always "full".
        """
        if neighbor_vectors.ndim == 3:
            n_atoms, cap = neighbor_vectors.shape[:2]
            if pair_mask is None:
                pair_mask = torch.ones(
                    (n_atoms, cap), dtype=torch.bool, device=neighbor_vectors.device
                )
            unit = torch.zeros_like(neighbor_vectors)
            unit[..., 0] = 1.0
            safe = torch.where(pair_mask[..., None], neighbor_vectors, unit)
            mu_j = dipoles.index_select(0, neighbor_indices.reshape(-1).long())
            fields = self._pair_fields(safe, mu_j.reshape(n_atoms, cap, 3))
            return torch.sum(fields * pair_mask[..., None], dim=1) / 2

        atom_is = neighbor_indices[:, 0].long()
        atom_js = neighbor_indices[:, 1].long()
        potential = torch.zeros_like(dipoles).index_add(
            0, atom_is, self._pair_fields(neighbor_vectors, dipoles.index_select(0, atom_js))
        )
        if not self.full_neighbor_list:
            # half lists store each pair once: add the mirrored (j, i) terms
            potential = potential.index_add(
                0, atom_js,
                self._pair_fields(neighbor_vectors, dipoles.index_select(0, atom_is)),
            )
        return potential / 2

    # -- reciprocal space -----------------------------------------------------

    def get_ns_kvectors(self, cell) -> tuple[int, int, int]:
        """Static k-space extents for a concrete cell; passed back as
        ``ns_kvectors`` the k-vectors are rebuilt from the (differentiable)
        cell inside the call."""
        return get_ns_ewald(cell, self.lr_wavelength)

    def compute_kvectors(self, cell: torch.Tensor) -> torch.Tensor:
        """The k-vector set of a cell, ``(n_k, 3)``."""
        return generate_kvectors_for_ewald(cell, self.get_ns_kvectors(cell))

    def _kvectors(self, cell, kvectors, ns_kvectors) -> torch.Tensor:
        if kvectors is not None:
            return kvectors
        if ns_kvectors is not None:
            return generate_kvectors_for_ewald(cell, tuple(int(n) for n in ns_kvectors))
        return self.compute_kvectors(cell)

    def _structure_chunks(self, positions, kvectors):
        """Per chunk of k-vectors: ``(k, v̂(k), cos(k·r), sin(k·r))`` with
        the last two ``(n_k, N)``."""
        for start in range(0, kvectors.shape[0], _K_CHUNK):
            kv = kvectors[start : start + _K_CHUNK]
            g_kernel = self.potential.lr_from_k_sq(torch.sum(kv**2, dim=-1))
            trig_args = torch.matmul(kv, positions.T)
            yield kv, g_kernel, torch.cos(trig_args), torch.sin(trig_args)

    def _compute_kspace(
        self, dipoles, cell, positions, kvectors=None, ns_kvectors=None, plain=False
    ) -> torch.Tensor:
        del plain  # the explicit sums run no kernel
        kvectors = self._kvectors(cell, kvectors, ns_kvectors)
        energy = torch.zeros_like(dipoles)
        for kv, g_kernel, cos, sin in self._structure_chunks(positions, kvectors):
            mu_k = torch.matmul(kv, dipoles.T)
            # S(k) = Σ_j (μ_j·k) e^{ik·r_j}, weighted by the kernel
            w_cos = torch.sum(cos * mu_k, dim=1) * g_kernel
            w_sin = torch.sum(sin * mu_k, dim=1) * g_kernel
            per_k = w_cos[:, None] * cos + w_sin[:, None] * sin  # (n_k, N)
            energy = energy + torch.matmul(per_k.T, kv)
        volume = torch.abs(det3(cell))
        energy = energy / volume
        energy = energy - dipoles * self.potential.self_contribution()
        energy = energy + self.potential.background_correction(volume) * torch.sum(
            dipoles, dim=0
        )
        return energy / 2

    def _compute_kspace_energy(
        self, dipoles, cell, positions, kvectors=None, ns_kvectors=None, plain=False
    ) -> torch.Tensor:
        r"""Total k-space energy :math:`\sum_i \vec V_i^{LR}\cdot\vec\mu_i`
        as a quadratic form.

        The dipolar structure factor is :math:`S(k) = \sum_j
        (\vec\mu_j\cdot\vec k)\,e^{ik\cdot r_j}`, so the per-atom field
        contracted with the dipoles collapses to
        :math:`\frac1{2V}\sum_k \hat v(k)\,|S(k)|^2` plus the self and
        background corrections, with no second :math:`O(N\cdot n_k)`
        contraction back onto the atoms.  Matches
        ``sum(_compute_kspace(...) * dipoles)``.  The scalar sums accumulate
        in float64; the result has the dtype of ``positions``.
        """
        del plain  # the explicit sums run no kernel
        f64 = torch.float64
        kvectors = self._kvectors(cell, kvectors, ns_kvectors)
        quad = torch.zeros((), dtype=f64, device=positions.device)
        for kv, g_kernel, cos, sin in self._structure_chunks(positions, kvectors):
            # Σ_j (μ_j·k) cos(k·r_j) = k · Σ_j cos(k·r_j) μ_j: one (n_k, N) × (N, 3)
            # product, no (n_k, N) array of μ·k
            s_cos = torch.sum(kv * torch.matmul(cos, dipoles), dim=1)
            s_sin = torch.sum(kv * torch.matmul(sin, dipoles), dim=1)
            quad = quad + torch.sum(g_kernel * (s_cos**2 + s_sin**2), dtype=f64)
        volume = torch.abs(det3(cell))
        e = quad / volume.to(f64)
        e = e - self.potential.self_contribution() * torch.sum(dipoles**2, dtype=f64)
        mu_tot = torch.sum(dipoles, dim=0, dtype=f64)
        e = e + self.potential.background_correction(volume) * torch.sum(mu_tot**2)
        return (e / 2).to(positions.dtype)

    # -- public entry points -----------------------------------------------------

    @staticmethod
    def _validate(dipoles, cell, positions, neighbor_indices, neighbor_vectors):
        validate_parameters(
            charges=dipoles,
            cell=cell,
            positions=positions,
            neighbor_indices=neighbor_indices,
            neighbor_distances=(
                None if neighbor_vectors is None
                else torch.linalg.norm(neighbor_vectors.detach(), dim=-1)
            ),
        )

    def energy(
        self,
        dipoles: torch.Tensor,
        cell: torch.Tensor,
        positions: torch.Tensor,
        neighbor_indices: torch.Tensor | None = None,
        neighbor_vectors: torch.Tensor | None = None,
        pair_mask: torch.Tensor | None = None,
        cell_list=None,
        plain: bool = False,
        **kspace_kwargs,
    ) -> torch.Tensor:
        r"""Total dipolar energy :math:`E = \sum_i \vec V_i\cdot\vec\mu_i`
        (scalar).

        With ``cell_list`` (a
        :class:`~torchpme_tpu_torch.ops.rspace_cells.CellList`) the
        real-space sum runs through the cell-list window
        (:func:`~torchpme_tpu_torch.ops.rspace_cells_dipole.cell_list_rspace_dipole_energy`,
        kernel G on a card).  Autograd with respect to ``positions`` gives
        minus the forces, with respect to ``dipoles`` the fields.  Matches
        ``sum(calc(...) * dipoles)`` on the same pair set.

        :param plain: run the kernels' plain versions on any device.
        :param kspace_kwargs: forwarded to the k-space part (``kvectors``,
            ``ns_kvectors``; a mesh subclass also takes ``tiled_interp``).
        """
        self._validate(dipoles, cell, positions, neighbor_indices, neighbor_vectors)
        if cell_list is not None:
            if neighbor_indices is not None or neighbor_vectors is not None:
                raise ValueError("Pass either a neighbor list or a `cell_list`, not both")
            e_sr = cell_list_rspace_dipole_energy(
                self.potential, dipoles, positions, cell, cell_list, plain=plain
            )
        elif neighbor_indices is None or neighbor_vectors is None:
            raise ValueError(
                "Provide `neighbor_indices` and `neighbor_vectors`, or a "
                "`cell_list` from compute_cell_list"
            )
        else:
            pot_sr = self._compute_rspace(
                dipoles, neighbor_indices, neighbor_vectors, pair_mask
            )
            e_sr = torch.sum(pot_sr * dipoles)
        if self.potential.smearing is None:
            return e_sr
        return e_sr + self._compute_kspace_energy(
            dipoles, cell, positions, plain=plain, **kspace_kwargs
        )

    def forward(
        self,
        dipoles: torch.Tensor,
        cell: torch.Tensor,
        positions: torch.Tensor,
        neighbor_indices: torch.Tensor,
        neighbor_vectors: torch.Tensor,
        pair_mask: torch.Tensor | None = None,
        plain: bool = False,
        **kspace_kwargs,
    ) -> torch.Tensor:
        r"""Compute the per-atom dipolar potential.

        :param dipoles: ``(n_atoms, 3)`` point dipoles.
        :param cell: ``(3, 3)`` cell matrix.
        :param positions: ``(n_atoms, 3)`` coordinates.
        :param neighbor_indices: ``(n_pairs, 2)`` neighbor-list indices (or
            the dense ``(N, C)`` layout).
        :param neighbor_vectors: ``(n_pairs, 3)`` pair displacement vectors
            (dense: ``(N, C, 3)``).
        :param pair_mask: optional bool mask of the dense layout's slots.
        :param plain: run the kernels' plain versions on any device.
        :param kspace_kwargs: ``kvectors`` (precomputed k-vectors) or
            ``ns_kvectors`` (static extents); a mesh subclass also takes
            ``tiled_interp``.
        :return: ``(n_atoms, 3)`` per-atom potential vectors; contract with
            the dipoles and sum for the total energy.
        """
        self._validate(dipoles, cell, positions, neighbor_indices, neighbor_vectors)
        potential_sr = self._compute_rspace(
            dipoles, neighbor_indices, neighbor_vectors, pair_mask
        )
        if self.potential.smearing is None:
            return potential_sr
        return potential_sr + self._compute_kspace(
            dipoles, cell, positions, plain=plain, **kspace_kwargs
        )
