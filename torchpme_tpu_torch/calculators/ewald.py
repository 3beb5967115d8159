"""Explicit-k-sum Ewald calculator.

Counterpart of :mod:`torchpme_tpu.calculators.ewald`.  The structure factor
is one ``(n_k, 3) @ (3, N)`` product, its cosines and sines, and two
contractions, in chunks of k-vectors that bound the ``(n_k, N)`` planes live
at once.  No kernel of the JAX package sits on this path (it is XLA code
there), so it is plain PyTorch on every device.  The quadratic energy
accumulates :math:`\\sum_k \\hat v(k)|S(k)|^2` in float64.
"""

from __future__ import annotations

import torch

from ..ops.kvectors import generate_kvectors_for_ewald, get_ns_ewald
from ..ops.math import det3
from .calculator import Calculator

__all__ = ["EwaldCalculator"]

# k-vectors per pass of the structure-factor sums: bounds the (n_k, N) trig
# planes that are live at once
_K_CHUNK = 16384


class EwaldCalculator(Calculator):
    r"""Potential computed with the classic Ewald sum, :math:`O(N^2)`.

    For :math:`O(N^{1.5})` scaling choose ``smearing = 1.3 N^{1/6}/\sqrt 2``,
    ``lr_wavelength = 2\pi·smearing/2.2`` and cutoff ``2.2·smearing``.

    :param potential: range-separated potential; ``smearing`` must be set.
    :param lr_wavelength: spatial resolution of the reciprocal-space sum; all
        k-vectors with wavelength ≥ this value are kept.
    :param full_neighbor_list: half (False) or full (True) neighbor list.

    Example
    -------
    CsCl Madelung constant (2.035361...):

    >>> import torch
    >>> from torchpme_tpu_torch import CoulombPotential, EwaldCalculator
    >>> from torchpme_tpu_torch.utils.neighbors import neighbor_list
    >>> f64 = torch.float64
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=f64)
    >>> charges = torch.tensor([[-1.0], [1.0]], dtype=f64)
    >>> cell = torch.eye(3, dtype=f64)
    >>> idx, dist, _ = neighbor_list(positions, cell, cutoff=1.2)
    >>> calc = EwaldCalculator(CoulombPotential(smearing=0.25), lr_wavelength=0.15)
    >>> pot = calc(charges, cell, positions, torch.as_tensor(idx), torch.as_tensor(dist))
    >>> print(f"{float(-torch.sum(pot * charges)):.5f}")
    2.03536
    """

    def __init__(self, potential, lr_wavelength: float = 0.5, full_neighbor_list: bool = False):
        super().__init__(potential, full_neighbor_list=full_neighbor_list)
        if potential.smearing is None:
            raise ValueError("Must specify range radius to use a potential with EwaldCalculator")
        if lr_wavelength <= 0:
            raise ValueError(f"`lr_wavelength` is {lr_wavelength} but must be positive")
        self.lr_wavelength = float(lr_wavelength)

    def extra_repr(self) -> str:
        return f"lr_wavelength={self.lr_wavelength}"

    def get_ns_kvectors(self, cell) -> tuple[int, int, int]:
        """Static per-axis k-space extents for a concrete cell; passed back
        as ``ns_kvectors`` the k-vectors are rebuilt from the
        (differentiable) cell inside the call, so cell gradients are exact."""
        return get_ns_ewald(cell, self.lr_wavelength)

    def compute_kvectors(self, cell: torch.Tensor) -> torch.Tensor:
        """The k-vector set of a cell, ``(n_k, 3)``."""
        return generate_kvectors_for_ewald(cell, self.get_ns_kvectors(cell))

    def _kspace_structure_setup(self, cell, positions, kvectors, ns_kvectors):
        """Per chunk of k-vectors: ``(v̂(k), cos(k·r), sin(k·r))``, the last
        two ``(n_k, N)``.  A precomputed ``kvectors`` is taken as
        independent of the cell (zero-padded batches); ``ns_kvectors``
        rebuilds them from ``cell``; neither: :meth:`compute_kvectors`."""
        if kvectors is None:
            if ns_kvectors is not None:
                kvectors = generate_kvectors_for_ewald(cell, tuple(int(n) for n in ns_kvectors))
            else:
                kvectors = self.compute_kvectors(cell)
        for start in range(0, kvectors.shape[0], _K_CHUNK):
            kv = kvectors[start : start + _K_CHUNK]
            # the kernel's k = 0 entry is 0, which also drops zero-padded k-vectors
            g_kernel = self.potential.lr_from_k_sq(torch.sum(kv**2, dim=-1))
            trig_args = torch.matmul(kv, positions.T)
            yield g_kernel, torch.cos(trig_args), torch.sin(trig_args)

    def _compute_kspace(
        self,
        charges: torch.Tensor,
        cell: torch.Tensor,
        positions: torch.Tensor,
        periodic: torch.Tensor | None = None,
        kvectors: torch.Tensor | None = None,
        node_mask: torch.Tensor | None = None,
        ns_kvectors: tuple[int, int, int] | None = None,
        plain: bool = False,
    ) -> torch.Tensor:
        del plain  # the explicit sums run no kernel
        energy = torch.zeros_like(charges)
        for g_kernel, cos, sin in self._kspace_structure_setup(
            cell, positions, kvectors, ns_kvectors
        ):
            # S(k) = Σ_j q_j e^{ik·r_j}, weighted by the kernel, back onto the atoms
            w_cos = torch.matmul(cos, charges) * g_kernel[:, None]
            w_sin = torch.matmul(sin, charges) * g_kernel[:, None]
            energy = energy + torch.matmul(cos.T, w_cos) + torch.matmul(sin.T, w_sin)
        volume = torch.abs(det3(cell))
        energy = energy / volume
        # the self interaction of each particle with its own screening density
        energy = energy - charges * self.potential.self_contribution()
        # neutralizing background of a charged cell (×2 compensates the final /2)
        charge_tot = torch.sum(charges, dim=0)
        energy = energy - 2 * self.potential.background_correction() * charge_tot / volume
        energy = energy + self.potential.pbc_correction(periodic, positions, cell, charges)
        if node_mask is not None:
            energy = energy * node_mask[:, None]
        # compensate double counting of pairs (i,j) and (j,i)
        return energy / 2

    def _compute_kspace_energy(
        self,
        charges: torch.Tensor,
        cell: torch.Tensor,
        positions: torch.Tensor,
        periodic: torch.Tensor | None = None,
        kvectors: torch.Tensor | None = None,
        ns_kvectors: tuple[int, int, int] | None = None,
        plain: bool = False,
    ) -> torch.Tensor:
        r"""Total k-space energy :math:`\sum_i q_i V_i^{LR} = \tfrac1V\sum_k
        \hat v(k)|S(k)|^2` (plus the corrections), the scalar path of
        :meth:`Calculator.energy`: no second contraction back onto the atoms.
        Matches ``sum(_compute_kspace(...) * charges)``; the sums accumulate
        in float64 and the result has the dtype of ``positions``."""
        del plain  # the explicit sums run no kernel
        f64 = torch.float64
        quad = torch.zeros((), dtype=f64, device=positions.device)
        for g_kernel, cos, sin in self._kspace_structure_setup(
            cell, positions, kvectors, ns_kvectors
        ):
            s_cos = torch.matmul(cos, charges)
            s_sin = torch.matmul(sin, charges)
            quad = quad + torch.sum(g_kernel[:, None] * (s_cos**2 + s_sin**2), dtype=f64)
        volume = torch.abs(det3(cell)).to(f64)
        e = quad / volume
        e = e - self.potential.self_contribution() * torch.sum(charges**2, dtype=f64)
        charge_tot = torch.sum(charges, dim=0, dtype=f64)
        e = e - 2 * self.potential.background_correction() * torch.sum(charge_tot**2) / volume
        if periodic is not None:
            e = e + torch.sum(
                self.potential.pbc_correction(periodic, positions, cell, charges) * charges,
                dtype=f64,
            )
        # compensate double counting of pairs (i,j) and (j,i)
        return (e / 2).to(positions.dtype)

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
        ns_kvectors: tuple[int, int, int] | None = None,
        cell_list=None,
        plain: bool = False,
    ) -> torch.Tensor:
        """Same contract as :meth:`Calculator.forward` (a neighbor list or a
        ``cell_list``), plus ``ns_kvectors``: static k-space extents (from
        :meth:`get_ns_kvectors`) from which the k-vectors are rebuilt from
        ``cell`` inside the call, so the cell gradient (stress) is exact; a
        precomputed ``kvectors`` is taken as independent of the cell
        (zero-padded batches)."""
        return super().forward(
            charges, cell, positions, neighbor_indices, neighbor_distances,
            periodic=periodic, node_mask=node_mask, pair_mask=pair_mask,
            kvectors=kvectors, cell_list=cell_list, ns_kvectors=ns_kvectors, plain=plain,
        )
