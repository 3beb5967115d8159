r"""Dipolar particle-mesh Ewald: O(N log N) k-space for point dipoles.

Counterpart of :mod:`torchpme_tpu.calculators.pme_dipole`.  The explicit
Ewald sum of :class:`CalculatorDipole` costs :math:`O(N\cdot n_k)`; this
calculator replaces it with a mesh pipeline:

* **spread**: the dipolar mesh density is the *gradient* spread
  :math:`Q(m) = \sum_j \vec\mu_j\cdot\nabla_{r_j} W_j(m)`, from the
  analytically differentiated 1D stencil tables.  On the tiled backend it is
  the three gradient stencils of each slot in one pass of kernel D's dipole
  form
  (:func:`~torchpme_tpu_torch.ops.mesh_tiled.tiled_dipoles_to_mesh`);
* **filter**: by the continuum shift identity :math:`\widehat Q(k) =
  -i\,\hat w(k)\,S(k)` with :math:`S(k) = \sum_j (\vec\mu_j\cdot\vec k)
  e^{-ik\cdot r_j}`, so the scalar k-space machinery applies:
  :math:`E^{LR} = \langle Q, K\circledast Q\rangle/(2V)` with the Gaussian
  Coulomb kernel, on cuFFT (the JAX package's DFT-by-matmul branch is a TPU
  choice and is not ported);
* **gather**: the per-atom vector field interpolates back with the same
  gradient stencil (kernel E's dipole form), the exact transpose of the spread, so autograd
  gives forces, fields and the cell gradient.

Drop-in for :class:`CalculatorDipole` (same ``forward`` / ``energy`` /
real-space path; only the k-space part changes).
"""

from __future__ import annotations

import torch

from .. import kernels as _k
from ..ops.kspace import apply_kspace_filter, compute_kspace_filter, kspace_filter_quadratic
from ..ops.kvectors import get_ns_mesh
from ..ops.math import det3, inv3
from ..ops.mesh import (
    _weight_coefficients,
    compute_dipole_interpolation,
    dipoles_to_mesh,
    mesh_to_dipole_field,
)
from ..ops.mesh_tiled import (
    TiledInterpolation,
    compute_tiled_interpolation,
    refresh_tiled_interpolation,
    supports_tiling,
    tiled_dipoles_to_mesh,
    tiled_mesh_to_dipole_field,
)
from .dipole import CalculatorDipole
from .pme import _poison

__all__ = ["PMECalculatorDipole"]

_STALE = (
    "The provided `tiled_interp` bucketing is stale: atoms have drifted out of "
    "their tile's stencil window (or it was built with overflow). Rebucket with "
    "compute_tiled_interpolation(derivatives=True)."
)


class PMECalculatorDipole(CalculatorDipole):
    r"""Mesh Ewald for point dipoles (gradient spread + scalar k-filter).

    :param potential: a :class:`~torchpme_tpu_torch.potentials.PotentialDipole`;
        ``smearing`` must be set.
    :param mesh_spacing: target distance between mesh planes (the mesh is
        rounded up to powers of two per axis, as for the scalar PME).
    :param interpolation_nodes: Lagrange stencil size per axis (3–7).  The
        *derivative* interpolation loses one order of accuracy, so the
        default is 6.
    :param full_neighbor_list: half (False) or full (True) neighbor list.
    :param mesh_backend: ``"auto"`` takes the tiled backend (kernels D, E,
        F) where the mesh tiles and the tensors are on a CUDA device, the
        scatter backend otherwise; ``"tiled"`` / ``"scatter"`` force one.
    :param tile_capacity: per-tile atom capacity of the tiled backend
        (default: from the true maximum occupancy).
    :param _method: stencil tables; only the interpolatory ``"Lagrange"``
        family is supported (B-spline spreading would need an influence
        function correction).

    Example
    -------
    Matches the O(N·n_k) Ewald dipolar calculator to mesh accuracy:

    >>> import numpy as np, torch
    >>> import torchpme_tpu_torch as tpt
    >>> from torchpme_tpu_torch.utils.neighbors import neighbor_list
    >>> rng = np.random.default_rng(0)
    >>> pos = torch.tensor(rng.uniform(0, 6.0, (40, 3)))
    >>> mu = torch.tensor(rng.normal(size=(40, 3)))
    >>> cell = torch.eye(3, dtype=torch.float64) * 6.0
    >>> idx, _, shifts = (torch.as_tensor(a) for a in neighbor_list(pos, cell, cutoff=2.5))
    >>> vec = pos[idx[:, 1]] - pos[idx[:, 0]] + shifts.to(pos.dtype) @ cell
    >>> pme = tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=0.9), mesh_spacing=0.35)
    >>> ew = tpt.CalculatorDipole(tpt.PotentialDipole(smearing=0.9), lr_wavelength=0.5)
    >>> e_pme = torch.sum(pme(mu, cell, pos, idx, vec) * mu)
    >>> e_ew = torch.sum(ew(mu, cell, pos, idx, vec) * mu)
    >>> print(bool(torch.abs(e_pme - e_ew) < 1e-4 * torch.abs(e_ew)))
    True
    """

    def __init__(
        self,
        potential,
        mesh_spacing: float = 1.0,
        interpolation_nodes: int = 6,
        full_neighbor_list: bool = False,
        mesh_backend: str = "auto",
        tile_capacity: int | None = None,
        _method: str = "Lagrange",
    ):
        super().__init__(potential, full_neighbor_list=full_neighbor_list)
        if mesh_spacing <= 0:
            raise ValueError(f"`mesh_spacing` is {mesh_spacing} but must be positive")
        if _method != "Lagrange":
            raise ValueError(
                "PMECalculatorDipole supports only the interpolatory "
                "'Lagrange' stencils: B-spline (P3M) spreading biases the "
                "quadratic form by the squared stencil transform without "
                "an influence-function correction"
            )
        _weight_coefficients(_method, interpolation_nodes)
        if mesh_backend not in ("auto", "tiled", "scatter"):
            raise ValueError(
                f"`mesh_backend` is {mesh_backend!r} but must be 'auto', 'tiled' "
                "or 'scatter'"
            )
        self.mesh_spacing = float(mesh_spacing)
        self.interpolation_nodes = int(interpolation_nodes)
        self.mesh_backend = mesh_backend
        self.tile_capacity = tile_capacity
        self._method = _method

    def _check_lr_wavelength(self) -> None:
        if self.potential.smearing is None:
            raise ValueError(
                "Must specify smearing to use a potential with PMECalculatorDipole"
            )

    def extra_repr(self) -> str:
        return (
            f"mesh_spacing={self.mesh_spacing}, "
            f"interpolation_nodes={self.interpolation_nodes}, "
            f"mesh_backend={self.mesh_backend!r}"
        )

    def get_ns_kvectors(self, cell) -> tuple[int, int, int]:
        """Static MESH shape for a concrete cell (named for drop-in reuse by
        the dipolar MD state, which passes it back as ``ns_kvectors``)."""
        return get_ns_mesh(cell, self.mesh_spacing)

    get_ns_mesh = get_ns_kvectors

    def compute_kvectors(self, cell) -> torch.Tensor:
        raise NotImplementedError(
            "PMECalculatorDipole has no explicit k-vector set; pass "
            "`ns_kvectors=calc.get_ns_mesh(cell)` instead"
        )

    def _use_tiled(self, ns, device) -> bool:
        if self.mesh_backend == "auto":
            return (
                supports_tiling(ns, self.interpolation_nodes)
                and torch.device(device).type == "cuda"
            )
        return self.mesh_backend == "tiled"

    def _dipole_mesh_density(
        self, dipoles, cell, positions, kvectors, ns_kvectors, tiled_interp,
        check_stale: bool = True, plain: bool = False,
    ):
        r"""Shared spread half of the k-space paths: the gradient-spread mesh
        density :math:`Q(m) = \sum_j \vec\mu_j\cdot\nabla W_j(m)`.

        Returns ``(q_mesh, interp, mesh_valid, ns)``; ``interp`` is a
        :class:`TiledInterpolation` on the tiled backend; ``mesh_valid`` is the
        on-device validity flag of a reused bucketing (``None`` otherwise).
        ``check_stale`` reads the flag and raises (one device sync); without
        it the caller poisons its result with NaN instead.  Under
        ``torch.func.vmap`` nothing is read on the host: a fresh bucketing's
        flag is "no atom dropped", and each system whose flag is false is
        poisoned, as in the JAX package.
        """
        if kvectors is not None:
            raise ValueError(
                "PMECalculatorDipole takes `ns_kvectors` (the mesh shape), "
                "not an explicit `kvectors` set"
            )
        if ns_kvectors is None and tiled_interp is not None:
            ns_kvectors = tiled_interp.ns
        ns = (
            tuple(int(n) for n in ns_kvectors)
            if ns_kvectors is not None
            else self.get_ns_kvectors(cell)
        )
        dtype = positions.dtype
        dipoles = dipoles.to(dtype)
        inverse_cell = inv3(cell)
        use_tiled = self._use_tiled(ns, positions.device)
        if tiled_interp is not None and not use_tiled:
            raise ValueError(
                "a `tiled_interp` bucketing was supplied but the tiled mesh "
                f"backend is not selected (mesh_backend={self.mesh_backend!r}, "
                f"ns={ns}); pass mesh_backend='tiled' or drop the bucketing"
            )
        if not use_tiled:
            interp = compute_dipole_interpolation(
                positions, inverse_cell, ns, self.interpolation_nodes, self._method
            )
            return dipoles_to_mesh(interp, dipoles), interp, None, ns

        mesh_valid = None
        # under vmap, or while a graph is traced, nothing is read on the host
        batched = _k.is_batched(dipoles, cell, positions) or _k.is_tracing()
        if tiled_interp is not None:
            # bucket reuse (MD): refresh only the per-slot geometry
            interp, mesh_valid = refresh_tiled_interpolation(
                tiled_interp, positions, inverse_cell, self._method
            )
            if check_stale and not batched and not bool(mesh_valid):
                raise ValueError(_STALE)
        else:
            interp = compute_tiled_interpolation(
                positions, inverse_cell, ns, self.interpolation_nodes, self._method,
                capacity=self.tile_capacity, derivatives=True,
            )
            if batched:
                # under vmap the count stays on the device: poison, not raise
                mesh_valid = interp.dropped == 0
            elif int(interp.dropped):
                raise ValueError(
                    f"{int(interp.dropped)} atoms exceeded the tile capacity "
                    "of the tiled dipolar mesh backend; pass a larger "
                    "`tile_capacity` or mesh_backend='scatter'."
                )
        # effective per-axis charges: chain rule through rel = pos@C⁻¹·ns
        ns_t = torch.tensor(ns, dtype=dtype, device=positions.device)
        nu = torch.matmul(dipoles, inverse_cell) * ns_t
        q_mesh = tiled_dipoles_to_mesh(interp, nu, plain=plain)
        return q_mesh, interp, mesh_valid, ns

    def _compute_kspace(
        self, dipoles, cell, positions, kvectors=None, ns_kvectors=None,
        tiled_interp: TiledInterpolation | None = None, plain: bool = False,
    ) -> torch.Tensor:
        q_mesh, interp, mesh_valid, ns = self._dipole_mesh_density(
            dipoles, cell, positions, kvectors, ns_kvectors, tiled_interp, plain=plain
        )
        kfilter = compute_kspace_filter(self.potential.lr_from_k_sq, cell, ns)
        # backward/forward norm pair: no 1/n factor in either direction
        filtered = apply_kspace_filter(
            q_mesh, kfilter, fft_norm="backward", ifft_norm="forward"
        )
        volume = torch.abs(det3(cell))
        if isinstance(interp, TiledInterpolation):
            e_rel = tiled_mesh_to_dipole_field(interp, filtered, plain=plain)
            e_rel = e_rel / volume
            ns_t = torch.tensor(ns, dtype=e_rel.dtype, device=e_rel.device)
            field = torch.einsum("na,ba,a->nb", e_rel, inv3(cell), ns_t)
            if mesh_valid is not None:
                # a stale bucketing poisons the result multiplicatively, so
                # the NaN rides every gradient
                field = field * _poison(mesh_valid, field)
        else:
            field = mesh_to_dipole_field(interp, filtered) / volume
        field = field - dipoles * self.potential.self_contribution()
        field = field + self.potential.background_correction(volume) * torch.sum(
            dipoles, dim=0
        )
        return field / 2

    def _compute_kspace_energy(
        self, dipoles, cell, positions, kvectors=None, ns_kvectors=None,
        tiled_interp: TiledInterpolation | None = None, check_stale: bool = True,
        plain: bool = False,
    ) -> torch.Tensor:
        r"""Total k-space energy :math:`\sum_i \vec V_i^{LR}\cdot\vec\mu_i`
        as the Parseval quadratic form on the gradient-spread mesh.

        Because the gather stencil is the exact transpose of the spread,
        :math:`\sum_i \vec\mu_i\cdot\vec E_i = \langle Q, K\circledast Q
        \rangle/V`, evaluated directly in k-space
        (:func:`~torchpme_tpu_torch.ops.kspace.kspace_filter_quadratic`): no
        inverse transform and no mesh→points gather in the forward.  Matches
        ``sum(_compute_kspace(...) * dipoles)``.  The scalar terms are
        assembled in float64; the result has the mesh's dtype.

        With ``check_stale=False`` a stale ``tiled_interp`` gives NaN (value
        and gradients) instead of an error, without waiting for the device.
        """
        q_mesh, _, mesh_valid, ns = self._dipole_mesh_density(
            dipoles, cell, positions, kvectors, ns_kvectors, tiled_interp,
            check_stale=check_stale, plain=plain,
        )
        kfilter = compute_kspace_filter(self.potential.lr_from_k_sq, cell, ns)
        f64 = torch.float64
        volume = torch.abs(det3(cell))
        e = kspace_filter_quadratic(q_mesh, kfilter) / volume.to(f64)
        if mesh_valid is not None:
            e = e * _poison(mesh_valid, e)
        e = e - self.potential.self_contribution() * torch.sum(dipoles**2, dtype=f64)
        mu_tot = torch.sum(dipoles, dim=0, dtype=f64)
        e = e + self.potential.background_correction(volume) * torch.sum(mu_tot**2)
        return (e / 2).to(q_mesh.dtype)
