"""Particle-mesh Ewald (PME) calculator, O(N log N).

Counterpart of :mod:`torchpme_tpu.calculators.pme`.  The k-space pipeline is
a chain of differentiable functions (stencil interpolation → spread → 3D
rFFT filter → gather back), so the whole forward, including the filter,
which depends on ``cell``, differentiates with respect to positions,
charges and cell.  On CUDA float32 tensors the tiled backend spreads and
gathers through the hand-written kernels of
:mod:`~torchpme_tpu_torch.ops.mesh_kernels`, and the fused backend spreads
the quadratic energy path's density through those of
:mod:`~torchpme_tpu_torch.ops.spread_fused`; the transform is cuFFT.
"""

from __future__ import annotations

import torch

from .. import kernels as _k
from ..ops.kspace import apply_kspace_filter, compute_kspace_filter, kspace_filter_quadratic
from ..ops.kvectors import get_ns_mesh
from ..ops.math import det3, inv3
from ..ops.mesh import compute_interpolation, mesh_to_points, points_to_mesh
from ..ops.mesh_tiled import (
    TiledInterpolation,
    compute_tiled_interpolation,
    refresh_tiled_interpolation,
    supports_tiling,
    tiled_mesh_to_points,
    tiled_points_to_mesh,
)
from ..ops.spread_fused import fused_tiled_density, supports_fused
from .calculator import Calculator

__all__ = ["PMECalculator"]

_STALE = (
    "The provided `tiled_interp` bucketing is stale: atoms have drifted out of "
    "their tile's stencil window (or it was built with overflow). Rebucket with "
    "compute_tiled_interpolation, like refreshing a neighbor list."
)


def _poison(mesh_valid: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """1 where the bucketing is valid, NaN otherwise; a multiplier, so the
    NaN also rides the backward pass."""
    return torch.where(mesh_valid, 1.0, float("nan")).to(like.dtype)


class PMECalculator(Calculator):
    r"""Mesh Ewald with Lagrange interpolation (smooth PME).

    :param potential: range-separated potential; ``smearing`` must be set
        (a reasonable default is 1/5 of the neighbor-list cutoff).
    :param mesh_spacing: target distance between mesh planes; the mesh is
        rounded up to powers of two per axis.
    :param interpolation_nodes: stencil size ``n`` per axis (``n³`` points
        per particle), 3–7.
    :param full_neighbor_list: half (False) or full (True) neighbor list.
    :param mesh_backend: ``"auto"`` takes the tiled backend where the mesh
        tiles (:func:`~torchpme_tpu_torch.ops.mesh_tiled.supports_tiling`)
        and the tensors are on a CUDA device, the scatter backend otherwise;
        ``"tiled"`` / ``"scatter"`` force one.  ``"fused"`` behaves like
        ``"tiled"`` except on the quadratic energy path (:meth:`energy`) with
        a reusable ``tiled_interp``, float32 data and a tile capacity that is
        a multiple of 8: there the refresh and the spread make way for
        :func:`~torchpme_tpu_torch.ops.spread_fused.fused_tiled_density`
        (kernels A and B on a card).
    :param tile_capacity: per-tile atom capacity of the tiled backend
        (default: from the true maximum occupancy).

    Example
    -------
    CsCl Madelung constant (2.035361...) to mesh accuracy:

    >>> import torch
    >>> from torchpme_tpu_torch import CoulombPotential, PMECalculator
    >>> from torchpme_tpu_torch.utils.neighbors import neighbor_list
    >>> f64 = torch.float64
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=f64)
    >>> charges = torch.tensor([[-1.0], [1.0]], dtype=f64)
    >>> cell = torch.eye(3, dtype=f64)
    >>> idx, dist, _ = neighbor_list(positions, cell, cutoff=1.2)
    >>> calc = PMECalculator(CoulombPotential(smearing=0.25), mesh_spacing=0.1)
    >>> pot = calc(charges, cell, positions, torch.as_tensor(idx), torch.as_tensor(dist))
    >>> print(f"{float(-torch.sum(pot * charges)):.3f}")
    2.035
    """

    _method = "Lagrange"
    #: the stencil sizes the method's weight tables hold (first, last)
    _NODES = (3, 7)

    def __init__(
        self,
        potential,
        mesh_spacing: float = 1.0,
        interpolation_nodes: int = 4,
        full_neighbor_list: bool = False,
        mesh_backend: str = "auto",
        tile_capacity: int | None = None,
    ):
        super().__init__(potential, full_neighbor_list=full_neighbor_list)
        if potential.smearing is None:
            raise ValueError(
                f"Must specify smearing to use a potential with {type(self).__name__}"
            )
        lo, hi = self._NODES
        if interpolation_nodes not in range(lo, hi + 1):
            raise ValueError(
                f"`interpolation_nodes` is {interpolation_nodes} but only "
                f"values from {lo} to {hi} for method '{self._method}' are allowed"
            )
        if mesh_backend not in ("auto", "tiled", "fused", "scatter"):
            raise ValueError(
                f"`mesh_backend` is {mesh_backend!r} but must be 'auto', 'tiled', "
                "'fused' or 'scatter'"
            )
        self.mesh_spacing = float(mesh_spacing)
        self.interpolation_nodes = int(interpolation_nodes)
        self.mesh_backend = mesh_backend
        self.tile_capacity = tile_capacity

    def extra_repr(self) -> str:
        return (
            f"mesh_spacing={self.mesh_spacing}, "
            f"interpolation_nodes={self.interpolation_nodes}, "
            f"mesh_backend={self.mesh_backend!r}"
        )

    def get_ns_mesh(self, cell) -> tuple[int, int, int]:
        """Static mesh shape for a concrete cell."""
        return get_ns_mesh(cell, self.mesh_spacing)

    def _kspace_filter(self, cell: torch.Tensor, ns) -> torch.Tensor:
        """The reciprocal-space filter on the rFFT grid, evaluated in float64
        and rounded once to the dtype of ``cell``: a float32 evaluation (the
        k-vectors from a float32 inverse cell, the Gaussian; for P3M the
        product of 3·2n sinc factors) is biased by a few 1e-6 near k = 0,
        and the mesh energy nearly cancels against the self term (on an
        H100 at 102k atoms it halved the float32 step's energy error,
        PERF.md)."""
        return self._kspace_filter_f64(cell.to(torch.float64), ns).to(cell.dtype)

    def _kspace_filter_f64(self, cell: torch.Tensor, ns) -> torch.Tensor:
        return compute_kspace_filter(self.potential.lr_from_k_sq, cell, ns)

    def _mesh_density(
        self,
        charges: torch.Tensor,
        cell: torch.Tensor,
        positions: torch.Tensor,
        kvectors,
        ns_mesh,
        tiled_interp: TiledInterpolation | None,
        check_stale: bool = True,
        plain: bool = False,
        energy_only: bool = False,
    ):
        """Spread the charges onto the mesh (shared by the per-atom
        potential path and the quadratic energy path).

        Returns ``(rho_mesh, interp, mesh_valid, ns_mesh)``; ``mesh_valid``
        is the on-device validity flag of a reused tiled bucketing (``None``
        on the scatter path and for a fresh bucketing).  ``check_stale``
        reads the flag and raises (one device sync); without it the caller
        poisons its result with NaN instead, as an MD loop wants.  Under
        ``torch.func.vmap`` nothing is read on the host (the JAX package's
        traced branch): a fresh bucketing's flag is "no atom dropped", and
        the caller poisons each system whose flag is false.  With
        ``energy_only`` (no gather from the mesh follows) the fused backend
        spreads a reused bucketing through
        :func:`~torchpme_tpu_torch.ops.spread_fused.fused_tiled_density`."""
        if kvectors is not None:
            raise NotImplementedError(
                "Mesh calculators build their own k-grid; precomputed `kvectors` "
                "are only supported by the Ewald calculator"
            )
        if tiled_interp is not None and ns_mesh is None:
            ns_mesh = tiled_interp.ns
        if ns_mesh is None:
            ns_mesh = self.get_ns_mesh(cell)
        ns_mesh = tuple(int(n) for n in ns_mesh)

        if self.mesh_backend == "auto":
            use_tiled = (
                supports_tiling(ns_mesh, self.interpolation_nodes)
                and positions.device.type == "cuda"
            )
        else:
            use_tiled = self.mesh_backend in ("tiled", "fused")

        if not use_tiled:
            interp = compute_interpolation(
                positions, inv3(cell), ns_mesh, self.interpolation_nodes, self._method
            )
            return points_to_mesh(interp, charges), interp, None, ns_mesh

        mesh_valid = None
        # under vmap, or while a graph is traced, nothing is read on the host
        batched = _k.is_batched(charges, cell, positions) or _k.is_tracing()
        if (
            tiled_interp is not None
            and energy_only
            and self.mesh_backend == "fused"
            and supports_fused(tiled_interp, positions.dtype)
        ):
            _k.refuse_batched("mesh_backend='fused' with a reused `tiled_interp` (kernels A, B)",
                              charges, cell, positions)
            # positions → density in kernels A (and B backward): no per-slot
            # weights in device memory
            rho_mesh, mesh_valid = fused_tiled_density(
                tiled_interp, positions, inv3(cell), charges, self._method, plain=plain
            )
            if check_stale and not batched and not bool(mesh_valid):
                raise ValueError(_STALE)
            return rho_mesh, tiled_interp, mesh_valid, ns_mesh
        if tiled_interp is not None:
            # bucket reuse (MD): refresh only the per-slot geometry from the
            # current positions, differentiably
            interp, mesh_valid = refresh_tiled_interpolation(
                tiled_interp, positions, inv3(cell), self._method
            )
            if check_stale and not batched and not bool(mesh_valid):
                raise ValueError(_STALE)
        else:
            interp = compute_tiled_interpolation(
                positions, inv3(cell), ns_mesh, self.interpolation_nodes,
                self._method, capacity=self.tile_capacity,
            )
            if batched:
                # under vmap the count stays on the device: poison, not raise
                mesh_valid = interp.dropped == 0
            elif int(interp.dropped):
                # tile overflow would silently drop atoms: fail loudly
                raise ValueError(
                    f"{int(interp.dropped)} atoms exceeded the tile capacity "
                    "of the tiled mesh backend; pass a larger `tile_capacity` "
                    "(e.g. for slab/vacuum systems) or mesh_backend='scatter'."
                )
        rho_mesh = tiled_points_to_mesh(interp, charges, plain=plain)
        return rho_mesh, interp, mesh_valid, ns_mesh

    def _compute_kspace(
        self,
        charges: torch.Tensor,
        cell: torch.Tensor,
        positions: torch.Tensor,
        periodic: torch.Tensor | None = None,
        kvectors: torch.Tensor | None = None,
        node_mask: torch.Tensor | None = None,
        ns_mesh: tuple[int, int, int] | None = None,
        tiled_interp: TiledInterpolation | None = None,
        plain: bool = False,
    ) -> torch.Tensor:
        rho_mesh, interp, mesh_valid, ns_mesh = self._mesh_density(
            charges, cell, positions, kvectors, ns_mesh, tiled_interp, plain=plain
        )
        kfilter = self._kspace_filter(cell, ns_mesh)
        # backward/forward norm pair: no 1/n factor in either direction
        potential_mesh = apply_kspace_filter(
            rho_mesh, kfilter, fft_norm="backward", ifft_norm="forward"
        )
        volume = torch.abs(det3(cell))
        if isinstance(interp, TiledInterpolation):
            energy = tiled_mesh_to_points(interp, potential_mesh, plain=plain) / volume
            if mesh_valid is not None:
                energy = energy * _poison(mesh_valid, energy)
        else:
            energy = mesh_to_points(interp, potential_mesh) / volume

        # smearing-dependent self-interaction of each particle's screening density
        energy = energy - charges * self.potential.self_contribution()
        # neutralizing background for charged cells (×2 compensates the final /2)
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
        ns_mesh: tuple[int, int, int] | None = None,
        tiled_interp: TiledInterpolation | None = None,
        check_stale: bool = True,
        plain: bool = False,
    ) -> torch.Tensor:
        r"""Total k-space energy :math:`\sum_i q_i V_i^{LR}` as a quadratic
        form, the scalar path of :meth:`Calculator.energy`: the mesh energy
        :math:`\langle\rho, K\circledast\rho\rangle` is evaluated in k-space
        by Parseval, with no inverse transform and no mesh→points gather.
        Matches ``sum(_compute_kspace(...) * charges)``.

        With ``check_stale=False`` a stale ``tiled_interp`` gives NaN (value
        and gradients) instead of an error, without waiting for the device.
        """
        rho_mesh, _, mesh_valid, ns_mesh = self._mesh_density(
            charges, cell, positions, kvectors, ns_mesh, tiled_interp,
            check_stale=check_stale, plain=plain, energy_only=True,
        )
        return self._kspace_energy_from_rho(
            rho_mesh, cell, charges, positions, periodic, ns_mesh, mesh_valid=mesh_valid
        )

    def _kspace_energy_from_rho(
        self,
        rho_mesh: torch.Tensor,
        cell: torch.Tensor,
        charges: torch.Tensor,
        positions: torch.Tensor,
        periodic,
        ns_mesh,
        mesh_valid: torch.Tensor | None = None,
    ) -> torch.Tensor:
        r"""k-space energy :math:`\tfrac12[\sum_k w\hat K|\hat\rho|^2/V -
        q^2\text{ self} - \text{background}]` (+ the slab term when
        ``periodic`` is given) from a density mesh, in the mesh's dtype."""
        kfilter = self._kspace_filter(cell, ns_mesh)
        # the mesh and self terms nearly cancel: assemble them in float64
        f64 = torch.float64
        volume = torch.abs(det3(cell)).to(f64)
        e = kspace_filter_quadratic(rho_mesh, kfilter) / volume
        if mesh_valid is not None:
            e = e * _poison(mesh_valid, e)
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
        ns_mesh: tuple[int, int, int] | None = None,
        tiled_interp: TiledInterpolation | None = None,
        cell_list=None,
        plain: bool = False,
    ) -> torch.Tensor:
        """Same contract as :meth:`Calculator.forward`, plus ``ns_mesh`` (a
        static mesh shape; :meth:`get_ns_mesh` of the cell when omitted) and
        ``tiled_interp`` (a reusable tile bucketing from
        :func:`~torchpme_tpu_torch.ops.mesh_tiled.compute_tiled_interpolation`;
        the weights are refreshed from the current positions inside the
        call, so gradients stay exact).  If atoms have drifted out of their
        tile's stencil window, or the bucketing overflowed its tile
        capacity, the call raises; rebucket like refreshing a neighbor list.

        Under ``torch.func.vmap`` over a padded batch (``node_mask``,
        ``pair_mask``, one shared ``ns_mesh``) the tiled mesh launches each
        of kernels D, E, F once per batch, and a system whose bucketing
        overflowed, or went stale, gives NaN instead of an error.

        :param plain: run the plain versions of the mesh kernels on any
            device (the reference path of the comparisons).
        """
        return super().forward(
            charges, cell, positions, neighbor_indices, neighbor_distances,
            periodic=periodic, node_mask=node_mask, pair_mask=pair_mask,
            kvectors=kvectors, cell_list=cell_list,
            ns_mesh=ns_mesh, tiled_interp=tiled_interp, plain=plain,
        )
