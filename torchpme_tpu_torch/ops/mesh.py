"""Charge spreading onto a mesh by scatter (``index_add_``) and the
gather back to the particles.

Counterpart of :mod:`torchpme_tpu.ops.mesh`: the coefficient tables, the 1D
stencil weights, the generic scatter spread and its transpose, and the
gradient stencil of point dipoles.  In the MD step this path spreads only
the few spill atoms of the cell list; it is the
``mesh_backend="scatter"`` of the calculators and the oracle of the spread
and gather kernels (``ops/spread_fused.py``, ``ops/mesh_kernels.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .kvectors import _cell_and_ns
from .math import inv3

__all__ = [
    "DipoleInterpolationWeights",
    "MeshInterpolationWeights",
    "MeshInterpolator",
    "compute_1d_weight_derivatives",
    "compute_1d_weights",
    "compute_dipole_interpolation",
    "compute_interpolation",
    "dipoles_to_mesh",
    "mesh_to_dipole_field",
    "mesh_to_points",
    "mesh_xyz",
    "points_to_mesh",
]


def _weight_coefficients(method: str, nodes: int) -> np.ndarray:
    """Rows = stencil node, cols = ascending powers of the offset ``x``.

    P3M: Deserno & Holm (JCP 109, 7678 (1998)); Lagrange: Essmann et al.
    (JCP 103, 8577 (1995)).  ``x`` lives in [-1/2, 1/2] relative to the
    stencil center.
    """
    if method == "P3M":
        tables = {
            1: [[1.0]],
            2: np.array([[1, -2], [1, 2]]) / 2,
            3: np.array([[1, -4, 4], [6, 0, -8], [1, 4, 4]]) / 8,
            4: np.array(
                [
                    [1, -6, 12, -8],
                    [23, -30, -12, 24],
                    [23, 30, -12, -24],
                    [1, 6, 12, 8],
                ]
            )
            / 48,
            5: np.array(
                [
                    [1, -8, 24, -32, 16],
                    [76, -176, 96, 64, -64],
                    [230, 0, -240, 0, 96],
                    [76, 176, 96, -64, -64],
                    [1, 8, 24, 32, 16],
                ]
            )
            / 384,
        }
        if nodes not in tables:
            raise ValueError(
                f"`interpolation_nodes` is {nodes} but only values "
                "from 1 to 5 for method 'P3M' are allowed"
            )
    elif method == "Lagrange":
        tables = {
            3: np.array([[0, -1, 1], [2, 0, -2], [0, 1, 1]]) / 2,
            4: np.array(
                [
                    [-3, 2, 12, -8],
                    [27, -54, -12, 24],
                    [27, 54, -12, -24],
                    [-3, -2, 12, 8],
                ]
            )
            / 48,
            5: np.array(
                [
                    [0, 2, -1, -2, 1],
                    [0, -16, 16, 4, -4],
                    [24, 0, -30, 0, 6],
                    [0, 16, 16, -4, -4],
                    [0, -2, -1, 2, 1],
                ]
            )
            / 24,
            6: np.array(
                [
                    [45, -18, -200, 80, 80, -32],
                    [-375, 250, 1560, -1040, -240, 160],
                    [2250, -4500, -1360, 2720, 160, -320],
                    [2250, 4500, -1360, -2720, 160, 320],
                    [-375, -250, 1560, 1040, -240, -160],
                    [45, 18, -200, -80, 80, 32],
                ]
            )
            / 3840,
            7: np.array(
                [
                    [0, -12, 4, 15, -5, -3, 1],
                    [0, 108, -54, -120, 60, 12, -6],
                    [0, -540, 540, 195, -195, -15, 15],
                    [720, 0, -980, 0, 280, 0, -20],
                    [0, 540, 540, -195, -195, 15, 15],
                    [0, -108, -54, 120, 60, -12, -6],
                    [0, 12, 4, -15, -5, 3, 1],
                ]
            )
            / 720,
        }
        if nodes not in tables:
            raise ValueError(
                f"`interpolation_nodes` is {nodes} but only values "
                "from 3 to 7 for method 'Lagrange' are allowed"
            )
    else:
        raise ValueError(
            f"method '{method}' is not supported. Choose from 'Lagrange' or 'P3M'"
        )
    return np.asarray(tables[nodes], dtype=np.float64)


def compute_1d_weights(x: torch.Tensor, nodes: int, method: str) -> torch.Tensor:
    """1D interpolation weights for offsets ``x`` in [-1/2, 1/2], shape
    ``(nodes, *x.shape)`` (a power-basis contraction, as in the JAX package)."""
    coeffs = torch.as_tensor(
        _weight_coefficients(method, nodes), dtype=x.dtype, device=x.device
    )
    powers = torch.stack([x**m for m in range(nodes)])
    return torch.tensordot(coeffs, powers, dims=1)


def compute_1d_weight_derivatives(x: torch.Tensor, nodes: int, method: str) -> torch.Tensor:
    """Derivatives ``dW/dx`` of the 1D interpolation weights at offsets ``x``,
    shape ``(nodes, *x.shape)``: the coefficient tables of
    :func:`compute_1d_weights`, differentiated in the power basis
    (``d/dx Σ c_m x^m = Σ m·c_m x^{m-1}``)."""
    if nodes == 1:
        return x.new_zeros((1, *x.shape))
    coeffs = _weight_coefficients(method, nodes)
    dcoeffs = torch.as_tensor(
        coeffs[:, 1:] * np.arange(1, nodes), dtype=x.dtype, device=x.device
    )
    powers = torch.stack([x**m for m in range(nodes - 1)])
    return torch.tensordot(dcoeffs, powers, dims=1)


def _axis_offsets(r: torch.Tensor, nodes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(stencil base, offset) per the grid-centering parity rule: even-``n``
    stencils center between the two nearest grid points, odd-``n`` on the
    nearest one (round half to even)."""
    if nodes % 2 == 0:
        base = torch.floor(r)
        return base.long(), r - (base + 0.5)
    base = torch.round(r)
    return base.long(), r - base


@dataclass(frozen=True)
class MeshInterpolationWeights:
    """Stencil of a set of points: ``(nodes³, N)`` flat mesh indices and
    combined weights, plus the static mesh shape."""

    linear_indices: torch.Tensor
    combined_weights: torch.Tensor
    ns: tuple[int, int, int]


def _stencil(positions, inverse_cell, ns, nodes: int):
    """Per-axis stencil offsets ``(N, 3)``, the ``(nodes³, N)`` flat mesh
    indices, and the node triples ``(sa, sb, sc)`` that enumerate them."""
    device = positions.device
    ns_t = torch.tensor(ns, dtype=positions.dtype, device=device)
    rel = torch.matmul(positions, inverse_cell) * ns_t
    base, offsets = _axis_offsets(rel, nodes)
    shifts = torch.arange(1 - (nodes + 1) // 2, 1 + nodes // 2, device=device)
    ns_i = torch.tensor(ns, device=device)
    idx = torch.remainder(base[None] + shifts[:, None, None], ns_i)  # (nodes, N, 3)
    grid = torch.arange(nodes, device=device)
    sa, sb, sc = (g.reshape(-1) for g in torch.meshgrid(grid, grid, grid, indexing="ij"))
    linear = (idx[sa, :, 0] * ns[1] + idx[sb, :, 1]) * ns[2] + idx[sc, :, 2]
    return offsets, linear, (sa, sb, sc)


def compute_interpolation(
    positions: torch.Tensor,
    inverse_cell: torch.Tensor,
    ns,
    interpolation_nodes: int,
    method: str,
) -> MeshInterpolationWeights:
    """Stencil indices and weights for interpolating ``positions`` on a mesh
    (grid centering by :func:`_axis_offsets`)."""
    ns = tuple(int(n) for n in ns)
    nodes = int(interpolation_nodes)
    offsets, linear, (sa, sb, sc) = _stencil(positions, inverse_cell, ns, nodes)
    weights_1d = compute_1d_weights(offsets, nodes, method)  # (nodes, N, 3)
    combined = weights_1d[sa, :, 0] * weights_1d[sb, :, 1] * weights_1d[sc, :, 2]
    return MeshInterpolationWeights(linear, combined, ns)


def points_to_mesh(
    interp: MeshInterpolationWeights, particle_weights: torch.Tensor
) -> torch.Tensor:
    """Spread ``(N, C)`` per-particle weights onto a ``(C, nx, ny, nz)`` mesh
    (one ``index_add_`` scatter; autograd gives the gather transpose)."""
    if particle_weights.ndim != 2:
        raise ValueError(
            f"`particle_weights` of dimension {particle_weights.ndim} has to be "
            "of dimension 2"
        )
    nx, ny, nz = interp.ns
    n_channels = particle_weights.shape[1]
    values = (
        particle_weights.T[:, None, :] * interp.combined_weights[None, :, :]
    ).reshape(n_channels, -1)
    mesh = torch.zeros(
        (n_channels, nx * ny * nz),
        dtype=particle_weights.dtype,
        device=particle_weights.device,
    )
    mesh = mesh.index_add(1, interp.linear_indices.reshape(-1), values)
    return mesh.reshape(n_channels, nx, ny, nz)


def mesh_to_points(
    interp: MeshInterpolationWeights, mesh_vals: torch.Tensor
) -> torch.Tensor:
    """Interpolate a ``(C, nx, ny, nz)`` mesh field back to the particle
    positions (transpose of :func:`points_to_mesh` with the same weights).

    :return: ``(N, C)`` interpolated values.
    """
    if mesh_vals.ndim != 4:
        raise ValueError(
            f"`mesh_vals` of dimension {mesh_vals.ndim} has to be of dimension 4"
        )
    flat_mesh = mesh_vals.reshape(mesh_vals.shape[0], -1)
    gathered = flat_mesh[:, interp.linear_indices]  # (C, nodes³, N)
    return torch.sum(gathered * interp.combined_weights[None], dim=1).T


# -- point dipoles: the gradient stencil ----------------------------------------


@dataclass(frozen=True)
class DipoleInterpolationWeights:
    r"""Gradient stencil for spreading point dipoles onto a mesh.

    ``grad_weights[s, j, b]`` is :math:`\partial W^{3D}_s(r_j)/\partial
    r_{j,b}`, the Cartesian gradient of the combined 3D stencil weight, so the
    dipolar mesh density is :math:`Q(m) = \sum_j \vec\mu_j\cdot\nabla_{r_j}
    W_j(m)` and the per-atom vector field gathers with the same stencil.
    """

    linear_indices: torch.Tensor  # (nodes³, N)
    grad_weights: torch.Tensor  # (nodes³, N, 3)
    ns: tuple[int, int, int]


def compute_dipole_interpolation(
    positions: torch.Tensor,
    inverse_cell: torch.Tensor,
    ns,
    interpolation_nodes: int,
    method: str,
) -> DipoleInterpolationWeights:
    r"""Gradient-stencil indices and weights for dipolar mesh spreading.

    The chain rule through the fractional coordinates gives
    :math:`\partial W/\partial r_b = \sum_a \dot W_a W_{a'} W_{a''}\,
    (\text{inverse cell})_{ba}\, n_a`, from the coefficient tables of the
    charge stencil and their analytic derivatives.
    """
    ns = tuple(int(n) for n in ns)
    nodes = int(interpolation_nodes)
    offsets, linear, (sa, sb, sc) = _stencil(positions, inverse_cell, ns, nodes)
    w = compute_1d_weights(offsets, nodes, method)  # (nodes, N, 3)
    dw = compute_1d_weight_derivatives(offsets, nodes, method)
    wx, wy, wz = w[sa, :, 0], w[sb, :, 1], w[sc, :, 2]
    # ∂W3D/∂rel_a, then the chain through rel = (pos @ inv_cell) ⊙ ns
    grad_rel = torch.stack(
        [dw[sa, :, 0] * wy * wz, wx * dw[sb, :, 1] * wz, wx * wy * dw[sc, :, 2]], dim=-1
    )  # (nodes³, N, 3) in fractional-mesh units
    ns_t = torch.tensor(ns, dtype=positions.dtype, device=positions.device)
    grad_pos = torch.einsum("sna,ba,a->snb", grad_rel, inverse_cell, ns_t)
    return DipoleInterpolationWeights(linear, grad_pos, ns)


def dipoles_to_mesh(interp: DipoleInterpolationWeights, dipoles: torch.Tensor) -> torch.Tensor:
    r"""Spread ``(N, 3)`` point dipoles onto the mesh as a gradient density
    :math:`Q(m) = \sum_j \vec\mu_j\cdot\nabla_{r_j} W_j(m)`, ``(1, nx, ny,
    nz)``.  Its Fourier transform is :math:`-i\,\hat w(k)\,S(k)` with
    :math:`S(k) = \sum_j (\vec\mu_j\cdot\vec k)\,e^{-ik\cdot r_j}`, so the
    scalar Parseval machinery applies unchanged."""
    nx, ny, nz = interp.ns
    values = torch.einsum("snb,nb->sn", interp.grad_weights, dipoles).reshape(-1)
    mesh = values.new_zeros(nx * ny * nz)
    mesh = mesh.index_add(0, interp.linear_indices.reshape(-1), values)
    return mesh.reshape(1, nx, ny, nz)


def mesh_to_dipole_field(
    interp: DipoleInterpolationWeights, mesh_vals: torch.Tensor
) -> torch.Tensor:
    """Gather a filtered ``(1, nx, ny, nz)`` mesh back to per-atom vector
    fields ``(N, 3)``: ``g_i = Σ_s ∇W_{s,i} · mesh[idx]`` (transpose of
    :func:`dipoles_to_mesh` in the dipole argument, so ``Σ_i μ_i·g_i ==
    Σ_m Q·mesh`` exactly)."""
    gathered = mesh_vals.reshape(-1)[interp.linear_indices]  # (nodes³, N)
    return torch.einsum("sn,snb->nb", gathered, interp.grad_weights)


def mesh_xyz(cell: torch.Tensor, ns) -> torch.Tensor:
    """Cartesian coordinates of the mesh points, ``(nx, ny, nz, 3)``."""
    fracs = [torch.arange(int(n), dtype=cell.dtype, device=cell.device) / int(n) for n in ns]
    grid = torch.stack(torch.meshgrid(*fracs, indexing="ij"), dim=-1)
    return torch.matmul(grid, cell)


class MeshInterpolator:
    """A mesh interpolation kept for repeated use (power users, e.g. LODE
    features): :meth:`update` the cell or mesh, :meth:`compute_weights` for
    positions, then :meth:`points_to_mesh` / :meth:`mesh_to_points`.  It
    takes the scatter route (:func:`compute_interpolation`,
    :func:`points_to_mesh`, :func:`mesh_to_points`), as the JAX class does.
    Its cell lives on ``device`` (default: that of a tensor ``cell``, else
    :func:`~torchpme_tpu_torch.default_device`), a host cell given to
    :meth:`update` too.

    Example
    -------
    Spreading conserves the total charge at every interpolation order:

    >>> import torch
    >>> mi = MeshInterpolator(torch.eye(3, dtype=torch.float64) * 4.0, (8, 8, 8),
    ...                       interpolation_nodes=4, method="Lagrange")
    >>> _ = mi.compute_weights(torch.tensor([[0.3, 1.7, 2.2], [3.1, 0.4, 1.1]],
    ...                                     dtype=torch.float64))
    >>> rho = mi.points_to_mesh(torch.tensor([[1.0], [-2.0]], dtype=torch.float64))
    >>> print(f"{float(torch.sum(rho)):.6f}")
    -1.000000
    """

    def __init__(self, cell, ns_mesh, interpolation_nodes: int, method: str, device=None):
        _weight_coefficients(method, interpolation_nodes)  # validate eagerly
        self.method = method
        self.interpolation_nodes = int(interpolation_nodes)
        self._interp: MeshInterpolationWeights | None = None
        self.device = resolve_device(device, cell)
        self.update(cell, ns_mesh)

    def update(self, cell=None, ns_mesh=None) -> None:
        """Refresh the cell and/or mesh shape this interpolator targets."""
        cell, ns_mesh = _cell_and_ns(cell, ns_mesh, self.device)
        if cell is not None:
            self.cell = cell
            self.inverse_cell = inv3(cell)
        if ns_mesh is not None:
            self.ns_mesh = ns_mesh

    def get_mesh_xyz(self) -> torch.Tensor:
        """Cartesian positions of the mesh points, ``(nx, ny, nz, 3)``."""
        return mesh_xyz(self.cell, self.ns_mesh)

    def compute_weights(self, positions: torch.Tensor) -> MeshInterpolationWeights:
        if positions.ndim != 2 or positions.shape[1] != 3:
            raise ValueError(f"shape {list(positions.shape)} of `positions` has to be (N, 3)")
        self._interp = compute_interpolation(
            positions, self.inverse_cell, self.ns_mesh, self.interpolation_nodes, self.method
        )
        return self._interp

    def points_to_mesh(self, particle_weights: torch.Tensor) -> torch.Tensor:
        if self._interp is None:
            raise ValueError("Call `compute_weights` before `points_to_mesh`.")
        return points_to_mesh(self._interp, particle_weights)

    def mesh_to_points(self, mesh_vals: torch.Tensor) -> torch.Tensor:
        if self._interp is None:
            raise ValueError("Call `compute_weights` before `mesh_to_points`.")
        return mesh_to_points(self._interp, mesh_vals)
