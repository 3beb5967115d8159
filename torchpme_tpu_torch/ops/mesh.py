"""Charge spreading onto a mesh by scatter (``index_add_``) and the
gather back to the particles.

Counterpart of :mod:`torchpme_tpu.ops.mesh`: the coefficient tables, the 1D
stencil weights, the generic scatter spread and its transpose.  In the MD
step this path spreads only the few spill atoms of the cell list; it is the
``mesh_backend="scatter"`` of the calculators and the oracle of the spread
and gather kernels (``ops/spread_fused.py``, ``ops/mesh_kernels.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "MeshInterpolationWeights",
    "compute_1d_weights",
    "compute_interpolation",
    "mesh_to_points",
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
    ns_t = torch.tensor(ns, dtype=positions.dtype, device=positions.device)
    rel = torch.matmul(positions, inverse_cell) * ns_t
    base, offsets = _axis_offsets(rel, nodes)
    weights_1d = compute_1d_weights(offsets, nodes, method)  # (nodes, N, 3)

    shifts = torch.arange(
        1 - (nodes + 1) // 2, 1 + nodes // 2, device=positions.device
    )
    ns_i = torch.tensor(ns, device=positions.device)
    idx = torch.remainder(base[None] + shifts[:, None, None], ns_i)  # (nodes, N, 3)

    grid = torch.arange(nodes, device=positions.device)
    sa, sb, sc = (g.reshape(-1) for g in torch.meshgrid(grid, grid, grid, indexing="ij"))
    linear = (idx[sa, :, 0] * ns[1] + idx[sb, :, 1]) * ns[2] + idx[sc, :, 2]
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
