"""Tile-bucketed mesh spreading and gathering.

Counterpart of :mod:`torchpme_tpu.ops.mesh_tiled`.  Atoms are bucketed into
8×8 mesh-column tiles in the xy-plane (one stable sort of N tile ids); per
slot the bucketing keeps the stencil start inside the tile, the z start and
the 1D stencil weights.  The bucketing is reusable like a neighbor list:
:func:`refresh_tiled_interpolation` recomputes the per-slot geometry from
moved positions, differentiably, and reports when an atom has left its
tile's stencil window.

:func:`tiled_points_to_mesh` and :func:`tiled_mesh_to_points` spread and
gather through the hand-written CUDA kernels of
:mod:`~torchpme_tpu_torch.ops.mesh_kernels` for float32 CUDA tensors, and
through their plain PyTorch versions (dense per-tile weight factors, one
batched matmul per tile, the parity-class fold) for CPU tensors or with
``plain=True``.  Both give what the scatter engine of
:mod:`~torchpme_tpu_torch.ops.mesh` gives, in another summation order.

Each tile has a static atom capacity; atoms beyond it are counted in
``TiledInterpolation.dropped`` and the calculators raise when it is nonzero
(under ``torch.func.vmap`` they poison that system's result with NaN
instead, as the JAX package does under tracing).

Everything here runs under ``torch.func.vmap`` over a padded batch of
systems that share ``ns``: the bucketing reads no value on the host there,
and :class:`TiledInterpolation` is a pytree node, so a batched bucketing can
be built once (``vmap(compute_tiled_interpolation)``) and passed back in.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch
from torch.utils import _pytree

from .. import kernels as _k
from .mesh import _axis_offsets, compute_1d_weight_derivatives, compute_1d_weights

__all__ = [
    "TILE",
    "TiledInterpolation",
    "compute_tiled_interpolation",
    "refresh_tiled_interpolation",
    "supports_tiling",
    "tiled_dipoles_to_mesh",
    "tiled_mesh_to_dipole_field",
    "tiled_mesh_to_points",
    "tiled_points_to_mesh",
]

TILE = 8  # xy tile edge in mesh cells


def supports_tiling(ns, interpolation_nodes: int) -> bool:
    """Tiling needs even tile grids and stencils that fit a 2-tile window."""
    nx, ny, _ = (int(n) for n in ns)
    return (
        interpolation_nodes <= TILE + 1
        and nx % (2 * TILE) == 0
        and ny % (2 * TILE) == 0
        and nx >= 2 * TILE
        and ny >= 2 * TILE
    )


@dataclass(frozen=True)
class TiledInterpolation:
    """Bucketed stencil data for one set of positions on one mesh.

    Shapes: ``T`` tiles, ``K`` capacity, ``n`` stencil nodes.
    """

    local_x: torch.Tensor  # (T, K) int32, stencil start within the tile, [0, TILE)
    local_y: torch.Tensor  # (T, K) int32
    start_z: torch.Tensor  # (T, K) int32, z start, [0, nz)
    weights: torch.Tensor  # (T, K, 3, n) per-axis 1D stencil weights (0 in empty slots)
    slot_of_atom: torch.Tensor  # (N,) int32 flat bucket slot per atom (K*T for dropped)
    dropped: torch.Tensor  # () int32, number of atoms beyond tile capacity
    atom_of_slot: torch.Tensor | None = None  # (T, K) int32, N for empty slots
    ns: tuple[int, int, int] = (1, 1, 1)
    nodes: int = 4
    #: (T, K, 3, n) derivatives dW/dx of the 1D weights (the dipolar gradient
    #: stencil); None unless built with ``derivatives=True``
    dweights: torch.Tensor | None = None


# A pytree node, as the JAX package's ``register_dataclass``: the tensors are
# the leaves and ``ns``, ``nodes`` and which optional fields are absent the
# context, so ``torch.func.vmap`` maps a bucketing in and out of a function.
_TENSORS = tuple(f.name for f in fields(TiledInterpolation) if f.name not in ("ns", "nodes"))


def _flatten_interp(interp: TiledInterpolation):
    present = tuple(n for n in _TENSORS if getattr(interp, n) is not None)
    return [getattr(interp, n) for n in present], (present, interp.ns, interp.nodes)


def _unflatten_interp(leaves, context) -> TiledInterpolation:
    present, ns, nodes = context
    return TiledInterpolation(**dict(zip(present, leaves)), ns=ns, nodes=nodes)


_pytree.register_pytree_node(
    TiledInterpolation, _flatten_interp, _unflatten_interp,
    serialized_type_name="torchpme_tpu_torch.ops.mesh_tiled.TiledInterpolation",
)


def _start_indices(rel: torch.Tensor, ns, nodes: int):
    """(wrapped stencil start ``(..., 3)`` int64, offsets) of scaled
    fractional coordinates."""
    base, offsets = _axis_offsets(rel, nodes)
    shift0 = 1 - (nodes + 1) // 2
    ns_i = torch.tensor(ns, device=rel.device)
    return torch.remainder(base + shift0, ns_i), offsets


def _max_tile_occupancy(positions, inverse_cell, ns, nodes) -> int:
    """Exact max atoms per xy tile of a configuration (host-side; under
    ``torch.func.grad`` the values are read through its wrappers)."""
    nx, ny, nz = (int(n) for n in ns)
    ty_count = ny // TILE
    pos = _k.host_values(positions)
    rel = (pos @ _k.host_values(inverse_cell)) * np.asarray(ns, dtype=pos.dtype)
    if nodes % 2 == 0:
        base = np.floor(rel).astype(np.int64)
    else:
        base = np.round(rel).astype(np.int64)
    shift0 = 1 - (nodes + 1) // 2
    start = (base + shift0) % np.asarray((nx, ny, nz), dtype=np.int64)
    tile_id = (start[:, 0] // TILE) * ty_count + start[:, 1] // TILE
    counts = np.bincount(tile_id, minlength=(nx // TILE) * ty_count)
    return int(counts.max()) if counts.size else 0


def compute_tiled_interpolation(
    positions: torch.Tensor,
    inverse_cell: torch.Tensor,
    ns,
    interpolation_nodes: int,
    method: str,
    capacity: int | None = None,
    derivatives: bool = False,
) -> TiledInterpolation:
    """Bucket atoms into xy tiles and precompute stencil weights.

    Same numerical contract as
    :func:`torchpme_tpu_torch.ops.mesh.compute_interpolation` (grid
    centering parity rule, wrapped indices).  The result lives on the device
    of ``positions``.

    :param capacity: slots per tile; by default the true maximum tile
        occupancy plus 8 (room for small drift across refreshes), rounded up
        to a multiple of 64.  Under ``torch.func.vmap`` the occupancy cannot
        be read, and the default is the JAX package's static capacity under
        tracing, ``min(N, 2·⌈N/T⌉ + 32)`` rounded up to a multiple of 64:
        an inhomogeneous batch passes ``capacity``, and a system that
        overflows it counts its atoms in ``dropped``.
    :param derivatives: also keep the weight derivatives (``dweights``), which
        the dipolar spread and gather need; a refresh keeps whichever the
        bucketing carries.

    Example
    -------
    The tiled spread agrees with the scatter reference and conserves charge:

    >>> import torch
    >>> positions = torch.tensor([[0.3, 1.7, 2.2], [3.1, 0.4, 1.1]])
    >>> charges = torch.tensor([[1.0], [-2.0]])
    >>> interp = compute_tiled_interpolation(
    ...     positions, torch.eye(3) / 4.0, (16, 16, 16), 4, "Lagrange"
    ... )
    >>> rho = tiled_points_to_mesh(interp, charges)
    >>> print(f"{float(rho.sum()):.6f}")
    -1.000000
    """
    ns = tuple(int(n) for n in ns)
    nodes = int(interpolation_nodes)
    nx, ny, nz = ns
    n_atoms = positions.shape[0]
    ty_count = ny // TILE
    n_tiles = (nx // TILE) * ty_count
    device = positions.device
    if capacity is None:
        if _k.is_batched(positions, inverse_cell):
            # under vmap each system's occupancy lives on the device and the
            # capacity must be one static number for the batch: 2x the mean
            # occupancy plus slack (torchpme_tpu/ops/mesh_tiled.py:163-168)
            mean = -(-n_atoms // n_tiles)
            capacity = int(-(-min(n_atoms, 2 * mean + 32) // 64) * 64)
        else:
            max_count = _max_tile_occupancy(positions, inverse_cell, ns, nodes)
            capacity = int(-(-min(n_atoms, max_count + 8) // 64) * 64)
    capacity = int(capacity)

    ns_t = torch.tensor(ns, dtype=positions.dtype, device=device)
    rel = torch.matmul(positions, inverse_cell) * ns_t
    start, offsets = _start_indices(rel, ns, nodes)  # (N, 3)
    weights = compute_1d_weights(offsets, nodes, method).permute(1, 2, 0)  # (N, 3, n)
    dweights = (
        compute_1d_weight_derivatives(offsets, nodes, method).permute(1, 2, 0)
        if derivatives
        else None
    )

    tile_x = start[:, 0] // TILE
    tile_y = start[:, 1] // TILE
    tile_id = tile_x * ty_count + tile_y

    # bucket by tile: one stable sort of N keys, then rank within the tile
    order = torch.argsort(tile_id, stable=True)
    tid_sorted = tile_id[order]
    # each sorted atom's tile starts at the first of its tile id
    rank = torch.arange(n_atoms, device=device) - torch.searchsorted(tid_sorted, tid_sorted)
    valid = rank < capacity
    dropped = torch.sum(~valid).to(torch.int32)
    # flat slot per sorted atom; dropped atoms land in a trash slot
    slot_sorted = torch.where(valid, tid_sorted * capacity + rank, n_tiles * capacity)
    # out of place, so that it batches under vmap
    slot_of_atom = torch.zeros(n_atoms, dtype=torch.int64, device=device).scatter(
        0, order, slot_sorted
    )

    def bucketize(values, fill=0):
        flat = torch.full(
            (n_tiles * capacity + 1, *values.shape[1:]), fill,
            dtype=values.dtype, device=device,
        )
        # autograd-visible copy: the weights carry the position gradient
        flat = flat.index_copy(0, slot_of_atom, values)
        return flat[:-1].reshape(n_tiles, capacity, *values.shape[1:])

    i32 = torch.int32
    return TiledInterpolation(
        local_x=bucketize((start[:, 0] - tile_x * TILE).to(i32)),
        local_y=bucketize((start[:, 1] - tile_y * TILE).to(i32)),
        start_z=bucketize(start[:, 2].to(i32)),
        weights=bucketize(weights),  # zero weights in empty slots: no contribution
        slot_of_atom=slot_of_atom.to(i32),
        dropped=dropped,
        atom_of_slot=bucketize(torch.arange(n_atoms, dtype=i32, device=device), fill=n_atoms),
        ns=ns,
        nodes=nodes,
        dweights=None if dweights is None else bucketize(dweights),
    )


def refresh_tiled_interpolation(
    interp: TiledInterpolation,
    positions: torch.Tensor,
    inverse_cell: torch.Tensor,
    method: str,
) -> tuple[TiledInterpolation, torch.Tensor]:
    """Recompute stencil weights for updated positions, reusing the buckets.

    The tile assignment is treated like a neighbor list: valid while no
    atom's stencil start has left its tile.  Only the per-slot geometry is
    updated (one gather of the bucketed positions plus dense math,
    differentiable with respect to ``positions`` and ``inverse_cell``).

    :return: ``(new_interp, still_valid)``; ``still_valid`` is a 0-dim bool
        tensor, False once any occupied slot's stencil start lies outside
        its tile or the bucketing had dropped atoms (then rebucket with
        :func:`compute_tiled_interpolation`).
    """
    if interp.atom_of_slot is None:
        raise ValueError(
            "This TiledInterpolation does not carry bucket->atom indices; "
            "build it with compute_tiled_interpolation first."
        )
    ns, nodes = interp.ns, interp.nodes
    nx, ny, _ = ns
    n_tiles, _ = interp.local_x.shape
    ty_count = ny // TILE
    n_atoms = positions.shape[0]
    device = positions.device

    # gather bucketed positions (a sentinel row keeps empty slots harmless)
    padded_pos = torch.cat([positions, positions.new_zeros((1, 3))], dim=0)
    pos_slots = padded_pos.index_select(0, interp.atom_of_slot.reshape(-1).long())
    pos_slots = pos_slots.reshape(*interp.atom_of_slot.shape, 3)  # (T, K, 3)
    ns_t = torch.tensor(ns, dtype=positions.dtype, device=device)
    rel = torch.matmul(pos_slots, inverse_cell) * ns_t
    start, offsets = _start_indices(rel, ns, nodes)  # (T, K, 3)
    weights = compute_1d_weights(offsets, nodes, method).movedim(0, -1)  # (T, K, 3, n)
    dweights = None
    if interp.dweights is not None:
        dweights = compute_1d_weight_derivatives(offsets, nodes, method).movedim(0, -1)

    # tile origins from the static tile index
    tile_idx = torch.arange(n_tiles, device=device)
    origin_x = (tile_idx // ty_count * TILE)[:, None]
    origin_y = (tile_idx % ty_count * TILE)[:, None]
    local_x = torch.remainder(start[..., 0] - origin_x, nx)
    local_y = torch.remainder(start[..., 1] - origin_y, ny)

    empty = interp.atom_of_slot == n_atoms
    weights = torch.where(empty[..., None, None], 0.0, weights)
    if dweights is not None:
        dweights = torch.where(empty[..., None, None], 0.0, dweights)
    local_x = torch.where(empty, 0, local_x)
    local_y = torch.where(empty, 0, local_y)
    start_z = torch.where(empty, 0, start[..., 2])

    # every occupied slot's stencil start must still lie inside its tile (the
    # local window has room for TILE-1 + nodes-1 < 2*TILE cells)
    still_valid = torch.all(empty | ((local_x < TILE) & (local_y < TILE))) & (
        interp.dropped == 0
    )
    i32 = torch.int32
    refreshed = replace(
        interp,
        local_x=local_x.to(i32),
        local_y=local_y.to(i32),
        start_z=start_z.to(i32),
        weights=weights,
        dweights=dweights,
    )
    return refreshed, still_valid


# -- dense per-tile factors, fold and extraction: the plain versions' pieces --


def _dense_axis_weights(local_start, axis_weights, extent: int, wrap: int | None = None):
    """Densify 1D stencil weights onto a local grid with selects.

    :param local_start: ``(T, K)`` start index of the stencil on the local grid.
    :param axis_weights: ``(T, K, n)`` stencil weights.
    :param extent: length of the local grid; targets beyond it are dropped.
    :param wrap: optional modulus applied to the target index (z-axis wrap).
    :return: ``(T, K, extent)`` dense weights.
    """
    iota = torch.arange(extent, device=local_start.device)
    dense = axis_weights.new_zeros((*local_start.shape, extent))
    for o in range(axis_weights.shape[-1]):
        target = local_start + o
        if wrap is not None:
            target = torch.remainder(target, wrap)
        dense = dense + torch.where(
            iota == target[..., None], axis_weights[..., o : o + 1], 0.0
        )
    return dense


def _dense_factors(local_x, local_y, start_z, weights, ns, nodes: int):
    """Dense ``wx (T, K, E)``, ``wy (T, K, E)`` and ``wz (T, K, nz)``."""
    extent, nz = TILE + nodes - 1, ns[2]
    wx = _dense_axis_weights(local_x, weights[:, :, 0], extent)
    wy = _dense_axis_weights(local_y, weights[:, :, 1], extent)
    wz = _dense_axis_weights(start_z, weights[:, :, 2], nz, wrap=nz)
    return wx, wy, wz


def _fold_tiles_to_mesh(tile_fields: torch.Tensor, ns, extent: int) -> torch.Tensor:
    """Assemble per-tile local fields ``(..., T, E, E, nz, C)`` into
    ``(..., C, nx, ny, nz)`` (leading axes: a batch of systems); local cell
    ``e`` of tile ``(tx, ty)`` lands on mesh cell ``tx·TILE + e`` (mod
    ``nx``).

    Tiles of equal (x, y) parity are disjoint, so each parity class folds
    with a pad + transpose + reshape; the four classes and the x/y wraps
    combine with shifted adds.
    """
    nx, ny, nz = ns
    tx_count, ty_count = nx // TILE, ny // TILE
    lead = tile_fields.shape[:-5]
    n_ch = tile_fields.shape[-1]
    window = 2 * TILE
    pad = window - extent
    tiles = torch.nn.functional.pad(
        tile_fields.reshape(*lead, tx_count, ty_count, extent, extent, nz, n_ch),
        (0, 0, 0, 0, 0, pad, 0, pad),
    )
    padded = tile_fields.new_zeros((*lead, nx + window, ny + window, nz, n_ch))
    axis = len(lead)
    for px in range(2):
        for py in range(2):
            cls = tiles[..., px::2, py::2, :, :, :, :]  # (..., tx/2, ty/2, W, W, nz, C), disjoint
            ntx, nty = cls.shape[axis], cls.shape[axis + 1]
            block = cls.transpose(axis + 1, axis + 2).reshape(
                *lead, ntx * window, nty * window, nz, n_ch
            )
            x0, y0 = px * TILE, py * TILE
            padded[..., x0 : x0 + ntx * window, y0 : y0 + nty * window, :, :] += block
    mesh = padded[..., :nx, :ny, :, :].clone()
    mesh[..., :window, :, :, :] += padded[..., nx:, :ny, :, :]
    mesh[..., :, :window, :, :] += padded[..., :nx, ny:, :, :]
    mesh[..., :window, :window, :, :] += padded[..., nx:, ny:, :, :]
    return mesh.movedim(-1, -4)


def _extract_tiles_from_mesh(mesh: torch.Tensor, ns, nodes: int) -> torch.Tensor:
    """Cut the ``(..., T, E, E, nz, C)`` local windows out of ``(..., C, nx,
    ny, nz)`` (transpose of :func:`_fold_tiles_to_mesh`): window cell ``e``
    of tile ``(tx, ty)`` is mesh cell ``tx·TILE + e`` (mod ``nx``)."""
    nx, ny, _ = ns
    extent = TILE + nodes - 1
    dev = mesh.device
    e = torch.arange(extent, device=dev)
    xi = torch.remainder(torch.arange(nx // TILE, device=dev)[:, None] * TILE + e, nx)
    yi = torch.remainder(torch.arange(ny // TILE, device=dev)[:, None] * TILE + e, ny)
    field = mesh.movedim(-4, -1)  # (..., nx, ny, nz, C)
    tiles = field[..., xi[:, None, :, None], yi[None, :, None, :], :, :]  # (..., tx, ty, E, E, nz, C)
    return tiles.reshape(*mesh.shape[:-4], -1, extent, extent, *field.shape[-2:])


# -- spread and gather ----------------------------------------------------------


def _slot_values(interp: TiledInterpolation, values: torch.Tensor) -> torch.Tensor:
    """Atom-order ``(N, C)`` values → per-slot ``(T, C, K)`` (0 in empty
    slots; dropped atoms fall into a trash slot that is sliced away)."""
    n_tiles, capacity = interp.local_x.shape
    flat = values.new_zeros((n_tiles * capacity + 1, values.shape[1]))
    flat = flat.index_copy(0, interp.slot_of_atom.long(), values)
    return flat[:-1].reshape(n_tiles, capacity, -1).transpose(1, 2).contiguous()


def tiled_points_to_mesh(
    interp: TiledInterpolation, particle_weights: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Spread ``(N, C)`` particle weights onto the ``(C, nx, ny, nz)`` mesh.

    Numerically what :func:`torchpme_tpu_torch.ops.mesh.points_to_mesh`
    gives (same stencils, different summation order).  Differentiable with
    respect to the particle weights and the stencil weights (and through
    them the positions).

    :param plain: run the plain PyTorch version on any device; by default
        CPU tensors take it and CUDA tensors launch kernel D (float32 only).
    """
    from .mesh_kernels import spread_tiles

    return spread_tiles(interp, _slot_values(interp, particle_weights), plain=plain)


def tiled_mesh_to_points(
    interp: TiledInterpolation, mesh_vals: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Back-interpolate a ``(C, nx, ny, nz)`` mesh field at the particle
    positions, ``(N, C)`` (transpose of :func:`tiled_points_to_mesh`).

    :param plain: as in :func:`tiled_points_to_mesh` (kernel E).
    """
    from .mesh_kernels import gather_tiles

    n_ch = mesh_vals.shape[0]
    per_slot = gather_tiles(interp, mesh_vals, plain=plain)  # (T, C, K)
    per_slot = per_slot.transpose(1, 2).reshape(-1, n_ch)
    per_slot = torch.cat([per_slot, per_slot.new_zeros((1, n_ch))], dim=0)
    return per_slot.index_select(0, interp.slot_of_atom.long())


# -- point dipoles: the three derivative stencils ---------------------------------


def _require_derivatives(interp: TiledInterpolation) -> None:
    if interp.dweights is None:
        raise ValueError(
            "This TiledInterpolation carries no weight derivatives; build it "
            "with compute_tiled_interpolation(..., derivatives=True)."
        )


def _dipole_triple(local_x, local_y, start_z, weights, dweights):
    """``(lx, ly, sz, weights)`` of every slot three times along the capacity
    axis, copy ``a`` with the weight triple whose axis-``a`` stencil is the
    derivative, ``(dw_x, w_y, w_z)``, ``(w_x, dw_y, w_z)``, ``(w_x, w_y,
    dw_z)`` (differentiable tensor ops; any leading batch axes): the
    charge-form argument through which the plain versions of the dipole forms
    of kernels D, E and F do the JAX package's concatenated three-stencil
    arithmetic."""
    variants = []
    for a in range(3):
        picked = [dweights[..., c, :] if c == a else weights[..., c, :] for c in range(3)]
        variants.append(torch.stack(picked, dim=-2))  # (..., T, K, 3, n)

    def triple(t):
        return torch.cat([t, t, t], dim=-1).contiguous()

    return (triple(local_x), triple(local_y), triple(start_z), torch.cat(variants, dim=-3))


def tiled_dipoles_to_mesh(
    interp: TiledInterpolation, nu: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    r"""Spread point dipoles onto the mesh as a gradient density, the tiled
    counterpart of :func:`torchpme_tpu_torch.ops.mesh.dipoles_to_mesh`.

    The dipolar density separates per fractional axis:
    :math:`Q(m) = \sum_j \vec\mu_j\cdot\nabla_{r_j} W_j(m)
    = \sum_a \nu_{ja}\,\partial_a[W_x W_y W_z]` with the effective per-axis
    charges :math:`\nu_{ja} = n_a\,(\mu_j\,C^{-1})_a` (chain rule through
    ``rel = pos @ inverse_cell * ns``): three monopole-like spreads whose
    axis-``a`` stencil is the weight derivative.  The JAX package runs them
    as one batched product with the variants concatenated along the
    capacity axis, which the plain version does too; kernel D's dipole form
    builds the three-term stencil per slot in one pass, and its VJP, the
    dipole forms of kernels E and F, reads each slot once too.

    :param nu: ``(N, 3)`` effective per-axis charges
        ``(dipoles @ inverse_cell) * ns``.
    :param plain: run the plain PyTorch version on any device.
    :return: dipolar density mesh ``(1, nx, ny, nz)``.
    """
    from .mesh_kernels import spread_dipoles

    _require_derivatives(interp)
    return spread_dipoles(interp, _slot_values(interp, nu), plain=plain)


def tiled_mesh_to_dipole_field(
    interp: TiledInterpolation, mesh_vals: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    r"""Back-interpolate a filtered ``(1, nx, ny, nz)`` mesh to per-atom
    gradient fields in fractional-mesh units (transpose of
    :func:`tiled_dipoles_to_mesh`): ``e_rel[j, a] = Σ_m ∂_a[W_j](m)·mesh(m)``,
    so ``Σ_j ν_j·e_rel_j == Σ_m Q·mesh`` exactly.  Chain to position units
    with ``(e_rel * ns) @ inverse_cell.T`` at the caller.  One launch of
    kernel E's dipole form; its backward spreads with kernel D's dipole form
    and runs kernel F's.
    """
    from .mesh_kernels import gather_dipole_fields

    _require_derivatives(interp)
    per_slot = gather_dipole_fields(interp, mesh_vals, plain=plain)  # (T, 3, K)
    per_slot = per_slot.transpose(1, 2).reshape(-1, 3)
    per_slot = torch.cat([per_slot, per_slot.new_zeros((1, 3))], dim=0)
    return per_slot.index_select(0, interp.slot_of_atom.long())
