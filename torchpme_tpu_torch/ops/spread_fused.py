r"""Charge spreading from positions: scaled coordinates → density mesh, and
its VJP.

Counterpart of :mod:`torchpme_tpu.ops.pallas.spread_fused`, for its two
callers:

* :func:`aligned_tiled_density`, the aligned MD state: the cell-list x/y
  grid is pinned to the 8×8 mesh-tile grid, so the ``nz_c·cap`` bucket rows
  of the z-column of cells at ``(tx, ty)`` are exactly the slots of mesh
  tile ``(tx, ty)`` (a reshape, no gather); atoms are position-bucketed, so
  the window begins ``lpad`` cells before the tile (:func:`aligned_geometry`);
* :func:`fused_tiled_density`, the fused mesh mode: the slots of a
  :class:`~torchpme_tpu_torch.ops.mesh_tiled.TiledInterpolation` (stencil
  starts bucketed into their tile, ``lpad = 0``, extent ``TILE + nodes − 1``)
  filled from positions with one gather, in place of the refresh and
  kernel D.

Two kernels carry both (``csrc/spread.cu``):

* **A** (:func:`fused_spread`): scaled fractional coordinates
  ``rel = (pos @ cell⁻¹)·ns`` and charges in, the ``(C, nx, ny, nz)``
  density out.  Each block owns the mesh cells of one tile and z chunk (the
  rule is in ``csrc/tpme_ops.cpp``), reads the slots of the tiles whose
  windows reach it, in the z cells that can reach the chunk, evaluates each
  slot's stencil weights once and stores its cells: no global atomics, no
  fold (the TPU's tile output + parity-class fold exists because TPU
  scatters serialize).
* **B** (:func:`fused_spread_bwd`): ``(rel, q, ∂E/∂ρ)`` in,
  ``(∂E/∂rel, ∂E/∂q)`` out.  Each block stages one tile's window of the
  mesh cotangent for a z chunk and contracts it, one thread a slot, against
  the derivative stencils (``d w / d rel``); ``d base / d rel = 0``, as
  autodiff through ``round``/``floor`` gives.  The cell cotangent flows
  through ``rel``, which is plain PyTorch.

Beside each kernel sits its plain PyTorch twin (:func:`spread_plain`,
:func:`spread_plain_bwd`), the batched form of the JAX package's
``_fwd_math``/``_bwd_math``: the dense per-tile weight factors, one batched
matmul per tile, and the fold.  A wrapper takes the twin only for a tensor
that lies on the CPU; for a CUDA tensor it launches the kernel or raises.

The two kernels are the ops ``torch.ops.tpme.spread_fwd`` (A, whose
registered VJP is B) and ``torch.ops.tpme.spread_bwd`` (B), registered in
C++ (``csrc/tpme_ops.cpp``: their CUDA kernels build the parameters, the
weight tables and the z chunks, and launch); the twins are their CPU kernels
here.  The geometry goes in as integers and the weight method's name
(:meth:`SpreadGeometry.as_args`), so :mod:`torch.export` traces through
them.  They have no vmap rule: under ``vmap`` they raise.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from .. import kernels as _k
from .mesh import (
    _axis_offsets,
    _weight_coefficients,
    compute_interpolation,
    points_to_mesh,
)
from .mesh_tiled import (
    TILE,
    TiledInterpolation,
    _fold_tiles_to_mesh,
    refresh_tiled_interpolation,
    tiled_points_to_mesh,
)

__all__ = [
    "SpreadGeometry",
    "aligned_geometry",
    "aligned_tiled_density",
    "fused_spread",
    "fused_spread_bwd",
    "fused_tiled_density",
    "spread_plain",
    "spread_plain_bwd",
    "supports_fused",
]


def aligned_geometry(nodes: int, pad_cells: int = 0) -> tuple[int, int]:
    """(extent, lpad) of the position-bucketed local window: atoms anywhere
    in the tile, so the stencil reaches ``lpad`` cells left of the tile
    origin and ``TILE - 1 + nodes//2`` (+1 for the odd-round overshoot)
    right; ``pad_cells`` widens both sides for overflow-balanced lists."""
    lpad = (nodes - 1) // 2 + pad_cells
    extent = TILE + nodes - (1 if nodes % 2 == 0 else 0) + 2 * pad_cells
    return extent, lpad


def _tables(method: str, nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Weight polynomials ``(nodes, nodes)`` and their derivatives
    ``(nodes, max(nodes - 1, 1))``, rows = stencil node, cols = powers."""
    coeffs = np.asarray(_weight_coefficients(method, nodes), np.float64)
    deriv = coeffs[:, 1:] * np.arange(1, nodes)[None, :]
    if deriv.shape[1] == 0:  # nodes == 1: constant weight
        deriv = np.zeros((coeffs.shape[0], 1))
    return coeffs, deriv


@dataclass(frozen=True)
class SpreadGeometry:
    """Static shape of one spread: mesh, stencil, window, tiles, slots."""

    ns: tuple[int, int, int]
    nodes: int
    method: str
    extent: int
    lpad: int
    n_tiles: int
    slots_per_tile: int  # nz_c · cap
    #: cell-list z cells of a tile column (``nz_c``): the slots of z cell
    #: ``c`` are ``c·cap … (c+1)·cap − 1``.  Kernel A reads, for each z chunk
    #: of the mesh, only the z cells whose atoms can reach it.  1 for the
    #: stencil-start bucketing, whose slots are in no z order.
    z_cells: int

    @property
    def ty_count(self) -> int:
        return self.ns[1] // TILE

    def as_args(self) -> tuple[list[int], str]:
        """The ``(geometry, method)`` arguments of the ``tpme::spread_*``
        ops: ``[nx, ny, nz, nodes, extent, lpad, n_tiles, slots_per_tile,
        z_cells]`` and the weight method."""
        return [*self.ns, self.nodes, self.extent, self.lpad, self.n_tiles,
                self.slots_per_tile, self.z_cells], self.method

    @classmethod
    def from_args(cls, geometry: Sequence[int], method: str) -> "SpreadGeometry":
        nx, ny, nz, nodes, extent, lpad, n_tiles, slots, z_cells = (int(g) for g in geometry)
        return cls((nx, ny, nz), nodes, method, extent, lpad, n_tiles, slots, z_cells)


# -- plain twin ---------------------------------------------------------------


def _poly(coeffs_row, off: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of one stencil node's weight polynomial."""
    acc = torch.full_like(off, float(coeffs_row[-1]))
    for c in coeffs_row[-2::-1]:
        acc = acc * off + float(c)
    return acc


def _node_weights(off: torch.Tensor, coeffs: np.ndarray) -> torch.Tensor:
    """``(..., nodes)`` per-node weights of the offsets ``off``."""
    return torch.stack([_poly(row, off) for row in coeffs], dim=-1)


def _dense(local: torch.Tensor, w: torch.Tensor, size: int, wrap: int | None):
    """``(T, size, K)`` dense weights: node ``o`` of slot ``k`` lands on
    local index ``local + o`` (mod ``wrap`` when given; dropped beyond
    ``size`` otherwise, as the JAX iota-select does)."""
    iota = torch.arange(size, device=local.device)[None, :, None]
    dense = torch.zeros(
        (local.shape[0], size, local.shape[1]), dtype=w.dtype, device=w.device
    )
    for o in range(w.shape[-1]):
        target = local + o if wrap is None else torch.remainder(local + o, wrap)
        dense = dense + torch.where(iota == target[:, None, :], w[:, None, :, o], 0.0)
    return dense


def _geometry(rel: torch.Tensor, geom: SpreadGeometry, with_deriv: bool):
    """Dense x/y ``(T, E, K)`` and z ``(T, nz, K)`` weight factors of the
    ``(T, K, 3)`` slots (and their rel-derivatives)."""
    nx, ny, nz = geom.ns
    nodes = geom.nodes
    shift0 = 1 - (nodes + 1) // 2
    tile = torch.arange(rel.shape[0], device=rel.device)[:, None]
    ox = tile // geom.ty_count * TILE
    oy = tile % geom.ty_count * TILE
    bx, offx = _axis_offsets(rel[..., 0], nodes)
    by, offy = _axis_offsets(rel[..., 1], nodes)
    bz, offz = _axis_offsets(rel[..., 2], nodes)
    # floor-mod (the sign of the divisor), as the JAX package's _fmod
    lx = torch.remainder(torch.remainder(bx + shift0, nx) + geom.lpad - ox, nx)
    ly = torch.remainder(torch.remainder(by + shift0, ny) + geom.lpad - oy, ny)
    sz = torch.remainder(bz + shift0, nz)
    coeffs, deriv = _tables(geom.method, nodes)
    e = geom.extent
    out = []
    for table in (coeffs, deriv) if with_deriv else (coeffs,):
        out.append(
            (
                _dense(lx, _node_weights(offx, table), e, None),
                _dense(ly, _node_weights(offy, table), e, None),
                _dense(sz, _node_weights(offz, table), nz, nz),
            )
        )
    return out


def _charge_z(wz: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``(T, K, C·nz)`` channel-major charge-weighted z factors."""
    wz_k = wz.transpose(1, 2)  # (T, K, nz)
    return torch.cat([wz_k * q[:, :, c : c + 1] for c in range(q.shape[-1])], dim=2)


def _tile_window_index(geom: SpreadGeometry, device):
    """Mesh x / y index of every local window cell, ``(T, E)`` each."""
    nx, ny, _ = geom.ns
    tile = torch.arange(geom.n_tiles, device=device)[:, None]
    e = torch.arange(geom.extent, device=device)[None, :]
    xi = torch.remainder(tile // geom.ty_count * TILE - geom.lpad + e, nx)
    yi = torch.remainder(tile % geom.ty_count * TILE - geom.lpad + e, ny)
    return xi, yi


def spread_plain(rel: torch.Tensor, q: torch.Tensor, geom: SpreadGeometry):
    """Plain twin of kernel A: ``(nb, 3)`` rel and ``(nb, C)`` charges in
    slot order → ``(C, nx, ny, nz)`` density."""
    n_ch = q.shape[-1]
    t, k, e = geom.n_tiles, geom.slots_per_tile, geom.extent
    nz = geom.ns[2]
    ((wx, wy, wz),) = _geometry(rel.reshape(t, k, 3), geom, with_deriv=False)
    wxy = (wx[:, :, None, :] * wy[:, None, :, :]).reshape(t, e * e, k)
    tiles = torch.bmm(wxy, _charge_z(wz, q.reshape(t, k, n_ch)))  # (T, E², C·nz)
    tiles = tiles.reshape(t, e, e, n_ch, nz).permute(0, 1, 2, 4, 3)
    rho = _fold_tiles_to_mesh(tiles, geom.ns, e)
    if geom.lpad:
        rho = torch.roll(rho, (-geom.lpad, -geom.lpad), dims=(1, 2))
    return rho


def spread_plain_bwd(rel, q, ct_rho, geom: SpreadGeometry):
    """Plain twin of kernel B: ``(rel, q, ∂E/∂ρ)`` → ``(∂E/∂rel (nb, 3),
    ∂E/∂q (nb, C))``."""
    n_ch = q.shape[-1]
    t, k, e = geom.n_tiles, geom.slots_per_tile, geom.extent
    nz = geom.ns[2]
    (wx, wy, wz), (dwx, dwy, dwz) = _geometry(
        rel.reshape(t, k, 3), geom, with_deriv=True
    )
    q_t = q.reshape(t, k, n_ch)
    # the tile-field cotangent is the mesh cotangent on each local window
    xi, yi = _tile_window_index(geom, rel.device)
    ct = ct_rho.permute(1, 2, 0, 3)  # (nx, ny, C, nz)
    field = ct[xi[:, :, None], yi[:, None, :]].reshape(t, e * e, n_ch * nz)

    wxy = (wx[:, :, None, :] * wy[:, None, :, :]).reshape(t, e * e, k)
    h = torch.bmm(wxy.transpose(1, 2), field)  # (T, K, C·nz)
    wz_k = wz.transpose(1, 2)  # (T, K, nz)
    ct_q = torch.stack(
        [(h[..., c * nz : (c + 1) * nz] * wz_k).sum(-1) for c in range(n_ch)], dim=-1
    )
    fz = torch.bmm(field, _charge_z(wz, q_t).transpose(1, 2)).reshape(t, e, e, k)
    a_x = (fz * wy[:, None, :, :]).sum(2)  # (T, E, K)
    b_y = (fz * wx[:, :, None, :]).sum(1)  # (T, E, K)
    hq = sum(q_t[:, :, c : c + 1] * h[..., c * nz : (c + 1) * nz] for c in range(n_ch))
    ct_x = (dwx * a_x).sum(1)
    ct_y = (dwy * b_y).sum(1)
    ct_z = (dwz.transpose(1, 2) * hq).sum(-1)
    ct_rel = torch.stack([ct_x, ct_y, ct_z], dim=-1)
    return ct_rel.reshape(-1, 3), ct_q.reshape(-1, n_ch)


# -- kernels A and B: the ops ------------------------------------------------


def _check_slots(rel, q, geom: SpreadGeometry) -> int:
    nb = geom.n_tiles * geom.slots_per_tile
    _k.check_cuda_tensor(rel, "rel", (nb, 3))
    if q.ndim != 2:
        raise ValueError(f"q must be (slots, channels), got {tuple(q.shape)}")
    _k.check_cuda_tensor(q, "q", (nb, q.shape[1]))
    if q.device != rel.device:
        raise ValueError("rel and q must be on the same device")
    return q.shape[1]


def _check_fwd(rel, q, geom: SpreadGeometry) -> int:
    n_ch = _check_slots(rel, q, geom)
    nx, ny, _ = geom.ns
    # the blocks own every mesh cell once: the tiles must cover the mesh
    if nx % TILE or ny % TILE or geom.n_tiles != (nx // TILE) * geom.ty_count:
        raise ValueError(f"{geom.n_tiles} tiles do not cover the {geom.ns} mesh")
    if geom.slots_per_tile % geom.z_cells:
        raise ValueError(
            f"{geom.slots_per_tile} slots per tile do not split into {geom.z_cells} z cells"
        )
    return n_ch


def _check_bwd(rel, q, ct_rho, geom: SpreadGeometry) -> int:
    n_ch = _check_slots(rel, q, geom)
    _k.check_cuda_tensor(ct_rho, "ct_rho", (n_ch, *geom.ns))
    return n_ch


@_k.plain_version("spread_fwd")
def _spread_fwd_plain(rel: Tensor, q: Tensor, geometry: Sequence[int], method: str) -> Tensor:
    """Kernel A's plain version with the op's signature: :func:`spread_plain`."""
    return spread_plain(rel, q, SpreadGeometry.from_args(geometry, method))


@_k.plain_version("spread_bwd")
def _spread_bwd_plain(rel: Tensor, q: Tensor, ct_rho: Tensor, geometry: Sequence[int],
                      method: str) -> tuple[Tensor, Tensor]:
    """Kernel B's plain version with the op's signature: :func:`spread_plain_bwd`."""
    return spread_plain_bwd(rel, q, ct_rho, SpreadGeometry.from_args(geometry, method))


@_k.register_fake("spread_fwd")
def _(rel, q, geometry, method):
    return rel.new_empty((q.shape[-1], *geometry[:3]))


@_k.register_fake("spread_bwd")
def _(rel, q, ct_rho, geometry, method):
    return torch.empty_like(rel), torch.empty_like(q)


#: kernel A: ``(nb, 3)`` rel, ``(nb, C)`` charges → ``(C, nx, ny, nz)``
spread_fwd = _k.tpme_op("spread_fwd")
#: kernel B: ``(rel, q, ∂E/∂ρ)`` → ``(∂E/∂rel, ∂E/∂q)``
spread_bwd = _k.tpme_op("spread_bwd")


def _spread_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:2])
    ctx.static = tuple(inputs[2:])  # geometry, method


def _spread_vjp(ctx, ct_rho):
    """Kernel A's VJP is kernel B."""
    rel, q = ctx.saved_tensors
    ct_rel, ct_q = _k.call("spread_bwd", rel, q, ct_rho.contiguous(), *ctx.static,
                           plain=ctx.plain)
    return ct_rel, ct_q, *(None,) * len(ctx.static)


_k.register_autograd("spread_fwd", _spread_vjp, _spread_setup)
_k.refuse_vmap("spread_fwd", "tpme::spread_fwd (kernel A)")
_k.refuse_vmap("spread_bwd", "tpme::spread_bwd (kernel B)")

#: ``(rel, q) → ρ`` with kernel A and its VJP (kernel B), or with ``plain``
#: the twin pair on any device: ``_Spread.apply(rel, q, geometry, method,
#: plain)``
_Spread = _k.op_function("_Spread", "spread_fwd", _spread_setup, _spread_vjp)


def fused_spread(rel: torch.Tensor, q: torch.Tensor, geom: SpreadGeometry):
    """Kernel A: ``(nb, 3)`` rel, ``(nb, C)`` charges → ``(C, nx, ny, nz)``,
    through ``torch.ops.tpme.spread_fwd``.

    CPU tensors take :func:`spread_plain`; CUDA tensors launch the kernel
    (float32 only) or raise.
    """
    if rel.device.type != "cpu":
        _check_fwd(rel, q, geom)
    return spread_fwd(rel, q, *geom.as_args())


def fused_spread_bwd(rel, q, ct_rho: torch.Tensor, geom: SpreadGeometry):
    """Kernel B: ``(rel, q, ∂E/∂ρ)`` → ``(∂E/∂rel, ∂E/∂q)``, through
    ``torch.ops.tpme.spread_bwd``.

    CPU tensors take :func:`spread_plain_bwd`; CUDA tensors launch the
    kernel (float32 only) or raise.
    """
    if rel.device.type != "cpu":
        _check_bwd(rel, q, ct_rho, geom)
    return spread_bwd(rel, q, ct_rho, *geom.as_args())


def aligned_tiled_density(
    pos_rows: torch.Tensor,
    q_rows: torch.Tensor,
    inverse_cell: torch.Tensor,
    ns,
    nodes: int,
    method: str,
    cell_grid: tuple[int, int, int, int],
    pad_cells: int = 0,
    plain: bool = False,
    extras_interp: TiledInterpolation | None = None,
) -> torch.Tensor:
    """Charge density mesh straight from tile-aligned bucket rows.

    :param pos_rows: ``(n_rows, 3)`` bucket-row positions
        (:meth:`torchpme_tpu_torch.md.MDFastPath.bucket` layout:
        ``n_cells·cap`` cell rows, then the spill side list).
    :param q_rows: ``(n_rows, C)`` charges in the same layout (0 in padding).
    :param cell_grid: ``(nx_c, ny_c, nz_c, cap)`` of the aligned cell list.
    :param pad_cells: window widening for overflow-balanced cell lists.
    :param plain: run the plain twins on any device (the reference path of
        the comparisons); by default CPU tensors take the twins and CUDA
        tensors the kernels.
    :param extras_interp: an extras-only tile bucketing of the spill rows
        (``pos_rows[nb:]``, :meth:`torchpme_tpu_torch.md.MDFastPath.create`);
        when given they spread by a refresh and
        :func:`~torchpme_tpu_torch.ops.mesh_tiled.tiled_points_to_mesh`
        (kernel D; E + F backward), and a stale table NaN-poisons the density.
    :return: ``(C, nx, ny, nz)`` density; without ``extras_interp`` the spill
        rows spread through the generic scatter
        (:func:`~torchpme_tpu_torch.ops.mesh.points_to_mesh`).
    """
    _k.refuse_batched("aligned_tiled_density (kernels A, B)", pos_rows, q_rows, inverse_cell)
    ns = tuple(int(n) for n in ns)
    nx_c, ny_c, nz_c, cap = cell_grid
    if nx_c != ns[0] // TILE or ny_c != ns[1] // TILE:
        raise ValueError(
            f"cell grid {(nx_c, ny_c)} is not aligned with the "
            f"{(ns[0] // TILE, ns[1] // TILE)} mesh-tile grid"
        )
    extent, lpad = aligned_geometry(nodes, pad_cells)
    if extent > 2 * TILE:
        raise ValueError(
            f"aligned window extent {extent} (nodes={nodes}, "
            f"pad_cells={pad_cells}) exceeds the 2-tile fold window {2 * TILE}"
        )
    geom = SpreadGeometry(
        ns, int(nodes), method, extent, lpad, nx_c * ny_c, nz_c * cap, nz_c
    )
    nb = geom.n_tiles * geom.slots_per_tile
    ns_t = torch.tensor(ns, dtype=pos_rows.dtype, device=pos_rows.device)
    # (pos @ cell⁻¹) · ns in this order keeps the floor/round stencil starts
    # in lockstep with the JAX package
    rel = torch.matmul(pos_rows, inverse_cell) * ns_t
    rho = _Spread.apply(rel[:nb], q_rows[:nb].contiguous(), *geom.as_args(), plain)
    if pos_rows.shape[0] > nb:
        if extras_interp is not None:
            refreshed, valid = refresh_tiled_interpolation(
                extras_interp, pos_rows[nb:], inverse_cell, method
            )
            rho_e = tiled_points_to_mesh(refreshed, q_rows[nb:], plain=plain)
            return rho + rho_e * torch.where(valid, 1.0, float("nan")).to(rho_e.dtype)
        # spill side list: a handful of atoms, generic scatter spread
        interp_e = compute_interpolation(pos_rows[nb:], inverse_cell, ns, nodes, method)
        rho = rho + points_to_mesh(interp_e, q_rows[nb:])
    return rho


# -- the fused mesh mode: the stencil-start bucketing ----------------------------


def supports_fused(interp: TiledInterpolation, dtype) -> bool:
    """float32 data, a tile capacity that is a multiple of 8, and the
    bucket→atom indices: what :func:`fused_tiled_density` takes (the JAX
    package's rule, kept for parity)."""
    return (
        dtype == torch.float32
        and interp.local_x.shape[1] % 8 == 0
        and interp.atom_of_slot is not None
    )


def _slot_validity(rel: torch.Tensor, interp: TiledInterpolation, sentinel: int):
    """Staleness flag recomputed from ``(T·K, 3)`` rel, outside autograd:
    every occupied slot's stencil start must still lie inside its tile (the
    criterion of
    :func:`~torchpme_tpu_torch.ops.mesh_tiled.refresh_tiled_interpolation`),
    and the bucketing dropped no atom.

    :param sentinel: the index empty slots hold in ``atom_of_slot``.
    """
    nx, ny, _ = interp.ns
    n_tiles, capacity = interp.local_x.shape
    ty_count = ny // TILE
    with torch.no_grad():
        base, _ = _axis_offsets(rel[:, :2].reshape(n_tiles, capacity, 2), interp.nodes)
        n_xy = torch.tensor((nx, ny), device=rel.device)
        start = torch.remainder(base + 1 - (interp.nodes + 1) // 2, n_xy)
        tile = torch.arange(n_tiles, device=rel.device)
        origin = torch.stack((tile // ty_count * TILE, tile % ty_count * TILE), dim=1)
        local = torch.remainder(start - origin[:, None, :], n_xy)
        empty = interp.atom_of_slot == sentinel
        ok = torch.all(local < TILE, dim=-1) | empty
        return torch.all(ok) & (interp.dropped == 0)


def fused_tiled_density(
    interp: TiledInterpolation,
    positions: torch.Tensor,
    inverse_cell: torch.Tensor,
    charges: torch.Tensor,
    method: str,
    plain: bool = False,
):
    """Charge density mesh straight from positions, through kernels A and B.

    Takes the place of
    :func:`~torchpme_tpu_torch.ops.mesh_tiled.refresh_tiled_interpolation` +
    :func:`~torchpme_tpu_torch.ops.mesh_tiled.tiled_points_to_mesh` where no
    gather from the mesh follows (the quadratic energy path): one gather of
    the slots' positions, ``rel = (pos @ cell⁻¹)·ns``, and kernel A; the
    backward is kernel B and the transposes of the gather and of ``rel``.
    No per-slot weights reach device memory.

    :param interp: a reusable bucketing with ``atom_of_slot``
        (:func:`~torchpme_tpu_torch.ops.mesh_tiled.compute_tiled_interpolation`);
        ``positions`` is in whatever order its ``atom_of_slot`` indexes
        (atoms, or the bucket rows of an MD state).
    :param charges: ``(N, C)`` charges in atom order (``slot_of_atom``).
    :param plain: run the kernels' plain twins on any device; by default CPU
        tensors take the twins and CUDA tensors the kernels (float32 only).
    :return: ``(rho (C, nx, ny, nz), mesh_valid)``: the density and a 0-dim
        bool tensor, False once an occupied slot's stencil start has left its
        tile or the bucketing dropped atoms (rebucket then).
    """
    _k.refuse_batched("fused_tiled_density (kernels A, B)", positions, inverse_cell, charges)
    rel, q_slots, geom = _fused_slots(interp, positions, inverse_cell, charges, method)
    rho = _Spread.apply(rel, q_slots, *geom.as_args(), plain)
    return rho, _slot_validity(rel, interp, positions.shape[0])


def _fused_slots(interp: TiledInterpolation, positions, inverse_cell, charges, method: str):
    """``(rel (T·K, 3), q (T·K, C), geometry)`` of a stencil-start bucketing:
    the slots' positions gathered through ``atom_of_slot`` (a zero row for
    empty slots), their charges through ``slot_of_atom``."""
    if interp.atom_of_slot is None:
        raise ValueError(
            "This TiledInterpolation does not carry bucket->atom indices; "
            "build it with compute_tiled_interpolation first."
        )
    ns, nodes = interp.ns, interp.nodes
    n_tiles, capacity = interp.local_x.shape
    n_ch = charges.shape[-1]
    padded_pos = torch.cat([positions, positions.new_zeros((1, 3))], dim=0)
    pos_slots = padded_pos.index_select(0, interp.atom_of_slot.reshape(-1).long())
    pos_slots = pos_slots.reshape(n_tiles, capacity, 3)
    # (pos @ cell⁻¹) · ns in this order, as the refresh computes it: the
    # floor/round stencil starts decide as there
    ns_t = torch.tensor(ns, dtype=positions.dtype, device=positions.device)
    rel = (torch.matmul(pos_slots, inverse_cell) * ns_t).reshape(-1, 3)
    q_slots = charges.new_zeros((n_tiles * capacity + 1, n_ch))
    q_slots = q_slots.index_copy(0, interp.slot_of_atom.long(), charges)[:-1]
    geom = SpreadGeometry(ns, nodes, method, TILE + nodes - 1, 0, n_tiles, capacity, 1)
    return rel, q_slots.contiguous(), geom
