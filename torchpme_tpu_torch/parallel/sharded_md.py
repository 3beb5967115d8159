"""Slab-sharded MD step: the cell-list window plus the tiled mesh, SPMD.

Counterpart of :mod:`torchpme_tpu.parallel.sharded_md`, on
``torch.distributed`` (:mod:`._collectives`):

* **real space** — the cell grid's x planes are sharded; each rank runs
  the window of kernel C on its slab extended by ONE halo plane of cells
  fetched from its right neighbour (a ring hop).  The half-window offsets
  only look at x+1, and the i-side charges are zero on the halo plane
  (kernel C's split variant, ``qi_g``), so each unordered pair counts once,
  on the rank of its lower-x cell.  The energy is one scalar sum.
* **k space** — each rank spreads its own atoms onto its ``nx/D`` mesh
  planes plus one-tile skirts on both sides: kernel D on a tile table
  (atom-order and rows entries), or, on a tile-aligned state, kernel A
  straight from the rank's rows (its VJP is kernel B).  The skirts ride two
  ring hops, and the energy is the distributed Parseval form: z and y
  transforms on the slab, ONE all-to-all x↔y swap, the x transform and
  ``Σ w K̂ |ρ̂|²`` on the rank's y block.  No collective carries the mesh.

Cell gradient of the window.  Kernel C sums it as the image term of each
pair's periodic wrap on the grid it is given (``ops/rspace_cells.py``).  On
a slab that grid is the rank's planes plus the halo, and its own x wrap only
joins the halo, whose i-side charges are zero; the wrap that matters is
global, between the last rank's last plane and its halo (global plane 0).
That image is added as a zero ``(cell − cell.detach())·e_x`` on the last
rank's halo coordinates, so autograd adds ``e_x ⊗ Σ_halo ∂E/∂pc``, the
missing ``−m ⊗ g`` of those pairs.

Every rank calls with the same replicated arguments (charges, cell, state;
atom-order positions in :func:`sharded_md_energy`) and gets the total
energy; :func:`sharded_md_energy_rows` takes only the rank's own block of
bucket rows, and its gradient comes back in that block.  A stale state
poisons the energy and every gradient with NaN on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels as _k
from ..device import resolve_device
from ..ops.kspace import _hermitian_fold_weights
from ..ops.math import det3, inv3
from ..ops.mesh import _axis_offsets, compute_1d_weight_derivatives, compute_1d_weights
from ..ops.mesh_kernels import spread_dipoles, spread_tiles
from ..ops.mesh_tiled import TILE, TiledInterpolation
from ..ops.rspace_cells import STALE_TOL, _window_energy, _window_offsets, compute_cell_list
from ..ops.spread_fused import SpreadGeometry, _Spread, aligned_geometry
from ._collectives import Axis, axis_of, psum, reduce_flag, replicate, ring_hop
from .sharded import _block, _fft_forward_sharded, _halo_fold, _replicated_calc

__all__ = [
    "ShardedMDState",
    "compute_sharded_md_state",
    "sharded_md_energy",
    "sharded_md_energy_rows",
]


@dataclass(frozen=True)
class ShardedMDState:
    """Host-computed bucketing for the slab-sharded MD step.

    Both slab decompositions (cells for real space, mesh tiles for k space),
    with a leading rank axis on every array.  Refresh it like a neighbor
    list: it stays valid while every atom remains in its cell AND its mesh
    stencil in its tile window; drift beyond either poisons the energy (and
    its gradients) with NaN.
    """

    # cell-list x-slabs: (D, bx·ny·nz cells, cap)
    cl_atom_index: torch.Tensor
    cl_slot_mask: torch.Tensor
    cl_atom_wrap: torch.Tensor  # (D, cells, cap, 3) int8
    # mesh-tile x-slabs: (D, tiles, K) global atom ids (n_atoms for empty)
    tm_atom_of_slot: torch.Tensor
    n_axis: tuple[int, int, int]
    cutoff: float
    ns_mesh: tuple[int, int, int]
    nodes: int
    method: str
    n_devices: int
    n_atoms: int
    #: rows mode (``rows=True``): global slab-row id of every atom (row
    #: ``d·cells·cap + c·cap + s``), and the tile tables as
    #: *extended-local* row ids: the rank's own ``cells·cap`` rows followed
    #: by the right neighbour's first-plane rows (the halo the window ships)
    row_of_atom: torch.Tensor | None = None
    tm_slot_rows: torch.Tensor | None = None
    #: tile-aligned rows mode (``aligned=True``): the cell x/y grid is the
    #: mesh-tile grid, so a rank's rows are its tile slots (no tile tables)
    aligned: bool = False

    @property
    def n_rows(self) -> int:
        """Total slab rows (cells · capacity, over all ranks)."""
        d, cells, cap = self.cl_slot_mask.shape
        return d * cells * cap

    @property
    def rows_per_rank(self) -> int:
        return self.n_rows // self.n_devices

    def _need_rows(self) -> None:
        if self.row_of_atom is None:
            raise ValueError(
                "this state was built without rows tables; pass rows=True "
                "to compute_sharded_md_state"
            )

    def bucket(self, positions: torch.Tensor) -> torch.Tensor:
        """Atom-order ``(N, 3)`` → all slab rows ``(n_rows, 3)`` (rank ``r``
        takes :meth:`rank_rows` of them)."""
        self._need_rows()
        positions = torch.as_tensor(positions, device=self.row_of_atom.device)
        rows = positions.new_zeros((self.n_rows, 3))
        return rows.index_copy(0, self.row_of_atom.long(), positions)

    def unbucket(self, rows: torch.Tensor) -> torch.Tensor:
        """All slab rows back to atom order (one gather)."""
        self._need_rows()
        return rows[self.row_of_atom.long()]

    def rank_rows(self, rows: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s block of the ``(n_rows, ...)`` slab rows."""
        n = self.rows_per_rank
        return rows[rank * n : (rank + 1) * n]


def _host_tile_tables(
    positions, cell, ns_mesh, nodes: int, D: int, tile_capacity: int | None
) -> np.ndarray:
    """Per-rank mesh-tile slot tables on the extended local slab (host).

    Atoms are assigned by the x plane of their (wrapped) stencil start, so
    stencils only ever extend rightward into the right halo tile; the left
    halo tile exists for layout symmetry with the ring fold.  Returns
    ``atom_of_slot`` ``(D, n_tiles, capacity)``, ``n_atoms`` in empty slots."""
    nx, ny, _nz = ns_mesh
    mx = nx // D
    pos = np.asarray(positions, dtype=np.float64)
    inv = np.linalg.inv(np.asarray(cell, dtype=np.float64))
    rel = pos @ inv
    rel -= np.floor(rel)
    rel *= np.asarray(ns_mesh)
    if nodes % 2 == 0:
        base = np.floor(rel).astype(np.int64)
    else:
        base = np.round(rel).astype(np.int64)
    shift0 = 1 - (nodes + 1) // 2
    start = (base + shift0) % np.asarray(ns_mesh)
    dev = start[:, 0] // mx
    local_x = start[:, 0] - dev * mx + TILE  # ∈ [TILE, TILE + mx)
    ty_count = ny // TILE
    tx_local = mx // TILE + 2
    n_tiles = tx_local * ty_count
    tile_flat = dev * n_tiles + (local_x // TILE) * ty_count + start[:, 1] // TILE

    counts = np.bincount(tile_flat, minlength=D * n_tiles)
    n_atoms = pos.shape[0]
    if tile_capacity is None:
        # the sizing rule of compute_tiled_interpolation's eager capacity
        capacity = int(-(-min(n_atoms, int(counts.max()) + 8) // 64) * 64)
    else:
        capacity = int(tile_capacity)
        if counts.max() > capacity:
            raise ValueError(
                f"tile_capacity {capacity} below the fullest tile "
                f"({counts.max()} atoms)"
            )
    order = np.argsort(tile_flat, kind="stable")
    starts_ = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank_in = np.arange(n_atoms) - starts_[tile_flat[order]]
    atom_of_slot = np.full((D * n_tiles, capacity), n_atoms, dtype=np.int32)
    atom_of_slot[tile_flat[order], rank_in] = order
    return atom_of_slot.reshape(D, n_tiles, capacity)


def _host_row_of_atom(atom_index: np.ndarray, slot_mask: np.ndarray, n_atoms: int) -> np.ndarray:
    """Global slab-row id of every atom (no spill: exactly one slot)."""
    flat_rows = np.arange(atom_index.size, dtype=np.int64).reshape(atom_index.shape)
    row_of_atom = np.full(n_atoms, -1, dtype=np.int64)
    row_of_atom[atom_index[slot_mask]] = flat_rows[slot_mask]
    assert (row_of_atom >= 0).all()
    return row_of_atom


def _host_tile_rows(
    atom_of_slot: np.ndarray,
    row_of_atom: np.ndarray,
    n_atoms: int,
    per_dev: int,
    cellcap: int,
    nyc: int,
    nzc: int,
) -> np.ndarray:
    """Tile tables as extended-local row ids: a slot of tile slab ``d``
    names an atom of cell slab ``d`` (local rows) or of the first cell plane
    of slab ``d + 1`` (the window's halo rows; at one rank, its own rows)."""
    D = atom_of_slot.shape[0]
    local_rows = per_dev * cellcap
    plane_rows = nyc * nzc * cellcap
    ext_rows = local_rows + plane_rows
    slot_rows = np.full_like(atom_of_slot, ext_rows, dtype=np.int64)
    for d in range(D):
        real = atom_of_slot[d] < n_atoms
        r = row_of_atom[np.minimum(atom_of_slot[d], n_atoms - 1)]
        d_c = r // local_rows
        loc = r % local_rows
        own = real & (d_c == d)
        # one rank is its own next slab: its rows are all its own (the JAX
        # package's table raises there)
        halo = real & ~own & (d_c == (d + 1) % D)
        bad = real & ~own & ~halo
        if bad.any() or (halo & (loc >= plane_rows)).any():
            raise ValueError(
                "rows mode needs each device's mesh stencils confined to "
                "its own cell slab plus the next slab's first plane; this "
                "cell/mesh/nodes geometry violates that (stencil span "
                "exceeds the cell edge — use rows=False or a finer cell "
                "grid)"
            )
        slot_rows[d][own] = loc[own]
        slot_rows[d][halo] = local_rows + loc[halo]
    return slot_rows


def compute_sharded_md_state(
    calc,
    positions,
    cell,
    cutoff: float,
    ns_mesh=None,
    n_devices: int = 8,
    cell_capacity: int | None = None,
    tile_capacity: int | None = None,
    rows: bool = False,
    aligned: bool = False,
    device=None,
) -> ShardedMDState:
    """Bucket atoms into per-rank cell and mesh-tile slabs (host, numpy; the
    JAX package's arrays, bit for bit).

    :param calc: a mesh calculator (PME/P3M): ``interpolation_nodes`` and
        the weight method.
    :param cutoff: real-space cutoff (as for ``compute_cell_list``).
    :param ns_mesh: mesh shape (``calc.get_ns_mesh(cell)`` when omitted).
        ``nx % n_devices == 0`` with ``nx/n_devices`` a multiple of 16, and
        ``ny`` a multiple of 16 and of ``n_devices``.
    :param n_devices: the number of ranks.
    :param rows: also build the slab-row tables of
        :func:`sharded_md_energy_rows` (each rank holds its own block of
        bucket rows; no position gather and no force reduction across ranks).
        Needs every mesh stencil starting in a rank's slab to belong to an
        atom of that slab or of the next slab's first cell plane (checked).
    :param aligned: pin the cell x/y grid to the mesh-tile grid
        (``xy_cells = (nx/8, ny/8)``; needs every tile edge ≥ ``cutoff`` and
        ``nx/8`` divisible by ``n_devices``): a rank's rows are then its
        tile slots, spread by kernel A with no gather and no tile table.
        Implies ``rows=True``; the step takes float32 rows only.
    :param device: device of the state (default: that of ``positions`` when
        it is a tensor, else :func:`torchpme_tpu_torch.default_device`).
    """
    from ..md import MDFastPath

    device = resolve_device(device, positions, cell)
    pos_np = np.asarray(_host(positions))
    cell_np = np.asarray(_host(cell), dtype=np.float64)
    if ns_mesh is None:
        ns_mesh = calc.get_ns_mesh(cell_np)
    ns_mesh = tuple(int(n) for n in ns_mesh)
    nodes = int(calc.interpolation_nodes)
    method = calc._method
    nx, ny, nz = ns_mesh
    D = int(n_devices)
    if nx % D:
        raise ValueError(f"mesh nx={nx} must be divisible by {D} devices")
    mx = nx // D
    if mx % (2 * TILE):
        raise ValueError(
            f"mesh slab of {mx} planes must be a multiple of {2 * TILE} for "
            "the tiled slab spread (use a finer mesh or fewer devices)"
        )
    if ny % (2 * TILE) or ny % D:
        raise ValueError(
            f"mesh ny={ny} must be a multiple of {2 * TILE} and of the "
            f"{D}-device axis (for the distributed-DFT layout swap)"
        )
    if nodes > TILE + 1:
        raise ValueError(f"interpolation_nodes={nodes} exceeds the tile halo")

    # real space: an x-sharded cell list without a spill list (the side list
    # would need the whole grid); the capacity covers the fullest cell
    if aligned:
        rows = True
        if not MDFastPath._aligned_supported(cell_np, cutoff, ns_mesh):
            raise ValueError(
                "aligned sharded state needs one mesh tile (8 mesh cells) "
                "per x/y cell-list cell with edge >= cutoff; this cell/mesh/"
                "cutoff combination does not allow it (use aligned=False)"
            )
        if (nx // TILE) % D:
            raise ValueError(
                f"aligned sharded state needs the {nx // TILE} x tile "
                f"columns divisible over {D} devices"
            )
        clist = compute_cell_list(
            pos_np, cell_np, cutoff, capacity=cell_capacity, spill=False,
            xy_cells=(nx // TILE, ny // TILE), device="cpu",
        )
    else:
        clist = compute_cell_list(
            pos_np, cell_np, cutoff, capacity=cell_capacity, spill=False,
            x_multiple=D, device="cpu",
        )
    nxc, nyc, nzc = clist.n_axis
    cellcap = clist.slot_mask.shape[1]
    per_dev = (nxc // D) * nyc * nzc
    atom_index = clist.atom_index.numpy()
    slot_mask = clist.slot_mask.numpy()

    def dev(a):
        return torch.as_tensor(a).to(device)

    n_atoms = int(pos_np.shape[0])
    common = dict(
        cl_atom_index=dev(atom_index.reshape(D, per_dev, cellcap)),
        cl_slot_mask=dev(slot_mask.reshape(D, per_dev, cellcap)),
        cl_atom_wrap=dev(clist.atom_wrap.numpy().reshape(D, per_dev, cellcap, 3)),
        n_axis=(nxc, nyc, nzc), cutoff=float(clist.cutoff), ns_mesh=ns_mesh,
        nodes=nodes, method=method, n_devices=D, n_atoms=n_atoms,
    )
    if aligned:
        # tile-aligned: the cell rows ARE the tile slots; only the atom→row
        # map is needed
        row_of_atom = _host_row_of_atom(atom_index, slot_mask, n_atoms)
        return ShardedMDState(
            **common,
            tm_atom_of_slot=dev(np.zeros((D, 0, 0), np.int32)),
            row_of_atom=dev(row_of_atom.astype(np.int32)),
            aligned=True,
        )

    # k space: per-rank mesh-tile tables on the extended local slab
    atom_of_slot = _host_tile_tables(pos_np, cell_np, ns_mesh, nodes, D, tile_capacity)
    row_of_atom = tm_slot_rows = None
    if rows:
        row_np = _host_row_of_atom(atom_index, slot_mask, n_atoms)
        slot_rows = _host_tile_rows(
            atom_of_slot, row_np, n_atoms, per_dev, cellcap, nyc, nzc
        )
        row_of_atom = dev(row_np.astype(np.int32))
        tm_slot_rows = dev(slot_rows.astype(np.int32))
    return ShardedMDState(
        **common, tm_atom_of_slot=dev(atom_of_slot), row_of_atom=row_of_atom,
        tm_slot_rows=tm_slot_rows,
    )


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


# -- the slab window ----------------------------------------------------------------


def _slab_centers(n_axis, first: int, n_cells: int, dtype, device):
    """Fractional centres ``(n_cells, 3)`` of the global cells ``first,
    first + 1, …`` of the ``n_axis`` grid."""
    nxc, nyc, nzc = n_axis
    home = first + torch.arange(n_cells, device=device)
    home3 = torch.stack([home // (nyc * nzc), (home // nzc) % nyc, home % nzc], dim=-1)
    return (home3.to(dtype) + 0.5) / torch.tensor(n_axis, dtype=dtype, device=device)


def _slab_grids(rows_b, q_b, mask_b, wrap_b, cell, n_axis, ax: Axis, window: bool):
    """Centre-relative slab grids and staleness from the rank's bucket
    block: ``(pc_t, q_g, mf_g, pos_b, centers, valid)``.

    ``rows_b`` ``(cells, cap, 3)`` are the rows as the caller holds them,
    ``wrap_b`` the cell list's images, ``pos_b`` the wrap-canonical
    positions (differentiable in ``rows_b`` and ``cell``).  With ``window``
    (kernel C's frame, as ``ops.rspace_cells._prepare_bucketed(window=True)``)
    the centres take no gradient and float32 coordinates are rounded once
    from float64; the cell gradient of the pair vectors is then kernel C's
    image term.  Without it (the dipolar window) the centres are
    differentiable, as in the JAX package."""
    dtype, device = rows_b.dtype, rows_b.device
    nxc, nyc, nzc = n_axis
    bx = nxc // ax.size
    n_cells, cap = mask_b.shape
    mask = mask_b[..., None].to(dtype)
    wide = torch.promote_types(dtype, torch.float64) if window else dtype
    pos_w = rows_b.to(wide) - torch.matmul(wrap_b.to(wide), cell.to(wide))
    frac = _slab_centers(n_axis, ax.rank * n_cells, n_cells, wide, device)
    centers = torch.matmul(frac, cell.detach().to(wide) if window else cell)
    pc = ((pos_w - centers[:, None, :]) * mask.to(wide)).to(dtype)
    pc_t = pc.reshape(bx, nyc, nzc, cap, 3).transpose(-1, -2).contiguous()
    q_g = q_b.reshape(bx, nyc, nzc, cap, -1).contiguous()
    mf_g = mask_b.reshape(bx, nyc, nzc, cap).to(dtype)
    with torch.no_grad():
        n_f = torch.tensor(n_axis, dtype=dtype, device=device)
        frac_t = torch.einsum("fe,xyzfa->xyzea", inv3(cell.detach()) * n_f[None, :], pc_t)
        valid = torch.all(torch.abs(frac_t) < 0.5 + STALE_TOL)
    return pc_t, q_g, mf_g, pos_w.to(dtype), centers.to(dtype), valid


def _halo_plane(grid, ax: Axis):
    """``grid`` ``(bx, …)`` extended by the right neighbour's first plane:
    ``(bx + 1, …)`` (rank ``r`` sends its first plane to ``r − 1``)."""
    return torch.cat([grid, ring_hop(grid[:1], -1, ax)], dim=0)


def _window_offsets_of(cell, n_axis, cap: int, dtype):
    """Window offset vectors ``(14, 3)`` of the global grid (kernel C's
    order), from float64 and without gradient (the image term carries it)."""
    wide = torch.promote_types(dtype, torch.float64)
    flat = torch.tensor(_window_offsets(cap), dtype=wide, device=cell.device)
    n_f = torch.tensor(n_axis, dtype=wide, device=cell.device)
    return torch.matmul(flat / n_f, cell.detach().to(wide)).to(dtype)


def _global_image_lift(pc_ext, cell, ax: Axis):
    """``pc_ext`` with the global x image of the last rank's halo plane: a
    zero ``cell[0] − cell[0].detach()`` on its coordinates (see the module
    docstring).  Other ranks' halos lie across no periodic boundary."""
    if ax.rank != ax.size - 1:
        return pc_ext
    lift = (cell[0] - cell[0].detach()).to(pc_ext.dtype)  # (3,), zero
    plane = torch.zeros_like(pc_ext[:1]) + lift[None, None, None, :, None]
    return pc_ext + torch.cat([torch.zeros_like(pc_ext[:-1]), plane], dim=0)


def _slab_window_from_grids(potential, pc_t, q_g, mf_g, cell, n_axis, cutoff, ax, plain):
    """Halo exchange + kernel C's split window on prepared slab grids.

    The right neighbour's first plane of cells rides one ring hop (centre-
    relative coordinates make the periodic wrap cancel, the global boundary
    included), and the i-side charges are zero on the halo plane, so each
    unordered pair counts once over all ranks.  Returns ``(e_local, pc_ext,
    q_ext)``: the extended grids serve the mesh side of the rows step too."""
    bx, cap = pc_t.shape[0], pc_t.shape[-1]
    pc_ext = _halo_plane(pc_t, ax)
    q_ext = _halo_plane(q_g, ax)
    mf_ext = _halo_plane(mf_g, ax)
    i_scale = (torch.arange(bx + 1, device=pc_t.device) < bx).to(q_ext.dtype)
    qi_ext = q_ext * i_scale[:, None, None, None, None]
    offs = _window_offsets_of(cell, n_axis, cap, pc_t.dtype)
    e_local = _window_energy(
        potential, _global_image_lift(pc_ext, cell, ax), q_ext, mf_ext, offs, cell,
        cutoff, plain, qi_g=qi_ext,
    )
    return e_local, pc_ext, q_ext


def _rank_block(state, ax: Axis):
    r = ax.rank
    return state.cl_atom_index[r], state.cl_slot_mask[r], state.cl_atom_wrap[r]


def _slab_window_energy(potential, charges, cell, positions, state, ax, plain):
    """The rank's window energy from atom-order ``positions`` (one gather
    of its slab's atoms): ``(e_local, valid)``."""
    cl_idx, cl_mask, cl_wrap = _rank_block(state, ax)
    idx = cl_idx.reshape(-1).long()
    rows_b = positions.index_select(0, idx).reshape(*cl_mask.shape, 3)
    q_b = charges.to(positions.dtype).index_select(0, idx).reshape(*cl_mask.shape, -1)
    q_b = q_b * cl_mask[..., None].to(q_b.dtype)
    pc_t, q_g, mf_g, _, _, valid = _slab_grids(
        rows_b, q_b, cl_mask, cl_wrap, cell, state.n_axis, ax, window=True
    )
    e_local, _, _ = _slab_window_from_grids(
        potential, pc_t, q_g, mf_g, cell, state.n_axis, state.cutoff, ax, plain
    )
    return e_local, valid


# -- the slab mesh ------------------------------------------------------------------


def _gather_slots(table, source, sentinel: int):
    """Rows ``source[table]`` of the ``(T, K)`` slot table, a zero row for
    the ``sentinel`` (empty slots)."""
    padded = torch.cat([source, source.new_zeros((1, source.shape[1]))], dim=0)
    return padded.index_select(0, table.reshape(-1).long()).reshape(*table.shape, -1)


def _slab_tile_geometry(pos_slots, empty, cell, ns_mesh, nodes, method, ax, derivatives):
    """Tile bucketing of slot positions on the rank's extended slab ``(mx +
    2·TILE, ny, nz)``: ``(interp, rel_inverse, valid)`` (x rebased by
    ``rank·mx − TILE``, y and z periodic)."""
    nx, ny, nz = ns_mesh
    mx = nx // ax.size
    ext = mx + 2 * TILE
    n_tiles = pos_slots.shape[0]
    ty_count = ny // TILE
    device = pos_slots.device
    inverse_cell = inv3(cell)
    frac = torch.einsum("tka,ab->tkb", pos_slots, inverse_cell)
    frac = frac - torch.floor(frac)  # wrap into the cell (zero-gradient shift)
    rel = frac * torch.tensor(ns_mesh, dtype=pos_slots.dtype, device=device)
    base, offsets = _axis_offsets(rel, nodes)
    weights = compute_1d_weights(offsets, nodes, method).movedim(0, -1)  # (T, K, 3, n)
    dweights = None
    if derivatives:
        dweights = compute_1d_weight_derivatives(offsets, nodes, method).movedim(0, -1)
    start = torch.remainder(base + 1 - (nodes + 1) // 2, torch.tensor(ns_mesh, device=device))
    # x rebased onto the extended slab; y/z stay global (periodic)
    lx = start[..., 0] - ax.rank * mx + TILE
    tile_idx = torch.arange(n_tiles, device=device)
    loc_x = lx - (tile_idx // ty_count * TILE)[:, None]
    loc_y = torch.remainder(start[..., 1] - (tile_idx % ty_count * TILE)[:, None], ny)
    valid = torch.all(empty | ((loc_x >= 0) & (loc_x < TILE) & (loc_y < TILE)))
    # a stale slot keeps its stencil in the tile's window (the kernels index
    # by it); the flag poisons the result
    loc_x = torch.clamp(loc_x, 0, TILE - 1)
    loc_y = torch.clamp(loc_y, 0, TILE - 1)
    weights = torch.where(empty[..., None, None], 0.0, weights)
    if dweights is not None:
        dweights = torch.where(empty[..., None, None], 0.0, dweights)
    i32 = torch.int32
    interp = TiledInterpolation(
        local_x=torch.where(empty, 0, loc_x).to(i32),
        local_y=torch.where(empty, 0, loc_y).to(i32),
        start_z=torch.where(empty, 0, start[..., 2]).to(i32),
        weights=weights,
        slot_of_atom=torch.zeros((0,), dtype=i32, device=device),  # unused here
        dropped=torch.zeros((), dtype=i32, device=device),
        ns=(ext, ny, nz),
        nodes=nodes,
        dweights=dweights,
    )
    return interp, inverse_cell, valid


def _slab_spread_from_slots(pos_slots, q_slots, empty, cell, ns_mesh, nodes, method, ax, plain):
    """Tile spread (kernel D) of gathered ``(T, K, …)`` slot tables on the
    rank's extended slab, and the ring fold of the skirts: ``(interior (C,
    nx/D, ny, nz), valid)``."""
    interp, _, valid = _slab_tile_geometry(
        pos_slots, empty, cell, ns_mesh, nodes, method, ax, derivatives=False
    )
    rho_ext = spread_tiles(interp, q_slots.transpose(1, 2), plain=plain)
    return _halo_fold(rho_ext, TILE, ax), valid


def _slab_spread_dipole_from_slots(
    pos_slots, mu_slots, empty, cell, ns_mesh, nodes, method, ax, plain
):
    r"""The dipolar gradient density :math:`Q(m) = \sum_j \vec\mu_j\cdot
    \nabla_{r_j} W_j(m)` of gathered slot tables on the rank's extended
    slab (kernel D's dipole form, with the effective per-axis charges
    :math:`\tilde\mu_a = n_a \sum_b \mu_b (\text{cell}^{-1})_{ba}`), and
    the ring fold: ``(interior (1, nx/D, ny, nz), valid)``."""
    interp, inverse_cell, valid = _slab_tile_geometry(
        pos_slots, empty, cell, ns_mesh, nodes, method, ax, derivatives=True
    )
    ns_t = torch.tensor(ns_mesh, dtype=mu_slots.dtype, device=mu_slots.device)
    nu = torch.matmul(mu_slots, inverse_cell) * ns_t
    nu = torch.where(empty[..., None], 0.0, nu)
    rho_ext = spread_dipoles(interp, nu.transpose(1, 2), plain=plain)
    return _halo_fold(rho_ext, TILE, ax), valid


def _slab_tiled_density(charges, cell, positions, state, ax, plain):
    """Spread the rank's atoms (its tile table into atom order) and fold:
    ``(interior, valid)``."""
    table = state.tm_atom_of_slot[ax.rank]
    pos_slots = _gather_slots(table, positions, state.n_atoms)
    q_slots = _gather_slots(table, charges.to(positions.dtype), state.n_atoms)
    return _slab_spread_from_slots(
        pos_slots, q_slots, table == state.n_atoms, cell, state.ns_mesh, state.nodes,
        state.method, ax, plain,
    )


def _slab_aligned_density(pos_b, q_b, cell, state, ax, plain):
    """Tile-aligned slab spread: the rank's rows are its tile slots, spread
    by kernel A with no gather (its VJP is kernel B).

    ``pos_b`` are the ``(cells, cap, 3)`` wrap-canonical rows in the aligned
    cell order ``(bx, ny_c, nz_c)``, ``q_b`` their masked charges.  Kernel A
    computes the stencil weights on the extended slab (x rebased by
    ``TILE − rank·mx`` in the rows' dtype, as the JAX package does), with an
    empty tile column on each side for the skirts, folded by the ring hops."""
    if pos_b.dtype != torch.float32:
        raise ValueError(
            f"the aligned sharded MD state runs the fused float32 kernels; got "
            f"{pos_b.dtype} rows — use float32 state, or aligned=False"
        )
    nx, ny, nz = state.ns_mesh
    mx = nx // ax.size
    ext = mx + 2 * TILE
    nxc, nyc, nzc = state.n_axis
    bx = nxc // ax.size
    cap = pos_b.shape[1]
    n_ch = q_b.shape[-1]
    k = nzc * cap
    extent, lpad = aligned_geometry(state.nodes)
    dtype, device = pos_b.dtype, pos_b.device
    ns_t = torch.tensor(state.ns_mesh, dtype=dtype, device=device)
    rel = torch.matmul(pos_b.reshape(-1, 3), inv3(cell)) * ns_t
    # integer shifts are exact in float32: stencil starts decide in lockstep
    # with the single-rank aligned path
    shift = torch.tensor(TILE, dtype=dtype) - torch.tensor(mx, dtype=dtype) * ax.rank
    rel = rel + torch.stack([shift, torch.tensor(0.0), torch.tensor(0.0)]).to(device)
    pad_rel = rel.new_zeros((nyc * k, 3))
    pad_q = q_b.new_zeros((nyc * k, n_ch))
    rel_p = torch.cat([pad_rel, rel, pad_rel], dim=0)
    q_p = torch.cat([pad_q, q_b.reshape(-1, n_ch), pad_q], dim=0).contiguous()
    geom = SpreadGeometry((ext, ny, nz), state.nodes, state.method, extent, lpad,
                          (bx + 2) * nyc, k, nzc)
    rho_ext = _Spread.apply(rel_p, q_p, *geom.as_args(), plain)
    return _halo_fold(rho_ext, TILE, ax)


def _dft_quadratic_sharded(interior, kfilter_local, ax: Axis):
    """The rank's share of the Parseval form ``Σ_k w_kz K̂ |ρ̂|²`` (float64):
    the forward transforms of the distributed filter and the weighted sum
    over the rank's y block of the spectrum (:func:`psum` for the total)."""
    spec = _fft_forward_sharded(interior, ax)  # (C, nx, ny/D, kz)
    nz = interior.shape[-1]
    fold = torch.as_tensor(_hermitian_fold_weights(nz), dtype=kfilter_local.dtype,
                           device=kfilter_local.device)
    power = spec.real**2 + spec.imag**2
    return torch.sum(power * (fold * kfilter_local), dtype=torch.float64)


def _kspace_total(potential, e_quad, charges, cell):
    """``½ [Σ w K̂|ρ̂|² / V − self − background]`` in float64, as
    ``PMECalculator._kspace_energy_from_rho`` assembles it."""
    f64 = torch.float64
    volume = torch.abs(det3(cell)).to(f64)
    e = e_quad / volume
    e = e - potential.self_contribution() * torch.sum(charges**2, dtype=f64)
    charge_tot = torch.sum(charges, dim=0, dtype=f64)
    e = e - 2 * potential.background_correction() * torch.sum(charge_tot**2) / volume
    return e / 2


def _check_state(state, ax: Axis, n_atoms: int, axis: str):
    if ax.size != state.n_devices:
        raise ValueError(
            f"state was built for {state.n_devices} devices, mesh axis "
            f"'{axis}' has {ax.size}"
        )
    if n_atoms != state.n_atoms:
        raise ValueError(f"state was built for {state.n_atoms} atoms, got {n_atoms}")


def sharded_md_energy(
    calc,
    device_mesh,
    charges: torch.Tensor,
    cell: torch.Tensor,
    positions: torch.Tensor,
    state: ShardedMDState,
    axis: str = "atoms",
    plain: bool = False,
) -> torch.Tensor:
    r"""Total energy :math:`E = \sum_i q_i V_i`, SPMD over the ranks.

    Matches ``calc.energy(charges, cell, positions, cell_list=...,
    ns_mesh=state.ns_mesh)``, the single-rank MD path, with every gradient
    (positions, charges, cell: forces, charge derivatives and the virial)
    through the collectives.  Every rank passes the same arguments and gets
    the same energy.  A stale ``state`` poisons the energy and its gradients.

    :param device_mesh: a ``DeviceMesh`` with one dimension named ``axis``,
        a process group, or ``None`` for the default group.
    :param plain: the kernels' plain versions on any device; by default CPU
        tensors take them and CUDA tensors the kernels (C's split variant,
        D; E and F backward).
    """
    ax = axis_of(device_mesh, axis)
    _check_state(state, ax, charges.shape[0], axis)
    calc_v = _replicated_calc(calc, ax)
    q_v, cell_v, pos_v = replicate(ax, charges, cell, positions)
    e_r, valid_r = _slab_window_energy(calc_v.potential, q_v, cell_v, pos_v, state, ax, plain)
    interior, valid_m = _slab_tiled_density(q_v, cell_v, pos_v, state, ax, plain)
    kf_local = calc_v._kspace_filter(cell_v, state.ns_mesh)[:, _block(state.ns_mesh[1], ax)]
    e_k = _dft_quadratic_sharded(interior, kf_local, ax)
    # staleness on ANY rank corrupts halos globally: poison every partial
    flag = reduce_flag(valid_r & valid_m, ax)
    e_r = psum(e_r * flag.to(e_r.dtype), ax)
    e_quad = psum(e_k * flag, ax)
    return e_r + _kspace_total(calc.potential, e_quad, charges, cell).to(e_r.dtype)


def sharded_md_energy_rows(
    calc,
    device_mesh,
    charges: torch.Tensor,
    cell: torch.Tensor,
    pos_rows: torch.Tensor,
    state: ShardedMDState,
    axis: str = "atoms",
    plain: bool = False,
) -> torch.Tensor:
    r"""The slab-sharded MD step from each rank's own block of bucket rows.

    Same energy and gradients as :func:`sharded_md_energy`, but rank ``r``
    passes only ``state.rank_rows(state.bucket(positions), r)``
    (``(n_rows/D, 3)``), and the gradient with respect to it comes back in
    that block: no position gather and no force reduction across ranks.

    * the mesh side of a ``rows=True`` state reads its tile tables from the
      *extended-local* rows (the rank's rows plus the halo plane the window
      already shipped): no collective of its own beyond the skirt fold;
    * an ``aligned=True`` state spreads the rank's rows as its tile slots
      with kernel A (float32 rows only): no gather at all.

    Charges and the cell are replicated.  A stale state poisons the energy
    and every gradient on every rank.
    """
    ax = axis_of(device_mesh, axis)
    _check_state(state, ax, charges.shape[0], axis)
    if state.tm_slot_rows is None and not state.aligned:
        raise ValueError("sharded_md_energy_rows needs a state built with rows=True")
    if pos_rows.shape[0] != state.rows_per_rank:
        raise ValueError(
            f"state has {state.n_rows} slab rows, {state.rows_per_rank} a rank; got "
            f"{pos_rows.shape[0]}"
        )
    if state.aligned and pos_rows.dtype != torch.float32:
        raise ValueError(
            f"the aligned sharded MD state runs the fused float32 kernels; got "
            f"{pos_rows.dtype} rows — use float32 state, or aligned=False"
        )
    _k.refuse_batched("sharded_md_energy_rows (kernels A, B, C)", charges, cell, pos_rows)
    calc_v = _replicated_calc(calc, ax)
    q_v, cell_v = replicate(ax, charges, cell)
    cl_idx, cl_mask, cl_wrap = _rank_block(state, ax)
    cells_local, cap = cl_mask.shape
    dtype = pos_rows.dtype
    q_b = q_v.to(dtype).index_select(0, cl_idx.reshape(-1).long()).reshape(cells_local, cap, -1)
    q_b = q_b * cl_mask[..., None].to(dtype)
    pc_t, q_g, mf_g, pos_b, centers, valid = _slab_grids(
        pos_rows.reshape(cells_local, cap, 3), q_b, cl_mask, cl_wrap, cell_v,
        state.n_axis, ax, window=True,
    )
    e_r, pc_ext, q_ext = _slab_window_from_grids(
        calc_v.potential, pc_t, q_g, mf_g, cell_v, state.n_axis, state.cutoff, ax, plain
    )
    if state.aligned:
        # mesh staleness is implied by cell-list staleness, as on one rank
        interior = _slab_aligned_density(pos_b, q_b, cell_v, state, ax, plain)
    else:
        # the mesh side reads the extended-local rows: absolute canonical
        # positions from the grids the window's halo already shipped
        nxc, nyc, nzc = state.n_axis
        plane = nyc * nzc
        halo_first = ((ax.rank + 1) % ax.size) * cells_local
        centers_halo = torch.matmul(
            _slab_centers(state.n_axis, halo_first, plane, centers.dtype, centers.device),
            cell_v.detach().to(centers.dtype),
        )
        centers_ext = torch.cat([centers, centers_halo], dim=0).detach()
        pc_rows = pc_ext.transpose(-1, -2).reshape(cells_local + plane, cap, 3)
        pos_ext = (pc_rows + centers_ext[:, None, :]).reshape(-1, 3)
        q_ext_rows = q_ext.reshape(-1, q_ext.shape[-1])
        table = state.tm_slot_rows[ax.rank]
        sentinel = (cells_local + plane) * cap
        interior, valid_m = _slab_spread_from_slots(
            _gather_slots(table, pos_ext, sentinel), _gather_slots(table, q_ext_rows, sentinel),
            table == sentinel, cell_v, state.ns_mesh, state.nodes, state.method, ax, plain,
        )
        valid = valid & valid_m
    kf_local = calc_v._kspace_filter(cell_v, state.ns_mesh)[:, _block(state.ns_mesh[1], ax)]
    e_k = _dft_quadratic_sharded(interior, kf_local, ax)
    # the force cotangents stay on their rank (no sum to spread a NaN), so
    # the staleness flag is global before it multiplies the partials
    flag = reduce_flag(valid, ax)
    e_r = psum(e_r * flag.to(e_r.dtype), ax)
    e_quad = psum(e_k * flag, ax)
    return e_r + _kspace_total(calc.potential, e_quad, charges, cell).to(e_r.dtype)
