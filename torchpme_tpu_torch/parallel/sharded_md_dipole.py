"""Slab-sharded dipolar MD step: the dipolar cell-list window plus the Ewald
or mesh quadratic form, SPMD over the ranks of a ``torch.distributed`` group.

Counterpart of :mod:`torchpme_tpu.parallel.sharded_md_dipole`, with the
decomposition of :mod:`.sharded_md`:

* **real space** — the dipolar window of kernel G runs on each rank's cell
  slab extended by ONE halo plane fetched from its right neighbour, with the
  *i-side dipoles* zero on the halo plane (G's ``mui_g``), so every
  unordered pair is counted by exactly one rank;
* **k space, Ewald mode** (:class:`~torchpme_tpu_torch.CalculatorDipole`)
  — each rank sums the partial structure factors
  :math:`S(k) = \\sum_i (\\vec\\mu_i\\cdot\\vec k) e^{i k\\cdot r_i}` over its
  own rows, ONE sum of the ``(2, n_k)`` spectrum over the ranks, and the
  replicated :math:`\\sum_k \\hat v(k) |S(k)|^2 / V`: the collective carries
  O(n_k), never O(atoms);
* **k space, PME mode** (:class:`~torchpme_tpu_torch.PMECalculatorDipole`)
  — the dipolar gradient spread (kernel D's dipole form) per mesh slab from
  the extended-local rows (the halo plane's dipoles from the window's hop,
  its positions by one more hop), and the distributed Parseval form (ONE
  all-to-all swap).

The window's cell gradient flows through differentiable cell centres and
offsets here (kernel G carries no image term), so the global periodic wrap
of the last rank's halo enters through the centres, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels as _k
from ..device import resolve_device
from ..ops.kspace import compute_kspace_filter
from ..ops.kvectors import generate_kvectors_for_ewald
from ..ops.math import det3
from ..ops.mesh_tiled import TILE
from ..ops.rspace_cells import _window_offsets, compute_cell_list
from ..ops.rspace_cells_dipole import _dipole_window_energy
from ._collectives import axis_of, psum, reduce_flag, replicate, ring_hop
from .sharded import _block, _replicated_calc
from .sharded_md import (
    _check_state,
    _dft_quadratic_sharded,
    _gather_slots,
    _halo_plane,
    _host,
    _host_row_of_atom,
    _host_tile_rows,
    _host_tile_tables,
    _rank_block,
    _slab_grids,
    _slab_spread_dipole_from_slots,
)

__all__ = [
    "ShardedMDDipoleState",
    "compute_sharded_md_dipole_state",
    "sharded_md_dipole_energy_rows",
]


@dataclass(frozen=True)
class ShardedMDDipoleState:
    """Host-computed x-slab cell bucketing for the sharded dipolar step.

    Refresh like a neighbor list: atoms drifting out of their cell poison
    the energy and every gradient with NaN.
    """

    # cell-list x-slabs: (D, bx·ny·nz cells, cap)
    cl_atom_index: torch.Tensor
    cl_slot_mask: torch.Tensor
    cl_atom_wrap: torch.Tensor  # (D, cells, cap, 3) int8
    #: bucket-row id of every atom (the rows layout of ShardedMDState)
    row_of_atom: torch.Tensor
    n_axis: tuple[int, int, int]
    cutoff: float
    #: Ewald mode: the k-space extents; PME mode: the mesh shape
    ns_kvectors: tuple[int, int, int] | None
    n_devices: int
    n_atoms: int
    #: PME mode only: mesh-tile slot tables as extended-local row ids (None
    #: selects the Ewald quadratic form)
    tm_slot_rows: torch.Tensor | None = None
    nodes: int = 0
    method: str = ""

    @property
    def n_rows(self) -> int:
        """Total slab rows (cells · capacity, over all ranks)."""
        d, cells, cap = self.cl_slot_mask.shape
        return d * cells * cap

    @property
    def rows_per_rank(self) -> int:
        return self.n_rows // self.n_devices

    def bucket(self, positions: torch.Tensor) -> torch.Tensor:
        """Atom-order ``(N, 3)`` → all slab rows ``(n_rows, 3)``."""
        positions = torch.as_tensor(positions, device=self.row_of_atom.device)
        rows = positions.new_zeros((self.n_rows, 3))
        return rows.index_copy(0, self.row_of_atom.long(), positions)

    def unbucket(self, rows: torch.Tensor) -> torch.Tensor:
        """All slab rows back to atom order (one gather)."""
        return rows[self.row_of_atom.long()]

    def rank_rows(self, rows: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s block of the ``(n_rows, ...)`` slab rows."""
        n = self.rows_per_rank
        return rows[rank * n : (rank + 1) * n]


def compute_sharded_md_dipole_state(
    calc,
    positions,
    cell,
    cutoff: float,
    n_devices: int = 8,
    cell_capacity: int | None = None,
    tile_capacity: int | None = None,
    ns_mesh=None,
    device=None,
) -> ShardedMDDipoleState:
    """Bucket atoms into per-rank cell slabs for the dipolar step (host,
    numpy; the JAX package's arrays).

    :param calc: a :class:`~torchpme_tpu_torch.CalculatorDipole` (Ewald
        quadratic form; direct mode: none) or a
        :class:`~torchpme_tpu_torch.PMECalculatorDipole` (slab gradient
        spread and the distributed Parseval form; the mesh follows the
        scalar sharded state's divisibility rules, and mesh-tile tables are
        built: pass ``tile_capacity`` for inhomogeneous systems).
    :param cutoff: real-space cutoff (the slab window has no spill list:
        pass ``cell_capacity`` for inhomogeneous systems).
    :param device: device of the state (default: that of ``positions`` when
        it is a tensor, else :func:`torchpme_tpu_torch.default_device`).
    """
    from ..calculators.pme_dipole import PMECalculatorDipole

    device = resolve_device(device, positions, cell)
    pos_np = np.asarray(_host(positions))
    cell_np = np.asarray(_host(cell), dtype=np.float64)
    mesh_mode = isinstance(calc, PMECalculatorDipole)
    D = int(n_devices)
    if mesh_mode:
        if ns_mesh is None:
            ns_mesh = calc.get_ns_kvectors(cell_np)
        ns_mesh = tuple(int(n) for n in ns_mesh)
        nx, ny, _nz = ns_mesh
        if nx % D:
            raise ValueError(f"mesh nx={nx} must be divisible by {D} devices")
        mx = nx // D
        if mx % (2 * TILE):
            raise ValueError(
                f"mesh slab of {mx} planes must be a multiple of {2 * TILE} "
                "for the tiled slab spread (use a finer mesh or fewer "
                "devices)"
            )
        if ny % (2 * TILE) or ny % D:
            raise ValueError(
                f"mesh ny={ny} must be a multiple of {2 * TILE} and of the "
                f"{D}-device axis (for the distributed-DFT layout swap)"
            )
        nodes = int(calc.interpolation_nodes)
        if nodes > TILE + 1:
            raise ValueError(f"interpolation_nodes={nodes} exceeds the tile halo")
    clist = compute_cell_list(
        pos_np, cell_np, cutoff, capacity=cell_capacity, spill=False,
        x_multiple=D, device="cpu",
    )
    nxc, nyc, nzc = clist.n_axis
    cap = clist.slot_mask.shape[1]
    per_dev = (nxc // D) * nyc * nzc
    n_atoms = int(pos_np.shape[0])
    atom_index, slot_mask = clist.atom_index.numpy(), clist.slot_mask.numpy()
    row_of_atom = _host_row_of_atom(atom_index, slot_mask, n_atoms)

    def dev(a):
        return torch.as_tensor(a).to(device)

    tm_slot_rows = None
    nodes_out, method = 0, ""
    if mesh_mode:
        atom_of_slot = _host_tile_tables(pos_np, cell_np, ns_mesh, nodes, D, tile_capacity)
        tm_slot_rows = dev(
            _host_tile_rows(atom_of_slot, row_of_atom, n_atoms, per_dev, cap, nyc, nzc)
            .astype(np.int32)
        )
        ns_k = ns_mesh
        nodes_out, method = nodes, calc._method
    else:
        ns_k = calc.get_ns_kvectors(cell_np) if calc.potential.smearing is not None else None
    return ShardedMDDipoleState(
        cl_atom_index=dev(atom_index.reshape(D, per_dev, cap)),
        cl_slot_mask=dev(slot_mask.reshape(D, per_dev, cap)),
        cl_atom_wrap=dev(clist.atom_wrap.numpy().reshape(D, per_dev, cap, 3)),
        row_of_atom=dev(row_of_atom.astype(np.int32)),
        n_axis=(nxc, nyc, nzc),
        cutoff=float(clist.cutoff),
        ns_kvectors=None if ns_k is None else tuple(int(n) for n in ns_k),
        n_devices=D,
        n_atoms=n_atoms,
        tm_slot_rows=tm_slot_rows,
        nodes=nodes_out,
        method=method,
    )


def _slab_dipole_window_from_grids(potential, pc_t, mu_gr, mf_g, cell, n_axis, cutoff, ax,
                                   plain):
    """Halo exchange + kernel G's window with separate i-side dipoles on
    prepared slab grids (the plumbing of the scalar
    ``_slab_window_from_grids``; the offsets carry the cell gradient).
    Returns ``(e, mu_ext)``: the extended dipoles feed the mesh side of the
    PME mode."""
    bx, cap = pc_t.shape[0], pc_t.shape[-1]
    pc_ext = _halo_plane(pc_t, ax)
    mu_ext = _halo_plane(mu_gr, ax)
    mf_ext = _halo_plane(mf_g, ax)
    i_scale = (torch.arange(bx + 1, device=pc_t.device) < bx).to(mu_ext.dtype)
    mui_ext = mu_ext * i_scale[:, None, None, None, None]
    flat = torch.tensor(_window_offsets(cap), dtype=pc_t.dtype, device=pc_t.device)
    offs = torch.matmul(flat / torch.tensor(n_axis, dtype=pc_t.dtype, device=pc_t.device), cell)
    e = _dipole_window_energy(potential, pc_ext, mu_ext, mf_ext, offs, cutoff, plain,
                              mui_g=mui_ext)
    return e, mu_ext


def sharded_md_dipole_energy_rows(
    calc,
    device_mesh,
    dipoles: torch.Tensor,
    cell: torch.Tensor,
    pos_rows: torch.Tensor,
    state: ShardedMDDipoleState,
    axis: str = "atoms",
    plain: bool = False,
) -> torch.Tensor:
    r"""Total dipolar energy :math:`E = \sum_i \vec V_i\cdot\vec\mu_i`, SPMD
    from each rank's own block of bucket rows.

    Matches ``calc.energy(dipoles, cell, positions, cell_list=...,
    ns_kvectors=state.ns_kvectors)`` with every gradient: with respect to
    the rank's ``pos_rows`` (``state.rank_rows(state.bucket(positions),
    rank)``) minus the forces in that block, with respect to ``dipoles`` the
    fields, to ``cell`` the stress seed.  Dipoles and the cell are
    replicated.  A stale state poisons the energy and every gradient.

    :param plain: the kernels' plain versions on any device; by default CPU
        tensors take them and CUDA tensors the kernels (G with ``mui_g``;
        in PME mode D's dipole form, E and F's backward).  A potential with
        a parameter that requires grad takes the plain autograd window,
        which needs ``plain=True`` on a card.
    """
    e_r, e_k = _dipole_energy_parts(calc, device_mesh, dipoles, cell, pos_rows, state, axis,
                                    plain)
    return e_r if e_k is None else e_r + e_k


def _dipole_energy_parts(calc, device_mesh, dipoles, cell, pos_rows, state, axis, plain):
    """The two terms of :func:`sharded_md_dipole_energy_rows`, apart: the
    window's energy (summed over the ranks) and the k-space energy with its
    corrections (``None`` without smearing), each with its gradients."""
    ax = axis_of(device_mesh, axis)
    _check_state(state, ax, dipoles.shape[0], axis)
    if pos_rows.shape[0] != state.rows_per_rank:
        raise ValueError(
            f"state has {state.n_rows} slab rows, {state.rows_per_rank} a rank; got "
            f"{pos_rows.shape[0]}"
        )
    _k.refuse_batched("sharded_md_dipole_energy_rows (kernel G)", dipoles, cell, pos_rows)
    potential = calc.potential
    lr = potential.smearing is not None
    mesh_mode = state.tm_slot_rows is not None
    calc_v = _replicated_calc(calc, ax)
    mu_v, cell_v = replicate(ax, dipoles, cell)
    cl_idx, cl_mask, cl_wrap = _rank_block(state, ax)
    cells_local, cap = cl_mask.shape
    dtype = pos_rows.dtype
    mu_b = mu_v.to(dtype).index_select(0, cl_idx.reshape(-1).long()).reshape(cells_local, cap, 3)
    mu_b = mu_b * cl_mask[..., None].to(dtype)
    pc_t, mu_gr, mf_g, pos_b, _, valid = _slab_grids(
        pos_rows.reshape(cells_local, cap, 3), mu_b, cl_mask, cl_wrap, cell_v,
        state.n_axis, ax, window=False,
    )
    e_r, mu_ext = _slab_dipole_window_from_grids(
        calc_v.potential, pc_t, mu_gr, mf_g, cell_v, state.n_axis, state.cutoff, ax, plain
    )

    if mesh_mode:
        # the gradient spread from the extended-local rows: the rank's own and
        # the next slab's first cell plane, whose absolute canonical positions
        # ride one ring hop (rebuilt from the window's centre-relative halo,
        # as the JAX package does, the positions carry two cancelling centre
        # terms into the float32 cell gradient)
        ns_mesh = state.ns_kvectors
        plane = state.n_axis[1] * state.n_axis[2]
        pos_ext = torch.cat([pos_b, ring_hop(pos_b[:plane], -1, ax)]).reshape(-1, 3)
        table = state.tm_slot_rows[ax.rank]
        sentinel = (cells_local + plane) * cap
        interior, valid_m = _slab_spread_dipole_from_slots(
            _gather_slots(table, pos_ext, sentinel),
            _gather_slots(table, mu_ext.reshape(-1, 3), sentinel),
            table == sentinel, cell_v, ns_mesh, state.nodes, state.method, ax, plain,
        )
        kfilter = compute_kspace_filter(calc_v.potential.lr_from_k_sq, cell_v, ns_mesh)
        e_quad = _dft_quadratic_sharded(interior, kfilter[:, _block(ns_mesh[1], ax)], ax)
        flag = reduce_flag(valid & valid_m, ax)
        e_r = psum(e_r * flag.to(e_r.dtype), ax)
        e_quad = psum(e_quad * flag, ax)
    else:
        # one rank's staleness poisons every rank's (sharded) force rows
        flag = reduce_flag(valid, ax)
        e_r = psum(e_r * flag.to(e_r.dtype), ax)
        if not lr:
            return e_r, None
        # Ewald quadratic form from the local rows: partial structure
        # factors, ONE sum of the (2, n_k) spectrum.  Canonical positions are
        # exact here (k·L = 2πn for Ewald k-vectors)
        kvectors = generate_kvectors_for_ewald(cell, state.ns_kvectors)
        (kv_v,) = replicate(ax, kvectors)
        pos_flat, mu_flat = pos_b.reshape(-1, 3), mu_b.reshape(-1, 3)
        trig_args = torch.matmul(kv_v, pos_flat.T)  # (n_k, R)
        mu_k = torch.matmul(kv_v, mu_flat.T)  # (n_k, R)
        s_part = torch.stack([torch.sum(torch.cos(trig_args) * mu_k, dim=1),
                              torch.sum(torch.sin(trig_args) * mu_k, dim=1)])
        s_full = psum(s_part, ax)  # (2, n_k)
        g_kernel = potential.lr_from_k_sq(torch.sum(kvectors**2, dim=-1))
        e_quad = torch.sum(g_kernel * torch.sum(s_full**2, dim=0), dtype=torch.float64)
        e_quad = e_quad * flag

    # the corrections of CalculatorDipole._compute_kspace_energy
    f64 = torch.float64
    volume = torch.abs(det3(cell))
    e_k = e_quad / volume.to(f64)
    e_k = e_k - potential.self_contribution() * torch.sum(dipoles**2, dtype=f64)
    mu_tot = torch.sum(dipoles, dim=0, dtype=f64)
    e_k = e_k + potential.background_correction(volume) * torch.sum(mu_tot**2)
    return e_r, (e_k / 2).to(e_r.dtype)
