"""Bucket-order MD state: the PME energy + force step without per-step gathers.

Counterpart of :class:`torchpme_tpu.md.MDFastPath` in its **aligned**,
**tiled** and **fused** modes (for ``PMECalculator`` and ``P3MCalculator``),
of :class:`torchpme_tpu.md.MDFastPathEwald` (the window of kernel C plus the
explicit Ewald sum on charge rows) and of
:class:`torchpme_tpu.md.MDFastPathDipole` (point dipoles: the window of
kernel G plus the dipolar Ewald or mesh k-space).  Positions live in
cell-bucket rows across steps (converted once, at build or rebucket time,
like a neighbor-list build).

* ``"aligned"``: the cell list's x/y grid is pinned to the 8×8 mesh-tile
  grid, so the same rows are the slots of the spread kernels, and the step
  pays no gather in either direction.  One step: the real-space window
  (kernel C) + the aligned spread (kernel A; its VJP is kernel B) + the
  k-space quadratic form on cuFFT.  Needs one mesh tile per x/y cell with
  edge ≥ cutoff, which bounds how fine the mesh can be.
* ``"tiled"``: any mesh that tiles.  The cell list is free of the mesh; a
  tile bucketing whose slots name bucket rows is refreshed from the rows
  each step (one gather) and spread by kernel D (its VJP is kernels E + F).
* ``"fused"``: the tiled mode's state, but the step spreads the slots
  straight from the gathered rows with kernel A at the stencil-start
  geometry (its VJP is kernel B), with no per-slot weights in device memory
  (:func:`~torchpme_tpu_torch.ops.spread_fused.fused_tiled_density`).
  float32 state; float64 state runs the tiled mode's step.

Autograd of :meth:`MDFastPath.energy` with respect to the rows gives minus
the forces in row layout.  Once an atom drifts out of its cell (or, in tiled
mode, out of its tile's stencil window) the energy and every gradient are
NaN: rebuild with :meth:`MDFastPath.rebucket`.
"""

from __future__ import annotations

import copy
from dataclasses import replace

import numpy as np
import torch
from torch import nn

from . import kernels as _k
from .device import resolve_device
from .ops.math import inv3
from .ops.mesh_tiled import (
    TILE,
    TiledInterpolation,
    compute_tiled_interpolation,
    supports_tiling,
)
from .ops.rspace_cells import (
    STALE_TOL,
    CellList,
    cell_list_rspace_energy_rows,
    compute_cell_list,
)
from .ops.rspace_cells_dipole import cell_list_rspace_dipole_energy_rows
from .ops.spread_fused import aligned_geometry, aligned_tiled_density

__all__ = ["MDFastPath", "MDFastPathDipole", "MDFastPathEwald"]


def _row_mapping(clist: CellList, n_atoms: int) -> tuple[np.ndarray, int]:
    """Bucket-row id of every atom (spill extras appended after the cell
    rows), host-side."""
    n_cells, cap = clist.slot_mask.shape
    row_of_atom = np.zeros(n_atoms, dtype=np.int32)
    idx = clist.atom_index.cpu().numpy()
    msk = clist.slot_mask.cpu().numpy()
    rows = np.arange(n_cells * cap, dtype=np.int32).reshape(n_cells, cap)
    row_of_atom[idx[msk]] = rows[msk]
    n_rows = n_cells * cap
    if clist.extra_index is not None:
        e_idx = clist.extra_index.cpu().numpy()
        e_msk = clist.extra_mask.cpu().numpy()
        row_of_atom[e_idx[e_msk]] = n_rows + np.nonzero(e_msk)[0].astype(np.int32)
        n_rows += e_idx.shape[0]
    return row_of_atom, n_rows


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _extras_tile_table(pos_np, cell_np, clist: CellList, ns_mesh, nodes, method, device):
    """Tile bucketing of the spill side-list rows (host-side): the aligned
    state spreads its cell rows as tile slots, and with this table its spill
    rows (``pos_rows[nb:]``) too, by a refresh and kernel D (E + F backward).

    Padded side-list slots are parked along the cell diagonal for the
    bucketing (so no tile overflows on them) and then emptied: the
    ``atom_of_slot`` sentinel, a trash ``slot_of_atom`` and zero weights,
    which exempt them from the refresh's staleness check, as unoccupied
    tile slots are."""
    e_idx = clist.extra_index.cpu().numpy()
    e_msk = clist.extra_mask.cpu().numpy()
    e_pad = int(e_idx.shape[0])
    frac = ((np.arange(e_pad) + 0.5) / e_pad).astype(pos_np.dtype)
    parked = frac[:, None] * cell_np.sum(axis=0)[None, :].astype(pos_np.dtype)
    ext_pos = np.where(e_msk[:, None], pos_np[e_idx], parked)
    pos_t = torch.as_tensor(ext_pos, device=device)
    interp = compute_tiled_interpolation(
        pos_t, inv3(torch.as_tensor(cell_np, dtype=pos_t.dtype, device=device)),
        ns_mesh, nodes, method,
    )
    dropped = int(interp.dropped)
    if dropped:
        raise ValueError(
            f"{dropped} spill extras exceeded the extras tile capacity "
            "(unexpected: the capacity counts exact occupancy)"
        )
    n_tiles, capacity = interp.local_x.shape
    aos = interp.atom_of_slot.cpu().numpy()
    phantom = np.concatenate([~e_msk, [True]])[np.minimum(aos, e_pad)]
    aos = np.where(phantom, e_pad, aos).astype(np.int32)
    soa = interp.slot_of_atom.cpu().numpy()
    soa = np.where(e_msk, soa, n_tiles * capacity).astype(np.int32)
    weights = interp.weights.cpu().numpy().copy()
    weights[phantom] = 0.0
    return replace(
        interp,
        atom_of_slot=torch.from_numpy(aos).to(device),
        slot_of_atom=torch.from_numpy(soa).to(device),
        weights=torch.from_numpy(weights).to(device),
    )


def _rows_tile_bucketing(
    pos_np, cell_np, ns_mesh, nodes, method, tile_capacity, row_of_atom, n_rows, device,
    derivatives=False,
) -> TiledInterpolation:
    """A tile bucketing of the atoms whose ``atom_of_slot`` names bucket
    rows (sentinel ``n_rows``), so a refresh reads the row-layout positions."""
    n_atoms = pos_np.shape[0]
    pos_t = torch.as_tensor(pos_np, device=device)
    tiled = compute_tiled_interpolation(
        pos_t, inv3(torch.as_tensor(cell_np, dtype=pos_t.dtype, device=device)),
        ns_mesh, nodes, method, capacity=tile_capacity, derivatives=derivatives,
    )
    dropped = int(tiled.dropped)
    if dropped:
        raise ValueError(
            f"{dropped} atoms exceeded the tile capacity; pass a larger "
            "`tile_capacity`"
        )
    slots = tiled.atom_of_slot.cpu().numpy()
    remapped = np.where(
        slots == n_atoms, n_rows, row_of_atom[np.minimum(slots, n_atoms - 1)]
    ).astype(np.int32)
    return replace(tiled, atom_of_slot=torch.from_numpy(remapped).to(device))


class MDFastPath(nn.Module):
    """A PME calculator bound to reusable bucketings, in bucket-row layout.

    Build with :meth:`create` (host-side, like a neighbor-list build).

    Example
    -------
    >>> import numpy as np, torch
    >>> import torchpme_tpu_torch as tpt
    >>> rng = np.random.default_rng(0)
    >>> positions = torch.tensor(rng.uniform(0, 14.0, (240, 3)))
    >>> charges = torch.tensor(np.tile([1.0, -1.0], 120).reshape(-1, 1))
    >>> cell = torch.eye(3, dtype=torch.float64) * 14.0
    >>> calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0),
    ...                          interpolation_nodes=4)
    >>> fp = tpt.MDFastPath.create(calc, positions, cell, 3.0, (32, 32, 32))
    >>> rows = fp.bucket(positions).requires_grad_()
    >>> e = fp.energy(charges, cell, rows)
    >>> forces = -fp.unbucket(torch.autograd.grad(e, rows)[0])
    >>> print(forces.shape)
    torch.Size([240, 3])
    """

    def __init__(
        self,
        calc,
        clist: CellList,
        row_of_atom: torch.Tensor,
        ns_mesh: tuple[int, int, int],
        n_rows: int,
        n_atoms: int,
        cell_grid: tuple[int, int, int, int] | None,
        aligned_pad: int = 0,
        tiled: TiledInterpolation | None = None,
        mesh_impl: str | None = None,
        extras_tiled: TiledInterpolation | None = None,
    ):
        super().__init__()
        #: "aligned" (cell rows are the tile slots), or "tiled" / "fused"
        #: (``tiled`` holds a tile bucketing whose ``atom_of_slot`` names
        #: bucket rows; "tiled" when not given)
        self.mesh_impl = "aligned" if tiled is None else mesh_impl or "tiled"
        if tiled is not None:
            # the rows layout is consumed by the tile refresh (or the fused
            # spread): pin the backend so an auto-resolved scatter can never
            # see row-layout positions
            calc = copy.copy(calc)
            calc.mesh_backend = "fused" if self.mesh_impl == "fused" else "tiled"
        self.calc = calc
        self.clist = clist
        self.tiled = tiled
        self.row_of_atom = row_of_atom
        self.ns_mesh = tuple(int(n) for n in ns_mesh)
        self.n_rows = int(n_rows)
        self.n_atoms = int(n_atoms)
        self.cell_grid = None if cell_grid is None else tuple(int(n) for n in cell_grid)
        self.aligned_pad = int(aligned_pad)
        #: extras-only tile bucketing of the spill rows (aligned mode with a
        #: spill list and ``extras_impl="tiled"``); None: the scatter spreads them
        self.extras_tiled = extras_tiled

    @classmethod
    def create(
        cls,
        calc,
        positions,
        cell,
        cutoff: float,
        ns_mesh=None,
        cell_capacity: int | None = None,
        tile_capacity: int | None = None,
        mesh_impl: str = "auto",
        extras_impl: str = "auto",
        balance: str | bool = "auto",
        _spill: bool | None = None,
        device=None,
    ) -> "MDFastPath":
        """Bucket ``positions`` for ``calc`` (host-side, numpy).

        :param calc: a :class:`~torchpme_tpu_torch.PMECalculator` or
            :class:`~torchpme_tpu_torch.P3MCalculator`.
        :param cutoff: real-space cutoff of the cell list.
        :param ns_mesh: static mesh shape (``calc.get_ns_mesh(cell)`` when
            omitted).
        :param tile_capacity: slots per mesh tile in tiled and fused mode
            (default: from the true maximum occupancy, a multiple of 64; fused
            mode takes multiples of 8).
        :param mesh_impl: ``"aligned"``, ``"tiled"``, ``"fused"`` or
            ``"auto"``: aligned where :meth:`_aligned_supported` allows it;
            otherwise fused for state on a CUDA device (on an H100 the fused
            102k step ran faster than the tiled one, in wall and in device
            time: PERF.md), tiled on the CPU.
        :param extras_impl: how the aligned mode spreads its spill atoms:
            ``"scatter"`` (the generic scatter, recomputed each step),
            ``"tiled"`` (an extras-only tile table: refresh + kernel D, E + F
            backward) or ``"auto"``: the scatter (on an H100 the table took
            more device time than the scatter at 168 and at 1101 spill atoms
            of the 102k box, PERF.md; the JAX package's ``"auto"`` takes the
            table from 512 on, where it saved time on a TPU).
        :param balance: overflow-balance the cell list (``"auto"``: in
            aligned mode, when the widened spread window fits the 2-tile
            fold; tiled mode balances only on ``True``).
        :param device: device of the state (default: that of ``positions``
            when it is a tensor, else
            :func:`torchpme_tpu_torch.default_device`).
        """
        device = resolve_device(device, positions, cell)
        pos_np = _to_numpy(positions)
        cell_np = np.asarray(_to_numpy(cell), np.float64)
        if ns_mesh is None:
            ns_mesh = calc.get_ns_mesh(cell_np)
        ns_mesh = tuple(int(n) for n in ns_mesh)
        if not supports_tiling(ns_mesh, calc.interpolation_nodes):
            raise ValueError(
                f"MDFastPath needs the tiled mesh backend: mesh {ns_mesh} / "
                f"{calc.interpolation_nodes} nodes does not tile (nx, ny must "
                "be multiples of 16)"
            )
        if mesh_impl == "auto":
            if cls._aligned_supported(cell_np, cutoff, ns_mesh):
                mesh_impl = "aligned"
            else:
                mesh_impl = "fused" if device.type == "cuda" else "tiled"
        if mesh_impl not in ("aligned", "tiled", "fused"):
            raise ValueError(
                f"`mesh_impl` is {mesh_impl!r} but must be 'auto', 'aligned', 'tiled' "
                "or 'fused'"
            )
        if mesh_impl == "fused" and tile_capacity is not None and tile_capacity % 8:
            raise ValueError(
                "the fused spread needs a tile capacity that is a multiple of 8, "
                f"got tile_capacity={tile_capacity}"
            )
        if mesh_impl == "aligned" and not cls._aligned_supported(cell_np, cutoff, ns_mesh):
            raise ValueError(
                "aligned MD state needs one mesh tile (8 mesh cells) per x/y "
                "cell-list cell with edge >= cutoff; this cell/mesh/cutoff "
                "combination does not allow it (use mesh_impl='tiled')"
            )
        if extras_impl not in ("auto", "tiled", "scatter"):
            raise ValueError(
                f"`extras_impl` is {extras_impl!r} but must be 'auto', 'tiled' or "
                "'scatter'"
            )
        if balance not in ("auto", True, False):
            raise ValueError(
                f"`balance` is {balance!r} but must be 'auto', True or False"
            )
        if mesh_impl != "aligned":
            return cls._create_tiled(
                calc, pos_np, cell_np, cutoff, ns_mesh, cell_capacity, tile_capacity,
                balance is True, _spill, device, mesh_impl,
            )
        # overflow balance: x/y slack capped so the widened spread window
        # still fits the 2-tile fold, with room for the staleness tolerance
        # (an atom the check accepts sits up to slack + STALE_TOL cell edges
        # outside its cell, and one x/y cell is TILE mesh cells); z slack is
        # unconstrained on the mesh side
        base_extent, _ = aligned_geometry(calc.interpolation_nodes)
        pad_budget = (2 * TILE - base_extent) // 2
        plane = 1.0 / np.linalg.norm(np.linalg.inv(cell_np), axis=0)
        h_mesh = plane[:2] / np.asarray(ns_mesh[:2], np.float64)
        use_balance = balance is True or (balance == "auto" and pad_budget >= 1)
        cap_cells = max(0.0, pad_budget - STALE_TOL * TILE)
        bal_arg = (
            (cap_cells * float(h_mesh[0]), cap_cells * float(h_mesh[1]), np.inf)
            if use_balance
            else False
        )
        clist = compute_cell_list(
            pos_np, cell_np, cutoff, capacity=cell_capacity, spill=_spill,
            xy_cells=(ns_mesh[0] // TILE, ns_mesh[1] // TILE),
            balance=bal_arg, device=device,
        )
        # the window widens by every mesh cell that an atom the staleness
        # check accepts (slack + STALE_TOL cell edges of TILE mesh cells past
        # its tile) can start a stencil in: an even stencil starts at
        # floor(r), an odd one at round(r), half a cell later
        reach = (max(clist.slack[:2]) + STALE_TOL) * TILE
        margin = 0.5 if calc.interpolation_nodes % 2 else 0.0
        aligned_pad = max(0, int(np.ceil(reach - margin - 1e-9)))
        assert aligned_pad <= pad_budget, "balance slack exceeds the spread window"
        _, cap = clist.slot_mask.shape
        row_of_atom, n_rows = _row_mapping(clist, pos_np.shape[0])
        extras_tiled = None
        if clist.extra_index is not None and extras_impl == "tiled":
            extras_tiled = _extras_tile_table(
                pos_np, cell_np, clist, ns_mesh, calc.interpolation_nodes, calc._method, device,
            )
        return cls(
            calc,
            clist,
            torch.from_numpy(row_of_atom).to(device),
            ns_mesh,
            n_rows,
            pos_np.shape[0],
            (*clist.n_axis, cap),
            aligned_pad,
            extras_tiled=extras_tiled,
        )

    @classmethod
    def _create_tiled(
        cls, calc, pos_np, cell_np, cutoff, ns_mesh, cell_capacity, tile_capacity,
        balance, spill, device, mesh_impl,
    ) -> "MDFastPath":
        """Tiled and fused mode: a cell list free of the mesh plus a tile
        bucketing whose slots name bucket rows."""
        clist = compute_cell_list(
            pos_np, cell_np, cutoff, capacity=cell_capacity, spill=spill,
            balance=balance, device=device,
        )
        n_atoms = pos_np.shape[0]
        row_of_atom, n_rows = _row_mapping(clist, n_atoms)
        tiled = _rows_tile_bucketing(
            pos_np, cell_np, ns_mesh, calc.interpolation_nodes, calc._method,
            tile_capacity, row_of_atom, n_rows, device,
        )
        return cls(
            calc, clist, torch.from_numpy(row_of_atom).to(device), ns_mesh, n_rows,
            n_atoms, None, 0, tiled, mesh_impl,
        )

    @staticmethod
    def _aligned_supported(cell, cutoff: float, ns_mesh) -> bool:
        """One mesh tile (8 mesh cells) per x/y cell must keep the cell-plane
        distance ≥ cutoff, and the cutoff must fit the cell at all."""
        cell_np = np.asarray(_to_numpy(cell), np.float64)
        plane = 1.0 / np.linalg.norm(np.linalg.inv(cell_np), axis=0)
        max_cells = np.floor(plane / cutoff)
        want = (ns_mesh[0] // TILE, ns_mesh[1] // TILE)
        return bool(
            np.all(plane >= cutoff)
            and max_cells[0] >= want[0]
            and max_cells[1] >= want[1]
        )

    # -- layout conversion (at build/rebucket boundaries) -------------------

    def bucket(self, positions: torch.Tensor) -> torch.Tensor:
        """Atom-order ``(N, 3)`` → bucket rows ``(n_rows, 3)`` (padding 0)."""
        positions = torch.as_tensor(positions, device=self.row_of_atom.device)
        rows = positions.new_zeros((self.n_rows, 3))
        return rows.index_copy(0, self.row_of_atom.long(), positions)

    def unbucket(self, pos_rows: torch.Tensor) -> torch.Tensor:
        """Bucket rows back to atom order."""
        return pos_rows[self.row_of_atom.long()]

    def rebucket(self, pos_rows, cell, cutoff=None) -> "MDFastPath":
        """Rebuild the bucketing from drifted rows (like a neighbor-list
        refresh), keeping the cell capacity and the spill side list so the
        row shapes stay stable."""
        return type(self).create(
            self.calc,
            self.unbucket(pos_rows),
            cell,
            cutoff if cutoff is not None else self.clist.cutoff,
            ns_mesh=self.ns_mesh,
            cell_capacity=self.clist.slot_mask.shape[1],
            tile_capacity=None if self.tiled is None else self.tiled.local_x.shape[1],
            mesh_impl=self.mesh_impl,
            extras_impl="scatter" if self.extras_tiled is None else "tiled",
            balance=max(self.clist.slack) > 0.0,
            _spill=self.clist.extra_index is not None,
            device=self.row_of_atom.device,
        )

    # -- the step ------------------------------------------------------------

    def energy(
        self,
        charges: torch.Tensor,
        cell: torch.Tensor,
        pos_rows: torch.Tensor,
        plain: bool = False,
    ) -> torch.Tensor:
        r"""Total energy :math:`\sum_i q_i V_i` from bucket rows.

        Autograd with respect to ``pos_rows`` gives minus the forces in row
        layout (padded rows get zero).  NaN when the bucketing is stale.

        :param plain: run the kernels' plain twins on any device (the
            reference path of the comparisons).  By default CPU tensors take
            the twins and CUDA tensors the kernels.
        """
        _k.refuse_batched("MDFastPath (kernels A, B, C)", charges, cell, pos_rows)
        e_sr = cell_list_rspace_energy_rows(
            self.calc.potential, charges, pos_rows, cell, self.clist, plain=plain
        )
        if self.mesh_impl != "aligned":
            # pos_rows are consumed only by the tile refresh or the fused
            # spread (row-id slots); a stale bucketing poisons the energy
            # instead of raising, so the step never waits for the device
            e_k = self.calc._compute_kspace_energy(
                charges.to(pos_rows.dtype), cell, pos_rows, ns_mesh=self.ns_mesh,
                tiled_interp=self.tiled, check_stale=False, plain=plain,
            )
            return e_sr + e_k
        dtype = pos_rows.dtype
        q_rows = charges.new_zeros((self.n_rows, charges.shape[-1]), dtype=dtype)
        q_rows = q_rows.index_copy(0, self.row_of_atom.long(), charges.to(dtype))
        rho = aligned_tiled_density(
            pos_rows,
            q_rows,
            inv3(cell),
            self.ns_mesh,
            self.calc.interpolation_nodes,
            self.calc._method,
            self.cell_grid,
            pad_cells=self.aligned_pad,
            extras_interp=self.extras_tiled,
            plain=plain,
        )
        # mesh staleness is implied by cell-list staleness (an atom the check
        # accepts keeps its stencil in the tile window: the pad covers slack
        # and tolerance), which poisons e_sr; a stale extras table poisons rho
        e_k = self.calc._kspace_energy_from_rho(
            rho, cell, charges, pos_rows, None, self.ns_mesh
        )
        return e_sr + e_k


class MDFastPathEwald(nn.Module):
    r"""Bucket-order MD state for the explicit-k-sum Ewald calculator, the
    :math:`O(N^2)` counterpart of :class:`MDFastPath` for the small and
    medium systems where Ewald beats the mesh methods.

    The real-space sum runs through the cell-list window in row layout
    (kernel C on a card: no per-step gather or force scatter); the k-space
    term is the structure-factor quadratic form
    :math:`\tfrac1V\sum_k \hat v(k)|S(k)|^2` on the charge rows, where
    padded rows carry :math:`q = 0` and drop out of every term and gradient.
    Only the window NaN-poisons on stale rows.

    Example
    -------
    >>> import numpy as np, torch
    >>> import torchpme_tpu_torch as tpt
    >>> rng = np.random.default_rng(0)
    >>> positions = torch.tensor(rng.uniform(0, 8.0, (100, 3)))
    >>> charges = torch.tensor(np.tile([1.0, -1.0], 50).reshape(-1, 1))
    >>> cell = torch.eye(3, dtype=torch.float64) * 8.0
    >>> calc = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=2.0)
    >>> fp = tpt.MDFastPathEwald.create(calc, positions, cell, cutoff=2.5)
    >>> rows = fp.bucket(positions).requires_grad_()
    >>> e = fp.energy(charges, cell, rows)
    >>> forces = -fp.unbucket(torch.autograd.grad(e, rows)[0])
    >>> clist = tpt.ops.compute_cell_list(
    ...     positions, cell, 2.5, capacity=fp.clist.slot_mask.shape[1], spill=False)
    >>> e_ref = calc.energy(charges, cell, positions, cell_list=clist,
    ...                     ns_kvectors=fp.ns_kvectors)
    >>> print(bool(torch.allclose(e, e_ref, rtol=1e-10)))
    True
    """

    def __init__(
        self,
        calc,
        clist: CellList,
        row_of_atom: torch.Tensor,
        ns_kvectors: tuple[int, int, int],
        n_rows: int,
        n_atoms: int,
    ):
        super().__init__()
        self.calc = calc
        self.clist = clist
        self.row_of_atom = row_of_atom
        self.ns_kvectors = tuple(int(n) for n in ns_kvectors)
        self.n_rows = int(n_rows)
        self.n_atoms = int(n_atoms)

    @classmethod
    def create(
        cls,
        calc,
        positions,
        cell,
        cutoff: float,
        cell_capacity: int | None = None,
        _spill: bool | None = None,
        device=None,
    ) -> "MDFastPathEwald":
        """Bucket ``positions`` for the Ewald ``calc`` (host-side, numpy).

        Same contract as :meth:`MDFastPath.create` without the mesh
        arguments: the k-space extents come from ``calc.get_ns_kvectors``,
        so the k-vectors are rebuilt from the cell inside the step (exact
        stress).  The JAX package's ``window_impl`` has no counterpart: the
        window runs kernel C on a card and its plain version on the CPU.

        :param device: device of the state (default: that of ``positions``
            when it is a tensor, else
            :func:`torchpme_tpu_torch.default_device`).
        """
        if not hasattr(calc, "get_ns_kvectors"):
            raise ValueError(
                "MDFastPathEwald needs an EwaldCalculator (mesh calculators use MDFastPath)"
            )
        device = resolve_device(device, positions, cell)
        pos_np = _to_numpy(positions)
        cell_np = np.asarray(_to_numpy(cell), np.float64)
        clist = compute_cell_list(
            pos_np, cell_np, cutoff, capacity=cell_capacity, spill=_spill, device=device
        )
        row_of_atom, n_rows = _row_mapping(clist, pos_np.shape[0])
        return cls(
            calc, clist, torch.from_numpy(row_of_atom).to(device),
            calc.get_ns_kvectors(cell_np), n_rows, pos_np.shape[0],
        )

    def bucket(self, positions: torch.Tensor) -> torch.Tensor:
        """Atom-order ``(N, 3)`` → bucket rows ``(n_rows, 3)`` (padding 0)."""
        positions = torch.as_tensor(positions, device=self.row_of_atom.device)
        rows = positions.new_zeros((self.n_rows, 3))
        return rows.index_copy(0, self.row_of_atom.long(), positions)

    def unbucket(self, pos_rows: torch.Tensor) -> torch.Tensor:
        """Bucket rows back to atom order."""
        return pos_rows[self.row_of_atom.long()]

    def rebucket(self, pos_rows, cell, cutoff=None) -> "MDFastPathEwald":
        """Rebuild the bucketing from drifted rows (like a neighbor-list
        refresh), keeping the cell capacity and the spill side list."""
        return type(self).create(
            self.calc,
            self.unbucket(pos_rows),
            cell,
            cutoff if cutoff is not None else self.clist.cutoff,
            cell_capacity=self.clist.slot_mask.shape[1],
            _spill=self.clist.extra_index is not None,
            device=self.row_of_atom.device,
        )

    def energy(
        self,
        charges: torch.Tensor,
        cell: torch.Tensor,
        pos_rows: torch.Tensor,
        plain: bool = False,
    ) -> torch.Tensor:
        r"""Total energy :math:`\sum_i q_i V_i` from bucket rows.

        Autograd with respect to ``pos_rows`` gives minus the forces in row
        layout.  NaN when the cell-list bucketing is stale.

        :param plain: run the window's plain version on any device.
        """
        _k.refuse_batched("MDFastPathEwald (kernel C)", charges, cell, pos_rows)
        e_sr = cell_list_rspace_energy_rows(
            self.calc.potential, charges, pos_rows, cell, self.clist, plain=plain
        )
        dtype = pos_rows.dtype
        q_rows = charges.new_zeros((self.n_rows, charges.shape[-1]), dtype=dtype)
        q_rows = q_rows.index_copy(0, self.row_of_atom.long(), charges.to(dtype))
        e_k = self.calc._compute_kspace_energy(
            q_rows, cell, pos_rows, ns_kvectors=self.ns_kvectors
        )
        return e_sr + e_k


class MDFastPathDipole(nn.Module):
    """Bucket-order MD state for dipolar systems, the dipolar counterpart of
    :class:`MDFastPath`.

    The real-space sum runs through the dipolar cell-list window in row
    layout
    (:func:`~torchpme_tpu_torch.ops.rspace_cells_dipole.cell_list_rspace_dipole_energy_rows`,
    kernel G on a card: no per-step gather or force scatter).  With a
    :class:`~torchpme_tpu_torch.PMECalculatorDipole` on the tiled mesh
    backend, a tile bucketing (with derivative stencils) whose slots name
    bucket rows is refreshed from the rows each step and spread by kernel D;
    otherwise (Ewald, or the scatter backend) the k-space term consumes
    dipole rows directly: every term is dipole-weighted, so padded rows
    (with zero dipole) contribute nothing.

    Example
    -------
    >>> import numpy as np, torch
    >>> import torchpme_tpu_torch as tpt
    >>> rng = np.random.default_rng(0)
    >>> positions = torch.tensor(rng.uniform(0, 8.0, (60, 3)))
    >>> dipoles = torch.tensor(rng.normal(size=(60, 3)))
    >>> cell = torch.eye(3, dtype=torch.float64) * 8.0
    >>> calc = tpt.CalculatorDipole(tpt.PotentialDipole(smearing=1.0), lr_wavelength=2.0)
    >>> fp = tpt.MDFastPathDipole.create(calc, positions, cell, cutoff=2.5)
    >>> rows = fp.bucket(positions).requires_grad_()
    >>> e = fp.energy(dipoles, cell, rows)
    >>> forces = -fp.unbucket(torch.autograd.grad(e, rows)[0])
    >>> clist = tpt.ops.compute_cell_list(
    ...     positions, cell, 2.5, capacity=fp.clist.slot_mask.shape[1], spill=False)
    >>> e_ref = calc.energy(dipoles, cell, positions, cell_list=clist,
    ...                     ns_kvectors=fp.ns_kvectors)
    >>> print(bool(torch.allclose(e, e_ref, rtol=1e-10)))
    True
    """

    def __init__(
        self,
        calc,
        clist: CellList,
        row_of_atom: torch.Tensor,
        ns_kvectors: tuple[int, int, int] | None,
        n_rows: int,
        n_atoms: int,
        tiled: TiledInterpolation | None = None,
    ):
        super().__init__()
        if hasattr(calc, "mesh_backend"):
            # the k-space term sees row-layout positions: pin the backend the
            # state was built for, so `auto` cannot resolve differently later
            calc = copy.copy(calc)
            calc.mesh_backend = "scatter" if tiled is None else "tiled"
        self.calc = calc
        self.clist = clist
        self.row_of_atom = row_of_atom
        self.ns_kvectors = None if ns_kvectors is None else tuple(int(n) for n in ns_kvectors)
        self.n_rows = int(n_rows)
        self.n_atoms = int(n_atoms)
        self.tiled = tiled

    @classmethod
    def create(
        cls,
        calc,
        positions,
        cell,
        cutoff: float,
        cell_capacity: int | None = None,
        _spill: bool | None = None,
        device=None,
    ) -> "MDFastPathDipole":
        """Bucket ``positions`` for the dipolar ``calc`` (host-side, numpy).

        Like :meth:`MDFastPath.create`, the cell list uses a tight capacity
        with the overflow spill side list by default (``_spill``), so
        inhomogeneous systems need no manual capacity tuning; extras ride as
        tail rows.  The JAX package's ``window_impl`` argument has no
        counterpart here: the window runs kernel G on a card and its plain
        version on the CPU (or with ``energy(..., plain=True)``).

        :param calc: a :class:`~torchpme_tpu_torch.CalculatorDipole` or
            :class:`~torchpme_tpu_torch.PMECalculatorDipole`.
        :param device: device of the state (default: that of ``positions``
            when it is a tensor, else
            :func:`torchpme_tpu_torch.default_device`).
        """
        device = resolve_device(device, positions, cell)
        pos_np = _to_numpy(positions)
        cell_np = np.asarray(_to_numpy(cell), np.float64)
        clist = compute_cell_list(
            pos_np, cell_np, cutoff, capacity=cell_capacity, spill=_spill, device=device
        )
        n_atoms = pos_np.shape[0]
        row_of_atom, n_rows = _row_mapping(clist, n_atoms)
        ns_k = calc.get_ns_kvectors(cell_np) if calc.potential.smearing is not None else None
        tiled = None
        use_tiled = getattr(calc, "_use_tiled", None)
        if ns_k is not None and use_tiled is not None and use_tiled(ns_k, device):
            tiled = _rows_tile_bucketing(
                pos_np, cell_np, ns_k, calc.interpolation_nodes, calc._method,
                calc.tile_capacity, row_of_atom, n_rows, device, derivatives=True,
            )
        return cls(
            calc, clist, torch.from_numpy(row_of_atom).to(device), ns_k, n_rows, n_atoms, tiled
        )

    def bucket(self, positions: torch.Tensor) -> torch.Tensor:
        """Atom-order ``(N, 3)`` → bucket rows ``(n_rows, 3)`` (padding 0)."""
        positions = torch.as_tensor(positions, device=self.row_of_atom.device)
        rows = positions.new_zeros((self.n_rows, 3))
        return rows.index_copy(0, self.row_of_atom.long(), positions)

    def unbucket(self, pos_rows: torch.Tensor) -> torch.Tensor:
        """Bucket rows back to atom order."""
        return pos_rows[self.row_of_atom.long()]

    def rebucket(self, pos_rows, cell, cutoff=None) -> "MDFastPathDipole":
        """Rebuild the bucketing from drifted rows (like a neighbor-list
        refresh), keeping the cell capacity and the spill side list."""
        return type(self).create(
            self.calc,
            self.unbucket(pos_rows),
            cell,
            cutoff if cutoff is not None else self.clist.cutoff,
            cell_capacity=self.clist.slot_mask.shape[1],
            _spill=self.clist.extra_index is not None,
            device=self.row_of_atom.device,
        )

    def energy(
        self,
        dipoles: torch.Tensor,
        cell: torch.Tensor,
        pos_rows: torch.Tensor,
        plain: bool = False,
    ) -> torch.Tensor:
        r"""Total dipolar energy :math:`\sum_i \vec V_i\cdot\vec\mu_i` from
        bucket rows.

        Autograd with respect to ``pos_rows`` gives minus the forces in row
        layout, with respect to ``dipoles`` (atom order, ``(N, 3)``) the
        fields.  NaN when the bucketing is stale.

        :param plain: run the kernels' plain versions on any device (the
            reference path of the comparisons).
        """
        _k.refuse_batched("MDFastPathDipole (kernels G, D, E, F)", dipoles, cell, pos_rows)
        potential = self.calc.potential
        e_sr = cell_list_rspace_dipole_energy_rows(
            potential, dipoles, pos_rows, cell, self.clist, plain=plain
        )
        if potential.smearing is None:
            return e_sr
        dtype = pos_rows.dtype
        if self.tiled is not None:
            # the dipoles stay in atom order (the tile slots map atoms); the
            # rows feed only the per-step weight refresh (row-id slots)
            e_k = self.calc._compute_kspace_energy(
                dipoles.to(dtype), cell, pos_rows, ns_kvectors=self.ns_kvectors,
                tiled_interp=self.tiled, check_stale=False, plain=plain,
            )
            return e_sr + e_k
        mu_rows = dipoles.new_zeros((self.n_rows, 3), dtype=dtype)
        mu_rows = mu_rows.index_copy(0, self.row_of_atom.long(), dipoles.to(dtype))
        e_k = self.calc._compute_kspace_energy(
            mu_rows, cell, pos_rows, ns_kvectors=self.ns_kvectors, plain=plain
        )
        return e_sr + e_k
