"""Cell-list real-space sum of the MD step, and per-atom potentials over
a cell list.

Counterpart of :mod:`torchpme_tpu.ops.rspace_cells`.  Atoms are bucketed
on the host, in numpy, into cells of edge ≥ cutoff (:func:`compute_cell_list`,
with overflow balance and a spill side list); every pair within the cutoff then lies in the 27-cell torus window
of its home cell.  The energy :math:`\\sum_{i<j} q_iq_jV_{SR}(d_{ij})` is
summed over the 13 half-window neighbor offsets plus the self cell, and one
pass returns the energy together with its whole gradient
(:func:`window_value_and_grad`, kernel C in ``csrc/window.cu``, beside its
plain twin :func:`_we_value_and_grad`).  The gradient then flows through
the window inputs (positions, charges, cell) by autograd.  The pair term
follows the calculators' convention: the short-range part of a potential
with smearing, the whole potential without (direct mode; kernel C's
unsmeared variant).  :func:`cell_list_rspace_potentials` gives the per-atom
potentials over the same windows in plain PyTorch (XLA code in the JAX
package too), differentiable by autograd.

Staleness keeps the JAX package's contract: once an atom leaves its cell
the energy, and every gradient, is NaN.
"""

from __future__ import annotations

import functools
from collections.abc import Sequence
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from .. import kernels as _k
from ..device import resolve_device
from .math import inv3

__all__ = [
    "STALE_TOL",
    "CellList",
    "cell_list_rspace_energy",
    "cell_list_rspace_energy_rows",
    "cell_list_rspace_potentials",
    "compute_cell_list",
    "window_value_and_grad",
]


@dataclass(frozen=True)
class CellList:
    """Host-computed cell bucketing, as tensors on one device.

    ``atom_index``/``slot_mask`` hold the atoms of each cell (padded to the
    capacity, row-major ``(nx, ny, nz)`` cell order); ``atom_wrap`` is the
    periodic image each atom was wrapped by.  ``slack`` is the per-axis
    assignment slack of overflow-balanced lists, in cell-edge units.  The
    ``extra_*`` side list holds atoms beyond a cell's capacity (``None``
    when nothing spilled).  Integer dtypes match the JAX package's.
    """

    atom_index: torch.Tensor  # (n_cells, capacity) int32
    slot_mask: torch.Tensor  # (n_cells, capacity) bool
    atom_wrap: torch.Tensor  # (n_cells, capacity, 3) int8
    n_axis: tuple[int, int, int]
    cutoff: float
    slack: tuple[float, float, float] = (0.0, 0.0, 0.0)
    extra_index: torch.Tensor | None = None  # (E,) int32
    extra_mask: torch.Tensor | None = None  # (E,) bool
    extra_cell: torch.Tensor | None = None  # (E, 3) int32
    extra_wrap: torch.Tensor | None = None  # (E, 3) int8


#: how far past its assignment slack (in cell edges) an atom may drift before
#: the staleness check poisons the energy
STALE_TOL = 1e-4


# -- host-side bucketing -------------------------------------------------------


def _spill_cost(n_cells: int, cap: int, extras: int) -> float:
    """Cost model of a capacity: window work ``n_cells·14·cap²`` plus the
    spill pass ``≈2·27·cap·E + 8·E²`` for ``E`` spilled atoms."""
    return n_cells * 14 * cap * cap + 54 * cap * extras + 8.0 * extras**2


def _cap_max(counts) -> int:
    """Smallest multiple-of-8 capacity (≥ 8) holding the fullest cell."""
    return max(8, int(-(-int(counts.max()) // 8) * 8))


def _choose_capacity(counts, n_cells: int) -> int:
    """The multiple-of-8 capacity minimizing :func:`_spill_cost`."""
    best, best_cost = None, None
    for cap in range(8, _cap_max(counts) + 8, 8):
        cost = _spill_cost(n_cells, cap, int(np.maximum(0, counts - cap).sum()))
        if best_cost is None or cost < best_cost:
            best, best_cost = cap, cost
    return best


def _balance_overflow(ids3, wrap, u, counts, capacity, slack_cell, n_axis):
    """Greedy overflow diffusion (host, in-place on ``ids3``/``wrap``/``counts``).

    Cells holding more than ``capacity`` atoms shed their excess into
    adjacent cells with room, moving only atoms within ``slack_cell`` (cell
    units) of the shared face.  Most-overfull cells go first; within a cell,
    atoms closest to a face move first.  Returns the number of atoms moved.
    """
    nx, ny, nz = (int(n) for n in n_axis)
    n_cells = nx * ny * nz
    dirs = [
        (ax, sign)
        for ax in range(3)
        if slack_cell[ax] > 1e-9
        for sign in (-1, +1)
    ]
    if not dirs:
        return 0
    ids_flat = (ids3[:, 0] * ny + ids3[:, 1]) * nz + ids3[:, 2]
    order = np.argsort(ids_flat, kind="stable")
    cell_counts = np.bincount(ids_flat, minlength=n_cells)
    starts = np.concatenate([[0], np.cumsum(cell_counts)])
    over = np.nonzero(counts > capacity)[0]
    over = over[np.argsort(-counts[over])]
    nvec = np.asarray([nx, ny, nz])
    moved = 0
    for c in over:
        excess = int(counts[c] - capacity)
        if excess <= 0:
            continue
        atoms = order[starts[c] : starts[c + 1]]
        cx, cy, cz = c // (ny * nz), (c // nz) % ny, c % nz
        cands = []
        for ax, sign in dirs:
            d = u[atoms, ax] if sign < 0 else 1.0 - u[atoms, ax]
            elig = d < slack_cell[ax]
            for a, da in zip(atoms[elig], d[elig]):
                cands.append((float(da), int(a), ax, sign))
        cands.sort()
        seen = set()
        for _da, a, ax, sign in cands:
            if excess <= 0:
                break
            if a in seen:
                continue  # each atom moves at most once
            tgt3 = [cx, cy, cz]
            tgt3[ax] += sign
            wdelta = 0
            if tgt3[ax] < 0:
                tgt3[ax] += int(nvec[ax])
                wdelta = -1
            elif tgt3[ax] >= nvec[ax]:
                tgt3[ax] -= int(nvec[ax])
                wdelta = +1
            t = (tgt3[0] * ny + tgt3[1]) * nz + tgt3[2]
            if counts[t] >= capacity:
                continue
            ids3[a] = tgt3
            wrap[a, ax] += wdelta
            counts[c] -= 1
            counts[t] += 1
            excess -= 1
            moved += 1
            seen.add(a)
    return moved


def _choose_capacity_balanced(ids3, wrap, u, counts, n_axis, slack_cell):
    """Capacity choice for overflow-balanced spilling lists: balance at each
    candidate, score the leftover overflow with :func:`_spill_cost`, apply
    the winning assignment in place and return its capacity."""
    n_cells = counts.shape[0]
    best = None
    for cap in range(8, _cap_max(counts) + 8, 8):
        ids3_c, wrap_c, counts_c = ids3.copy(), wrap.copy(), counts.copy()
        _balance_overflow(ids3_c, wrap_c, u, counts_c, cap, slack_cell, n_axis)
        cost = _spill_cost(n_cells, cap, int(np.maximum(0, counts_c - cap).sum()))
        if best is None or cost < best[0]:
            best = (cost, cap, ids3_c, wrap_c)
    _, cap, ids3_b, wrap_b = best
    ids3[:] = ids3_b
    wrap[:] = wrap_b
    return cap


def _check_balance(balance):
    """``balance`` is ``True``, ``False`` or three per-axis slack caps."""
    if isinstance(balance, (bool, np.bool_)):
        return bool(balance)
    if (
        isinstance(balance, (tuple, list, np.ndarray))
        and len(balance) == 3
        and all(isinstance(b, (int, float, np.integer, np.floating)) for b in balance)
    ):
        return tuple(float(b) for b in balance)
    raise ValueError(
        f"`balance` is {balance!r} but must be True, False or a 3-tuple of "
        "per-axis absolute slack caps"
    )


def compute_cell_list(
    positions,
    cell,
    cutoff: float,
    capacity: int | None = None,
    spill: bool | None = None,
    x_multiple: int | None = None,
    xy_cells: tuple[int, int] | None = None,
    balance: bool | tuple[float, float, float] = False,
    device=None,
) -> CellList:
    """Bucket atoms into cells of edge ≥ ``cutoff`` (host-side, numpy).

    Same contract, and bit for bit the same arrays, as
    :func:`torchpme_tpu.ops.rspace_cells.compute_cell_list`:

    :param capacity: atoms per cell; default from a cost model (a tight
        capacity with an overflow side list).
    :param spill: allow the overflow side list (default: when
        ``capacity`` is ``None``); needs every cell-plane distance ≥
        2·cutoff.
    :param x_multiple: round the cell count along x down to a multiple of
        this (cells get larger, never smaller than the cutoff): the x-slab
        sharded MD state needs the x cell planes evenly divisible over the
        ranks (:func:`torchpme_tpu_torch.parallel.compute_sharded_md_state`).
    :param xy_cells: force the cell counts along x and y (the tile-aligned
        MD state pins them to the mesh-tile grid).
    :param balance: overflow-balance the bucketing within the per-axis
        slack ``(edge − cutoff)/2``; a 3-tuple caps the absolute slack.
    :param device: device of the returned tensors (default: that of
        ``positions`` when it is a tensor, else
        :func:`torchpme_tpu_torch.default_device`).
    """
    balance = _check_balance(balance)
    device = resolve_device(device, positions)
    if isinstance(positions, torch.Tensor):
        positions = positions.detach().cpu().numpy()
    if isinstance(cell, torch.Tensor):
        cell = cell.detach().cpu().numpy()
    pos = np.asarray(positions, dtype=np.float64)
    cell_np = np.asarray(cell, dtype=np.float64)
    inv = np.linalg.inv(cell_np)
    plane_dist = 1.0 / np.linalg.norm(inv, axis=0)
    n_axis = np.maximum(1, np.floor(plane_dist / cutoff).astype(np.int64))
    if np.any(plane_dist < cutoff):
        raise ValueError(
            f"cutoff {cutoff} exceeds a cell plane distance {plane_dist}; "
            "the 27-cell window cannot cover the cutoff sphere"
        )
    if x_multiple is not None:
        if n_axis[0] < x_multiple:
            raise ValueError(
                f"only {n_axis[0]} cell planes fit along x at cutoff {cutoff}; "
                f"cannot shard them over {x_multiple} devices"
            )
        n_axis[0] -= n_axis[0] % x_multiple
    if xy_cells is not None:
        req = np.asarray(xy_cells, dtype=np.int64)
        if np.any(req > n_axis[:2]):
            raise ValueError(
                f"xy_cells {tuple(xy_cells)} would make a cell edge smaller "
                f"than the cutoff {cutoff} (at most {tuple(n_axis[:2])} cells "
                "fit)"
            )
        n_axis[:2] = req
    nx, ny, nz = (int(n) for n in n_axis)
    n_cells = nx * ny * nz

    frac = pos @ inv
    wrap = np.floor(frac).astype(np.int64)  # periodic image of each atom
    frac -= wrap
    ids3 = np.minimum((frac * n_axis).astype(np.int64), n_axis - 1)
    ids = (ids3[:, 0] * ny + ids3[:, 1]) * nz + ids3[:, 2]

    counts = np.bincount(ids, minlength=n_cells)
    # spilling needs min-image validity for the extra↔extra pass
    spill_ok = bool(np.all(plane_dist >= 2 * cutoff))
    if spill is None:
        spill = capacity is None and spill_ok
    elif spill and not spill_ok:
        raise ValueError(
            f"spill requires every cell-plane distance ≥ 2·cutoff; got "
            f"{plane_dist} at cutoff {cutoff}"
        )
    slack_cell = (0.0, 0.0, 0.0)
    if balance is not False:
        edge = plane_dist / n_axis
        slack_abs = np.maximum(0.0, (edge - cutoff) * 0.5 * (1.0 - 1e-6))
        if balance is not True:  # per-axis absolute slack caps
            slack_abs = np.minimum(slack_abs, np.asarray(balance, np.float64))
        slack_cell = tuple(float(s) for s in slack_abs / edge)
        balance = max(slack_cell) > 1e-9  # no room: cell edges == cutoff
        if not balance:
            slack_cell = (0.0, 0.0, 0.0)
    if balance:
        u = frac * n_axis - ids3  # position within the cell, [0, 1) per axis
        if capacity is None and spill:
            capacity = _choose_capacity_balanced(
                ids3, wrap, u, counts, n_axis, slack_cell
            )
        elif capacity is None:
            # smallest multiple-of-8 capacity fully absorbed by balancing; at
            # the fullest cell's capacity nothing overflows, so the loop
            # always settles
            for cap in range(8, _cap_max(counts) + 8, 8):
                ids3_c, wrap_c, counts_c = ids3.copy(), wrap.copy(), counts.copy()
                _balance_overflow(
                    ids3_c, wrap_c, u, counts_c, cap, slack_cell, n_axis
                )
                if counts_c.max() <= cap:
                    capacity = cap
                    ids3, wrap = ids3_c, wrap_c
                    break
            assert capacity is not None, "balancing overflowed at the max capacity"
        else:
            counts_b = counts.copy()
            _balance_overflow(ids3, wrap, u, counts_b, capacity, slack_cell, n_axis)
        ids = (ids3[:, 0] * ny + ids3[:, 1]) * nz + ids3[:, 2]
        counts = np.bincount(ids, minlength=n_cells)
    if capacity is None:
        capacity = _choose_capacity(counts, n_cells) if spill else _cap_max(counts)
    if counts.max() > capacity and not spill:
        raise ValueError(
            f"capacity {capacity} below the fullest cell ({counts.max()} atoms)"
        )

    order = np.argsort(ids, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(pos.shape[0]) - starts[ids[order]]
    in_cell = rank < capacity
    atom_index = np.zeros((n_cells, capacity), dtype=np.int32)
    slot_mask = np.zeros((n_cells, capacity), dtype=bool)
    atom_wrap = np.zeros((n_cells, capacity, 3), dtype=np.int8)
    sel, rsel = ids[order][in_cell], rank[in_cell]
    atom_index[sel, rsel] = order[in_cell]
    slot_mask[sel, rsel] = True
    atom_wrap[sel, rsel] = wrap[order][in_cell]

    def dev(a):
        return torch.from_numpy(a).to(device)

    extras = (None,) * 4
    n_extra = int((~in_cell).sum())
    if n_extra > 0:
        # padded generously (multiples of 128 with headroom) so rebuilds with
        # slightly different overflow counts keep the shapes
        e_pad = max(128, int(-(-int(n_extra * 1.25) // 128) * 128))
        e_idx = np.zeros(e_pad, dtype=np.int32)
        e_mask = np.zeros(e_pad, dtype=bool)
        e_cell = np.zeros((e_pad, 3), dtype=np.int32)
        e_wrap = np.zeros((e_pad, 3), dtype=np.int8)
        out = order[~in_cell]
        e_idx[:n_extra] = out
        e_mask[:n_extra] = True
        e_cell[:n_extra] = ids3[out]
        e_wrap[:n_extra] = wrap[out]
        extras = (dev(e_idx), dev(e_mask), dev(e_cell), dev(e_wrap))

    return CellList(
        dev(atom_index),
        dev(slot_mask),
        dev(atom_wrap),
        (nx, ny, nz),
        float(cutoff),
        slack_cell,
        *extras,
    )


# -- window inputs ---------------------------------------------------------------


def _half_window_chunks(cap: int):
    """Lexicographic half-window offsets (+ the self cell, last), grouped as
    the JAX package groups them (its chunks are ≥128 lanes wide on the TPU);
    flattened, they fix the order of ``offs`` and ``d_offs``."""
    half = [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
        if (dx, dy, dz) > (0, 0, 0)
    ]
    offsets = half + [(0, 0, 0)]
    per_chunk = max(1, 128 // cap)
    return tuple(
        tuple(offsets[i : i + per_chunk]) for i in range(0, len(offsets), per_chunk)
    )


def _window_offsets(cap: int) -> list[tuple[int, int, int]]:
    return [o for chunk in _half_window_chunks(cap) for o in chunk]


def _frame_fractions(n_axis: tuple, cap: int, dtype, device) -> tuple:
    """The cell grid's frame in fractional coordinates, made once per grid:
    ``(n, centers, offsets)``, the cells per axis ``(3,)``, each cell's
    center ``(n_cells, 3)`` and the window offsets ``(14, 3)``.  Made anew
    while a graph is traced (its tensors may be fake there, and must not be
    kept)."""
    if _k.is_tracing():
        return _frame_fractions_uncached(n_axis, cap, dtype, device)
    return _frame_fractions_cached(n_axis, cap, dtype, device)


def _frame_fractions_uncached(n_axis: tuple, cap: int, dtype, device) -> tuple:
    nx, ny, nz = n_axis
    n = torch.tensor(n_axis, dtype=dtype, device=device)
    home = torch.arange(nx * ny * nz, device=device)
    home3 = torch.stack([home // (ny * nz), (home // nz) % ny, home % nz], dim=-1)
    flat = torch.tensor(_window_offsets(cap), dtype=dtype, device=device)
    return n, (home3.to(dtype) + 0.5) / n, flat / n


_frame_fractions_cached = functools.lru_cache(maxsize=None)(_frame_fractions_uncached)


def _prepare_bucketed(q_raw, pos_raw, cell, clist: CellList, window: bool = False):
    """Window inputs from positions/charges already in bucket order.

    Returns ``(pc_t, q_g, mf_g, offs, valid)``: cell-center-relative
    coordinates ``(nx, ny, nz, 3, cap)``, masked charges ``(nx, ny, nz, cap,
    C)``, the occupancy mask ``(nx, ny, nz, cap)``, the ``(14, 3)``
    center-to-center offset vectors (the cell gradient flows through them),
    and the staleness flag as a 0-d bool tensor (no host sync).

    :param window: the inputs of :class:`_WindowEnergy`, which carries the
        cell gradient of the pair vectors itself (the image term): centers
        and offsets take no gradient, and float32 coordinates are rounded
        once from float64 (centers up to a box edge from the origin would
        round by ~4e-6 Å, 1e-4 of the closest pairs' distance).
    """
    dtype, device = pos_raw.dtype, pos_raw.device
    n_channels = q_raw.shape[-1]
    nx, ny, nz = clist.n_axis
    n_cells, cap = clist.slot_mask.shape
    n_axis, center_frac, offset_frac = _frame_fractions(clist.n_axis, cap, dtype, device)
    mask = clist.slot_mask[..., None].to(dtype)
    q_b = q_raw * mask

    if window:
        # one rounding from float64, and no gradient through the frame
        wide = torch.promote_types(dtype, torch.float64)
        _, center_wide, offset_wide = _frame_fractions(clist.n_axis, cap, wide, device)
        frame = cell.detach().to(wide)
        pos_b = pos_raw.to(wide) - torch.matmul(clist.atom_wrap.to(wide), cell.to(wide))
        centers = torch.matmul(center_wide, frame)
        pc = ((pos_b - centers[:, None, :]) * mask.to(wide)).to(dtype)
        offs = torch.matmul(offset_wide, frame).to(dtype)
    else:
        # canonicalize into the cell image the bucketing assigned
        pos_b = pos_raw - torch.matmul(clist.atom_wrap.to(dtype), cell)
        centers = torch.matmul(center_frac, cell)
        pc = (pos_b - centers[:, None, :]) * mask  # park padded slots at center
        offs = torch.matmul(offset_frac, cell)  # (14, 3)
    pc_t = pc.reshape(nx, ny, nz, cap, 3).transpose(-1, -2).contiguous()
    q_g = q_b.reshape(nx, ny, nz, cap, n_channels).contiguous()
    mf_g = clist.slot_mask.reshape(nx, ny, nz, cap).to(dtype)

    # staleness: |(pc @ cell⁻¹)·n| ≤ 0.5 + slack (+tol) per axis; balanced
    # lists assign atoms up to the slack outside their cell on purpose
    with torch.no_grad():
        inv_cell = inv3(cell.detach())
        frac_t = torch.einsum("fe,xyzfa->xyzea", inv_cell * n_axis[None, :], pc_t)
        bound = 0.5 + torch.tensor(clist.slack, dtype=dtype, device=device) + STALE_TOL
        valid = torch.all(torch.abs(frac_t) < bound[:, None])
    return pc_t, q_g, mf_g, offs, valid


def _prepare(charges, positions, cell, clist: CellList, window: bool = False):
    """Window inputs from atom-order charges and positions (one gather each
    into bucket order), as :func:`_prepare_bucketed`.  The gathers are
    ``index_select``: its backward is one atomic ``index_add`` (advanced
    indexing's sorts the rows)."""
    n_cells, cap = clist.slot_mask.shape
    idx = clist.atom_index.reshape(-1).long()
    return _prepare_bucketed(
        charges.to(positions.dtype).index_select(0, idx).reshape(n_cells, cap, -1),
        positions.index_select(0, idx).reshape(n_cells, cap, 3), cell, clist, window=window,
    )


# -- pair terms ------------------------------------------------------------------


def _pair_values(potential, dist):
    """Pair terms ``v(d)`` in the calculators' convention: the whole
    potential without smearing (direct mode; times ``1 - f_cut`` with an
    exclusion window), its short-range part with."""
    if potential.smearing is None:
        values = potential.from_dist(dist)
        if getattr(potential, "exclusion_radius", None) is not None:
            values = values * (1 - potential.f_cutoff(dist))
        return values
    return potential.sr_from_dist(dist)


def _smooth_split(potential) -> bool:
    """Range-separated without an exclusion window: the pair term is the
    smooth SR part, which the analytic hooks describe."""
    return potential.smearing is not None and getattr(potential, "exclusion_radius", None) is None


def _trainable(potential) -> tuple:
    """The potential's parameters that want a gradient (the weights of a
    learnable ``CombinedPotential``)."""
    if not isinstance(potential, torch.nn.Module):
        return ()
    return tuple(p for p in potential.parameters() if p.requires_grad)


def _window_terms(potential):
    """``[(member, exponent)]``: the ``1/r^p`` pair terms kernel C evaluates
    for ``potential`` (a ``CoulombPotential`` is p = 1; a
    ``CombinedPotential`` of up to ``kernels.MAX_MEMBERS`` of them, all
    smeared or all direct), or ``None`` where it cannot (an exclusion
    window, a spline, any other member)."""
    from ..potentials import CombinedPotential, CoulombPotential, InversePowerLawPotential

    def exponent(pot):
        if getattr(pot, "exclusion_radius", None) is not None:
            return None
        if type(pot) is CoulombPotential:
            return 1
        if type(pot) is InversePowerLawPotential:
            return pot.exponent
        return None

    members = [potential]
    if type(potential) is CombinedPotential:
        members = list(potential.potentials)
        if potential.exclusion_radius is not None or not 1 <= len(members) <= _k.MAX_MEMBERS:
            return None
    terms = [(m, exponent(m)) for m in members]
    return None if any(p is None for _, p in terms) else terms


def _term_window_math(member, p: int, dist_sq):
    """float32 ``(V, V'/d)`` of one ``1/r^p`` term from :math:`d^2`: the
    member's ``sr_window_math`` with smearing, the unsmeared
    :math:`V = P d^{-p}`, :math:`V'/d = -pV/d^2` from one ``rsqrt`` without."""
    if member.smearing is not None:
        return member.sr_window_math(dist_sq)
    rd = torch.rsqrt(dist_sq)
    rd2 = rd * rd
    inv_dp = rd2 ** ((p - 1) // 2) * rd if p % 2 else rd2 ** (p // 2)
    v = member.prefactor * inv_dp
    return v, -p * v * rd2


def _window_math(potential, dist_sq):
    r"""float32 window math ``(V, V'/d, members)`` from :math:`d^2`, as
    kernel C evaluates it for the pair terms of :func:`_window_terms`: each
    term's math, combined by the weights of a ``CombinedPotential``
    (``members`` then holds each term's V, whose energies are dE/dw; else
    ``None``)."""
    from ..potentials import CombinedPotential

    parts = [_term_window_math(m, p, dist_sq) for m, p in _window_terms(potential)]
    if type(potential) is not CombinedPotential:
        return (*parts[0], None)
    values = [v for v, _ in parts]
    return (potential._combine(values), potential._combine([w for _, w in parts]), values)


def _exact_pair_terms(potential, d, vq, params):
    """The exact route's pair terms ``(v, q_iq_jV'(d), dE/dparams)``: the
    potential's ``sr_pair_force`` hook, else ``sr_derivative``, else autograd
    of the pair values (spline potentials, exclusion windows, direct mode);
    the parameter cotangents by autograd of the pair energy."""
    smooth = _smooth_split(potential)
    pair_force = getattr(potential, "sr_pair_force", None) if smooth else None
    deriv = getattr(potential, "sr_derivative", None) if smooth else None
    analytic = pair_force is not None or deriv is not None
    with torch.enable_grad():
        d_in = d if analytic else d.detach().requires_grad_()
        v_raw = _pair_values(potential, d_in)
        pair_e = vq * v_raw
        targets = list(params) if analytic else [d_in, *params]
        grads = _grads(pair_e.sum(), targets)
    v_raw, pair_e = v_raw.detach(), pair_e.detach()
    if not analytic:
        return v_raw, grads[0], grads[1:]
    if pair_force is not None:
        return v_raw, pair_force(d, vq, pair_e), grads
    return v_raw, vq * deriv(d, v_raw), grads


def _table_pair_terms(potential, terms, d, vq):
    """float64 ``(v, q_iq_jV'(d), members)`` for the pair terms of
    :func:`_window_terms`, without autograd (the body of the ``tpme::window``
    op runs below it): the smooth split's hooks with smearing, :math:`V' =
    -pV/d` per term without; ``members`` holds each term's ``v`` for a
    ``CombinedPotential`` (their energies are dE/dw), else ``None``."""
    from ..potentials import CombinedPotential

    combined = type(potential) is CombinedPotential
    if potential.smearing is not None:
        v_raw, dd, _ = _exact_pair_terms(potential, d, vq, ())
        return v_raw, dd, [_pair_values(m, d) for m, _ in terms] if combined else None
    parts = [_pair_values(m, d) for m, _ in terms]
    slopes = [-p * v / d for (_, p), v in zip(terms, parts)]
    if not combined:
        return parts[0], vq * slopes[0], None
    return potential._combine(parts), vq * potential._combine(slopes), parts


def _grads(total, targets):
    """``d total / d targets`` (zeros for a target it does not reach)."""
    if not targets:
        return []
    if not total.requires_grad:  # a pair term that depends on none of them
        return [torch.zeros_like(t) for t in targets]
    grads = torch.autograd.grad(total, targets, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(targets, grads)]


def _masked_pair_values(potential, d_sq, pair_ok):
    """``v(d)`` on the pairs of ``pair_ok``, 0 elsewhere (a safe ``d`` there,
    so gradients stay finite)."""
    d = torch.sqrt(torch.where(pair_ok, d_sq, 1.0))
    return torch.where(pair_ok, _pair_values(potential, d), 0.0)


@functools.lru_cache(maxsize=None)
def _window_neighbours(n_axis: tuple, cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Per window offset ``o`` (:func:`_window_offsets`), the flat index of
    each cell's periodic neighbour at ``h + o`` (the cell its pairs read) and
    at ``h - o`` (the cell a j-side sum goes home from): two ``(14,
    n_cells)`` arrays."""
    home = np.indices(n_axis).reshape(3, 1, -1)
    offsets = np.array(_window_offsets(cap)).T[:, :, None]  # (3, 14, 1)
    n = np.array(n_axis)[:, None, None]
    return tuple(
        np.ravel_multi_index(tuple((home + sign * offsets) % n), n_axis) for sign in (1, -1)
    )


#: pairs (cells × cap² per offset) the plain window forms at once: more
#: offsets a pass cost memory, fewer cost launches and graph nodes
_PAIR_BUDGET = 1 << 24


def _offset_chunks(n_cells: int, cap: int) -> list[slice]:
    """The window offsets in passes of at most :data:`_PAIR_BUDGET` pairs
    (one offset a pass where one offset alone exceeds it)."""
    n_off = len(_window_offsets(cap))
    per = max(1, _PAIR_BUDGET // (n_cells * cap * cap))
    return [slice(i, min(i + per, n_off)) for i in range(0, n_off, per)]


class _WindowPairs:
    """The pairs of the window offsets ``ks`` (a slice of
    :func:`_window_offsets`, all by default) at once, stacked on a leading
    axis ``k``: partner coordinates ``pj`` ``(k, x, y, z, 3, cap)``, ``d²``
    and the mask of the pairs inside the cutoff (the self pair excluded on
    the self cell), each ``(k, x, y, z, cap, cap)``; :meth:`partners` reads a
    per-cell array at each offset's neighbour, and :meth:`home` brings a
    per-offset j-side array back to its cells."""

    def __init__(self, pc_t, mf_g, offs, cutoff: float, ks: slice = slice(None)):
        nx, ny, nz, _, cap = pc_t.shape
        device = pc_t.device
        self.offsets = _window_offsets(cap)[ks]
        reads, homes = _window_neighbours((nx, ny, nz), cap)
        self._reads = torch.as_tensor(reads[ks], device=device)
        self._homes = torch.as_tensor(homes[ks], device=device)
        self._k = torch.arange(len(self.offsets), device=device)[:, None]
        self.pj = self.partners(pc_t) + offs[ks, None, None, None, :, None]
        cutoff_sq = torch.tensor(cutoff, dtype=pc_t.dtype, device=device) ** 2
        self.d_sq = sum(
            (pc_t[..., c, :, None] - self.pj[..., c, None, :]) ** 2 for c in range(3)
        )
        mj = self.partners(mf_g)
        ok = (self.d_sq > 0.0) & (self.d_sq < cutoff_sq) & (mj[..., None, :] > 0.5)
        # the self pair, excluded by identity on the self cell
        eye = torch.eye(cap, dtype=torch.bool, device=device)
        self_cell = torch.tensor([o == (0, 0, 0) for o in self.offsets], device=device)
        self.pair_ok = ok & ~(eye & self_cell.reshape(-1, 1, 1, 1, 1, 1))

    def _flat(self, t, lead: int):
        return t.reshape(*t.shape[:lead], -1, *t.shape[lead + 3:])

    def partners(self, t):
        """``t`` ``(x, y, z, ...)`` at each offset's neighbour cell:
        ``(k, x, y, z, ...)``."""
        return self._flat(t, 0)[self._reads].reshape(len(self.offsets), *t.shape)

    def home(self, t):
        """``t`` ``(k, x, y, z, ...)``, each offset's slice moved from the
        neighbour cell back to its home cell: the roll by ``+o``."""
        return self._flat(t, 1)[self._k, self._homes].reshape(t.shape)


# -- kernel C and its plain twin ----------------------------------------------


def _we_value_and_grad(
    potential, cutoff: float, pc_t, q_g, mf_g, offs, with_params=False, qi_g=None
):
    """Plain twin of kernel C: the window energy and its gradient in one pass.

    Per offset, with ``s_ij = q_i·q_j·V'(d_ij)/d_ij``:
    ``∂E/∂pc_i = Σ_j s_ij (pc_i − pj_j)`` and ``∂E/∂pj_j = Σ_i s_ij (pj_j −
    pc_i)``; the ``pj`` side rolls back onto its home cell, and its per-offset
    total is the ``offs`` gradient.  The self cell's j-side charges are
    ½-weighted so each unordered pair counts once.  For the pair terms of
    :func:`_window_terms` (kernel C's), float32 takes the fused pair math of
    :func:`_window_math` and float64 the analytic :func:`_table_pair_terms`;
    every other potential the exact route (:func:`_exact_pair_terms`).

    The image term ``d_image`` (3, 3), in float64, is the window's cell
    gradient at fixed positions: ``−Σ_pairs m_ij ⊗ g_ij`` with ``g_ij`` the
    pair's i-side gradient and ``m_ij`` the integer image of the pair, the
    periodic wrap of the rolled neighbour cell (``floor((h + o) / n)`` per
    axis).  It equals what ``d_pc`` and ``d_offs`` give through the cell
    centers and the offsets, without summing per-atom gradients times
    centers (:func:`_prepare_bucketed` with ``window=True``).

    :param with_params: also return the gradients with respect to the
        potential's trainable parameters (:func:`_trainable`): for kernel C's
        pair terms these are the weights of a ``CombinedPotential`` and their
        gradient each term's energy, summed in float64 as kernel C sums it.
    :param qi_g: separate i-side charges ``(nx, ny, nz, cap, C)`` (the
        x-slab sharded window zeroes them on its halo plane, so each
        unordered pair counts once, on the rank of its lower-x cell): the
        energy is ``Σ qi_i q_j V``, and the i- and j-side charge
        cotangents come apart, ``d_qi`` and ``d_q``.  The self row of
        ``d_offs`` is then 0 (its offset is the zero vector).
    :return: ``(e, (d_pc, d_q, d_offs, d_image))`` (``d_qi`` last with
        ``qi_g``), and ``d_params`` with ``with_params``; outside autograd
        (the caller's op or :class:`_WindowEnergy` carries the gradients).
    """
    params = _trainable(potential) if with_params else ()
    e, grads, member_e, d_params = _we_plain(
        potential, cutoff, pc_t, q_g, mf_g, offs, params, qi_g
    )
    if not with_params:
        return e, grads
    if _window_terms(potential) is not None:
        # the only trainable parameters of kernel C's potentials are the
        # weights of a CombinedPotential (its terms hold plain floats)
        d_params = [member_e] * len(params)
    return e, grads, tuple(g.to(device=p.device, dtype=p.dtype) for g, p in zip(d_params, params))


@torch.no_grad()
def _we_plain(potential, cutoff, pc_t, q_g, mf_g, offs, params, qi_g=None):
    """:func:`_we_value_and_grad`'s pass, the offsets stacked in as few
    passes as :func:`_offset_chunks` allows: ``(e, grads, member_e,
    d_params)``, ``member_e`` the float64 energies of a
    ``CombinedPotential``'s terms where they are kernel C's (zeros
    otherwise), ``d_params`` the exact route's gradients of ``params``;
    ``grads`` ends with ``d_qi`` where ``qi_g`` is given."""
    nx, ny, nz, _, cap = pc_t.shape
    n_terms = len(_window_terms(potential) or ())
    # the energy is a sum of terms far larger than their total: accumulate it
    # in float64, as kernel C does
    e = torch.zeros((), dtype=torch.float64, device=pc_t.device)
    member_e = torch.zeros(n_terms, dtype=torch.float64, device=pc_t.device)
    d_pc, d_q = torch.zeros_like(pc_t), torch.zeros_like(q_g)
    d_qi = None if qi_g is None else torch.zeros_like(qi_g)
    d_offs, d_image = [], torch.zeros((3, 3), dtype=torch.float64, device=pc_t.device)
    d_params = [torch.zeros_like(p, dtype=torch.float64) for p in params]
    for ks in _offset_chunks(nx * ny * nz, cap):
        part = _we_offsets(potential, cutoff, pc_t, q_g, mf_g, offs, params, ks, qi_g)
        e, member_e = e + part[0], member_e + part[1]
        d_pc, d_q, d_image = d_pc + part[2], d_q + part[3], d_image + part[5]
        d_offs.append(part[4])
        d_params = [a + g for a, g in zip(d_params, part[6])]
        if qi_g is not None:
            d_qi = d_qi + part[7]
    grads = (d_pc, d_q, torch.cat(d_offs), d_image)
    if qi_g is not None:
        # the self offset is the zero vector: its row carries no gradient
        # (with split charges its pairs no longer cancel there)
        grads[2][_window_offsets(cap).index((0, 0, 0))] = 0.0
        grads = (*grads, d_qi)
    return e.to(pc_t.dtype), grads, member_e, d_params


def _we_offsets(potential, cutoff, pc_t, q_g, mf_g, offs, params, ks: slice, qi_g=None):
    """The window offsets ``ks`` on one stacked axis: ``(e, member_e, d_pc,
    d_q, d_offs[ks], d_image, d_params)``, each summed over those offsets,
    and ``d_qi`` last where ``qi_g`` is given (then ``d_q`` is the j side
    only)."""
    dtype = pc_t.dtype
    terms = _window_terms(potential)
    pairs = _WindowPairs(pc_t, mf_g, offs, cutoff, ks)
    pj, d_sq_safe = pairs.pj, torch.where(pairs.pair_ok, pairs.d_sq, 1.0)
    # the self cell's j-side charges are halved: each unordered pair once
    w = torch.tensor([0.5 if o == (0, 0, 0) else 1.0 for o in pairs.offsets],
                     dtype=dtype, device=pc_t.device).reshape(-1, 1, 1, 1, 1, 1)
    qj = pairs.partners(q_g) * w
    qi = q_g if qi_g is None else qi_g
    okf = pairs.pair_ok.to(dtype)
    vq = okf * torch.matmul(qi, qj.transpose(-1, -2))
    members, d_params = None, []
    if dtype == torch.float32 and terms is not None:
        v_raw, w_raw, members = _window_math(potential, d_sq_safe)
        s = vq * w_raw
    elif terms is not None:
        d = torch.sqrt(d_sq_safe)
        v_raw, dd, members = _table_pair_terms(potential, terms, d, vq)
        s = dd / d
    else:
        d = torch.sqrt(d_sq_safe)
        v_raw, dd, d_params = _exact_pair_terms(potential, d, vq, params)
        s = dd / d
    e = torch.sum(vq * v_raw, dtype=torch.float64)
    member_e = torch.zeros(len(terms or ()), dtype=torch.float64, device=pc_t.device)
    if members is not None:
        member_e = torch.stack([torch.sum(vq * v_m, dtype=torch.float64) for v_m in members])
    v = okf * v_raw
    g_i = pc_t * s.sum(-1)[..., None, :] - torch.matmul(pj, s.transpose(-1, -2))
    d_pj = pj * s.sum(-2)[..., None, :] - torch.matmul(pc_t, s)  # (k, x, y, z, 3, cap)
    d_pc = g_i.sum(0) + pairs.home(d_pj).sum(0)
    d_qj = pairs.home(torch.matmul(v.transpose(-1, -2), qi)) * w
    d_image = -_image_term(g_i.sum(-1, dtype=torch.float64), pairs.offsets)
    d_offs = d_pj.sum(dim=(1, 2, 3, 5))
    if qi_g is not None:
        return (e, member_e, d_pc, d_qj.sum(0), d_offs, d_image, d_params,
                torch.matmul(v, qj).sum(0))
    d_q = torch.matmul(v, qj).sum(0) + d_qj.sum(0)
    return e, member_e, d_pc, d_q, d_offs, d_image, d_params


def _image_term(g_cells, offsets) -> torch.Tensor:
    """``Σ_o Σ_h m_o(h) ⊗ g_o,h`` in float64: ``g_cells`` ``(k, nx, ny, nz,
    3)`` holds each home cell's i-side gradient sum over offset ``o``'s
    pairs, and ``m_o(h) = floor((h + o) / n)`` per axis the integer image of
    its neighbour cell: 1 on the last plane for ``o = +1``, −1 on the first
    for ``o = −1``, 0 elsewhere."""
    o = torch.tensor(offsets, dtype=torch.float64, device=g_cells.device)
    rows = []
    for a in range(3):
        per_plane = g_cells.sum(dim=tuple(b + 1 for b in range(3) if b != a), dtype=torch.float64)
        rows.append((o[:, a] > 0).to(torch.float64) @ per_plane[:, -1]
                    - (o[:, a] < 0).to(torch.float64) @ per_plane[:, 0])
    return torch.stack(rows)


def _table(potential, terms) -> tuple:
    """The pair-term table of ``potential`` and its ``terms``
    (:func:`_window_terms`) as the ``tpme::window`` op takes it:
    ``(weights, kinds, exponents, smearings, prefactors, direct)`` — a
    ``CombinedPotential``'s weights (``None`` for one term), per term its
    class (0 ``CoulombPotential``, 1 ``InversePowerLawPotential``), ``p``,
    smearing (0 without) and prefactor, and whether the terms are
    unsmeared."""
    from ..potentials import CombinedPotential, CoulombPotential

    return (
        potential.weights if type(potential) is CombinedPotential else None,
        [0 if type(m) is CoulombPotential else 1 for m, _ in terms],
        [p for _, p in terms],
        [0.0 if m.smearing is None else float(m.smearing) for m, _ in terms],
        [float(m.prefactor) for m, _ in terms],
        potential.smearing is None,
    )


def window_table(potential):
    """The pair-term table of ``potential`` (:func:`_table`), or ``None``
    where kernel C cannot evaluate it (:func:`_window_terms`)."""
    terms = _window_terms(potential)
    return None if terms is None else _table(potential, terms)


@functools.lru_cache(maxsize=64)
def _table_members(kinds: tuple, exponents: tuple, smearings: tuple, prefactors: tuple,
                   direct: bool) -> tuple:
    """The terms of a :func:`window_table` as potentials, made once per table."""
    from ..potentials import CoulombPotential, InversePowerLawPotential

    members = []
    for kind, p, smearing, prefactor in zip(kinds, exponents, smearings, prefactors):
        smearing = None if direct else smearing
        members.append(
            CoulombPotential(smearing=smearing, prefactor=prefactor) if kind == 0
            else InversePowerLawPotential(exponent=p, smearing=smearing, prefactor=prefactor)
        )
    return tuple(members)


def _table_potential(table):
    """The potential a :func:`window_table` describes: its one term, or a
    frozen ``CombinedPotential`` of its terms with its weights."""
    from ..potentials import CombinedPotential

    weights, kinds, exponents, smearings, prefactors, direct = table
    members = _table_members(
        tuple(kinds), tuple(exponents), tuple(smearings), tuple(prefactors), bool(direct)
    )
    if weights is None:
        return members[0]
    return CombinedPotential(
        list(members), initial_weights=weights.detach(), learnable_weights=False,
        smearing=None if direct else smearings[0],
    )


def _window_group(cap: int, n_ch: int, device_index: int, split: bool = False) -> int:
    """Neighbour offsets that kernel C stages per pass at this capacity on
    the card: 27, 9, 3 or 1, the most that fit its shared memory, as the
    ``tpme::window`` op chooses them (``tpme::window_plan``).  Raises where
    even one offset a pass does not fit.  With separate i-side charges
    (``split``) a slot stages both charge sets, so it takes the shared memory
    of ``2·n_ch`` channels."""
    group, largest = _k.tpme_op("window_plan")(cap, n_ch, split, device_index)
    if group == 0:
        raise ValueError(
            f"the window kernel takes a cell capacity of at most {largest} at {n_ch} "
            f"channel(s){' with separate i-side charges' if split else ''}, got {cap}; "
            f"plain=True runs the plain version"
        )
    return group


def _check_window(potential, pc_t, q_g, mf_g, offs, qi_g=None):
    """Validate kernel C's operands, and that it evaluates ``potential``."""
    if _window_terms(potential) is None:
        raise TypeError(
            "the window kernel evaluates CoulombPotential and InversePowerLawPotential "
            "(p = 1..6) pair terms, and a CombinedPotential of up to "
            f"{_k.MAX_MEMBERS} of them, without an exclusion window; got "
            f"{type(potential).__name__}: plain=True runs the plain version"
        )
    _check_window_operands(pc_t, q_g, mf_g, offs, qi_g)


def _check_window_operands(pc_t, q_g, mf_g, offs, qi_g=None):
    if pc_t.ndim != 5 or pc_t.shape[3] != 3:
        raise ValueError(f"pc_t must be (nx, ny, nz, 3, cap), got {tuple(pc_t.shape)}")
    nx, ny, nz, _, cap = pc_t.shape
    n_ch = q_g.shape[-1]
    if n_ch > _k.MAX_CHANNELS:
        raise ValueError(f"the window kernel takes at most {_k.MAX_CHANNELS} channels")
    _k.check_cuda_tensor(pc_t, "pc_t", (nx, ny, nz, 3, cap))
    _k.check_cuda_tensor(q_g, "q_g", (nx, ny, nz, cap, n_ch))
    _k.check_cuda_tensor(mf_g, "mf_g", (nx, ny, nz, cap))
    _k.check_cuda_tensor(offs, "offs", (_k.N_OFFSETS, 3))
    if qi_g is not None:
        _k.check_cuda_tensor(qi_g, "qi_g", (nx, ny, nz, cap, n_ch))


@_k.plain_version("window")
def _window_plain(
    pc_t: Tensor, q_g: Tensor, mf_g: Tensor, offs: Tensor, cell: Tensor,
    weights: Optional[Tensor], kinds: Sequence[int], exponents: Sequence[int],
    smearings: Sequence[float], prefactors: Sequence[float], direct: bool, cutoff: float,
    qi_g: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Kernel C's plain version with the op's signature (the op's CPU
    kernel, :func:`_we_value_and_grad`'s pass): ``(e, d_pc, d_q, d_offs,
    d_image, d_qi, members)`` of the window for the pair-term table of
    :func:`window_table`; ``members`` are the terms' float64 energies (a
    ``CombinedPotential``'s dE/dw).  With separate i-side charges ``qi_g``
    the energy is ``Σ qi_i q_j V`` and ``d_qi`` their cotangent (``d_q`` is
    then the j side's), else ``d_qi`` is empty.  ``cell`` only takes the
    image term's cotangent."""
    del cell
    table = (weights, kinds, exponents, smearings, prefactors, direct)
    e, grads, members, _ = _we_plain(
        _table_potential(table), cutoff, pc_t, q_g, mf_g, offs, (), qi_g
    )
    d_qi = grads[4] if qi_g is not None else q_g.new_empty((0,))
    return e, *grads[:4], d_qi, members


@_k.register_fake("window")
def _(pc_t, q_g, mf_g, offs, cell, weights, kinds, exponents, smearings, prefactors, direct,
      cutoff, qi_g=None):
    wide = dict(dtype=torch.float64, device=pc_t.device)
    d_qi = torch.empty_like(q_g) if qi_g is not None else q_g.new_empty((0,))
    return (pc_t.new_empty(()), torch.empty_like(pc_t), torch.empty_like(q_g),
            torch.empty_like(offs), torch.empty((3, 3), **wide), d_qi,
            torch.empty((len(kinds),), **wide))


#: kernel C (``csrc/tpme_ops.cpp`` builds its parameters from the pair-term
#: table, each constant rounded to float32 from the expressions of
#: ``ops/math.py``, and launches it): the outputs of :func:`_window_plain`
window = _k.tpme_op("window")


def _window_setup(ctx, inputs, output):
    # the gradients ride as attributes of non-differentiable outputs:
    # torch.export refuses outputs saved with save_for_backward
    ctx.mark_non_differentiable(*output[1:])
    ctx.grads = output[1:]
    # only the energy takes a cotangent: no zeros are made for the others
    ctx.set_materialize_grads(False)
    cell, weights = inputs[4], inputs[5]
    ctx.n_inputs = len(inputs)
    # qi_g, the op's last input, when given
    ctx.split = len(inputs) > 12 and inputs[12] is not None
    ctx.cell_dtype = cell.dtype
    ctx.weights_like = None if weights is None else (weights.dtype, weights.device)


def _window_vjp(ctx, e_bar, *_):
    """The energy is a scalar: every cotangent is ``ē ×`` a gradient the
    forward already holds (the image term for the cell, the terms' energies
    for a ``CombinedPotential``'s weights)."""
    d_pc, d_q, _, d_image, d_qi, members = ctx.grads
    ct_w = None
    if ctx.weights_like is not None:
        dtype, device = ctx.weights_like
        ct_w = e_bar.to(device=device, dtype=dtype) * members.to(device=device, dtype=dtype)
    ct_cell = e_bar.to(ctx.cell_dtype) * d_image.to(ctx.cell_dtype)
    rest = (None,) * (ctx.n_inputs - 6)
    if ctx.split:
        rest = (*rest[:-1], e_bar * d_qi)
    return (e_bar * d_pc, e_bar * d_q, None, None, ct_cell, ct_w, *rest)


_k.register_autograd("window", _window_vjp, _window_setup)
_k.refuse_vmap("window", "tpme::window (kernel C)")
#: the window's energy with kernel C's VJP, or with ``plain`` its plain
#: version on any device: ``_Window.apply(*op_args, qi_g, plain)``
_Window = _k.op_function("_Window", "window", _window_setup, _window_vjp)


def window_value_and_grad(
    potential, cutoff: float, pc_t, q_g, mf_g, offs, with_params=False, qi_g=None
):
    """Kernel C: window energy and ``(d_pc, d_q, d_offs, d_image)`` in one
    launch (the image term as :func:`_we_value_and_grad` defines it),
    through ``torch.ops.tpme.window``; with separate i-side charges
    ``qi_g``, kernel C's split variant and ``d_qi`` last.

    On CPU tensors the op's body is the plain version (as is
    :func:`_we_value_and_grad` for a potential outside kernel C's table);
    CUDA tensors launch the kernel or raise.  It takes float32, at most ``kernels.MAX_CHANNELS``
    charge channels, a capacity whose one offset fits shared memory (~3000
    at one channel, ~1850 at four), and the pair terms of
    :func:`_window_terms`: ``CoulombPotential`` and
    ``InversePowerLawPotential`` (p = 1..6), smeared or direct, and a
    ``CombinedPotential`` of up to ``kernels.MAX_MEMBERS`` of them, without
    exclusion windows.  Anything else raises a ``TypeError``.

    :param with_params: also return the gradients with respect to the
        potential's trainable parameters: for a ``CombinedPotential`` the
        kernel sums each member's energy in float64, and those are ``dE/dw``.
        The kernel reads the weights on the card: keep the potential there
        (``calc.to``), or each launch copies them from the host.
    """
    table = window_table(potential)
    if pc_t.device.type != "cpu":
        # checked before the op: on a device other than the CPU and the card
        # (``meta``) the op would answer with its fake
        _check_window(potential, pc_t, q_g, mf_g, offs, qi_g)
    elif table is None:
        return _we_value_and_grad(
            potential, cutoff, pc_t, q_g, mf_g, offs, with_params, qi_g
        )
    # a cell of the operands' dtype: the op only routes the image term's
    # cotangent to it
    cell = offs.new_zeros((3, 3))
    with torch.no_grad():
        e, *grads, d_qi, members = window(
            pc_t, q_g, mf_g, offs, cell, *table, cutoff, qi_g=qi_g
        )
    if qi_g is not None:
        grads = [*grads, d_qi]
    if not with_params:
        return e, tuple(grads)
    # the only trainable parameters kernel C's potentials have are the
    # weights of a CombinedPotential (its members hold plain floats)
    return e, tuple(grads), tuple(
        members.to(device=w.device, dtype=w.dtype) for w in _trainable(potential)
    )


class _WindowEnergy(torch.autograd.Function):
    """Window energy of a potential outside kernel C's table (a spline, an
    exclusion window), by the plain version on any device: its forward
    already holds the whole gradient, so the backward only scales.  ``cell``
    takes the image term (its inputs come from :func:`_prepare_bucketed`
    with ``window=True``, whose centers and offsets carry no gradient).  The
    potential's trainable parameters ride as the trailing inputs, so their
    gradients flow back too."""

    @staticmethod
    def forward(ctx, pc_t, q_g, mf_g, offs, cell, qi_g, potential, cutoff, *params):
        e, grads, d_params = _we_value_and_grad(
            potential, cutoff, pc_t, q_g, mf_g, offs, with_params=True, qi_g=qi_g
        )
        d_pc, d_q, _, d_image, *d_qi = grads
        ctx.split = qi_g is not None
        ctx.save_for_backward(d_pc, d_q, d_image.to(cell.dtype), *d_qi, *d_params)
        return e

    @staticmethod
    def backward(ctx, e_bar):
        d_pc, d_q, d_image, *rest = ctx.saved_tensors
        ct_qi = e_bar * rest.pop(0) if ctx.split else None
        return (
            e_bar * d_pc, e_bar * d_q, None, None, e_bar.to(d_image.dtype) * d_image,
            ct_qi, None, None, *(e_bar.to(device=g.device, dtype=g.dtype) * g for g in rest),
        )


def _window_energy(potential, pc_t, q_g, mf_g, offs, cell, cutoff: float, plain: bool,
                   qi_g=None):
    """The window's energy, differentiable in ``pc_t``, ``q_g``, ``cell``
    (the image term), a ``CombinedPotential``'s weights and the separate
    i-side charges ``qi_g`` where given: kernel C's op for a potential of
    its table, else the plain version (CPU tensors or ``plain``; on a card
    without it the ``TypeError`` of :func:`window_value_and_grad`)."""
    table = window_table(potential)
    if table is not None:
        return _Window.apply(pc_t, q_g, mf_g, offs, cell, *table, cutoff, qi_g, plain)[0]
    if not plain and pc_t.device.type != "cpu":
        _check_window(potential, pc_t, q_g, mf_g, offs, qi_g)
    return _WindowEnergy.apply(
        pc_t, q_g, mf_g, offs, cell, qi_g, potential, cutoff, *_trainable(potential)
    )


# -- spill side list -------------------------------------------------------------

_D27 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _prepare_extras_bucketed(qe_raw, pe_raw, cell, clist: CellList, window: bool = False):
    """Spill atoms in the buckets' center-relative frame: ``(pe, pe_abs,
    qe, valid)`` (an extra must stay inside its recorded home cell).

    :param window: the frame of :func:`_prepare_bucketed` with ``window=True``
        (no gradient through the centers, one rounding from float64), for
        :func:`_extras_pairs` with ``window=True``.
    """
    dtype, device = pe_raw.dtype, pe_raw.device
    nx, ny, nz = clist.n_axis
    n_axis = torch.tensor([nx, ny, nz], dtype=dtype, device=device)
    mask = clist.extra_mask[:, None].to(dtype)
    qe = qe_raw * mask
    if window:
        wide = torch.promote_types(dtype, torch.float64)
        pe_abs_w = pe_raw.to(wide) - torch.matmul(clist.extra_wrap.to(wide), cell.to(wide))
        centers = torch.matmul((clist.extra_cell.to(wide) + 0.5) / n_axis.to(wide),
                               cell.detach().to(wide))
        pe = ((pe_abs_w - centers) * mask.to(wide)).to(dtype)
        pe_abs = pe_abs_w.to(dtype)
    else:
        pe_abs = pe_raw - torch.matmul(clist.extra_wrap.to(dtype), cell)
        centers = torch.matmul((clist.extra_cell.to(dtype) + 0.5) / n_axis, cell)
        pe = (pe_abs - centers) * mask  # park padded at 0
    with torch.no_grad():
        frac = torch.matmul(pe, inv3(cell.detach())) * n_axis
        bound = 0.5 + torch.tensor(clist.slack, dtype=dtype, device=device) + STALE_TOL
        valid = torch.all(torch.abs(frac) < bound[None, :])
    return pe, pe_abs, qe, valid


def _prepare_extras(charges, positions, cell, clist: CellList, window: bool = False):
    """:func:`_prepare_extras_bucketed` from atom-order charges and positions."""
    idx = clist.extra_index.long()
    return _prepare_extras_bucketed(
        charges.to(positions.dtype).index_select(0, idx), positions.index_select(0, idx),
        cell, clist, window=window,
    )


def _extras_pairs(pc_t, q_g, mf_g, pe, pe_abs, clist, cell, window: bool = False):
    """Pairs of the spill side list, in both directions: extra ↔ bucketed
    over the 27-cell window of each extra's home cell, extra ↔ extra as
    dense minimum-image pairs (``compute_cell_list`` spills only where every
    cell-plane distance is at least 2·cutoff).

    Returns ``(d2_em, ok_em, rows_q, ids, d2_ee, ok_ee)``: ``d²`` and the
    pair mask ``(E, 27·cap)`` against the bucket rows ``ids (E, 27)`` whose
    charges are ``rows_q (E, 27, cap, C)``, and ``d²`` and the pair mask
    ``(E, E)`` of the extras (self excluded, both directions present).

    :param window: the inputs are in the window frame (``window=True`` of
        :func:`_prepare_bucketed` and :func:`_prepare_extras_bucketed`): the
        cell reaches each pair vector only as its integer image ``m``,
        ``−m·cell`` (a zero whose gradient is the pair's image term), as in
        kernel C.
    """
    dtype, device = pc_t.dtype, pc_t.device
    nx, ny, nz, _, cap = pc_t.shape
    n_cells = nx * ny * nz
    n_axis = torch.tensor([nx, ny, nz], dtype=dtype, device=device)
    cut2 = torch.tensor(clist.cutoff, dtype=dtype, device=device) ** 2
    e_pad = pe.shape[0]
    w27 = 27 * cap

    d27 = torch.tensor(_D27, device=device)  # (27, 3)
    nb3 = torch.remainder(
        clist.extra_cell.long()[:, None, :] + d27[None],
        torch.tensor([nx, ny, nz], device=device),
    )
    ids = (nb3[..., 0] * ny + nb3[..., 1]) * nz + nb3[..., 2]  # (E, 27)
    flat = ids.reshape(-1)

    def rows(x):  # the window rows of every extra (index_select: see _prepare)
        return x.reshape(n_cells, *x.shape[3:]).index_select(0, flat)

    rows_p = rows(pc_t).reshape(e_pad, 27, 3, cap).transpose(1, 2).reshape(e_pad, 3, w27)
    rows_q = rows(q_g).reshape(e_pad, 27, cap, -1)  # (E, 27, cap, C)
    rows_m = rows(mf_g).reshape(e_pad, w27)
    if window:
        wide = torch.promote_types(dtype, torch.float64)
        frame = cell.detach().to(wide)
        offv = torch.matmul(d27.to(wide) / n_axis.to(wide), frame).to(dtype)
        # the image of each window cell: floor((home + d) / n) per axis
        image = torch.div(clist.extra_cell.long()[:, None, :] + d27[None],
                          torch.tensor([nx, ny, nz], device=device), rounding_mode="floor")
        lift = torch.matmul(image.to(dtype), cell - cell.detach())  # (E, 27, 3), zero
        off_em = offv.T[None] + lift.transpose(1, 2)  # (E, 3, 27)
    else:
        off_em = torch.matmul(d27.to(dtype) / n_axis, cell).T[None]  # (1, 3, 27)
    off_flat = off_em.repeat_interleave(cap, dim=2)  # (E or 1, 3, 27·cap)
    d2 = sum((pe[:, c, None] - rows_p[:, c, :] - off_flat[:, c, :]) ** 2 for c in range(3))
    ok_em = (d2 < cut2) & (rows_m > 0.5) & clist.extra_mask[:, None]

    if window:
        # minimum-image vectors in float64 from the extras' positions, the
        # cell entering as the image term only
        dp = pe_abs.to(wide)[:, None, :] - pe_abs.to(wide)[None, :, :]  # (E, E, 3)
        n_img = torch.round(torch.matmul(dp.detach(), inv3(frame)))
        r_ee = (dp - torch.matmul(n_img, frame)).to(dtype)
        r_ee = r_ee - torch.matmul(n_img.to(dtype), cell - cell.detach())
        d2e = (r_ee**2).sum(-1)
    else:
        f = torch.matmul(pe_abs, inv3(cell))  # (E, 3)
        g = []
        for c in range(3):
            df = f[:, c][:, None] - f[:, c][None, :]
            g.append(df - torch.round(df))
        d2e = sum(
            (g[0] * cell[0, d] + g[1] * cell[1, d] + g[2] * cell[2, d]) ** 2
            for d in range(3)
        )
    m_ee = clist.extra_mask[:, None] & clist.extra_mask[None, :]
    eye = torch.eye(e_pad, dtype=torch.bool, device=device)
    ok_ee = (d2e < cut2) & m_ee & ~eye
    return d2, ok_em, rows_q, ids, d2e, ok_ee


def _extras_potentials(potential, pc_t, q_g, mf_g, pe, pe_abs, clist, cell, window=False):
    """Pair terms of the spill side list (:func:`_extras_pairs`): ``(v_em,
    rows_q, ids, v_ee)``, the masked pair values ``v_em (E, 27, cap)`` and
    ``v_ee (E, E)`` in place of the masks and ``d²``."""
    d2, ok_em, rows_q, ids, d2e, ok_ee = _extras_pairs(
        pc_t, q_g, mf_g, pe, pe_abs, clist, cell, window
    )
    v_em = _masked_pair_values(potential, d2, ok_em).reshape(rows_q.shape[:3])
    return v_em, rows_q, ids, _masked_pair_values(potential, d2e, ok_ee)


def _extras_energy(potential, pc_t, q_g, mf_g, pe, pe_abs, qe, clist, cell, window=False):
    """Energy of the spill pairs, by plain autograd: each extra ↔ bucketed
    pair once, extra ↔ extra pairs in both directions (hence ½)."""
    v_em, rows_q, _, v_ee = _extras_potentials(
        potential, pc_t, q_g, mf_g, pe, pe_abs, clist, cell, window
    )
    e_em = torch.sum(v_em[..., None] * rows_q * qe[:, None, None, :])
    e_ee = 0.5 * torch.sum(v_ee * (qe @ qe.T))
    return e_em + e_ee


def cell_list_rspace_energy_rows(
    potential,
    charges: torch.Tensor,
    pos_rows: torch.Tensor,
    cell: torch.Tensor,
    clist: CellList,
    plain: bool = False,
) -> torch.Tensor:
    r"""Real-space energy :math:`\sum_{i<j} q_iq_jv(d_{ij})` from
    positions in bucket-row order (``(n_cells·cap [+ E_pad], 3)``, the
    :meth:`~torchpme_tpu_torch.md.MDFastPath.bucket` layout).

    Differentiable with respect to ``charges`` (atom order), ``pos_rows``
    and ``cell``.  NaN (value and gradients) when the bucketing is stale.

    :param plain: run the window's plain twin on any device (the reference
        path of the comparisons); by default CPU tensors take the twin and
        CUDA tensors kernel C.
    """
    _k.refuse_batched("the cell-list window (kernel C)", charges, pos_rows, cell)
    n_cells, cap = clist.slot_mask.shape
    nb = n_cells * cap
    dtype = pos_rows.dtype
    q = charges.to(dtype)
    pc_t, q_g, mf_g, offs, valid = _prepare_bucketed(
        q[clist.atom_index.long()], pos_rows[:nb].reshape(n_cells, cap, 3), cell, clist,
        window=True,
    )
    e0 = _window_energy(potential, pc_t, q_g, mf_g, offs, cell, clist.cutoff, plain)
    if clist.extra_index is not None:
        pe, pe_abs, qe, valid_e = _prepare_extras_bucketed(
            q[clist.extra_index.long()], pos_rows[nb:].reshape(-1, 3), cell, clist,
            window=True,
        )
        # the spill pairs take autograd, in the window's frame: the cell
        # reaches them as their images only
        e0 = e0 + _extras_energy(
            potential, pc_t, q_g, mf_g, pe, pe_abs, qe, clist, cell, window=True
        )
        valid = valid & valid_e
    # NaN-poison through a multiply so gradients are poisoned too
    return e0 * torch.where(valid, 1.0, float("nan")).to(e0.dtype)


def cell_list_rspace_energy(
    potential,
    charges: torch.Tensor,
    positions: torch.Tensor,
    cell: torch.Tensor,
    clist: CellList,
    plain: bool = False,
) -> torch.Tensor:
    r"""Real-space energy from atom-order ``positions``: one gather into
    bucket rows, then :func:`cell_list_rspace_energy_rows` (same value and
    gradients up to the row permutation)."""
    rows = positions.index_select(0, clist.atom_index.reshape(-1).long())
    if clist.extra_index is not None:
        rows = torch.cat([rows, positions.index_select(0, clist.extra_index.long())], dim=0)
    return cell_list_rspace_energy_rows(potential, charges, rows, cell, clist, plain=plain)


class _CallablePotential:
    """Adapter giving a plain ``v(d)`` callable the pair-term interface of
    a potential: with no smearing, its pair term is the whole potential,
    here the callable."""

    __slots__ = ("from_dist",)
    smearing = None

    def __init__(self, fn):
        self.from_dist = fn


def _window_potentials(potential, pc_t, q_g, mf_g, offs, cutoff: float) -> torch.Tensor:
    r"""Per-slot potentials :math:`\tfrac12\sum_j q_j v(d_{ij})` in bucket
    order, ``(n_cells, cap, C)``: per half-window offset the pair block
    against the neighbour cell, and its transpose brought back onto the
    neighbour's atoms (the self cell's block holds both directions)."""
    nx, ny, nz, _, cap = pc_t.shape
    pot_g = torch.zeros_like(q_g)
    for ks in _offset_chunks(nx * ny * nz, cap):
        pairs = _WindowPairs(pc_t, mf_g, offs, cutoff, ks)
        v = _masked_pair_values(potential, pairs.d_sq, pairs.pair_ok)
        # the mirrored half lands on the neighbour cell's atoms
        mirrored = torch.tensor([o != (0, 0, 0) for o in pairs.offsets], dtype=pc_t.dtype,
                                device=pc_t.device).reshape(-1, 1, 1, 1, 1, 1)
        tr = pairs.home(torch.matmul(v.transpose(-1, -2), q_g)) * mirrored
        pot_g = pot_g + (torch.matmul(v, pairs.partners(q_g)) + tr).sum(0)
    # each unordered pair was counted once per member: halve, as the
    # full-neighbor-list convention of Calculator._compute_rspace does
    return pot_g.reshape(nx * ny * nz, cap, -1) / 2


def cell_list_rspace_potentials(
    potential, charges: torch.Tensor, positions: torch.Tensor, cell: torch.Tensor,
    clist: CellList,
) -> torch.Tensor:
    r"""Per-atom real-space potentials :math:`\tfrac12\sum_j q_j v(d_{ij})`
    from a cell list, with no neighbor list.

    The same values as :meth:`~torchpme_tpu_torch.Calculator._compute_rspace`
    over a complete neighbor list at ``clist.cutoff`` (pairs with ``d <
    cutoff``), spill side list included.  Differentiable with respect to
    ``charges``, ``positions`` and ``cell``; NaN (values and gradients) once
    an atom has left its cell.  Plain PyTorch on every device (the JAX
    package's is XLA code).

    :param potential: a potential (the calculators' pair-term convention:
        the short-range part with smearing, the whole potential without) or
        any elementwise callable ``v(d)``.

    Example
    -------
    >>> import torch
    >>> from torchpme_tpu_torch import CoulombPotential
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=torch.float64)
    >>> charges = torch.tensor([[-1.0], [1.0]], dtype=torch.float64)
    >>> cell = torch.eye(3, dtype=torch.float64)
    >>> clist = compute_cell_list(positions, cell, cutoff=0.49)
    >>> pot = cell_list_rspace_potentials(
    ...     CoulombPotential(smearing=0.2), charges, positions, cell, clist)
    >>> print(tuple(pot.shape))
    (2, 1)
    """
    pot_obj = potential if hasattr(potential, "from_dist") else _CallablePotential(potential)
    n_atoms, n_channels = charges.shape
    dtype = positions.dtype
    pc_t, q_g, mf_g, offs, valid = _prepare(charges, positions, cell, clist)
    nx, ny, nz, _, cap = pc_t.shape
    n_cells = nx * ny * nz
    pot_b = _window_potentials(pot_obj, pc_t, q_g, mf_g, offs, clist.cutoff)
    mask_b = (mf_g.reshape(n_cells, cap) > 0.5)[..., None].to(dtype)
    idx = clist.atom_index.reshape(-1).long()
    out = torch.zeros((n_atoms, n_channels), dtype=dtype, device=positions.device)
    if clist.extra_index is not None:
        pe, pe_abs, qe, valid_e = _prepare_extras(charges, positions, cell, clist)
        valid = valid & valid_e
        v_em, rows_q, ids, v_ee = _extras_potentials(
            pot_obj, pc_t, q_g, mf_g, pe, pe_abs, clist, cell
        )
        # the extras' own potentials, over both pair classes
        v_at_e = 0.5 * (torch.sum(v_em[..., None] * rows_q, dim=(1, 2)) + v_ee @ qe)
        out = out.index_add(
            0, clist.extra_index.long(),
            v_at_e * clist.extra_mask[:, None].to(dtype),
        )
        # the bucketed side: ½ q_e v onto each window row's slots
        contrib = 0.5 * v_em[..., None] * qe[:, None, None, :]  # (E, 27, cap, C)
        buf = torch.zeros((n_cells, cap, n_channels), dtype=dtype, device=positions.device)
        pot_b = pot_b + buf.index_add(
            0, ids.reshape(-1), contrib.reshape(-1, cap, n_channels)
        )
    out = out.index_add(0, idx, (pot_b * mask_b).reshape(-1, n_channels))
    return out * torch.where(valid, 1.0, float("nan")).to(dtype)
