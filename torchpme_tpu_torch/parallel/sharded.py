"""Per-atom Ewald and mesh potentials, SPMD over the ranks of a
``torch.distributed`` group.

Counterpart of :mod:`torchpme_tpu.parallel.sharded`.  The scale axes are
sharded as there:

* **real space** — neighbor pairs sharded over the ranks; each rank
  scatter-adds its own pairs into an ``(N, C)`` partial, summed over the
  ranks (:func:`~._collectives.psum`);
* **Ewald k space** — k-vectors sharded; each rank sums the structure
  factors of its k-block, and the per-atom energies are summed;
* **PME/P3M k space** — slab decomposition along the first mesh axis.
  Atoms are bucketed by x-slab on the host (:func:`compute_slab_bucketing`,
  refreshed like a neighbor list); each rank spreads its own atoms into its
  ``nx/D`` planes plus a ``halo``-plane skirt on each side, the skirts ride
  two ring hops (the periodic wrap included), and the reciprocal filter is a
  distributed FFT: z and y on the rank's slab, one all-to-all x↔y swap, x,
  the filter, and the same way back.  (The JAX package's per-axis DFT
  matmuls are a TPU choice; here each axis is ``torch.fft``.)  No
  collective carries the whole mesh: the one global reduction is the
  ``(N, C)`` potentials, O(atoms).

Every rank calls a function with the same (replicated) arguments and gets
the whole result; gradients flow through every collective
(:mod:`._collectives`).  No hand kernel is on this file's path: its scatter
and gather are plain PyTorch, as the JAX package's are XLA code.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kvectors import generate_kvectors_for_ewald
from ..ops.math import det3, inv3
from ..ops.mesh import _axis_offsets, compute_1d_weights
from ._collectives import Axis, all_to_all, axis_of, psum, reduce_flag, replicate, ring_hop

__all__ = [
    "SlabBucketing",
    "compute_slab_bucketing",
    "pad_to_multiple",
    "sharded_ewald_potentials",
    "sharded_mesh_potentials",
]


def pad_to_multiple(array, multiple: int, axis: int = 0, fill=0):
    """Right-pad ``array`` along ``axis`` to a multiple of ``multiple``.

    Example
    -------
    >>> import torch
    >>> pad_to_multiple(torch.ones((5, 2)), 4).shape
    torch.Size([8, 2])
    """
    array = torch.as_tensor(array)
    n = array.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return array
    shape = list(array.shape)
    shape[axis] = target - n
    pad = torch.full(shape, fill, dtype=array.dtype, device=array.device)
    return torch.cat([array, pad], dim=axis)


def _block(n: int, ax: Axis) -> slice:
    """This rank's block of ``n`` (a multiple of the ranks) rows."""
    size = n // ax.size
    return slice(ax.rank * size, (ax.rank + 1) * size)


def _trainable_tensors(module) -> list[str]:
    """Names of the tensor attributes of ``module`` that require grad (an
    ``nn.Parameter``, or a tensor scalar such as a trainable smearing)."""
    names = [n for n, p in getattr(module, "_parameters", {}).items()
             if p is not None and p.requires_grad]
    names += [n for n, v in vars(module).items()
              if isinstance(v, torch.Tensor) and v.requires_grad]
    return names


def _replicated_potential(potential, ax: Axis):
    """``potential`` whose trainable tensors went through
    :func:`~._collectives.replicate` (their cotangents from rank-local work
    are summed over the ranks, as the JAX package ``pcast``\\ s them), or
    ``potential`` itself when it has none.  Members of a
    ``CombinedPotential`` are replicated the same way."""
    names = _trainable_tensors(potential)
    members = getattr(potential, "potentials", None)
    new_members = None
    if members is not None:
        new_members = [_replicated_potential(m, ax) for m in members]
        if all(a is b for a, b in zip(new_members, members)):
            new_members = None
    if not names and new_members is None:
        return potential
    out = copy.copy(potential)
    if names:
        values = replicate(ax, *(getattr(potential, n) for n in names))
        for name, value in zip(names, values):
            # an instance attribute shadows the parameter of the copy only
            object.__setattr__(out, name, value)
    if new_members is not None:
        object.__setattr__(out, "potentials", new_members)
    return out


def _replicated_calc(calc, ax: Axis):
    """A shallow copy of ``calc`` over :func:`_replicated_potential`."""
    potential = _replicated_potential(calc.potential, ax)
    if potential is calc.potential:
        return calc
    out = copy.copy(calc)
    out._modules = dict(calc._modules)
    out._modules["potential"] = potential
    return out


def _rspace_partial(calc, charges, idx_local, dist_local, mask_local, ax: Axis):
    """Local-pair scatter partials, summed to the whole ``(N, C)``."""
    partial = calc._compute_rspace(charges, idx_local, dist_local, pair_mask=mask_local)
    return psum(partial, ax)


def _padded_pairs(neighbor_indices, neighbor_distances, pair_mask, n_dev: int):
    """Pairs padded to a multiple of the ranks (masked off, distance 1)."""
    n_pairs = neighbor_distances.shape[0]
    idx = pad_to_multiple(neighbor_indices, n_dev)
    if pair_mask is None:
        mask = torch.arange(idx.shape[0], device=idx.device) < n_pairs
    else:
        mask = pad_to_multiple(pair_mask, n_dev, fill=False)
    dist = pad_to_multiple(neighbor_distances, n_dev, fill=1.0)
    return idx, dist, mask


def _corrections(potential, energy, charges, cell):
    """``energy / V`` less the self and background terms (per atom), as
    ``PMECalculator._compute_kspace`` assembles them."""
    volume = torch.abs(det3(cell))
    energy = energy / volume - charges * potential.self_contribution()
    charge_tot = torch.sum(charges, dim=0)
    return energy - 2 * potential.background_correction() * charge_tot / volume


def sharded_ewald_potentials(
    calc,
    device_mesh,
    charges: torch.Tensor,
    cell: torch.Tensor,
    positions: torch.Tensor,
    neighbor_indices: torch.Tensor,
    neighbor_distances: torch.Tensor,
    ns_kvectors: tuple[int, int, int],
    pair_mask: torch.Tensor | None = None,
    axis: str = "atoms",
) -> torch.Tensor:
    """Ewald per-atom potentials, SPMD over the ranks of ``device_mesh``.

    Pairs and k-vectors are sharded (each rank takes its block of the padded
    arrays); positions, charges and the cell are replicated.  Every rank
    passes the same arguments and gets ``calc(...)``'s values.

    :param device_mesh: a ``DeviceMesh`` with one dimension named ``axis``,
        a process group, or ``None`` for the default group.
    """
    ax = axis_of(device_mesh, axis)
    n_dev = ax.size
    kvectors = pad_to_multiple(generate_kvectors_for_ewald(cell, ns_kvectors), n_dev)
    idx, dist, mask = _padded_pairs(neighbor_indices, neighbor_distances, pair_mask, n_dev)
    calc_v = _replicated_calc(calc, ax)
    q_v, pos_v, dist_v, kv_v = replicate(ax, charges, positions, dist, kvectors)
    pairs = _block(idx.shape[0], ax)
    pot = _rspace_partial(calc_v, q_v, idx[pairs], dist_v[pairs], mask[pairs], ax)

    # k-space partial over the local k-block
    kv = kv_v[_block(kv_v.shape[0], ax)]
    g_kernel = calc_v.potential.lr_from_k_sq(torch.sum(kv**2, dim=-1))
    trig_args = torch.matmul(kv, pos_v.T)
    trig = torch.stack([torch.cos(trig_args), torch.sin(trig_args)])
    weighted = torch.einsum("fki,ic,k->fkc", trig, q_v, g_kernel)
    energy = psum(torch.einsum("fkc,fki->ic", weighted, trig), ax)
    return pot + _corrections(calc.potential, energy, charges, cell) / 2


@dataclass(frozen=True)
class SlabBucketing:
    """Host-computed assignment of atoms to x-slabs of the density mesh.

    Refreshed like a neighbor list: the assignment stays valid while every
    atom's interpolation stencil fits inside its slab plus the ``halo``
    skirt; drift beyond that poisons the result with NaN.
    """

    atom_index: torch.Tensor  # (n_devices, capacity) int32 global atom ids
    slot_mask: torch.Tensor  # (n_devices, capacity) bool, False for padding
    ns: tuple[int, int, int]
    halo: int


def compute_slab_bucketing(
    positions,
    cell,
    ns_mesh,
    n_devices: int,
    interpolation_nodes: int,
    capacity: int | None = None,
    device=None,
) -> SlabBucketing:
    """Bucket atoms by mesh x-slab for :func:`sharded_mesh_potentials`
    (host-side, numpy; the same arrays as the JAX package's).

    :param device: device of the returned tensors (default: that of
        ``positions`` when it is a tensor, else
        :func:`torchpme_tpu_torch.default_device`).
    """
    device = resolve_device(device, positions)
    ns_mesh = tuple(int(n) for n in ns_mesh)
    nx = ns_mesh[0]
    if nx % n_devices:
        raise ValueError(
            f"mesh x-size {nx} must be divisible by the {n_devices}-device axis"
        )
    block = nx // n_devices
    # stencil half-width plus one plane of slack for host/device float
    # disagreement at slab boundaries
    halo = int(interpolation_nodes) // 2 + 2
    if halo > block:
        raise ValueError(
            f"slab of {block} planes is thinner than the {halo}-plane stencil "
            f"halo; use a finer mesh or fewer devices along this axis"
        )
    pos = np.asarray(_host(positions), dtype=np.float64)
    inv = np.linalg.inv(np.asarray(_host(cell), dtype=np.float64))
    frac_x = (pos @ inv)[:, 0]
    frac_x -= np.floor(frac_x)
    slab = np.minimum((frac_x * n_devices).astype(np.int64), n_devices - 1)

    counts = np.bincount(slab, minlength=n_devices)
    if capacity is None:
        capacity = max(8, int(-(-counts.max() // 8) * 8))
    elif counts.max() > capacity:
        raise ValueError(
            f"capacity {capacity} below the fullest slab ({counts.max()} atoms)"
        )
    order = np.argsort(slab, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank_in_slab = np.arange(pos.shape[0]) - starts[slab[order]]

    atom_index = np.zeros((n_devices, capacity), dtype=np.int32)
    slot_mask = np.zeros((n_devices, capacity), dtype=bool)
    atom_index[slab[order], rank_in_slab] = order
    slot_mask[slab[order], rank_in_slab] = True
    return SlabBucketing(
        torch.from_numpy(atom_index).to(device), torch.from_numpy(slot_mask).to(device),
        ns_mesh, halo,
    )


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _slab_stencil(pos_local, mask, inverse_cell, ns, nodes, method, rank, block, halo):
    """Stencil indices/weights of a slab's atoms on its extended local mesh.

    The math of :func:`~torchpme_tpu_torch.ops.mesh.compute_interpolation`,
    except that x is *not* wrapped: indices are rebased onto the rank's
    ``block + 2·halo`` plane window (the halo exchange realizes the periodic
    wrap).  Returns ``(linear_indices (nodes³, cap), weights, valid)``,
    ``valid`` False if a real atom's stencil escapes the window.
    """
    nx, ny, nz = ns
    ext = block + 2 * halo
    dtype, device = pos_local.dtype, pos_local.device
    frac = torch.matmul(pos_local, inverse_cell)
    frac = frac - torch.floor(frac)  # wrap into the cell (zero-gradient shift)
    rel = frac * torch.tensor(ns, dtype=dtype, device=device)
    base, offsets = _axis_offsets(rel, nodes)
    weights_1d = compute_1d_weights(offsets, nodes, method)  # (nodes, cap, 3)
    shifts = torch.arange(1 - (nodes + 1) // 2, 1 + nodes // 2, device=device)[:, None]

    # x: rebased onto the local window, no wrap (the halo exchange does it)
    local_x = base[None, :, 0] + shifts - rank * block + halo  # (nodes, cap)
    in_window = (local_x >= 0) & (local_x < ext)
    valid = torch.all(in_window | ~mask[None, :])
    # y, z: periodic wrap as usual
    iy_all = torch.remainder(base[None, :, 1] + shifts, ny)
    iz_all = torch.remainder(base[None, :, 2] + shifts, nz)
    lx_all = torch.clamp(local_x, 0, ext - 1)

    sa, sb, sc = (torch.as_tensor(g.ravel(), device=device) for g in np.meshgrid(
        np.arange(nodes), np.arange(nodes), np.arange(nodes), indexing="ij"
    ))
    linear = (lx_all[sa] * ny + iy_all[sb]) * nz + iz_all[sc]  # (nodes³, cap)
    combined = (
        weights_1d[sa, :, 0] * weights_1d[sb, :, 1] * weights_1d[sc, :, 2]
    ) * mask[None, :].to(dtype)
    return linear, combined, valid


def _fft_forward_sharded(interior, ax: Axis):
    """z and y transforms on the slab, the x↔y swap, the x transform:
    ``(C, nx/D, ny, nz)`` real → ``(C, nx, ny/D, nz//2 + 1)`` spectrum
    (unnormalized, as the calculators' ``backward`` norm)."""
    spec = torch.fft.rfft(interior, dim=-1, norm="backward")
    spec = torch.fft.fft(spec, dim=-2, norm="backward")
    spec = all_to_all(spec, 2, 1, ax)  # (C, nx/D, ny, kz) → (C, nx, ny/D, kz)
    return torch.fft.fft(spec, dim=1, norm="backward")


def _dft_filter_sharded(interior, kfilter_local, ax: Axis):
    """Distributed reciprocal filter: the forward transforms of
    :func:`_fft_forward_sharded`, the filter on the (x-whole, y-sharded)
    spectrum, and the inverse transforms back (unscaled, as
    ``apply_kspace_filter(..., ifft_norm="forward")``)."""
    nz = interior.shape[-1]
    spec = _fft_forward_sharded(interior, ax) * kfilter_local
    spec = torch.fft.ifft(spec, dim=1, norm="forward")
    spec = all_to_all(spec, 1, 2, ax)  # back to (C, nx/D, ny, kz)
    spec = torch.fft.ifft(spec, dim=-2, norm="forward")
    return torch.fft.irfft(spec, n=nz, dim=-1, norm="forward")


def _halo_fold(rho_ext, halo: int, ax: Axis):
    """Fold the halo skirts of ``(C, block + 2·halo, …)`` into the ring
    neighbours' interiors: ``(C, block, …)``."""
    ext = rho_ext.shape[1]
    block = ext - 2 * halo
    from_left = ring_hop(rho_ext[:, ext - halo :], 1, ax)
    from_right = ring_hop(rho_ext[:, :halo], -1, ax)
    interior = rho_ext[:, halo : halo + block]
    pad = interior.new_zeros((interior.shape[0], block - halo, *interior.shape[2:]))
    return (interior + torch.cat([from_left, pad], dim=1)
            + torch.cat([pad, from_right], dim=1))


def sharded_mesh_potentials(
    calc,
    device_mesh,
    charges: torch.Tensor,
    cell: torch.Tensor,
    positions: torch.Tensor,
    neighbor_indices: torch.Tensor,
    neighbor_distances: torch.Tensor,
    ns_mesh: tuple[int, int, int],
    pair_mask: torch.Tensor | None = None,
    axis: str = "atoms",
    slab_bucketing: SlabBucketing | None = None,
) -> torch.Tensor:
    """PME/P3M per-atom potentials, SPMD over the ranks of ``device_mesh``.

    Slab-decomposed along the first mesh axis (see the module docstring):
    each rank spreads only its own atoms into its ``nx/D`` planes plus halo
    skirts, the skirts ride ring hops, the filter is a distributed FFT with
    all-to-all swaps, and the gather back reads the rank's slab plus the
    neighbours' edge planes.  Every rank passes the same arguments and gets
    ``calc(...)``'s values.

    ``slab_bucketing`` is the atom→slab assignment of
    :func:`compute_slab_bucketing`; reuse it across steps like a neighbor
    list (computed here when omitted).  A stale bucketing poisons the result
    with NaN.  Requires ``nx`` and ``ny`` divisible by the number of ranks.
    """
    ax = axis_of(device_mesh, axis)
    n_dev = ax.size
    ns_mesh = tuple(int(n) for n in ns_mesh)
    nx, ny, nz = ns_mesh
    if nx % n_dev or ny % n_dev:
        raise ValueError(
            f"mesh sizes nx={nx}, ny={ny} must be divisible by the "
            f"{n_dev}-device '{axis}' axis for the slab-sharded pipeline"
        )
    block = nx // n_dev
    if slab_bucketing is None:
        slab_bucketing = compute_slab_bucketing(
            positions, cell, ns_mesh, n_dev, calc.interpolation_nodes
        )
    if slab_bucketing.ns != ns_mesh:
        raise ValueError(
            f"slab_bucketing was built for mesh {slab_bucketing.ns}, got {ns_mesh}"
        )
    halo = slab_bucketing.halo
    n_atoms, n_channels = charges.shape
    idx, dist, mask = _padded_pairs(neighbor_indices, neighbor_distances, pair_mask, n_dev)

    calc_v = _replicated_calc(calc, ax)
    q_v, cell_v, pos_v, dist_v = replicate(ax, charges, cell, positions, dist)
    pairs = _block(idx.shape[0], ax)
    pot_r = _rspace_partial(calc_v, q_v, idx[pairs], dist_v[pairs], mask[pairs], ax)

    # this rank's slab of atoms, gathered from the replicated inputs
    idx_map = slab_bucketing.atom_index[ax.rank].long()
    slot = slab_bucketing.slot_mask[ax.rank]
    pos_shard = pos_v.index_select(0, idx_map)
    q_shard = q_v.index_select(0, idx_map) * slot[:, None].to(q_v.dtype)
    linear, weights, valid = _slab_stencil(
        pos_shard, slot, inv3(cell_v), ns_mesh, calc.interpolation_nodes, calc._method,
        ax.rank, block, halo,
    )
    # a stale bucketing on ANY rank corrupts halos globally
    flag = reduce_flag(valid, ax)

    # spread into the extended local slab: (C, block + 2·halo, ny, nz)
    ext = block + 2 * halo
    values = (q_shard.T[:, None, :] * weights[None]).reshape(n_channels, -1)
    rho_ext = values.new_zeros((n_channels, ext * ny * nz)).index_add(
        1, linear.reshape(-1), values
    )
    interior = _halo_fold(rho_ext.reshape(n_channels, ext, ny, nz), halo, ax)

    kfilter = calc_v._kspace_filter(cell_v, ns_mesh)  # (nx, ny, kz)
    kf_local = kfilter[:, _block(ny, ax)]
    pot_interior = _dft_filter_sharded(interior, kf_local, ax)

    # the gather needs the neighbours' edge planes: fetch the halo skirts
    halo_left = ring_hop(pot_interior[:, block - halo :], 1, ax)
    halo_right = ring_hop(pot_interior[:, :halo], -1, ax)
    pot_ext = torch.cat([halo_left, pot_interior, halo_right], dim=1)
    gathered = pot_ext.reshape(n_channels, -1)[:, linear]  # (C, nodes³, cap)
    energies = torch.sum(gathered * weights[None], dim=1).T  # (cap, C)
    energies = energies * flag.to(energies.dtype)

    # back to atom order: an O(atoms) scatter and sum, not O(mesh)
    mesh_pot = energies.new_zeros((n_atoms, n_channels)).index_add(
        0, idx_map, energies * slot[:, None].to(energies.dtype)
    )
    mesh_pot = psum(mesh_pot, ax)
    return pot_r + _corrections(calc.potential, mesh_pot, charges, cell) / 2
