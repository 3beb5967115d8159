"""Neighbor-list construction (host-side) and differentiable distances.

Counterpart of :mod:`torchpme_tpu.utils.neighbors`.  The calculators take
precomputed ``(i, j)`` indices and distances; this module is a convenience
for tests, benchmarks and users without an external neighbor-list engine.
:func:`neighbor_list` runs on the host in numpy / scipy and returns numpy
arrays:

* a periodic cKDTree query for orthorhombic cells (O(N log N); used at 100k
  atoms), and
* an image-replication brute force for arbitrary triclinic cells and
  non-periodic systems (small systems / tests).

:func:`compute_distances` recomputes the distances from tensors, so that
gradients reach the positions and the cell; :func:`compute_distances_dense`
and :func:`compute_distances_dense_symmetric` do the same for the dense
per-atom layout of :func:`dense_neighbor_format`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "compute_distances",
    "compute_distances_dense",
    "compute_distances_dense_symmetric",
    "dense_neighbor_format",
    "neighbor_list",
]

def _to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _half_list_filter(i: np.ndarray, j: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """Keep exactly one of each mirrored pair (i,j,S) / (j,i,-S)."""
    # lexicographic sign of the shift vector
    first_nonzero = np.where(
        shifts[:, 0] != 0,
        np.sign(shifts[:, 0]),
        np.where(shifts[:, 1] != 0, np.sign(shifts[:, 1]), np.sign(shifts[:, 2])),
    )
    zero_shift = first_nonzero == 0
    return (zero_shift & (i < j)) | (first_nonzero > 0)


def _brute_force(
    positions: np.ndarray,
    cell: np.ndarray | None,
    cutoff: float,
    periodic: bool,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = positions.shape[0]
    wrap = None
    if cell is None or not periodic:
        shift_list = [np.zeros(3, dtype=np.int64)]
        cell_mat = np.zeros((3, 3))
    else:
        cell_mat = np.asarray(cell, dtype=np.float64)
        inv = np.linalg.inv(cell_mat)
        # wrap positions into the cell first: the ±n_img image window below
        # assumes in-cell coordinates (shifts are corrected on output)
        wrap = np.floor(positions @ inv)
        positions = positions - wrap @ cell_mat
        # number of periodic images needed per axis: cutoff / plane spacing
        plane_dist = 1.0 / np.linalg.norm(inv, axis=0)
        n_img = np.ceil(cutoff / plane_dist).astype(int)
        ranges = [np.arange(-k, k + 1) for k in n_img]
        shift_list = [
            np.array(s)
            for s in np.stack(
                np.meshgrid(*ranges, indexing="ij"), axis=-1
            ).reshape(-1, 3)
        ]

    all_i, all_j, all_d, all_s = [], [], [], []
    for shift in shift_list:
        disp = positions[None, :, :] + shift @ cell_mat - positions[:, None, :]
        dist = np.linalg.norm(disp, axis=-1)
        mask = dist < cutoff
        if (shift == 0).all():
            np.fill_diagonal(mask, False)
        ii, jj = np.nonzero(mask)
        all_i.append(ii)
        all_j.append(jj)
        all_d.append(dist[ii, jj])
        all_s.append(np.broadcast_to(shift, (ii.shape[0], 3)))
    i = np.concatenate(all_i)
    j = np.concatenate(all_j)
    d = np.concatenate(all_d)
    s = np.concatenate(all_s)
    if wrap is not None:
        # shifts refer to the *input* positions: undo the internal wrap
        s = s - wrap[j].astype(np.int64) + wrap[i].astype(np.int64)
    return i, j, d, s


def _kdtree_orthorhombic(
    positions: np.ndarray, box_lengths: np.ndarray, cutoff: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    from scipy.spatial import cKDTree

    wrapped = np.mod(positions, box_lengths)
    # cKDTree with boxsize requires points strictly inside the box
    wrapped = np.where(wrapped >= box_lengths, 0.0, wrapped)
    tree = cKDTree(wrapped, boxsize=box_lengths)
    pairs = tree.query_pairs(cutoff, output_type="ndarray")  # half list, i < j
    i, j = pairs[:, 0], pairs[:, 1]
    raw = wrapped[j] - wrapped[i]
    # minimum-image shift for the wrapped coordinates...
    img_shift = -np.round(raw / box_lengths)
    disp = raw + img_shift * box_lengths
    # ... then add back the wrap offsets so shifts refer to the *input* positions
    wrap_shift = (wrapped - positions) / box_lengths
    shift = img_shift + np.round(wrap_shift[j] - wrap_shift[i])
    d = np.linalg.norm(disp, axis=-1)
    keep = d < cutoff
    return i[keep], j[keep], d[keep], shift[keep].astype(np.int64)


def neighbor_list(
    positions,
    cell=None,
    cutoff: float | None = None,
    full_list: bool = False,
    periodic: bool = True,
):
    """Compute a neighbor list on the host.

    :param positions: ``(N, 3)`` coordinates (any array-like or tensor).
    :param cell: ``(3, 3)`` cell matrix or ``None`` for open boundaries.
    :param cutoff: pair cutoff; defaults to half the smallest cell dimension.
    :param full_list: each pair twice (True) or once (False).
    :param periodic: apply periodic boundary conditions.
    :return: ``(indices (P, 2) int, distances (P,), shifts (P, 3) int)`` as
        numpy arrays; distance of pair ``p`` is
        ``|pos[j] - pos[i] + shifts[p] @ cell|``.

    Example
    -------
    The CsCl dimer has 8 nearest images at √3/2:

    >>> import numpy as np
    >>> positions = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    >>> idx, dist, shifts = neighbor_list(positions, np.eye(3), cutoff=0.9)
    >>> print(idx.shape[0], f"{dist.min():.4f}")
    8 0.8660
    """
    positions = np.asarray(_to_numpy(positions), dtype=np.float64)
    cell_np = None if cell is None else np.asarray(_to_numpy(cell), dtype=np.float64)
    if cutoff is None:
        if cell_np is None:
            raise ValueError("`cutoff` is required for non-periodic systems")
        cutoff = float(np.min(np.linalg.norm(cell_np, axis=1)) / 2 - 1e-6)

    use_kdtree = (
        periodic
        and cell_np is not None
        and np.allclose(cell_np, np.diag(np.diag(cell_np)))
        and np.all(np.diag(cell_np) > 2 * cutoff)
        and positions.shape[0] > 512
    )
    if use_kdtree:
        i, j, d, s = _kdtree_orthorhombic(positions, np.diag(cell_np), cutoff)
        if full_list:
            i, j, d, s = (
                np.concatenate([i, j]),
                np.concatenate([j, i]),
                np.concatenate([d, d]),
                np.concatenate([s, -s]),
            )
        indices = np.stack([i, j], axis=1)
        return indices, d, s

    i, j, d, s = _brute_force(positions, cell_np, cutoff, periodic)
    if not full_list:
        keep = _half_list_filter(i, j, s)
        i, j, d, s = i[keep], j[keep], d[keep], s[keep]
    indices = np.stack([i, j], axis=1)
    return indices, d, s.astype(np.int64)


def compute_distances(
    positions: torch.Tensor,
    neighbor_indices: torch.Tensor,
    cell: torch.Tensor | None = None,
    neighbor_shifts: torch.Tensor | None = None,
    norm: bool = True,
) -> torch.Tensor:
    """Differentiable pair distances from positions + integer cell shifts.

    This is the pattern users need for force correctness: recompute the
    distances inside the differentiated function so gradients flow to
    ``positions`` and ``cell``.
    """
    atom_is = neighbor_indices[:, 0].long()
    atom_js = neighbor_indices[:, 1].long()
    # index_select, not positions[...]: its backward is one atomic index_add
    # instead of a sort of all pairs
    vectors = positions.index_select(0, atom_js) - positions.index_select(0, atom_is)
    if cell is not None and neighbor_shifts is not None:
        vectors = vectors + torch.matmul(neighbor_shifts.to(cell.dtype), cell)
    elif cell is not None:
        raise ValueError("Provided `cell` but no `neighbor_shifts`.")
    elif neighbor_shifts is not None:
        raise ValueError("Provided `neighbor_shifts` but no `cell`.")
    if norm:
        return torch.linalg.norm(vectors, dim=1)
    return vectors


def dense_neighbor_format(
    neighbor_indices,
    neighbor_distances,
    n_atoms: int,
    neighbor_shifts=None,
    full_list: bool = False,
    capacity: int | None = None,
):
    """Convert a pair list into the dense per-atom format (host-side,
    numpy): the ``(n_atoms, capacity)`` layout replaces the pair-indexed
    scatter of the real-space sum with a gather plus a dense reduction.  The
    output, made into tensors, feeds :meth:`Calculator.forward` directly
    (the calculators dispatch on the distances' ndim).

    :param neighbor_indices: ``(n_pairs, 2)`` pair list.
    :param neighbor_distances: ``(n_pairs,)`` distances.
    :param n_atoms: number of atoms.
    :param neighbor_shifts: optional ``(n_pairs, 3)`` integer cell shifts.
    :param full_list: whether the input lists each pair twice.
    :param capacity: neighbors per atom (defaults to the exact maximum,
        rounded up to a multiple of 8).
    :return: dict with ``indices (N, C)``, ``distances (N, C)``,
        ``mask (N, C)`` and, when shifts are given, ``shifts (N, C, 3)``.
    """
    idx = np.asarray(_to_numpy(neighbor_indices))
    d = np.asarray(_to_numpy(neighbor_distances))
    i, j = idx[:, 0], idx[:, 1]
    s = None if neighbor_shifts is None else np.asarray(_to_numpy(neighbor_shifts))
    if not full_list:
        i, j = np.concatenate([i, j]), np.concatenate([j, i])
        d = np.concatenate([d, d])
        if s is not None:
            s = np.concatenate([s, -s])

    order = np.argsort(i, kind="stable")
    i, j, d = i[order], j[order], d[order]
    if s is not None:
        s = s[order]
    counts = np.bincount(i, minlength=n_atoms)
    if capacity is None:
        capacity = max(8, int(-(-counts.max() // 8) * 8))
    elif counts.max() > capacity:
        raise ValueError(
            f"capacity {capacity} below the densest atom ({counts.max()} neighbors)"
        )
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(i.shape[0]) - starts[i]

    nbr = np.zeros((n_atoms, capacity), dtype=np.int32)
    dist = np.ones((n_atoms, capacity), dtype=d.dtype)
    mask = np.zeros((n_atoms, capacity), dtype=bool)
    nbr[i, rank] = j
    dist[i, rank] = d
    mask[i, rank] = True
    out = {"indices": nbr, "distances": dist, "mask": mask}
    if s is not None:
        shifts = np.zeros((n_atoms, capacity, 3), dtype=s.dtype)
        shifts[i, rank] = s
        out["shifts"] = shifts
    return out


def _dense_vectors(positions, neighbor_indices, cell, neighbor_shifts) -> torch.Tensor:
    """``(N, C, 3)`` pair vectors of the dense layout."""
    n_atoms, capacity = neighbor_indices.shape
    vectors = positions.index_select(0, neighbor_indices.reshape(-1).long()).reshape(
        n_atoms, capacity, 3
    ) - positions[:, None, :]
    if cell is not None:
        vectors = vectors + torch.matmul(neighbor_shifts.to(cell.dtype), cell)
    return vectors


def _safe_norm(vectors: torch.Tensor) -> torch.Tensor:
    """Lengths of ``vectors``, 1 where a vector is zero: padded slots may point
    at the atom itself, and the double ``where`` keeps the square root's
    infinite slope at zero out of the backward pass."""
    sq = torch.sum(vectors**2, dim=-1)
    zero = sq == 0.0
    return torch.where(zero, 1.0, torch.sqrt(torch.where(zero, 1.0, sq)))


class _SymmetricDenseDistances(torch.autograd.Function):
    """Dense distances whose position cotangent is the dense half of the
    gather's, doubled (see :func:`compute_distances_dense_symmetric`)."""

    @staticmethod
    def forward(ctx, positions, cell, neighbor_indices, neighbor_shifts):
        vectors = _dense_vectors(positions, neighbor_indices, cell, neighbor_shifts)
        distances = _safe_norm(vectors)
        ctx.save_for_backward(vectors, distances, neighbor_shifts)
        ctx.with_cell = cell is not None
        return distances

    @staticmethod
    def backward(ctx, g):
        vectors, distances, shifts = ctx.saved_tensors
        r_hat = vectors / distances[..., None]
        # mirrored-pair identity: scatter half == dense half, hence the 2
        grad_positions = -2.0 * torch.sum(g[..., None] * r_hat, dim=1)
        grad_cell = None
        if ctx.with_cell:
            # exact: each dense row counts its own pair once
            grad_cell = torch.einsum("nc,nci,ncj->ij", g, shifts.to(r_hat.dtype), r_hat)
        return grad_positions, grad_cell, None, None


def compute_distances_dense_symmetric(
    positions, neighbor_indices, cell=None, neighbor_shifts=None
):
    r"""Dense-format distances with a backward pass free of scatters.

    The forward equals :func:`compute_distances_dense`; the position
    cotangent uses the mirrored-pair identity of a *symmetric* dense neighbor
    list (every pair ``(i, j, S)`` also appears as ``(j, i, -S)``, as
    :func:`dense_neighbor_format` produces): the scatter half of the gather's
    backward equals the dense half, so

    .. math:: \partial E/\partial p_i = -2 \sum_s g_{is}\,\hat r_{is}

    with :math:`g` the distance cotangent: a dense reduction instead of an
    ``index_add`` over all slots.

    **Correctness requires** (a) a symmetric dense list and (b) a
    pair-symmetric cotangent, true for any pair energy
    :math:`\sum m_{is} f(d_{is})\,q_i q_{j_s}` such as the calculators'
    real-space sums, where masked slots carry zero cotangent.  Otherwise use
    :func:`compute_distances_dense`.  The cell cotangent (stress) is exact.

    Example
    -------
    >>> import torch
    >>> f64 = torch.float64
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], dtype=f64,
    ...                          requires_grad=True)
    >>> dense = dense_neighbor_format(torch.tensor([[0, 1]]), torch.tensor([1.0], dtype=f64), 2)
    >>> d = compute_distances_dense_symmetric(positions, torch.as_tensor(dense["indices"]))
    >>> mask = torch.as_tensor(dense["mask"])
    >>> energy = torch.sum(torch.where(mask, d**2, 0.0)) / 2  # (1/2) sum over both rows
    >>> torch.autograd.grad(energy, positions)[0][:, 0].tolist()
    [-2.0, 2.0]
    """
    if (cell is None) != (neighbor_shifts is None):
        raise ValueError(
            "Provide `cell` and `neighbor_shifts` together (or neither)."
        )
    return _SymmetricDenseDistances.apply(positions, cell, neighbor_indices, neighbor_shifts)


def compute_distances_dense(positions, neighbor_indices, cell=None, neighbor_shifts=None):
    """Differentiable distances for the dense ``(N, C)`` neighbor format
    (1 in the slots whose vector is zero)."""
    if cell is not None and neighbor_shifts is None:
        raise ValueError("Provided `cell` but no `neighbor_shifts`.")
    if neighbor_shifts is not None and cell is None:
        raise ValueError("Provided `neighbor_shifts` but no `cell`.")
    return _safe_norm(_dense_vectors(positions, neighbor_indices, cell, neighbor_shifts))
