"""Input validation shared by every calculator ``forward``.

Counterpart of :mod:`torchpme_tpu.utils.validation`, with the same
messages.  All checks are on static information (shapes, dtypes, devices);
value-dependent checks are deliberately absent, so no check waits for the
device.
"""

from __future__ import annotations

import torch
from torch import Tensor as Array

__all__ = ["validate_parameters"]


def validate_parameters(
    charges: Array,
    cell: Array,
    positions: Array,
    neighbor_indices: Array,
    neighbor_distances: Array,
    periodic: Array | None = None,
    pair_mask: Array | None = None,
    node_mask: Array | None = None,
    kvectors: Array | None = None,
) -> None:
    dtype = positions.dtype
    device = positions.device
    for name, value in (
        ("cell", cell),
        ("charges", charges),
        ("neighbor_indices", neighbor_indices),
        ("neighbor_distances", neighbor_distances),
        ("pair_mask", pair_mask),
        ("node_mask", node_mask),
        ("kvectors", kvectors),
    ):
        if isinstance(value, torch.Tensor) and value.device != device:
            raise ValueError(
                f"device of `{name}` ({value.device}) must be same as that of "
                f"the `positions` class ({device})"
            )

    num_atoms = positions.shape[-2]
    if list(positions.shape) != [num_atoms, 3]:
        raise ValueError(
            "`positions` must be a tensor with shape [n_atoms, 3], got tensor "
            f"with shape {list(positions.shape)}"
        )

    if list(cell.shape) != [3, 3]:
        raise ValueError(
            "`cell` must be a tensor with shape [3, 3], got tensor with shape "
            f"{list(cell.shape)}"
        )
    if cell.dtype != dtype:
        raise TypeError(
            f"type of `cell` ({cell.dtype}) must be same as that of the "
            f"`positions` class ({dtype})"
        )

    if charges.ndim != 2:
        raise ValueError(
            "`charges` must be a 2-dimensional tensor, got "
            f"tensor with {charges.ndim} dimension(s) and shape "
            f"{list(charges.shape)}"
        )
    if charges.shape[0] != num_atoms:
        raise ValueError(
            "`charges` must be a tensor with shape [n_atoms, n_channels], with "
            "`n_atoms` being the same as the variable `positions`. Got tensor "
            f"with shape {list(charges.shape)} where positions contains "
            f"{num_atoms} atoms"
        )
    if charges.dtype != dtype:
        raise TypeError(
            f"type of `charges` ({charges.dtype}) must be same as that of the "
            f"`positions` class ({dtype})"
        )

    if neighbor_indices is None and neighbor_distances is None:
        pass  # cell-list mode: the real-space sum needs no neighbor list
    elif neighbor_indices is None or neighbor_distances is None:
        raise ValueError(
            "Provide `neighbor_indices` and `neighbor_distances` together "
            "(or neither, with a `cell_list`); got only one of them"
        )
    else:
        if neighbor_distances.ndim == 2:
            # dense per-atom layout: indices/distances both (n_atoms, capacity)
            if neighbor_indices.shape != neighbor_distances.shape or (
                neighbor_indices.shape[0] != num_atoms
            ):
                raise ValueError(
                    "dense neighbor layout requires `neighbor_indices` and "
                    "`neighbor_distances` of identical shape [n_atoms, capacity], "
                    f"got {list(neighbor_indices.shape)} and "
                    f"{list(neighbor_distances.shape)} for {num_atoms} atoms"
                )
        elif neighbor_indices.ndim != 2 or neighbor_indices.shape[1] != 2:
            raise ValueError(
                "neighbor_indices is expected to have shape [num_neighbors, 2]"
                f", but got {list(neighbor_indices.shape)} for one structure"
            )
        elif neighbor_distances.shape != neighbor_indices[:, 0].shape:
            raise ValueError(
                "`neighbor_indices` and `neighbor_distances` need to have shapes "
                "[num_neighbors, 2] and [num_neighbors], but got "
                f"{list(neighbor_indices.shape)} and {list(neighbor_distances.shape)}"
            )
        if neighbor_distances.dtype != dtype:
            raise TypeError(
                f"type of `neighbor_distances` ({neighbor_distances.dtype}) must be "
                f"same as that of the `positions` class ({dtype})"
            )

    if periodic is not None and tuple(periodic.shape) != (3,):
        raise ValueError(
            "`periodic` must be a tensor of shape (3,), got "
            f"tensor with shape {list(periodic.shape)}"
        )

    if pair_mask is not None and neighbor_distances is not None:
        if pair_mask.shape != neighbor_distances.shape:
            raise ValueError(
                "`pair_mask` must have the same shape as `neighbor_distances`, "
                f"got tensor with shape {list(pair_mask.shape)} vs "
                f"{list(neighbor_distances.shape)}"
            )
        if pair_mask.dtype != torch.bool:
            raise TypeError(f"type of `pair_mask` ({pair_mask.dtype}) must be bool")

    if node_mask is not None:
        if tuple(node_mask.shape) != (num_atoms,):
            raise ValueError(
                "`node_mask` must have shape [n_atoms], got tensor with shape "
                f"{list(node_mask.shape)} where n_atoms is {num_atoms}"
            )
        if node_mask.dtype != torch.bool:
            raise TypeError(f"type of `node_mask` ({node_mask.dtype}) must be bool")

    if kvectors is not None:
        if kvectors.ndim != 2 or kvectors.shape[1] != 3:
            raise ValueError(
                "`kvectors` must be a tensor of shape [n_kvecs, 3], got "
                f"tensor with shape {list(kvectors.shape)}"
            )
        if kvectors.dtype != dtype:
            raise TypeError(
                f"type of `kvectors` ({kvectors.dtype}) must be same as that of "
                f"the `positions` class ({dtype})"
            )
