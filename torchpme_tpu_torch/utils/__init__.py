"""Host-side helpers (counterpart of :mod:`torchpme_tpu.utils`)."""

from .neighbors import (
    compute_distances,
    compute_distances_dense,
    compute_distances_dense_symmetric,
    dense_neighbor_format,
    neighbor_list,
)
from .validation import validate_parameters

__all__ = [
    "compute_distances",
    "compute_distances_dense",
    "compute_distances_dense_symmetric",
    "dense_neighbor_format",
    "neighbor_list",
    "validate_parameters",
]
