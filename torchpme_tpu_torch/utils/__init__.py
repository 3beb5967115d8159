"""Host-side helpers (counterpart of :mod:`torchpme_tpu.utils`)."""

from .neighbors import compute_distances, dense_neighbor_format, neighbor_list
from .validation import validate_parameters

__all__ = [
    "compute_distances",
    "dense_neighbor_format",
    "neighbor_list",
    "validate_parameters",
]
