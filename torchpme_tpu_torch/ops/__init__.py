"""Tensor operations of the port (counterpart of :mod:`torchpme_tpu.ops`)."""

from .kspace import apply_kspace_filter, compute_kspace_filter, kspace_filter_quadratic
from .kvectors import (
    generate_kvectors_for_ewald,
    generate_kvectors_for_mesh,
    get_ns_ewald,
    get_ns_mesh,
)
from .math import det3, inv3
from .mesh import (
    MeshInterpolationWeights,
    compute_1d_weight_derivatives,
    compute_1d_weights,
    compute_dipole_interpolation,
    compute_interpolation,
    dipoles_to_mesh,
    mesh_to_dipole_field,
    mesh_to_points,
    points_to_mesh,
)
from .mesh_tiled import (
    TILE,
    TiledInterpolation,
    compute_tiled_interpolation,
    refresh_tiled_interpolation,
    supports_tiling,
    tiled_dipoles_to_mesh,
    tiled_mesh_to_dipole_field,
    tiled_mesh_to_points,
    tiled_points_to_mesh,
)
from .rspace_cells import (
    CellList,
    cell_list_rspace_energy,
    cell_list_rspace_energy_rows,
    compute_cell_list,
)
from .rspace_cells_dipole import (
    cell_list_rspace_dipole_energy,
    cell_list_rspace_dipole_energy_rows,
)
from .spread_fused import aligned_geometry, aligned_tiled_density

__all__ = [
    "CellList",
    "MeshInterpolationWeights",
    "TILE",
    "TiledInterpolation",
    "aligned_geometry",
    "aligned_tiled_density",
    "apply_kspace_filter",
    "cell_list_rspace_dipole_energy",
    "cell_list_rspace_dipole_energy_rows",
    "cell_list_rspace_energy",
    "cell_list_rspace_energy_rows",
    "compute_1d_weight_derivatives",
    "compute_1d_weights",
    "compute_cell_list",
    "compute_dipole_interpolation",
    "compute_interpolation",
    "compute_kspace_filter",
    "compute_tiled_interpolation",
    "det3",
    "dipoles_to_mesh",
    "generate_kvectors_for_ewald",
    "generate_kvectors_for_mesh",
    "get_ns_ewald",
    "get_ns_mesh",
    "inv3",
    "kspace_filter_quadratic",
    "mesh_to_dipole_field",
    "mesh_to_points",
    "points_to_mesh",
    "refresh_tiled_interpolation",
    "supports_tiling",
    "tiled_dipoles_to_mesh",
    "tiled_mesh_to_dipole_field",
    "tiled_mesh_to_points",
    "tiled_points_to_mesh",
]
