"""The multi-device tier on ``torch.distributed``: the slab-sharded
potentials and MD steps of :mod:`torchpme_tpu.parallel`, SPMD over the
ranks of a process group (one process a rank; gloo on the CPU, NCCL on
cards).

Every rank calls a function with the same replicated arguments (the rows
entries take the rank's own block of bucket rows) and gets the whole
result; gradients flow through the collectives of :mod:`._collectives`,
which transpose as JAX's ``psum`` / ``ppermute`` / ``all_to_all`` do.
"""

from ._collectives import collective_counts, reset_collective_counts
from .sharded import (
    SlabBucketing,
    compute_slab_bucketing,
    pad_to_multiple,
    sharded_ewald_potentials,
    sharded_mesh_potentials,
)
from .sharded_md import (
    ShardedMDState,
    compute_sharded_md_state,
    sharded_md_energy,
    sharded_md_energy_rows,
)
from .sharded_md_dipole import (
    ShardedMDDipoleState,
    compute_sharded_md_dipole_state,
    sharded_md_dipole_energy_rows,
)

__all__ = [
    "ShardedMDDipoleState",
    "ShardedMDState",
    "SlabBucketing",
    "compute_sharded_md_dipole_state",
    "compute_sharded_md_state",
    "compute_slab_bucketing",
    "pad_to_multiple",
    "sharded_ewald_potentials",
    "sharded_md_dipole_energy_rows",
    "sharded_md_energy",
    "sharded_md_energy_rows",
    "sharded_mesh_potentials",
]
