"""State carried between the JAX package and the port, as numpy.

The MD step has no learned weights.  Its state is the potential's scalars,
the calculator's stencil settings, and the host-built bucketing of
:class:`~torchpme_tpu_torch.md.MDFastPath` (the cell list, the row map and
the static shapes).  :func:`md_state` writes that state as a flat dict of
numpy arrays and Python scalars; :func:`md_from_state` builds the port's
``CoulombPotential``, ``PMECalculator`` and ``MDFastPath`` from such a dict
on a given device.  A dict filled from the JAX package's objects (same
keys, arrays via ``np.asarray``) gives the port the identical state, which
is how the tests hold the two packages against each other.
"""

from __future__ import annotations

import numpy as np
import torch

from .calculators import PMECalculator
from .md import MDFastPath
from .ops.rspace_cells import CellList
from .potentials import CoulombPotential

__all__ = ["md_from_state", "md_state"]

_CLIST_ARRAYS = ("atom_index", "slot_mask", "atom_wrap")
_EXTRA_ARRAYS = ("extra_index", "extra_mask", "extra_cell", "extra_wrap")
_DTYPES = {
    "atom_index": np.int32,
    "slot_mask": np.bool_,
    "atom_wrap": np.int8,
    "extra_index": np.int32,
    "extra_mask": np.bool_,
    "extra_cell": np.int32,
    "extra_wrap": np.int8,
    "row_of_atom": np.int32,
}


def md_state(fp: MDFastPath) -> dict:
    """The port's MD state as numpy arrays and Python scalars."""
    pot, calc, clist = fp.calc.potential, fp.calc, fp.clist
    state = {
        "smearing": pot.smearing,
        "prefactor": pot.prefactor,
        "interpolation_nodes": calc.interpolation_nodes,
        "method": calc._method,
        "mesh_spacing": calc.mesh_spacing,
        "n_axis": tuple(clist.n_axis),
        "cutoff": clist.cutoff,
        "slack": tuple(clist.slack),
        "row_of_atom": fp.row_of_atom.cpu().numpy(),
        "n_rows": fp.n_rows,
        "n_atoms": fp.n_atoms,
        "ns_mesh": fp.ns_mesh,
        "cell_grid": fp.cell_grid,
        "aligned_pad": fp.aligned_pad,
    }
    for name in _CLIST_ARRAYS + _EXTRA_ARRAYS:
        value = getattr(clist, name)
        state[name] = None if value is None else value.cpu().numpy()
    return state


def md_from_state(state: dict, device=None) -> MDFastPath:
    """Port objects (potential, calculator, MD state) from a numpy state
    dict with the keys of :func:`md_state`, on ``device``."""
    if state["method"] != "Lagrange":
        raise ValueError(f"the port's PMECalculator is Lagrange-only, got {state['method']!r}")
    potential = CoulombPotential(
        smearing=float(state["smearing"]), prefactor=float(state["prefactor"])
    )
    calc = PMECalculator(
        potential,
        mesh_spacing=float(state["mesh_spacing"]),
        interpolation_nodes=int(state["interpolation_nodes"]),
    )

    def dev(name):
        value = state.get(name)
        if value is None:
            return None
        return torch.from_numpy(np.asarray(value, dtype=_DTYPES[name]).copy()).to(device)

    clist = CellList(
        *(dev(name) for name in _CLIST_ARRAYS),
        tuple(int(n) for n in state["n_axis"]),
        float(state["cutoff"]),
        tuple(float(s) for s in state["slack"]),
        *(dev(name) for name in _EXTRA_ARRAYS),
    )
    return MDFastPath(
        calc,
        clist,
        dev("row_of_atom"),
        tuple(int(n) for n in state["ns_mesh"]),
        int(state["n_rows"]),
        int(state["n_atoms"]),
        tuple(int(n) for n in state["cell_grid"]),
        int(state["aligned_pad"]),
    )
