"""Shared fixtures of the torch-port parity tests (tests/test_torch_*.py).

The same seeded numpy inputs go through the JAX package and the port;
state built by the JAX package reaches the port as numpy through
:mod:`torchpme_tpu_torch.convert`.
"""

import numpy as np
import torch

from torchpme_tpu.md import _row_mapping as jax_row_mapping
from torchpme_tpu_torch.convert import md_dipole_from_state, md_from_state
from torchpme_tpu_torch.ops.rspace_cells import CellList

CLIST_FIELDS = (
    "atom_index",
    "slot_mask",
    "atom_wrap",
    "extra_index",
    "extra_mask",
    "extra_cell",
    "extra_wrap",
)


def random_box(n, box, seed, lo=0.0, hi=None, charges="normal"):
    """``(positions, charges, cell)`` as float64 numpy, neutral charges."""
    rng = np.random.default_rng(seed)
    hi = box if hi is None else hi
    positions = rng.uniform(lo, hi, (n, 3))
    if charges == "water":
        q = np.tile([-0.84, 0.42, 0.42], n // 3 + 1)[:n]
    else:
        q = rng.normal(size=n)
    q = (q - q.mean()).reshape(-1, 1)
    return positions, q, np.eye(3) * box


def lattice_box(seed, n_side=7, box=16.0, jitter=0.35):
    """A jittered cubic lattice (no pair closer than ~1.6 Å, so the steep
    1/r^p gradients stay well conditioned in float64) with neutral normal
    charges, as float64 numpy."""
    rng = np.random.default_rng(seed)
    grid = (np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3)
            + 0.5) * (box / n_side)
    positions = grid + rng.uniform(-jitter, jitter, grid.shape)
    q = rng.normal(size=(positions.shape[0], 1))
    return positions, q - q.mean(), np.eye(3) * box


def clustered_box(n, box, seed, n_cluster=40):
    """A box with a dense cluster, so tight cell lists spill."""
    positions, q, cell = random_box(n, box, seed)
    rng = np.random.default_rng(seed + 100)
    cluster = 0.5 + 0.3 * rng.uniform(size=(n_cluster, 3)) * box / 8.0
    positions = np.concatenate([positions, cluster])
    q = np.concatenate([q, np.ones((n_cluster, 1))])
    return positions, q - q.mean(), cell


def clist_arrays(clist) -> dict:
    """The array fields of a JAX or port cell list as numpy (None kept)."""
    out = {}
    for name in CLIST_FIELDS:
        value = getattr(clist, name)
        if value is None:
            out[name] = None
        elif isinstance(value, torch.Tensor):
            out[name] = value.numpy()
        else:
            out[name] = np.asarray(value)
    return out


def port_clist(clist_j) -> CellList:
    """The port's CellList holding a JAX cell list's arrays (CPU)."""
    arrays = {
        k: None if v is None else torch.from_numpy(v.copy())
        for k, v in clist_arrays(clist_j).items()
    }
    return CellList(
        arrays["atom_index"],
        arrays["slot_mask"],
        arrays["atom_wrap"],
        tuple(clist_j.n_axis),
        float(clist_j.cutoff),
        tuple(clist_j.slack),
        arrays["extra_index"],
        arrays["extra_mask"],
        arrays["extra_cell"],
        arrays["extra_wrap"],
    )


def rows_of(clist_j, positions):
    """Bucket-row positions (numpy) of a JAX cell list."""
    row_of_atom, n_rows = jax_row_mapping(clist_j, positions.shape[0])
    rows = np.zeros((n_rows, 3), positions.dtype)
    rows[row_of_atom] = positions
    return rows


TILED_FIELDS = (
    "local_x", "local_y", "start_z", "weights", "slot_of_atom", "dropped", "atom_of_slot",
)


def jax_tiled_state(interp_j) -> dict:
    """The numpy state dict of a JAX TiledInterpolation (convert's keys)."""
    state = {"ns": tuple(interp_j.ns), "nodes": int(interp_j.nodes)}
    for name in (*TILED_FIELDS, "dweights"):
        value = getattr(interp_j, name)
        state[name] = None if value is None else np.asarray(value)
    return state


def _opt_float(value):
    return None if value is None else float(value)


def jax_potential_state(pot_j) -> dict:
    """The numpy state dict of a JAX potential (convert's keys)."""
    import torchpme_tpu as tpme
    from torchpme_tpu.ops.splines import CubicSplineReciprocal

    kinds = {
        tpme.CoulombPotential: "coulomb",
        tpme.InversePowerLawPotential: "inverse_power_law",
        tpme.CombinedPotential: "combined",
        tpme.SplinePotential: "spline",
    }
    state = {
        "kind": kinds[type(pot_j)],
        "smearing": _opt_float(pot_j.smearing),
        "exclusion_radius": _opt_float(pot_j.exclusion_radius),
        "exclusion_degree": int(pot_j.exclusion_degree),
        "prefactor": float(pot_j.prefactor),
    }
    if state["kind"] == "inverse_power_law":
        state["exponent"] = int(pot_j.exponent)
    elif state["kind"] == "combined":
        state.update(
            members=[jax_potential_state(p) for p in pot_j.potentials],
            weights=np.asarray(pot_j.weights),
            learnable_weights=bool(pot_j.learnable_weights),
        )
    elif state["kind"] == "spline":
        state.update({name: np.asarray(getattr(pot_j, name))
                      for name in ("r_grid", "y_grid", "k_grid", "yhat_grid")})
        state.update(
            reciprocal=isinstance(pot_j._spline, CubicSplineReciprocal),
            y_at_zero=float(pot_j._y_at_zero),
            yhat_at_zero=float(pot_j._yhat_at_zero),
        )
    return state


def jax_md_state(fp_j) -> dict:
    """The numpy state dict of a JAX MDFastPath (convert's keys)."""
    calc = fp_j.calc
    state = {
        "smearing": float(calc.potential.smearing),
        "prefactor": float(calc.potential.prefactor),
        "interpolation_nodes": int(calc.interpolation_nodes),
        "method": calc._method,
        "mesh_spacing": float(calc.mesh_spacing),
        "mesh_impl": fp_j.mesh_impl,
        "n_axis": tuple(fp_j.clist.n_axis),
        "cutoff": float(fp_j.clist.cutoff),
        "slack": tuple(fp_j.clist.slack),
        "row_of_atom": np.asarray(fp_j.row_of_atom),
        "n_rows": fp_j.n_rows,
        "n_atoms": fp_j.n_atoms,
        "ns_mesh": fp_j.ns_mesh,
        "cell_grid": fp_j.cell_grid,
        "aligned_pad": fp_j.aligned_pad,
    }
    if calc._method == "P3M":
        state.update(mode=int(calc.mode), differential_order=int(calc.differential_order))
    pot_state = jax_potential_state(calc.potential)
    if pot_state["kind"] != "coulomb" or pot_state["exclusion_radius"] is not None:
        state["potential"] = pot_state
    state.update(clist_arrays(fp_j.clist))
    state["tiled"] = None if fp_j.tiled is None else jax_tiled_state(fp_j.tiled)
    state["extras_tiled"] = (
        None if fp_j.extras_tiled is None else jax_tiled_state(fp_j.extras_tiled)
    )
    return state


def port_from_jax(fp_j):
    """The port's MDFastPath on the JAX MDFastPath's exact state (CPU)."""
    return md_from_state(jax_md_state(fp_j), device="cpu")


def dipole_box(n, box, seed, triclinic=False):
    """``(positions, dipoles, cell)`` as float64 numpy: uniform positions and
    normal dipoles in a cubic (or skewed) cell."""
    rng = np.random.default_rng(seed)
    cell = np.eye(3) * box
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = 0.15 * box, -0.1 * box, 0.12 * box
    positions = rng.uniform(0, 1, (n, 3)) @ cell
    return positions, rng.normal(size=(n, 3)), cell


def jax_dipole_calculator_state(calc_j) -> dict:
    """The numpy state dict of a JAX dipolar calculator (convert's keys)."""
    pot = calc_j.potential
    state = {
        "smearing": None if pot.smearing is None else float(pot.smearing),
        "exclusion_radius": (
            None if pot.exclusion_radius is None else float(pot.exclusion_radius)
        ),
        "exclusion_degree": int(pot.exclusion_degree),
        "epsilon": float(pot.epsilon),
        "prefactor": float(pot.prefactor),
        "full_neighbor_list": bool(calc_j.full_neighbor_list),
    }
    if hasattr(calc_j, "mesh_spacing"):
        state.update(
            kind="pme",
            mesh_spacing=float(calc_j.mesh_spacing),
            interpolation_nodes=int(calc_j.interpolation_nodes),
            method=calc_j._method,
            mesh_backend=calc_j.mesh_backend,
            tile_capacity=calc_j.tile_capacity,
        )
    else:
        state.update(kind="ewald", lr_wavelength=calc_j.lr_wavelength)
    return state


def jax_md_dipole_state(fp_j) -> dict:
    """The numpy state dict of a JAX MDFastPathDipole (convert's keys)."""
    state = {
        **jax_dipole_calculator_state(fp_j.calc),
        "n_axis": tuple(fp_j.clist.n_axis),
        "cutoff": float(fp_j.clist.cutoff),
        "slack": tuple(fp_j.clist.slack),
        "row_of_atom": np.asarray(fp_j.row_of_atom),
        "n_rows": fp_j.n_rows,
        "n_atoms": fp_j.n_atoms,
        "ns_kvectors": fp_j.ns_kvectors,
    }
    state.update(clist_arrays(fp_j.clist))
    state["tiled"] = None if fp_j.tiled is None else jax_tiled_state(fp_j.tiled)
    return state


def port_dipole_from_jax(fp_j):
    """The port's MDFastPathDipole on the JAX state's exact arrays (CPU)."""
    return md_dipole_from_state(jax_md_dipole_state(fp_j), device="cpu")


def rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())
