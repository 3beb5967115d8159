"""State carried between the JAX package and the port, as numpy.

A potential's state is its kind and scalars (``smearing``,
``exclusion_radius``, ``exclusion_degree``, ``prefactor``) and, by kind,
the exponent of ``InversePowerLawPotential``, the members and weights of
``CombinedPotential`` and the grids of ``SplinePotential``
(:func:`potential_state` / :func:`potential_from_state`).  A calculator's
state is its potential's and the calculator's settings (:func:`calculator_state` /
:func:`calculator_from_state`, enough for the per-atom call: the stencil of
``PMECalculator`` and ``P3MCalculator``, P3M's influence-function ``mode``
and ``differential_order``, Ewald's ``lr_wavelength``), a reusable
tile bucketing (:func:`tiled_interp_state` / :func:`tiled_interp_from_state`)
and the host-built bucketing of :class:`~torchpme_tpu_torch.md.MDFastPath`
(the cell list, the row map, the static shapes and, in tiled mode, the tile
bucketing; in aligned mode the extras tile table, when it has one).  :func:`md_state` writes that state as a flat dict of numpy
arrays and Python scalars; :func:`md_from_state` builds the port's
potential, ``PMECalculator`` or ``P3MCalculator`` and ``MDFastPath`` from such a dict
on a given device (its potential from ``potential``); :func:`md_ewald_state` / :func:`md_ewald_from_state`
do the same for :class:`~torchpme_tpu_torch.md.MDFastPathEwald` (its cell
list, row map and k-space extents).  The dipolar family has the same four
functions
(:func:`dipole_calculator_state` / :func:`dipole_calculator_from_state`,
:func:`md_dipole_state` / :func:`md_dipole_from_state`).  A labeled wrapper
of :mod:`~torchpme_tpu_torch.atomistic` is its class name and its inner
calculator's state (:func:`labeled_calculator_state` /
:func:`labeled_calculator_from_state`).  A dict filled from the JAX package's objects (same
keys, arrays via ``np.asarray``) gives the port the identical state, which
is how the tests hold the two packages against each other.
"""

from __future__ import annotations

import numpy as np
import torch

from .calculators import (
    CalculatorDipole,
    EwaldCalculator,
    P3MCalculator,
    PMECalculator,
    PMECalculatorDipole,
)
from .device import resolve_device
from .md import MDFastPath, MDFastPathDipole, MDFastPathEwald
from .ops.mesh_tiled import TiledInterpolation
from .ops.rspace_cells import CellList
from .potentials import (
    CombinedPotential,
    CoulombPotential,
    InversePowerLawPotential,
    PotentialDipole,
    SplinePotential,
)

__all__ = [
    "calculator_from_state",
    "calculator_state",
    "dipole_calculator_from_state",
    "dipole_calculator_state",
    "labeled_calculator_from_state",
    "labeled_calculator_state",
    "md_dipole_from_state",
    "md_dipole_state",
    "md_ewald_from_state",
    "md_ewald_state",
    "md_from_state",
    "md_state",
    "potential_from_state",
    "potential_state",
    "tiled_interp_from_state",
    "tiled_interp_state",
]

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
_TILED_ARRAYS = (
    "local_x", "local_y", "start_z", "weights", "slot_of_atom", "dropped", "atom_of_slot",
)
_TILED_FLOAT_ARRAYS = ("weights", "dweights")


_POTENTIAL_KINDS = {
    CoulombPotential: "coulomb",
    InversePowerLawPotential: "inverse_power_law",
    CombinedPotential: "combined",
    SplinePotential: "spline",
}
_SPLINE_GRIDS = ("r_grid", "y_grid", "k_grid", "yhat_grid")


def _opt_float(value):
    return None if value is None else float(value)


def potential_state(pot) -> dict:
    """A potential as numpy arrays and Python scalars: ``kind``, its scalars
    and, by kind, ``exponent``; ``members`` (their states), ``weights`` and
    ``learnable_weights``; or the spline grids, ``reciprocal`` and the values
    at zero."""
    kind = _POTENTIAL_KINDS.get(type(pot))
    if kind is None:
        raise TypeError(f"no numpy state for a {type(pot).__name__}")
    state = {
        "kind": kind,
        "smearing": _opt_float(pot.smearing),
        "exclusion_radius": _opt_float(pot.exclusion_radius),
        "exclusion_degree": int(pot.exclusion_degree),
        "prefactor": float(pot.prefactor),
    }
    if kind == "inverse_power_law":
        state["exponent"] = int(pot.exponent)
    elif kind == "combined":
        state.update(
            members=[potential_state(p) for p in pot.potentials],
            weights=pot.weights.detach().cpu().numpy(),
            learnable_weights=bool(pot.learnable_weights),
        )
    elif kind == "spline":
        state.update({name: getattr(pot, name).detach().cpu().numpy() for name in _SPLINE_GRIDS})
        state.update(
            reciprocal=bool(pot.reciprocal),
            y_at_zero=float(pot._y_at_zero),
            yhat_at_zero=float(pot._yhat_at_zero),
        )
    return state


def potential_from_state(state: dict):
    """The port's potential from the keys of :func:`potential_state` (a
    dict filled from the JAX package's potential gives the same one)."""
    common = dict(
        smearing=_opt_float(state.get("smearing")),
        exclusion_radius=_opt_float(state.get("exclusion_radius")),
        exclusion_degree=int(state.get("exclusion_degree", 1)),
    )
    kind = state.get("kind", "coulomb")
    if kind == "combined":
        return CombinedPotential(
            [potential_from_state(m) for m in state["members"]],
            initial_weights=torch.from_numpy(np.array(state["weights"], dtype=np.float64)),
            learnable_weights=bool(state.get("learnable_weights", True)),
            **common,
        )
    prefactor = float(state.get("prefactor", 1.0))
    if kind == "coulomb":
        return CoulombPotential(**common, prefactor=prefactor)
    if kind == "inverse_power_law":
        return InversePowerLawPotential(int(state["exponent"]), **common, prefactor=prefactor)
    if kind == "spline":
        grids = {name: torch.from_numpy(np.array(state[name], dtype=np.float64))
                 for name in _SPLINE_GRIDS}
        return SplinePotential(
            **grids, reciprocal=bool(state["reciprocal"]),
            y_at_zero=float(state["y_at_zero"]), yhat_at_zero=float(state["yhat_at_zero"]),
            **common, prefactor=prefactor,
        )
    raise ValueError(
        f"`kind` is {kind!r} but must be 'coulomb', 'inverse_power_law', 'combined' or 'spline'"
    )


def calculator_state(calc) -> dict:
    """The potential's ``smearing`` and ``prefactor`` (and, for any potential
    but a ``CoulombPotential`` without exclusion window, its whole state under
    ``potential``) and the calculator's settings: the stencil of a mesh
    calculator (``method`` ``"Lagrange"`` for PME, ``"P3M"`` with ``mode``
    and ``differential_order``), or Ewald's ``lr_wavelength``."""
    pot = calc.potential
    state = {"smearing": pot.smearing, "prefactor": pot.prefactor}
    if type(pot) is not CoulombPotential or pot.exclusion_radius is not None:
        state["potential"] = potential_state(pot)
    if isinstance(calc, EwaldCalculator):
        state["lr_wavelength"] = calc.lr_wavelength
        return state
    state.update(
        interpolation_nodes=calc.interpolation_nodes,
        method=calc._method,
        mesh_spacing=calc.mesh_spacing,
    )
    if isinstance(calc, P3MCalculator):
        state.update(mode=calc.mode, differential_order=calc.differential_order)
    return state


def calculator_from_state(state: dict, **kwargs):
    """The port's calculator from the keys of :func:`calculator_state` (its
    potential from ``potential``, or a ``CoulombPotential`` of the top-level
    ``smearing`` and ``prefactor`` where the state has none):
    ``EwaldCalculator`` where the state has an
    ``lr_wavelength`` and no ``method``, else ``PMECalculator``
    (``"Lagrange"``) or ``P3MCalculator`` (``"P3M"``).  ``kwargs``
    (``full_neighbor_list``, ``mesh_backend``, ``tile_capacity``) go to the
    calculator."""
    if state.get("potential") is not None:
        potential = potential_from_state(state["potential"])
    else:
        potential = CoulombPotential(
            smearing=float(state["smearing"]), prefactor=float(state["prefactor"])
        )
    method = state.get("method")
    if method is None and state.get("lr_wavelength") is not None:
        return EwaldCalculator(potential, lr_wavelength=float(state["lr_wavelength"]), **kwargs)
    mesh = dict(
        mesh_spacing=float(state["mesh_spacing"]),
        interpolation_nodes=int(state["interpolation_nodes"]),
    )
    if method == "Lagrange":
        return PMECalculator(potential, **mesh, **kwargs)
    if method == "P3M":
        return P3MCalculator(
            potential, **mesh, mode=int(state.get("mode", 0)),
            differential_order=int(state.get("differential_order", 2)), **kwargs,
        )
    raise ValueError(f"`method` is {method!r} but must be 'Lagrange' or 'P3M'")


def labeled_calculator_state(calc) -> dict:
    """A labeled wrapper (:class:`~torchpme_tpu_torch.atomistic.Calculator`
    and its subclasses): ``class``, the wrapper's class name, and
    ``calculator``, the :func:`calculator_state` of the calculator it wraps."""
    return {"class": type(calc).__name__, "calculator": calculator_state(calc._calculator)}


def labeled_calculator_from_state(state: dict, **kwargs):
    """The port's labeled wrapper from the keys of
    :func:`labeled_calculator_state`; ``kwargs`` go to the inner calculator."""
    from . import atomistic

    inner = calculator_from_state(state["calculator"], **kwargs)
    cls = getattr(atomistic, state["class"], None)
    if cls is None or type(inner) is not cls._base_calculator:
        raise ValueError(
            f"`class` is {state['class']!r}, which does not wrap a {type(inner).__name__}"
        )
    # the wrapper's own two attributes, around the inner calculator built above
    wrapper = cls.__new__(cls)
    torch.nn.Module.__init__(wrapper)
    wrapper._calculator = inner
    wrapper.potential = inner.potential
    return wrapper


def tiled_interp_state(interp: TiledInterpolation) -> dict:
    """A tile bucketing as numpy arrays plus its static ``ns`` and ``nodes``."""
    state = {"ns": tuple(interp.ns), "nodes": int(interp.nodes)}
    for name in (*_TILED_ARRAYS, "dweights"):
        value = getattr(interp, name)
        state[name] = None if value is None else value.detach().cpu().numpy()
    return state


def tiled_interp_from_state(state: dict, device=None) -> TiledInterpolation:
    """The port's :class:`TiledInterpolation` from the keys of
    :func:`tiled_interp_state` (the integer arrays as int32, the weights in
    their own float type), on ``device``."""
    device = resolve_device(device)

    def dev(name):
        value = state.get(name)
        if value is None:
            return None
        dtype = None if name in _TILED_FLOAT_ARRAYS else np.int32
        return torch.from_numpy(np.array(value, dtype=dtype)).to(device)

    return TiledInterpolation(
        *(dev(name) for name in _TILED_ARRAYS),
        ns=tuple(int(n) for n in state["ns"]),
        nodes=int(state["nodes"]),
        dweights=dev("dweights"),
    )


def _bucketing_state(fp) -> dict:
    """The part of an MD state both families share: the cell list, the row
    map, the static sizes and the tile bucketing."""
    clist = fp.clist
    state = {
        "n_axis": tuple(clist.n_axis),
        "cutoff": clist.cutoff,
        "slack": tuple(clist.slack),
        "row_of_atom": fp.row_of_atom.cpu().numpy(),
        "n_rows": fp.n_rows,
        "n_atoms": fp.n_atoms,
    }
    for name in _CLIST_ARRAYS + _EXTRA_ARRAYS:
        value = getattr(clist, name)
        state[name] = None if value is None else value.cpu().numpy()
    tiled = getattr(fp, "tiled", None)
    state["tiled"] = None if tiled is None else tiled_interp_state(tiled)
    return state


def md_state(fp: MDFastPath) -> dict:
    """The port's MD state as numpy arrays and Python scalars."""
    return {
        **calculator_state(fp.calc),
        **_bucketing_state(fp),
        "mesh_impl": fp.mesh_impl,
        "ns_mesh": fp.ns_mesh,
        "cell_grid": fp.cell_grid,
        "aligned_pad": fp.aligned_pad,
        "extras_tiled": None if fp.extras_tiled is None else tiled_interp_state(fp.extras_tiled),
    }


def _bucketing_from_state(state: dict, device):
    """``(clist, row_of_atom, tiled)`` on ``device`` from the keys of
    :func:`_bucketing_state`."""

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
    tiled = state.get("tiled")
    return (
        clist,
        dev("row_of_atom"),
        None if tiled is None else tiled_interp_from_state(tiled, device),
    )


def md_from_state(state: dict, device=None) -> MDFastPath:
    """Port objects (potential, calculator, MD state) from a numpy state
    dict with the keys of :func:`md_state`, on ``device`` (default:
    :func:`torchpme_tpu_torch.default_device`)."""
    device = resolve_device(device)
    clist, row_of_atom, tiled = _bucketing_from_state(state, device)
    extras = state.get("extras_tiled")
    return MDFastPath(
        calculator_from_state(state),
        clist,
        row_of_atom,
        tuple(int(n) for n in state["ns_mesh"]),
        int(state["n_rows"]),
        int(state["n_atoms"]),
        None if tiled is not None else tuple(int(n) for n in state["cell_grid"]),
        int(state["aligned_pad"]),
        tiled,
        state.get("mesh_impl"),
        None if extras is None else tiled_interp_from_state(extras, device),
    )


def md_ewald_state(fp: MDFastPathEwald) -> dict:
    """The port's Ewald MD state as numpy arrays and Python scalars."""
    return {
        **calculator_state(fp.calc),
        **_bucketing_state(fp),
        "ns_kvectors": fp.ns_kvectors,
    }


def md_ewald_from_state(state: dict, device=None) -> MDFastPathEwald:
    """Port objects (potential, Ewald calculator, MD state) from a numpy
    state dict with the keys of :func:`md_ewald_state`, on ``device``
    (default: :func:`torchpme_tpu_torch.default_device`)."""
    device = resolve_device(device)
    clist, row_of_atom, _ = _bucketing_from_state(state, device)
    return MDFastPathEwald(
        calculator_from_state(state),
        clist,
        row_of_atom,
        tuple(int(n) for n in state["ns_kvectors"]),
        int(state["n_rows"]),
        int(state["n_atoms"]),
    )


# -- the dipolar family ------------------------------------------------------------

_DIPOLE_POTENTIAL_KEYS = (
    "smearing", "exclusion_radius", "exclusion_degree", "epsilon", "prefactor",
)


def dipole_calculator_state(calc: CalculatorDipole) -> dict:
    """The dipolar potential's scalars and the calculator's settings
    (``kind`` is ``"ewald"`` for :class:`CalculatorDipole`, ``"pme"`` for
    :class:`PMECalculatorDipole`)."""
    pot = calc.potential
    if pot.has_trainable_parameters():
        raise ValueError("a potential with trainable parameters has no numpy state")
    state = {
        key: None if getattr(pot, key) is None else float(getattr(pot, key))
        for key in _DIPOLE_POTENTIAL_KEYS
    }
    state["exclusion_degree"] = int(pot.exclusion_degree)
    state["full_neighbor_list"] = calc.full_neighbor_list
    if isinstance(calc, PMECalculatorDipole):
        state.update(
            kind="pme",
            mesh_spacing=calc.mesh_spacing,
            interpolation_nodes=calc.interpolation_nodes,
            method=calc._method,
            mesh_backend=calc.mesh_backend,
            tile_capacity=calc.tile_capacity,
        )
    else:
        state.update(kind="ewald", lr_wavelength=calc.lr_wavelength)
    return state


def dipole_calculator_from_state(state: dict, **kwargs) -> CalculatorDipole:
    """The port's dipolar calculator over a :class:`PotentialDipole` from the
    keys of :func:`dipole_calculator_state`; ``kwargs`` override the
    calculator's own settings (``mesh_backend``, ``tile_capacity``, ...)."""
    potential = PotentialDipole(**{key: state.get(key) for key in _DIPOLE_POTENTIAL_KEYS
                                   if state.get(key) is not None})
    full = bool(state.get("full_neighbor_list", False))
    if state["kind"] == "ewald":
        lr = state.get("lr_wavelength")
        settings = dict(full_neighbor_list=full, lr_wavelength=None if lr is None else float(lr))
        return CalculatorDipole(potential, **{**settings, **kwargs})
    if state["kind"] != "pme":
        raise ValueError(f"`kind` is {state['kind']!r} but must be 'ewald' or 'pme'")
    settings = dict(
        mesh_spacing=float(state["mesh_spacing"]),
        interpolation_nodes=int(state["interpolation_nodes"]),
        full_neighbor_list=full,
        mesh_backend=state.get("mesh_backend", "auto"),
        tile_capacity=state.get("tile_capacity"),
        _method=state.get("method", "Lagrange"),
    )
    return PMECalculatorDipole(potential, **{**settings, **kwargs})


def md_dipole_state(fp: MDFastPathDipole) -> dict:
    """The port's dipolar MD state as numpy arrays and Python scalars."""
    return {
        **dipole_calculator_state(fp.calc),
        **_bucketing_state(fp),
        "ns_kvectors": fp.ns_kvectors,
    }


def md_dipole_from_state(state: dict, device=None) -> MDFastPathDipole:
    """Port objects (potential, calculator, dipolar MD state) from a numpy
    state dict with the keys of :func:`md_dipole_state`, on ``device``
    (default: :func:`torchpme_tpu_torch.default_device`)."""
    device = resolve_device(device)
    clist, row_of_atom, tiled = _bucketing_from_state(state, device)
    ns_k = state.get("ns_kvectors")
    return MDFastPathDipole(
        dipole_calculator_from_state(state),
        clist,
        row_of_atom,
        None if ns_k is None else tuple(int(n) for n in ns_k),
        int(state["n_rows"]),
        int(state["n_atoms"]),
        tiled,
    )
