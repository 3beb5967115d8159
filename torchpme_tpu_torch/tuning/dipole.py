r"""Parameter tuning for the dipolar calculators (Ewald and PME).

Counterpart of :mod:`torchpme_tpu.tuning.dipole`.  Unlike the scalar tuners,
which screen candidates with closed-form error bounds, the dipolar tuners
**measure** each candidate's force error against a converged dipolar Ewald
sum evaluated once on the input system (``smearing = cutoff/5.5``,
``lr_wavelength = smearing/2.5``: the dipolar k-sum's (μ·k)² weight makes it
converge slower in ``k_max·σ`` than the Coulomb rule of thumb, hence the
extra 2.5).  The returned parameters meet the accuracy on *this* system.
Candidates meeting the accuracy are then timed (energy plus its backward to
dipoles, cell and positions, wall time closed by a device synchronisation
on a card) and the fastest wins: the screen-then-time structure of
:class:`~torchpme_tpu_torch.tuning.tuner.GridSearchTuner`.  The reference
sum's k-vector count grows as N·(L/λ)³, so the screen is for systems of
hundreds to a few thousand dipoles.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from ..calculators import CalculatorDipole, PMECalculatorDipole
from ..device import resolve_device
from ..potentials import PotentialDipole
from .tuner import _min_dimension, _on_device, _to_numpy, _wall_seconds

__all__ = ["tune_ewald_dipole", "tune_pme_dipole"]

#: reference convergence: smearing = cutoff / _REF_RATIO, lr_wavelength =
#: smearing / _REF_LR_FACTOR (λ = σ is off by ~1e-1 absolute force RMS on a
#: 50-dipole box, λ = σ/2.5 is converged to ~1e-8)
_REF_RATIO = 5.5
_REF_LR_FACTOR = 2.5


def _filter_pairs(cutoff, neighbor_indices, neighbor_vectors):
    """Restrict a (larger-cutoff) vector neighbor list to ``cutoff``: on the
    host, returned on the inputs' device."""
    device = resolve_device(None, neighbor_indices, neighbor_vectors)
    vec = _to_numpy(neighbor_vectors)
    keep = np.linalg.norm(vec, axis=-1) < cutoff
    return tuple(_on_device(device, _to_numpy(neighbor_indices)[keep], vec[keep]))


def _forces(calc, dipoles, cell, positions, idx, vec, shifts):
    """Gradient of the total dipolar energy with respect to the positions
    (minus the forces), the pair vectors rebuilt from the positions."""
    extra = (
        {"ns_kvectors": calc.get_ns_kvectors(cell)}
        if calc.potential.smearing is not None
        else {}
    )
    p = positions.detach().requires_grad_()
    v = p[idx[:, 1].long()] - p[idx[:, 0].long()] + shifts.to(p.dtype) @ cell
    (grad,) = torch.autograd.grad(calc.energy(dipoles, cell, p, idx, v, **extra), p)
    return grad


class _DipoleTimings:
    """Wall time of the dipolar energy+gradient step (see
    :class:`~torchpme_tpu_torch.tuning.tuner.TuningTimings`, adapted to the
    vector neighbor list and the (dipoles, cell, positions) gradient)."""

    def __init__(self, dipoles, cell, positions, idx, vec, n_repeat=4, n_warmup=2):
        self.args = (dipoles, cell, positions)
        self.idx = idx
        self.vec = vec
        self.n_repeat = n_repeat
        self.n_warmup = n_warmup

    def __call__(self, calc, **extra) -> float:
        args = [x.detach().requires_grad_() for x in self.args]

        def step():
            energy = calc.energy(*args, self.idx, self.vec, **extra)
            torch.autograd.grad(energy, args)

        return _wall_seconds(step, self.args[2].device, self.n_warmup, self.n_repeat)


def _tune_dipole(
    dipoles,
    cell,
    positions,
    cutoff,
    neighbor_indices,
    neighbor_vectors,
    neighbor_shifts,
    candidates,
    make_calc,
    accuracy,
    smearing_ratios,
):
    device = resolve_device(None, dipoles, cell, positions)
    dipoles, cell, positions = _on_device(device, dipoles, cell, positions)
    idx, vec = _filter_pairs(cutoff, neighbor_indices, neighbor_vectors)
    keep = np.linalg.norm(_to_numpy(neighbor_vectors), axis=-1) < cutoff
    (shifts,) = _on_device(device, _to_numpy(neighbor_shifts)[keep])

    smearing_ref = float(cutoff) / _REF_RATIO
    ref = CalculatorDipole(
        PotentialDipole(smearing=smearing_ref),
        lr_wavelength=smearing_ref / _REF_LR_FACTOR,
    ).to(device)
    f_ref = _forces(ref, dipoles, cell, positions, idx, vec, shifts)

    timer = _DipoleTimings(dipoles, cell, positions, idx, vec)
    best = None
    lowest = None  # (err, smearing, param) fallback when nothing qualifies
    for ratio in smearing_ratios:
        smearing = float(cutoff) / ratio
        for param in candidates:
            calc = make_calc(smearing, param).to(device)
            f = _forces(calc, dipoles, cell, positions, idx, vec, shifts)
            # absolute RMS force error, like the scalar bounds
            err = float(torch.sqrt(torch.mean(torch.sum((f - f_ref) ** 2, dim=-1))))
            if lowest is None or err < lowest[0]:
                lowest = (err, smearing, param)
            if err > accuracy:
                continue
            t = timer(calc, ns_kvectors=calc.get_ns_kvectors(cell))
            if best is None or t < best[2]:
                best = (smearing, param, t)
            # candidates are ordered coarse → fine: the first qualifying
            # one is the cheapest for this smearing, skip the finer rest
            break
    if best is None:
        warnings.warn(
            "No parameter combination met the accuracy requirement.\n"
            "Returning the parameter with the smallest measured force "
            f"error, which is {lowest[0]:.3e}.\n",
            stacklevel=3,
        )
        return lowest[1], lowest[2], float("inf")
    return best


def tune_ewald_dipole(
    dipoles,
    cell,
    positions,
    cutoff: float,
    neighbor_indices,
    neighbor_vectors,
    neighbor_shifts,
    ns_lo: int = 2,
    ns_hi: int = 40,
    accuracy: float = 1e-3,
    smearing_ratios=(4.0, 4.5, 5.0, 5.5),
) -> tuple[float, dict[str, Any], float]:
    r"""Find ``(smearing, lr_wavelength)`` for :class:`CalculatorDipole`.

    Screens ``lr_wavelength = min_cell_dim / ns`` for ``ns = ns_lo..ns_hi``
    crossed with ``smearing = cutoff / ratio``, measuring each candidate's
    absolute RMS force error against a converged dipolar-Ewald reference.
    Per smearing the scan stops at the first (coarsest = cheapest)
    qualifying wavelength, which is timed; the fastest qualifying
    ``(smearing, lr_wavelength)`` wins.

    :param neighbor_vectors: ``(P, 3)`` pair displacement vectors (the
        dipolar calculators take vectors, not distances); build at a cutoff
        ≥ ``cutoff``: the tuner filters down.
    :param neighbor_shifts: ``(P, 3)`` integer cell shifts of each pair
        (to rebuild the vectors differentiably for the force error).
    :return: ``(smearing, {"lr_wavelength": ...}, seconds_per_step)``.
    """
    min_dim = _min_dimension(cell)
    candidates = [
        {"lr_wavelength": min_dim / ns} for ns in range(ns_lo, ns_hi + 1)
    ]

    def make_calc(smearing, param):
        return CalculatorDipole(PotentialDipole(smearing=smearing), **param)

    return _tune_dipole(
        dipoles, cell, positions, cutoff, neighbor_indices, neighbor_vectors,
        neighbor_shifts, candidates, make_calc, accuracy, smearing_ratios,
    )


def tune_pme_dipole(
    dipoles,
    cell,
    positions,
    cutoff: float,
    neighbor_indices,
    neighbor_vectors,
    neighbor_shifts,
    nodes_lo: int = 4,
    nodes_hi: int = 7,
    mesh_lo: int = 2,
    mesh_hi: int = 7,
    accuracy: float = 1e-3,
    smearing_ratios=(4.0, 4.5, 5.0, 5.5),
) -> tuple[float, dict[str, Any], float]:
    r"""Find ``(smearing, mesh_spacing, interpolation_nodes)`` for
    :class:`PMECalculatorDipole`.

    Same measured-error screen as :func:`tune_ewald_dipole` over
    ``mesh_spacing = smearing / 2^(m/2)`` (m = ``mesh_lo..mesh_hi``) × Lagrange
    node counts × smearing ratios; per smearing the scan stops at the first
    qualifying (coarsest-mesh) candidate.

    :return: ``(smearing, {"mesh_spacing": ..., "interpolation_nodes": ...},
        seconds_per_step)``.
    """

    def make_calc(smearing, param):
        return PMECalculatorDipole(
            PotentialDipole(smearing=smearing),
            mesh_spacing=smearing / 2 ** (param["_m"] / 2),
            interpolation_nodes=param["interpolation_nodes"],
        )

    candidates = [
        {"_m": m, "interpolation_nodes": nodes}
        for m in range(mesh_lo, mesh_hi + 1)
        for nodes in range(nodes_lo, nodes_hi + 1)
    ]
    smearing, param, timing = _tune_dipole(
        dipoles, cell, positions, cutoff, neighbor_indices, neighbor_vectors,
        neighbor_shifts, candidates, make_calc, accuracy, smearing_ratios,
    )
    param = {
        "mesh_spacing": smearing / 2 ** (param["_m"] / 2),
        "interpolation_nodes": param["interpolation_nodes"],
    }
    return smearing, param, timing
