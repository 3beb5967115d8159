"""Parameter-tuning infrastructure: error bounds, grid search, timing.

Counterpart of :mod:`torchpme_tpu.tuning.tuner`, with the same candidate
grids, screening and results:

* the error bounds are plain functions of their scalar parameters on floats
  or tensors, evaluated in float64, and autograd differentiates them in
  ``smearing``, ``mesh_spacing``, ``lr_wavelength`` and ``cutoff``;
* a candidate's timing is the wall time of a forward plus the backward to
  positions, charges and cell, each step closed by a
  ``torch.cuda.synchronize`` on a card: what a user pays, host dispatch
  included.  The warm-up steps take the first use of a mesh shape (the
  kernels' build, cuFFT plans, allocator growth).  Wall times of one
  candidate vary from run to run, so on a card the pick between candidates
  of similar cost varies too.

Inputs given as tensors keep their device; host (numpy) inputs go to
:func:`~torchpme_tpu_torch.device.default_device`, the card, and the timed
calculators are built on that device.
"""

from __future__ import annotations

import math
import time
import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..potentials import InversePowerLawPotential
from ..utils.validation import validate_parameters

__all__ = [
    "TuningErrorBounds",
    "TunerBase",
    "GridSearchTuner",
    "TuningTimings",
    "tune_over_cutoffs",
]


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on_device(device, *values) -> list[torch.Tensor]:
    """``values`` as tensors on ``device`` (tensors there are kept as they are)."""
    return [
        v.to(device) if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v), device=device)
        for v in values
    ]


def _f64(*values) -> list[torch.Tensor]:
    """Scalars or tensors as float64 tensors on the device of the first tensor
    among them (the CPU for plain numbers); a tensor keeps its autograd
    history."""
    device = next((v.device for v in values if isinstance(v, torch.Tensor)), None)
    return [torch.as_tensor(v, dtype=torch.float64, device=device) for v in values]


class TuningErrorBounds:
    """Base class for calculator error-bound estimators.

    Subclasses implement :meth:`error` as a function of the tuning
    parameters; instances are callable.  The system's scalars (volume, the
    charges' sum of squares, the cell's basis lengths) are kept in float64
    on the inputs' device.
    """

    def __init__(self, charges, cell, positions):
        device = resolve_device(None, charges, cell, positions)
        self._charges, self._cell, self._positions = _on_device(device, charges, cell, positions)
        cell64 = self._cell.double()
        self.volume = torch.abs(torch.linalg.det(cell64))
        self.sum_squared_charges = torch.sum(self._charges.double() ** 2)
        self.prefac = 2 * self.sum_squared_charges / math.sqrt(self._positions.shape[0])
        self.cell_dimensions = torch.linalg.norm(cell64, dim=1)

    def __call__(self, *args, **kwargs):
        return self.error(*args, **kwargs)

    def error(self, *args, **kwargs):
        raise NotImplementedError

    forward = __call__


class TunerBase:
    """Shared tuning scaffolding: smearing estimation and neighbor filtering.

    The smearing is chosen so that the real-space truncation error equals a
    quarter of the requested accuracy (inverting the Kolafa–Perram real-space
    bound), from the volume and the charges' sum of squares in float64.

    :param charges: ``(N, 1)`` charges.
    :param cell: ``(3, 3)`` cell.
    :param positions: ``(N, 3)`` coordinates.
    :param cutoff: real-space cutoff (a tuning hyperparameter).
    :param calculator: calculator class to instantiate for timing.
    :param exponent: potential exponent; only ``p = 1`` is supported.
    :param full_neighbor_list: neighbor-list convention for timing runs.
    :param prefactor: unit prefactor forwarded to the timed potential.

    Example
    -------
    >>> import torch
    >>> from torchpme_tpu_torch import PMECalculator
    >>> f64 = torch.float64
    >>> tuner = TunerBase(
    ...     torch.tensor([[1.0], [-1.0]], dtype=f64), torch.eye(3, dtype=f64) * 10,
    ...     torch.tensor([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]], dtype=f64),
    ...     cutoff=4.0, calculator=PMECalculator,
    ... )
    >>> print(f"{tuner.estimate_smearing(1e-3):.4f}")
    1.3343
    """

    def __init__(
        self,
        charges,
        cell,
        positions,
        cutoff: float,
        calculator,
        exponent: int = 1,
        full_neighbor_list: bool = False,
        prefactor: float = 1.0,
    ):
        if exponent != 1:
            raise NotImplementedError(
                f"Only exponent = 1 is supported but got {exponent}."
            )
        device = resolve_device(None, charges, cell, positions)
        charges, cell, positions = _on_device(device, charges, cell, positions)
        validate_parameters(
            charges=charges,
            cell=cell,
            positions=positions,
            neighbor_indices=torch.zeros((1, 2), dtype=torch.int32, device=device),
            neighbor_distances=torch.ones((1,), dtype=positions.dtype, device=device),
        )
        self.charges = charges
        self.cell = cell
        self.positions = positions
        self.cutoff = cutoff
        self.calculator = calculator
        self.exponent = exponent
        self.full_neighbor_list = full_neighbor_list
        self.prefactor = prefactor

        self._smearing_prefac = (
            2 * float(torch.sum(charges.detach().double() ** 2)) / math.sqrt(positions.shape[0])
        )

    def tune(self, accuracy: float = 1e-3):
        raise NotImplementedError

    def estimate_smearing(self, accuracy: float) -> float:
        """Smearing such that the real-space error bound equals ``accuracy/4``."""
        if not isinstance(accuracy, float):
            raise ValueError(f"'{accuracy}' is not a float.")
        volume = float(torch.abs(torch.linalg.det(self.cell.detach().double())))
        ratio = math.sqrt(
            -2
            * math.log(
                accuracy
                / 2
                / self._smearing_prefac
                * math.sqrt(self.cutoff * volume)
            )
        )
        return float(self.cutoff / ratio)

    @staticmethod
    def filter_neighbors(cutoff: float, neighbor_indices, neighbor_distances):
        """Restrict a (pre-computed, larger-cutoff) neighbor list to ``cutoff``.

        Runs on the host (the output's length depends on the data) and
        returns tensors on the inputs' device.
        """
        device = resolve_device(None, neighbor_indices, neighbor_distances)
        d = _to_numpy(neighbor_distances)
        keep = d < cutoff
        return tuple(_on_device(device, _to_numpy(neighbor_indices)[keep], d[keep]))


def tune_over_cutoffs(
    tune_fn,
    charges,
    cell,
    positions,
    cutoffs,
    neighbor_indices,
    neighbor_distances,
    **tune_kwargs,
):
    r"""Jointly tune the real-space ``cutoff`` with the k-space parameters.

    Runs a ``tune_*`` function at each candidate cutoff and returns the
    fastest combination.  The neighbor list must be computed at
    ``max(cutoffs)``: each trial filters it down
    (:meth:`TunerBase.filter_neighbors`), so only one neighbor-list build is
    needed.

    :param tune_fn: one of :func:`~torchpme_tpu_torch.tuning.tune_ewald`,
        :func:`~torchpme_tpu_torch.tuning.tune_pme`,
        :func:`~torchpme_tpu_torch.tuning.tune_p3m`.
    :param cutoffs: iterable of candidate cutoffs, each ≤ the cutoff the
        neighbor list was built with.
    :param tune_kwargs: forwarded to ``tune_fn`` (accuracy, grid bounds, ...).
    :return: ``(cutoff, smearing, kspace_params, seconds_per_step)`` of the
        fastest accurate combination.

    Example
    -------
    >>> import torch
    >>> from torchpme_tpu_torch.tuning import tune_ewald, tune_over_cutoffs
    >>> from torchpme_tpu_torch.utils.neighbors import neighbor_list
    >>> f64 = torch.float64
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=f64)
    >>> charges = torch.tensor([[1.0], [-1.0]], dtype=f64)
    >>> cell = torch.eye(3, dtype=f64)
    >>> idx, dist, _ = neighbor_list(positions, cell, cutoff=0.49)
    >>> cutoff, smearing, params, timing = tune_over_cutoffs(
    ...     tune_ewald, charges, cell, positions, [0.4, 0.49],
    ...     torch.as_tensor(idx), torch.as_tensor(dist), ns_lo=4, ns_hi=6,
    ... )
    >>> cutoff in (0.4, 0.49) and smearing > 0 and "lr_wavelength" in params
    True
    """
    best = None
    for cutoff in cutoffs:
        with warnings.catch_warnings():
            # an individual cutoff failing its accuracy screen is fine as
            # long as some cutoff passes; the sweep raises when all fail
            warnings.simplefilter("ignore", UserWarning)
            smearing, params, timing = tune_fn(
                charges,
                cell,
                positions,
                cutoff=float(cutoff),
                neighbor_indices=neighbor_indices,
                neighbor_distances=neighbor_distances,
                **tune_kwargs,
            )
        if math.isfinite(timing) and (best is None or timing < best[3]):
            best = (float(cutoff), smearing, params, timing)
    if best is None:
        raise ValueError(
            "No (cutoff, parameters) combination met the accuracy requirement; "
            "widen the candidate grids or relax the accuracy."
        )
    return best


def _wall_seconds(step, device: torch.device, n_warmup: int, n_repeat: int) -> float:
    """Mean wall seconds of ``step()`` over ``n_repeat`` runs after
    ``n_warmup``, each run closed by a synchronisation of a CUDA ``device``."""
    elapsed = 0.0
    for i in range(n_warmup + n_repeat):
        start = time.perf_counter()
        step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if i >= n_warmup:
            elapsed += time.perf_counter() - start
    return elapsed / n_repeat


class TuningTimings:
    """Wall-clock timing of a calculator's energy+gradient step.

    The timed quantity is a forward plus the backward of
    ``sum(potentials * charges)`` to positions, charges and cell (the
    neighbor distances held fixed), closed by a device synchronisation on a
    card, averaged over ``n_repeat`` runs after ``n_warmup`` runs.

    Example
    -------
    >>> import torch
    >>> from torchpme_tpu_torch import CoulombPotential, EwaldCalculator
    >>> f64 = torch.float64
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=f64)
    >>> charges = torch.tensor([[1.0], [-1.0]], dtype=f64)
    >>> timer = TuningTimings(charges, torch.eye(3, dtype=f64), positions,
    ...                       torch.tensor([[0, 1]]), torch.tensor([0.866], dtype=f64))
    >>> seconds = timer(EwaldCalculator(CoulombPotential(smearing=0.2), lr_wavelength=0.2))
    >>> 0 < seconds < 1
    True
    """

    def __init__(
        self,
        charges,
        cell,
        positions,
        neighbor_indices,
        neighbor_distances,
        n_repeat: int = 4,
        n_warmup: int = 2,
        run_backward: bool = True,
    ):
        device = resolve_device(None, charges, cell, positions, neighbor_indices,
                                neighbor_distances)
        (self.charges, self.cell, self.positions, self.neighbor_indices,
         self.neighbor_distances) = _on_device(
            device, charges, cell, positions, neighbor_indices, neighbor_distances
        )
        validate_parameters(
            charges=self.charges,
            cell=self.cell,
            positions=self.positions,
            neighbor_indices=self.neighbor_indices,
            neighbor_distances=self.neighbor_distances,
        )
        self.n_repeat = n_repeat
        self.n_warmup = n_warmup
        self.run_backward = run_backward

    def __call__(self, calculator, **extra_kwargs) -> float:
        inputs = [
            x.detach().requires_grad_(self.run_backward)
            for x in (self.positions, self.charges, self.cell)
        ]
        positions, charges, cell = inputs

        def step():
            potentials = calculator(
                charges, cell, positions, self.neighbor_indices,
                self.neighbor_distances, **extra_kwargs,
            )
            energy = torch.sum(potentials * charges)
            if self.run_backward:
                torch.autograd.grad(energy, inputs)

        return _wall_seconds(step, self.positions.device, self.n_warmup, self.n_repeat)

    forward = __call__


class GridSearchTuner(TunerBase):
    """Grid-search tuner: error-bound screening, wall-clock ranking.

    Every candidate parameter set is scored with the analytic error bound;
    only candidates meeting the requested accuracy are timed (the rest get
    infinite timing).

    :param params: list of k-space parameter dicts to screen (e.g.
        ``{"mesh_spacing": ..., "interpolation_nodes": ...}``).
    """

    def __init__(
        self,
        charges,
        cell,
        positions,
        cutoff: float,
        calculator,
        error_bounds: TuningErrorBounds,
        params: list[dict],
        neighbor_indices,
        neighbor_distances,
        full_neighbor_list: bool = False,
        prefactor: float = 1.0,
        exponent: int = 1,
    ):
        super().__init__(
            charges,
            cell,
            positions,
            cutoff,
            calculator,
            exponent=exponent,
            full_neighbor_list=full_neighbor_list,
            prefactor=prefactor,
        )
        self.error_bounds = error_bounds
        self.params = params
        neighbor_indices, neighbor_distances = self.filter_neighbors(
            cutoff, neighbor_indices, neighbor_distances
        )
        self.time_func = TuningTimings(
            self.charges,
            self.cell,
            self.positions,
            neighbor_indices,
            neighbor_distances,
            run_backward=True,
        )

    def tune(self, accuracy: float = 1e-3) -> tuple[list[float], list[float]]:
        """Return (error, timing) per candidate; timing is ∞ above accuracy."""
        if not isinstance(accuracy, float):
            raise ValueError(f"'{accuracy}' is not a float.")
        smearing = self.estimate_smearing(accuracy)
        errors, timings = [], []
        for param in self.params:
            error = float(
                self.error_bounds(smearing=smearing, cutoff=self.cutoff, **param).detach()
            )
            errors.append(error)
            timings.append(
                self._time_candidate(smearing, param) if error <= accuracy else float("inf")
            )
        return errors, timings

    def _time_candidate(self, smearing: float, k_space_params: dict) -> float:
        calculator = self.calculator(
            InversePowerLawPotential(
                exponent=self.exponent,
                smearing=smearing,
                prefactor=self.prefactor,
            ),
            full_neighbor_list=self.full_neighbor_list,
            **k_space_params,
        ).to(self.positions.device)
        # the static shapes, as the JAX package passes them to its jitted step
        extra = {}
        if hasattr(calculator, "get_ns_mesh"):
            extra["ns_mesh"] = calculator.get_ns_mesh(self.cell)
        elif hasattr(calculator, "get_ns_kvectors"):
            extra["ns_kvectors"] = calculator.get_ns_kvectors(self.cell)
        return self.time_func(calculator, **extra)


def _best_candidate(params, errs, timings, smearing, accuracy):
    """The tuners' common return: the fastest candidate, or (with a warning)
    the most accurate one when no candidate meets ``accuracy``."""
    if any(err < accuracy for err in errs):
        best = timings.index(min(timings))
        return smearing, params[best], timings[best]
    warnings.warn(
        "No parameter meets the accuracy requirement.\n"
        f"Returning the parameter with the smallest error, which is {min(errs)}.\n",
        stacklevel=3,
    )
    best = errs.index(min(errs))
    return smearing, params[best], timings[best]


def _min_dimension(cell) -> float:
    """Length of the cell's shortest basis vector."""
    return float(np.min(np.linalg.norm(_to_numpy(cell), axis=1)))
