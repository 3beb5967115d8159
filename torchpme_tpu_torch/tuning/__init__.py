"""Parameter tuning (counterpart of :mod:`torchpme_tpu.tuning`): error
bounds, grid search over k-space parameters and cutoffs, and wall-clock
timings of the candidates on the inputs' device."""

from .dipole import tune_ewald_dipole, tune_pme_dipole
from .ewald import EwaldErrorBounds, tune_ewald
from .p3m import P3MErrorBounds, tune_p3m
from .pme import PMEErrorBounds, tune_pme
from .tuner import (
    GridSearchTuner,
    TunerBase,
    TuningErrorBounds,
    TuningTimings,
    tune_over_cutoffs,
)

__all__ = [
    "EwaldErrorBounds",
    "GridSearchTuner",
    "P3MErrorBounds",
    "PMEErrorBounds",
    "TunerBase",
    "TuningErrorBounds",
    "TuningTimings",
    "tune_ewald",
    "tune_ewald_dipole",
    "tune_over_cutoffs",
    "tune_p3m",
    "tune_pme",
    "tune_pme_dipole",
]
