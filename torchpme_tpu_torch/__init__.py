"""torchpme_tpu_torch: the PyTorch + CUDA port of :mod:`torchpme_tpu`.

A second package beside the JAX one, keeping its module paths and public
names.  It holds the pair potentials (``CoulombPotential``,
``InversePowerLawPotential``, ``CombinedPotential`` with trainable weights,
``SplinePotential``, each with the optional exclusion window), the
point-charge calculators over them
(``Calculator`` for the direct sum, ``EwaldCalculator``, ``PMECalculator``,
``P3MCalculator``; per atom over a neighbor list or a cell list), their MD
steps (``MDFastPath`` in aligned, fused and tiled mode for the mesh
calculators, ``MDFastPathEwald``), and the point-dipole family:
``PotentialDipole``, ``CalculatorDipole`` (direct and Ewald),
``PMECalculatorDipole`` and ``MDFastPathDipole``.  The TPU-side kernels on those paths are
hand-written CUDA C++ for Hopper (``csrc/``), each with a plain PyTorch
version in the module that wraps it.  Entry points put their state on the
CUDA device when the caller gave neither a device nor tensors
(:func:`default_device`, which raises without a card: ``device="cpu"`` asks
for the CPU).  This package imports ``torch``,
``numpy`` and ``scipy``, never ``jax``.
"""

from . import calculators, md, ops, potentials, prefactors, utils  # noqa: F401
from .calculators import (
    Calculator,
    CalculatorDipole,
    EwaldCalculator,
    P3MCalculator,
    PMECalculator,
    PMECalculatorDipole,
)
from .device import default_device
from .md import MDFastPath, MDFastPathDipole, MDFastPathEwald
from .potentials import (
    CombinedPotential,
    CoulombPotential,
    InversePowerLawPotential,
    Potential,
    PotentialDipole,
    SplinePotential,
)

__all__ = [
    "Calculator",
    "CalculatorDipole",
    "CombinedPotential",
    "CoulombPotential",
    "EwaldCalculator",
    "InversePowerLawPotential",
    "MDFastPath",
    "MDFastPathDipole",
    "MDFastPathEwald",
    "P3MCalculator",
    "PMECalculator",
    "PMECalculatorDipole",
    "Potential",
    "PotentialDipole",
    "SplinePotential",
    "default_device",
]
