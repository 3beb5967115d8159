"""torchpme_tpu_torch: the PyTorch + CUDA port of :mod:`torchpme_tpu`.

A second package beside the JAX one, keeping its module paths and public
names.  It holds the 102k-atom PME MD step (``MDFastPath`` in aligned and
tiled mode) and the per-atom ``PMECalculator`` call over a neighbor list,
both over ``CoulombPotential``, and the point-dipole family: ``PotentialDipole``,
``CalculatorDipole`` (direct and Ewald), ``PMECalculatorDipole`` and
``MDFastPathDipole``.  The TPU-side kernels on those paths are
hand-written CUDA C++ for Hopper (``csrc/``), each with a plain PyTorch
version in the module that wraps it.  Entry points put their state on the
CUDA device when the caller gave neither a device nor tensors
(:func:`default_device`, which raises without a card: ``device="cpu"`` asks
for the CPU).  This package imports ``torch``,
``numpy`` and ``scipy``, never ``jax``.
"""

from . import calculators, md, ops, potentials, prefactors, utils  # noqa: F401
from .calculators import Calculator, CalculatorDipole, PMECalculator, PMECalculatorDipole
from .device import default_device
from .md import MDFastPath, MDFastPathDipole
from .potentials import CoulombPotential, Potential, PotentialDipole

__all__ = [
    "Calculator",
    "CalculatorDipole",
    "CoulombPotential",
    "MDFastPath",
    "MDFastPathDipole",
    "PMECalculator",
    "PMECalculatorDipole",
    "Potential",
    "PotentialDipole",
    "default_device",
]
