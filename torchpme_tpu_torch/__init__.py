"""torchpme_tpu_torch: the PyTorch + CUDA port of :mod:`torchpme_tpu`.

A second package beside the JAX one, keeping its module paths and public
names.  Its first slice is the 102k-atom PME MD step (``MDFastPath`` in
aligned mode over ``PMECalculator`` + ``CoulombPotential``), whose three
TPU-side kernels are hand-written CUDA C++ for Hopper (``csrc/``), each
with a plain PyTorch twin in the module that wraps it.  This package
imports ``torch`` and ``numpy``, never ``jax``.
"""

from . import calculators, md, ops, potentials, prefactors  # noqa: F401
from .calculators import Calculator, PMECalculator
from .md import MDFastPath
from .potentials import CoulombPotential, Potential

__all__ = [
    "Calculator",
    "CoulombPotential",
    "MDFastPath",
    "PMECalculator",
    "Potential",
]
