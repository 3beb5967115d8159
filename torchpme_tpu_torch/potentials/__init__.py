"""Range-separated pair potentials (counterpart of :mod:`torchpme_tpu.potentials`)."""

from .coulomb import CoulombPotential
from .potential import Potential

__all__ = ["CoulombPotential", "Potential"]
