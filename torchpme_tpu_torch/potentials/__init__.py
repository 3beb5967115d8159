"""Range-separated pair potentials (counterpart of :mod:`torchpme_tpu.potentials`)."""

from .coulomb import CoulombPotential
from .dipole import PotentialDipole
from .potential import Potential

__all__ = ["CoulombPotential", "Potential", "PotentialDipole"]
