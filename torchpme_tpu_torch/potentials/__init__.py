"""Range-separated pair potentials (counterpart of :mod:`torchpme_tpu.potentials`)."""

from .combined import CombinedPotential
from .coulomb import CoulombPotential
from .dipole import PotentialDipole
from .inverse_power_law import InversePowerLawPotential
from .potential import Potential
from .spline import SplinePotential

__all__ = [
    "CombinedPotential",
    "CoulombPotential",
    "InversePowerLawPotential",
    "Potential",
    "PotentialDipole",
    "SplinePotential",
]
