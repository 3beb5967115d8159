"""Calculators (counterpart of :mod:`torchpme_tpu.calculators`)."""

from .calculator import Calculator
from .dipole import CalculatorDipole
from .ewald import EwaldCalculator
from .p3m import P3MCalculator
from .pme import PMECalculator
from .pme_dipole import PMECalculatorDipole

__all__ = [
    "Calculator",
    "CalculatorDipole",
    "EwaldCalculator",
    "P3MCalculator",
    "PMECalculator",
    "PMECalculatorDipole",
]
