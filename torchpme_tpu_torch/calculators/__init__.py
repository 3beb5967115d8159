"""Calculators (counterpart of :mod:`torchpme_tpu.calculators`)."""

from .calculator import Calculator
from .dipole import CalculatorDipole
from .pme import PMECalculator
from .pme_dipole import PMECalculatorDipole

__all__ = ["Calculator", "CalculatorDipole", "PMECalculator", "PMECalculatorDipole"]
