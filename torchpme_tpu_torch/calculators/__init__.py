"""Calculators (counterpart of :mod:`torchpme_tpu.calculators`)."""

from .calculator import Calculator
from .pme import PMECalculator

__all__ = ["Calculator", "PMECalculator"]
