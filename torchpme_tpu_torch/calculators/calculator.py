"""Minimal calculator base (counterpart of
:mod:`torchpme_tpu.calculators.calculator`).

The port's first slice serves the MD energy step, which reaches a
calculator only for its potential, its stencil settings and its k-space
energy; the per-atom potential API and the neighbor-list real space come
with later slices.
"""

from __future__ import annotations

from torch import nn

from ..potentials.potential import Potential

__all__ = ["Calculator"]


class Calculator(nn.Module):
    """Holds the pair potential of a calculator.

    :param potential: the range-separated pair potential.
    """

    def __init__(self, potential: Potential):
        super().__init__()
        if not isinstance(potential, Potential):
            raise TypeError(
                f"Potential must be an instance of Potential, got {type(potential)}"
            )
        self.potential = potential
