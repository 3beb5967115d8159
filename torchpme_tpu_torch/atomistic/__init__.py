"""Labeled atomistic-systems interface (counterpart of
:mod:`torchpme_tpu.atomistic`): calculators that consume a :class:`System`
(positions, cell, types, attached per-atom data) plus a
:class:`NeighborList` with explicit metadata, validate that metadata, and
return a :class:`LabeledValues` block keyed by ``charges_channel``; and the
converters to and from real metatensor objects
(:mod:`torchpme_tpu_torch.atomistic.convert`), importable without metatensor.
"""

from .calculator import (
    Calculator,
    EwaldCalculator,
    LabeledValues,
    NeighborList,
    P3MCalculator,
    PMECalculator,
    System,
)
from .convert import (
    labeled_to_metatensor,
    metatensor_backend,
    neighborlist_from_metatensor,
    system_from_metatensor,
)

__all__ = [
    "Calculator",
    "EwaldCalculator",
    "LabeledValues",
    "NeighborList",
    "P3MCalculator",
    "PMECalculator",
    "System",
    "labeled_to_metatensor",
    "metatensor_backend",
    "neighborlist_from_metatensor",
    "system_from_metatensor",
]
