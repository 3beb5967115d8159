"""torchpme_tpu_torch: the PyTorch + CUDA port of :mod:`torchpme_tpu`.

A second package beside the JAX one, keeping its module paths and public
names.  It holds the pair potentials (``CoulombPotential``,
``InversePowerLawPotential``, ``CombinedPotential`` with trainable weights,
``SplinePotential``, each with the optional exclusion window), the
point-charge calculators over them
(``Calculator`` for the direct sum, ``EwaldCalculator``, ``PMECalculator``,
``P3MCalculator``; per atom over a neighbor list or a cell list), their MD
steps (``MDFastPath`` in aligned, fused and tiled mode for the mesh
calculators, ``MDFastPathEwald``), and the point-dipole family:
``PotentialDipole``, ``CalculatorDipole`` (direct and Ewald),
``PMECalculatorDipole`` and ``MDFastPathDipole``; the parameter tuners of
:mod:`~torchpme_tpu_torch.tuning`, and the labeled calculators of
:mod:`~torchpme_tpu_torch.atomistic`, and the multi-device tier of
:mod:`~torchpme_tpu_torch.parallel` on ``torch.distributed``.  The TPU-side kernels on those paths are
hand-written CUDA C++ for Hopper (``csrc/``), each with a plain PyTorch
version in the module that wraps it.  Entry points put their state on the
CUDA device when the caller gave neither a device nor tensors
(:func:`default_device`, which raises without a card: ``device="cpu"`` asks
for the CPU).  This package imports ``torch``,
``numpy`` and ``scipy``, never ``jax``.

The package imports its modules at first use (PEP 562).  The kernels are
``tpme::`` operators registered in C++ in their own library
(:mod:`~torchpme_tpu_torch.kernels`), so a process that only runs an exported
CUDA program (:mod:`~torchpme_tpu_torch.deploy`) needs ``torch`` and that
library, which the artifact carries, and no module of this package.
"""

import importlib

#: the JAX package's version (``torchpme_tpu/_version.py``), which the port
#: follows
__version__ = "0.5.0"
__version_tuple__ = (0, 5, 0)

_SUBMODULES = frozenset({
    "atomistic", "calculators", "convert", "deploy", "device", "kernels", "md", "ops",
    "parallel", "potentials", "prefactors", "tuning", "utils",
})
_EXPORTS = {
    "Calculator": "calculators",
    "CalculatorDipole": "calculators",
    "EwaldCalculator": "calculators",
    "P3MCalculator": "calculators",
    "PMECalculator": "calculators",
    "PMECalculatorDipole": "calculators",
    "default_device": "device",
    "MDFastPath": "md",
    "MDFastPathDipole": "md",
    "MDFastPathEwald": "md",
    "CombinedPotential": "potentials",
    "CoulombPotential": "potentials",
    "InversePowerLawPotential": "potentials",
    "Potential": "potentials",
    "PotentialDipole": "potentials",
    "SplinePotential": "potentials",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted({*globals(), *_SUBMODULES, *_EXPORTS})
