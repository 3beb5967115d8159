"""Doctest every module of the torch port (on the CPU: examples run the
kernels' plain versions)."""

import doctest
import importlib
import pkgutil

import pytest
import torch

import torchpme_tpu_torch

torch.set_num_threads(1)


def _walk_modules():
    names = ["torchpme_tpu_torch"]
    for info in pkgutil.walk_packages(
        torchpme_tpu_torch.__path__, prefix="torchpme_tpu_torch."
    ):
        names.append(info.name)
    return sorted(names)


ALL_MODULES = _walk_modules()

MUST_HAVE_EXAMPLES = [
    "torchpme_tpu_torch.calculators.calculator",
    "torchpme_tpu_torch.calculators.pme",
    "torchpme_tpu_torch.calculators.p3m",
    "torchpme_tpu_torch.calculators.ewald",
    "torchpme_tpu_torch.ops.kspace",
    "torchpme_tpu_torch.ops.mesh",
    "torchpme_tpu_torch.ops.rspace_cells",
    "torchpme_tpu_torch.calculators.dipole",
    "torchpme_tpu_torch.calculators.pme_dipole",
    "torchpme_tpu_torch.potentials.dipole",
    "torchpme_tpu_torch.md",
    "torchpme_tpu_torch.ops.mesh_tiled",
    "torchpme_tpu_torch.utils.neighbors",
    "torchpme_tpu_torch.ops.kvectors",
    "torchpme_tpu_torch.ops.math",
    "torchpme_tpu_torch.potentials.coulomb",
    "torchpme_tpu_torch.prefactors",
    "torchpme_tpu_torch.potentials.potential",
    "torchpme_tpu_torch.potentials.inverse_power_law",
    "torchpme_tpu_torch.potentials.combined",
    "torchpme_tpu_torch.potentials.spline",
    "torchpme_tpu_torch.ops.splines",
]


@pytest.mark.parametrize("name", ALL_MODULES)
def test_port_module_doctests(name):
    module = importlib.import_module(name)
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0
    if name in MUST_HAVE_EXAMPLES:
        assert results.attempted > 0, f"no doctests collected in {name}"
