"""Converters between the labeled containers and real metatensor objects.

Counterpart of :mod:`torchpme_tpu.atomistic.convert`.  A metatensor /
metatomic pipeline feeds the calculators of
:mod:`torchpme_tpu_torch.atomistic.calculator` and consumes their output
through:

* :func:`system_from_metatensor` — ``metatomic.torch.System`` (with its
  TensorMap ``"charge"`` data) → :class:`~torchpme_tpu_torch.atomistic.System`;
* :func:`neighborlist_from_metatensor` — a metatensor ``TensorBlock``
  neighbor list (the layout ``metatomic.torch.System.get_neighborlist``
  returns) → :class:`~torchpme_tpu_torch.atomistic.NeighborList`;
* :func:`labeled_to_metatensor` — :class:`~torchpme_tpu_torch.atomistic.LabeledValues`
  → a metatensor ``TensorMap`` (keys ``"_"``, samples ``(system, atom)``,
  properties ``charges_channel``).

metatensor's objects hold torch tensors, which the converters take as they
are (device and autograd history kept); numpy values go to ``device``, or
to :func:`~torchpme_tpu_torch.device.default_device`.  The module imports
without metatensor; :func:`labeled_to_metatensor` needs ``metatensor.torch``
or the numpy ``metatensor`` core API.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .calculator import _EXPECTED_SAMPLE_NAMES, LabeledValues, NeighborList, System

__all__ = [
    "system_from_metatensor",
    "neighborlist_from_metatensor",
    "labeled_to_metatensor",
    "metatensor_backend",
]


def _tensor(x, device) -> torch.Tensor:
    """A torch tensor as it is; anything else as a tensor on ``device``."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)


def metatensor_backend() -> str | None:
    """Which metatensor API is importable: ``"torch"``, ``"numpy"`` or None."""
    try:
        import metatensor.torch  # noqa: F401

        return "torch"
    except ImportError:
        pass
    try:
        import metatensor  # noqa: F401

        return "numpy"
    except ImportError:
        return None


def system_from_metatensor(mts_system, charge_key: str = "charge", device=None) -> System:
    """Build a :class:`System` from a ``metatomic.torch.System``.

    The system must carry a ``charge`` data entry: a one-block,
    component-free TensorMap whose block values are ``(n_atoms, n_channels)``.

    :param mts_system: a ``metatomic.torch.System`` (or any object with
        ``types`` / ``positions`` / ``cell`` attributes, ``known_data()``,
        and ``get_data(name)`` returning a TensorMap-like with ``block()``).
    :param charge_key: name of the per-atom data entry to import.
    :param device: where numpy values go (tensors keep their device).
    """
    device = resolve_device(device, mts_system.positions)
    system = System(
        types=_tensor(mts_system.types, device),
        positions=_tensor(mts_system.positions, device),
        cell=_tensor(mts_system.cell, device),
    )
    known = set(mts_system.known_data())
    if charge_key not in known:
        raise ValueError(
            f"`system` does not contain `{charge_key}` data; attach it with "
            f'`system.add_data("{charge_key}", tensor_map)` first'
        )
    charge_tmap = mts_system.get_data(charge_key)
    if len(charge_tmap) != 1:
        raise ValueError(
            "Charge tensor must have exactly one block but has "
            f"{len(charge_tmap)} blocks"
        )
    block = charge_tmap.block()
    if len(block.components) > 0:
        raise ValueError(
            "TensorBlock containing the charges should not have components; "
            f"found {len(block.components)}"
        )
    return system.add_data(charge_key, _tensor(block.values, device))


def neighborlist_from_metatensor(neighbors, device=None) -> NeighborList:
    """Build a :class:`NeighborList` from a metatensor neighbor TensorBlock:
    samples named ``(first_atom, second_atom, cell_shift_a/b/c)``, one
    ``xyz`` component, one ``distance`` property, values ``(n_pairs, 3, 1)``.

    :param device: where numpy values go (tensors keep their device).
    """
    samples = neighbors.samples
    names = tuple(samples.names)
    if names != _EXPECTED_SAMPLE_NAMES:
        raise ValueError(
            "Invalid samples for `neighbors`: the sample names must be "
            "'first_atom', 'second_atom', 'cell_shift_a', 'cell_shift_b', "
            f"'cell_shift_c', got {list(names)}"
        )
    components = list(getattr(neighbors, "components", []))
    if components:
        component_names = tuple(c.names[0] for c in components)
    else:
        component_names = ("xyz",)
    if component_names != ("xyz",):
        raise ValueError(
            "Invalid components for `neighbors`: there should be a single "
            f"'xyz' component, got {list(component_names)}"
        )
    device = resolve_device(device, neighbors.values, samples.values)
    return NeighborList(
        samples=_tensor(samples.values, device),
        vectors=_tensor(neighbors.values, device),
        sample_names=names,
        component_names=component_names,
        property_names=("distance",),
    )


def labeled_to_metatensor(labeled: LabeledValues, backend: str = "auto"):
    """Export a :class:`LabeledValues` block as a metatensor ``TensorMap``:
    keys ``Labels("_", [[0]])``, one TensorBlock whose samples are
    ``(system, atom)``, no components, and ``charges_channel`` properties.

    :param backend: ``"torch"`` (metatensor.torch: the values tensor as it
        is), ``"numpy"`` (metatensor core: a numpy copy), or ``"auto"``
        (torch if importable, else numpy).
    """
    if backend == "auto":
        backend = metatensor_backend()
        if backend is None:
            raise ImportError(
                "neither metatensor.torch nor metatensor is installed; "
                "`pip install metatensor[torch]` (requires network egress)"
            )

    values = labeled.values
    n_atoms, n_channels = values.shape
    if labeled.samples is not None:
        samples_arr = labeled.samples.detach().cpu().numpy().astype(np.int32)
    else:
        samples_arr = np.stack(
            [np.zeros(n_atoms, np.int32), np.arange(n_atoms, dtype=np.int32)],
            axis=1,
        )
    props_arr = np.arange(n_channels, dtype=np.int32).reshape(-1, 1)
    keys_arr = np.zeros((1, 1), dtype=np.int32)

    if backend == "torch":
        from metatensor.torch import Labels, TensorBlock, TensorMap

        def labels(names, arr):
            return Labels(list(names), torch.from_numpy(arr)).to(values.device)

        block = TensorBlock(
            values=values,
            samples=labels(labeled.sample_names, samples_arr),
            components=[],
            properties=labels(labeled.property_names, props_arr),
        )
        return TensorMap(keys=labels(("_",), keys_arr), blocks=[block])

    if backend == "numpy":
        from metatensor import Labels, TensorBlock, TensorMap

        block = TensorBlock(
            values=values.detach().cpu().numpy().copy(),
            samples=Labels(list(labeled.sample_names), samples_arr),
            components=[],
            properties=Labels(list(labeled.property_names), props_arr),
        )
        keys = Labels("_", keys_arr)
        return TensorMap(keys=keys, blocks=[block])

    raise ValueError(f"unknown metatensor backend {backend!r}")
