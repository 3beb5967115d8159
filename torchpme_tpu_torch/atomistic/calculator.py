"""Labeled-I/O calculators over :class:`System` / :class:`NeighborList`.

Counterpart of :mod:`torchpme_tpu.atomistic.calculator`, with the same
validation and messages:

* the neighbor list must carry its metadata — pair sample names
  ``(first_atom, second_atom, cell_shift_a/b/c)``, an ``xyz`` vector
  component, a ``distance`` property — and consistency is checked eagerly;
* the system must have a ``"charge"`` data tensor of shape
  ``(n_atoms, n_channels)``;
* the result is a labeled block whose samples are ``(system, atom)`` and
  whose properties are ``charges_channel``.

The containers are plain dataclasses of tensors; the calculators are
``nn.Module`` s around the port's plain calculators, so their values are
the plain calculator's own, kernels included, and autograd reaches the
system's positions, cell and charges.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from .. import calculators as _calc
from ..potentials import Potential

__all__ = [
    "System",
    "NeighborList",
    "LabeledValues",
    "Calculator",
    "EwaldCalculator",
    "PMECalculator",
    "P3MCalculator",
]


@dataclass(frozen=True)
class System:
    """An atomistic system with attached per-atom data tensors.

    :param types: ``(n_atoms,)`` integer species.
    :param positions: ``(n_atoms, 3)`` Cartesian coordinates.
    :param cell: ``(3, 3)`` cell matrix (rows are basis vectors).
    :param data: dict of named per-atom tensors; calculators require a
        ``"charge"`` entry of shape ``(n_atoms, n_channels)``.

    Example
    -------
    >>> import torch
    >>> system = System(
    ...     types=torch.tensor([55, 17]),
    ...     positions=torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    ...     cell=torch.eye(3),
    ... ).add_data("charge", torch.tensor([[1.0], [-1.0]]))
    >>> len(system), tuple(system.get_data("charge").shape)
    (2, (2, 1))
    """

    types: torch.Tensor
    positions: torch.Tensor
    cell: torch.Tensor
    data: dict = field(default_factory=dict)

    def add_data(self, name: str, values) -> "System":
        """Return a new System with ``values`` attached under ``name`` (host
        data goes to the device of ``positions``)."""
        new = dict(self.data)
        new[name] = torch.as_tensor(values, device=self.positions.device)
        return System(self.types, self.positions, self.cell, new)

    def get_data(self, name: str) -> torch.Tensor:
        if name not in self.data:
            raise ValueError(
                f"`system` does not contain `{name}` data. Please attach it "
                f'with `system.add_data("{name}", values)`.'
            )
        return self.data[name]

    def __len__(self) -> int:
        return self.positions.shape[0]


_EXPECTED_SAMPLE_NAMES = (
    "first_atom",
    "second_atom",
    "cell_shift_a",
    "cell_shift_b",
    "cell_shift_c",
)


@dataclass(frozen=True)
class NeighborList:
    """A half or full neighbor list with explicit metadata.

    :param samples: ``(n_pairs, 5)`` integer tensor whose columns are named by
        ``sample_names`` — (first_atom, second_atom, cell_shift_a/b/c).
    :param vectors: ``(n_pairs, 3, 1)`` pair displacement vectors (the
        trailing axis is the ``distance`` property, the metatensor
        TensorBlock layout) or ``(n_pairs, 3)``.
    :param sample_names: metadata names for the sample columns.
    :param component_names: names of the vector components.
    :param property_names: names of the trailing property axis.
    """

    samples: torch.Tensor
    vectors: torch.Tensor
    sample_names: tuple = _EXPECTED_SAMPLE_NAMES
    component_names: tuple = ("xyz",)
    property_names: tuple = ("distance",)

    @property
    def indices(self) -> torch.Tensor:
        return self.samples[:, :2]

    @property
    def cell_shifts(self) -> torch.Tensor:
        return self.samples[:, 2:5]

    @property
    def pair_vectors(self) -> torch.Tensor:
        v = self.vectors
        return v[..., 0] if v.ndim == 3 else v

    @property
    def distances(self) -> torch.Tensor:
        return torch.linalg.norm(self.pair_vectors, dim=-1)


@dataclass(frozen=True)
class LabeledValues:
    """A labeled output block: ``(samples, properties)``-annotated values."""

    values: torch.Tensor
    sample_names: tuple = ("system", "atom")
    samples: torch.Tensor | None = None
    property_names: tuple = ("charges_channel",)

    def block(self) -> "LabeledValues":
        return self


class Calculator(nn.Module):
    """Base labeled-I/O calculator wrapping a plain tensor calculator.

    Subclasses set ``_base_calculator``; ``kwargs`` go to its constructor.

    Example
    -------
    >>> import torch
    >>> from torchpme_tpu_torch import CoulombPotential
    >>> f64 = torch.float64
    >>> positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=f64)
    >>> system = System(torch.tensor([55, 17]), positions, torch.eye(3, dtype=f64)).add_data(
    ...     "charge", torch.tensor([[-1.0], [1.0]], dtype=f64))
    >>> from torchpme_tpu_torch.utils.neighbors import neighbor_list
    >>> idx, _, shifts = neighbor_list(positions, system.cell, cutoff=0.9)
    >>> idx, shifts = torch.as_tensor(idx), torch.as_tensor(shifts)
    >>> vectors = positions[idx[:, 1]] - positions[idx[:, 0]] + shifts.to(f64) @ system.cell
    >>> neighbors = NeighborList(torch.cat([idx, shifts], dim=1), vectors)
    >>> calc = PMECalculator(CoulombPotential(smearing=0.2), mesh_spacing=0.05)
    >>> out = calc(system, neighbors)
    >>> out.sample_names, tuple(out.values.shape)
    (('system', 'atom'), (2, 1))
    >>> print(f"{float(-torch.sum(out.values * system.get_data('charge'))):.3f}")
    2.035
    """

    _base_calculator: type = _calc.Calculator

    def __init__(self, potential: Potential, **kwargs):
        super().__init__()
        self._calculator = self._base_calculator(potential, **kwargs)
        self.potential = potential

    # -- validation (the JAX package's messages) -------------------------------

    def _validate(self, system: System, neighbors: NeighborList) -> None:
        if not isinstance(system, System):
            raise TypeError(
                "`system` must be a torchpme_tpu_torch.atomistic.System, got "
                f"{type(system)}"
            )
        if not isinstance(neighbors, NeighborList):
            raise TypeError(
                "`neighbors` must be a torchpme_tpu_torch.atomistic.NeighborList, "
                f"got {type(neighbors)}"
            )
        if tuple(neighbors.sample_names) != _EXPECTED_SAMPLE_NAMES:
            raise ValueError(
                "Invalid samples for `neighbors`: the sample names must be "
                "'first_atom', 'second_atom', 'cell_shift_a', 'cell_shift_b', "
                f"'cell_shift_c', got {list(neighbors.sample_names)}"
            )
        if tuple(neighbors.component_names) != ("xyz",):
            raise ValueError(
                "Invalid components for `neighbors`: there should be a single "
                f"'xyz' component, got {list(neighbors.component_names)}"
            )
        if tuple(neighbors.property_names) != ("distance",):
            raise ValueError(
                "Invalid properties for `neighbors`: there should be a single "
                f"'distance' property, got {list(neighbors.property_names)}"
            )
        if neighbors.samples.ndim != 2 or neighbors.samples.shape[1] != 5:
            raise ValueError(
                "Invalid samples for `neighbors`: expected shape "
                f"(n_pairs, 5), got {list(neighbors.samples.shape)}"
            )
        vectors = neighbors.pair_vectors
        if tuple(vectors.shape) != (neighbors.samples.shape[0], 3):
            raise ValueError(
                "Invalid vectors for `neighbors`: expected shape (n_pairs, 3), "
                f"got {list(vectors.shape)}"
            )
        charges = system.get_data("charge")
        if charges.ndim != 2 or charges.shape[0] != len(system):
            raise ValueError(
                "Invalid `charge` data: expected shape (n_atoms, n_channels) "
                f"with n_atoms={len(system)}, got {list(charges.shape)}"
            )

    def forward(
        self,
        system: System,
        neighbors: NeighborList,
        system_index: int = 0,
        **extra_kwargs,
    ) -> LabeledValues:
        """Compute per-atom potentials, returning a labeled block.

        :param extra_kwargs: forwarded to the plain calculator (``ns_mesh``,
            ``ns_kvectors``, ``tiled_interp``, ``plain``).
        """
        self._validate(system, neighbors)
        charges = system.get_data("charge")
        values = self._calculator(
            charges,
            system.cell,
            system.positions,
            neighbors.indices,
            neighbors.distances,
            **extra_kwargs,
        )
        n_atoms = len(system)
        atoms = torch.arange(n_atoms, device=values.device)
        samples = torch.stack([torch.full_like(atoms, system_index), atoms], dim=1)
        return LabeledValues(values=values, samples=samples)


class EwaldCalculator(Calculator):
    """Labeled-I/O wrapper of :class:`torchpme_tpu_torch.EwaldCalculator`."""

    _base_calculator = _calc.EwaldCalculator


class PMECalculator(Calculator):
    """Labeled-I/O wrapper of :class:`torchpme_tpu_torch.PMECalculator`."""

    _base_calculator = _calc.PMECalculator


class P3MCalculator(Calculator):
    """Labeled-I/O wrapper of :class:`torchpme_tpu_torch.P3MCalculator`."""

    _base_calculator = _calc.P3MCalculator
