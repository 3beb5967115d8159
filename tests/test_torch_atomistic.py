"""The port's labeled atomistic calculators (torchpme_tpu_torch.atomistic)
against the port's plain calculators (bitwise) and the JAX package's
torchpme_tpu.atomistic (values, validation messages, metatensor converters),
on the CPU in float64."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchpme_tpu as tpme
import torchpme_tpu.atomistic as jat
import torchpme_tpu_torch as tpt
import torchpme_tpu_torch.atomistic as tat
from torchpme_tpu_torch.convert import labeled_calculator_from_state, labeled_calculator_state
from torchpme_tpu_torch.utils.neighbors import neighbor_list

sys.path.append(str(Path(__file__).parent))
from torch_port_common import jax_potential_state, random_box

torch.set_num_threads(1)

CUTOFF = 3.0
# (wrapper name, settings of its calculator)
CALCULATORS = {
    "EwaldCalculator": dict(lr_wavelength=1.0),
    "PMECalculator": dict(mesh_spacing=0.6, interpolation_nodes=5),
    "P3MCalculator": dict(mesh_spacing=0.6, interpolation_nodes=3),
}


@pytest.fixture(scope="module")
def box():
    """30 atoms in an 8 Å box (seed 7), two charge channels; the neighbor
    samples and (n_pairs, 3, 1) vectors of the metatensor layout."""
    positions, q, cell = random_box(30, 8.0, 7)
    charges = np.concatenate([q, -0.5 * q], axis=1)
    idx, _, shifts = neighbor_list(positions, cell, cutoff=CUTOFF)
    vectors = positions[idx[:, 1]] - positions[idx[:, 0]] + shifts @ cell
    types = np.arange(30) % 2 + 1
    return types, positions, cell, charges, np.concatenate([idx, shifts], axis=1), vectors


def _port(box, charge=True):
    types, positions, cell, charges, samples, vectors = box
    system = tat.System(torch.as_tensor(types), torch.as_tensor(positions), torch.as_tensor(cell))
    if charge:
        system = system.add_data("charge", charges)
    return system, tat.NeighborList(torch.as_tensor(samples), torch.as_tensor(vectors)[..., None])


def _jax(box, charge=True):
    types, positions, cell, charges, samples, vectors = box
    system = jat.System(jnp.asarray(types), jnp.asarray(positions), jnp.asarray(cell))
    if charge:
        system = system.add_data("charge", jnp.asarray(charges))
    return system, jat.NeighborList(jnp.asarray(samples), jnp.asarray(vectors)[..., None])


@pytest.mark.parametrize("name", CALCULATORS)
def test_labeled_equals_plain_bitwise_and_jax(box, name):
    kw = CALCULATORS[name]
    system, neighbors = _port(box)
    calc = getattr(tat, name)(tpt.CoulombPotential(smearing=0.8), **kw)
    out = calc(system, neighbors, system_index=3)
    plain = getattr(tpt, name)(tpt.CoulombPotential(smearing=0.8), **kw)(
        system.get_data("charge"), system.cell, system.positions, neighbors.indices,
        torch.linalg.norm(neighbors.vectors[..., 0], dim=-1),
    )
    assert torch.equal(out.values, plain)
    assert out.sample_names == ("system", "atom") and out.property_names == ("charges_channel",)
    assert out.samples.tolist() == [[3, i] for i in range(30)]
    assert out.block() is out

    system_j, neighbors_j = _jax(box)
    calc_j = getattr(jat, name)(tpme.CoulombPotential(smearing=0.8), **kw)

    def call_j():
        out_j = calc_j(system_j, neighbors_j, system_index=3)
        return out_j.values, out_j.samples

    # one trace and compile of the JAX call, not one per operation
    values_j, samples_j = (np.asarray(a) for a in jax.jit(call_j)())
    np.testing.assert_allclose(out.values.numpy(), values_j, rtol=0,
                               atol=1e-10 * np.abs(values_j).max())
    np.testing.assert_array_equal(out.samples.numpy(), samples_j)


@pytest.mark.parametrize("name", CALCULATORS)
def test_labeled_state_carries_a_jax_wrapper(box, name):
    """convert: a labeled wrapper's state (its class and its calculator's
    state), filled from the JAX package's wrapper, gives the port's wrapper
    with the same values."""
    kw = CALCULATORS[name]
    calc_j = getattr(jat, name)(tpme.CoulombPotential(smearing=0.8, prefactor=2.0), **kw)
    inner = calc_j._calculator
    pot = jax_potential_state(inner.potential)
    state = {"class": type(calc_j).__name__,
             "calculator": {"smearing": pot["smearing"], "prefactor": pot["prefactor"]}}
    if name == "EwaldCalculator":
        state["calculator"]["lr_wavelength"] = float(inner.lr_wavelength)
    else:
        state["calculator"].update(
            interpolation_nodes=int(inner.interpolation_nodes), method=inner._method,
            mesh_spacing=float(inner.mesh_spacing))
        if name == "P3MCalculator":
            state["calculator"].update(mode=int(inner.mode),
                                       differential_order=int(inner.differential_order))
    calc = labeled_calculator_from_state(state)
    assert type(calc) is getattr(tat, name)
    assert labeled_calculator_state(calc) == state
    out = calc(*_port(box))
    system_j, neighbors_j = _jax(box)
    values_j = np.asarray(jax.jit(lambda: calc_j(system_j, neighbors_j).values)())
    np.testing.assert_allclose(out.values.numpy(), values_j, rtol=0,
                               atol=1e-10 * np.abs(values_j).max())
    with pytest.raises(ValueError, match="does not wrap"):
        labeled_calculator_from_state({**state, "class": "Calculator"})


def _bad_inputs(make, box, case):
    """``(system, neighbors)`` of one invalid case, built by ``make`` (the
    port's or the JAX package's containers)."""
    system, neighbors = make(box, charge=case != "missing_charge")
    nl = type(neighbors)
    if case == "sample_names":
        neighbors = nl(neighbors.samples, neighbors.vectors, sample_names=("i", "j", "a", "b", "c"))
    elif case == "components":
        neighbors = nl(neighbors.samples, neighbors.vectors, component_names=("abc",))
    elif case == "properties":
        neighbors = nl(neighbors.samples, neighbors.vectors, property_names=("d",))
    elif case == "samples_shape":
        neighbors = nl(neighbors.samples[:, :4], neighbors.vectors)
    elif case == "vectors_shape":
        neighbors = nl(neighbors.samples, neighbors.vectors[:-1])
    elif case == "charge_shape":
        system = system.add_data("charge", np.ones((29, 1)))
    elif case == "system_type":
        system = "not a system"
    elif case == "neighbors_type":
        neighbors = "not a neighbor list"
    return system, neighbors


@pytest.mark.parametrize("case", [
    "missing_charge", "sample_names", "components", "properties", "samples_shape",
    "vectors_shape", "charge_shape", "system_type", "neighbors_type",
])
def test_validation_errors_match_jax(box, case):
    calc_t = tat.EwaldCalculator(tpt.CoulombPotential(smearing=0.8), lr_wavelength=1.0)
    calc_j = jat.EwaldCalculator(tpme.CoulombPotential(smearing=0.8), lr_wavelength=1.0)
    with pytest.raises((ValueError, TypeError)) as err_j:
        calc_j(*_bad_inputs(_jax, box, case))
    with pytest.raises(err_j.type) as err_t:
        calc_t(*_bad_inputs(_port, box, case))
    assert str(err_t.value) == str(err_j.value).replace("torchpme_tpu.", "torchpme_tpu_torch.")


# -- metatensor converters: duck-typed stand-ins of metatomic's objects ---------


class _FakeLabels:
    def __init__(self, names, values):
        self.names = list(names)
        self.values = values


class _FakeBlock:
    def __init__(self, values, samples, components=(), properties=None):
        self.values = values
        self.samples = samples
        self.components = list(components)
        self.properties = properties


class _FakeTensorMap:
    def __init__(self, blocks):
        self._blocks = blocks

    def __len__(self):
        return len(self._blocks)

    def block(self):
        return self._blocks[0]


class _FakeMetatomicSystem:
    def __init__(self, types, positions, cell, data):
        self.types = types
        self.positions = positions
        self.cell = cell
        self._data = data

    def known_data(self):
        return list(self._data)

    def get_data(self, name):
        return self._data[name]


def _fake_mts_pair(box, wrap):
    """A (System, neighbors TensorBlock) pair shaped like metatomic's, its
    arrays made by ``wrap`` (numpy or torch)."""
    types, positions, cell, charges, samples, vectors = box
    charge_block = _FakeBlock(
        values=wrap(charges), samples=_FakeLabels(["atom"], wrap(np.arange(30).reshape(-1, 1))))
    system = _FakeMetatomicSystem(wrap(types), wrap(positions), wrap(cell),
                                  {"charge": _FakeTensorMap([charge_block])})
    nb = _FakeBlock(
        values=wrap(vectors[..., None]),
        samples=_FakeLabels(["first_atom", "second_atom", "cell_shift_a", "cell_shift_b",
                             "cell_shift_c"], wrap(samples)),
        components=[_FakeLabels(["xyz"], wrap(np.arange(3).reshape(-1, 1)))],
        properties=_FakeLabels(["distance"], wrap(np.zeros((1, 1), np.int32))),
    )
    return system, nb


@pytest.mark.parametrize("arrays", ["numpy", "torch"])
def test_convert_structural_roundtrip(box, arrays):
    """tests/test_atomistic.py:205-220 for the port: a metatomic-shaped
    system and neighbor block give the same labeled values as the port's own
    containers, and as the JAX package's converters."""
    wrap = np.asarray if arrays == "numpy" else torch.as_tensor
    mts_system, mts_nb = _fake_mts_pair(box, wrap)
    system = tat.system_from_metatensor(mts_system, device="cpu")
    neighbors = tat.neighborlist_from_metatensor(mts_nb, device="cpu")
    if arrays == "torch":  # tensors are taken as they are
        assert system.positions is mts_system.positions and neighbors.vectors is mts_nb.values
    calc = tat.EwaldCalculator(tpt.CoulombPotential(smearing=0.8), lr_wavelength=1.0)
    out = calc(system, neighbors)
    assert torch.equal(out.values, calc(*_port(box)).values)

    jax_system = jat.system_from_metatensor(_fake_mts_pair(box, np.asarray)[0])
    jax_nb = jat.neighborlist_from_metatensor(_fake_mts_pair(box, np.asarray)[1])
    calc_j = jat.EwaldCalculator(tpme.CoulombPotential(smearing=0.8), lr_wavelength=1.0)
    values_j = np.asarray(jax.jit(lambda: calc_j(jax_system, jax_nb).values)())
    np.testing.assert_allclose(out.values.numpy(), values_j, rtol=0,
                               atol=1e-10 * np.abs(values_j).max())


@pytest.mark.parametrize("case", ["missing_charge", "two_blocks", "components", "sample_names",
                                  "xyz"])
def test_convert_errors_match_jax(box, case):
    messages = []
    for conv in (jat, tat):
        mts_system, mts_nb = _fake_mts_pair(box, np.asarray)
        if case == "missing_charge":
            mts_system._data = {}
        elif case == "two_blocks":
            tmap = mts_system._data["charge"]
            tmap._blocks = tmap._blocks * 2
        elif case == "components":
            mts_system._data["charge"].block().components.append(
                _FakeLabels(["xyz"], np.arange(3).reshape(-1, 1)))
        elif case == "sample_names":
            mts_nb.samples.names = ["i", "j", "a", "b", "c"]
        else:
            mts_nb.components = [_FakeLabels(["abc"], np.arange(3).reshape(-1, 1))]
        kw = {} if conv is jat else {"device": "cpu"}
        with pytest.raises(ValueError) as err:
            if case in ("sample_names", "xyz"):
                conv.neighborlist_from_metatensor(mts_nb, **kw)
            else:
                conv.system_from_metatensor(mts_system, **kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_labeled_to_metatensor_needs_a_backend(box):
    out = tat.EwaldCalculator(tpt.CoulombPotential(smearing=0.8), lr_wavelength=1.0)(*_port(box))
    assert tat.metatensor_backend() == jat.metatensor_backend()
    if tat.metatensor_backend() is None:
        with pytest.raises(ImportError, match="metatensor"):
            tat.labeled_to_metatensor(out)
    with pytest.raises(ValueError, match="unknown metatensor backend"):
        tat.labeled_to_metatensor(out, backend="jax")


def test_real_metatensor_roundtrip(box):
    """Through real metatensor objects (skips where metatensor is absent)."""
    mts = pytest.importorskip("metatensor")
    out = tat.EwaldCalculator(tpt.CoulombPotential(smearing=0.8), lr_wavelength=1.0)(*_port(box))
    tmap = tat.labeled_to_metatensor(out, backend="numpy")
    assert isinstance(tmap, mts.TensorMap)
    block = tmap.block()
    assert list(block.samples.names) == ["system", "atom"]
    np.testing.assert_array_equal(np.asarray(block.values), out.values.numpy())
