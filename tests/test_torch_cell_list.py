"""The port's host-side cell list (numpy) ≡ the JAX package's, bit for bit,
plus the three repairs the port makes to it: one spill cost model, an
assertion for the unreachable capacity fallback, and ``balance`` validated
up front."""

import numpy as np
import pytest
import torch
from torch_port_common import clist_arrays, clustered_box, random_box

from torchpme_tpu.ops import rspace_cells as jax_rc
from torchpme_tpu_torch.ops import rspace_cells as port_rc

torch.set_num_threads(1)


def _systems():
    pos, _, cell = random_box(400, 16.0, seed=1)
    cpos, _, ccell = clustered_box(300, 16.0, seed=2)
    return {
        "plain": (pos, cell, 3.0, {}),
        "balanced": (pos, cell, 3.0, dict(balance=True)),
        "pinned_xy": (pos, cell, 3.0, dict(xy_cells=(4, 4))),
        "pinned_xy_capped": (
            pos, cell, 3.0, dict(xy_cells=(4, 4), balance=(0.5, 0.5, np.inf))
        ),
        "spilled": (cpos, ccell, 3.0, {}),
        "spilled_balanced": (cpos, ccell, 3.0, dict(balance=True)),
        "explicit_capacity_spill": (cpos, ccell, 3.0, dict(capacity=8, spill=True)),
        "spilled_pinned_xy": (cpos, ccell, 3.0, dict(xy_cells=(4, 4), balance=True)),
        "unwrapped_f32": (
            (pos * 1.1 - 0.8).astype(np.float32), cell.astype(np.float32), 3.0, {}
        ),
    }


SYSTEMS = _systems()


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_cell_list_bit_identical(name):
    pos, cell, cutoff, kw = SYSTEMS[name]
    ref = jax_rc.compute_cell_list(pos, cell, cutoff, **kw)
    got = port_rc.compute_cell_list(pos, cell, cutoff, **kw, device="cpu")
    ref_a, got_a = clist_arrays(ref), clist_arrays(got)
    for field, r in ref_a.items():
        g = got_a[field]
        if r is None:
            assert g is None, field
            continue
        assert g.dtype == r.dtype, field
        np.testing.assert_array_equal(g, r, err_msg=field)
    assert got.n_axis == ref.n_axis
    assert got.cutoff == ref.cutoff
    assert got.slack == ref.slack  # exact float equality
    if name.startswith("spilled") or name.startswith("explicit"):
        assert got.extra_index is not None, "system did not spill"


def test_cell_list_device_tensors():
    pos, cell, cutoff, _ = SYSTEMS["spilled"]
    got = port_rc.compute_cell_list(pos, cell, cutoff, device="cpu")
    assert isinstance(got.atom_index, torch.Tensor)
    assert got.atom_index.dtype == torch.int32
    assert got.slot_mask.dtype == torch.bool
    assert got.atom_wrap.dtype == torch.int8
    assert got.extra_cell.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_spill_cost_model(seed):
    """Both capacity choosers score with the one ``_spill_cost`` helper,
    which reproduces the JAX package's (duplicated) cost expression."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(14.0, size=500)
    counts[:3] += 30  # a few overfull cells
    n_cells = counts.shape[0]
    caps = range(8, port_rc._cap_max(counts) + 8, 8)
    costs = [
        port_rc._spill_cost(n_cells, c, int(np.maximum(0, counts - c).sum()))
        for c in caps
    ]
    best = list(caps)[int(np.argmin(costs))]
    assert port_rc._choose_capacity(counts, n_cells) == best
    assert jax_rc._choose_capacity(counts, n_cells) == best


def test_balanced_unspilled_capacity_terminates():
    """Balance without spill on a cluster balancing cannot absorb: the
    capacity search settles on the fullest cell's capacity (the JAX
    package's unreachable ``for/else`` is an assertion in the port)."""
    pos, cell = SYSTEMS["spilled"][0], SYSTEMS["spilled"][1]
    kw = dict(balance=True, spill=False)
    ref = jax_rc.compute_cell_list(pos, cell, 3.0, **kw)
    got = port_rc.compute_cell_list(pos, cell, 3.0, **kw, device="cpu")
    assert got.slot_mask.shape == ref.slot_mask.shape
    np.testing.assert_array_equal(got.atom_index.numpy(), np.asarray(ref.atom_index))
    assert got.extra_index is None
    counts = got.slot_mask.numpy().sum(axis=1)
    assert got.slot_mask.shape[1] == port_rc._cap_max(counts)


@pytest.mark.parametrize(
    "bad", ["auto", "yes", (1.0, 2.0), (1.0, "a", 2.0), 1, None]
)
def test_balance_validated_up_front(bad):
    pos, cell, cutoff, _ = SYSTEMS["plain"]
    with pytest.raises(ValueError, match="`balance`"):
        port_rc.compute_cell_list(pos, cell, cutoff, balance=bad, device="cpu")


def test_cell_list_errors_match_jax():
    pos, cell, _, _ = SYSTEMS["plain"]
    for kw, match in (
        (dict(cutoff=20.0), "cutoff"),
        (dict(cutoff=3.0, xy_cells=(8, 8)), "xy_cells"),
        (dict(cutoff=3.0, capacity=1), "capacity"),
        (dict(cutoff=9.0, spill=True), "spill"),
    ):
        with pytest.raises(ValueError, match=match):
            port_rc.compute_cell_list(pos, cell, **kw, device="cpu")
        with pytest.raises(ValueError, match=match):
            jax_rc.compute_cell_list(pos, cell, **kw)
