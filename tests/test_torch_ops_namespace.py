"""The port's namespaces against the JAX package's: ``ops`` exports what
it has ported, and ``tuning``, ``atomistic`` and ``utils.neighbors`` export
the same names; the dense-format distances of ``utils.neighbors`` hold to
the JAX package's in float64."""

import importlib
import pkgutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torchpme_tpu.ops as jax_ops
import torchpme_tpu.utils.neighbors as jax_neighbors
import torchpme_tpu_torch.ops as port_ops
import torchpme_tpu_torch.utils.neighbors as port_neighbors
from torchpme_tpu_torch.utils.neighbors import dense_neighbor_format, neighbor_list

sys.path.append(str(Path(__file__).parent))
from torch_port_common import random_box


def _port_definitions() -> set[str]:
    """Public names defined in any module of the port's ``ops`` package."""
    names = set()
    for info in pkgutil.iter_modules(port_ops.__path__, prefix="torchpme_tpu_torch.ops."):
        module = importlib.import_module(info.name)
        names.update(n for n in vars(module) if not n.startswith("_"))
    return names


def test_ops_exports_every_ported_name_of_the_jax_namespace():
    ported = set(jax_ops.__all__) & _port_definitions()
    assert {"cell_list_rspace_energy", "MeshInterpolationWeights"} <= ported
    # the scalar math and the spline tier (ops/math.py, ops/splines.py)
    assert {"exp1", "CustomExp1", "gamma", "gammainc_over_powerlaw", "gammaincc_over_powerlaw",
            "CubicSpline", "CubicSplineReciprocal", "compute_spline_ft",
            "compute_second_derivatives", "solve_tridiagonal"} <= ported
    missing = sorted(ported - set(port_ops.__all__))
    assert not missing, f"defined by the port but not exported from its ops: {missing}"


def test_ops_exports_resolve():
    for name in port_ops.__all__:
        assert getattr(port_ops, name) is not None, name


@pytest.mark.parametrize("module", ["tuning", "atomistic", "utils.neighbors"])
def test_namespace_equals_the_jax_one(module):
    port = importlib.import_module(f"torchpme_tpu_torch.{module}")
    jax_module = importlib.import_module(f"torchpme_tpu.{module}")
    assert sorted(port.__all__) == sorted(jax_module.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def _dense_inputs(seed, with_cell):
    positions, _, cell = random_box(24, 6.0, seed)
    idx, dist, shifts = neighbor_list(positions, cell, cutoff=2.5)
    dense = dense_neighbor_format(idx, dist, 24, neighbor_shifts=shifts)
    weights = np.random.default_rng(seed + 1).normal(size=dense["mask"].shape)
    # a pair-symmetric cotangent: the same weight on (i, j, S) and (j, i, -S)
    pairs = {}
    for i in range(24):
        for s in np.flatnonzero(dense["mask"][i]):
            key = (min(i, dense["indices"][i, s]), max(i, dense["indices"][i, s]),
                   tuple(dense["shifts"][i, s] * (1 if i <= dense["indices"][i, s] else -1)))
            weights[i, s] = pairs.setdefault(key, weights[i, s])
    weights = np.where(dense["mask"], weights, 0.0)
    extra = (cell, dense["shifts"]) if with_cell else (None, None)
    return positions, dense["indices"], weights, extra


@pytest.mark.parametrize("with_cell", [True, False])
@pytest.mark.parametrize("name", ["compute_distances_dense", "compute_distances_dense_symmetric"])
def test_dense_distances_match_jax(name, with_cell):
    """Values and gradients (positions, cell) of the dense-format distances
    against the JAX package's, float64, with a pair-symmetric cotangent (the
    condition of the symmetric form's backward)."""
    import jax
    import jax.numpy as jnp

    positions, idx, weights, (cell, shifts) = _dense_inputs(5, with_cell)

    def jax_loss(p, c):
        d = getattr(jax_neighbors, name)(p, jnp.asarray(idx), c,
                                         None if shifts is None else jnp.asarray(shifts))
        return jnp.sum(jnp.asarray(weights) * d**2), d

    j_cell = None if cell is None else jnp.asarray(cell)
    (_, d_j), grads_j = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(positions), j_cell)

    p_t = torch.tensor(positions, requires_grad=True)
    c_t = None if cell is None else torch.tensor(cell, requires_grad=True)
    d_t = getattr(port_neighbors, name)(p_t, torch.as_tensor(idx), c_t,
                                        None if shifts is None else torch.as_tensor(shifts))
    leaves = [p_t] if c_t is None else [p_t, c_t]
    grads_t = torch.autograd.grad(torch.sum(torch.as_tensor(weights) * d_t**2), leaves)
    np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j), rtol=1e-12, atol=0)
    for g_t, g_j in zip(grads_t, grads_j):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                                   atol=1e-10 * np.abs(np.asarray(g_j)).max())


def test_dense_distances_need_cell_and_shifts_together():
    positions, idx, _, (cell, shifts) = _dense_inputs(5, True)
    p, i = torch.as_tensor(positions), torch.as_tensor(idx)
    with pytest.raises(ValueError, match="together"):
        port_neighbors.compute_distances_dense_symmetric(p, i, torch.as_tensor(cell))
    with pytest.raises(ValueError, match="Provided `cell` but no `neighbor_shifts`"):
        port_neighbors.compute_distances_dense(p, i, torch.as_tensor(cell))
    with pytest.raises(ValueError, match="Provided `neighbor_shifts` but no `cell`"):
        port_neighbors.compute_distances_dense(p, i, None, torch.as_tensor(shifts))
