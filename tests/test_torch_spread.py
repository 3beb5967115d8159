"""The module of kernels A and B (``ops/spread_fused.py``): the port's plain
aligned spread and its VJP ≡ the JAX package's Pallas kernels (interpret
mode) on the rows of an aligned MDFastPath, plus the wrapper contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import port_from_jax, random_box, rel

import torchpme_tpu as tpme
from torchpme_tpu.ops.math import inv3 as jax_inv3
from torchpme_tpu.ops.pallas.spread_fused import (
    aligned_tiled_density as jax_aligned_density,
)
from torchpme_tpu_torch.ops import spread_fused as sf

torch.set_num_threads(1)

NS = (32, 32, 32)

# (nodes, balance): nodes 5 with the default balance spills and widens the
# window (aligned_pad >= 1); nodes 4 exercises the even (floor) stencils
CASES = {"nodes5_spill_pad": (5, "auto"), "nodes4_unbalanced": (4, False)}


def _system(nodes, balance):
    pos, q, cell = random_box(400, 16.0, seed=3, lo=-1.0, hi=17.0)
    calc = tpme.PMECalculator(
        tpme.CoulombPotential(smearing=1.0), mesh_spacing=0.5,
        interpolation_nodes=nodes,
    )
    f32 = jnp.float32
    fp_j = tpme.MDFastPath.create(
        calc, jnp.asarray(pos, f32), jnp.asarray(cell, f32), 3.0, NS,
        mesh_impl="aligned", balance=balance,
    )
    rows = np.asarray(fp_j.bucket(jnp.asarray(pos, f32)))
    q_rows = np.zeros((fp_j.n_rows, 1), np.float32)
    q_rows[np.asarray(fp_j.row_of_atom)] = q
    inv = np.asarray(jax_inv3(jnp.asarray(cell, f32)))
    w = np.random.default_rng(11).normal(size=(1, *NS)).astype(np.float32)
    return fp_j, rows, q_rows, inv, w


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    nodes, balance = CASES[request.param]
    fp_j, rows, q_rows, inv, w = _system(nodes, balance)
    args = (NS, nodes, "Lagrange", fp_j.cell_grid)

    def loss_j(p, q, c):
        rho = jax_aligned_density(p, q, c, *args, pad_cells=fp_j.aligned_pad)
        return jnp.sum(rho * jnp.asarray(w)), rho

    (_, rho_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(rows), jnp.asarray(q_rows), jnp.asarray(inv)
    )
    return dict(
        fp_j=fp_j, rows=rows, q_rows=q_rows, inv=inv, w=w, args=args,
        rho_j=np.asarray(rho_j), g_j=[np.asarray(g) for g in g_j],
    )


def _port(case, plain=False):
    p = torch.tensor(case["rows"], requires_grad=True)
    q = torch.tensor(case["q_rows"], requires_grad=True)
    c = torch.tensor(case["inv"], requires_grad=True)
    rho = sf.aligned_tiled_density(
        p, q, c, *case["args"], pad_cells=case["fp_j"].aligned_pad, plain=plain
    )
    grads = torch.autograd.grad(torch.sum(rho * torch.tensor(case["w"])), (p, q, c))
    return rho.detach().numpy(), [g.numpy() for g in grads]


def test_case_geometry(case):
    fp_j = case["fp_j"]
    if fp_j.calc.interpolation_nodes == 5:
        assert fp_j.aligned_pad >= 1
        assert fp_j.clist.extra_index is not None, "no spill extras"
    else:
        assert fp_j.aligned_pad == 0


def test_density_matches_jax(case):
    rho, _ = _port(case)
    assert rho.dtype == np.float32
    np.testing.assert_allclose(rho, case["rho_j"], atol=1e-5)  # tests/ops/test_spread_fused.py:49


@pytest.mark.parametrize("arg", ["pos_rows", "q_rows", "inverse_cell"])
def test_density_vjp_matches_jax(case, arg):
    _, grads = _port(case)
    i = ["pos_rows", "q_rows", "inverse_cell"].index(arg)
    assert rel(grads[i], case["g_j"][i]) <= 1e-5


def test_plain_flag_is_the_cpu_path(case):
    rho_a, g_a = _port(case)
    rho_b, g_b = _port(case, plain=True)
    np.testing.assert_array_equal(rho_a, rho_b)
    for a, b in zip(g_a, g_b):
        np.testing.assert_array_equal(a, b)


def test_float64_plain_spread(case):
    """The plain twins take float64 too (the on-card reference path); the
    float32 density agrees with it to float32 roundoff."""
    p = torch.tensor(case["rows"], dtype=torch.float64)
    q = torch.tensor(case["q_rows"], dtype=torch.float64)
    c = torch.tensor(case["inv"], dtype=torch.float64)
    rho64 = sf.aligned_tiled_density(p, q, c, *case["args"], pad_cells=case["fp_j"].aligned_pad)
    assert rho64.dtype == torch.float64
    assert rel(case["rho_j"], rho64.numpy()) <= 1e-5


def _slots(case, dtype=torch.float32, device="cpu"):
    fp = port_from_jax(case["fp_j"])
    nx_c, ny_c, nz_c, cap = fp.cell_grid
    extent, lpad = sf.aligned_geometry(fp.calc.interpolation_nodes, fp.aligned_pad)
    geom = sf.SpreadGeometry(
        NS, fp.calc.interpolation_nodes, "Lagrange", extent, lpad, nx_c * ny_c, nz_c * cap
    )
    nb = geom.n_tiles * geom.slots_per_tile
    rel_t = torch.tensor(case["rows"][:nb] @ case["inv"] * np.asarray(NS, np.float32))
    q = torch.tensor(case["q_rows"][:nb])
    return rel_t.to(device=device, dtype=dtype), q.to(device=device, dtype=dtype), geom


def test_wrappers_take_plain_twin_on_cpu(case):
    rel_t, q, geom = _slots(case)
    np.testing.assert_array_equal(
        sf.fused_spread(rel_t, q, geom).numpy(), sf.spread_plain(rel_t, q, geom).numpy()
    )
    ct = torch.tensor(case["w"])
    for a, b in zip(
        sf.fused_spread_bwd(rel_t, q, ct, geom), sf.spread_plain_bwd(rel_t, q, ct, geom)
    ):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrappers_raise_off_cpu(case):
    """A tensor that is not on the CPU never takes the plain twin: the
    wrapper validates it for the kernel and raises on what it cannot take."""
    rel64, q64, geom = _slots(case, torch.float64, "meta")
    with pytest.raises(TypeError, match="float32"):
        sf.fused_spread(rel64, q64, geom)
    with pytest.raises(TypeError, match="float32"):
        sf.fused_spread_bwd(rel64, q64, torch.empty((1, *NS), device="meta"), geom)
    rel32, q32, geom = _slots(case, torch.float32, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        sf.fused_spread(rel32, q32, geom)


def test_spread_geometry_checks():
    p = torch.zeros((4 * 4 * 2 * 8, 3))
    q = torch.zeros((p.shape[0], 1))
    inv = torch.eye(3)
    with pytest.raises(ValueError, match="not aligned"):
        sf.aligned_tiled_density(p, q, inv, NS, 5, "Lagrange", (2, 4, 2, 8))
    with pytest.raises(ValueError, match="2-tile fold"):
        sf.aligned_tiled_density(p, q, inv, NS, 5, "Lagrange", (4, 4, 2, 8), pad_cells=2)
