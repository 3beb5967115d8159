"""The dipolar mesh stencils of the port ≡ the JAX package's: the weight
derivatives, the gradient-stencil scatter spread and gather
(``ops/mesh.py``), the ``derivatives=`` option of the tile bucketing and its
refresh, and the tiled dipolar spread and gather (``ops/mesh_tiled.py``,
which go through the plain versions of kernels D, E, F on the CPU), values
and gradients; and tiled ≡ scatter inside the port.

float64 throughout, 1e-12 absolute on O(1) values: both packages evaluate the
same polynomials, in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_tiled_state

from torchpme_tpu.ops import mesh as jm
from torchpme_tpu.ops import mesh_tiled as jmt
from torchpme_tpu_torch.convert import tiled_interp_from_state, tiled_interp_state
from torchpme_tpu_torch.ops import mesh as tm
from torchpme_tpu_torch.ops import mesh_tiled as mt

torch.set_num_threads(1)

CELL = np.asarray([[6.0, 0.0, 0.0], [0.8, 5.5, 0.0], [0.3, -0.6, 9.0]])
INV = np.linalg.inv(CELL)
NS = (16, 16, 32)
ATOL = 1e-12


def make_system(n_atoms=70, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n_atoms, 3)) @ CELL, rng.normal(size=(n_atoms, 3))


@pytest.mark.parametrize("nodes", [3, 4, 5, 6, 7])
def test_weight_derivatives_match_jax_and_autograd(nodes):
    x = np.linspace(-0.5, 0.5, 41)
    ref = np.asarray(jm.compute_1d_weight_derivatives(jnp.asarray(x), nodes, "Lagrange"))
    xt = torch.tensor(x, requires_grad=True)
    got = tm.compute_1d_weight_derivatives(xt, nodes, "Lagrange")
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=ATOL)
    w = tm.compute_1d_weights(xt, nodes, "Lagrange")
    for node in range(nodes):
        (auto,) = torch.autograd.grad(w[node].sum(), xt, retain_graph=True)
        np.testing.assert_allclose(got[node].detach().numpy(), auto.numpy(), rtol=0, atol=1e-11)


@pytest.mark.parametrize("nodes", [4, 5, 6])
def test_dipole_interpolation_spread_and_gather_match_jax(nodes):
    positions, dipoles = make_system()
    interp_j = jm.compute_dipole_interpolation(
        jnp.asarray(positions), jnp.asarray(INV), NS, nodes, "Lagrange"
    )
    interp_t = tm.compute_dipole_interpolation(
        torch.tensor(positions), torch.tensor(INV), NS, nodes, "Lagrange"
    )
    np.testing.assert_array_equal(
        interp_t.linear_indices.numpy(), np.asarray(interp_j.linear_indices)
    )
    np.testing.assert_allclose(
        interp_t.grad_weights.numpy(), np.asarray(interp_j.grad_weights), rtol=0, atol=ATOL
    )
    q_j = np.asarray(jm.dipoles_to_mesh(interp_j, jnp.asarray(dipoles)))
    q_t = tm.dipoles_to_mesh(interp_t, torch.tensor(dipoles))
    assert q_t.shape == (1, *NS)
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=ATOL)
    field = np.random.default_rng(1).normal(size=q_j.shape)
    g_j = np.asarray(jm.mesh_to_dipole_field(interp_j, jnp.asarray(field)))
    g_t = tm.mesh_to_dipole_field(interp_t, torch.tensor(field))
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=ATOL)
    # spread and gather are transposes: Σ_i μ_i·g_i == Σ_m Q·mesh
    assert float((g_t * torch.tensor(dipoles)).sum()) == pytest.approx(
        float((q_t * torch.tensor(field)).sum()), rel=1e-12
    )


def _both_tiled(positions, nodes, capacity=None):
    interp_j = jmt.compute_tiled_interpolation(
        jnp.asarray(positions), jnp.asarray(INV), NS, nodes, "Lagrange",
        capacity=capacity, derivatives=True,
    )
    interp_t = mt.compute_tiled_interpolation(
        torch.tensor(positions), torch.tensor(INV), NS, nodes, "Lagrange",
        capacity=capacity, derivatives=True,
    )
    return interp_j, interp_t


@pytest.mark.parametrize("nodes", [4, 6])
def test_tile_bucketing_with_derivatives_matches_jax(nodes):
    positions, _ = make_system()
    interp_j, interp_t = _both_tiled(positions, nodes)
    ours, theirs = tiled_interp_state(interp_t), jax_tiled_state(interp_j)
    assert ours["dweights"].shape == ours["weights"].shape
    for name in ("weights", "dweights"):
        np.testing.assert_allclose(ours[name], theirs[name], rtol=0, atol=ATOL)
    for name in ("local_x", "local_y", "start_z", "slot_of_atom", "atom_of_slot"):
        np.testing.assert_array_equal(ours[name], theirs[name])
    # without the option the field stays empty, and the refresh keeps it so
    plain_t = mt.compute_tiled_interpolation(
        torch.tensor(positions), torch.tensor(INV), NS, nodes, "Lagrange"
    )
    assert plain_t.dweights is None
    refreshed, _ = mt.refresh_tiled_interpolation(
        plain_t, torch.tensor(positions), torch.tensor(INV), "Lagrange"
    )
    assert refreshed.dweights is None
    with pytest.raises(ValueError, match="derivatives=True"):
        mt.tiled_dipoles_to_mesh(plain_t, torch.tensor(positions))
    # the numpy state round-trips the derivative field
    back = tiled_interp_from_state(ours, device="cpu")
    np.testing.assert_array_equal(back.dweights.numpy(), ours["dweights"])


@pytest.mark.parametrize("nodes", [4, 6])
def test_refresh_keeps_derivatives_and_matches_jax(nodes):
    positions, _ = make_system(seed=2)
    interp_j, interp_t = _both_tiled(positions, nodes)
    moved = positions + 0.01 * np.random.default_rng(3).normal(size=positions.shape)
    new_j, ok_j = jmt.refresh_tiled_interpolation(
        interp_j, jnp.asarray(moved), jnp.asarray(INV), "Lagrange"
    )
    new_t, ok_t = mt.refresh_tiled_interpolation(
        interp_t, torch.tensor(moved), torch.tensor(INV), "Lagrange"
    )
    assert bool(ok_j) == bool(ok_t)
    np.testing.assert_allclose(
        new_t.dweights.numpy(), np.asarray(new_j.dweights), rtol=0, atol=ATOL
    )
    assert float((new_t.dweights - interp_t.dweights).abs().max()) > 1e-4
    empty = new_t.atom_of_slot == positions.shape[0]
    assert float(new_t.dweights[empty].abs().max()) == 0.0


@pytest.mark.parametrize("nodes", [4, 5, 6])
def test_tiled_dipole_spread_and_gather_match_jax_and_scatter(nodes):
    positions, dipoles = make_system(seed=4)
    interp_j, _ = _both_tiled(positions, nodes)
    interp_t = tiled_interp_from_state(jax_tiled_state(interp_j), device="cpu")
    nu = (dipoles @ INV) * np.asarray(NS)
    q_j = np.asarray(jmt.tiled_dipoles_to_mesh(interp_j, jnp.asarray(nu)))
    q_t = mt.tiled_dipoles_to_mesh(interp_t, torch.tensor(nu))
    assert q_t.shape == (1, *NS)
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        mt.tiled_dipoles_to_mesh(interp_t, torch.tensor(nu), plain=True).numpy(), q_t.numpy()
    )
    field = np.random.default_rng(5).normal(size=q_j.shape)
    e_j = np.asarray(jmt.tiled_mesh_to_dipole_field(interp_j, jnp.asarray(field)))
    e_t = mt.tiled_mesh_to_dipole_field(interp_t, torch.tensor(field))
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=0, atol=ATOL)

    # tiled ≡ scatter: the same density, and the same Cartesian field after
    # the chain e_rel → (e_rel · ns) @ C⁻ᵀ
    scatter = tm.compute_dipole_interpolation(
        torch.tensor(positions), torch.tensor(INV), NS, nodes, "Lagrange"
    )
    np.testing.assert_allclose(
        tm.dipoles_to_mesh(scatter, torch.tensor(dipoles)).numpy(), q_t.numpy(),
        rtol=0, atol=ATOL,
    )
    cart = torch.einsum(
        "na,ba,a->nb", e_t, torch.tensor(INV), torch.tensor(NS, dtype=torch.float64)
    )
    np.testing.assert_allclose(
        cart.numpy(), tm.mesh_to_dipole_field(scatter, torch.tensor(field)).numpy(),
        rtol=0, atol=1e-11,
    )


@pytest.mark.parametrize("nodes", [4, 6])
def test_tiled_dipole_gradients_match_jax(nodes):
    """d/d(positions, ν, mesh) of a scalar of the refreshed spread + gather:
    the position gradient flows through ``weights`` and ``dweights`` and the
    VJPs of the tile kernels (their plain versions here)."""
    positions, dipoles = make_system(seed=6)
    interp_j, _ = _both_tiled(positions, nodes)
    interp_t = tiled_interp_from_state(jax_tiled_state(interp_j), device="cpu")
    nu = (dipoles @ INV) * np.asarray(NS)
    rng = np.random.default_rng(7)
    ct_mesh = rng.normal(size=(1, *NS))
    field = rng.normal(size=(1, *NS))
    ct_e = rng.normal(size=nu.shape)

    def loss_j(pos, nu_, fld):
        it, _ = jmt.refresh_tiled_interpolation(interp_j, pos, jnp.asarray(INV), "Lagrange")
        return jnp.sum(jmt.tiled_dipoles_to_mesh(it, nu_) * ct_mesh) + jnp.sum(
            jmt.tiled_mesh_to_dipole_field(it, fld) * ct_e
        )

    ref = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(
        jnp.asarray(positions), jnp.asarray(nu), jnp.asarray(field)
    )
    args = [torch.tensor(a, requires_grad=True) for a in (positions, nu, field)]
    it, _ = mt.refresh_tiled_interpolation(interp_t, args[0], torch.tensor(INV), "Lagrange")
    loss = (mt.tiled_dipoles_to_mesh(it, args[1]) * torch.tensor(ct_mesh)).sum() + (
        mt.tiled_mesh_to_dipole_field(it, args[2]) * torch.tensor(ct_e)
    ).sum()
    got = torch.autograd.grad(loss, args)
    for a, b in zip(got, ref):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale, rtol=0, atol=1e-11)
