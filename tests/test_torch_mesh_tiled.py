"""The port's tile bucketing and the plain versions of kernels D, E, F ≡ the
JAX package's tiled mesh backend: bucketing arrays, the refresh and its
validity flag, spread / gather against ``impl="xla"`` (float64) and against
the Pallas kernels in interpret mode (float32), the backward pass against
``jax.grad``, and tiled ≡ scatter inside the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import TILED_FIELDS, jax_tiled_state

from torchpme_tpu.ops import mesh_tiled as jmt
from torchpme_tpu_torch.convert import tiled_interp_from_state, tiled_interp_state
from torchpme_tpu_torch.ops import mesh as tm
from torchpme_tpu_torch.ops import mesh_kernels as mk
from torchpme_tpu_torch.ops import mesh_tiled as mt

torch.set_num_threads(1)

CELL = np.diag([5.0, 5.0, 20.0])
SHAPES = [(1, 128), (3, 128), (2, 96)]  # (channels, nz) of tests/ops/test_mesh_pallas.py


def make_system(n_atoms, n_channels=1, seed=0):
    rng = np.random.default_rng(seed)
    positions = rng.uniform(0, 1, (n_atoms, 3)) @ CELL
    return positions, rng.normal(size=(n_atoms, n_channels))


def both_interps(positions, ns, nodes, dtype, capacity=None):
    """(JAX bucketing, port bucketing) of the same positions."""
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    inv = np.linalg.inv(CELL)
    interp_j = jmt.compute_tiled_interpolation(
        jnp.asarray(positions, jdt), jnp.asarray(inv, jdt), ns, nodes, "Lagrange",
        capacity=capacity,
    )
    interp_t = mt.compute_tiled_interpolation(
        torch.tensor(positions, dtype=tdt), torch.tensor(inv, dtype=tdt), ns, nodes,
        "Lagrange", capacity=capacity,
    )
    return interp_j, interp_t


def assert_same_bucketing(interp_t, interp_j, weight_tol=1e-12):
    ours, theirs = tiled_interp_state(interp_t), jax_tiled_state(interp_j)
    assert ours["ns"] == theirs["ns"] and ours["nodes"] == theirs["nodes"]
    for name in TILED_FIELDS:
        if name == "weights":
            np.testing.assert_allclose(ours[name], theirs[name], rtol=0, atol=weight_tol)
        else:
            np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
            assert ours[name].dtype == np.int32, name


@pytest.mark.parametrize("nodes", [3, 4, 5, 6])
@pytest.mark.parametrize("capacity", [None, 24, 8], ids=["auto", "cap24", "overflow"])
def test_compute_tiled_interpolation_matches_jax(nodes, capacity):
    positions, _ = make_system(60)
    interp_j, interp_t = both_interps(positions, (16, 16, 32), nodes, "f64", capacity)
    assert_same_bucketing(interp_t, interp_j)
    assert (int(interp_t.dropped) > 0) == (capacity == 8)
    if capacity is None:
        assert interp_t.local_x.shape[1] == 64  # max occupancy + 8, rounded up to 64


@pytest.mark.parametrize("nodes", [4, 5])
def test_refresh_matches_jax_and_flags_stale_buckets(nodes):
    positions, _ = make_system(60, seed=2)
    ns = (16, 16, 32)
    interp_j, interp_t = both_interps(positions, ns, nodes, "f64")
    inv = np.linalg.inv(CELL)
    rng = np.random.default_rng(5)
    # a move that keeps every stencil start inside its tile's window: half
    # of the room to the nearer mesh plane
    frac = positions @ inv * np.asarray(ns)
    offset = frac - (np.floor(frac) if nodes % 2 == 0 else np.round(frac) - 0.5)
    room = np.minimum(offset, 1 - offset) * 0.5
    small = positions + (rng.uniform(-1, 1, positions.shape) * room / np.asarray(ns)) @ CELL
    new_j, ok_j = jmt.refresh_tiled_interpolation(
        interp_j, jnp.asarray(small), jnp.asarray(inv), "Lagrange"
    )
    new_t, ok_t = mt.refresh_tiled_interpolation(
        interp_t, torch.tensor(small), torch.tensor(inv), "Lagrange"
    )
    assert bool(ok_j) and bool(ok_t)
    assert_same_bucketing(new_t, new_j)
    assert float((new_t.weights - interp_t.weights).abs().max()) > 1e-3

    large = positions.copy()
    large[7, 0] += CELL[0, 0] / 2
    new_j, ok_j = jmt.refresh_tiled_interpolation(
        interp_j, jnp.asarray(large), jnp.asarray(inv), "Lagrange"
    )
    new_t, ok_t = mt.refresh_tiled_interpolation(
        interp_t, torch.tensor(large), torch.tensor(inv), "Lagrange"
    )
    assert not bool(ok_j) and not bool(ok_t)
    assert_same_bucketing(new_t, new_j)


def test_refresh_needs_bucket_indices_and_reports_overflow():
    positions, _ = make_system(60)
    _, interp_t = both_interps(positions, (16, 16, 32), 4, "f64", capacity=8)
    inv = torch.tensor(np.linalg.inv(CELL))
    _, ok = mt.refresh_tiled_interpolation(interp_t, torch.tensor(positions), inv, "Lagrange")
    assert not bool(ok)  # built with overflow
    with pytest.raises(ValueError, match="bucket->atom"):
        mt.refresh_tiled_interpolation(
            mt.replace(interp_t, atom_of_slot=None), torch.tensor(positions), inv, "Lagrange"
        )


@pytest.mark.parametrize("nodes", [3, 4, 5])
@pytest.mark.parametrize("n_channels,nz", SHAPES)
def test_plain_spread_and_gather_match_jax_xla_f64(nodes, n_channels, nz):
    ns = (16, 16, nz)
    positions, charges = make_system(60, n_channels)
    interp_j, _ = both_interps(positions, ns, nodes, "f64")
    interp_t = tiled_interp_from_state(jax_tiled_state(interp_j), device="cpu")
    rho_j = np.asarray(jmt.tiled_points_to_mesh(interp_j, jnp.asarray(charges), impl="xla"))
    rho_t = mt.tiled_points_to_mesh(interp_t, torch.tensor(charges))
    np.testing.assert_allclose(rho_t.numpy(), rho_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        mt.tiled_points_to_mesh(interp_t, torch.tensor(charges), plain=True).numpy(),
        rho_j, rtol=0, atol=1e-12,
    )
    field = np.random.default_rng(1).normal(size=rho_j.shape)
    back_j = np.asarray(jmt.tiled_mesh_to_points(interp_j, jnp.asarray(field), impl="xla"))
    back_t = mt.tiled_mesh_to_points(interp_t, torch.tensor(field))
    np.testing.assert_allclose(back_t.numpy(), back_j, rtol=0, atol=1e-12)


@pytest.mark.parametrize("nodes", [3, 4, 5])
@pytest.mark.parametrize("n_channels,nz", SHAPES)
def test_plain_spread_and_gather_match_jax_pallas_f32(nodes, n_channels, nz):
    """Against the TPU kernels themselves (interpret mode), float32, at the
    tolerance the JAX package holds them to (atol 1e-6)."""
    ns = (16, 16, nz)
    positions, charges = make_system(60, n_channels)
    interp_j, interp_t = both_interps(positions, ns, nodes, "f32")
    assert_same_bucketing(interp_t, interp_j, weight_tol=1e-6)
    q32 = charges.astype(np.float32)
    rho_j = np.asarray(jmt.tiled_points_to_mesh(interp_j, jnp.asarray(q32), impl="pallas"))
    rho_t = mt.tiled_points_to_mesh(interp_t, torch.tensor(q32))
    assert rho_t.dtype == torch.float32
    np.testing.assert_allclose(rho_t.numpy(), rho_j, rtol=0, atol=1e-6)
    field = np.random.default_rng(1).normal(size=rho_j.shape).astype(np.float32)
    back_j = np.asarray(jmt.tiled_mesh_to_points(interp_j, jnp.asarray(field), impl="pallas"))
    back_t = mt.tiled_mesh_to_points(interp_t, torch.tensor(field))
    np.testing.assert_allclose(back_t.numpy(), back_j, rtol=0, atol=1e-6)


def _jax_loss(impl, inv, ns, nodes):
    """The JAX package's loss; its gradient is taken under ``jax.jit``: one
    compile of the whole graph instead of one per operation (~5x faster)."""

    def loss(positions, charges):  # tests/ops/test_mesh_pallas.py:55-62
        interp = jmt.compute_tiled_interpolation(positions, inv, ns, nodes, "Lagrange")
        rho = jmt.tiled_points_to_mesh(interp, charges, impl=impl)
        back = jmt.tiled_mesh_to_points(interp, rho * 1.5, impl=impl)
        return jnp.sum(rho**2) + jnp.sum(back * charges)

    return loss


def _port_loss_grads(positions, charges, ns, nodes, dtype):
    p = torch.tensor(positions, dtype=dtype, requires_grad=True)
    q = torch.tensor(charges, dtype=dtype, requires_grad=True)
    inv = torch.tensor(np.linalg.inv(CELL), dtype=dtype)
    interp = mt.compute_tiled_interpolation(p, inv, ns, nodes, "Lagrange")
    rho = mt.tiled_points_to_mesh(interp, q)
    back = mt.tiled_mesh_to_points(interp, rho * 1.5)
    return torch.autograd.grad(torch.sum(rho**2) + torch.sum(back * q), (p, q))


@pytest.mark.parametrize("nodes", [3, 4, 5])
@pytest.mark.parametrize("n_channels,nz", SHAPES)
def test_plain_backward_matches_jax_grad_f64(nodes, n_channels, nz):
    """The custom backward (D ↔ E as each other's transpose, F for the
    weights) against jax.grad through the XLA tile GEMMs."""
    ns = (16, 16, nz)
    positions, charges = make_system(48, n_channels)
    inv = jnp.asarray(np.linalg.inv(CELL))
    g_j = jax.jit(jax.grad(_jax_loss("xla", inv, ns, nodes), argnums=(0, 1)))(
        jnp.asarray(positions), jnp.asarray(charges)
    )
    g_t = _port_loss_grads(positions, charges, ns, nodes, torch.float64)
    for ours, theirs in zip(g_t, g_j):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-12 * np.abs(theirs).max())


@pytest.mark.parametrize("n_channels,nz", [(1, 128), (2, 96)])
def test_plain_backward_matches_jax_pallas_vjp_f32(n_channels, nz):
    """Against the custom VJP of the TPU kernels (interpret mode), at the
    bars of tests/ops/test_mesh_pallas.py:66-68."""
    ns, nodes = (16, 16, nz), 5
    positions, charges = make_system(48, n_channels)
    p32, q32 = positions.astype(np.float32), charges.astype(np.float32)
    inv = jnp.asarray(np.linalg.inv(CELL), jnp.float32)
    g_j = jax.jit(jax.grad(_jax_loss("pallas", inv, ns, nodes), argnums=(0, 1)))(
        jnp.asarray(p32), jnp.asarray(q32)
    )
    g_t = _port_loss_grads(p32, q32, ns, nodes, torch.float32)
    scale = float(np.abs(np.asarray(g_j[0])).max())
    np.testing.assert_allclose(g_t[0].numpy(), np.asarray(g_j[0]), rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(g_t[1].numpy(), np.asarray(g_j[1]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("nodes", [3, 4, 5])
def test_wgrad_plain_is_the_weight_gradient_of_the_trilinear_form(nodes):
    """Kernel F's plain version ≡ autograd of S = Σ q · gather(w, F) with
    respect to the weights, and D / E are transposes: <D q, F> = <q, E F>."""
    ns = (16, 16, 32)
    positions, charges = make_system(60, 2, seed=4)
    _, interp = both_interps(positions, ns, nodes, "f64")
    q_slots = mt._slot_values(interp, torch.tensor(charges))
    field = torch.tensor(np.random.default_rng(3).normal(size=(2, *ns)))
    args = (interp.local_x, interp.local_y, interp.start_z)
    w = interp.weights.clone().requires_grad_()
    s = torch.sum(mk.mesh_gather_plain(*args, w, field, ns, nodes) * q_slots)
    (g_auto,) = torch.autograd.grad(s, w)
    g_plain = mk.mesh_wgrad_plain(*args, interp.weights, q_slots, field, ns, nodes)
    np.testing.assert_allclose(g_plain.numpy(), g_auto.numpy(), rtol=0, atol=1e-12)
    spread = mk.mesh_spread_plain(*args, interp.weights, q_slots, ns, nodes)
    s = float(s.detach())
    assert abs(float(torch.sum(spread * field)) - s) <= 1e-12 * abs(s)
    both = mk.mesh_gather_wgrad(*args, interp.weights, q_slots, field, ns, nodes)
    np.testing.assert_array_equal(both[1].numpy(), g_plain.numpy())


@pytest.mark.parametrize("nodes", [3, 4, 5, 6, 7])
def test_tiled_equals_scatter_in_the_port(nodes):
    ns = (16, 32, 24)
    positions, charges = make_system(80, 2, seed=6)
    inv = torch.tensor(np.linalg.inv(CELL))
    pos_t, q_t = torch.tensor(positions), torch.tensor(charges)
    tiled = mt.compute_tiled_interpolation(pos_t, inv, ns, nodes, "Lagrange")
    scatter = tm.compute_interpolation(pos_t, inv, ns, nodes, "Lagrange")
    rho = tm.points_to_mesh(scatter, q_t)
    np.testing.assert_allclose(
        mt.tiled_points_to_mesh(tiled, q_t).numpy(), rho.numpy(), rtol=0, atol=1e-13
    )
    field = torch.tensor(np.random.default_rng(8).normal(size=tuple(rho.shape)))
    np.testing.assert_allclose(
        mt.tiled_mesh_to_points(tiled, field).numpy(),
        tm.mesh_to_points(scatter, field).numpy(), rtol=0, atol=1e-13,
    )


@pytest.mark.parametrize("nodes", [3, 4, 5])
def test_mesh_to_points_matches_jax(nodes):
    from torchpme_tpu.ops import mesh as jm

    ns = (12, 10, 14)
    positions, _ = make_system(40, seed=9)
    inv = np.linalg.inv(CELL)
    field = np.random.default_rng(2).normal(size=(2, *ns))
    interp_j = jm.compute_interpolation(jnp.asarray(positions), jnp.asarray(inv), ns, nodes, "Lagrange")
    interp_t = tm.compute_interpolation(torch.tensor(positions), torch.tensor(inv), ns, nodes, "Lagrange")
    np.testing.assert_allclose(
        tm.mesh_to_points(interp_t, torch.tensor(field)).numpy(),
        np.asarray(jm.mesh_to_points(interp_j, jnp.asarray(field))), rtol=0, atol=1e-12,
    )
    with pytest.raises(ValueError, match="dimension 4"):
        tm.mesh_to_points(interp_t, torch.tensor(field[0]))


def test_tiled_state_round_trip_and_supports_tiling():
    positions, _ = make_system(60)
    interp_j, interp_t = both_interps(positions, (16, 16, 32), 4, "f64")
    back = tiled_interp_from_state(tiled_interp_state(interp_t), device="cpu")
    assert_same_bucketing(back, interp_j)
    assert back.weights.dtype == torch.float64
    for ns, nodes in (((16, 16, 8), 4), ((24, 16, 8), 4), ((16, 16, 8), 10), ((8, 16, 8), 3)):
        assert mt.supports_tiling(ns, nodes) == jmt.supports_tiling(ns, nodes)
