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
from torchpme_tpu_torch.ops import mesh_kernels as mk
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
    # the JAX package's calls under jax.jit: one compile each, not one per
    # operation
    interp_j = jax.jit(jm.compute_dipole_interpolation, static_argnums=(2, 3, 4))(
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
    q_j = np.asarray(jax.jit(jm.dipoles_to_mesh)(interp_j, jnp.asarray(dipoles)))
    q_t = tm.dipoles_to_mesh(interp_t, torch.tensor(dipoles))
    assert q_t.shape == (1, *NS)
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=ATOL)
    field = np.random.default_rng(1).normal(size=q_j.shape)
    g_j = np.asarray(jax.jit(jm.mesh_to_dipole_field)(interp_j, jnp.asarray(field)))
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
    new_j, ok_j = jax.jit(jmt.refresh_tiled_interpolation, static_argnums=(3,))(
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
    q_j = np.asarray(jax.jit(jmt.tiled_dipoles_to_mesh)(interp_j, jnp.asarray(nu)))
    q_t = mt.tiled_dipoles_to_mesh(interp_t, torch.tensor(nu))
    assert q_t.shape == (1, *NS)
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        mt.tiled_dipoles_to_mesh(interp_t, torch.tensor(nu), plain=True).numpy(), q_t.numpy()
    )
    field = np.random.default_rng(5).normal(size=q_j.shape)
    e_j = np.asarray(jax.jit(jmt.tiled_mesh_to_dipole_field)(interp_j, jnp.asarray(field)))
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


# -- kernel D's dipole form: one pass per slot, mirrored in float64 ----------------


def _one_pass_mirror(interp, nu_slots):
    """Test-only mirror of kernel D's dipole form: per slot and node ``(a, b,
    c)`` the value ``w_y[b](ν_x w_z[c] dw_x[a] + ν_z dw_z[c] w_x[a]) +
    dw_y[b] ν_y w_z[c] w_x[a]`` built from the slot's weights once, landing
    on window cell ``(lx + a, ly + b)`` of its tile (dropped beyond the
    window), i.e. mesh cell ``(tx·8 + lx + a, ty·8 + ly + b, sz + c)`` modulo
    the mesh."""
    nx, ny, nz = interp.ns
    n = interp.nodes
    t, _ = interp.local_x.shape
    ty_count = ny // mt.TILE
    tile = torch.arange(t)
    ox, oy = (tile // ty_count * mt.TILE)[:, None, None], (tile % ty_count * mt.TILE)[:, None, None]
    w, dw = interp.weights, interp.dweights
    wx, wy, wz = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    dwx, dwy, dwz = dw[..., 0, :], dw[..., 1, :], dw[..., 2, :]
    nux, nuy, nuz = (nu_slots[:, a, :, None] for a in range(3))
    al, be, ga = nux * wz, nuy * wz, nuz * dwz  # (T, K, c)
    pa = al[..., None, :] * dwx[..., :, None] + ga[..., None, :] * wx[..., :, None]  # (T, K, a, c)
    qa = be[..., None, :] * wx[..., :, None]
    val = pa[..., :, None, :] * wy[..., None, :, None] + qa[..., :, None, :] * dwy[..., None, :, None]
    nodes = torch.arange(n)
    xa = interp.local_x.long()[..., None] + nodes
    yb = interp.local_y.long()[..., None] + nodes
    zc = torch.remainder(interp.start_z.long()[..., None] + nodes, nz)
    extent = mt.TILE + n - 1
    keep = (xa < extent)[..., :, None, None] & (yb < extent)[..., None, :, None]
    gx, gy = torch.remainder(ox + xa, nx), torch.remainder(oy + yb, ny)
    idx = (gx[..., :, None, None] * ny + gy[..., None, :, None]) * nz + zc[..., None, None, :]
    val = torch.where(keep, val, 0.0)
    mesh = torch.zeros(nx * ny * nz, dtype=val.dtype).index_add(0, idx.reshape(-1), val.reshape(-1))
    return mesh.reshape(1, nx, ny, nz)


def _dipole_case(nodes, seed=8):
    positions, dipoles = make_system(seed=seed)
    interp_j, _ = _both_tiled(positions, nodes)
    interp_t = tiled_interp_from_state(jax_tiled_state(interp_j), device="cpu")
    nu = (dipoles @ INV) * np.asarray(NS)
    return interp_j, interp_t, nu


@pytest.mark.parametrize("nodes", [3, 4, 6, 7])
def test_one_pass_dipole_spread_matches_plain_and_jax(nodes):
    """The one-pass three-term stencil ≡ the plain version (the charge form
    over every slot three times) ≤ 1e-12, and ≡ the JAX package's
    concatenated spread ≤ 1e-10; the wrapper is the plain version on CPU
    tensors."""
    interp_j, interp_t, nu = _dipole_case(nodes)
    nu_slots = mt._slot_values(interp_t, torch.tensor(nu))
    it = interp_t
    args = (it.local_x, it.local_y, it.start_z, it.weights, it.dweights, nu_slots, NS, nodes)
    plain = mk.mesh_spread_dipole_plain(*args)
    mirror = _one_pass_mirror(interp_t, nu_slots)
    np.testing.assert_allclose(mirror.numpy(), plain.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(mk.mesh_spread_dipole(*args).numpy(), plain.numpy())
    q_j = np.asarray(jax.jit(jmt.tiled_dipoles_to_mesh)(interp_j, jnp.asarray(nu)))
    np.testing.assert_allclose(mirror.numpy(), q_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        mt.tiled_dipoles_to_mesh(interp_t, torch.tensor(nu)).numpy(), q_j, rtol=0, atol=1e-10
    )


def _leaves(interp, requires_grad=True):
    """The interp with fresh leaf weights and derivatives."""
    from dataclasses import replace

    w = interp.weights.detach().clone().requires_grad_(requires_grad)
    dw = interp.dweights.detach().clone().requires_grad_(requires_grad)
    return replace(interp, weights=w, dweights=dw), w, dw


def _tripled(interp):
    """The bucketing of every slot three times along the capacity axis (copy
    ``a`` with the axis-``a`` derivative), built with differentiable ops:
    the charge-form path that the dipole forms replace."""
    from dataclasses import replace

    lx, ly, sz, w = mt._dipole_triple(
        interp.local_x, interp.local_y, interp.start_z, interp.weights, interp.dweights
    )
    return replace(interp, local_x=lx, local_y=ly, start_z=sz, weights=w, dweights=None)


@pytest.mark.parametrize("nodes", [3, 4, 6, 7])
def test_dipole_form_autograd_matches_the_tripled_path(nodes):
    """The cotangents of ``weights``, ``dweights`` and ``ν`` through the
    dipole form's spread and gather (kernel D's dipole form forward and in the
    gather's backward, the dipole forms of E and F in the backwards) ≡ those
    of the path through the tripled slots and the charge-form functions, and
    ≡ the one-pass mirror's own autograd, ≤ 1e-12."""
    _, interp_t, nu = _dipole_case(nodes, seed=9)
    rng = np.random.default_rng(10)
    nu_slots = mt._slot_values(interp_t, torch.tensor(nu))
    ct_mesh = torch.tensor(rng.normal(size=(1, *NS)))
    field = torch.tensor(rng.normal(size=(1, *NS)))
    ct_vals = torch.tensor(rng.normal(size=nu_slots.shape))

    def run(path):
        it, w, dw = _leaves(interp_t)
        nu_ = nu_slots.clone().requires_grad_()
        fld = field.clone().requires_grad_()
        t, _, k = nu_.shape
        if path == "tripled":
            slots = _tripled(it)
            mesh = mk.spread_tiles(slots, nu_.reshape(t, 1, 3 * k))
            vals = mk.gather_tiles(slots, fld).reshape(t, 3, k)
        elif path == "mirror":
            mesh = _one_pass_mirror(it, nu_)
            vals = mk.gather_tiles(_tripled(it), fld).reshape(t, 3, k)
        else:
            mesh = mk.spread_dipoles(it, nu_)
            vals = mk.gather_dipole_fields(it, fld)
        loss = (mesh * ct_mesh).sum() + (vals * ct_vals).sum()
        return torch.autograd.grad(loss, (w, dw, nu_, fld))

    got, ref, mirror = run("dipole"), run("tripled"), run("mirror")
    for label, a, b, m in zip(("weights", "dweights", "nu", "mesh"), got, ref, mirror):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, rtol=0, atol=ATOL,
                                   err_msg=label)
        np.testing.assert_allclose(m.numpy() / scale, b.numpy() / scale, rtol=0, atol=ATOL,
                                   err_msg=label)


@pytest.mark.parametrize("fn", ["spread_dipoles", "gather_dipole_fields"])
def test_dipole_form_backward_refuses_weights_changed_in_place(fn):
    """The weights and derivatives that the backward's dipole forms of E and
    F read are saved for it: changing them in place after the forward makes
    the backward raise instead of using stale values."""
    _, interp_t, nu = _dipole_case(4, seed=9)
    it, w, dw = _leaves(interp_t)
    if fn == "spread_dipoles":
        x = mt._slot_values(interp_t, torch.tensor(nu)).requires_grad_()
        out = mk.spread_dipoles(it, x)
    else:
        x = torch.zeros((1, *NS), dtype=torch.float64, requires_grad=True)
        out = mk.gather_dipole_fields(it, x)
    with torch.no_grad():
        dw.mul_(2.0)
    with pytest.raises(RuntimeError, match="inplace"):
        torch.autograd.grad(out.sum(), (w, x))


# -- the dipole forms of kernels E and F ---------------------------------------


def _slots_to_atoms(interp, per_slot):
    """Per-slot ``(T, C, K)`` → atom-order ``(N, C)``."""
    n_ch = per_slot.shape[1]
    flat = per_slot.transpose(1, 2).reshape(-1, n_ch)
    flat = torch.cat([flat, flat.new_zeros((1, n_ch))], dim=0)
    return flat.index_select(0, interp.slot_of_atom.long())


@pytest.mark.parametrize("nodes", [3, 4, 5, 6, 7])
def test_dipole_gather_and_wgrad_plain_match_jax(nodes):
    """The plain versions of the dipole forms of E and F ≡ the JAX package's
    ``tiled_mesh_to_dipole_field`` and its ``jax.vjp`` with respect to the
    weights and their derivatives (cotangent ν), and E ≡ the ``jax.vjp`` of
    ``tiled_dipoles_to_mesh`` with respect to ν (cotangent the mesh), ≤ 1e-10
    in float64 (XLA path); the CPU wrappers are the plain versions; empty
    slots give zeros."""
    from dataclasses import replace as jreplace

    interp_j, it, nu = _dipole_case(nodes, seed=11)
    field = np.random.default_rng(12).normal(size=(1, *NS))
    args = (it.local_x, it.local_y, it.start_z, it.weights, it.dweights)
    nu_slots = mt._slot_values(it, torch.tensor(nu))
    fld = torch.tensor(field)
    vals = mk.mesh_gather_dipole_plain(*args, fld, NS, nodes)
    ct_w, ct_dw = mk.mesh_wgrad_dipole_plain(*args, nu_slots, fld, NS, nodes)
    assert vals.shape == nu_slots.shape and ct_w.shape == ct_dw.shape == it.weights.shape

    @jax.jit
    def refs(interp, f, n):
        def field_j(w, dw):
            return jmt.tiled_mesh_to_dipole_field(jreplace(interp, weights=w, dweights=dw), f)

        e, vjp_field = jax.vjp(field_j, interp.weights, interp.dweights)
        _, vjp_spread = jax.vjp(lambda n_: jmt.tiled_dipoles_to_mesh(interp, n_), n)
        return (e, *vjp_field(n), *vjp_spread(f))

    e_j, ref_w, ref_dw, ref_nu = refs(interp_j, jnp.asarray(field), jnp.asarray(nu))
    got_atoms = _slots_to_atoms(it, vals).numpy()
    for got, ref in ((got_atoms, e_j), (got_atoms, ref_nu), (ct_w.numpy(), ref_w),
                     (ct_dw.numpy(), ref_dw)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-10)
    empty = it.atom_of_slot == len(nu)
    assert bool(empty.any())
    assert float(vals.transpose(1, 2)[empty].abs().max()) == 0.0
    assert float(ct_w[empty].abs().max()) == float(ct_dw[empty].abs().max()) == 0.0
    both = mk.mesh_gather_wgrad_dipole(*args, nu_slots, fld, NS, nodes)
    for got, ref in zip((mk.mesh_gather_dipole(*args, fld, NS, nodes),
                         *mk.mesh_wgrad_dipole(*args, nu_slots, fld, NS, nodes), *both),
                        (vals, ct_w, ct_dw, vals, ct_w, ct_dw)):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _contraction_mirror(interp, q_slots, mesh, dipole):
    """Test-only float64 mirror of kernels E and F as ``csrc/mesh.cu``'s
    ``contract_slot`` sums them, slot by slot in the kernel's order: over
    the window's x nodes ``a``, then y nodes ``b`` (both dropped beyond the
    window), then the z nodes ``c`` of the column (wrapping modulo the mesh).
    Returns ``(values, ct_w[, ct_dw])``."""
    nx, ny, nz = interp.ns
    n = interp.nodes
    e = mt.TILE + n - 1
    t, k = interp.local_x.shape
    ty_count = ny // mt.TILE
    tile = torch.arange(t)[:, None]
    ox, oy = tile // ty_count * mt.TILE, tile % ty_count * mt.TILE
    x0, y0, z0 = (a.long() for a in (interp.local_x, interp.local_y, interp.start_z))
    w = interp.weights
    wx, wy, wz = (w[..., i, :] for i in range(3))
    zero = torch.zeros((t, k), dtype=w.dtype)

    def column(ch, a, b):  # (T, K, n) mesh values of window column (a, b)
        gx, gy = torch.remainder(ox + x0 + a, nx), torch.remainder(oy + y0 + b, ny)
        zc = torch.remainder(z0[..., None] + torch.arange(n), nz)
        return mesh[ch][gx[..., None], gy[..., None], zc]

    g = {key: [[zero] * n for _ in range(3)] for key in ("w", "d")}
    if not dipole:
        vals = []
        for ch in range(q_slots.shape[1]):
            qv = q_slots[:, ch]
            acc = zero
            for a in range(n):
                keep_a = (x0 + a < e).to(w.dtype)
                sa, qa = zero, wx[..., a] * qv
                for b in range(n):
                    keep = keep_a * (y0 + b < e).to(w.dtype)
                    f = column(ch, a, b) * keep[..., None]
                    s = zero
                    for c in range(n):
                        s = s + wz[..., c] * f[..., c]
                    sa = sa + wy[..., b] * s
                    tz = qa * wy[..., b]
                    for c in range(n):
                        g["w"][2][c] = g["w"][2][c] + tz * f[..., c]
                    g["w"][1][b] = g["w"][1][b] + qa * s
                acc = acc + wx[..., a] * sa
                g["w"][0][a] = g["w"][0][a] + qv * sa
            vals.append(acc)
        vals = torch.stack(vals, dim=1)
    else:
        d = interp.dweights
        dx, dy, dz = (d[..., i, :] for i in range(3))
        nux, nuy, nuz = (q_slots[:, i] for i in range(3))
        ex = ey = ez = zero
        for a in range(n):
            keep_a = (x0 + a < e).to(w.dtype)
            sw = sdy = sdz = zero
            cxa, cya, cza = nux * dx[..., a], nuy * wx[..., a], nuz * wx[..., a]
            for b in range(n):
                keep = keep_a * (y0 + b < e).to(w.dtype)
                f = column(0, a, b) * keep[..., None]
                s = sd = zero
                for c in range(n):
                    s = s + wz[..., c] * f[..., c]
                    sd = sd + dz[..., c] * f[..., c]
                sw = sw + wy[..., b] * s
                sdy = sdy + dy[..., b] * s
                sdz = sdz + wy[..., b] * sd
                cw, cd = cxa * wy[..., b] + cya * dy[..., b], cza * wy[..., b]
                for c in range(n):
                    g["w"][2][c] = g["w"][2][c] + cw * f[..., c]
                    g["d"][2][c] = g["d"][2][c] + cd * f[..., c]
                g["w"][1][b] = g["w"][1][b] + cxa * s + cza * sd
                g["d"][1][b] = g["d"][1][b] + cya * s
            ex = ex + dx[..., a] * sw
            ey = ey + wx[..., a] * sdy
            ez = ez + wx[..., a] * sdz
            g["w"][0][a] = keep_a * (nuy * sdy + nuz * sdz)
            g["d"][0][a] = keep_a * (nux * sw)
        vals = torch.stack([ex, ey, ez], dim=1)

    def stacked(key):
        return torch.stack([torch.stack(g[key][i], dim=-1) for i in range(3)], dim=2)

    return (vals, stacked("w"), stacked("d")) if dipole else (vals, stacked("w"))


@pytest.mark.parametrize("nodes", [3, 5, 7])
@pytest.mark.parametrize("form", ["charges", "dipoles"])
def test_kernel_order_mirror_of_gather_and_wgrad_matches_plain(nodes, form):
    """A float64 mirror of the per-slot contraction of kernels E and F (both
    forms), in the order the kernel sums it, ≡ the plain versions ≤ 1e-12,
    with a third of the slots stale (x nodes beyond the window) and the empty
    slots giving zeros; three channels in the charge form."""
    _, it, nu = _dipole_case(nodes, seed=13)
    rng = np.random.default_rng(14)
    lx = it.local_x.clone()
    stale = (it.atom_of_slot < len(nu)) & (torch.arange(lx.shape[1]) % 3 == 0)
    lx[stale] = mt.TILE + 1  # nodes 0..n-3 of x fall off the window
    from dataclasses import replace

    it = replace(it, local_x=lx)
    args = (it.local_x, it.local_y, it.start_z, it.weights)
    if form == "charges":
        q_slots = mt._slot_values(it, torch.tensor(rng.normal(size=(len(nu), 3))))
        mesh = torch.tensor(rng.normal(size=(3, *NS)))
        ref = (mk.mesh_gather_plain(*args, mesh, NS, nodes),
               mk.mesh_wgrad_plain(*args, q_slots, mesh, NS, nodes))
        got = _contraction_mirror(it, q_slots, mesh, dipole=False)
    else:
        q_slots = mt._slot_values(it, torch.tensor(nu))
        mesh = torch.tensor(rng.normal(size=(1, *NS)))
        ref = mk.mesh_gather_wgrad_dipole_plain(*args, it.dweights, q_slots, mesh, NS, nodes)
        got = _contraction_mirror(it, q_slots, mesh, dipole=True)
    for a, b in zip(got, ref):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, rtol=0, atol=ATOL)
