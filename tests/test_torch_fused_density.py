"""The fused mesh mode: the port's ``fused_tiled_density`` (kernels A and B at
the stencil-start geometry, their plain twins on the CPU) ≡ the JAX
package's (Pallas kernels in interpret mode), and its two callers,
``MDFastPath(mesh_impl="fused")`` and ``PMECalculator(mesh_backend="fused")``
≡ theirs in float32 and ≡ the port's tiled mode in float64."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_tiled_state, port_from_jax, random_box, rel

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.ops.mesh_tiled import compute_tiled_interpolation as jax_tiled
from torchpme_tpu.ops.pallas.spread_fused import fused_tiled_density as jax_fused
from torchpme_tpu_torch.convert import tiled_interp_from_state
from torchpme_tpu_torch.ops import spread_fused as sf
from torchpme_tpu_torch.ops.mesh_tiled import (
    compute_tiled_interpolation,
    refresh_tiled_interpolation,
    tiled_points_to_mesh,
)

torch.set_num_threads(1)

CUTOFF = 3.0


def _density_system(n_ch, nz, seed=0):
    """tests/ops/test_spread_fused.py:make_system: 60 atoms in a 5×5×20 box,
    some unwrapped slightly outside it, on a (16, 16, nz) mesh."""
    rng = np.random.default_rng(seed)
    cell = np.diag([5.0, 5.0, 20.0]).astype(np.float32)
    pos = (rng.uniform(-0.2, 1.2, (60, 3)) @ cell).astype(np.float32)
    q = rng.normal(size=(60, n_ch)).astype(np.float32)
    inv = np.linalg.inv(cell).astype(np.float32)
    return pos, q, inv, (16, 16, nz)


def _port_density(interp_j, pos, q, inv, w, dtype=torch.float32):
    interp = tiled_interp_from_state(jax_tiled_state(interp_j), "cpu")
    args = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (pos, q, inv)]
    rho, valid = sf.fused_tiled_density(interp, args[0], args[2], args[1], "Lagrange")
    grads = torch.autograd.grad(torch.sum(rho * torch.tensor(w, dtype=dtype)), args)
    return rho.detach().numpy(), bool(valid), [g.numpy() for g in grads]


# (nodes, channels, nz): odd and even stencils, 1 and 2 channels, and z lines
# that are not multiples of 8
DENSITY_CASES = [(3, 1, 36), (4, 2, 32), (5, 2, 44), (6, 1, 20)]


@pytest.mark.parametrize("nodes,n_ch,nz", DENSITY_CASES)
def test_fused_density_and_vjp_match_jax(nodes, n_ch, nz):
    pos, q, inv, ns = _density_system(n_ch, nz)
    interp_j = jax_tiled(jnp.asarray(pos), jnp.asarray(inv), ns, nodes, "Lagrange")
    w = np.random.default_rng(2).normal(size=(n_ch, *ns)).astype(np.float32)

    def loss(p, qq, c):
        rho, valid = jax_fused(interp_j, p, c, qq, "Lagrange")
        return jnp.sum(rho * w), (rho, valid)

    (_, (rho_j, valid_j)), g_j = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)
    )(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(inv))
    rho, valid, grads = _port_density(interp_j, pos, q, inv, w)
    assert rho.dtype == np.float32 and rho.shape == (n_ch, *ns)
    # the bar of tests/ops/test_spread_fused.py:49
    np.testing.assert_allclose(rho, np.asarray(rho_j), atol=1e-5)
    assert valid and bool(valid_j)
    for got, ref in zip(grads, g_j):  # positions, charges, inverse cell
        assert rel(got, np.asarray(ref)) <= 1e-5


def test_validity_flag_matches_jax_on_a_drifted_system():
    """tests/ops/test_spread_fused.py:84: one atom moved 2.6 Å (8 mesh cells)
    out of its tile."""
    rng = np.random.default_rng(4)
    cell = np.eye(3, dtype=np.float32) * 5.0
    inv = np.linalg.inv(cell).astype(np.float32)
    pos = rng.uniform(0, 5, (40, 3)).astype(np.float32)
    q = rng.normal(size=(40, 1)).astype(np.float32)
    ns = (16, 16, 32)
    interp_j = jax_tiled(jnp.asarray(pos), jnp.asarray(inv), ns, 5, "Lagrange")
    interp = tiled_interp_from_state(jax_tiled_state(interp_j), "cpu")
    valid_of = jax.jit(
        lambda p: jax_fused(interp_j, p, jnp.asarray(inv), jnp.asarray(q), "Lagrange")[1]
    )
    for shift, expect in ((0.0, True), (2.6, False)):
        drifted = pos.copy()
        drifted[7, 0] += shift
        valid_j = valid_of(jnp.asarray(drifted))
        _, valid = sf.fused_tiled_density(interp, torch.tensor(drifted), torch.tensor(inv),
                                          torch.tensor(q), "Lagrange")
        assert bool(valid) == bool(valid_j) == expect
    # a bucketing that dropped atoms is never valid
    _, valid = sf.fused_tiled_density(replace(interp, dropped=torch.tensor(1)),
                                      torch.tensor(pos), torch.tensor(inv), torch.tensor(q),
                                      "Lagrange")
    assert not bool(valid)


def test_bucketing_without_slot_indices_raises():
    pos, q, inv, ns = _density_system(1, 32)
    interp = compute_tiled_interpolation(torch.tensor(pos), torch.tensor(inv), ns, 4, "Lagrange")
    stripped = replace(interp, atom_of_slot=None)
    assert sf.supports_fused(interp, torch.float32)
    assert not sf.supports_fused(stripped, torch.float32)
    assert not sf.supports_fused(interp, torch.float64)
    with pytest.raises(ValueError, match="bucket->atom"):
        sf.fused_tiled_density(stripped, torch.tensor(pos), torch.tensor(inv), torch.tensor(q),
                               "Lagrange")


@pytest.mark.parametrize("nodes", [4, 5])
def test_float64_fused_plain_path_is_the_tiled_refresh_and_spread(nodes):
    pos, q, inv, ns = _density_system(2, 36, seed=1)
    p, qq, c = (torch.tensor(a, dtype=torch.float64) for a in (pos, q, inv))
    interp = compute_tiled_interpolation(p, c, ns, nodes, "Lagrange")
    rho, valid = sf.fused_tiled_density(interp, p, c, qq, "Lagrange")
    refreshed, valid_t = refresh_tiled_interpolation(interp, p, c, "Lagrange")
    assert rho.dtype == torch.float64 and bool(valid) == bool(valid_t) is True
    assert rel(rho.numpy(), tiled_points_to_mesh(refreshed, qq).numpy()) <= 1e-12


# -- the MD state in fused mode ----------------------------------------------------


def _md_system():
    """tests/ops/test_spread_fused.py:112: 150 atoms in a 12 Å box, 5 nodes."""
    pos, q, cell = random_box(150, 12.0, seed=3)
    calcs = [
        pkg.PMECalculator(pkg.CoulombPotential(smearing=1.0), mesh_spacing=0.75,
                          interpolation_nodes=5)
        for pkg in (tpme, tpt)
    ]
    return pos, q, cell, calcs


def _step(fp, pos, q, cell, dtype):
    """(energy, row gradient, cell gradient) of the port's step."""
    c = torch.tensor(cell, dtype=dtype, requires_grad=True)
    rows = fp.bucket(torch.tensor(pos, dtype=dtype)).requires_grad_()
    e = fp.energy(torch.tensor(q, dtype=dtype), c, rows)
    return (float(e.detach()), *(g.numpy() for g in torch.autograd.grad(e, (rows, c))))


def test_md_fused_matches_jax_fused_in_float32():
    pos, q, cell, (calc_j, _) = _md_system()
    f32 = jnp.float32
    ns = calc_j.get_ns_mesh(jnp.asarray(cell))
    fp_j = tpme.MDFastPath.create(calc_j, jnp.asarray(pos, f32), jnp.asarray(cell, f32), CUTOFF,
                                  ns, mesh_impl="fused")
    rows_j = fp_j.bucket(jnp.asarray(pos, f32))
    e_j, (g_rows_j, g_cell_j) = jax.jit(jax.value_and_grad(fp_j.energy, argnums=(2, 1)))(
        jnp.asarray(q, f32), jnp.asarray(cell, f32), rows_j
    )
    fp = port_from_jax(fp_j)
    assert fp.mesh_impl == "fused" and fp.calc.mesh_backend == "fused"
    e, g_rows, g_cell = _step(fp, pos, q, cell, torch.float32)
    assert abs(e - float(e_j)) <= 1e-5 * abs(float(e_j))
    assert rel(g_rows, np.asarray(g_rows_j)) <= 1e-5
    assert rel(g_cell, np.asarray(g_cell_j)) <= 1e-4


def test_md_fused_runs_kernels_a_and_b_and_float64_matches_tiled(monkeypatch):
    """float32 state: the fused step spreads through the twins of A and B
    (never the refresh); float64 state: the fused mode takes the tiled step,
    as in the JAX package, and the two agree to 1e-10."""
    pos, q, cell, (_, calc) = _md_system()
    ns = calc.get_ns_mesh(cell)
    cpu = dict(device="cpu")
    fp_f = tpt.MDFastPath.create(calc, pos, cell, CUTOFF, ns, mesh_impl="fused", **cpu)
    fp_t = tpt.MDFastPath.create(calc, pos, cell, CUTOFF, ns, mesh_impl="tiled", **cpu)
    assert fp_f.mesh_impl == "fused" and fp_f.tiled.local_x.shape[1] % 8 == 0
    e_f, g_f, c_f = _step(fp_f, pos, q, cell, torch.float64)
    e_t, g_t, c_t = _step(fp_t, pos, q, cell, torch.float64)
    assert abs(e_f - e_t) <= 1e-10 * abs(e_t)
    assert rel(g_f, g_t) <= 1e-10 and rel(c_f, c_t) <= 1e-10
    calls = []
    real = sf.spread_plain_bwd

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(sf, "spread_plain_bwd", spy)
    e32, g32, _ = _step(fp_f, pos, q, cell, torch.float32)
    assert [g.lpad for g in calls] == [0] and calls[0].z_cells == 1
    assert abs(e32 - e_t) <= 1e-5 * abs(e_t) and rel(g32, g_t) <= 1e-4
    # rebucket keeps the mode; a stale bucketing poisons the step
    rows = fp_f.bucket(torch.tensor(pos, dtype=torch.float32))
    assert fp_f.rebucket(rows, torch.tensor(cell, dtype=torch.float32)).mesh_impl == "fused"
    drifted = rows.clone()
    drifted[fp_f.row_of_atom[5].long(), 0] += 6.0
    e_stale = fp_f.energy(torch.tensor(q, dtype=torch.float32),
                          torch.tensor(cell, dtype=torch.float32), drifted)
    assert np.isnan(float(e_stale))


def test_md_fused_refuses_unaligned_tile_capacity():
    """tests/test_md.py:174."""
    pos, _, cell, (_, calc) = _md_system()
    ns = calc.get_ns_mesh(cell)
    with pytest.raises(ValueError, match="multiple of 8"):
        tpt.MDFastPath.create(calc, pos, cell, CUTOFF, ns, tile_capacity=100,
                              mesh_impl="fused", device="cpu")
    fp = tpt.MDFastPath.create(calc, pos, cell, CUTOFF, ns, tile_capacity=104,
                               mesh_impl="fused", device="cpu")
    assert fp.tiled.local_x.shape[1] == 104


# -- the calculator ----------------------------------------------------------------


def test_calculator_fused_energy_matches_jax_and_forward_is_tiled():
    pos, q, cell, (calc_j, _) = _md_system()
    f32 = jnp.float32
    ns = calc_j.get_ns_mesh(jnp.asarray(cell))
    interp_j = jax_tiled(jnp.asarray(pos, f32), jnp.asarray(np.linalg.inv(cell), f32), ns, 5,
                         "Lagrange")
    fused_j = replace(calc_j, mesh_backend="fused")

    def e_j(p, c):
        return fused_j._compute_kspace_energy(jnp.asarray(q, f32), c, p, ns_mesh=ns,
                                              tiled_interp=interp_j)

    ej, (gp_j, gc_j) = jax.jit(jax.value_and_grad(e_j, argnums=(0, 1)))(
        jnp.asarray(pos, f32), jnp.asarray(cell, f32)
    )
    interp = tiled_interp_from_state(jax_tiled_state(interp_j), "cpu")
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), mesh_spacing=0.75,
                             interpolation_nodes=5, mesh_backend="fused")
    p = torch.tensor(pos, dtype=torch.float32, requires_grad=True)
    c = torch.tensor(cell, dtype=torch.float32, requires_grad=True)
    qq = torch.tensor(q, dtype=torch.float32)
    e = calc._compute_kspace_energy(qq, c, p, ns_mesh=ns, tiled_interp=interp)
    gp, gc = torch.autograd.grad(e, (p, c))
    assert abs(float(e.detach()) - float(ej)) <= 1e-5 * abs(float(ej))
    assert rel(gp.numpy(), np.asarray(gp_j)) <= 1e-5
    # the cell gradient sums the mesh term against the volume's, which cancel;
    # the port assembles them in float64, the JAX package in float32
    assert rel(gc.numpy(), np.asarray(gc_j)) <= 1e-4

    # the full energy (real space over a neighbor list + k-space) and the
    # per-atom forward, which stays on the tiled path
    from torchpme_tpu_torch.utils.neighbors import compute_distances, neighbor_list

    tiled = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), mesh_spacing=0.75,
                              interpolation_nodes=5, mesh_backend="tiled")
    idx, _, shifts = (torch.as_tensor(a) for a in neighbor_list(p.detach(), c.detach(), CUTOFF))
    dist = compute_distances(p.detach(), idx, c.detach(), shifts)
    kw = dict(ns_mesh=ns, tiled_interp=interp)
    e_full = calc.energy(qq, c.detach(), p.detach(), idx, dist, **kw)
    assert abs(float(e_full) - float(tiled.energy(qq, c.detach(), p.detach(), idx, dist, **kw))) \
        <= 1e-5 * abs(float(e_full))
    pot_f = calc(qq, c.detach(), p.detach(), idx, dist, **kw)
    pot_t = tiled(qq, c.detach(), p.detach(), idx, dist, **kw)
    np.testing.assert_array_equal(pot_f.numpy(), pot_t.numpy())
    with pytest.raises(ValueError, match="stale"):
        moved = p.detach().clone()
        moved[3, 0] += 6.0
        calc.energy(qq, c.detach(), moved, idx, dist, **kw)
