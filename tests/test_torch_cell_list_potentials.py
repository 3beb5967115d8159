"""The port's per-atom real space over a cell list ≡ the JAX package's:
``cell_list_rspace_potentials`` (spill on and off, triclinic, two charge
channels, a callable pair term, stale lists NaN) with its gradients in
positions, charges and cell, ``Calculator.forward(cell_list=…)`` for the
mesh and Ewald calculators, and direct mode (no smearing) through
``energy`` (kernel C's unsmeared pair math in its plain version here) and
``forward``.  Float64 at ≤ 1e-10: the algorithm is the JAX package's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import port_clist, rel

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.ops import rspace_cells as jrc
from torchpme_tpu.utils.neighbors import neighbor_list
from torchpme_tpu_torch.ops import rspace_cells as trc

torch.set_num_threads(1)

COULOMB_J = tpme.CoulombPotential(smearing=1.0)


def _system(seed, n, box, triclinic, spread=0.0):
    """tests/ops/test_rspace_cells.py:_system as numpy."""
    rng = np.random.default_rng(seed)
    positions = rng.uniform(-spread, box + spread, (n, 3))
    charges = rng.normal(size=(n, 2))
    if triclinic:
        cell = np.array([[box, 0, 0], [0.3, box, 0], [0.2, -0.4, box]])
    else:
        cell = np.eye(3) * box
    return positions, charges, cell


@functools.partial(jax.jit, static_argnums=0)
def _jax_value_and_vjp(pot_j, p, q, c, clist_j, weights):
    """One compilation for the values and the gradients, shared by the
    cases whose cell lists have the same shapes (the list is an argument)."""
    out, vjp = jax.vjp(lambda *a: jrc.cell_list_rspace_potentials(pot_j, a[1], a[0], a[2], clist_j),
                       p, q, c)
    return out, vjp(weights)


def _both(pot_j, pot_t, positions, charges, cell, clist_j, weights):
    """(values, d/dpositions, d/dcharges, d/dcell of sum(pot·w)) of the JAX
    and the port's cell_list_rspace_potentials on the same cell list."""
    out_j, grads_j = _jax_value_and_vjp(
        pot_j, jnp.asarray(positions), jnp.asarray(charges), jnp.asarray(cell), clist_j,
        jnp.asarray(weights),
    )
    ref = (np.asarray(out_j), *(np.asarray(g) for g in grads_j))
    p, q, c = (torch.tensor(a, requires_grad=True) for a in (positions, charges, cell))
    out = trc.cell_list_rspace_potentials(pot_t, q, p, c, port_clist(clist_j))
    grads = torch.autograd.grad(torch.sum(out * torch.tensor(weights)), (p, q, c))
    return (out.detach().numpy(), *(g.numpy() for g in grads)), ref


def _assert_close(ours, theirs, tol=1e-10):
    for name, a, b in zip(("values", "positions", "charges", "cell"), ours, theirs):
        assert a.shape == b.shape, name
        assert np.all(np.isfinite(a)), name
        assert rel(a, b) <= tol, (name, rel(a, b))


@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("spread", [0.0, 2.0])
def test_potentials_match_jax(triclinic, spread):
    positions, charges, cell = _system(1, 60, 8.0, triclinic, spread)
    cutoff = 3.1
    clist_j = jrc.compute_cell_list(jnp.asarray(positions), jnp.asarray(cell), cutoff,
                                    spill=False)
    weights = np.random.default_rng(2).normal(size=charges.shape)
    ours, theirs = _both(COULOMB_J, tpt.CoulombPotential(smearing=1.0),
                         positions, charges, cell, clist_j, weights)
    _assert_close(ours, theirs)
    # the neighbor-list sum at the same cutoff
    idx, dist, _ = neighbor_list(positions, cell, cutoff, full_list=True)
    calc = tpt.Calculator(tpt.CoulombPotential(smearing=1.0), full_neighbor_list=True)
    ref = calc._compute_rspace(torch.tensor(charges), torch.tensor(idx), torch.tensor(dist))
    assert rel(ours[0], ref.numpy()) <= 1e-12


@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("capacity", [8, 16])
def test_spill_potentials_match_jax(triclinic, capacity):
    """A tight capacity spills atoms into the side list: both pair classes
    (extra ↔ bucketed, extra ↔ extra) land on the right atoms."""
    positions, charges, cell = _system(12, 700, 9.0, triclinic)
    clist_j = jrc.compute_cell_list(jnp.asarray(positions), jnp.asarray(cell), 2.2,
                                    capacity=capacity, spill=True)
    assert int(np.asarray(clist_j.extra_mask).sum()) > 0
    weights = np.random.default_rng(3).normal(size=charges.shape)
    ours, theirs = _both(COULOMB_J, tpt.CoulombPotential(smearing=1.0),
                         positions, charges, cell, clist_j, weights)
    _assert_close(ours, theirs)


@pytest.mark.parametrize("kind", ["callable", "direct"])
def test_callable_and_direct_pair_terms_match_jax(kind):
    positions, charges, cell = _system(10, 400, 7.0, True)
    clist_j = jrc.compute_cell_list(jnp.asarray(positions), jnp.asarray(cell), 1.7,
                                    capacity=8, spill=True)
    assert clist_j.extra_index is not None
    if kind == "callable":
        pot_j, pot_t = (lambda d: jnp.exp(-(d**2))), (lambda d: torch.exp(-(d**2)))
    else:
        pot_j, pot_t = tpme.CoulombPotential(), tpt.CoulombPotential()
    weights = np.random.default_rng(4).normal(size=charges.shape)
    ours, theirs = _both(pot_j, pot_t, positions, charges, cell, clist_j, weights)
    _assert_close(ours, theirs)


def test_stale_lists_poison_values_and_gradients():
    positions, charges, cell = _system(14, 700, 9.0, False)
    pot = tpt.CoulombPotential(smearing=1.0)
    clist = trc.compute_cell_list(positions, cell, 2.2, capacity=8, spill=True, device="cpu")
    victim_bucketed = int(clist.atom_index[clist.slot_mask][0])
    victim_extra = int(clist.extra_index[clist.extra_mask][0])
    for victim in (victim_bucketed, victim_extra):
        drifted = positions.copy()
        drifted[victim, 0] += 3.0
        p = torch.tensor(drifted, requires_grad=True)
        out = trc.cell_list_rspace_potentials(pot, torch.tensor(charges), p,
                                              torch.tensor(cell), clist)
        assert bool(torch.isnan(out).all())
        (g,) = torch.autograd.grad(out.sum(), p)
        assert bool(torch.isnan(g).all())


# -- the calculators ---------------------------------------------------------------


def _forward_pair(calc_j, calc_t, positions, charges, cell, cutoff, **kw):
    """(potentials, d/dpositions, d/dcell of sum(pot·q)) of calc(cell_list=)."""
    clist_j = jrc.compute_cell_list(jnp.asarray(positions), jnp.asarray(cell), cutoff)

    def f_j(p, c):
        return calc_j(jnp.asarray(charges), c, p, cell_list=clist_j, **kw)

    def value_and_vjp(p, c):  # one compilation for the values and the gradients
        out, vjp = jax.vjp(f_j, p, c)
        return out, vjp(jnp.asarray(charges))

    out_j, grads_j = jax.jit(value_and_vjp)(jnp.asarray(positions), jnp.asarray(cell))
    ref = (np.asarray(out_j), *(np.asarray(g) for g in grads_j))
    p, c = (torch.tensor(a, requires_grad=True) for a in (positions, cell))
    q = torch.tensor(charges)
    out = calc_t(q, c, p, cell_list=port_clist(clist_j), **kw)
    grads = torch.autograd.grad(torch.sum(out * q), (p, c))
    return (out.detach().numpy(), *(g.numpy() for g in grads)), ref


@pytest.mark.parametrize("calc_name", ["pme", "ewald", "direct"])
def test_calculator_forward_over_a_cell_list_matches_jax(calc_name):
    positions, charges, cell = _system(3, 40, 7.0, calc_name == "ewald")
    kw = {}
    if calc_name == "pme":
        calc_j = tpme.PMECalculator(tpme.CoulombPotential(smearing=1.0), mesh_spacing=0.4)
        calc_t = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), mesh_spacing=0.4,
                                   mesh_backend="scatter")
        kw["ns_mesh"] = calc_t.get_ns_mesh(cell)
    elif calc_name == "ewald":
        calc_j = tpme.EwaldCalculator(tpme.CoulombPotential(smearing=1.0), lr_wavelength=1.0)
        calc_t = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=1.0)
        kw["ns_kvectors"] = calc_t.get_ns_kvectors(cell)
    else:
        calc_j = tpme.Calculator(tpme.CoulombPotential())
        calc_t = tpt.Calculator(tpt.CoulombPotential())
    ours, theirs = _forward_pair(calc_j, calc_t, positions, charges, cell, 2.5, **kw)
    for name, a, b in zip(("potentials", "positions", "cell"), ours, theirs):
        assert rel(a, b) <= 1e-10, (calc_name, name, rel(a, b))
    # energy ≡ sum(pot·q) on the same cell list
    p, q, c = (torch.tensor(a) for a in (positions, charges, cell))
    clist = trc.compute_cell_list(p, c, 2.5)
    e = calc_t.energy(q, c, p, cell_list=clist, **kw)
    assert abs(float(e) - float(np.sum(ours[0] * charges))) <= 1e-10 * abs(float(e))


@pytest.mark.parametrize("spill", [False, True])
def test_direct_mode_energy_over_a_cell_list_matches_jax(spill):
    """Direct mode through ``energy(cell_list=)``: the window's plain
    version with the unsmeared pair (float64 against JAX's window, values
    and gradients; float32 on kernel C's float32 pair math against float64
    at the float32 bar), and the neighbor-list direct sum."""
    positions, charges, cell = _system(7, 300 if spill else 60, 9.0, spill)
    cutoff = 2.2
    kw = dict(capacity=8, spill=True) if spill else {}
    clist_j = jrc.compute_cell_list(jnp.asarray(positions), jnp.asarray(cell), cutoff, **kw)
    assert (clist_j.extra_index is not None) == spill
    calc_j = tpme.Calculator(tpme.CoulombPotential())

    def e_j(p, q, c):
        return calc_j.energy(q, c, p, cell_list=clist_j)

    args = (jnp.asarray(positions), jnp.asarray(charges), jnp.asarray(cell))
    ej, gj = jax.jit(jax.value_and_grad(e_j, argnums=(0, 1, 2)))(*args)
    calc = tpt.Calculator(tpt.CoulombPotential())
    clist = port_clist(clist_j)
    p, q, c = (torch.tensor(a, requires_grad=True) for a in (positions, charges, cell))
    e = calc.energy(q, c, p, cell_list=clist)
    grads = torch.autograd.grad(e, (p, q, c))
    assert abs(float(e.detach()) - float(ej)) <= 1e-10 * abs(float(ej))
    for a, b in zip(grads, gj):
        assert rel(a.numpy(), np.asarray(b)) <= 1e-10
    # the per-atom direct sum over the same cell list, and over a neighbor list
    pot = calc(q.detach(), c.detach(), p.detach(), cell_list=clist)
    assert abs(float(torch.sum(pot * q.detach())) - float(ej)) <= 1e-10 * abs(float(ej))
    idx, dist, _ = neighbor_list(positions, cell, cutoff)
    e_nl = calc.energy(q.detach(), c.detach(), p.detach(), torch.tensor(idx), torch.tensor(dist))
    assert abs(float(e_nl) - float(ej)) <= 1e-10 * abs(float(ej))
    # float32: kernel C's unsmeared pair math (rsqrt) in its plain version
    f32 = [torch.tensor(a, dtype=torch.float32) for a in (positions, charges, cell)]
    e32 = calc.energy(f32[1], f32[2], f32[0], cell_list=clist)
    assert e32.dtype == torch.float32
    assert abs(float(e32) - float(ej)) <= 2e-5 * abs(float(ej))


def test_window_direct_variant_plain_twin_matches_float64():
    """The plain twin of kernel C's unsmeared variant: float32 (the
    kernel's rsqrt pair math) against float64 (1/d), energy and the three
    gradients, on the same window inputs."""
    positions, charges, cell = _system(8, 200, 9.0, True)
    clist = trc.compute_cell_list(positions, cell, 2.2, device="cpu")
    pot = tpt.CoulombPotential()
    outs = []
    for dtype in (torch.float32, torch.float64):
        p, q, c = (torch.tensor(a, dtype=dtype) for a in (positions, charges, cell))
        ins = trc._prepare(q, p, c, clist)[:4]
        e, grads = trc._we_value_and_grad(pot, clist.cutoff, *ins)
        outs.append((e, *grads))
    for a, b in zip(*outs):
        assert rel(a.numpy(), b.numpy()) <= 2e-5
    e64 = float(outs[1][0])
    assert abs(e64) > 1.0
