"""Kernel C's module (``ops/rspace_cells.py``) over the potential family:
the window energy from bucket rows ≡ the JAX package's for 1/r^p, Combined
(with the weights' gradient), Spline and the exclusion windows, smeared and
direct, in float64 (every gradient) and float32 (the fused pair math), the
per-member energies that are dE/dw, and the wrapper's refusals."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_kernel_params as kernel_params
from torch_port_common import lattice_box, port_clist, rel, rows_of

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.ops import rspace_cells as jax_rc
from torchpme_tpu_torch.ops import rspace_cells as port_rc

torch.set_num_threads(1)

CUTOFF = 3.0
W = np.array([0.7, -0.4])
W4 = np.array([0.7, -0.4, 0.3, -0.2])
R_GRID = np.linspace(0.2, 12.0, 300)


def _spline_y():
    return np.exp(-R_GRID) / R_GRID


def _pots(pkg, name, weights=None):
    """The potential ``name`` of package ``pkg`` (the JAX package or the port)."""
    arr = jnp.asarray if pkg is tpme else torch.tensor
    if name == "ipl3":
        return pkg.InversePowerLawPotential(exponent=3, smearing=1.0, prefactor=0.8)
    if name == "ipl6":
        return pkg.InversePowerLawPotential(exponent=6, smearing=0.9)
    if name == "ipl6_direct":
        return pkg.InversePowerLawPotential(exponent=6)
    if name == "combined4":  # p = 1, 3, 5, 6: kernel C's largest table
        return pkg.CombinedPotential(
            [pkg.CoulombPotential(smearing=1.0)]
            + [pkg.InversePowerLawPotential(exponent=p, smearing=0.9) for p in (3, 5, 6)],
            initial_weights=arr(W4) if weights is None else weights, smearing=1.0)
    if name == "combined_direct":  # p = 2, 4
        return pkg.CombinedPotential(
            [pkg.InversePowerLawPotential(exponent=2), pkg.InversePowerLawPotential(exponent=4)],
            initial_weights=arr(W) if weights is None else weights)
    if name == "coulomb_exclusion":
        return pkg.CoulombPotential(smearing=1.0, exclusion_radius=2.6, exclusion_degree=2)
    if name == "direct_exclusion":
        return pkg.InversePowerLawPotential(exponent=2, exclusion_radius=2.2)
    if name == "spline":  # direct: the whole splined potential is the pair term
        return pkg.SplinePotential(arr(R_GRID), arr(_spline_y()))
    raise KeyError(name)


NAMES = ["ipl3", "ipl6", "ipl6_direct", "combined4", "combined_direct", "coulomb_exclusion",
         "direct_exclusion", "spline"]
COMBINED = ("combined4", "combined_direct")
# float64 against JAX here: the direct terms of a combination (one JAX
# compilation); the smeared combinations, the exclusion windows and the spline
# reach the window in float64 through ``Calculator.energy(cell_list=)`` in
# test_torch_potentials_family.py and the MD steps of test_torch_md_extras.py
F64_NAMES = ["combined_direct"]


@functools.lru_cache(maxsize=None)
def _system():
    pos, q, cell = lattice_box(4)
    clist_j = jax_rc.compute_cell_list(pos, cell, CUTOFF, capacity=4, spill=True)
    assert clist_j.extra_index is not None, "system did not spill"
    return pos, q, cell, clist_j


@pytest.fixture(scope="module")
def system():
    return _system()


@functools.lru_cache(maxsize=None)
def _jax_window(name, dt):
    """The JAX package's window energy and its gradients (charges, rows,
    cell, weights), once per potential and dtype."""
    pos, q, cell, clist_j = _system()
    rows = rows_of(clist_j, pos).astype(dt)
    jdt = getattr(jnp, dt)

    def energy(qq, rr, cc, ww):
        pot = _pots(tpme, name, ww if name in COMBINED else None)
        return jax_rc.cell_list_rspace_energy_rows(pot, qq, rr, cc, clist_j)

    w = W4 if name == "combined4" else W
    args = (jnp.asarray(q, jdt), jnp.asarray(rows, jdt), jnp.asarray(cell, jdt), jnp.asarray(w, jdt))
    e, grads = jax.jit(jax.value_and_grad(energy, argnums=(0, 1, 2, 3)))(*args)
    return float(e), [np.asarray(g) for g in grads], rows


def _port_window(name, system, rows, dt, plain=False):
    pos, q, cell, clist_j = system
    tdt = getattr(torch, dt)
    pot = _pots(tpt, name)
    args = [torch.tensor(a, dtype=tdt, requires_grad=True) for a in (q, rows, cell)]
    e = port_rc.cell_list_rspace_energy_rows(pot, *args, port_clist(clist_j), plain=plain)
    wants = args + ([pot.weights] if name in COMBINED else [])
    grads = torch.autograd.grad(e, wants)
    return float(e.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", F64_NAMES)
def test_window_f64_matches_jax(system, name):
    e_j, g_j, rows = _jax_window(name, "float64")
    e, g = _port_window(name, system, rows, "float64")
    assert abs(e - e_j) <= 1e-10 * abs(e_j)
    for got, ref in zip(g, g_j):
        assert rel(got, ref) <= 1e-10
    assert len(g) == (4 if name in COMBINED else 3)


@pytest.mark.parametrize("name", ["ipl3", "combined4"])
def test_window_f32_matches_jax(system, name):
    """float32: the port's plain window takes kernel C's pair math (1/r^p and
    Combined; JAX's float32 hook route for the smeared ones, its exact route
    for the direct terms).  (JAX's float32 window does not take a spline of
    float64 grids, so the spline is held in float64 only.)  Charge and row gradients to 2e-5
    (the A&S erfc, 1.5e-7 absolute, and float32 sums of cancelling terms, as
    for Coulomb in test_torch_window.py), the energy to 5e-5; the weights' gradient,
    which the port sums in float64 per member, to 1e-5 of JAX's float64."""
    e_j, g_j, rows = _jax_window(name, "float32")
    e, g = _port_window(name, system, rows, "float32")
    # the energy is a sum of O(1) pair terms that cancels to |E| ~ 0.1: 5e-5
    assert abs(e - e_j) <= 5e-5 * abs(e_j)
    for got, ref in zip(g[:2], g_j[:2]):
        assert got.dtype == np.float32 and rel(got, ref) <= 2e-5
    if name in COMBINED:
        _, g64 = _port_window(name, system, rows.astype(np.float64), "float64")
        assert rel(g[3], g64[3]) <= 1e-5


def _window_inputs(system, dtype, device="cpu"):
    pos, q, cell, clist_j = system
    clist = port_clist(clist_j)
    n_cells, cap = clist.slot_mask.shape
    rows = rows_of(clist_j, pos)
    idx = clist.atom_index.long()
    pc_t, q_g, mf_g, offs, _ = port_rc._prepare_bucketed(
        torch.tensor(q)[idx], torch.tensor(rows[: n_cells * cap]).reshape(n_cells, cap, 3),
        torch.tensor(cell), clist)
    return [t.to(device=device, dtype=dtype) for t in (pc_t, q_g, mf_g, offs)]


@pytest.mark.parametrize("name", ["ipl3", "ipl6_direct", "combined4", "spline"])
def test_image_term_is_the_cell_gradient_through_the_frame(system, name):
    """The window's image term (the plain twin's fourth gradient, −Σ m ⊗ g
    over the pairs with m the pair's integer image, kernel C's form) is what
    d_pc and d_offs give through the cell centres and the offsets by the
    chain rule (float64, ≤ 1e-10); with ``window=True`` the frame carries no
    gradient, so d_pc reaches the cell only through the atoms' wraps."""
    pos, q, cell, _ = system
    pos = pos + np.outer(np.arange(len(pos)) % 3 - 1, cell[0])  # atoms outside the box: wraps
    clist = port_rc.compute_cell_list(pos, cell, CUTOFF, device="cpu")
    assert bool((clist.atom_wrap != 0).any())
    n_cells, cap = clist.slot_mask.shape
    idx = clist.atom_index.long()
    rows, q_rows = torch.tensor(pos)[idx], torch.tensor(q)[idx]
    c = torch.tensor(cell, requires_grad=True)
    pc_t, q_g, mf_g, offs, _ = port_rc._prepare_bucketed(q_rows, rows, c, clist)
    _, (d_pc, _, d_offs, d_image) = port_rc._we_value_and_grad(
        _pots(tpt, name), CUTOFF, pc_t.detach(), q_g, mf_g, offs.detach())
    chain = torch.autograd.grad((pc_t, offs), c, (d_pc, d_offs))[0]
    d_rows = d_pc.reshape(n_cells, 3, cap).transpose(1, 2)
    wraps = -torch.einsum("nca,ncb->ab", clist.atom_wrap.double(), d_rows)
    assert float(d_image.abs().max()) > 0.0
    assert rel(d_image.numpy(), (chain - wraps).numpy()) <= 1e-10
    pc_w, _, _, offs_w, _ = port_rc._prepare_bucketed(q_rows, rows, c, clist, window=True)
    assert torch.equal(pc_w, pc_t) and not offs_w.requires_grad
    (through_wraps,) = torch.autograd.grad(pc_w, c, d_pc)
    assert rel(through_wraps.numpy(), wraps.numpy()) <= 1e-12


@pytest.mark.parametrize("name", COMBINED)
def test_member_energies_are_the_weight_gradient(system, name):
    """The float32 plain version's dE/dw (each member's energy, float64
    sums, kernel C's form) sums with the weights to the energy, and matches
    the float64 exact route's autograd dE/dw."""
    pot = _pots(tpt, name)
    ins = _window_inputs(system, torch.float32)
    e, _, (d_w,) = port_rc._we_value_and_grad(pot, CUTOFF, *ins, with_params=True)
    assert d_w.dtype == torch.float64 and d_w.shape == pot.weights.shape
    assert abs(float(torch.dot(pot.weights.detach(), d_w)) - float(e)) <= 1e-6 * abs(float(e))
    _, _, (d_w64,) = port_rc._we_value_and_grad(
        pot, CUTOFF, *[t.double() for t in ins], with_params=True)
    assert rel(d_w.numpy(), d_w64.numpy()) <= 1e-5
    frozen = tpt.CombinedPotential(list(pot.potentials), initial_weights=pot.weights.detach(),
                                   learnable_weights=False, smearing=pot.smearing)
    assert port_rc._we_value_and_grad(frozen, CUTOFF, *ins, with_params=True)[2] == ()


@pytest.mark.parametrize("name", NAMES)
def test_window_terms_and_card_refusal(system, name):
    """Kernel C takes the 1/r^p terms and their combinations; a spline, an
    exclusion window or another member is refused on a non-CPU device with a
    TypeError that names plain=True, never taken by the plain version."""
    terms = port_rc._window_terms(_pots(tpt, name))
    takes = name in ("ipl3", "ipl6", "ipl6_direct", "combined4", "combined_direct")
    assert (terms is not None) == takes
    ins = _window_inputs(system, torch.float32, "meta")
    if takes:
        with pytest.raises(ValueError, match="CUDA"):
            port_rc.window_value_and_grad(_pots(tpt, name), CUTOFF, *ins)
    else:
        with pytest.raises(TypeError, match="plain=True"):
            port_rc.window_value_and_grad(_pots(tpt, name), CUTOFF, *ins)


def test_kernel_table_constants():
    """The member table carries each term's exponent and constants as the
    plain pair math forms them (float32-rounded; the C++ builder is held to
    these bytes by tests/test_torch_ops_cpp.py); the weights reach the op as
    the potential's own tensor."""
    pot = _pots(tpt, "combined4")
    grid = (3, 3, 3, 8)
    p = kernel_params.window_params(port_rc.window_table(pot), CUTOFF, grid, 1)
    assert (p.kind, p.n_members, p.direct) == (2, 4, 0)
    coul, ipl = p.members[0], p.members[3]
    assert [p.members[i].p for i in range(4)] == [1, 3, 5, 6]
    weights = port_rc.window_table(pot)[0]
    assert weights is pot.weights
    np.testing.assert_array_equal(weights.detach().to(torch.float32).numpy(),
                                  W4.astype(np.float32))
    assert port_rc.window_table(_pots(tpt, "ipl3"))[0] is None
    assert ipl.alpha_sq == np.float32(0.5 / 0.9**2)
    assert coul.c_gauss == np.float32(1.0 * 2.0 / (1.0 * 2**0.5) / np.pi**0.5)
    single = _pots(tpt, "ipl3")
    p1 = kernel_params.window_params(port_rc.window_table(single), CUTOFF, grid, 1)
    assert (p1.kind, p1.n_members, p1.members[0].p) == (1, 1, 3)
    coul1 = tpt.CoulombPotential(smearing=1.0)
    table = port_rc._table(coul1, [(coul1, 1)])
    assert kernel_params.window_params(table, CUTOFF, grid, 1).kind == 0


