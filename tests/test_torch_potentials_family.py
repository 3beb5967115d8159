"""The port's potential family ≡ the JAX package's on the same seeded
inputs: the scalar math (``ops/math.py``), 1/r^p for p = 1..6, Combined,
Spline (plain and reciprocal, with ``ops/splines.py``) and the exclusion
windows, every method in float64 to 1e-12, plus the Combined weights as
trainable parameters and the numpy state conversion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_potential_state

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.ops import math as jax_math
from torchpme_tpu.ops import splines as jax_splines
from torchpme_tpu_torch.convert import potential_from_state, potential_state
from torchpme_tpu_torch.ops import math as port_math
from torchpme_tpu_torch.ops import splines as port_splines

torch.set_num_threads(1)

RNG = np.random.default_rng(11)
DIST = RNG.uniform(0.05, 6.0, 400)
K_SQ = np.concatenate([[0.0], RNG.uniform(1e-3, 30.0, 300)])
EXPONENTS = [1, 2, 3, 4, 5, 6]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _lax_map(fn, x):
    """JAX's float64 exp1 runs a while loop per element: map it one scalar at
    a time, so that no lane waits on another's slowest branch."""
    return np.asarray(jax.jit(lambda v: jax.lax.map(fn, v))(jnp.asarray(x)))


# -- ops/math.py ----------------------------------------------------------------


def test_exp1_float64_matches_jax():
    x = np.geomspace(1e-8, 700.0, 3001)
    ref = _lax_map(jax.scipy.special.exp1, x)
    got = port_math.exp1(torch.tensor(x)).numpy()
    assert np.max(np.abs(got - ref) / ref) <= 1e-14
    xt = torch.tensor(x[::50], requires_grad=True)
    (g,) = torch.autograd.grad(port_math.exp1(xt).sum(), xt)
    ref_g = -np.exp(-x[::50]) / x[::50]  # dE1/dx (JAX's own jvp of expn loops at n = 0)
    assert np.max(np.abs(g.numpy() - ref_g) / np.abs(ref_g)) <= 1e-14
    edge = port_math.exp1(torch.tensor([0.0, -1.0], dtype=torch.float64)).numpy()
    assert edge[0] == np.inf and np.isnan(edge[1])


def test_exp1_float32_is_the_as_form():
    x = np.geomspace(1e-6, 80.0, 2001).astype(np.float32)
    got = port_math.exp1(torch.tensor(x)).numpy()
    ref = np.asarray(jax_math.exp1(jnp.asarray(x)))
    assert got.dtype == np.float32
    # the two packages evaluate one rational form in float32: a few ulp of
    # E1 ≤ 18, and the A&S error (2e-7 absolute) against the exact function
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    exact = _lax_map(jax.scipy.special.exp1, x.astype(np.float64))
    assert np.all(np.abs(got - exact) <= 2e-7 + 2.0**-23 * exact)
    assert port_math.exp1(torch.tensor([0.0], dtype=torch.float32)).item() == np.inf


@pytest.mark.parametrize("p", EXPONENTS)
def test_incomplete_gamma_forms_match_jax(p):
    z = np.geomspace(1e-4, 50.0, 800)
    lo = jax_math.gammainc_over_powerlaw(p, jnp.asarray(z))
    up = _lax_map(lambda s: jax_math.gammaincc_over_powerlaw(p, s), z)
    assert _rel(port_math.gammainc_over_powerlaw(p, torch.tensor(z)), lo) <= 1e-12
    assert _rel(port_math.gammaincc_over_powerlaw(p, torch.tensor(z)), up) <= 1e-12
    assert abs(float(port_math.gamma(p / 2)) - float(jax_math.gamma(jnp.asarray(p / 2)))) <= 1e-14
    for fn in (port_math.gammainc_over_powerlaw, port_math.gammaincc_over_powerlaw):
        with pytest.raises(ValueError, match="exponent"):
            fn(7, torch.tensor(z))


def test_custom_exp1_alias():
    assert port_math.CustomExp1 is port_math.exp1


# -- potentials ------------------------------------------------------------------


SPLINE_R = np.linspace(0.1, 20.0, 400)
SPLINE_Y = np.asarray(tpme.CoulombPotential(smearing=1.0).lr_from_dist(jnp.asarray(SPLINE_R)))


def _spline(pkg, reciprocal):
    arr = jnp.asarray if pkg is tpme else torch.tensor
    return pkg.SplinePotential(arr(SPLINE_R), arr(SPLINE_Y), reciprocal=reciprocal, smearing=1.0)


def _family():
    """(name, JAX potential, port potential) for every member of the family."""
    out = []
    for p in EXPONENTS:
        kw = dict(exponent=p, smearing=1.3, prefactor=0.7)
        out.append((f"ipl{p}", tpme.InversePowerLawPotential(**kw),
                    tpt.InversePowerLawPotential(**kw)))
    kw = dict(exponent=3, smearing=1.1, exclusion_radius=1.7, exclusion_degree=2)
    out.append(("ipl3_exclusion", tpme.InversePowerLawPotential(**kw),
                tpt.InversePowerLawPotential(**kw)))
    kw = dict(smearing=1.2, exclusion_radius=2.0, exclusion_degree=3, prefactor=2.0)
    out.append(("coulomb_exclusion", tpme.CoulombPotential(**kw), tpt.CoulombPotential(**kw)))
    w = np.array([0.8, -0.35])
    out.append((
        "combined",
        tpme.CombinedPotential([tpme.CoulombPotential(smearing=1.0),
                                tpme.InversePowerLawPotential(exponent=6, smearing=0.9)],
                               initial_weights=jnp.asarray(w), smearing=1.0),
        tpt.CombinedPotential([tpt.CoulombPotential(smearing=1.0),
                               tpt.InversePowerLawPotential(exponent=6, smearing=0.9)],
                              initial_weights=torch.tensor(w), smearing=1.0),
    ))
    for recip in (False, True):
        out.append((f"spline_{'reciprocal' if recip else 'plain'}", _spline(tpme, recip),
                    _spline(tpt, recip)))
    return out


FAMILY = _family()
IDS = [name for name, _, _ in FAMILY]
FAMILY_BY_NAME = {name: ((tpme, pj), (tpt, pt)) for name, pj, pt in FAMILY}
METHODS = ("from_dist", "sr_from_dist", "lr_from_dist")


@pytest.mark.parametrize("name,pot_j,pot_t", FAMILY, ids=IDS)
def test_potential_methods_match_jax(name, pot_j, pot_t):
    d_j, d_t = jnp.asarray(DIST), torch.tensor(DIST)
    for method in METHODS:
        ref = getattr(pot_j, method)(d_j)
        assert _rel(getattr(pot_t, method)(d_t).detach(), ref) <= 1e-12, method
    k_ref = pot_j.lr_from_k_sq(jnp.asarray(K_SQ))
    assert _rel(pot_t.lr_from_k_sq(torch.tensor(K_SQ)).detach(), k_ref) <= 1e-12
    for method in ("self_contribution", "background_correction"):
        ref = float(getattr(pot_j, method)())
        got = float(torch.as_tensor(getattr(pot_t, method)(), dtype=torch.float64).detach())
        assert abs(got - ref) <= 1e-12 * max(abs(ref), 1.0), method
    if pot_j.exclusion_radius is not None:
        assert _rel(pot_t.f_cutoff(d_t), pot_j.f_cutoff(d_j)) <= 1e-15


@pytest.mark.parametrize("p", EXPONENTS)
def test_inverse_power_law_hooks_match_jax(p):
    pot_j = tpme.InversePowerLawPotential(exponent=p, smearing=1.3, prefactor=0.7)
    pot_t = tpt.InversePowerLawPotential(exponent=p, smearing=1.3, prefactor=0.7)
    d_j, d_t = jnp.asarray(DIST), torch.tensor(DIST)
    sr_j, sr_t = pot_j.sr_from_dist(d_j), pot_t.sr_from_dist(d_t)
    assert _rel(pot_t.sr_derivative(d_t, sr_t), pot_j.sr_derivative(d_j, sr_j)) <= 1e-12
    vq = RNG.normal(size=DIST.shape)
    assert _rel(pot_t.sr_pair_force(d_t, torch.tensor(vq), torch.tensor(vq) * sr_t),
                pot_j.sr_pair_force(d_j, jnp.asarray(vq), jnp.asarray(vq) * sr_j)) <= 1e-12
    # the analytic derivative is autograd's
    dd = d_t.clone().requires_grad_()
    (auto,) = torch.autograd.grad(pot_t.sr_from_dist(dd).sum(), dd)
    assert _rel(pot_t.sr_derivative(d_t, sr_t), auto) <= 1e-10
    d2 = (DIST[DIST > 0.3] ** 2).astype(np.float32)
    vj, wj = pot_j.sr_window_math(jnp.asarray(d2))
    vt, wt = pot_t.sr_window_math(torch.tensor(d2))
    assert vt.dtype == torch.float32
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=2e-6, atol=1e-7 * float(jnp.max(jnp.abs(vj))))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=2e-6, atol=1e-7 * float(jnp.max(jnp.abs(wj))))


def test_inverse_power_law_validates_exponent():
    for bad in (0, 7, 2.5):
        with pytest.raises(ValueError, match="exponent"):
            tpt.InversePowerLawPotential(exponent=bad, smearing=1.0)


def test_combined_hooks_and_validation():
    pots = [tpt.CoulombPotential(smearing=1.0), tpt.InversePowerLawPotential(exponent=6, smearing=0.9)]
    comb = tpt.CombinedPotential(pots, initial_weights=torch.tensor([0.8, -0.35]), smearing=1.0)
    assert comb.sr_derivative is not None and comb.sr_window_math is not None
    assert isinstance(comb.weights, torch.nn.Parameter)
    frozen = tpt.CombinedPotential(pots, learnable_weights=False, smearing=1.0)
    assert not isinstance(frozen.weights, torch.nn.Parameter)
    assert [n for n, _ in frozen.named_buffers()] == ["weights"]
    spl = tpt.SplinePotential(torch.linspace(0.1, 5.0, 50, dtype=torch.float64),
                              torch.linspace(1.0, 0.1, 50, dtype=torch.float64), smearing=1.0)
    mixed = tpt.CombinedPotential([pots[0], spl], smearing=1.0)
    assert mixed.sr_derivative is None and mixed.sr_window_math is None
    with pytest.raises(ValueError, match="direct"):
        tpt.CombinedPotential([tpt.CoulombPotential(), pots[0]], smearing=1.0)
    with pytest.raises(ValueError, match="specify a `smearing`"):
        tpt.CombinedPotential(pots)
    with pytest.raises(ValueError, match="Cannot specify"):
        tpt.CombinedPotential([tpt.CoulombPotential()], smearing=1.0)
    with pytest.raises(ValueError, match="number of initial weights"):
        tpt.CombinedPotential(pots, initial_weights=torch.ones(3), smearing=1.0)


def test_combined_weight_gradients_match_jax():
    """d/dw of the pair, k-space, self and background terms: autograd
    through the weights parameter ≡ jax.grad through the weights leaf."""
    w = np.array([0.8, -0.35])

    def jax_terms(weights):
        pot = tpme.CombinedPotential(
            [tpme.CoulombPotential(smearing=1.0),
             tpme.InversePowerLawPotential(exponent=3, smearing=0.9)],
            initial_weights=weights, smearing=1.0)
        return (jnp.sum(pot.sr_from_dist(jnp.asarray(DIST)))
                + jnp.sum(pot.lr_from_k_sq(jnp.asarray(K_SQ)))
                + pot.self_contribution() + pot.background_correction())

    ref = np.asarray(jax.grad(jax_terms)(jnp.asarray(w)))
    pot = tpt.CombinedPotential(
        [tpt.CoulombPotential(smearing=1.0), tpt.InversePowerLawPotential(exponent=3, smearing=0.9)],
        initial_weights=torch.tensor(w), smearing=1.0)
    total = (pot.sr_from_dist(torch.tensor(DIST)).sum() + pot.lr_from_k_sq(torch.tensor(K_SQ)).sum()
             + pot.self_contribution() + pot.background_correction())
    (g,) = torch.autograd.grad(total, pot.weights)
    assert _rel(g, ref) <= 1e-12


def test_exclusion_radius_validated():
    with pytest.raises(ValueError, match="exclusion_radius"):
        tpt.CoulombPotential(smearing=1.0, exclusion_radius=0.0)
    pot = tpt.CoulombPotential(smearing=1.0)
    with pytest.raises(ValueError, match="exclusion_radius"):
        pot.f_cutoff(torch.tensor([1.0]))


# -- ops/splines.py -----------------------------------------------------------------


def test_spline_tier_matches_jax():
    x = np.sort(RNG.uniform(0.0, 8.0, 60))
    y = np.sin(x) * np.exp(-0.2 * x)
    d2_ref = np.asarray(jax.jit(jax_splines.compute_second_derivatives)(jnp.asarray(x),
                                                                        jnp.asarray(y)))
    d2 = port_splines.compute_second_derivatives(torch.tensor(x), torch.tensor(y))
    assert _rel(d2, d2_ref) <= 1e-12
    xq = RNG.uniform(-0.5, 8.5, 300)
    sp_t = port_splines.CubicSpline(torch.tensor(x), torch.tensor(y))
    ref = jax.jit(lambda a, b, c: jax_splines.CubicSpline.from_points(a, b)(c))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq))
    assert _rel(sp_t(torch.tensor(xq)), ref) <= 1e-12
    xr = x[x > 0.2]
    rs_t = port_splines.CubicSplineReciprocal(torch.tensor(xr), torch.tensor(np.sin(xr)))
    xq2 = np.abs(xq) + 0.01
    ref = jax.jit(lambda a, b, c: jax_splines.CubicSplineReciprocal.from_points(a, b)(c))(
        jnp.asarray(xr), jnp.asarray(np.sin(xr)), jnp.asarray(xq2))
    assert _rel(rs_t(torch.tensor(xq2)), ref) <= 1e-12
    # below k·h ~ 0.1 the per-interval k^-6 pole removal cancels digits in
    # either package's summation order
    k = np.concatenate([[0.0], np.geomspace(0.05, 20.0, 80)])
    ft_j = jax.jit(jax_splines.compute_spline_ft)(jnp.asarray(k), jnp.asarray(x), jnp.asarray(y),
                                                  jnp.asarray(d2_ref))
    ft_t = port_splines.compute_spline_ft(torch.tensor(k), torch.tensor(x), torch.tensor(y), d2)
    assert _rel(ft_t, ft_j) <= 1e-12
    a, b, c, d = (RNG.uniform(0.1, 1.0, 9) for _ in range(4))
    b = b + 3.0
    ref = np.asarray(jax.jit(jax_splines.solve_tridiagonal)(*map(jnp.asarray, (a, b, c, d))))
    assert _rel(port_splines.solve_tridiagonal(*map(torch.tensor, (a, b, c, d))), ref) <= 1e-13


# -- state ----------------------------------------------------------------------


@pytest.mark.parametrize("name,pot_j,pot_t", FAMILY, ids=IDS)
def test_potential_state_round_trip(name, pot_j, pot_t):
    """The JAX potential's numpy state builds the port's, which gives the
    same values and writes the same state back."""
    state = jax_potential_state(pot_j)
    port = potential_from_state(state)
    assert type(port) is type(pot_t)
    d = torch.tensor(DIST)
    for method in METHODS:
        assert _rel(getattr(port, method)(d).detach(), getattr(pot_j, method)(jnp.asarray(DIST))) <= 1e-12
    again = potential_state(port)
    assert again.keys() == state.keys()
    for key, value in state.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(again[key], value)
        elif key != "members":
            assert again[key] == value, key


# -- calculators over the family ----------------------------------------------------

CALC_CUTOFF = 3.1
CALC_W = np.array([0.9, -0.3])


def _calc_pot(pkg, name, weights):
    """(potential, learnable?) of calculator case ``name`` in ``pkg``."""
    arr = jnp.asarray if pkg is tpme else torch.tensor
    if name == "direct_ipl6":
        return pkg.InversePowerLawPotential(exponent=6, prefactor=0.5)
    if name == "direct_combined_exclusion":
        return pkg.CombinedPotential(
            [pkg.CoulombPotential(), pkg.InversePowerLawPotential(exponent=2)],
            initial_weights=weights, exclusion_radius=1.4)
    if name == "ewald_combined":
        return pkg.CombinedPotential(
            [pkg.CoulombPotential(smearing=1.0), pkg.InversePowerLawPotential(exponent=3, smearing=1.0)],
            initial_weights=weights, smearing=1.0)
    if name == "pme_combined_exclusion":  # an exclusion window on a member
        return pkg.CombinedPotential(
            [pkg.CoulombPotential(smearing=1.0, exclusion_radius=1.6),
             pkg.InversePowerLawPotential(exponent=6, smearing=1.0)],
            initial_weights=weights, smearing=1.0)
    if name == "p3m_ipl5":
        return pkg.InversePowerLawPotential(exponent=5, smearing=1.0, prefactor=2.0)
    if name == "pme_spline":  # the family's reciprocal spline (JAX builds it once)
        return dict(FAMILY_BY_NAME["spline_reciprocal"])[pkg]
    raise KeyError(name)


def _calc(pkg, name, pot):
    kind = name.split("_")[0]
    if kind == "direct":
        return pkg.Calculator(pot)
    if kind == "ewald":
        return pkg.EwaldCalculator(pot, lr_wavelength=1.5)
    cls = pkg.PMECalculator if kind == "pme" else pkg.P3MCalculator
    return cls(pot, mesh_spacing=0.6, interpolation_nodes=4, mesh_backend="scatter")


CALC_CASES = ["direct_ipl6", "direct_combined_exclusion", "ewald_combined",
              "pme_combined_exclusion", "pme_spline", "p3m_ipl5"]


@pytest.fixture(scope="module")
def calc_box():
    from torch_port_common import random_box

    pos, q, cell = random_box(60, 8.0, seed=31)
    cell = cell + np.asarray([[0.0, 0.0, 0.0], [0.4, 0.0, 0.0], [-0.3, 0.2, 0.0]])
    return pos, q, cell


@pytest.mark.parametrize("name", CALC_CASES)
def test_calculators_match_jax(calc_box, name):
    """Per-atom potentials over a neighbor list and over a cell list, and the
    gradients of sum(pot·q) in positions, charges, cell and the Combined
    weights, against jax.grad in float64 (≤ 1e-10); and the energy over the
    cell list (``calc.energy(cell_list=)``: the window of kernel C's plain
    version, its parameter cotangents included) with the same gradients."""
    from torchpme_tpu.utils.neighbors import compute_distances as jax_distances
    from torchpme_tpu_torch.utils import neighbors as tnb

    pos, q, cell = calc_box
    idx, _, shifts = tnb.neighbor_list(pos, cell, CALC_CUTOFF)
    combined = "combined" in name
    kw = {}
    calc_t = _calc(tpt, name, _calc_pot(tpt, name, torch.tensor(CALC_W)))
    if hasattr(calc_t, "get_ns_mesh"):
        kw = {"ns_mesh": calc_t.get_ns_mesh(torch.tensor(cell))}
    elif hasattr(calc_t, "get_ns_kvectors"):
        kw = {"ns_kvectors": calc_t.get_ns_kvectors(cell)}

    fixed = None if combined else _calc(tpme, name, _calc_pot(tpme, name, None))

    def total(p, qq, c, w):
        calc_j = fixed or _calc(tpme, name, _calc_pot(tpme, name, w))
        d = jax_distances(p, jnp.asarray(idx), c, jnp.asarray(shifts))
        out = calc_j(qq, c, p, jnp.asarray(idx), d, **kw)
        return jnp.sum(out * qq), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(total, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(a) for a in (pos, q, cell, CALC_W)))
    theirs = [np.asarray(out_j), *(np.asarray(g) for g in grads_j[: 4 if combined else 3])]
    clist = tpt.ops.compute_cell_list(pos, cell, CALC_CUTOFF, device="cpu")
    e_ref = float(np.sum(theirs[0] * q))
    for over in ("neighbor_list", "cell_list", "cell_list_energy"):
        p, qq, c = (torch.tensor(a, requires_grad=True) for a in (pos, q, cell))
        if over == "neighbor_list":
            d = tnb.compute_distances(p, torch.tensor(idx), c, torch.tensor(shifts))
            out = calc_t(qq, c, p, torch.tensor(idx), d, **kw)
        elif over == "cell_list":
            out = calc_t(qq, c, p, cell_list=clist, **kw)
        else:
            out = None
            energy = calc_t.energy(qq, c, p, cell_list=clist, **kw)
        if out is not None:
            energy = torch.sum(out * qq)
        wants = (p, qq, c, calc_t.potential.weights) if combined else (p, qq, c)
        grads = torch.autograd.grad(energy, wants)
        ours = [None if out is None else out.detach().numpy(), *(g.numpy() for g in grads)]
        assert abs(float(energy.detach()) - e_ref) <= 1e-10 * abs(e_ref), over
        for what, a, b in zip(("potentials", "positions", "charges", "cell", "weights"), ours, theirs):
            if a is not None:
                assert _rel(a, b) <= 1e-10, (over, what, _rel(a, b))
