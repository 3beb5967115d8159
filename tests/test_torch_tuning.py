"""The port's tuning module (torchpme_tpu_torch.tuning) against the JAX
package's (torchpme_tpu.tuning), on the CPU in float64.

The same seeded numpy inputs go through both: every error bound and its
gradients; the smearing estimate and the neighbor filter; the candidates
each tuner times and the pick it makes, with the timings of both packages
replaced by one deterministic cost (so no check depends on wall-clock
order); real tunes on the CsCl Madelung oracle; and the dipolar tuners'
measured force errors.
"""

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchpme_tpu as tpme
import torchpme_tpu.tuning as jtune
import torchpme_tpu.tuning.dipole as jdipole
import torchpme_tpu.tuning.tuner as jtuner
import torchpme_tpu_torch as tpt
import torchpme_tpu_torch.tuning as ttune
import torchpme_tpu_torch.tuning.dipole as tdipole
import torchpme_tpu_torch.tuning.tuner as ttuner
from torchpme_tpu_torch.utils.neighbors import neighbor_list

sys.path.append(str(Path(__file__).parent))
from helpers import define_crystal
from torch_port_common import random_box

F64 = torch.float64
torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


@pytest.fixture(scope="module")
def box():
    """60 atoms in a 9 Å box (seed 4), neighbor list at 4 Å."""
    positions, charges, cell = random_box(60, 9.0, 4)
    idx, dist, shifts = neighbor_list(positions, cell, cutoff=4.0)
    return positions, charges, cell, idx, dist, shifts


# -- error bounds ----------------------------------------------------------------

# (class, k-space parameters) at >= 6 points each: PME nodes 3-7, P3M 1-7
BOUND_POINTS = (
    [("Ewald", 0.8, 4.0, {"lr_wavelength": lr}) for lr in (0.4, 0.9, 1.5, 2.2, 3.0, 4.5)]
    + [("PME", s, c, {"mesh_spacing": h, "interpolation_nodes": n})
       for s, c, h, n in ((0.7, 3.5, 0.3, 3), (0.9, 4.0, 0.5, 4), (1.1, 4.5, 0.8, 5),
                          (0.8, 3.0, 1.2, 6), (1.3, 5.0, 0.6, 7), (1.0, 4.2, 2.0, 5))]
    + [("P3M", s, c, {"mesh_spacing": h, "interpolation_nodes": n})
       for s, c, h, n in ((0.7, 3.5, 0.3, 1), (0.9, 4.0, 0.5, 2), (1.1, 4.5, 0.8, 3),
                          (0.8, 3.0, 1.2, 4), (1.3, 5.0, 0.6, 5), (1.0, 4.2, 2.0, 6),
                          (1.2, 3.8, 0.9, 7))]
)


def _bound_id(point):
    name, s, c, kw = point
    return f"{name}-{s}-{c}-" + "-".join(str(v) for v in kw.values())


@pytest.mark.parametrize("point", BOUND_POINTS, ids=[_bound_id(p) for p in BOUND_POINTS])
def test_error_bounds_and_gradients_match_jax(box, point):
    name, smearing, cutoff, kspace = point
    positions, charges, cell = box[:3]
    bj = getattr(jtune, f"{name}ErrorBounds")(jnp.asarray(charges), jnp.asarray(cell),
                                              jnp.asarray(positions))
    bt = getattr(ttune, f"{name}ErrorBounds")(_t(charges), _t(cell), _t(positions))
    cont = "lr_wavelength" if name == "Ewald" else "mesh_spacing"
    nodes = {} if name == "Ewald" else {"interpolation_nodes": kspace["interpolation_nodes"]}

    def f_jax(s, x, c):
        return bj(smearing=s, cutoff=c, **{cont: x}, **nodes)

    args = (smearing, kspace[cont], cutoff)
    value_j = float(f_jax(*args))
    grads_j = jax.grad(f_jax, argnums=(0, 1, 2))(*args)
    targs = [torch.tensor(a, dtype=F64, requires_grad=True) for a in args]
    value_t = bt(smearing=targs[0], cutoff=targs[2], **{cont: targs[1]}, **nodes)
    grads_t = torch.autograd.grad(value_t, targs)
    assert value_t.dtype == F64
    assert float(value_t.detach()) == pytest.approx(value_j, rel=1e-12, abs=0)
    # the same value from plain floats
    assert float(bt(smearing=smearing, cutoff=cutoff, **kspace)) == pytest.approx(
        value_j, rel=1e-12, abs=0)
    for gt, gj in zip(grads_t, grads_j):
        assert float(gt) == pytest.approx(float(gj), rel=1e-10, abs=1e-300)


@pytest.mark.parametrize(("name", "kspace", "anchor"), [
    ("Ewald", {"lr_wavelength": 0.5}, "8.4304e-05"),
    ("PME", {"mesh_spacing": 0.5, "interpolation_nodes": 3}, "1.1180e-03"),
    ("P3M", {"mesh_spacing": 0.5, "interpolation_nodes": 3}, "4.5968e-04"),
])
def test_error_bound_anchors(name, kspace, anchor):
    """The JAX package's docstring anchors; P3M's 4.5968e-04 is the JAX
    package's summation order of the a_m series (the reference's 4.5961e-04
    sums it in another)."""
    bounds = getattr(ttune, f"{name}ErrorBounds")(
        _t([[1.0], [-1.0]]), torch.eye(3, dtype=F64), _t([[0.0, 0.0, 0.0], [0.4, 0.4, 0.4]])
    )
    assert f"{float(bounds(smearing=1.0, cutoff=4.4, **kspace)):.4e}" == anchor


# -- the tuner's logic -------------------------------------------------------------


@pytest.mark.parametrize("accuracy", [1e-2, 1e-4, 1e-6])
@pytest.mark.parametrize("cutoff", [3.0, 4.0])
def test_estimate_smearing_and_filter_match_jax(box, cutoff, accuracy):
    positions, charges, cell, idx, dist, _ = box
    tj = jtuner.TunerBase(jnp.asarray(charges), jnp.asarray(cell), jnp.asarray(positions),
                          cutoff, tpme.PMECalculator)
    tt = ttuner.TunerBase(_t(charges), _t(cell), _t(positions), cutoff, tpt.PMECalculator)
    assert tt.estimate_smearing(accuracy) == pytest.approx(
        tj.estimate_smearing(accuracy), rel=1e-14, abs=0)
    idx_j, d_j = jtuner.TunerBase.filter_neighbors(cutoff, jnp.asarray(idx), jnp.asarray(dist))
    idx_t, d_t = ttuner.TunerBase.filter_neighbors(cutoff, torch.as_tensor(idx), _t(dist))
    assert idx_t.device.type == "cpu" and d_t.dtype == F64
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_non_float_accuracy_and_exponent_raise_as_in_jax(box):
    positions, charges, cell = box[:3]
    for tuner_mod, calc, arr in ((jtuner, tpme.PMECalculator, jnp.asarray),
                                 (ttuner, tpt.PMECalculator, _t)):
        tuner = tuner_mod.TunerBase(arr(charges), arr(cell), arr(positions), 4.0, calc)
        with pytest.raises(ValueError, match="'1' is not a float."):
            tuner.estimate_smearing(1)
        with pytest.raises(NotImplementedError, match="Only exponent = 1"):
            tuner_mod.TunerBase(arr(charges), arr(cell), arr(positions), 4.0, calc, exponent=2)


def _cost(timer, calculator, **extra):
    """A deterministic stand-in for a timed step, the same in both packages:
    a function of the pair count, the atom count and the k-space size."""
    n_pairs = int(timer.neighbor_indices.shape[0])
    n_atoms = int(timer.positions.shape[0])
    if "ns_mesh" in extra:
        mesh = math.prod(extra["ns_mesh"])
        k_cost = mesh * math.log2(mesh) + n_atoms * calculator.interpolation_nodes**3 * 40
    else:
        k_cost = math.prod(2 * n + 1 for n in extra["ns_kvectors"]) * n_atoms
    return 1e-9 * (k_cost + 25 * n_pairs)


@pytest.fixture
def fixed_timings(monkeypatch):
    """Both packages' TuningTimings give _cost and record what they timed."""
    calls = {"jax": [], "port": []}

    def patched(key):
        def __call__(self, calculator, **extra):
            calls[key].append((type(calculator).__name__, int(self.neighbor_indices.shape[0]),
                               tuple(sorted((k, tuple(v)) for k, v in extra.items()))))
            return _cost(self, calculator, **extra)
        return __call__

    monkeypatch.setattr(jtuner.TuningTimings, "__call__", patched("jax"))
    monkeypatch.setattr(ttuner.TuningTimings, "__call__", patched("port"))
    return calls


def _same_pick(got, expected):
    *head_t, time_t = got
    *head_j, time_j = expected
    assert time_t == time_j
    for a, b in zip(head_t, head_j):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k] == pytest.approx(b[k], rel=1e-14, abs=0), k
        else:
            assert a == pytest.approx(b, rel=1e-14, abs=0)


TUNERS = {
    "ewald": dict(ns_lo=2, ns_hi=9),
    "pme": dict(nodes_lo=3, nodes_hi=6, mesh_lo=3, mesh_hi=6),
    "p3m": dict(nodes_lo=1, nodes_hi=5, mesh_lo=3, mesh_hi=6),
}


@pytest.mark.parametrize("accuracy", [1e-3, 1e-4])
@pytest.mark.parametrize("name", TUNERS)
def test_tuners_pick_as_jax_with_the_same_timings(box, fixed_timings, name, accuracy):
    positions, charges, cell, idx, dist, _ = box
    kw = dict(cutoff=3.5, accuracy=accuracy, **TUNERS[name])
    got = getattr(ttune, f"tune_{name}")(_t(charges), _t(cell), _t(positions),
                                         neighbor_indices=torch.as_tensor(idx),
                                         neighbor_distances=_t(dist), **kw)
    expected = getattr(jtune, f"tune_{name}")(jnp.asarray(charges), jnp.asarray(cell),
                                              jnp.asarray(positions),
                                              neighbor_indices=jnp.asarray(idx),
                                              neighbor_distances=jnp.asarray(dist), **kw)
    _same_pick(got, expected)
    assert math.isfinite(got[2])
    assert fixed_timings["port"] == fixed_timings["jax"] and fixed_timings["port"]


@pytest.mark.parametrize("name", ["pme", "ewald"])
def test_tune_over_cutoffs_picks_as_jax(box, fixed_timings, name):
    positions, charges, cell, idx, dist, _ = box
    kw = dict(accuracy=1e-4, **TUNERS[name])
    got = ttune.tune_over_cutoffs(getattr(ttune, f"tune_{name}"), _t(charges), _t(cell),
                                  _t(positions), (3.0, 3.5, 4.0), torch.as_tensor(idx),
                                  _t(dist), **kw)
    expected = jtune.tune_over_cutoffs(getattr(jtune, f"tune_{name}"), jnp.asarray(charges),
                                       jnp.asarray(cell), jnp.asarray(positions),
                                       (3.0, 3.5, 4.0), jnp.asarray(idx), jnp.asarray(dist),
                                       **kw)
    _same_pick(got, expected)
    assert fixed_timings["port"] == fixed_timings["jax"]
    assert len({n_pairs for _, n_pairs, _ in fixed_timings["port"]}) == 3


def test_unreachable_accuracy_warns_and_non_float_raises_as_jax(box, fixed_timings):
    positions, charges, cell, idx, dist, _ = box
    kw = dict(cutoff=3.5, nodes_lo=3, nodes_hi=4, mesh_lo=2, mesh_hi=3)
    port_args = (_t(charges), _t(cell), _t(positions))
    jax_args = (jnp.asarray(charges), jnp.asarray(cell), jnp.asarray(positions))
    with pytest.warns(UserWarning, match="No parameter meets the accuracy requirement"):
        got = ttune.tune_pme(*port_args, neighbor_indices=torch.as_tensor(idx),
                             neighbor_distances=_t(dist), accuracy=1e-12, **kw)
    with pytest.warns(UserWarning, match="No parameter meets the accuracy requirement"):
        expected = jtune.tune_pme(*jax_args, neighbor_indices=jnp.asarray(idx),
                                  neighbor_distances=jnp.asarray(dist), accuracy=1e-12, **kw)
    _same_pick(got, expected)
    assert got[2] == float("inf") and not fixed_timings["port"]
    with pytest.raises(ValueError, match="No \\(cutoff, parameters\\) combination"):
        ttune.tune_over_cutoffs(ttune.tune_pme, *port_args, (3.0, 3.5), torch.as_tensor(idx),
                                _t(dist), accuracy=1e-12, nodes_lo=3, nodes_hi=3, mesh_lo=2,
                                mesh_hi=2)
    for tune, args, nl in ((ttune.tune_p3m, port_args, (torch.as_tensor(idx), _t(dist))),
                           (jtune.tune_p3m, jax_args, (jnp.asarray(idx), jnp.asarray(dist)))):
        with pytest.raises(ValueError, match="'1' is not a float."):
            tune(*args, 3.5, *nl, accuracy=1)


# -- real tuning on the card's path (here: the plain versions) ---------------------


@pytest.fixture(scope="module")
def cscl_supercell():
    """4x4x4 CsCl supercell (128 atoms), tests/tuning/test_tuning.py's."""
    pos1, charges1, cell1, madelung_ref, nfu = (np.asarray(a) if hasattr(a, "shape") else a
                                                for a in define_crystal("CsCl"))
    reps = 4
    shifts = np.stack(np.meshgrid(*([np.arange(reps)] * 3), indexing="ij"), -1).reshape(-1, 3)
    positions = (pos1[None] + (shifts @ cell1)[:, None]).reshape(-1, 3)
    charges = np.tile(charges1, (reps**3, 1))
    cell = cell1 * reps
    idx, dist, _ = neighbor_list(positions, cell, cutoff=4.4)
    return positions, charges, cell, idx, dist, madelung_ref, nfu * reps**3


@pytest.mark.parametrize(("name", "grid"), [
    ("ewald", dict(ns_lo=4, ns_hi=8)),
    ("pme", dict(nodes_lo=3, nodes_hi=4, mesh_lo=3, mesh_hi=5)),
    ("p3m", dict(nodes_lo=3, nodes_hi=4, mesh_lo=3, mesh_hi=5)),
])
def test_tuned_parameters_meet_the_madelung_accuracy(cscl_supercell, name, grid):
    positions, charges, cell, idx, dist, madelung_ref, n_units = cscl_supercell
    accuracy = 1e-3
    smearing, params, timing = getattr(ttune, f"tune_{name}")(
        _t(charges), _t(cell), _t(positions), 4.4, torch.as_tensor(idx), _t(dist),
        accuracy=accuracy, **grid,
    )
    assert smearing > 0 and math.isfinite(timing) and timing > 0
    calc_cls = {"ewald": tpt.EwaldCalculator, "pme": tpt.PMECalculator,
                "p3m": tpt.P3MCalculator}[name]
    calc = calc_cls(tpt.CoulombPotential(smearing=smearing), **params)
    pot = calc(_t(charges), _t(cell), _t(positions), torch.as_tensor(idx), _t(dist))
    madelung = -float(torch.sum(pot * _t(charges))) / n_units
    assert madelung == pytest.approx(madelung_ref, rel=accuracy, abs=0)


@pytest.mark.parametrize("run_backward", [True, False])
def test_timings_positive_and_finite(cscl_supercell, run_backward):
    positions, charges, cell, idx, dist = cscl_supercell[:5]
    timer = ttune.TuningTimings(_t(charges), _t(cell), _t(positions), torch.as_tensor(idx),
                                _t(dist), n_repeat=2, n_warmup=1, run_backward=run_backward)
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=0.8), mesh_spacing=0.5)
    seconds = timer(calc, ns_mesh=calc.get_ns_mesh(cell))
    assert math.isfinite(seconds) and seconds > 0


def test_host_inputs_go_to_the_card():
    """numpy inputs go to the default device: without a card that raises,
    it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy inputs go there")
    positions, charges, cell = random_box(8, 5.0, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttune.PMEErrorBounds(charges, cell, positions)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttuner.TunerBase.filter_neighbors(3.0, np.zeros((1, 2), np.int64), np.ones(1))


# -- the dipolar tuners ------------------------------------------------------------

DIPOLE_CUTOFF = 3.0


@pytest.fixture(scope="module")
def dipole_system():
    """40 dipoles in a 7 Å box (seed 3), tests/tuning/test_dipole.py's, and
    the JAX package's converged reference forces on it."""
    rng = np.random.default_rng(3)
    n, box = 40, 7.0
    positions = rng.uniform(0, box, (n, 3))
    dipoles = rng.normal(size=(n, 3))
    cell = np.eye(3) * box
    idx, _, shifts = neighbor_list(positions, cell, cutoff=DIPOLE_CUTOFF)
    vec = positions[idx[:, 1]] - positions[idx[:, 0]] + shifts @ cell
    return dipoles, cell, positions, idx, vec, shifts


def _port_dipole_args(dipole_system):
    return [torch.as_tensor(a) for a in dipole_system]


def _jax_forces(calc, jargs):
    """The JAX package's ``_forces``, traced once under ``jax.jit`` (its
    eager form compiles every operation apart: ~10 s a candidate here)."""
    dipoles, cell, positions, idx, vec, shifts = jargs
    return np.asarray(jax.jit(
        lambda p: jdipole._forces(calc, dipoles, cell, p, idx, vec, shifts))(positions))


def test_dipolar_measured_errors_match_jax(dipole_system):
    """The force errors the dipolar screen measures, for three candidates
    (one Ewald, two PME), equal the JAX package's within 1e-9."""
    jargs = [jnp.asarray(a) for a in dipole_system]
    targs = _port_dipole_args(dipole_system)
    s_ref = DIPOLE_CUTOFF / jdipole._REF_RATIO
    assert (tdipole._REF_RATIO, tdipole._REF_LR_FACTOR) == (jdipole._REF_RATIO,
                                                            jdipole._REF_LR_FACTOR)
    ref_j = tpme.CalculatorDipole(tpme.PotentialDipole(smearing=s_ref),
                                  lr_wavelength=s_ref / jdipole._REF_LR_FACTOR)
    ref_t = tpt.CalculatorDipole(tpt.PotentialDipole(smearing=s_ref),
                                 lr_wavelength=s_ref / tdipole._REF_LR_FACTOR)
    f_ref_j = _jax_forces(ref_j, jargs)
    f_ref_t = tdipole._forces(ref_t, *targs)
    np.testing.assert_allclose(f_ref_t.numpy(), f_ref_j, rtol=0,
                               atol=1e-9 * np.abs(f_ref_j).max())
    smearing = DIPOLE_CUTOFF / 4.5
    candidates = [  # as the tuners build them: ns = 10; m = 2 and 3
        ("CalculatorDipole", dict(lr_wavelength=7.0 / 10)),
        ("PMECalculatorDipole", dict(mesh_spacing=smearing / 2, interpolation_nodes=5)),
        ("PMECalculatorDipole", dict(mesh_spacing=smearing / 2**1.5, interpolation_nodes=6)),
    ]
    for cls, kw in candidates:
        calc_j = getattr(tpme, cls)(tpme.PotentialDipole(smearing=smearing), **kw)
        calc_t = getattr(tpt, cls)(tpt.PotentialDipole(smearing=smearing), **kw)
        err_j = float(np.sqrt(np.mean(np.sum((_jax_forces(calc_j, jargs) - f_ref_j) ** 2, -1))))
        f_t = tdipole._forces(calc_t, *targs)
        err_t = float(torch.sqrt(torch.mean(torch.sum((f_t - f_ref_t) ** 2, dim=-1))))
        assert abs(err_t - err_j) <= 1e-9, (cls, kw, err_t, err_j)


def test_tune_pme_dipole_meets_accuracy(dipole_system):
    dipoles, cell, positions, idx, vec, shifts = _port_dipole_args(dipole_system)
    smearing, params, timing = ttune.tune_pme_dipole(
        dipoles, cell, positions, DIPOLE_CUTOFF, idx, vec, shifts,
        nodes_lo=5, nodes_hi=6, mesh_lo=3, mesh_hi=5, accuracy=1e-3,
        smearing_ratios=(4.5, 5.5),
    )
    assert math.isfinite(timing) and timing > 0
    assert set(params) == {"mesh_spacing", "interpolation_nodes"}
    # against the port's converged Ewald, built apart from the tuner's
    ref = tpt.CalculatorDipole(tpt.PotentialDipole(smearing=0.5), lr_wavelength=0.18)
    calc = tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=smearing), **params)
    d = (tdipole._forces(calc, dipoles, cell, positions, idx, vec, shifts)
         - tdipole._forces(ref, dipoles, cell, positions, idx, vec, shifts))
    assert float(torch.sqrt(torch.mean(torch.sum(d**2, dim=-1)))) < 1e-3


def test_tune_ewald_dipole_unreachable_accuracy_warns(dipole_system):
    """An impossible accuracy warns and returns the lowest-error candidate
    with an infinite timing, as the JAX package does."""
    dipoles, cell, positions, idx, vec, shifts = _port_dipole_args(dipole_system)
    with pytest.warns(UserWarning, match="No parameter combination"):
        smearing, params, timing = ttune.tune_ewald_dipole(
            dipoles, cell, positions, DIPOLE_CUTOFF, idx, vec, shifts,
            ns_lo=1, ns_hi=2, accuracy=1e-12, smearing_ratios=(3.0,),
        )
    assert timing == float("inf") and smearing == DIPOLE_CUTOFF / 3.0
    assert set(params) == {"lr_wavelength"}


# -- chip_smoke.py's parameters come from the port's tuning module -------------------


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  Path(__file__).parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_parameters_match_the_jax_tuning(chip_smoke):
    """The main path's smearing (the port's estimate_smearing), the 12k
    Ewald wavelength (a bisection of the port's EwaldErrorBounds, rounded
    down) and the P3M geometry's error bound, each against the JAX
    package's tuning module on the same boxes."""
    cs = chip_smoke
    positions, charges, cell = cs.water_box(cs.N_ATOMS)
    jax_args = (jnp.asarray(charges), jnp.asarray(cell), jnp.asarray(positions))
    smearing = cs.smearing_for(positions, charges, cell)
    smearing_j = jtuner.TunerBase(*jax_args, cs.CUTOFF, tpme.PMECalculator).estimate_smearing(
        cs.ACCURACY)
    assert smearing == pytest.approx(smearing_j, rel=1e-14, abs=0)
    assert smearing == pytest.approx(cs.bench_smearing(charges, cell), rel=1e-14, abs=0)
    bound_j = float(jtune.P3MErrorBounds(*jax_args)(
        smearing=smearing, mesh_spacing=cs.p3m_spacing(cell), cutoff=cs.CUTOFF,
        interpolation_nodes=cs.NODES))
    assert cs.p3m_bound(positions, charges, cell, smearing) == pytest.approx(bound_j, rel=1e-12)
    assert bound_j <= cs.ACCURACY

    epos, eq, ecell = cs.water_box(cs.EWALD_N)
    lr = cs.ewald_lr(epos, eq, ecell)
    assert lr == 2.61
    bound = jtune.EwaldErrorBounds(jnp.asarray(eq), jnp.asarray(ecell), jnp.asarray(epos))

    def jax_bound(x):
        return float(bound(smearing=cs.EWALD_SMEARING, lr_wavelength=x, cutoff=cs.CUTOFF))

    # the JAX bound's root lies in [2.61, 2.62): 2.61 is its rounding down
    assert jax_bound(lr) <= cs.ACCURACY < jax_bound(lr + 0.01)
