"""The port's math, Coulomb hooks, k-space energy and scatter spread ≡ the
JAX package's on the same seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import random_box

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.ops import kspace as jax_kspace
from torchpme_tpu.ops import mesh as jax_mesh
from torchpme_tpu.ops.kvectors import generate_kvectors_for_mesh as jax_kvectors
from torchpme_tpu.ops.math import inv3 as jax_inv3
from torchpme_tpu.potentials.coulomb import slab_correction_1r as jax_slab
from torchpme_tpu_torch import prefactors
from torchpme_tpu_torch.ops import kspace, mesh
from torchpme_tpu_torch.ops.kvectors import generate_kvectors_for_mesh, get_ns_mesh
from torchpme_tpu_torch.ops.math import det3, inv3
from torchpme_tpu_torch.potentials.coulomb import slab_correction_1r

torch.set_num_threads(1)

SMEARING = 1.2836
DIST = np.random.default_rng(0).uniform(0.05, 5.0, 2000)
# float32 bars: 2e-7 absolute where the pair terms are O(1) (d >= 0.8, unit
# prefactor), plus 4e-7 relative (a few ulp) for the terms above 1; below
# d = 0.8, 1/d reaches 20 and the bar is relative only
SHORT = DIST < 0.8


def _pots():
    return (
        tpme.CoulombPotential(smearing=SMEARING, prefactor=prefactors.eV_A),
        tpt.CoulombPotential(smearing=SMEARING, prefactor=prefactors.eV_A),
    )


def test_prefactors_match():
    for name in ("SI", "eV_A", "kcalmol_A", "kJmol"):
        assert getattr(prefactors, name) == getattr(tpme.prefactors, name)


def test_potential_rejects_exclusion_radius():
    # the exclusion window is ported: only a radius that is not positive is refused
    with pytest.raises(ValueError, match="exclusion_radius"):
        tpt.CoulombPotential(smearing=1.0, exclusion_radius=0.0)
    with pytest.raises(ValueError, match="smearing"):
        tpt.PMECalculator(tpt.CoulombPotential())


def test_sr_from_dist_f64():
    pj, pt = _pots()
    ref = np.asarray(pj.sr_from_dist(jnp.asarray(DIST)))
    got = pt.sr_from_dist(torch.tensor(DIST)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13)
    np.testing.assert_allclose(
        pt.from_dist(torch.tensor(DIST)).numpy(),
        np.asarray(pj.from_dist(jnp.asarray(DIST))),
        rtol=1e-13,
    )


def _check_f32(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[~SHORT], ref[~SHORT], rtol=4e-7, atol=2e-7)
    np.testing.assert_allclose(got[SHORT], ref[SHORT], rtol=1e-6, atol=0)


def test_sr_from_dist_f32():
    pj = tpme.CoulombPotential(smearing=SMEARING)
    pt = tpt.CoulombPotential(smearing=SMEARING)
    d32 = DIST.astype(np.float32)
    _check_f32(
        pt.sr_from_dist(torch.tensor(d32)).numpy(),
        pj.sr_from_dist(jnp.asarray(d32, jnp.float32)),
    )


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sr_window_math(dtype):
    pj = tpme.CoulombPotential(smearing=SMEARING)
    pt = tpt.CoulombPotential(smearing=SMEARING)
    d2 = (DIST**2).astype(dtype)
    vj, wj = pj.sr_window_math(jnp.asarray(d2, dtype=getattr(jnp, dtype)))
    vt, wt = pt.sr_window_math(torch.tensor(d2))
    if dtype == "float64":
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-13)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-13)
    else:
        _check_f32(vt.numpy(), vj)
        _check_f32(wt.numpy(), wj)


def test_pair_force_hooks_f64():
    pj, pt = _pots()
    rng = np.random.default_rng(1)
    vq = rng.normal(size=DIST.shape)
    vj = pj.sr_from_dist(jnp.asarray(DIST))
    vt = pt.sr_from_dist(torch.tensor(DIST))
    np.testing.assert_allclose(
        pt.sr_pair_force(torch.tensor(DIST), torch.tensor(vq), torch.tensor(vq) * vt).numpy(),
        np.asarray(pj.sr_pair_force(jnp.asarray(DIST), jnp.asarray(vq), jnp.asarray(vq) * vj)),
        rtol=1e-13,
    )


def test_kernel_and_corrections():
    pj, pt = _pots()
    k_sq = np.concatenate([[0.0], DIST**2])
    np.testing.assert_allclose(
        pt.lr_from_k_sq(torch.tensor(k_sq)).numpy(),
        np.asarray(pj.lr_from_k_sq(jnp.asarray(k_sq))),
        rtol=1e-13,
    )
    assert pt.self_contribution() == pytest.approx(float(pj.self_contribution()), rel=1e-15)
    assert pt.background_correction() == pytest.approx(
        float(pj.background_correction()), rel=1e-15
    )


@pytest.mark.parametrize("periodic", [None, [True, True, False], [True, True, True]])
def test_slab_correction(periodic):
    pos, q, cell = random_box(30, 6.0, seed=4)
    cell = cell + np.diag([0.0, 0.5, 1.0])
    ref = np.asarray(
        jax_slab(
            None if periodic is None else jnp.asarray(periodic),
            jnp.asarray(pos), jnp.asarray(cell), jnp.asarray(q),
        )
    )
    got = slab_correction_1r(
        periodic, torch.tensor(pos), torch.tensor(cell), torch.tensor(q)
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


def test_inv3_det3():
    m = np.random.default_rng(2).normal(size=(3, 3)) + 3 * np.eye(3)
    np.testing.assert_allclose(
        inv3(torch.tensor(m)).numpy(), np.asarray(jax_inv3(jnp.asarray(m))), rtol=1e-14
    )
    assert float(det3(torch.tensor(m))) == pytest.approx(np.linalg.det(m), rel=1e-13)


def test_kvectors_and_filter():
    cell = np.diag([9.0, 10.0, 11.0]) + 0.3
    ns = (8, 16, 12)
    np.testing.assert_allclose(
        generate_kvectors_for_mesh(torch.tensor(cell), ns).numpy(),
        np.asarray(jax_kvectors(jnp.asarray(cell), ns)),
        rtol=1e-14, atol=1e-14,
    )
    assert get_ns_mesh(cell, 0.7) == tpme.ops.get_ns_mesh(jnp.asarray(cell), 0.7)
    np.testing.assert_array_equal(
        kspace._hermitian_fold_weights(12), jax_kspace._hermitian_fold_weights(12)
    )


def test_kspace_energy_from_rho_f64():
    """Quadratic form on cuFFT/pocketfft vs the JAX package's mesh energy,
    value and cell gradient, on the same density."""
    pj, pt = _pots()
    ns = (16, 16, 16)
    rng = np.random.default_rng(3)
    rho = rng.normal(size=(1, *ns))
    pos, q, cell = random_box(20, 7.0, seed=5)
    cell = cell + np.asarray([[0.0, 0.2, 0.0], [0.1, 0.0, 0.0], [0.0, 0.0, 0.3]])
    calc_j = tpme.PMECalculator(pj, interpolation_nodes=4)
    calc_t = tpt.PMECalculator(pt, interpolation_nodes=4)

    def e_j(c):
        return calc_j._kspace_energy_from_rho(
            jnp.asarray(rho), c, jnp.asarray(q), jnp.asarray(pos), None, ns
        )

    ej, gj = jax.jit(jax.value_and_grad(e_j))(jnp.asarray(cell))
    c_t = torch.tensor(cell, requires_grad=True)
    et = calc_t._kspace_energy_from_rho(
        torch.tensor(rho), c_t, torch.tensor(q), torch.tensor(pos), None, ns
    )
    (gt,) = torch.autograd.grad(et, c_t)
    assert float(et.detach()) == pytest.approx(float(ej), rel=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-12, atol=1e-12 * float(np.abs(gj).max()))


@pytest.mark.parametrize("method,nodes", [("Lagrange", 5), ("Lagrange", 4), ("P3M", 3)])
def test_scatter_spread_f64(method, nodes):
    """The spill atoms' scatter spread and its VJP vs the JAX package."""
    pos, q, cell = random_box(37, 5.0, seed=6, lo=-1.0, hi=6.0)
    ns = (8, 12, 10)
    inv = np.linalg.inv(cell)
    rng = np.random.default_rng(7)
    w = rng.normal(size=(1, *ns))

    def loss_j(p, c):
        interp = jax_mesh.compute_interpolation(p, jnp.asarray(inv), ns, nodes, method)
        return jnp.sum(jax_mesh.points_to_mesh(interp, c) * jnp.asarray(w))

    lj, gj = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(jnp.asarray(pos), jnp.asarray(q))
    p_t = torch.tensor(pos, requires_grad=True)
    q_t = torch.tensor(q, requires_grad=True)
    interp = mesh.compute_interpolation(p_t, torch.tensor(inv), ns, nodes, method)
    rho = mesh.points_to_mesh(interp, q_t)
    lt = torch.sum(rho * torch.tensor(w))
    gt = torch.autograd.grad(lt, (p_t, q_t))
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-12)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11, atol=1e-12)
    assert float(rho.detach().sum()) == pytest.approx(float(q.sum()), abs=1e-12)
