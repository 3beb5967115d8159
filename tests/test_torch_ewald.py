"""The port's Ewald for point charges ≡ the JAX package's:
``compute_batched_kvectors``, ``EwaldCalculator`` per atom and ``energy``
with a neighbor list and a cell list, with ``kvectors``, ``ns_kvectors`` or
neither, its gradients in positions, charges and cell, ``MDFastPathEwald``
(energy, forces, cell gradient, ``rebucket``, the numpy state of the JAX
step), and the CsCl Madelung constant.  Float64 at ≤ 1e-10: the algorithm
is the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import clist_arrays, clustered_box, random_box, rel

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.ops.kvectors import compute_batched_kvectors as jax_batched
from torchpme_tpu.utils.neighbors import compute_distances as jax_distances
from torchpme_tpu_torch.convert import (
    calculator_from_state,
    calculator_state,
    md_ewald_from_state,
    md_ewald_state,
)
from torchpme_tpu_torch.ops.kvectors import compute_batched_kvectors
from torchpme_tpu_torch.utils import neighbors as tnb

torch.set_num_threads(1)

TRICLINIC = np.array([[9.0, 0.0, 0.0], [1.5, 8.0, 0.0], [-1.0, 2.0, 10.0]])
CUTOFF = 3.0


def test_compute_batched_kvectors_matches_jax():
    cells = np.stack([np.eye(3) * 6.0, TRICLINIC, np.diag([5.0, 7.0, 9.0])])
    ours = compute_batched_kvectors(1.3, torch.tensor(cells))
    theirs = np.asarray(jax_batched(1.3, jnp.asarray(cells)))
    assert ours.shape == theirs.shape and ours.dtype == torch.float64
    assert rel(ours.numpy(), theirs) <= 1e-15
    # the padding is zero vectors, at the end of the shorter sets
    n_k = [tpt.ops.generate_kvectors_for_ewald(torch.tensor(c), tpt.ops.get_ns_ewald(c, 1.3))
           .shape[0] for c in cells]
    assert max(n_k) == ours.shape[1] and min(n_k) < max(n_k)
    short = int(np.argmin(n_k))
    assert float(ours[short, n_k[short]:].abs().max()) == 0.0


@pytest.fixture(scope="module")
def ewald_box():
    positions, q, _ = random_box(80, 9.0, seed=41)
    positions = positions @ np.linalg.inv(np.eye(3) * 9.0) @ TRICLINIC
    q = np.concatenate([q, q[::-1] * 0.5], axis=1)
    return positions, q, TRICLINIC


def _jax_call(calc, positions, q, cell, idx, shifts, **kw):
    def pot(p, qq, c):
        d = jax_distances(p, jnp.asarray(idx), c, jnp.asarray(shifts))
        return calc(qq, c, p, jnp.asarray(idx), d, **kw)

    def total(p, qq, c):
        out = pot(p, qq, c)
        return jnp.sum(out * qq), out

    # one compilation for the values and the gradients
    (_, out), grads = jax.jit(jax.value_and_grad(total, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(positions), jnp.asarray(q), jnp.asarray(cell)
    )
    return (np.asarray(out), *(np.asarray(g) for g in grads))


@pytest.mark.parametrize("kind", ["ns_kvectors", "kvectors", "eager"])
@pytest.mark.parametrize("full", [False, True], ids=["half", "full"])
def test_ewald_calculator_matches_jax(ewald_box, kind, full):
    """Per-atom potentials and the gradients of sum(pot·q) in positions,
    charges and cell; precomputed ``kvectors`` are independent of the cell
    (the JAX contract), ``ns_kvectors`` rebuild them from it."""
    positions, q, cell = ewald_box
    idx, _, shifts = tnb.neighbor_list(positions, cell, CUTOFF, full_list=full)
    calc_j = tpme.EwaldCalculator(tpme.CoulombPotential(smearing=1.0), lr_wavelength=1.2,
                                  full_neighbor_list=full)
    calc = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=1.2,
                               full_neighbor_list=full)
    ns_k = calc.get_ns_kvectors(cell)
    assert ns_k == calc_j.get_ns_kvectors(cell)
    kw_j, kw = {}, {}
    if kind == "ns_kvectors":
        kw_j = kw = {"ns_kvectors": ns_k}
    elif kind == "kvectors":
        kw_j = {"kvectors": calc_j.compute_kvectors(jnp.asarray(cell))}
        kw = {"kvectors": calc.compute_kvectors(torch.tensor(cell))}
        assert rel(kw["kvectors"].numpy(), kw_j["kvectors"]) <= 1e-15
    theirs = (
        _jax_call(calc_j, positions, q, cell, idx, shifts, **kw_j) if kind != "eager"
        else _jax_call(calc_j, positions, q, cell, idx, shifts, ns_kvectors=ns_k)
    )
    p, qq, c = (torch.tensor(a, requires_grad=True) for a in (positions, q, cell))
    d = tnb.compute_distances(p, torch.tensor(idx), c, torch.tensor(shifts))
    pot = calc(qq, c, p, torch.tensor(idx), d, **kw)
    grads = torch.autograd.grad(torch.sum(pot * qq), (p, qq, c))
    ours = (pot.detach().numpy(), *(g.numpy() for g in grads))
    for name, a, b in zip(("potentials", "positions", "charges", "cell"), ours, theirs):
        assert rel(a, b) <= 1e-10, (name, rel(a, b))
    # the quadratic energy ≡ sum(pot·q), on the neighbor list and a cell list
    with torch.no_grad():
        e = calc.energy(qq, c, p, torch.tensor(idx), d, **kw)
        clist = tpt.ops.compute_cell_list(p, c, CUTOFF)
        e_cl = calc.energy(qq, c, p, cell_list=clist, **kw)
    e_sum = float(np.sum(theirs[0] * q))
    assert abs(float(e) - e_sum) <= 1e-10 * abs(e_sum)
    assert abs(float(e_cl) - e_sum) <= 1e-10 * abs(e_sum)


def test_ewald_energy_gradients_match_jax(ewald_box):
    """The quadratic energy's own gradients (the MD path) in positions,
    charges and cell, against JAX's."""
    positions, q, cell = ewald_box
    q = q[:, :1]
    calc_j = tpme.EwaldCalculator(tpme.CoulombPotential(smearing=1.0), lr_wavelength=1.2)
    calc = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=1.2)
    ns_k = calc.get_ns_kvectors(cell)
    e_j, g_j = jax.jit(jax.value_and_grad(
        lambda p, qq, c: calc_j._compute_kspace_energy(qq, c, p, ns_kvectors=ns_k),
        argnums=(0, 1, 2)))(jnp.asarray(positions), jnp.asarray(q), jnp.asarray(cell))
    p, qq, c = (torch.tensor(a, requires_grad=True) for a in (positions, q, cell))
    e = calc._compute_kspace_energy(qq, c, p, ns_kvectors=ns_k)
    grads = torch.autograd.grad(e, (p, qq, c))
    assert abs(float(e.detach()) - float(e_j)) <= 1e-10 * abs(float(e_j))
    for a, b in zip(grads, g_j):
        assert rel(a.numpy(), np.asarray(b)) <= 1e-10
    # a periodic mask of two directions adds the slab term on both paths
    periodic = torch.tensor([True, True, False])
    e_slab = calc._compute_kspace_energy(qq, c, p, periodic=periodic, ns_kvectors=ns_k)
    e_slab_j = jax.jit(lambda qq, c, p: calc_j._compute_kspace_energy(
        qq, c, p, periodic=jnp.asarray([True, True, False]), ns_kvectors=ns_k))(
        jnp.asarray(q), jnp.asarray(cell), jnp.asarray(positions))
    assert abs(float(e_slab.detach()) - float(e_slab_j)) <= 1e-10 * abs(float(e_slab_j))


@pytest.mark.parametrize("calc_name", ["ewald", "p3m"])
def test_cscl_madelung_constant_ewald(calc_name):
    positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=torch.float64)
    charges = torch.tensor([[-1.0], [1.0]], dtype=torch.float64)
    cell = torch.eye(3, dtype=torch.float64)
    idx, dist, _ = tnb.neighbor_list(positions, cell, cutoff=1.2)
    if calc_name == "ewald":
        calc = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=0.25), lr_wavelength=0.15)
        tol = 1e-6
    else:
        calc = tpt.P3MCalculator(tpt.CoulombPotential(smearing=0.25), mesh_spacing=0.1,
                                 mesh_backend="scatter")
        tol = 1e-3
    pot = calc(charges, cell, positions, torch.tensor(idx), torch.tensor(dist))
    assert abs(-float(torch.sum(pot * charges)) - 2.0353610945) <= tol


def test_ewald_options_and_state():
    with pytest.raises(ValueError, match="range radius"):
        tpt.EwaldCalculator(tpt.CoulombPotential())
    with pytest.raises(ValueError, match="lr_wavelength"):
        tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=0.0)
    calc = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=0.8)
    state = calculator_state(calc)
    assert state == {"smearing": 1.0, "prefactor": 1.0, "lr_wavelength": 0.8}
    back = calculator_from_state(state)
    assert isinstance(back, tpt.EwaldCalculator) and calculator_state(back) == state
    assert "lr_wavelength=0.8" in repr(back)
    with pytest.raises(ValueError, match="EwaldCalculator"):
        tpt.MDFastPathEwald.create(
            tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0)), np.zeros((2, 3)),
            np.eye(3) * 8.0, 2.0, device="cpu",
        )


# -- MDFastPathEwald -----------------------------------------------------------------


@pytest.fixture(scope="module")
def md_case():
    pos, q, cell = clustered_box(300, 12.0, seed=5, n_cluster=30)
    calc_j = tpme.EwaldCalculator(tpme.CoulombPotential(smearing=1.0), lr_wavelength=1.5)
    fp_j = tpme.MDFastPathEwald.create(calc_j, jnp.asarray(pos), jnp.asarray(cell), CUTOFF)
    assert fp_j.clist.extra_index is not None  # the cluster spills
    rows = fp_j.bucket(jnp.asarray(pos))
    e, (g_q, g_cell, g_rows) = jax.jit(jax.value_and_grad(fp_j.energy, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(cell), rows
    )
    ref = (float(e), -np.asarray(fp_j.unbucket(g_rows)), np.asarray(g_q), np.asarray(g_cell))
    return fp_j, ref, (pos, q, cell)


def _port_step(fp, pos, q, cell):
    qq, c = torch.tensor(q, requires_grad=True), torch.tensor(cell, requires_grad=True)
    rows = fp.bucket(torch.tensor(pos)).requires_grad_()
    e = fp.energy(qq, c, rows)
    g_rows, g_q, g_cell = torch.autograd.grad(e, (rows, qq, c))
    return float(e.detach()), -fp.unbucket(g_rows).numpy(), g_q.numpy(), g_cell.numpy()


def _jax_ewald_state(fp_j) -> dict:
    """The numpy state of a JAX MDFastPathEwald (convert's keys)."""
    state = {
        "smearing": float(fp_j.calc.potential.smearing),
        "prefactor": float(fp_j.calc.potential.prefactor),
        "lr_wavelength": float(fp_j.calc.lr_wavelength),
        "n_axis": tuple(fp_j.clist.n_axis),
        "cutoff": float(fp_j.clist.cutoff),
        "slack": tuple(fp_j.clist.slack),
        "row_of_atom": np.asarray(fp_j.row_of_atom),
        "n_rows": fp_j.n_rows,
        "n_atoms": fp_j.n_atoms,
        "ns_kvectors": fp_j.ns_kvectors,
        "tiled": None,
    }
    state.update(clist_arrays(fp_j.clist))
    return state


def test_md_fast_path_ewald_matches_jax(md_case):
    fp_j, (e_j, f_j, q_j, c_j), (pos, q, cell) = md_case
    calc = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=1.5)
    fp = tpt.MDFastPathEwald.create(calc, torch.tensor(pos), torch.tensor(cell), CUTOFF)
    assert fp.ns_kvectors == fp_j.ns_kvectors and fp.n_rows == fp_j.n_rows
    np.testing.assert_array_equal(fp.row_of_atom.numpy(), np.asarray(fp_j.row_of_atom))
    e, f, g_q, g_c = _port_step(fp, pos, q, cell)
    assert abs(e - e_j) <= 1e-10 * abs(e_j)
    assert rel(f, f_j) <= 1e-10 and rel(g_q, q_j) <= 1e-10 and rel(g_c, c_j) <= 1e-10
    # ≡ the calculator's energy over a cell list of the same capacity
    clist = tpt.ops.compute_cell_list(torch.tensor(pos), torch.tensor(cell), CUTOFF,
                                      capacity=fp.clist.slot_mask.shape[1], spill=True)
    e_ref = calc.energy(torch.tensor(q), torch.tensor(cell), torch.tensor(pos), cell_list=clist,
                        ns_kvectors=fp.ns_kvectors)
    assert abs(float(e_ref) - e) <= 1e-10 * abs(e)


def test_md_fast_path_ewald_state_rebucket_and_staleness(md_case):
    fp_j, (e_j, f_j, _, _), (pos, q, cell) = md_case
    fp = md_ewald_from_state(_jax_ewald_state(fp_j), device="cpu")
    e, f, _, _ = _port_step(fp, pos, q, cell)
    assert abs(e - e_j) <= 1e-10 * abs(e_j) and rel(f, f_j) <= 1e-10
    state = md_ewald_state(fp)
    assert state.keys() == _jax_ewald_state(fp_j).keys()
    again = md_ewald_state(md_ewald_from_state(state, device="cpu"))
    for key, value in state.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(again[key], value, err_msg=key)
        else:
            assert again[key] == value, key
    # drift one atom out of its cell: NaN, until a rebucket
    moved = pos.copy()
    moved[0] += np.array([2.5, 0.0, 0.0])
    rows = fp.bucket(torch.tensor(moved))
    assert bool(torch.isnan(fp.energy(torch.tensor(q), torch.tensor(cell), rows)))
    fresh = fp.rebucket(rows, torch.tensor(cell))
    assert fresh.clist.slot_mask.shape == fp.clist.slot_mask.shape
    e_new = fresh.energy(torch.tensor(q), torch.tensor(cell), fresh.bucket(torch.tensor(moved)))
    fp_j2 = fp_j.rebucket(fp_j.bucket(jnp.asarray(moved)), jnp.asarray(cell))
    e_new_j = float(jax.jit(fp_j2.energy)(jnp.asarray(q), jnp.asarray(cell),
                                          fp_j2.bucket(jnp.asarray(moved))))
    assert abs(float(e_new) - e_new_j) <= 1e-10 * abs(e_new_j)
