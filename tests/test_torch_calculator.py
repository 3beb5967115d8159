"""The port's per-atom calculator call ≡ the JAX package's: the host neighbor
list, the direct sum, ``PMECalculator.forward`` with its gradients for both
mesh backends and every neighbor layout, the masks, ``energy``, the Madelung
oracle, ``MDFastPath(mesh_impl="tiled")``, the stale-bucket / overflow
guards, the device rule of the entry points and the validation messages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import clustered_box, jax_md_state, port_from_jax, random_box, rel

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.utils import neighbors as jnb
from torchpme_tpu.utils.validation import validate_parameters as jax_validate
from torchpme_tpu_torch.convert import (
    calculator_from_state,
    calculator_state,
    md_from_state,
    md_state,
)
from torchpme_tpu_torch.ops.mesh_tiled import compute_tiled_interpolation
from torchpme_tpu_torch.ops.rspace_cells import compute_cell_list
from torchpme_tpu_torch.utils import neighbors as tnb
from torchpme_tpu_torch.utils.validation import validate_parameters

torch.set_num_threads(1)

NS = (32, 32, 32)
CUTOFF = 3.0
TRICLINIC = np.array([[9.0, 0.0, 0.0], [1.5, 8.0, 0.0], [-1.0, 2.0, 10.0]])


# -- neighbor lists -------------------------------------------------------------


@pytest.mark.parametrize(
    "case",
    ["ortho-half", "ortho-full", "triclinic-half", "triclinic-full", "open", "kdtree-half",
     "kdtree-full", "default-cutoff", "unwrapped"],
)
def test_neighbor_list_identical_to_jax(case):
    rng = np.random.default_rng(11)
    kind, _, mode = case.partition("-")
    full = mode == "full"
    cutoff, periodic, cell = 3.0, True, np.eye(3) * 9.0
    positions = rng.uniform(0, 9.0, (90, 3))
    if kind == "triclinic":
        cell = TRICLINIC
        positions = rng.uniform(0, 1, (90, 3)) @ cell
    elif kind == "open":
        cell, periodic = None, False
    elif kind == "kdtree":
        cell = np.eye(3) * 14.0
        positions = rng.uniform(0, 14.0, (600, 3))
    elif kind == "default":
        cutoff = None
    elif kind == "unwrapped":
        positions = rng.uniform(-9.0, 18.0, (90, 3))
    theirs = jnb.neighbor_list(positions, cell, cutoff, full_list=full, periodic=periodic)
    ours = tnb.neighbor_list(positions, cell, cutoff, full_list=full, periodic=periodic)
    from_tensor = tnb.neighbor_list(
        torch.tensor(positions), None if cell is None else torch.tensor(cell), cutoff,
        full_list=full, periodic=periodic,
    )
    assert theirs[0].shape[0] > 50
    for a, b, c in zip(ours, theirs, from_tensor):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


def test_neighbor_list_needs_a_cutoff_without_a_cell():
    with pytest.raises(ValueError, match="`cutoff` is required"):
        tnb.neighbor_list(np.zeros((2, 3)), None, None, periodic=False)


@pytest.mark.parametrize("cell", [np.eye(3) * 9.0, TRICLINIC], ids=["ortho", "triclinic"])
def test_compute_distances_matches_jax_and_the_list(cell):
    rng = np.random.default_rng(12)
    positions = rng.uniform(0, 1, (70, 3)) @ cell
    idx, dist, shifts = tnb.neighbor_list(positions, cell, 3.0)
    p = torch.tensor(positions, requires_grad=True)
    c = torch.tensor(cell, requires_grad=True)
    d = tnb.compute_distances(p, torch.tensor(idx), c, torch.tensor(shifts))
    np.testing.assert_allclose(d.detach().numpy(), dist, rtol=0, atol=1e-12)
    d_j = jnb.compute_distances(
        jnp.asarray(positions), jnp.asarray(idx), jnp.asarray(cell), jnp.asarray(shifts)
    )
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(d_j), rtol=0, atol=1e-13)
    vec = tnb.compute_distances(p, torch.tensor(idx), c, torch.tensor(shifts), norm=False)
    assert vec.shape == (idx.shape[0], 3)
    g_p, g_c = torch.autograd.grad(d.sum(), (p, c))
    g_j = jax.grad(
        lambda p_, c_: jnb.compute_distances(p_, jnp.asarray(idx), c_, jnp.asarray(shifts)).sum(),
        argnums=(0, 1),
    )(jnp.asarray(positions), jnp.asarray(cell))
    assert rel(g_p.numpy(), g_j[0]) <= 1e-12 and rel(g_c.numpy(), g_j[1]) <= 1e-12
    with pytest.raises(ValueError, match="no `neighbor_shifts`"):
        tnb.compute_distances(p, torch.tensor(idx), cell=c)
    with pytest.raises(ValueError, match="no `cell`"):
        tnb.compute_distances(p, torch.tensor(idx), neighbor_shifts=torch.tensor(shifts))


@pytest.mark.parametrize("full", [False, True], ids=["half", "full"])
def test_dense_neighbor_format_identical_to_jax(full):
    positions, _, cell = random_box(80, 9.0, seed=13)
    idx, dist, shifts = tnb.neighbor_list(positions, cell, 3.0, full_list=full)
    ours = tnb.dense_neighbor_format(idx, dist, 80, shifts, full_list=full)
    theirs = jnb.dense_neighbor_format(idx, dist, 80, shifts, full_list=full)
    assert ours.keys() == theirs.keys()
    for key in theirs:
        np.testing.assert_array_equal(ours[key], np.asarray(theirs[key]), err_msg=key)
    with pytest.raises(ValueError, match="capacity 2 below"):
        tnb.dense_neighbor_format(idx, dist, 80, full_list=full, capacity=2)


# -- the per-atom call ----------------------------------------------------------


@pytest.fixture(scope="module")
def box():
    """A 300-atom box with a half list, a full list and the dense layout."""
    positions, q, cell = random_box(300, 14.0, seed=21)
    q = np.concatenate([q, q[::-1] * 0.5], axis=1)  # two charge channels
    lists = {}
    for name, full in (("half", False), ("full", True)):
        idx, dist, shifts = tnb.neighbor_list(positions, cell, CUTOFF, full_list=full)
        lists[name] = dict(indices=idx, shifts=shifts, full=full)
    idx, dist, shifts = lists["half"]["indices"], None, lists["half"]["shifts"]
    dense = tnb.dense_neighbor_format(
        idx, tnb.neighbor_list(positions, cell, CUTOFF)[1], 300, shifts
    )
    lists["dense"] = dict(indices=dense["indices"], shifts=dense["shifts"], mask=dense["mask"], full=True)
    return positions, q, cell, lists


def _jax_distances(p, c, lst):
    idx, shifts = jnp.asarray(lst["indices"]), jnp.asarray(lst["shifts"])
    if idx.shape[1] == 2 and shifts.ndim == 2:
        return jnb.compute_distances(p, idx, c, shifts)
    vec = p[idx] - p[:, None, :] + shifts.astype(c.dtype) @ c  # dense layout
    # padded slots hold a zero vector: keep the square root away from it
    return jnp.sqrt(jnp.where(jnp.asarray(lst["mask"]), jnp.sum(vec**2, axis=-1), 1.0))


def _port_distances(p, c, lst):
    idx, shifts = torch.tensor(lst["indices"]), torch.tensor(lst["shifts"])
    if "mask" not in lst:
        return tnb.compute_distances(p, idx, c, shifts)
    vec = p[idx.long()] - p[:, None, :] + shifts.to(c.dtype) @ c
    return torch.sqrt(torch.where(torch.tensor(lst["mask"]), torch.sum(vec**2, dim=-1), 1.0))


def _jax_call(calc, positions, q, cell, lst, **kw):
    """(potentials, d/dpositions, d/dcharges, d/dcell of sum(pot·q))."""
    mask = jnp.asarray(lst["mask"]) if "mask" in lst else None

    def pot(p, qq, c):
        return calc(qq, c, p, jnp.asarray(lst["indices"]), _jax_distances(p, c, lst),
                    pair_mask=mask, **kw)

    def value_and_grads(p, qq, c):
        values = pot(p, qq, c)
        return values, jax.grad(lambda *a: jnp.sum(pot(*a) * a[1]), argnums=(0, 1, 2))(p, qq, c)

    # one trace and compile of the whole call: eager JAX compiles every
    # operation on its own, seconds per test
    values, grads = jax.jit(value_and_grads)(
        jnp.asarray(positions), jnp.asarray(q), jnp.asarray(cell))
    return (np.asarray(values), *(np.asarray(g) for g in grads))


def _port_call(calc, positions, q, cell, lst, **kw):
    p = torch.tensor(positions, requires_grad=True)
    qq = torch.tensor(q, requires_grad=True)
    c = torch.tensor(cell, requires_grad=True)
    mask = torch.tensor(lst["mask"]) if "mask" in lst else None
    pot = calc(qq, c, p, torch.tensor(lst["indices"]), _port_distances(p, c, lst),
               pair_mask=mask, **kw)
    grads = torch.autograd.grad(torch.sum(pot * qq), (p, qq, c))
    return (pot.detach().numpy(), *(g.numpy() for g in grads))


def _assert_call_matches(ours, theirs, tol=1e-10):
    for name, a, b in zip(("potentials", "positions", "charges", "cell"), ours, theirs):
        assert a.shape == b.shape, name
        assert rel(a, b) <= tol, (name, rel(a, b))


@pytest.mark.parametrize("layout", ["half", "full", "dense"])
def test_direct_calculator_matches_jax(box, layout):
    positions, q, cell, lists = box
    lst = lists[layout]
    full = lst["full"] and layout != "dense" or layout == "dense"
    calc_j = tpme.Calculator(tpme.CoulombPotential(), full_neighbor_list=full)
    calc_t = tpt.Calculator(tpt.CoulombPotential(), full_neighbor_list=full)
    _assert_call_matches(
        _port_call(calc_t, positions, q, cell, lst), _jax_call(calc_j, positions, q, cell, lst)
    )


@pytest.mark.parametrize("layout", ["half", "full", "dense"])
@pytest.mark.parametrize("backend", ["scatter", "tiled"])
def test_pme_forward_and_gradients_match_jax(box, backend, layout):
    positions, q, cell, lists = box
    lst = lists[layout]
    kw = dict(mesh_spacing=0.5, interpolation_nodes=5, full_neighbor_list=lst["full"],
              mesh_backend=backend)
    calc_j = tpme.PMECalculator(tpme.CoulombPotential(smearing=1.0), fft_backend="fft", **kw)
    calc_t = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), **kw)
    ours = _port_call(calc_t, positions, q, cell, lst, ns_mesh=NS)
    _assert_call_matches(ours, _jax_call(calc_j, positions, q, cell, lst, ns_mesh=NS))
    assert np.abs(ours[1]).max() > 1e-2 and np.abs(ours[3]).max() > 1e-2


@pytest.mark.parametrize("backend", ["scatter", "tiled"])
def test_pme_masks_match_jax(box, backend):
    """The slab mask (two periodic directions) and a node mask."""
    positions, q, cell, lists = box
    kw = dict(mesh_spacing=0.5, interpolation_nodes=4, mesh_backend=backend)
    calc_j = tpme.PMECalculator(tpme.CoulombPotential(smearing=1.0), fft_backend="fft", **kw)
    calc_t = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), **kw)
    node_mask = np.arange(300) % 7 != 0
    periodic = np.array([True, True, False])
    ours = _port_call(calc_t, positions, q, cell, lists["half"], ns_mesh=NS,
                      periodic=torch.tensor(periodic), node_mask=torch.tensor(node_mask))
    theirs = _jax_call(calc_j, positions, q, cell, lists["half"], ns_mesh=NS,
                       periodic=jnp.asarray(periodic), node_mask=jnp.asarray(node_mask))
    _assert_call_matches(ours, theirs)
    plain = _port_call(calc_t, positions, q, cell, lists["half"], ns_mesh=NS)
    assert rel(ours[0][node_mask], plain[0][node_mask]) > 1e-6  # the slab term is there
    # the node mask zeroes the k-space part: what is left is the real-space sum
    direct = tpt.Calculator(tpt.CoulombPotential(smearing=1.0))
    p, c = torch.tensor(positions), torch.tensor(cell)
    sr = direct._compute_rspace(
        torch.tensor(q), torch.tensor(lists["half"]["indices"]), _port_distances(p, c, lists["half"])
    )
    np.testing.assert_allclose(ours[0][~node_mask], sr.numpy()[~node_mask], rtol=0, atol=1e-14)


@pytest.mark.parametrize("backend", ["scatter", "tiled"])
def test_energy_equals_sum_of_forward_and_matches_jax(box, backend):
    positions, q, cell, lists = box
    lst = lists["half"]
    kw = dict(mesh_spacing=0.5, interpolation_nodes=5, mesh_backend=backend)
    calc_j = tpme.PMECalculator(tpme.CoulombPotential(smearing=1.0), fft_backend="fft", **kw)
    calc_t = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), **kw)
    p, qq, c = torch.tensor(positions), torch.tensor(q), torch.tensor(cell, requires_grad=True)
    p.requires_grad_()
    idx = torch.tensor(lst["indices"])
    e = calc_t.energy(qq, c, p, idx, _port_distances(p, c, lst), ns_mesh=NS)
    pot = calc_t(qq, c, p, idx, _port_distances(p, c, lst), ns_mesh=NS)
    e_sum = torch.sum(pot * qq)
    assert abs(float(e.detach()) - float(e_sum.detach())) <= 1e-11 * abs(float(e_sum.detach()))
    for a, b in zip(torch.autograd.grad(e, (p, c)), torch.autograd.grad(e_sum, (p, c))):
        assert rel(a.numpy(), b.numpy()) <= 1e-10
    # one trace and compile of the JAX energy, not one per operation
    e_j = jax.jit(lambda pj, cj: calc_j.energy(jnp.asarray(q), cj, pj, jnp.asarray(lst["indices"]),
                                               _jax_distances(pj, cj, lst), ns_mesh=NS))(
        jnp.asarray(positions), jnp.asarray(cell))
    assert abs(float(e.detach()) - float(e_j)) <= 1e-10 * abs(float(e_j))
    # node_mask falls back to the per-atom path; the slab term rides the quadratic form
    node_mask = torch.arange(300) % 5 != 0
    with torch.no_grad():
        e_masked = calc_t.energy(qq, c, p, idx, _port_distances(p, c, lst), ns_mesh=NS,
                                 node_mask=node_mask)
        pot_masked = calc_t(qq, c, p, idx, _port_distances(p, c, lst), ns_mesh=NS,
                            node_mask=node_mask)
        periodic = torch.tensor([True, True, False])
        e_slab = calc_t.energy(qq, c, p, idx, _port_distances(p, c, lst), ns_mesh=NS,
                               periodic=periodic)
        pot_slab = calc_t(qq, c, p, idx, _port_distances(p, c, lst), ns_mesh=NS,
                          periodic=periodic)
    assert abs(float(e_masked) - float(torch.sum(pot_masked * qq))) <= 1e-11 * abs(float(e_masked))
    assert abs(float(e_slab) - float(torch.sum(pot_slab * qq))) <= 1e-11 * abs(float(e_slab))


def test_energy_over_a_cell_list_matches_the_neighbor_list(box):
    positions, q, cell, lists = box
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=4)
    p, qq, c = torch.tensor(positions), torch.tensor(q[:, :1].copy()), torch.tensor(cell)
    clist = compute_cell_list(p, c, CUTOFF)
    e_nl = calc.energy(qq, c, p, torch.tensor(lists["half"]["indices"]),
                       _port_distances(p, c, lists["half"]), ns_mesh=NS)
    p.requires_grad_()
    e_cl = calc.energy(qq, c, p, cell_list=clist, ns_mesh=NS)
    assert abs(float(e_cl.detach()) - float(e_nl)) <= 1e-11 * abs(float(e_nl))
    assert torch.autograd.grad(e_cl, p)[0].abs().max() > 1e-3
    # the per-atom call and direct mode take the cell list too
    pot_cl = calc(qq, c, p.detach(), cell_list=clist, ns_mesh=NS)
    assert abs(float(torch.sum(pot_cl * qq)) - float(e_nl)) <= 1e-11 * abs(float(e_nl))
    direct = tpt.Calculator(tpt.CoulombPotential())
    e_direct = direct.energy(qq, c, p.detach(), cell_list=clist)
    e_direct_nl = direct.energy(qq, c, p.detach(), torch.tensor(lists["half"]["indices"]),
                                _port_distances(p.detach(), c, lists["half"]))
    assert abs(float(e_direct) - float(e_direct_nl)) <= 1e-11 * abs(float(e_direct_nl))
    with pytest.raises(ValueError, match="not both"):
        calc.energy(qq, c, p, torch.tensor(lists["half"]["indices"]),
                    _port_distances(p, c, lists["half"]), cell_list=clist)
    with pytest.raises(ValueError, match="Provide `neighbor_indices`"):
        calc(qq, c, p)


@pytest.mark.parametrize("backend", ["scatter", "tiled"])
def test_cscl_madelung_constant(backend):
    positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=torch.float64)
    charges = torch.tensor([[-1.0], [1.0]], dtype=torch.float64)
    cell = torch.eye(3, dtype=torch.float64)
    idx, dist, _ = tnb.neighbor_list(positions, cell, cutoff=1.2)
    calc = tpt.PMECalculator(
        tpt.CoulombPotential(smearing=0.25), mesh_spacing=0.05, interpolation_nodes=5,
        mesh_backend=backend,
    )
    assert calc.get_ns_mesh(cell) == (64, 64, 64)
    pot = calc(charges, cell, positions, torch.tensor(idx), torch.tensor(dist))
    assert abs(-float(torch.sum(pot * charges)) - 2.0353610945) <= 2e-5


def test_calculator_options_validated():
    pot = tpt.CoulombPotential(smearing=1.0)
    assert tpt.PMECalculator(pot, mesh_backend="fused").mesh_backend == "fused"
    with pytest.raises(ValueError, match="mesh_backend"):
        tpt.PMECalculator(pot, mesh_backend="dense")
    with pytest.raises(ValueError, match="from 3 to 7"):
        tpt.PMECalculator(pot, interpolation_nodes=2)
    with pytest.raises(ValueError, match="smearing"):
        tpt.PMECalculator(tpt.CoulombPotential())
    with pytest.raises(TypeError, match="instance of Potential"):
        tpt.Calculator("coulomb")
    calc = tpt.PMECalculator(pot, mesh_spacing=0.5, interpolation_nodes=4, mesh_backend="scatter")
    again = calculator_from_state(calculator_state(calc), mesh_backend="scatter")
    assert calculator_state(again) == calculator_state(calc)
    assert "mesh_backend='scatter'" in repr(again)
    positions, q, cell = (torch.tensor(a) for a in random_box(20, 9.0, seed=1))
    with pytest.raises(NotImplementedError, match="kvectors"):
        calc(q, cell, positions, torch.zeros((0, 2), dtype=torch.long),
             torch.zeros(0, dtype=torch.float64), kvectors=torch.zeros((4, 3), dtype=torch.float64))
    direct = tpt.Calculator(pot)
    with pytest.raises(NotImplementedError, match="_compute_kspace"):
        direct(q, cell, positions, torch.zeros((0, 2), dtype=torch.long),
               torch.zeros(0, dtype=torch.float64))


# -- reusable tile bucketing: stale buckets, overflow, poison --------------------


def test_tiled_interp_reuse_and_stale_bucket_guards(box):
    positions, q, cell, lists = box
    lst = lists["half"]
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=4,
                             mesh_backend="tiled")
    p, qq, c = torch.tensor(positions), torch.tensor(q), torch.tensor(cell)
    idx = torch.tensor(lst["indices"])
    interp = compute_tiled_interpolation(p, torch.linalg.inv(c), NS, 4, "Lagrange")
    fresh = calc(qq, c, p, idx, _port_distances(p, c, lst), ns_mesh=NS)
    reused = calc(qq, c, p, idx, _port_distances(p, c, lst), tiled_interp=interp)
    np.testing.assert_allclose(reused.numpy(), fresh.numpy(), rtol=0, atol=1e-12)

    moved = p.clone()
    moved[5, 0] += cell[0, 0] / 2
    with pytest.raises(ValueError, match="bucketing is stale"):
        calc(qq, c, moved, idx, _port_distances(p, c, lst), tiled_interp=interp)
    with pytest.raises(ValueError, match="bucketing is stale"):
        calc._compute_kspace_energy(qq, c, moved, tiled_interp=interp)
    # without the eager check the result is poisoned, value and gradient
    moved.requires_grad_()
    e = calc._compute_kspace_energy(qq, c, moved, tiled_interp=interp, check_stale=False)
    assert torch.isnan(e) and torch.isnan(torch.autograd.grad(e, moved)[0]).all()
    e_ok = calc._compute_kspace_energy(qq, c, p, tiled_interp=interp, check_stale=False)
    assert torch.isfinite(e_ok)

    small = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=4,
                              mesh_backend="tiled", tile_capacity=8)
    with pytest.raises(ValueError, match="exceeded the tile capacity"):
        small(qq, c, p, idx, _port_distances(p, c, lst), ns_mesh=NS)
    overflowed = compute_tiled_interpolation(p, torch.linalg.inv(c), NS, 4, "Lagrange", capacity=8)
    assert int(overflowed.dropped) > 0
    with pytest.raises(ValueError, match="bucketing is stale"):
        calc(qq, c, p, idx, _port_distances(p, c, lst), tiled_interp=overflowed)


def test_auto_backend_takes_the_scatter_on_the_cpu(box, monkeypatch):
    positions, q, cell, lists = box
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=4)
    from torchpme_tpu_torch.calculators import pme

    def refuse(*args, **kwargs):
        raise AssertionError("the tiled backend ran on CPU tensors under mesh_backend='auto'")

    monkeypatch.setattr(pme, "compute_tiled_interpolation", refuse)
    p, qq, c = torch.tensor(positions), torch.tensor(q), torch.tensor(cell)
    pot = calc(qq, c, p, torch.tensor(lists["half"]["indices"]),
               _port_distances(p, c, lists["half"]), ns_mesh=NS)
    assert torch.isfinite(pot).all()


# -- MDFastPath(mesh_impl="tiled") ----------------------------------------------


def _md_calcs(nodes=5, smearing=1.0):
    kw = dict(mesh_spacing=0.5, interpolation_nodes=nodes)
    return (tpme.PMECalculator(tpme.CoulombPotential(smearing=smearing), **kw),
            tpt.PMECalculator(tpt.CoulombPotential(smearing=smearing), **kw))


def _md_port_step(fp, pos, q, cell, dtype):
    c = torch.tensor(cell, dtype=dtype, requires_grad=True)
    rows = fp.bucket(torch.tensor(pos, dtype=dtype)).requires_grad_()
    e = fp.energy(torch.tensor(q, dtype=dtype), c, rows)
    g_rows, g_cell = torch.autograd.grad(e, (rows, c))
    return float(e.detach()), g_rows.numpy(), g_cell.numpy()


def _md_jax_step(fp_j, pos, q, cell, jdt):
    rows = fp_j.bucket(jnp.asarray(pos, jdt))
    e, (g_cell, g_rows) = jax.jit(jax.value_and_grad(fp_j.energy, argnums=(1, 2)))(
        jnp.asarray(q, jdt), jnp.asarray(cell, jdt), rows
    )
    return float(e), np.asarray(g_rows), np.asarray(g_cell)


@pytest.fixture(scope="module")
def md_case():
    pos, q, cell = clustered_box(400, 16.0, seed=3, n_cluster=30)
    calc_j, calc_t = _md_calcs()
    fp_j = tpme.MDFastPath.create(
        calc_j, jnp.asarray(pos), jnp.asarray(cell), CUTOFF, NS, mesh_impl="tiled"
    )
    fp = tpt.MDFastPath.create(
        calc_t, torch.tensor(pos), torch.tensor(cell), CUTOFF, NS, mesh_impl="tiled"
    )
    return fp_j, fp, (pos, q, cell)


def test_md_tiled_matches_jax_tiled(md_case):
    fp_j, fp, (pos, q, cell) = md_case
    assert fp.mesh_impl == "tiled" and fp.cell_grid is None and fp.tiled is not None
    assert fp.calc.mesh_backend == "tiled"
    e_j, rows_j, cell_j = _md_jax_step(fp_j, pos, q, cell, jnp.float64)
    e, rows, cell_g = _md_port_step(fp, pos, q, cell, torch.float64)
    assert rows.shape == rows_j.shape  # force rows, bucket layout
    assert abs(e - e_j) <= 1e-9 * abs(e_j)
    assert rel(rows, rows_j) <= 1e-9
    assert rel(cell_g, cell_j) <= 1e-9


def test_md_tiled_state_matches_jax_and_converts(md_case):
    fp_j, fp, (pos, q, cell) = md_case
    ours, theirs = md_state(fp), jax_md_state(fp_j)
    assert ours.keys() == theirs.keys() and ours["mesh_impl"] == "tiled"
    for key, value in theirs.items():
        if key == "tiled":
            for name, arr in value.items():
                if arr is None:  # no derivative stencils on the monopole bucketing
                    assert ours[key][name] is None, name
                    continue
                np.testing.assert_allclose(ours[key][name], arr, rtol=0, atol=1e-12, err_msg=name)
        elif isinstance(value, np.ndarray):
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        elif key not in ("cell_grid", "aligned_pad"):
            assert tuple(np.atleast_1d(ours[key])) == tuple(np.atleast_1d(value)), key
    from_jax = port_from_jax(fp_j)
    back = md_from_state(md_state(fp), device="cpu")
    e = _md_port_step(fp, pos, q, cell, torch.float64)[0]
    assert _md_port_step(from_jax, pos, q, cell, torch.float64)[0] == pytest.approx(e, rel=1e-13)
    assert _md_port_step(back, pos, q, cell, torch.float64)[0] == e
    assert back.tiled.weights.dtype == torch.float64 and back.mesh_impl == "tiled"


def test_md_tiled_f32_matches_jax_tiled_f32(md_case):
    _, _, (pos, q, cell) = md_case
    calc_j, calc_t = _md_calcs()
    f32 = jnp.float32
    fp_j = tpme.MDFastPath.create(
        calc_j, jnp.asarray(pos, f32), jnp.asarray(cell, f32), CUTOFF, NS, mesh_impl="tiled"
    )
    fp = tpt.MDFastPath.create(
        calc_t, torch.tensor(pos, dtype=torch.float32), torch.tensor(cell, dtype=torch.float32),
        CUTOFF, NS, mesh_impl="tiled",
    )
    e_j, rows_j, _ = _md_jax_step(fp_j, pos, q, cell, f32)
    e, rows, _ = _md_port_step(fp, pos, q, cell, torch.float32)
    assert abs(e - e_j) <= 2e-5 * abs(e_j)  # the float32 bars of the aligned step
    assert rel(rows, rows_j) <= 5e-5


def test_md_tiled_runs_where_aligned_cannot(md_case):
    """A 64³ mesh in a 16 Å box: 2 Å tiles < the 3 Å cutoff, so aligned mode
    refuses and `auto` takes tiled."""
    _, _, (pos, q, cell) = md_case
    _, calc = _md_calcs(nodes=4)
    with pytest.raises(ValueError, match="mesh_impl='tiled'"):
        tpt.MDFastPath.create(calc, pos, cell, CUTOFF, (64, 64, 64), mesh_impl="aligned",
                              device="cpu")
    fp = tpt.MDFastPath.create(calc, pos, cell, CUTOFF, (64, 64, 64), device="cpu")
    assert fp.mesh_impl == "tiled"
    fp32 = tpt.MDFastPath.create(calc, pos, cell, CUTOFF, NS, device="cpu")
    assert fp32.mesh_impl == "aligned"  # auto keeps aligned where it is supported
    e64, e32 = (
        float(f.energy(torch.tensor(q), torch.tensor(cell), f.bucket(torch.tensor(pos))))
        for f in (fp, fp32)
    )
    # two meshes, one energy, to the accuracy of the coarser mesh (0.5 Å
    # spacing at smearing 1.0 with a dense cluster in the box)
    assert abs(e64 - e32) <= 5e-3 * abs(e64)


def test_md_tiled_stale_rows_poison_and_rebucket(md_case):
    _, fp, (pos, q, cell) = md_case
    qq, c = torch.tensor(q), torch.tensor(cell)
    rows = fp.bucket(torch.tensor(pos))
    # one mesh cell along x: still inside the 3 Å cell of the list, but the
    # stencil start of at least one atom leaves its tile's window
    rows[: fp.n_rows, 0] += 4.1
    rows.requires_grad_()
    e_sr_only = fp.energy(qq, c, rows)
    assert torch.isnan(e_sr_only)
    assert torch.isnan(torch.autograd.grad(e_sr_only, rows)[0]).any()
    fp2 = fp.rebucket(fp.bucket(torch.tensor(pos)), c)
    assert fp2.mesh_impl == "tiled" and fp2.n_rows == fp.n_rows
    assert fp2.tiled.local_x.shape == fp.tiled.local_x.shape
    e2 = fp2.energy(qq, c, fp2.bucket(torch.tensor(pos)))
    e1 = fp.energy(qq, c, fp.bucket(torch.tensor(pos)))
    assert float(e2) == pytest.approx(float(e1), rel=1e-12)
    with pytest.raises(ValueError, match="exceeded the tile capacity"):
        tpt.MDFastPath.create(fp.calc, pos, cell, CUTOFF, NS, mesh_impl="tiled",
                              tile_capacity=8, device="cpu")


# -- where the state goes -------------------------------------------------------


def test_default_device_rule(monkeypatch):
    """Host inputs and no device → default_device(): the card, or a raise
    that says to pass device="cpu" when there is none.  A CPU tensor or
    device='cpu' is the caller asking for the CPU."""
    from torchpme_tpu_torch.device import resolve_device

    pos, q, cell = random_box(60, 12.0, seed=2)
    _, calc = _md_calcs(nodes=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_state = md_state(tpt.MDFastPath.create(calc, pos, cell, CUTOFF, NS, device="cpu"))
    host_calls = [
        tpt.default_device,
        lambda: resolve_device(None, pos, cell),
        lambda: tpt.MDFastPath.create(calc, pos, cell, CUTOFF, NS),
        lambda: tpt.MDFastPath.create(calc, pos, cell, CUTOFF, NS, mesh_impl="tiled"),
        lambda: compute_cell_list(pos, cell, CUTOFF),
        lambda: md_from_state(cpu_state),
    ]
    # no card: nothing lands on the CPU unless asked for
    for call in host_calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tpt.default_device() == torch.device("cuda")
    assert resolve_device(None, pos, cell) == torch.device("cuda")
    assert resolve_device(None, pos, torch.tensor(cell)) == torch.device("cpu")
    assert resolve_device("cpu", pos) == torch.device("cpu")
    # with a card, host inputs head for it (this build of torch has none: the
    # attempt itself is the evidence) ...
    for call in host_calls[2:]:
        with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
            call()
    # ... while CPU tensors and device="cpu" stay on the CPU
    pos_t, cell_t = torch.tensor(pos), torch.tensor(cell)
    for fp in (
        tpt.MDFastPath.create(calc, pos_t, cell_t, CUTOFF, NS),
        tpt.MDFastPath.create(calc, pos_t, cell_t, CUTOFF, NS, mesh_impl="tiled"),
        tpt.MDFastPath.create(calc, pos, cell, CUTOFF, NS, device="cpu"),
        md_from_state(cpu_state, device="cpu"),
    ):
        assert fp.row_of_atom.device.type == "cpu"
        assert fp.clist.atom_index.device.type == "cpu"
    assert compute_cell_list(pos_t, cell_t, CUTOFF).atom_index.device.type == "cpu"
    assert compute_cell_list(pos, cell, CUTOFF, device="cpu").atom_index.device.type == "cpu"
    interp = compute_tiled_interpolation(pos_t, torch.linalg.inv(cell_t), NS, 4, "Lagrange")
    assert interp.weights.device.type == "cpu"  # follows its tensor inputs
    assert isinstance(tnb.neighbor_list(pos_t, cell_t, CUTOFF)[0], np.ndarray)


# -- validation -----------------------------------------------------------------


def _valid_inputs():
    return dict(
        charges=np.ones((4, 1)), cell=np.eye(3), positions=np.zeros((4, 3)),
        neighbor_indices=np.zeros((5, 2), np.int64), neighbor_distances=np.ones(5),
    )


BAD_INPUTS = {
    "positions-shape": dict(positions=np.zeros((4, 2))),
    "cell-shape": dict(cell=np.eye(2)),
    "cell-dtype": dict(cell=np.eye(3, dtype=np.float32)),
    "charges-ndim": dict(charges=np.ones(4)),
    "charges-atoms": dict(charges=np.ones((3, 1))),
    "charges-dtype": dict(charges=np.ones((4, 1), np.float32)),
    "one-of-two": dict(neighbor_distances=None),
    "dense-shapes": dict(neighbor_indices=np.zeros((4, 6), np.int64),
                         neighbor_distances=np.ones((4, 5))),
    "indices-shape": dict(neighbor_indices=np.zeros((5, 3), np.int64)),
    "distances-shape": dict(neighbor_distances=np.ones(4)),
    "distances-dtype": dict(neighbor_distances=np.ones(5, np.float32)),
    "periodic-shape": dict(periodic=np.ones(2, bool)),
    "pair-mask-shape": dict(pair_mask=np.ones(4, bool)),
    "pair-mask-dtype": dict(pair_mask=np.ones(5)),
    "node-mask-shape": dict(node_mask=np.ones(3, bool)),
    "node-mask-dtype": dict(node_mask=np.ones(4)),
    "kvectors-shape": dict(kvectors=np.ones((4, 2))),
    "kvectors-dtype": dict(kvectors=np.ones((4, 3), np.float32)),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_validate_parameters_messages_match_jax(case):
    inputs = {**_valid_inputs(), **BAD_INPUTS[case]}
    as_jax = {k: None if v is None else jnp.asarray(v) for k, v in inputs.items()}
    as_torch = {k: None if v is None else torch.tensor(v) for k, v in inputs.items()}
    with pytest.raises((ValueError, TypeError)) as theirs:
        jax_validate(**as_jax)
    with pytest.raises(theirs.type) as ours:
        validate_parameters(**as_torch)
    assert str(ours.value).replace("torch.", "") == str(theirs.value)
    validate_parameters(**{k: torch.tensor(v) for k, v in _valid_inputs().items()})


def test_validate_parameters_refuses_mixed_devices():
    inputs = {k: torch.tensor(v) for k, v in _valid_inputs().items()}
    inputs["cell"] = inputs["cell"].to("meta")
    with pytest.raises(ValueError, match="device of `cell`"):
        validate_parameters(**inputs)
