"""The port's dipolar calculators ≡ the JAX package's.

``CalculatorDipole``: the analytic and cross-code anchors of
``tests/calculators/test_values_dipole.py`` (direct sum −0.265625, the
smearing limits, the espressomd DipolarP3M value and its three frames), pair
list ≡ dense layout ≡ ``cell_list=``, and the per-atom potential with its
gradients wrt positions, dipoles and cell against JAX in float64 (1e-10 of
max: the same sums in another order).  ``PMECalculatorDipole``: the same on
both mesh backends (the tiled one runs the plain versions of kernels D, E, F
here), ``energy`` ≡ ``sum(pot·μ)``, and the stale / overflow / validation
errors.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import dipole_box, port_clist, rel

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.ops import rspace_cells as jax_rc
from torchpme_tpu.utils.neighbors import neighbor_list
from torchpme_tpu_torch.ops.mesh_tiled import compute_tiled_interpolation
from torchpme_tpu_torch.prefactors import eV_A

torch.set_num_threads(1)

CUTOFF = 3.0


def parallel_dipoles():
    """Three parallel dipoles along y in a 10 Å cube (numpy, float64)."""
    positions = np.asarray([[0.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 4.0, 0.0]])
    dipoles = np.asarray([[1.0, 1.0, 0.0]] * 3)
    cell = np.eye(3) * 10.0
    indices = np.asarray([[0, 1], [1, 2], [0, 2]])
    vectors = np.asarray([[0.0, 2.0, 0.0], [0.0, 2.0, 0.0], [0.0, 4.0, 0.0]])
    return dipoles, cell, positions, indices, vectors


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_magnetostatics_direct():
    dipoles, *rest = _t(*parallel_dipoles())
    pot = tpt.CalculatorDipole(tpt.PotentialDipole())(dipoles, *rest)
    assert float(torch.sum(pot * dipoles)) == pytest.approx(-0.265625, abs=1e-12)


@pytest.mark.parametrize(("smearing", "expected_sr"), [(1e10, -0.265625), (1e-10, 0.0)])
def test_magnetostatics_sr_limits(smearing, expected_sr):
    calc = tpt.CalculatorDipole(tpt.PotentialDipole(smearing=smearing), lr_wavelength=1.0)
    dipoles, _, _, indices, vectors = _t(*parallel_dipoles())
    pot = calc._compute_rspace(dipoles, indices, vectors)
    assert float(torch.sum(pot * dipoles)) == pytest.approx(expected_sr, abs=1e-8)


def test_magnetostatic_ewald_espresso_anchor():
    smearing = (1 / 2) ** 0.5  # espressomd alpha = 1
    calc = tpt.CalculatorDipole(tpt.PotentialDipole(smearing=smearing), lr_wavelength=0.1)
    dipoles, *rest = _t(*parallel_dipoles())
    result = float(torch.sum(calc(dipoles, *rest) * dipoles))
    np.testing.assert_allclose(result, -0.30848574939287954, atol=1e-6, rtol=1e-4)


def test_epsilon_surface_term():
    dipoles, cell, positions, indices, vectors = _t(*parallel_dipoles())
    pots = [
        tpt.CalculatorDipole(
            tpt.PotentialDipole(smearing=0.7, epsilon=eps), lr_wavelength=0.5
        )(dipoles, cell, positions, indices, vectors)
        for eps in (0.0, 1.0)
    ]
    shift = 4 * np.pi / 3 / 1000.0 * dipoles.sum(0).numpy() / 2
    np.testing.assert_allclose(
        (pots[1] - pots[0]).numpy(), np.broadcast_to(shift, (3, 3)), rtol=1e-10
    )


# espressomd DipolarP3M golden frames with their cutoffs and alphas, as
# tests/calculators/test_values_dipole.py reads them
DIPOLE_FRAMES = Path(__file__).parent / "data" / "dipoles_test_frames.xyz"
FRAME_PARAMS = [
    (3.9986718930, 0.8819831493),
    (4.0000000000, 0.8956299559),
    (4.7363281250, 0.7215211182),
]


def read_dipole_frames(path):
    frames, lines, i = [], path.read_text().splitlines(), 0
    while i < len(lines):
        n, header = int(lines[i]), lines[i + 1]
        lattice = np.array(
            re.search(r'Lattice="([^"]+)"', header).group(1).split(), dtype=float
        ).reshape(3, 3)
        rows = np.array([lines[i + 2 + a].split()[1:10] for a in range(n)], dtype=float)
        frames.append(dict(
            cell=lattice, positions=rows[:, 0:3], dipoles=rows[:, 3:6], forces=rows[:, 6:9],
            energy=float(re.search(r"energy=(\S+)", header).group(1)),
        ))
        i += 2 + n
    return frames


@pytest.mark.parametrize("frame_index", [0, 1, 2])
def test_dipolar_ewald_vs_espressomd_frames(frame_index):
    frame = read_dipole_frames(DIPOLE_FRAMES)[frame_index]
    cutoff, alpha = FRAME_PARAMS[frame_index]
    calc = tpt.CalculatorDipole(
        tpt.PotentialDipole(smearing=(1 / (2 * alpha**2)) ** 0.5, prefactor=eV_A),
        lr_wavelength=0.1,
    )
    idx_np, _, shifts_np = neighbor_list(frame["positions"], frame["cell"], cutoff)
    idx, shifts = torch.as_tensor(idx_np).long(), torch.as_tensor(shifts_np)
    dipoles, cell = torch.tensor(frame["dipoles"]), torch.tensor(frame["cell"])
    positions = torch.tensor(frame["positions"], requires_grad=True)
    vectors = positions[idx[:, 1]] - positions[idx[:, 0]] + shifts.to(cell.dtype) @ cell
    pot = calc(dipoles, cell, positions, idx, vectors, ns_kvectors=calc.get_ns_kvectors(cell))
    e = torch.sum(pot * dipoles)
    (grad,) = torch.autograd.grad(e, positions)
    np.testing.assert_allclose(float(e.detach()), frame["energy"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(-grad.numpy(), frame["forces"], atol=1e-5, rtol=1e-4)


# -- against the JAX package, values and gradients ------------------------------------


def _pairs(positions, cell, full=False):
    idx, _, shifts = neighbor_list(positions, cell, CUTOFF, full_list=full)
    return np.asarray(idx), np.asarray(shifts)


def _jax_call(calc_j, positions, dipoles, cell, idx, shifts, **kw):
    """Per-atom potential and the gradients of a fixed scalar of it wrt
    (positions, dipoles, cell), through the neighbor vectors."""
    weights = np.random.default_rng(11).normal(size=dipoles.shape)

    def pot(p, mu, c):
        vec = p[idx[:, 1]] - p[idx[:, 0]] + jnp.asarray(shifts, c.dtype) @ c
        return calc_j(mu, c, p, jnp.asarray(idx), vec, **kw)

    def loss(*a):
        out = pot(*a)
        return jnp.sum(out * weights), out

    args = [jnp.asarray(a) for a in (positions, dipoles, cell)]
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads], weights


def _port_call(calc_t, positions, dipoles, cell, idx, shifts, weights, **kw):
    p, mu, c = (torch.tensor(a, requires_grad=True) for a in (positions, dipoles, cell))
    idx_t = torch.as_tensor(idx).long()
    vec = (
        p.index_select(0, idx_t[:, 1]) - p.index_select(0, idx_t[:, 0])
        + torch.as_tensor(shifts).to(c.dtype) @ c
    )
    pot = calc_t(mu, c, p, idx_t, vec, **kw)
    grads = torch.autograd.grad(torch.sum(pot * torch.tensor(weights)), (p, mu, c))
    return pot.detach().numpy(), [g.numpy() for g in grads]


EWALD_CASES = {
    "ewald": dict(smearing=0.8, lr_wavelength=1.2, triclinic=False, full=False),
    "ewald-triclinic-full": dict(smearing=0.9, lr_wavelength=1.5, triclinic=True, full=True),
    "ewald-epsilon": dict(smearing=0.8, lr_wavelength=1.2, triclinic=True, full=False, epsilon=2.0),
    "direct": dict(smearing=None, lr_wavelength=None, triclinic=False, full=False),
}


@pytest.mark.parametrize("name", list(EWALD_CASES))
def test_calculator_dipole_matches_jax(name):
    case = dict(EWALD_CASES[name])
    full, triclinic = case.pop("full"), case.pop("triclinic")
    lr = case.pop("lr_wavelength")
    positions, dipoles, cell = dipole_box(90, 9.0, seed=3, triclinic=triclinic)
    idx, shifts = _pairs(positions, cell, full)
    kw = dict(full_neighbor_list=full, lr_wavelength=lr)
    calc_j = tpme.CalculatorDipole(tpme.PotentialDipole(prefactor=1.1, **case), **kw)
    calc_t = tpt.CalculatorDipole(tpt.PotentialDipole(prefactor=1.1, **case), **kw)
    # static k-space extents, so the k-vectors follow the differentiated cell
    call_kw = {} if lr is None else dict(ns_kvectors=calc_t.get_ns_kvectors(cell))
    pot_j, g_j, weights = _jax_call(calc_j, positions, dipoles, cell, idx, shifts, **call_kw)
    pot_t, g_t = _port_call(calc_t, positions, dipoles, cell, idx, shifts, weights, **call_kw)
    assert rel(pot_t, pot_j) <= 1e-10
    for label, a, b in zip(("positions", "dipoles", "cell"), g_t, g_j):
        assert rel(a, b) <= 1e-10, label
    if lr is not None:
        assert calc_t.get_ns_kvectors(cell) == calc_j.get_ns_kvectors(jnp.asarray(cell))
        np.testing.assert_allclose(
            calc_t.compute_kvectors(torch.tensor(cell)).numpy(),
            np.asarray(calc_j.compute_kvectors(jnp.asarray(cell))), rtol=0, atol=1e-13,
        )


def _vectors(positions, cell, idx, shifts):
    return positions[idx[:, 1]] - positions[idx[:, 0]] + shifts.astype(float) @ cell


@pytest.mark.parametrize("smearing", [0.8, None])
def test_pair_list_dense_and_cell_list_agree(smearing):
    """Half list ≡ full list ≡ dense (N, C, 3) layout, and ``energy`` over a
    pair list ≡ over ``cell_list=`` ≡ ``sum(pot·μ)``, values and gradients."""
    positions, dipoles, cell = dipole_box(120, 10.0, seed=5, triclinic=True)
    lr = None if smearing is None else 1.3
    pot = tpt.PotentialDipole(smearing=smearing)
    half = tpt.CalculatorDipole(pot, lr_wavelength=lr)
    full = tpt.CalculatorDipole(pot, full_neighbor_list=True, lr_wavelength=lr)
    mu, c, p = _t(dipoles, cell, positions)
    idx_h, sh_h = _pairs(positions, cell)
    idx_f, sh_f = _pairs(positions, cell, full=True)
    vec_h, vec_f = _vectors(positions, cell, idx_h, sh_h), _vectors(positions, cell, idx_f, sh_f)
    ref = half(mu, c, p, *_t(idx_h, vec_h))
    assert rel(full(mu, c, p, *_t(idx_f, vec_f)).numpy(), ref.numpy()) <= 1e-12

    n, counts = positions.shape[0], np.bincount(idx_f[:, 0], minlength=positions.shape[0])
    cap = int(counts.max())
    nbr, vecs, mask = np.zeros((n, cap), np.int64), np.zeros((n, cap, 3)), np.zeros((n, cap), bool)
    fill = np.zeros(n, int)
    for (i, j), v in zip(idx_f, vec_f):
        nbr[i, fill[i]], vecs[i, fill[i]], mask[i, fill[i]] = j, v, True
        fill[i] += 1
    dense = half(mu, c, p, *_t(nbr, vecs), pair_mask=torch.as_tensor(mask))
    assert rel(dense.numpy(), ref.numpy()) <= 1e-12

    clist = port_clist(jax_rc.compute_cell_list(positions, cell, CUTOFF))

    def energies(fn):
        args = [torch.tensor(a, requires_grad=True) for a in (dipoles, cell, positions)]
        e = fn(*args)
        return float(e.detach()), [g.numpy() for g in torch.autograd.grad(e, args)]

    def with_pairs(mu_, c_, p_):
        i = torch.as_tensor(idx_h).long()
        vec = p_.index_select(0, i[:, 1]) - p_.index_select(0, i[:, 0]) + torch.as_tensor(
            sh_h).to(c_.dtype) @ c_
        return half.energy(mu_, c_, p_, i, vec)

    e_pairs, g_pairs = energies(with_pairs)
    e_cells, g_cells = energies(lambda mu_, c_, p_: half.energy(mu_, c_, p_, cell_list=clist))
    assert e_pairs == pytest.approx(float(torch.sum(ref * mu)), rel=1e-12)
    assert e_cells == pytest.approx(e_pairs, rel=1e-11)
    for label, a, b in zip(("dipoles", "cell", "positions"), g_cells, g_pairs):
        assert rel(a, b) <= 1e-10, label
    with pytest.raises(ValueError, match="not both"):
        half.energy(mu, c, p, *_t(idx_h, vec_h), cell_list=clist)
    with pytest.raises(ValueError, match="cell_list"):
        half.energy(mu, c, p)


def test_energy_over_cell_list_matches_jax():
    positions, dipoles, cell = dipole_box(150, 11.0, seed=6)
    clist_j = jax_rc.compute_cell_list(positions, cell, CUTOFF)
    kw = dict(lr_wavelength=1.4)
    calc_j = tpme.CalculatorDipole(tpme.PotentialDipole(smearing=0.85), **kw)
    calc_t = tpt.CalculatorDipole(tpt.PotentialDipole(smearing=0.85), **kw)
    ns_k = calc_t.get_ns_kvectors(cell)

    def e_j(mu, c, p):
        return calc_j.energy(mu, c, p, cell_list=clist_j, ns_kvectors=ns_k)

    ej, gj = jax.jit(jax.value_and_grad(e_j, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (dipoles, cell, positions))
    )
    args = [torch.tensor(a, requires_grad=True) for a in (dipoles, cell, positions)]
    e = calc_t.energy(*args, cell_list=port_clist(clist_j), ns_kvectors=ns_k)
    grads = torch.autograd.grad(e, args)
    assert float(e.detach()) == pytest.approx(float(ej), rel=1e-10)
    for label, a, b in zip(("dipoles", "cell", "positions"), grads, gj):
        assert rel(a.numpy(), np.asarray(b)) <= 1e-10, label


def test_calculator_dipole_validation():
    with pytest.raises(TypeError, match="PotentialDipole"):
        tpt.CalculatorDipole(tpt.CoulombPotential(smearing=1.0), lr_wavelength=1.0)
    with pytest.raises(ValueError, match="both"):
        tpt.CalculatorDipole(tpt.PotentialDipole(smearing=1.0))
    with pytest.raises(ValueError, match="both"):
        tpt.CalculatorDipole(tpt.PotentialDipole(), lr_wavelength=1.0)
    dipoles, cell, positions, indices, vectors = _t(*parallel_dipoles())
    calc = tpt.CalculatorDipole(tpt.PotentialDipole())
    with pytest.raises(ValueError):
        calc(dipoles[:2], cell, positions, indices, vectors)
    with pytest.raises(ValueError):
        calc(dipoles, cell[:2], positions, indices, vectors)


# -- PMECalculatorDipole --------------------------------------------------------------

PME_NS = (16, 16, 16)


@pytest.fixture(scope="module", params=["scatter", "tiled"])
def pme_case(request):
    backend = request.param
    positions, dipoles, cell = dipole_box(110, 9.5, seed=8, triclinic=True)
    idx, shifts = _pairs(positions, cell)
    kw = dict(mesh_spacing=1.3, interpolation_nodes=5, mesh_backend=backend)
    calc_j = tpme.PMECalculatorDipole(
        tpme.PotentialDipole(smearing=0.9, prefactor=0.8), fft_backend="fft", **kw
    )
    calc_t = tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=0.9, prefactor=0.8), **kw)
    assert calc_t.get_ns_mesh(cell) == calc_j.get_ns_mesh(jnp.asarray(cell)) == PME_NS
    ref = _jax_call(calc_j, positions, dipoles, cell, idx, shifts, ns_kvectors=PME_NS)
    return calc_j, calc_t, (positions, dipoles, cell, idx, shifts), ref


def test_pme_dipole_matches_jax(pme_case):
    _, calc_t, system, (pot_j, g_j, weights) = pme_case
    pot_t, g_t = _port_call(calc_t, *system, weights, ns_kvectors=PME_NS)
    assert rel(pot_t, pot_j) <= 1e-10
    for label, a, b in zip(("positions", "dipoles", "cell"), g_t, g_j):
        assert rel(a, b) <= 1e-10, label
    # without the static shape the mesh comes from the cell
    pot_auto, _ = _port_call(calc_t, *system, weights)
    np.testing.assert_array_equal(pot_auto, pot_t)


def test_pme_dipole_energy_is_sum_pot_mu_and_matches_jax(pme_case):
    calc_j, calc_t, (positions, dipoles, cell, idx, shifts), _ = pme_case
    clist_j = jax_rc.compute_cell_list(positions, cell, CUTOFF)

    def e_j(mu, c, p):
        return calc_j.energy(mu, c, p, cell_list=clist_j, ns_kvectors=PME_NS)

    ej, gj = jax.jit(jax.value_and_grad(e_j, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (dipoles, cell, positions))
    )
    args = [torch.tensor(a, requires_grad=True) for a in (dipoles, cell, positions)]
    e = calc_t.energy(*args, cell_list=port_clist(clist_j), ns_kvectors=PME_NS)
    grads = torch.autograd.grad(e, args)
    assert float(e.detach()) == pytest.approx(float(ej), rel=1e-10)
    for label, a, b in zip(("dipoles", "cell", "positions"), grads, gj):
        assert rel(a.numpy(), np.asarray(b)) <= 1e-10, label
    mu, c, p = _t(dipoles, cell, positions)
    vec = _vectors(positions, cell, idx, shifts)
    pot = calc_t(mu, c, p, *_t(idx, vec), ns_kvectors=PME_NS)
    assert float(torch.sum(pot * mu)) == pytest.approx(float(e.detach()), rel=1e-11)
    assert float(calc_t.energy(mu, c, p, *_t(idx, vec))) == pytest.approx(
        float(e.detach()), rel=1e-11
    )


def test_pme_dipole_backends_agree_and_plain_flag(pme_case):
    _, calc_t, (positions, dipoles, cell, idx, shifts), _ = pme_case
    mu, c, p = _t(dipoles, cell, positions)
    args = _t(idx, _vectors(positions, cell, idx, shifts))
    ref = calc_t(mu, c, p, *args)
    other = "tiled" if calc_t.mesh_backend == "scatter" else "scatter"
    twin = tpt.PMECalculatorDipole(
        calc_t.potential, mesh_spacing=1.3, interpolation_nodes=5, mesh_backend=other
    )
    assert rel(twin(mu, c, p, *args).numpy(), ref.numpy()) <= 1e-11
    np.testing.assert_array_equal(calc_t(mu, c, p, *args, plain=True).numpy(), ref.numpy())
    # `auto` on CPU tensors is the scatter backend
    auto = tpt.PMECalculatorDipole(calc_t.potential, mesh_spacing=1.3, interpolation_nodes=5)
    assert not auto._use_tiled(PME_NS, "cpu") and auto._use_tiled(PME_NS, "cuda")
    assert not auto._use_tiled((12, 12, 12), "cuda")


def test_pme_dipole_reused_bucketing_stale_and_overflow():
    positions, dipoles, cell = dipole_box(110, 9.5, seed=8)
    pot = tpt.PotentialDipole(smearing=0.9)
    kw = dict(mesh_spacing=1.3, interpolation_nodes=5)
    calc = tpt.PMECalculatorDipole(pot, mesh_backend="tiled", **kw)
    mu, c, p = _t(dipoles, cell, positions)
    interp = compute_tiled_interpolation(
        p, torch.linalg.inv(c), PME_NS, 5, "Lagrange", derivatives=True
    )
    fresh = calc._compute_kspace(mu, c, p)
    reused = calc._compute_kspace(mu, c, p, tiled_interp=interp)
    assert rel(reused.numpy(), fresh.numpy()) <= 1e-12
    e_reused = calc._compute_kspace_energy(mu, c, p, tiled_interp=interp)
    assert float(e_reused) == pytest.approx(float(torch.sum(fresh * mu)), rel=1e-11)

    moved = p.clone()
    moved[0, 0] += 4.0  # out of its tile's stencil window
    with pytest.raises(ValueError, match="stale"):
        calc._compute_kspace(mu, c, moved, tiled_interp=interp)
    with pytest.raises(ValueError, match="stale"):
        calc._compute_kspace_energy(mu, c, moved, tiled_interp=interp)
    moved.requires_grad_()
    e = calc._compute_kspace_energy(mu, c, moved, tiled_interp=interp, check_stale=False)
    (g,) = torch.autograd.grad(e, moved)
    assert torch.isnan(e) and torch.isnan(g).all()

    with pytest.raises(ValueError, match="tile capacity"):
        tpt.PMECalculatorDipole(pot, mesh_backend="tiled", tile_capacity=8, **kw)._compute_kspace(
            mu, c, p
        )
    with pytest.raises(ValueError, match="not selected"):
        tpt.PMECalculatorDipole(pot, mesh_backend="scatter", **kw)._compute_kspace(
            mu, c, p, tiled_interp=interp
        )
    no_deriv = compute_tiled_interpolation(p, torch.linalg.inv(c), PME_NS, 5, "Lagrange")
    with pytest.raises(ValueError, match="derivatives=True"):
        calc._compute_kspace(mu, c, p, tiled_interp=no_deriv)


def test_pme_dipole_validation():
    pot = tpt.PotentialDipole(smearing=1.0)
    with pytest.raises(ValueError, match="smearing"):
        tpt.PMECalculatorDipole(tpt.PotentialDipole())
    with pytest.raises(TypeError, match="PotentialDipole"):
        tpt.PMECalculatorDipole(tpt.CoulombPotential(smearing=1.0))
    with pytest.raises(ValueError, match="positive"):
        tpt.PMECalculatorDipole(pot, mesh_spacing=0.0)
    with pytest.raises(ValueError, match="Lagrange"):
        tpt.PMECalculatorDipole(pot, _method="P3M")
    with pytest.raises(ValueError):
        tpt.PMECalculatorDipole(pot, interpolation_nodes=9)
    with pytest.raises(ValueError, match="mesh_backend"):
        tpt.PMECalculatorDipole(pot, mesh_backend="fused")
    calc = tpt.PMECalculatorDipole(pot)
    assert calc.interpolation_nodes == 6 and calc.lr_wavelength is None
    with pytest.raises(NotImplementedError, match="ns_kvectors"):
        calc.compute_kvectors(torch.eye(3))
    dipoles, cell, positions, *_ = _t(*parallel_dipoles())
    with pytest.raises(ValueError, match="kvectors"):
        calc._compute_kspace(dipoles, cell, positions, kvectors=torch.zeros((4, 3)))
