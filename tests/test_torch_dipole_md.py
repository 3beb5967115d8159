"""The dipolar slice end to end: the port's ``MDFastPathDipole`` energy step
≡ the JAX package's in float64 (1e-9: energy, force rows, fields ``∂E/∂μ``
and cell gradient) over the Ewald and the mesh calculators, smeared and
direct, with and without a spill list, tiled and scatter mesh backends; the
staleness poison, ``rebucket``, the numpy state conversion, and the 3000-atom
accuracy oracle whose JAX energies ``chip_smoke.py`` prints beside its own.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (
    clustered_box,
    dipole_box,
    jax_md_dipole_state,
    port_dipole_from_jax,
    rel,
)

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu_torch.convert import (
    dipole_calculator_from_state,
    dipole_calculator_state,
    md_dipole_from_state,
    md_dipole_state,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CUTOFF = 3.0


def _spilling_system():
    positions, _, cell = clustered_box(300, 16.0, seed=2)
    dipoles = np.random.default_rng(9).normal(size=(positions.shape[0], 3))
    return positions, dipoles, cell


def _calcs(kind, smearing=0.9, backend="tiled"):
    """The same calculator in both packages."""
    if kind == "direct":
        return tpme.CalculatorDipole(tpme.PotentialDipole()), tpt.CalculatorDipole(
            tpt.PotentialDipole()
        )
    if kind == "ewald":
        return (
            tpme.CalculatorDipole(tpme.PotentialDipole(smearing=smearing), lr_wavelength=1.6),
            tpt.CalculatorDipole(tpt.PotentialDipole(smearing=smearing), lr_wavelength=1.6),
        )
    kw = dict(mesh_spacing=1.0, interpolation_nodes=5, mesh_backend=backend)
    return (
        tpme.PMECalculatorDipole(tpme.PotentialDipole(smearing=smearing), fft_backend="fft", **kw),
        tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=smearing), **kw),
    )


def _jax_step(fp_j, positions, dipoles, cell):
    rows = fp_j.bucket(jnp.asarray(positions))
    e, (g_mu, g_cell, g_rows) = jax.jit(jax.value_and_grad(fp_j.energy, argnums=(0, 1, 2)))(
        jnp.asarray(dipoles), jnp.asarray(cell), rows
    )
    return float(e), -np.asarray(fp_j.unbucket(g_rows)), np.asarray(g_mu), np.asarray(g_cell)


def _port_step(fp, positions, dipoles, cell, dtype=torch.float64, plain=False):
    """(energy, atom-order forces, fields, cell gradient) of the port's step."""
    mu = torch.tensor(dipoles, dtype=dtype, requires_grad=True)
    c = torch.tensor(cell, dtype=dtype, requires_grad=True)
    rows = fp.bucket(torch.tensor(positions, dtype=dtype)).requires_grad_()
    e = fp.energy(mu, c, rows, plain=plain)
    g_mu, g_cell, g_rows = torch.autograd.grad(e, (mu, c, rows))
    return float(e.detach()), -fp.unbucket(g_rows).numpy(), g_mu.numpy(), g_cell.numpy()


CASES = {
    # name: (calculator kind, mesh backend, system, spill)
    "ewald-spill": ("ewald", None, "clustered", None),
    "ewald-nospill-triclinic": ("ewald", None, "triclinic", False),
    "direct-spill": ("direct", None, "clustered", None),
    "pme-tiled-spill": ("pme", "tiled", "clustered", None),
    "pme-tiled-nospill-triclinic": ("pme", "tiled", "triclinic", False),
    "pme-scatter-spill": ("pme", "scatter", "clustered", None),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    kind, backend, system, spill = CASES[request.param]
    if system == "clustered":
        positions, dipoles, cell = _spilling_system()
    else:
        positions, dipoles, cell = dipole_box(260, 14.0, seed=4, triclinic=True)
    calc_j, calc_t = _calcs(kind, backend=backend)
    fp_j = tpme.MDFastPathDipole.create(
        calc_j, jnp.asarray(positions), jnp.asarray(cell), CUTOFF, _spill=spill,
        window_impl="xla",
    )
    fp = tpt.MDFastPathDipole.create(
        calc_t, torch.tensor(positions), torch.tensor(cell), CUTOFF, _spill=spill
    )
    has_spill = fp.clist.extra_index is not None
    assert has_spill == (system == "clustered" and spill is None)
    assert (fp.tiled is not None) == (backend == "tiled")
    return dict(
        name=request.param, fp_j=fp_j, fp=fp, ref=_jax_step(fp_j, positions, dipoles, cell),
        system=(positions, dipoles, cell),
    )


def test_slice_f64_matches_jax(case):
    """The slice as a whole: 1e-9 on the energy and, of max, on force rows,
    fields and cell gradient (float64, the same sums in another order)."""
    got = _port_step(case["fp"], *case["system"])
    e_j, f_j, mu_j, c_j = case["ref"]
    assert abs(got[0] - e_j) <= 1e-9 * abs(e_j)
    for label, a, b in zip(("forces", "fields", "cell"), got[1:], (f_j, mu_j, c_j)):
        assert rel(a, b) <= 1e-9, label


def test_create_reproduces_jax_state(case):
    ours, theirs = md_dipole_state(case["fp"]), jax_md_dipole_state(case["fp_j"])
    assert ours.keys() == theirs.keys()

    def same(a, b, key):
        if isinstance(b, dict):
            assert a.keys() == b.keys(), key
            for k in b:
                same(a[k], b[k], f"{key}.{k}")
        elif isinstance(b, np.ndarray) and b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=key)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=key)
        elif key == "mesh_backend":
            pass  # the port pins the backend the state was built for
        elif b is None:
            assert a is None, key
        else:
            assert tuple(np.atleast_1d(a)) == tuple(np.atleast_1d(b)), key

    for key, value in theirs.items():
        same(ours[key], value, key)


def test_convert_from_jax_state(case):
    fp = port_dipole_from_jax(case["fp_j"])
    got = _port_step(fp, *case["system"])
    e_j, f_j, mu_j, c_j = case["ref"]
    assert abs(got[0] - e_j) <= 1e-9 * abs(e_j)
    for label, a, b in zip(("forces", "fields", "cell"), got[1:], (f_j, mu_j, c_j)):
        assert rel(a, b) <= 1e-9, label


def test_convert_round_trip(case):
    fp = case["fp"]
    state = md_dipole_state(fp)
    back = md_dipole_from_state(state, device="cpu")
    again = md_dipole_state(back)

    def same(a, b, key):
        if isinstance(b, dict):
            for k in b:
                same(a[k], b[k], f"{key}.{k}")
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=key)
            assert a.dtype == b.dtype, key
        else:
            assert a == b, key

    for key, value in state.items():
        same(again[key], value, key)
    assert type(back.calc) is type(fp.calc)
    assert _port_step(back, *case["system"])[0] == _port_step(fp, *case["system"])[0]
    calc_back = dipole_calculator_from_state(dipole_calculator_state(fp.calc))
    assert dipole_calculator_state(calc_back) == dipole_calculator_state(fp.calc)


def test_plain_flag_is_the_cpu_path(case):
    a = _port_step(case["fp"], *case["system"])
    b = _port_step(case["fp"], *case["system"], plain=True)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


def test_stale_rows_poison_energy_and_gradients(case):
    fp = case["fp"]
    positions, dipoles, cell = case["system"]
    rows = fp.bucket(torch.tensor(positions))
    rows[int(fp.row_of_atom[0]), 0] += cell[0, 0] / 2
    rows.requires_grad_()
    mu = torch.tensor(dipoles, requires_grad=True)
    e = fp.energy(mu, torch.tensor(cell), rows)
    g_rows, g_mu = torch.autograd.grad(e, (rows, mu))
    assert torch.isnan(e)
    assert torch.isnan(fp.unbucket(g_rows)).all() and torch.isnan(g_mu).all()


def test_rebucket_keeps_shapes_and_recovers(case):
    fp = case["fp"]
    positions, dipoles, cell = case["system"]
    rows = fp.bucket(torch.tensor(positions))
    np.testing.assert_array_equal(fp.unbucket(rows).numpy(), positions)
    rows[int(fp.row_of_atom[0]), 0] += cell[0, 0] / 2  # stale
    fp2 = fp.rebucket(rows, torch.tensor(cell))
    assert type(fp2) is type(fp) and fp2.n_atoms == fp.n_atoms
    assert fp2.clist.slot_mask.shape == fp.clist.slot_mask.shape
    assert (fp2.clist.extra_index is None) == (fp.clist.extra_index is None)
    assert (fp2.tiled is None) == (fp.tiled is None)
    assert fp2.ns_kvectors == fp.ns_kvectors
    moved = fp.unbucket(rows)
    e = fp2.energy(torch.tensor(dipoles), torch.tensor(cell), fp2.bucket(moved))
    assert torch.isfinite(e)


def test_float32_step_is_its_float64_self():
    """float32 through the fused window math and the float32 mesh against
    float64 on the same float32-rounded inputs: 1e-5 on the energy, 2e-5 of
    max on forces and fields (the A&S erfc of the window, 1.5e-7 absolute,
    under 1/d⁴ force terms)."""
    positions, dipoles, cell = dipole_box(260, 14.0, seed=4)
    _, calc_t = _calcs("pme")
    p32 = positions.astype(np.float32).astype(np.float64)
    mu32 = dipoles.astype(np.float32).astype(np.float64)
    fp = tpt.MDFastPathDipole.create(calc_t, torch.tensor(p32), torch.tensor(cell), CUTOFF)
    got = _port_step(fp, p32, mu32, cell, dtype=torch.float32)
    ref = _port_step(fp, p32, mu32, cell)
    assert abs(got[0] - ref[0]) <= 1e-5 * abs(ref[0])
    assert rel(got[1], ref[1]) <= 2e-5 and rel(got[2], ref[2]) <= 2e-5


def test_create_validates_and_places_state():
    positions, dipoles, cell = dipole_box(100, 12.0, seed=1)
    _, calc = _calcs("pme")
    fp = tpt.MDFastPathDipole.create(calc, positions, cell, CUTOFF, device="cpu")
    assert fp.row_of_atom.device.type == "cpu" and fp.calc.mesh_backend == "tiled"
    assert fp.tiled.dweights is not None and fp.tiled.dweights.shape == fp.tiled.weights.shape
    # slots of the tile bucketing name bucket rows, the sentinel is n_rows
    slots = fp.tiled.atom_of_slot.numpy()
    assert slots.max() == fp.n_rows and np.sort(slots[slots < fp.n_rows]).tolist() == sorted(
        fp.row_of_atom.tolist()
    )
    # `auto` on the CPU is the scatter backend: no tile bucketing, rows feed the mesh
    auto = tpt.PMECalculatorDipole(calc.potential, mesh_spacing=1.0, interpolation_nodes=5)
    fp_auto = tpt.MDFastPathDipole.create(auto, positions, cell, CUTOFF, device="cpu")
    assert fp_auto.tiled is None and fp_auto.calc.mesh_backend == "scatter"
    assert auto.mesh_backend == "auto"  # the caller's calculator is not touched
    a = _port_step(fp, positions, dipoles, cell)
    b = _port_step(fp_auto, positions, dipoles, cell)
    assert a[0] == pytest.approx(b[0], rel=1e-11) and rel(a[1], b[1]) <= 1e-10
    with pytest.raises(ValueError, match="tile capacity"):
        small = tpt.PMECalculatorDipole(
            calc.potential, mesh_spacing=1.0, interpolation_nodes=5, mesh_backend="tiled",
            tile_capacity=8,
        )
        tpt.MDFastPathDipole.create(small, positions, cell, CUTOFF, device="cpu")
    direct = tpt.MDFastPathDipole.create(_calcs("direct")[1], positions, cell, CUTOFF,
                                         device="cpu")
    assert direct.ns_kvectors is None and direct.tiled is None


def test_chip_smoke_dipole_oracle_constants():
    """chip_smoke.py's 3000-atom dipolar accuracy system is that of
    tools/bench_family.py; the JAX package's float64 energies for it (mesh
    PME and the converged dipolar Ewald) are the constants the script prints
    beside the port's, and the port's own float64 values agree with them."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    positions, dipoles, cell = cs.dipole_oracle_box()
    smearing, spacing = cs.dipole_parameters()
    assert positions.shape == (cs.DIPOLE_GT_N, 3)
    calc_j = tpme.PMECalculatorDipole(
        tpme.PotentialDipole(smearing=smearing), mesh_spacing=spacing, fft_backend="fft"
    )
    calc_t = tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=smearing), mesh_spacing=spacing)
    assert calc_t.get_ns_mesh(cell) == calc_j.get_ns_mesh(jnp.asarray(cell)) == cs.DIPOLE_GT_NS
    assert calc_t.interpolation_nodes == cs.DIPOLE_NODES
    fp_j = tpme.MDFastPathDipole.create(
        calc_j, jnp.asarray(positions), jnp.asarray(cell), cs.CUTOFF, window_impl="xla"
    )
    e_pme_j = float(jax.jit(fp_j.energy)(jnp.asarray(dipoles), jnp.asarray(cell), fp_j.bucket(
        jnp.asarray(positions))))
    assert abs(e_pme_j - cs.DIPOLE_GT_JAX_PME) <= 1e-9 * abs(cs.DIPOLE_GT_JAX_PME)
    fp = tpt.MDFastPathDipole.create(calc_t, positions, cell, cs.CUTOFF, device="cpu")
    e_pme = float(fp.energy(torch.tensor(dipoles), torch.tensor(cell), fp.bucket(
        torch.tensor(positions))))
    assert abs(e_pme - e_pme_j) <= 1e-9 * abs(e_pme_j)
    # the Ewald oracle costs 3000 atoms × 2·10⁵ k-vectors: the port's alone
    # here, against the constant taken from the JAX package
    e_ew = cs.dipole_ewald_oracle(tpt, positions, dipoles, cell, smearing, torch.device("cpu"))
    assert abs(e_ew - cs.DIPOLE_GT_JAX_EWALD) <= 1e-9 * abs(cs.DIPOLE_GT_JAX_EWALD)
    assert abs(e_pme - e_ew) <= cs.DIPOLE_GT_BAR * abs(e_ew)
