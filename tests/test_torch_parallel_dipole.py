"""The sharded dipolar MD step (``torchpme_tpu_torch.parallel.
sharded_md_dipole_energy_rows``) on gloo ranks of the CPU, case for case
against the dipolar half of ``tests/test_parallel.py``: the Ewald, direct and
PME modes, cubic and triclinic, at D ∈ {1, 2, 4} ranks (one module-scoped
pool each, :mod:`torch_parallel_pool`), against the JAX package's sharded
step at the same D and the port's own single cell-list step; the
collectives, the staleness poison, the validation errors and a trainable
smearing.  Float64: energies to ``rtol`` 1e-12, gradients to
``5e-12·max(|ref|, 1)``; the PME mode to JAX's own 1e-10 / 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_parallel_pool import RankPool

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu import parallel as jpar
from torchpme_tpu_torch import parallel as par
from torchpme_tpu_torch.ops.rspace_cells import compute_cell_list

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
CUTOFF = 1.0
MD_NS = (128, 16, 16)
SPEC = {
    "ewald": {"kind": "dipole_ewald", "smearing": 0.45, "lr_wavelength": 1.2},
    "direct": {"kind": "dipole_direct"},
    "pme": {"kind": "dipole_pme", "smearing": 0.5, "nodes": 5},
}


def _system(triclinic):
    rng = np.random.default_rng(5)
    n, box = 220, 10.0
    pos = rng.uniform(0, box, (n, 3))
    mu = rng.normal(size=(n, 3))
    cell = np.eye(3) * box
    if triclinic:
        cell[1, 0] += 0.8
        cell[2, 1] -= 0.5
    return dict(dipoles=mu, cell=cell, positions=pos)


SYSTEM = {False: _system(False), True: _system(True)}
# (mode, triclinic, D): each held against the port's single step, and
# those of JAX_CASES against JAX's sharded step at that D (the port's single
# dipolar steps are held to JAX's in tests/test_torch_dipole_md.py)
CASES = [("ewald", False, d) for d in WORLDS] + [
    ("direct", False, 4), ("direct", True, 1), ("pme", False, 2), ("pme", True, 4)]
JAX_CASES = {("ewald", False, d) for d in WORLDS} | {("direct", False, 4), ("pme", False, 2)}


def _inputs(mode, triclinic):
    kw = dict(SYSTEM[triclinic], spec=SPEC[mode], cutoff=CUTOFF)
    if mode == "pme":
        kw["ns_mesh"] = MD_NS
    return kw


@pytest.fixture(scope="module")
def port():
    pools = {d: RankPool(d) for d in WORLDS}
    jobs = {f"{m}-{t}-{d}": (d, _inputs(m, t)) for m, t, d in CASES}
    jobs["trainable-2"] = (2, dict(_inputs("ewald", False),
                                   spec=dict(SPEC["ewald"], trainable=True)))
    jobs["stale-2"] = (2, dict(_inputs("ewald", False), drift_row=True))
    jobs["stale_pme-2"] = (2, dict(_inputs("pme", False), drift_row=True))
    jobs["errors-2"] = (2, dict(_inputs("ewald", False), errors=True))
    tickets = {name: (d, pools[d].submit("dipole_rows", **kw)) for name, (d, kw) in jobs.items()}
    cache = {}

    def get(name):
        if name not in cache:
            d, ticket = tickets[name]
            cache[name] = pools[d].collect(ticket)
        return cache[name]

    yield get
    for pool in pools.values():
        pool.close()


_REFS = {}


def _jax_calc(mode, smearing=None):
    if mode == "direct":
        return tpme.CalculatorDipole(tpme.PotentialDipole())
    s = SPEC[mode]["smearing"] if smearing is None else smearing
    if mode == "pme":
        return tpme.PMECalculatorDipole(tpme.PotentialDipole(smearing=s),
                                        interpolation_nodes=SPEC["pme"]["nodes"])
    return tpme.CalculatorDipole(tpme.PotentialDipole(smearing=s),
                                 lr_wavelength=SPEC["ewald"]["lr_wavelength"])


def _port_calc(mode, smearing=None):
    if mode == "direct":
        return tpt.CalculatorDipole(tpt.PotentialDipole())
    s = SPEC[mode]["smearing"] if smearing is None else smearing
    if mode == "pme":
        return tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=s),
                                       interpolation_nodes=SPEC["pme"]["nodes"])
    return tpt.CalculatorDipole(tpt.PotentialDipole(smearing=s),
                                lr_wavelength=SPEC["ewald"]["lr_wavelength"])


def _jax_ref(mode, triclinic, d):
    """JAX's sharded rows step at d: energy, gradients (dipoles, cell, and
    the positions, unbucketed), and its state's capacity and k extents;
    without its step where (mode, triclinic, d) is not in JAX_CASES."""
    key = ("jax", mode, triclinic, d)
    if key not in _REFS:
        data = SYSTEM[triclinic]
        calc = _jax_calc(mode)
        pos, cell = jnp.asarray(data["positions"]), jnp.asarray(data["cell"])
        kw = {"ns_mesh": MD_NS} if mode == "pme" else {}
        state = jpar.compute_sharded_md_dipole_state(calc, pos, cell, CUTOFF, d, **kw)
        if (mode, triclinic, d) not in JAX_CASES:
            _REFS[key] = (None, None, state.cl_slot_mask.shape[-1], state.ns_kvectors)
            return _REFS[key]
        mesh = Mesh(np.array(jax.devices()[:d]), ("atoms",))
        e, g = jax.jit(jax.value_and_grad(
            lambda mu, c, r: jpar.sharded_md_dipole_energy_rows(calc, mesh, mu, c, r, state),
            argnums=(0, 1, 2)))(jnp.asarray(data["dipoles"]), cell, state.bucket(pos))
        _REFS[key] = (float(e), [np.asarray(g[0]), np.asarray(g[1]),
                                 np.asarray(state.unbucket(g[2]))],
                      state.cl_slot_mask.shape[-1], state.ns_kvectors)
    return _REFS[key]


def _port_single(mode, triclinic, cap, ns_kvectors, smearing=None):
    """The port's single cell-list step on the same pair set."""
    data = SYSTEM[triclinic]
    calc = _port_calc(mode, smearing)
    leaves = [torch.tensor(data[k], requires_grad=True)
              for k in ("dipoles", "cell", "positions")]
    clist = compute_cell_list(data["positions"], data["cell"], CUTOFF, capacity=cap,
                              spill=False, device="cpu")
    e = calc.energy(*leaves, cell_list=clist, ns_kvectors=ns_kvectors)
    return float(e.detach()), [g.numpy() for g in torch.autograd.grad(e, leaves)]


def _close(got, want, atol):
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol * scale)


@pytest.mark.parametrize("mode,triclinic,d", CASES)
def test_sharded_md_dipole_rows_matches(port, mode, triclinic, d):
    """Energy, fields, cell gradient and forces (in each rank's block of
    rows, padded rows zero) ≡ the port's single step and JAX's sharded step
    at D (JAX_CASES)."""
    out = port(f"{mode}-{triclinic}-{d}")
    e_j, g_j, cap, ns_k = _jax_ref(mode, triclinic, d)
    assert out[0]["cap"] == cap and out[0]["ns_kvectors"] == ns_k
    assert out[0]["tm"] == (mode == "pme")
    e_rtol, g_atol = (1e-10, 1e-9) if mode == "pme" else (1e-12, 5e-12)
    refs = [_port_single(mode, triclinic, cap, ns_k)] + ([(e_j, g_j)] if e_j is not None else [])
    g_rows = np.concatenate([r["g_rows"] for r in out])
    row_of_atom = out[0]["row_of_atom"]
    for e_ref, g_ref in refs:
        for r in out:
            assert r["e"] == out[0]["e"]
            assert abs(r["e"] - e_ref) <= e_rtol * abs(e_ref)
            _close(r["g_mu"], g_ref[0], g_atol)
            _close(r["g_cell"], g_ref[1], g_atol)
        _close(g_rows[row_of_atom], g_ref[2], g_atol)
    empty = np.ones(out[0]["n_rows"], bool)
    empty[row_of_atom] = False
    assert float(np.abs(g_rows[empty]).max(initial=0.0)) == 0.0


def test_sharded_md_dipole_collectives_and_stale(port):
    """The Ewald k-space sum carries O(n_k), never O(atoms) or O(rows);
    stale bucketings poison energy and forces (Ewald and PME modes)."""
    out = port("ewald-False-4")
    n_k = int(np.prod(out[0]["ns_kvectors"]))
    counts = out[0]["counts"]
    assert counts["all_reduce"]["max_elements"] <= 4 * n_k
    assert counts["ring_hop"]["calls"] >= 3
    for name in ("stale-2", "stale_pme-2"):
        for r in port(name):
            assert np.isnan(r["e"])
            assert np.all(np.isnan(r["g_rows"]))
    pme = port("pme-False-2")[0]["counts"]
    assert pme["all_to_all"]["calls"] >= 1
    assert pme["all_reduce"]["max_elements"] < np.prod(MD_NS) // 8
    errors = port("errors-2")[0]["errors"]
    assert "slab rows" in errors[0]
    assert "atoms" in errors[1]


def test_sharded_md_dipole_trainable_potential(port):
    """A trainable smearing takes the plain autograd window and its gradient
    comes through the halo: against JAX's sharded step and the port's single
    step."""
    out = port("trainable-2")
    data = SYSTEM[False]
    pos, cell, mu = (jnp.asarray(data[k]) for k in ("positions", "cell", "dipoles"))
    state = jpar.compute_sharded_md_dipole_state(_jax_calc("ewald"), pos, cell, CUTOFF, 2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("atoms",))
    rows = state.bucket(pos)
    g_j = float(jax.jit(jax.grad(lambda s: jpar.sharded_md_dipole_energy_rows(
        _jax_calc("ewald", s), mesh, mu, cell, rows, state)))(jnp.asarray(0.45)))
    s = torch.tensor(0.45, dtype=torch.float64, requires_grad=True)
    clist = compute_cell_list(data["positions"], data["cell"], CUTOFF,
                              capacity=state.cl_slot_mask.shape[-1], spill=False, device="cpu")
    e = _port_calc("ewald", s).energy(torch.tensor(data["dipoles"]), torch.tensor(data["cell"]),
                                      torch.tensor(data["positions"]), cell_list=clist,
                                      ns_kvectors=state.ns_kvectors)
    g_p = float(torch.autograd.grad(e, s)[0])
    for r in out:
        assert abs(r["g_smearing"] - g_j) <= 1e-10 * abs(g_j)
        assert abs(r["g_smearing"] - g_p) <= 1e-10 * abs(g_p)


def test_sharded_md_dipole_state_matches_jax_and_validates():
    data = SYSTEM[True]
    for mode, d in (("ewald", 2), ("pme", 4)):
        kw = {"ns_mesh": MD_NS} if mode == "pme" else {}
        got = par.compute_sharded_md_dipole_state(_port_calc(mode), data["positions"],
                                                  data["cell"], CUTOFF, d, device="cpu", **kw)
        want = jpar.compute_sharded_md_dipole_state(_jax_calc(mode), data["positions"],
                                                    data["cell"], CUTOFF, d, **kw)
        for name in ("cl_atom_index", "cl_slot_mask", "cl_atom_wrap", "row_of_atom",
                     "tm_slot_rows"):
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        for name in ("n_axis", "cutoff", "ns_kvectors", "n_devices", "n_atoms", "nodes",
                     "method"):
            assert getattr(got, name) == getattr(want, name), name
    pos, cell = data["positions"], data["cell"]
    calc = _port_calc("pme")
    with pytest.raises(ValueError, match="divisible"):
        par.compute_sharded_md_dipole_state(calc, pos, cell, CUTOFF, 8, ns_mesh=(124, 16, 16),
                                            device="cpu")
    with pytest.raises(ValueError, match="multiple of 16"):
        par.compute_sharded_md_dipole_state(calc, pos, cell, CUTOFF, 8, ns_mesh=(64, 16, 16),
                                            device="cpu")
    with pytest.raises(ValueError, match="ny"):
        par.compute_sharded_md_dipole_state(calc, pos, cell, CUTOFF, 8, ns_mesh=(128, 8, 16),
                                            device="cpu")
