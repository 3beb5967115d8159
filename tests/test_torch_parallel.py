"""The multi-device tier (``torchpme_tpu_torch.parallel``) on gloo ranks of
the CPU, case for case against ``tests/test_parallel.py``.

Each world size D ∈ {1, 2, 4} is one pool of spawned ranks (module-scoped,
:mod:`torch_parallel_pool`); every port case is queued on the pools when the
module starts, and runs while the JAX references compute.  The port at D
ranks is held against the JAX package's sharded function at the same D
(``Mesh(jax.devices()[:D])``, the 8 virtual devices of ``conftest.py``) and
against the port's own unsharded call: float64 energies to ``rtol`` 1e-12,
gradients to ``5e-12·max(|ref|, 1)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import neighbor_list
from jax.sharding import Mesh
from torch_parallel_pool import RankPool
from torch_port_common import rel

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu import parallel as jpar
from torchpme_tpu_torch import parallel as par
from torchpme_tpu_torch.ops.rspace_cells import compute_cell_list

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
E_RTOL, G_ATOL = 1e-12, 5e-12


def _small():
    rng = np.random.default_rng(3)
    n, box = 24, 6.0
    pos = rng.uniform(0, box, (n, 3))
    q = rng.normal(size=(n, 1))
    q = q - q.mean()
    cell = np.eye(3) * box
    idx, dist, _ = neighbor_list(pos, cell, 2.0)
    return dict(charges=q, cell=cell, positions=pos, idx=np.asarray(idx),
                dist=np.asarray(dist))


def _md(triclinic=False, seed=11, n=220, box=10.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3))
    q = rng.normal(size=(n, 1))
    q = q - q.mean()
    cell = np.eye(3) * box
    if triclinic:
        cell[1, 0] += 0.8
        cell[2, 1] -= 0.5
    return dict(charges=q, cell=cell, positions=pos)


def _aligned():
    rng = np.random.default_rng(7)
    n, box = 500, 16.0
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 1)).astype(np.float32)
    q = q - q.mean()
    return dict(charges=q, cell=(np.eye(3) * box).astype(np.float32), positions=pos)


SMALL = _small()
MD = {False: _md(), True: _md(triclinic=True)}
ALIGNED = _aligned()
MD_NS, MD_CUTOFF = (128, 16, 16), 1.0
# one cell plane a slab at D = 4: 10 Å / 2.5 Å = 4 planes
ONE_PLANE = dict(cutoff=2.5, ns_mesh=(64, 16, 16))
MESH_NS = (32, 32, 32)
EWALD = {"kind": "ewald", "smearing": 1.0, "lr_wavelength": 0.5}
SPEC = {
    "pme": {"kind": "pme", "smearing": 0.5, "nodes": 4},
    "p3m": {"kind": "p3m", "smearing": 0.5, "nodes": 3},
    "mesh_pme": {"kind": "pme", "smearing": 1.0, "nodes": 4},
    "mesh_p3m": {"kind": "p3m", "smearing": 1.0, "nodes": 4},
}


def _ewald_ns():
    calc = tpme.EwaldCalculator(tpme.CoulombPotential(smearing=1.0), lr_wavelength=0.5)
    return tuple(int(n) for n in calc.get_ns_kvectors(jnp.asarray(SMALL["cell"])))


def _port_cases():
    """``{name: (world, case, inputs)}``: every port run of this module."""
    md_in = lambda tri: dict(MD[tri], cutoff=MD_CUTOFF, ns_mesh=MD_NS)  # noqa: E731
    cases = {}
    for d in WORLDS:
        cases[f"collectives-{d}"] = (d, "collectives", {})
        cases[f"ewald-{d}"] = (d, "ewald", dict(SMALL, spec=EWALD, ns_kvectors=_ewald_ns()))
        for kind in ("mesh_pme", "mesh_p3m"):
            cases[f"{kind}-{d}"] = (d, "mesh", dict(SMALL, spec=SPEC[kind], ns_mesh=MESH_NS))
        cases[f"md-pme-False-{d}"] = (d, "md", dict(md_in(False), spec=SPEC["pme"]))
        cases[f"rows-False-{d}"] = (d, "md_rows", dict(md_in(False), spec=SPEC["pme"]))
        cases[f"aligned-{d}"] = (d, "md_rows_gathers", dict(
            ALIGNED, spec=SPEC["pme"], cutoff=MD_CUTOFF, ns_mesh=MD_NS, aligned=True,
            dtype="float32"))
    cases["mesh_grad-4"] = (4, "mesh", dict(SMALL, spec=SPEC["mesh_pme"], ns_mesh=MESH_NS,
                                            grad=True))
    drifted = SMALL["positions"].copy()
    drifted[0, 0] += SMALL["cell"][0, 0] / 2
    cases["mesh_stale-2"] = (2, "mesh", dict(SMALL, spec=SPEC["mesh_pme"], ns_mesh=MESH_NS,
                                             drift=drifted))
    cases["md-pme-True-4"] = (4, "md", dict(md_in(True), spec=SPEC["pme"]))
    cases["md-p3m-True-2"] = (2, "md", dict(md_in(True), spec=SPEC["p3m"]))
    cases["rows-True-4"] = (4, "md_rows", dict(md_in(True), spec=SPEC["pme"]))
    cases["rows-True-2"] = (2, "md_rows_gathers", dict(md_in(True), spec=SPEC["pme"]))
    cases["one_plane-md-4"] = (4, "md", dict(MD[False], spec=SPEC["pme"], **ONE_PLANE))
    cases["one_plane-rows-4"] = (4, "md_rows", dict(MD[False], spec=SPEC["pme"], **ONE_PLANE))
    md_drift = MD[False]["positions"].copy()
    md_drift[0, 0] += MD[False]["cell"][0, 0] / 2
    cases["md_stale-2"] = (2, "md", dict(md_in(False), spec=SPEC["pme"], drift=md_drift))
    cases["rows_stale-2"] = (2, "md_rows", dict(md_in(False), spec=SPEC["pme"], drift_row=True))
    cases["rows_errors-2"] = (2, "md_rows", dict(md_in(False), spec=SPEC["pme"],
                                                 plain_state=True))
    cases["aligned_errors-2"] = (2, "md_rows", dict(
        ALIGNED, spec=SPEC["pme"], cutoff=MD_CUTOFF, ns_mesh=MD_NS, aligned=True,
        dtype="float32", plain_state=True))
    cases["aligned_stale-2"] = (2, "md_rows", dict(
        ALIGNED, spec=SPEC["pme"], cutoff=MD_CUTOFF, ns_mesh=MD_NS, aligned=True,
        dtype="float32", drift_row=True))
    return cases


@pytest.fixture(scope="module")
def port():
    """Start the pools, queue every port case, and hand out the results."""
    pools = {d: RankPool(d) for d in WORLDS}
    tickets = {name: (d, pools[d].submit(case, **inputs))
               for name, (d, case, inputs) in _port_cases().items()}
    cache = {}

    def get(name):
        if name not in cache:
            d, ticket = tickets[name]
            cache[name] = pools[d].collect(ticket)
        return cache[name]

    yield get
    for pool in pools.values():
        pool.close()


_JAX = {}


def _jax(key, fn):
    """A JAX reference, computed once per module."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _mesh(d):
    return Mesh(np.array(jax.devices()[:d]), ("atoms",))


def _jax_calc(spec):
    pot = tpme.CoulombPotential(smearing=spec["smearing"])
    if spec["kind"] == "ewald":
        return tpme.EwaldCalculator(pot, lr_wavelength=spec["lr_wavelength"])
    cls = tpme.P3MCalculator if spec["kind"] == "p3m" else tpme.PMECalculator
    return cls(pot, interpolation_nodes=spec["nodes"])


def _port_calc(spec):
    pot = tpt.CoulombPotential(smearing=spec["smearing"])
    if spec["kind"] == "ewald":
        return tpt.EwaldCalculator(pot, lr_wavelength=spec["lr_wavelength"])
    cls = tpt.P3MCalculator if spec["kind"] == "p3m" else tpt.PMECalculator
    return cls(pot, interpolation_nodes=spec["nodes"])


def _close(got, want, atol_scale=G_ATOL, what=""):
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol_scale * scale, err_msg=what)


def _same_on_every_rank(results, key="e"):
    for r in results[1:]:
        assert r[key] == results[0][key]


# -- the collectives ------------------------------------------------------------------


@pytest.mark.parametrize("d", WORLDS)
def test_collectives_transpose_as_jax(port, d):
    """psum's backward is the identity and a replicated input's cotangent is
    summed over the ranks: D× gradients fail here.  A ring hop brings the
    left neighbour's tensor; the all-to-all's backward is the inverse swap."""
    out = port(f"collectives-{d}")
    w_sum = sum(o["w"] for o in out)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["g_rep"], w_sum)
        np.testing.assert_array_equal(o["g_psum"], o["w"])
        np.testing.assert_array_equal(
            o["hop"], np.arange(8.0).reshape(2, 4) + 100 * ((r - 1) % d))
        want = np.concatenate([np.arange(4.0) + 4 * r + 10 * s for s in range(d)])
        np.testing.assert_array_equal(o["swapped"].real.ravel(), want)
        np.testing.assert_array_equal(
            o["g_swap"].real, np.broadcast_to(np.arange(4.0) + 4 * r, (1, d, 4)))
    assert out[0]["e"] == float(np.sum(w_sum * np.arange(4.0)))


def test_pad_to_multiple():
    x = torch.ones((5, 2))
    padded = par.pad_to_multiple(x, 4)
    assert padded.shape == (8, 2)
    assert float(padded[5:].abs().max()) == 0.0
    assert par.pad_to_multiple(x, 5).shape == (5, 2)
    mask = par.pad_to_multiple(torch.ones(3, dtype=torch.bool), 4, fill=False)
    assert mask.tolist() == [True, True, True, False]


# -- per-atom potentials --------------------------------------------------------------


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_ewald_matches(port, d):
    """Port at D ranks ≡ the JAX package's sharded Ewald at D and the port's
    own single call, to 1e-13 (the JAX test's bar)."""
    out = port(f"ewald-{d}")
    ns = _ewald_ns()
    ref_j = _jax(f"ewald-{d}", lambda: np.asarray(jax.jit(
        lambda q, pos: jpar.sharded_ewald_potentials(
            _jax_calc(EWALD), _mesh(d), q, jnp.asarray(SMALL["cell"]), pos,
            jnp.asarray(SMALL["idx"]), jnp.asarray(SMALL["dist"]), ns)
    )(jnp.asarray(SMALL["charges"]), jnp.asarray(SMALL["positions"]))))
    t = {k: torch.tensor(SMALL[k]) for k in ("charges", "cell", "positions", "idx", "dist")}
    ref_p = _port_calc(EWALD)(t["charges"], t["cell"], t["positions"], t["idx"], t["dist"])
    for o in out:
        np.testing.assert_allclose(o["pot"], ref_j, atol=1e-13)
        np.testing.assert_allclose(o["pot"], ref_p.numpy(), atol=1e-13)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("kind", ["mesh_pme", "mesh_p3m"])
def test_sharded_mesh_matches(port, kind, d):
    """Per-atom PME potentials ≡ JAX's sharded ones at D and the port's
    single call; P3M's against JAX's at 2 devices (its filter is the one
    difference, and the single call is held to JAX's in test_torch_p3m)."""
    out = port(f"{kind}-{d}")
    spec = SPEC[kind]
    d_jax = 2 if kind == "mesh_p3m" else d
    ref_j = _jax(f"{kind}-{d_jax}", lambda: np.asarray(jax.jit(
        lambda q, pos: jpar.sharded_mesh_potentials(
            _jax_calc(spec), _mesh(d_jax), q, jnp.asarray(SMALL["cell"]), pos,
            jnp.asarray(SMALL["idx"]), jnp.asarray(SMALL["dist"]), MESH_NS,
            slab_bucketing=jpar.compute_slab_bucketing(
                SMALL["positions"], SMALL["cell"], MESH_NS, d_jax, spec["nodes"]))
    )(jnp.asarray(SMALL["charges"]), jnp.asarray(SMALL["positions"]))))
    t = {k: torch.tensor(SMALL[k]) for k in ("charges", "cell", "positions", "idx", "dist")}
    calc = _port_calc(spec)
    calc.mesh_backend = "scatter"
    ref_p = calc(t["charges"], t["cell"], t["positions"], t["idx"], t["dist"], ns_mesh=MESH_NS)
    for o in out:
        np.testing.assert_allclose(o["pot"], ref_j, atol=1e-13)
        np.testing.assert_allclose(o["pot"], ref_p.numpy(), atol=1e-13)


def test_sharded_mesh_gradients_flow(port):
    """d(Σ pot·q)/d(q, positions) through the ring hops, the all-to-alls
    and the sums, against the JAX package's sharded gradients and the
    port's single call."""
    (out, *_) = port("mesh_grad-4")
    spec = SPEC["mesh_pme"]
    cell = jnp.asarray(SMALL["cell"])
    bucket = jpar.compute_slab_bucketing(SMALL["positions"], SMALL["cell"], MESH_NS, 4, 4)

    def e_j(q, pos):
        return jnp.sum(jpar.sharded_mesh_potentials(
            _jax_calc(spec), _mesh(4), q, cell, pos, jnp.asarray(SMALL["idx"]),
            jnp.asarray(SMALL["dist"]), MESH_NS, slab_bucketing=bucket) * q)

    g_j = jax.jit(jax.grad(e_j, argnums=(0, 1)))(
        jnp.asarray(SMALL["charges"]), jnp.asarray(SMALL["positions"]))
    q = torch.tensor(SMALL["charges"], requires_grad=True)
    pos = torch.tensor(SMALL["positions"], requires_grad=True)
    calc = _port_calc(spec)
    calc.mesh_backend = "scatter"
    e = torch.sum(calc(q, torch.tensor(SMALL["cell"]), pos, torch.tensor(SMALL["idx"]),
                       torch.tensor(SMALL["dist"]), ns_mesh=MESH_NS) * q)
    g_p = torch.autograd.grad(e, (q, pos))
    for name, got, a, b in zip(("charges", "positions"), (out["g_q"], out["g_pos"]), g_j, g_p):
        _close(got, np.asarray(a), what=name)
        _close(got, b.numpy(), what=name)


def test_sharded_mesh_collective_volume(port):
    """No collective carries the whole mesh: ring hops and all-to-alls of
    O(mesh/D), and no all-reduce of mesh size (the ``(N, C)`` potentials are
    the only global sum of mesh-derived data)."""
    counts = port("mesh_pme-4")[0]["counts"]
    assert counts["all_to_all"]["calls"] >= 2, "distributed FFT swap missing"
    assert counts["ring_hop"]["calls"] >= 4, "halo ring exchange missing"
    assert counts["all_reduce"]["max_elements"] < np.prod(MESH_NS) // 8


def test_sharded_mesh_stale_bucketing_poisons(port):
    for o in port("mesh_stale-2"):
        assert np.all(np.isnan(o["pot"])), "stale slab bucketing not detected"


def test_slab_bucketing_matches_jax_and_validates():
    s = SMALL
    with pytest.raises(ValueError, match="divisible"):
        par.compute_slab_bucketing(s["positions"], s["cell"], (30, 32, 32), 8, 4, device="cpu")
    with pytest.raises(ValueError, match="halo"):
        par.compute_slab_bucketing(s["positions"], s["cell"], (16, 16, 16), 8, 7, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        par.compute_slab_bucketing(s["positions"], s["cell"], (32, 32, 32), 8, 4, capacity=1,
                                   device="cpu")
    for d in (1, 4, 8):
        b = par.compute_slab_bucketing(s["positions"], s["cell"], (32, 32, 32), d, 4,
                                       device="cpu")
        bj = jpar.compute_slab_bucketing(s["positions"], s["cell"], (32, 32, 32), d, 4)
        np.testing.assert_array_equal(b.atom_index.numpy(), np.asarray(bj.atom_index))
        np.testing.assert_array_equal(b.slot_mask.numpy(), np.asarray(bj.slot_mask))
        assert (b.ns, b.halo) == (bj.ns, bj.halo)


# -- the slab-sharded MD step -----------------------------------------------------------


def _jax_md(kind, triclinic, d, cutoff=MD_CUTOFF, ns_mesh=MD_NS, data=None):
    """The JAX package's atom-order sharded step at d: energy and gradients
    (charges, cell, positions)."""
    data = data or MD[triclinic]

    def run():
        calc = _jax_calc(SPEC[kind])
        cell = jnp.asarray(data["cell"])
        pos = jnp.asarray(data["positions"])
        state = jpar.compute_sharded_md_state(calc, pos, cell, cutoff, ns_mesh, d)
        e, g = jax.jit(jax.value_and_grad(
            lambda q, c, p: jpar.sharded_md_energy(calc, _mesh(d), q, c, p, state),
            argnums=(0, 1, 2)))(jnp.asarray(data["charges"]), cell, pos)
        return float(e), [np.asarray(x) for x in g]

    return _jax(("md", kind, triclinic, d, cutoff, ns_mesh), run)


def _port_md_single(kind, triclinic, cutoff=MD_CUTOFF, ns_mesh=MD_NS, data=None):
    """The port's single-rank cell-list step: energy and gradients."""
    data = data or MD[triclinic]

    def run():
        calc = _port_calc(SPEC[kind])
        leaves = [torch.tensor(data[k], requires_grad=True)
                  for k in ("charges", "cell", "positions")]
        clist = compute_cell_list(data["positions"], data["cell"], cutoff, device="cpu")
        e = calc.energy(*leaves, cell_list=clist, ns_mesh=ns_mesh)
        return float(e.detach()), [g.numpy() for g in torch.autograd.grad(e, leaves)]

    return _jax(("port", kind, triclinic, cutoff, ns_mesh), run)


def _check_md(out, refs, key_pos="g_pos", rows=False):
    _same_on_every_rank(out)
    for e_ref, g_ref in refs:
        assert abs(out[0]["e"] - e_ref) <= E_RTOL * abs(e_ref)
        for r in out:
            _close(r["g_q"], g_ref[0], what="charges")
            _close(r["g_cell"], g_ref[1], what="cell")
        if rows:
            g_rows = np.concatenate([r["g_rows"] for r in out])
            row_of_atom = out[0]["row_of_atom"]
            _close(g_rows[row_of_atom], g_ref[2], what="rows")
            empty = np.ones(out[0]["n_rows"], bool)
            empty[row_of_atom] = False
            assert float(np.abs(g_rows[empty]).max(initial=0.0)) == 0.0
        else:
            for r in out:
                _close(r[key_pos], g_ref[2], what="positions")


MD_CASES = [("pme", False, d) for d in WORLDS] + [("pme", True, 4), ("p3m", True, 2)]


@pytest.mark.parametrize("kind,triclinic,d", MD_CASES)
def test_sharded_md_energy_matches(port, kind, triclinic, d):
    """The atom-order step ≡ the port's single cell-list step and, but for
    P3M (whose single step ``tests/test_torch_p3m.py`` holds to JAX's), JAX's
    sharded step at D: energy and gradients (charges, cell, positions)."""
    out = port(f"md-{kind}-{triclinic}-{d}")
    refs = [_port_md_single(kind, triclinic)]
    if kind == "pme":
        refs.append(_jax_md(kind, triclinic, d))
    _check_md(out, refs)


@pytest.mark.parametrize("triclinic,d", [(False, 1), (False, 2), (False, 4), (True, 4),
                                         (True, 2)])
def test_sharded_md_rows_matches(port, triclinic, d):
    """The rows step (each rank its own block of bucket rows) ≡ JAX's
    sharded step at D (its rows entry equals its atom-order one, and raises
    at D = 1) and the port's single step; the forces come back in each
    rank's block, padded rows zero."""
    out = port(f"rows-{triclinic}-{d}")
    # JAX's triclinic reference at 4 devices serves both triclinic cases
    d_jax = 4 if triclinic else d
    _check_md(out, [_jax_md("pme", triclinic, d_jax), _port_md_single("pme", triclinic)],
              rows=True)


def test_sharded_md_one_plane_slab(port):
    """A slab of one cell plane (4 planes over 4 ranks: x + 1 and x − 1 of
    the extended grid are the same plane), atom-order and rows."""
    refs = [_jax_md("pme", False, 4, **ONE_PLANE), _port_md_single("pme", False, **ONE_PLANE)]
    state = par.compute_sharded_md_state(
        _port_calc(SPEC["pme"]), MD[False]["positions"], MD[False]["cell"], device="cpu",
        n_devices=4, **ONE_PLANE)
    assert state.n_axis[0] == 4 and state.cl_slot_mask.shape[1] == np.prod(state.n_axis[1:])
    _check_md(port("one_plane-md-4"), refs)
    _check_md(port("one_plane-rows-4"), refs, rows=True)


def test_sharded_md_collective_volume(port):
    """Scalar sums, O(slab-surface) hops, O(mesh/D) all-to-alls: no
    all-reduce of mesh size on the forward and backward passes."""
    counts = port("md-pme-False-4")[0]["counts"]
    assert counts["all_to_all"]["calls"] >= 1, "distributed FFT swap missing"
    assert counts["ring_hop"]["calls"] >= 3, "halo ring exchange missing"
    assert counts["all_reduce"]["max_elements"] < np.prod(MD_NS) // 8


def test_sharded_md_stale_state_poisons(port):
    for o in port("md_stale-2"):
        assert np.isnan(o["e"]), "stale sharded state not detected"
        assert np.all(np.isnan(o["g_pos"])), "stale-state forces not poisoned"


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_md_state_matches_jax_and_validates(d):
    data = MD[False]
    calc_p, calc_j = _port_calc(SPEC["pme"]), _jax_calc(SPEC["pme"])
    args = (data["positions"], data["cell"], MD_CUTOFF, MD_NS, d)
    rows = d > 1  # the JAX package's rows tables raise at one rank
    got = par.compute_sharded_md_state(calc_p, *args, rows=rows, device="cpu")
    want = jpar.compute_sharded_md_state(calc_j, *args, rows=rows)
    for name in ("cl_atom_index", "cl_slot_mask", "cl_atom_wrap", "tm_atom_of_slot",
                 "row_of_atom", "tm_slot_rows"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for name in ("n_axis", "cutoff", "ns_mesh", "nodes", "method", "n_devices", "n_atoms"):
        assert getattr(got, name) == getattr(want, name), name
    # every atom once in the cell slabs and once in the tiles
    idx = got.cl_atom_index.numpy()[got.cl_slot_mask.numpy()]
    np.testing.assert_array_equal(np.bincount(idx, minlength=220), 1)
    slots = got.tm_atom_of_slot.numpy().ravel()
    np.testing.assert_array_equal(np.bincount(slots[slots < 220], minlength=220), 1)
    if d == 1:
        # one rank: the port's rows tables name its own rows only
        own = par.compute_sharded_md_state(calc_p, *args, rows=True, device="cpu")
        table = own.tm_slot_rows.numpy()
        sentinel = own.rows_per_rank + np.prod(own.n_axis[1:]) * own.cl_slot_mask.shape[-1]
        assert np.all((table < own.rows_per_rank) | (table == sentinel))


def test_sharded_md_state_errors():
    data = MD[False]
    calc = _port_calc(SPEC["pme"])
    pos, cell = data["positions"], data["cell"]
    with pytest.raises(ValueError, match="divisible"):
        par.compute_sharded_md_state(calc, pos, cell, MD_CUTOFF, (100, 16, 16), 8, device="cpu")
    with pytest.raises(ValueError, match="multiple of 16"):
        par.compute_sharded_md_state(calc, pos, cell, MD_CUTOFF, (64, 16, 16), 8, device="cpu")
    with pytest.raises(ValueError, match="cell planes"):
        par.compute_sharded_md_state(calc, pos, cell, 2.5, MD_NS, 8, device="cpu")
    with pytest.raises(ValueError, match="ny"):
        par.compute_sharded_md_state(calc, pos, cell, MD_CUTOFF, (128, 8, 16), 8, device="cpu")
    with pytest.raises(ValueError, match="tile_capacity"):
        par.compute_sharded_md_state(calc, pos, cell, MD_CUTOFF, MD_NS, 8, tile_capacity=1,
                                     device="cpu")
    al = ALIGNED
    with pytest.raises(ValueError, match="tile"):
        par.compute_sharded_md_state(calc, al["positions"], al["cell"], 2.0, (256, 16, 16), 8,
                                     aligned=True, device="cpu")


def test_sharded_md_rows_no_global_force_reduction(port):
    """The forces stay on their rank: no all-reduce of O(n_rows)."""
    for name in ("rows-False-4", "rows-True-4"):
        out = port(name)
        assert out[0]["counts"]["all_reduce"]["max_elements"] < out[0]["n_rows"]


def test_sharded_md_rows_stale_poison_and_validation(port):
    for o in port("rows_stale-2"):
        assert np.isnan(o["e"])
        assert np.all(np.isnan(o["g_rows"]))
    errors = port("rows_errors-2")[0]["errors"]
    assert "rows=True" in errors[0] and "rows=True" in errors[1]
    assert "slab rows" in errors[2]
    assert errors[3] is None  # a float64 block of a float64 state runs


# -- the tile-aligned rows step (kernels A, B and C's split variant on a card) ---------


def _aligned_refs(d):
    """The port's single-rank aligned float32 step and its float64 cell-list
    step on the same float32 inputs, and JAX's float32 sharded aligned step."""
    data = ALIGNED

    def port_refs():
        calc = _port_calc(SPEC["pme"])
        pos, q, cell = (torch.tensor(data[k]) for k in ("positions", "charges", "cell"))
        fp = tpt.MDFastPath.create(calc, pos, cell, MD_CUTOFF, ns_mesh=MD_NS,
                                   mesh_impl="aligned")
        rows = fp.bucket(pos).requires_grad_()
        e1 = fp.energy(q, cell, rows)
        f1 = fp.unbucket(torch.autograd.grad(e1, rows)[0]).numpy()
        pos64 = pos.double().requires_grad_()
        clist = compute_cell_list(pos64.detach(), cell.double(), MD_CUTOFF)
        e64 = calc.energy(q.double(), cell.double(), pos64, cell_list=clist, ns_mesh=MD_NS)
        f64 = torch.autograd.grad(e64, pos64)[0].numpy()
        return float(e1.detach()), f1, float(e64.detach()), f64

    def jax_ref():
        calc = _jax_calc(SPEC["pme"])
        pos, q, cell = (jnp.asarray(data[k]) for k in ("positions", "charges", "cell"))
        state = jpar.compute_sharded_md_state(calc, pos, cell, MD_CUTOFF, MD_NS, 4,
                                              aligned=True)
        rows = state.bucket(pos)
        e, g = jax.jit(jax.value_and_grad(lambda r: jpar.sharded_md_energy_rows(
            calc, _mesh(4), q, cell, r, state)))(rows)
        return float(e), np.asarray(state.unbucket(g), np.float64)

    return _jax("aligned-port", port_refs), (_jax("aligned-jax", jax_ref) if d == 4 else None)


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_md_rows_aligned_matches(port, d):
    """The aligned float32 rows step at D ranks ≡ the port's single-rank
    aligned step and the JAX package's float32 sharded aligned step (energy
    2e-5, forces 5e-5 of max: the bars of tests/test_torch_md.py), and the
    float64 cell-list step on the same inputs (2e-5, 1e-5 of max: JAX's
    test's bars)."""
    out = port(f"aligned-{d}")
    (e1, f1, e64, f64), jax_ref = _aligned_refs(d)
    _same_on_every_rank(out)
    g_rows = np.concatenate([r["g_rows"] for r in out])
    f = g_rows[out[0]["row_of_atom"]]
    assert g_rows.dtype == np.float32
    assert abs(out[0]["e"] - e1) <= 2e-5 * abs(e1)
    assert rel(f, f1) <= 5e-5
    assert abs(out[0]["e"] - e64) <= 2e-5 * abs(e64)
    assert rel(f.astype(np.float64), f64) <= 1e-5
    if jax_ref is not None:
        assert abs(out[0]["e"] - jax_ref[0]) <= 2e-5 * abs(jax_ref[0])
        assert rel(f, jax_ref[1]) <= 5e-5
    empty = np.ones(out[0]["n_rows"], bool)
    empty[out[0]["row_of_atom"]] = False
    assert float(np.abs(g_rows[empty]).max(initial=0.0)) == 0.0


def test_sharded_md_rows_aligned_collectives_and_no_mesh_gather(port):
    """Aligned rows step: hops and the swap present, no all-reduce of
    O(n_rows), and no slot gather at all (the rows are the tile slots);
    the non-aligned rows step gathers its slots from the extended rows."""
    out = port("aligned-4")
    counts = out[0]["counts"]
    assert counts["all_to_all"]["calls"] >= 1 and counts["ring_hop"]["calls"] >= 3
    assert counts["all_reduce"]["max_elements"] < out[0]["n_rows"]
    assert all(o["gathers"] == 0 for o in out)
    assert all(o["gathers"] == 2 for o in port("rows-True-2"))


def test_sharded_md_rows_aligned_stale_and_validation(port):
    for o in port("aligned_stale-2"):
        assert np.isnan(o["e"])
        assert np.all(np.isnan(o["g_rows"]))
    errors = port("aligned_errors-2")[0]["errors"]
    assert "rows=True" in errors[0] and "rows=True" in errors[1]
    assert "slab rows" in errors[2]
    # float64 rows of an aligned state are refused (kernels A and B are float32)
    assert "float32" in errors[3]


def _jax_fields(obj) -> dict:
    """A JAX dataclass state as the dict of ``convert``'s keys."""
    from dataclasses import fields

    return {f.name: (None if getattr(obj, f.name) is None else
                     getattr(obj, f.name) if not hasattr(getattr(obj, f.name), "shape")
                     else np.asarray(getattr(obj, f.name))) for f in fields(obj)}


def _same_state(a, b):
    from dataclasses import fields

    for f in fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f.name)
        else:
            assert x == y, f.name


def test_convert_carries_jax_states():
    """``convert``'s parallel states: a JAX state through numpy is the
    port's own, and the port's round-trips."""
    from torchpme_tpu_torch import convert

    data, al = MD[True], ALIGNED
    calc_p, calc_j = _port_calc(SPEC["pme"]), _jax_calc(SPEC["pme"])
    cases = [
        (par.compute_sharded_md_state(calc_p, data["positions"], data["cell"], MD_CUTOFF, MD_NS,
                                      2, rows=True, device="cpu"),
         jpar.compute_sharded_md_state(calc_j, data["positions"], data["cell"], MD_CUTOFF,
                                       MD_NS, 2, rows=True),
         convert.sharded_md_state, convert.sharded_md_from_state),
        (par.compute_sharded_md_state(calc_p, al["positions"], al["cell"], MD_CUTOFF, MD_NS, 4,
                                      aligned=True, device="cpu"),
         jpar.compute_sharded_md_state(calc_j, al["positions"], al["cell"], MD_CUTOFF, MD_NS, 4,
                                       aligned=True),
         convert.sharded_md_state, convert.sharded_md_from_state),
        (par.compute_sharded_md_dipole_state(
            tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=0.5), interpolation_nodes=5),
            data["positions"], data["cell"], MD_CUTOFF, 2, ns_mesh=MD_NS, device="cpu"),
         jpar.compute_sharded_md_dipole_state(
            tpme.PMECalculatorDipole(tpme.PotentialDipole(smearing=0.5), interpolation_nodes=5),
            data["positions"], data["cell"], MD_CUTOFF, 2, ns_mesh=MD_NS),
         convert.sharded_md_dipole_state, convert.sharded_md_dipole_from_state),
        (par.compute_slab_bucketing(SMALL["positions"], SMALL["cell"], MESH_NS, 4, 4,
                                    device="cpu"),
         jpar.compute_slab_bucketing(SMALL["positions"], SMALL["cell"], MESH_NS, 4, 4),
         convert.slab_bucketing_state, convert.slab_bucketing_from_state),
    ]
    for ours, theirs, to_state, from_state in cases:
        from_jax = from_state(_jax_fields(theirs), device="cpu")
        if isinstance(ours, par.ShardedMDState) and ours.aligned:
            # the JAX aligned state carries an empty (D, 0, 0) tile table
            assert from_jax.tm_atom_of_slot.shape == ours.tm_atom_of_slot.shape
        _same_state(from_jax, ours)
        _same_state(from_state(to_state(ours), device="cpu"), ours)
