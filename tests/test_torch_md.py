"""The port's slice end to end: the aligned MDFastPath energy + force step
≡ the JAX package's (float64 against its tiled mode, float32 against its
aligned mode with the Pallas kernels in interpret mode), the staleness and
rebucket contracts, the numpy state conversion, the no-JAX import rule, and
the reference constant of chip_smoke.py."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import clustered_box, jax_md_state, port_from_jax, random_box, rel

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu_torch.convert import md_from_state, md_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NS = (32, 32, 32)
CUTOFF = 3.0


def _system():
    return clustered_box(400, 16.0, seed=3, n_cluster=30)


def _calcs(nodes=5, smearing=1.0):
    return (
        tpme.PMECalculator(
            tpme.CoulombPotential(smearing=smearing), mesh_spacing=0.5,
            interpolation_nodes=nodes,
        ),
        tpt.PMECalculator(
            tpt.CoulombPotential(smearing=smearing), mesh_spacing=0.5,
            interpolation_nodes=nodes,
        ),
    )


def _port_step(fp, pos, q, cell, dtype, plain=False):
    """(energy, atom-order forces, cell gradient) of the port's step."""
    c = torch.tensor(cell, dtype=dtype, requires_grad=True)
    rows = fp.bucket(torch.tensor(pos, dtype=dtype)).requires_grad_()
    e = fp.energy(torch.tensor(q, dtype=dtype), c, rows, plain=plain)
    g_rows, g_cell = torch.autograd.grad(e, (rows, c))
    return float(e.detach()), -fp.unbucket(g_rows).numpy(), g_cell.numpy()


def _jax_step(fp_j, pos, q, cell, jdt):
    rows = fp_j.bucket(jnp.asarray(pos, jdt))
    e, (g_cell, g_rows) = jax.jit(jax.value_and_grad(fp_j.energy, argnums=(1, 2)))(
        jnp.asarray(q, jdt), jnp.asarray(cell, jdt), rows
    )
    return float(e), -np.asarray(fp_j.unbucket(g_rows)), np.asarray(g_cell)


@pytest.fixture(scope="module")
def f64_case():
    pos, q, cell = _system()
    calc_j, calc_t = _calcs()
    fp_j = tpme.MDFastPath.create(
        calc_j, jnp.asarray(pos), jnp.asarray(cell), CUTOFF, NS, mesh_impl="tiled"
    )
    ref = _jax_step(fp_j, pos, q, cell, jnp.float64)
    fp = tpt.MDFastPath.create(calc_t, torch.tensor(pos), torch.tensor(cell), CUTOFF, NS)
    return fp, ref, (pos, q, cell)


def test_slice_f64_matches_jax_tiled(f64_case):
    fp, (e_j, f_j, c_j), (pos, q, cell) = f64_case
    assert fp.aligned_pad >= 1 and fp.clist.extra_index is not None
    e, f, c = _port_step(fp, pos, q, cell, torch.float64)
    assert abs(e - e_j) <= 1e-9 * abs(e_j)
    assert rel(f, f_j) <= 1e-9
    assert rel(c, c_j) <= 1e-8


@pytest.fixture(scope="module", params=[5, 4], ids=["nodes5", "nodes4"])
def f32_case(request):
    pos, q, cell = _system()
    calc_j, calc_t = _calcs(nodes=request.param)
    f32 = jnp.float32
    fp_j = tpme.MDFastPath.create(
        calc_j, jnp.asarray(pos, f32), jnp.asarray(cell, f32), CUTOFF, NS,
        mesh_impl="aligned",
    )
    ref = _jax_step(fp_j, pos, q, cell, f32)
    fp = tpt.MDFastPath.create(
        calc_t, torch.tensor(pos, dtype=torch.float32),
        torch.tensor(cell, dtype=torch.float32), CUTOFF, NS,
    )
    return fp_j, fp, ref, (pos, q, cell)


def test_slice_f32_matches_jax_aligned(f32_case):
    _, fp, (e_j, f_j, _), (pos, q, cell) = f32_case
    e, f, _ = _port_step(fp, pos, q, cell, torch.float32)
    assert abs(e - e_j) <= 2e-5 * abs(e_j)  # the bars of tests/test_md.py:212-214
    assert rel(f, f_j) <= 5e-5


def test_create_reproduces_jax_state(f32_case):
    """The port's aligned state is the JAX package's but for the staleness
    tolerance folded into it: the x/y balance cap is STALE_TOL cell edges
    smaller, and the pad covers slack + STALE_TOL (the arrays agree here)."""
    from torchpme_tpu_torch.ops.rspace_cells import STALE_TOL

    fp_j, fp, _, _ = f32_case
    ours, theirs = md_state(fp), jax_md_state(fp_j)
    assert ours.keys() == theirs.keys()
    for c in range(2):
        assert theirs["slack"][c] - STALE_TOL <= ours["slack"][c] <= theirs["slack"][c]
    assert ours["slack"][2] == theirs["slack"][2]
    reach = (max(ours["slack"][:2]) + STALE_TOL) * 8 - 0.5 * (fp.calc.interpolation_nodes % 2)
    assert ours["aligned_pad"] == int(np.ceil(reach - 1e-9)) >= theirs["aligned_pad"]
    for key, value in theirs.items():
        if key in ("slack", "aligned_pad"):
            continue
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        else:
            assert tuple(np.atleast_1d(ours[key])) == tuple(np.atleast_1d(value)), key


def test_convert_from_jax_state(f32_case):
    fp_j, _, (e_j, f_j, _), (pos, q, cell) = f32_case
    fp = port_from_jax(fp_j)
    e, f, _ = _port_step(fp, pos, q, cell, torch.float32)
    assert abs(e - e_j) <= 2e-5 * abs(e_j)
    assert rel(f, f_j) <= 5e-5


def test_convert_round_trip(f64_case):
    fp, _, (pos, q, cell) = f64_case
    state = md_state(fp)
    back = md_from_state(state, device="cpu")
    again = md_state(back)
    for key, value in state.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(again[key], value, err_msg=key)
            assert again[key].dtype == value.dtype, key
        else:
            assert again[key] == value, key
    assert state["mesh_impl"] == "aligned" and state["tiled"] is None
    assert _port_step(back, pos, q, cell, torch.float64)[0] == _port_step(
        fp, pos, q, cell, torch.float64
    )[0]


def test_stale_rows_poison_energy_and_forces(f64_case):
    fp, _, (pos, q, cell) = f64_case
    rows = fp.bucket(torch.tensor(pos))
    rows[int(fp.row_of_atom[0]), 0] += cell[0, 0] / 2
    rows.requires_grad_()
    e = fp.energy(torch.tensor(q), torch.tensor(cell), rows)
    (g,) = torch.autograd.grad(e, rows)
    assert torch.isnan(e)
    assert torch.isnan(fp.unbucket(g)).all()


# (balance, cutoff): the default slack, a wider one (cell edges 4 Å against a
# 2.6 Å cutoff: 1.4 mesh cells where the balance cap allows it, and there an
# odd stencil's pad, ceil(reach − ½), is one cell less than ceil(slack ·
# TILE)), and none
LIMIT_CASES = {"balanced": (True, CUTOFF), "balanced_wide": (True, 2.6),
               "unbalanced": (False, CUTOFF)}


@pytest.mark.parametrize("case", LIMIT_CASES)
@pytest.mark.parametrize("nodes", [3, 4, 5, 6])
@pytest.mark.parametrize("side", [-1, 1], ids=["low_face", "high_face"])
def test_aligned_window_holds_every_atom_the_staleness_check_accepts(case, nodes, side):
    """An even stencil starts at floor(r), an odd one at round(r): an atom
    the staleness check still accepts (up to its slack + STALE_TOL cell
    edges past its cell) must keep every stencil node inside the aligned
    spread window, so the density keeps its whole charge while the energy
    is flagged valid."""
    from torchpme_tpu_torch.ops.mesh_tiled import TILE
    from torchpme_tpu_torch.ops.rspace_cells import STALE_TOL, _prepare_bucketed
    from torchpme_tpu_torch.ops.spread_fused import aligned_tiled_density

    balance, cutoff = LIMIT_CASES[case]
    pos, q, cell = random_box(300, 16.0, seed=5)
    _, calc = _calcs(nodes=nodes)
    fp = tpt.MDFastPath.create(calc, pos, cell, cutoff, NS, mesh_impl="aligned",
                               balance=balance, device="cpu")
    clist = fp.clist
    if case == "balanced_wide" and nodes == 3:
        # the pad is below ceil(slack · TILE) here: the half cell of the odd
        # stencil's rounding is what the window leaves out (at 5 nodes the
        # balance cap holds the slack under one mesh cell, and both agree)
        assert fp.aligned_pad < np.ceil(clist.slack[0] * TILE)
    nx, ny, nz = clist.n_axis
    n_cells, cap = clist.slot_mask.shape
    edge = cell[0, 0] / nx
    ones = torch.ones((pos.shape[0], 1), dtype=torch.float64)

    def flag_and_charge(rows):
        n = n_cells * cap
        valid = _prepare_bucketed(
            ones[clist.atom_index.long()], rows[:n].reshape(n_cells, cap, 3),
            torch.tensor(cell), clist,
        )[4]
        q_rows = torch.zeros((fp.n_rows, 1), dtype=torch.float64)
        q_rows = q_rows.index_copy(0, fp.row_of_atom.long(), ones)
        rho = aligned_tiled_density(
            rows, q_rows, torch.linalg.inv(torch.tensor(cell)), NS, nodes, "Lagrange",
            fp.cell_grid, pad_cells=fp.aligned_pad, plain=True,
        )
        return bool(valid), float(rho.sum())

    rows = fp.bucket(torch.tensor(pos))
    assert flag_and_charge(rows) == (True, pytest.approx(pos.shape[0], rel=1e-12))
    # move one atom 0.5 STALE_TOL cell edges past its slack, beyond one x face
    row = int(fp.row_of_atom[0])
    home, slot = divmod(row, cap)
    cx = home // (ny * nz)
    past = clist.slack[0] + 0.5 * STALE_TOL
    frac = cx - past if side < 0 else cx + 1 + past
    rows[row, 0] = (frac + nx * int(clist.atom_wrap[home, slot, 0])) * edge
    valid, charge = flag_and_charge(rows)
    assert valid
    assert charge == pytest.approx(pos.shape[0], rel=1e-12)


@pytest.mark.parametrize("nodes", [3, 4, 5, 6, 7])
def test_aligned_balance_cap_leaves_a_fresh_state_valid(nodes):
    """The x/y balance cap less the staleness tolerance never goes below 0
    (7 nodes leave no pad at all), the pad stays within the 2-tile fold, and
    a freshly built state is never flagged stale."""
    from torchpme_tpu_torch.ops.rspace_cells import _prepare_bucketed
    from torchpme_tpu_torch.ops.spread_fused import aligned_geometry
    from torchpme_tpu_torch.ops.mesh_tiled import TILE

    pos, q, cell = random_box(300, 16.0, seed=5)
    _, calc = _calcs(nodes=nodes)
    fp = tpt.MDFastPath.create(calc, pos, cell, CUTOFF, NS, balance=True, device="cpu")
    assert min(fp.clist.slack) >= 0.0
    assert aligned_geometry(nodes, fp.aligned_pad)[0] <= 2 * TILE
    n_cells, cap = fp.clist.slot_mask.shape
    rows = fp.bucket(torch.tensor(pos))[: n_cells * cap].reshape(n_cells, cap, 3)
    q_rows = torch.tensor(q)[fp.clist.atom_index.long()]
    assert bool(_prepare_bucketed(q_rows, rows, torch.tensor(cell), fp.clist)[4])


def test_rebucket_keeps_shapes(f64_case):
    fp, _, (pos, q, cell) = f64_case
    rows = fp.bucket(torch.tensor(pos))
    rows[int(fp.row_of_atom[0]), 0] += cell[0, 0] / 2  # stale
    fp2 = fp.rebucket(rows, torch.tensor(cell))
    assert fp2.n_rows == fp.n_rows
    assert fp2.clist.slot_mask.shape == fp.clist.slot_mask.shape
    assert fp2.clist.slack == fp.clist.slack
    assert fp2.aligned_pad == fp.aligned_pad and fp2.mesh_impl == "aligned"
    e = fp2.energy(torch.tensor(q), torch.tensor(cell), fp2.bucket(fp.unbucket(rows)))
    assert torch.isfinite(e)
    np.testing.assert_array_equal(fp.unbucket(fp.bucket(torch.tensor(pos))).numpy(), pos)


def test_mesh_modes_and_options_validated():
    pos, q, cell = random_box(100, 16.0, seed=9)
    _, calc = _calcs()
    with pytest.raises(ValueError, match="mesh_impl='tiled'"):  # tile edge 1.0 < cutoff
        tpt.MDFastPath.create(calc, pos, cell, CUTOFF, (128, 128, 128), mesh_impl="aligned",
                              device="cpu")
    # `auto` takes the tiled mode where aligned cannot run
    cpu = dict(device="cpu")
    assert tpt.MDFastPath.create(calc, pos, cell, CUTOFF, (64, 64, 32), **cpu).mesh_impl == "tiled"
    assert tpt.MDFastPath.create(calc, pos, cell, CUTOFF, NS, **cpu).mesh_impl == "aligned"
    assert tpt.MDFastPath.create(calc, pos, cell, CUTOFF, NS, mesh_impl="tiled",
                                 **cpu).tiled is not None
    for kw, err in (
        (dict(mesh_impl="fused", tile_capacity=100), ValueError),
        (dict(mesh_impl="nope"), ValueError),
        (dict(extras_impl="table"), ValueError),
        (dict(balance="yes"), ValueError),
    ):
        with pytest.raises(err):
            tpt.MDFastPath.create(calc, pos, cell, CUTOFF, NS, **kw, **cpu)
    with pytest.raises(ValueError, match="tile"):
        tpt.MDFastPath.create(calc, pos, cell, CUTOFF, (24, 24, 24), **cpu)


def test_package_imports_no_jax_and_no_cuda():
    """Importing the port pulls in no JAX module and the JAX package not at
    all, touches no CUDA state and builds no kernel."""
    code = (
        "import sys\n"
        "jaxmods = lambda: {m for m in sys.modules if m == 'jax' or m.startswith('jax.')}\n"
        "before = jaxmods()\n"
        "import torch, torchpme_tpu_torch, torchpme_tpu_torch.convert\n"
        "from torchpme_tpu_torch import kernels\n"
        "assert jaxmods() == before, sorted(jaxmods() - before)\n"
        "assert not any(m == 'torchpme_tpu' or m.startswith('torchpme_tpu.') for m in sys.modules)\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert kernels.load_library.cache_info().currsize == 0\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_no_jax_imports_in_source():
    files = sorted((REPO / "torchpme_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "torchpme_tpu"), f"{path}: {name}"


def test_chip_smoke_reference_constants():
    """chip_smoke.py's 1536-atom reference energy is the JAX package's
    aligned float32 step; the port's own float32 step on this CPU lands
    within the script's bars (energy 1e-5 of it, forces 1e-3 of truth)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    pos, q, cell = cs.water_box(cs.GT_N)
    calc_j, calc_t = _calcs(nodes=cs.NODES, smearing=cs.GT_SMEARING)
    f32 = jnp.float32
    fp_j = tpme.MDFastPath.create(
        calc_j, jnp.asarray(pos, f32), jnp.asarray(cell, f32), cs.CUTOFF, cs.GT_NS,
        mesh_impl="aligned",
    )
    e_j, _, _ = _jax_step(fp_j, pos, q, cell, f32)
    assert abs(e_j - cs.GT_JAX_ENERGY) <= 1e-6 * abs(cs.GT_JAX_ENERGY)

    fp = tpt.MDFastPath.create(
        calc_t, torch.tensor(pos, dtype=torch.float32),
        torch.tensor(cell, dtype=torch.float32), cs.CUTOFF, cs.GT_NS,
    )
    assert fp.aligned_pad == 1 and fp.clist.extra_index is not None
    assert fp.cell_grid[3] == 24
    e, f, _ = _port_step(fp, pos, q, cell, torch.float32)
    truth = np.load(REPO / "tools" / "ground_truth.npz")
    f_ref = truth["forces"]
    assert abs(e - cs.GT_JAX_ENERGY) <= 1e-5 * abs(cs.GT_JAX_ENERGY)
    assert np.sqrt(np.mean((f - f_ref) ** 2)) / np.sqrt(np.mean(f_ref**2)) <= 1.0e-3


def test_chip_smoke_tiled_reference_constants():
    """chip_smoke.py's tiled-mode reference: the JAX package's float32 tiled
    step at the 64³ mesh of mesh_spacing=1.2 (where aligned mode cannot run)
    gives GT_TILED_JAX_ENERGY and meets the 1e-4 force bar against
    tools/ground_truth.npz on this CPU; the port's own float32 tiled step
    lands within the script's bars of both."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    pos, q, cell = cs.water_box(cs.GT_N)
    kw = dict(mesh_spacing=cs.GT_MESH_SPACING, interpolation_nodes=cs.NODES)
    calc_j = tpme.PMECalculator(tpme.CoulombPotential(smearing=cs.GT_SMEARING), **kw)
    calc_t = tpt.PMECalculator(tpt.CoulombPotential(smearing=cs.GT_SMEARING), **kw)
    assert calc_t.get_ns_mesh(cell) == calc_j.get_ns_mesh(jnp.asarray(cell)) == cs.GT_TILED_NS
    assert not tpt.MDFastPath._aligned_supported(cell, cs.CUTOFF, cs.GT_TILED_NS)
    truth = np.load(REPO / "tools" / "ground_truth.npz")
    f_ref, e_ref = truth["forces"], float(truth["energy"])

    def force_rms(f):
        return np.sqrt(np.mean((f - f_ref) ** 2)) / np.sqrt(np.mean(f_ref**2))

    f32 = jnp.float32
    fp_j = tpme.MDFastPath.create(
        calc_j, jnp.asarray(pos, f32), jnp.asarray(cell, f32), cs.CUTOFF, cs.GT_TILED_NS,
        mesh_impl="tiled",
    )
    e_j, f_j, _ = _jax_step(fp_j, pos, q, cell, f32)
    assert abs(e_j - cs.GT_TILED_JAX_ENERGY) <= 1e-6 * abs(cs.GT_TILED_JAX_ENERGY)
    assert force_rms(f_j) <= cs.GT_FORCE_BAR and abs(e_j - e_ref) <= cs.GT_FORCE_BAR * abs(e_ref)

    fp = tpt.MDFastPath.create(
        calc_t, torch.tensor(pos, dtype=torch.float32),
        torch.tensor(cell, dtype=torch.float32), cs.CUTOFF, cs.GT_TILED_NS,
    )
    assert fp.mesh_impl == "tiled" and fp.tiled.local_x.shape == (64, 64)
    e, f, _ = _port_step(fp, pos, q, cell, torch.float32)
    assert abs(e - cs.GT_TILED_JAX_ENERGY) <= 1e-5 * abs(cs.GT_TILED_JAX_ENERGY)
    assert force_rms(f) <= cs.GT_FORCE_BAR and abs(e - e_ref) <= cs.GT_FORCE_BAR * abs(e_ref)
    assert rel(f, f_j) <= 5e-5
