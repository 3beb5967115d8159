"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the kernels
have no CPU mode; their arithmetic is covered on the CPU through the twins).
On a machine with a card (which has no JAX, so without the suite's
conftest): ``python -m pytest tests/test_torch_kernels_cuda.py --noconftest``.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import torchpme_tpu_torch as tpt
from torchpme_tpu_torch import kernels
from torchpme_tpu_torch.ops import mesh_kernels as mk
from torchpme_tpu_torch.ops import mesh_tiled as mt
from torchpme_tpu_torch.ops import rspace_cells as rc
from torchpme_tpu_torch.ops import rspace_cells_dipole as rcd
from torchpme_tpu_torch.ops import spread_fused as sf

pytestmark = pytest.mark.cuda

NS = (32, 32, 32)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _clustered_box(seed=3):
    """400 random atoms plus a dense cluster (the cell list spills)."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform(0, 16.0, (400, 3)), 0.5 + 0.6 * rng.uniform(size=(30, 3))])
    q = rng.normal(size=(430, 1))
    return pos, q - q.mean(), np.eye(3) * 16.0


@pytest.fixture(scope="module")
def step(device):
    pos, q, cell = _clustered_box()
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=5)
    f32 = dict(dtype=torch.float32, device=device)
    fp = tpt.MDFastPath.create(calc, torch.tensor(pos, **f32), torch.tensor(cell, **f32), 3.0, NS)
    return fp, torch.tensor(pos, **f32), torch.tensor(q, **f32), torch.tensor(cell, **f32)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _hold_z_chunk(request, kernel, z_chunk):
    """Hold a kernel's z chunk (``kernels.override_z_chunk``) until the test
    ends."""
    kernels.override_z_chunk(kernel, z_chunk)
    request.addfinalizer(lambda: kernels.override_z_chunk(kernel, None))


def _slots(fp, pos, q, cell):
    nx_c, ny_c, nz_c, cap = fp.cell_grid
    extent, lpad = sf.aligned_geometry(5, fp.aligned_pad)
    geom = sf.SpreadGeometry(NS, 5, "Lagrange", extent, lpad, nx_c * ny_c, nz_c * cap, nz_c)
    nb = geom.n_tiles * geom.slots_per_tile
    rows = fp.bucket(pos)
    ns = torch.tensor(NS, dtype=torch.float32, device=pos.device)
    rel = (rows @ torch.linalg.inv(cell) * ns)[:nb].contiguous()
    q_rows = torch.zeros((fp.n_rows, 1), dtype=torch.float32, device=pos.device)
    q_rows = q_rows.index_copy(0, fp.row_of_atom.long(), q)[:nb].contiguous()
    return rel, q_rows, geom


def test_spread_kernels_match_plain(step):
    fp, pos, q, cell = step
    rel, q_rows, geom = _slots(fp, pos, q, cell)
    assert _rel(sf.fused_spread(rel, q_rows, geom), sf.spread_plain(rel, q_rows, geom)) <= 1e-5
    ct = torch.randn((1, *NS), device=pos.device)
    for a, b in zip(
        sf.fused_spread_bwd(rel, q_rows, ct, geom), sf.spread_plain_bwd(rel, q_rows, ct, geom)
    ):
        assert _rel(a, b) <= 1e-5


def test_window_kernel_matches_plain(step):
    fp, pos, q, cell = step
    n_cells, cap = fp.clist.slot_mask.shape
    rows = fp.bucket(pos)[: n_cells * cap].reshape(n_cells, cap, 3)
    ins = rc._prepare_bucketed(q[fp.clist.atom_index.long()], rows, cell, fp.clist)[:4]
    pot = fp.calc.potential
    e_k, g_k = rc.window_value_and_grad(pot, 3.0, *ins)
    e_p, g_p = rc._we_value_and_grad(pot, 3.0, *ins)
    assert abs(float(e_k) - float(e_p)) <= 1e-5 * abs(float(e_p))
    for a, b in zip(g_k, g_p):
        assert _rel(a, b) <= 1e-5


def test_step_launches_every_kernel_and_matches_plain(step):
    fp, pos, q, cell = step
    out = {}
    for plain in (False, True):
        rows = fp.bucket(pos).requires_grad_()
        kernels.reset_launch_counts()
        e = fp.energy(q, cell, rows, plain=plain)
        (g,) = torch.autograd.grad(e, rows)
        torch.cuda.synchronize()
        out[plain] = (float(e.detach()), g, kernels.launch_counts())
    aligned = ("spread_fwd", "spread_bwd", "window")
    assert all(out[False][2][name] == 1 for name in aligned), out[False][2]
    assert all(n == 0 for n in out[True][2].values()), out[True][2]
    assert abs(out[False][0] - out[True][0]) <= 1e-5 * abs(out[True][0])
    assert _rel(out[False][1], out[True][1]) <= 1e-5


def test_kernels_refuse_float64(step):
    fp, pos, q, cell = step
    with pytest.raises(TypeError, match="float32"):
        fp.energy(q.double(), cell.double(), fp.bucket(pos.double()))
    assert np.isfinite(float(fp.energy(q.double(), cell.double(), fp.bucket(pos.double()), plain=True)))


def _dense_window_inputs(device, capacity=None, n_ch=1):
    """Window inputs of a 3×3×3 cell grid whose capacity exceeds one warp
    (or is ``capacity``), with ``n_ch`` charge channels."""
    rng = np.random.default_rng(21)
    cell = np.eye(3) * 9.5 + np.asarray([[0, 0, 0], [0.7, 0, 0], [-0.4, 0.5, 0]])
    pos = rng.uniform(0, 1, (1150, 3)) @ cell
    f32 = dict(dtype=torch.float32, device=device)
    clist = tpt.ops.compute_cell_list(pos, cell, 3.0, capacity=capacity, spill=False,
                                      device=device)
    assert clist.n_axis == (3, 3, 3) and clist.slot_mask.shape[1] > 32
    idx = clist.atom_index.long()
    return rc._prepare_bucketed(
        torch.tensor(rng.normal(size=(1150, n_ch)), **f32)[idx], torch.tensor(pos, **f32)[idx],
        torch.tensor(cell, **f32), clist,
    )[:4]


# (capacity, channels, offsets a pass): every group size of csrc/window.cu
EDGE_WINDOWS = {
    "grid3_cap_gt_32": (None, 1, 27),
    "grid3_cap250_ch4": (250, 4, 9),
    "grid3_cap700": (700, 1, 3),
    "grid3_cap1600_ch4": (1600, 4, 1),
}


@pytest.mark.parametrize("shape", ["clustered", *EDGE_WINDOWS])
def test_window_kernel_is_reproducible_and_matches_plain_at_edge_shapes(step, shape):
    """Kernel C at a capacity above 32 on the smallest grid, up to capacities
    that take one x plane, a row or one offset of the 27 per pass: within the
    plain version's bars, and d_pc, d_q bitwise equal over two launches
    (each row has one writer)."""
    if shape == "clustered":
        fp, pos, q, cell = step
        n_cells, cap = fp.clist.slot_mask.shape
        rows = fp.bucket(pos)[: n_cells * cap].reshape(n_cells, cap, 3)
        ins = rc._prepare_bucketed(q[fp.clist.atom_index.long()], rows, cell, fp.clist)[:4]
    else:
        capacity, n_ch, group = EDGE_WINDOWS[shape]
        ins = _dense_window_inputs(step[1].device, capacity, n_ch)
        cap = ins[0].shape[-1]
        assert rc._window_group(cap, n_ch, ins[0].device.index) == group
    pot = tpt.CoulombPotential(smearing=1.0)
    kernels.reset_launch_counts()
    e_a, g_a = rc.window_value_and_grad(pot, 3.0, *ins)
    e_b, g_b = rc.window_value_and_grad(pot, 3.0, *ins)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["window"] == 2
    assert torch.equal(g_a[0], g_b[0]) and torch.equal(g_a[1], g_b[1])
    e_p, g_p = rc._we_value_and_grad(pot, 3.0, *ins)
    assert abs(float(e_a) - float(e_p)) <= 1e-6 * abs(float(e_p))
    for a, b in zip(g_a[:3], g_p[:3]):
        assert a.dtype == torch.float32 and a.shape == b.shape
    assert g_a[3].dtype == torch.float64 and g_a[3].shape == (3, 3)
    assert _rel(g_a[0], g_p[0]) <= 1e-5 and _rel(g_a[1], g_p[1]) <= 1e-5
    # d_offs totals every gradient of an offset; the plain version sums it in
    # float32, which leaves ~1e-4 of max in the self row (0 in exact
    # arithmetic, and in the kernel): hold it against float64 as well, and
    # the image term (double sums of the boundary pairs' gradients)
    _, g64 = rc._we_value_and_grad(pot, 3.0, *[t.double() for t in ins])
    assert _rel(g_a[2], g_p[2]) <= 5e-4 and _rel(g_a[2], g64[2]) <= 1e-5
    assert _rel(g_a[3], g_p[3]) <= 1e-5 and _rel(g_a[3], g64[3]) <= 1e-5


def test_window_kernel_refuses_what_it_does_not_take(step):
    fp, pos, q, cell = step
    ins = _dense_window_inputs(pos.device)
    with pytest.raises(TypeError, match="float32"):
        rc.window_value_and_grad(fp.calc.potential, 3.0, *[t.double() for t in ins])
    with pytest.raises(TypeError, match="Coulomb"):
        rc.window_value_and_grad(tpt.Potential(smearing=1.0), 3.0, *ins)
    # a capacity whose one offset a pass exceeds shared memory: a clear error
    # that names the largest capacity it takes
    largest = torch.ops.tpme.window_plan(1, 4, False, pos.device.index)[1]
    assert 1500 < largest < 4000
    assert rc._window_group(largest, 4, pos.device.index) == 1
    big = _dense_window_inputs(pos.device, capacity=largest + 1, n_ch=4)
    with pytest.raises(ValueError, match=f"at most {largest} at 4 channel"):
        rc.window_value_and_grad(fp.calc.potential, 3.0, *big)


def test_spread_kernel_takes_a_tall_mesh(device):
    """Kernel A at nz = 288 (the first version's tile field would not fit
    shared memory there) against its plain version; every mesh cell is
    written (the output is not zeroed first)."""
    rng = np.random.default_rng(5)
    cell = np.diag([16.0, 16.0, 36.0])
    pos = rng.uniform(0, 1, (900, 3)) @ cell
    ns = (32, 32, 288)
    f32 = dict(dtype=torch.float32, device=device)
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=5)
    fp = tpt.MDFastPath.create(calc, torch.tensor(pos, **f32), torch.tensor(cell, **f32), 3.0, ns,
                               mesh_impl="aligned")
    nx_c, ny_c, nz_c, cap = fp.cell_grid
    extent, lpad = sf.aligned_geometry(5, fp.aligned_pad)
    geom = sf.SpreadGeometry(ns, 5, "Lagrange", extent, lpad, nx_c * ny_c, nz_c * cap, nz_c)
    nb = geom.n_tiles * geom.slots_per_tile
    rows = fp.bucket(torch.tensor(pos, **f32))
    rel = (rows @ torch.linalg.inv(torch.tensor(cell, **f32)) * torch.tensor(ns, **f32))[:nb]
    q = torch.zeros((fp.n_rows, 2), **f32)
    q = q.index_copy(0, fp.row_of_atom.long(), torch.tensor(rng.normal(size=(900, 2)), **f32))
    q = q[:nb].contiguous()
    torch.cuda.empty_cache()
    got = sf.fused_spread(rel.contiguous(), q, geom)
    ref = sf.spread_plain(rel, q, geom)
    torch.cuda.synchronize()
    assert got.shape == (2, *ns) and bool(torch.isfinite(got).all())
    assert _rel(got, ref) <= 1e-6
    with pytest.raises(TypeError, match="float32"):
        sf.fused_spread(rel.double().contiguous(), q.double(), geom)


# -- kernels D, E, F (tile spread, gather, weight gradient) --------------------

MESH_CASES = [  # (nodes, channels, nz), as tests/ops/test_mesh_pallas.py
    (nodes, n_ch, nz) for nodes in (3, 4, 5) for n_ch, nz in ((1, 128), (3, 128), (2, 96))
]


def _tiled_case(device, nodes, n_ch, nz, n=500, seed=0):
    """A float32 bucketing on a (32, 32, nz) mesh, per-slot charges and a
    random mesh field."""
    rng = np.random.default_rng(seed)
    ns = (32, 32, nz)
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.tensor(rng.uniform(0, 10.0, (n, 3)), **f32)
    interp = mt.compute_tiled_interpolation(
        pos, torch.eye(3, **f32) / 10.0, ns, nodes, "Lagrange"
    )
    q_slots = mt._slot_values(interp, torch.tensor(rng.normal(size=(n, n_ch)), **f32))
    field = torch.tensor(rng.normal(size=(n_ch, *ns)), **f32)
    return interp, q_slots, field


def _arrays(interp):
    return interp.local_x, interp.local_y, interp.start_z, interp.weights


@pytest.mark.parametrize("nodes,n_ch,nz", MESH_CASES)
def test_mesh_kernels_match_plain(device, nodes, n_ch, nz):
    interp, q_slots, field = _tiled_case(device, nodes, n_ch, nz)
    a, ns = _arrays(interp), interp.ns
    kernels.reset_launch_counts()
    assert _rel(mk.mesh_spread(*a, q_slots, ns, nodes),
                mk.mesh_spread_plain(*a, q_slots, ns, nodes)) <= 1e-5
    assert _rel(mk.mesh_gather(*a, field, ns, nodes),
                mk.mesh_gather_plain(*a, field, ns, nodes)) <= 1e-5
    wg_plain = mk.mesh_wgrad_plain(*a, q_slots, field, ns, nodes)
    assert _rel(mk.mesh_wgrad(*a, q_slots, field, ns, nodes), wg_plain) <= 1e-5
    vals, wg = mk.mesh_gather_wgrad(*a, q_slots, field, ns, nodes)
    torch.cuda.synchronize()
    assert _rel(vals, mk.mesh_gather_plain(*a, field, ns, nodes)) <= 1e-5
    assert _rel(wg, wg_plain) <= 1e-5
    counts = kernels.launch_counts()
    assert (counts["mesh_spread"], counts["mesh_gather"], counts["mesh_wgrad"]) == (1, 2, 2)


@pytest.mark.parametrize("nz", [20, 40], ids=["under_one_chunk", "partial_last_chunk"])
def test_mesh_spread_splits_z_when_the_tile_field_exceeds_shared_memory(device, nz):
    """Kernel D takes z in chunks of 32 cells a block: a z line shorter than
    one chunk, and one whose last chunk is partial, ≡ the plain version."""
    interp, q_slots, _ = _tiled_case(device, 5, 2, nz)
    a, ns = _arrays(interp), interp.ns
    assert _rel(mk.mesh_spread(*a, q_slots, ns, 5), mk.mesh_spread_plain(*a, q_slots, ns, 5)) <= 1e-5


def test_mesh_kernels_ignore_stale_and_empty_slots(device):
    """A stencil start beyond the tile window writes nothing outside the
    mesh and empty slots contribute nothing: kernels ≡ plain versions."""
    interp, q_slots, field = _tiled_case(device, 4, 1, 128)
    lx = interp.local_x.clone()
    lx[interp.atom_of_slot < 500] = 9  # stale: two of four x nodes fall off the window
    a, ns = (lx, interp.local_y, interp.start_z, interp.weights), interp.ns
    assert _rel(mk.mesh_spread(*a, q_slots, ns, 4), mk.mesh_spread_plain(*a, q_slots, ns, 4)) <= 1e-5
    vals, wg = mk.mesh_gather_wgrad(*a, q_slots, field, ns, 4)
    assert _rel(vals, mk.mesh_gather_plain(*a, field, ns, 4)) <= 1e-5
    assert _rel(wg, mk.mesh_wgrad_plain(*a, q_slots, field, ns, 4)) <= 1e-5
    empty = interp.atom_of_slot == 500
    assert float(vals.transpose(1, 2)[empty].abs().max()) == 0.0
    assert float(wg[empty].abs().max()) == 0.0


@pytest.mark.parametrize("nodes,n_ch,nz", [(5, 1, 128), (4, 3, 128), (3, 2, 96)])
def test_mesh_autograd_functions_match_plain_backward(device, nodes, n_ch, nz):
    """Both autograd.Functions (spread: backward E + F; gather: backward
    D + F) against autograd through the plain versions."""
    interp, q_slots, field = _tiled_case(device, nodes, n_ch, nz)
    ct_mesh = torch.randn_like(field)
    ct_vals = torch.randn_like(q_slots)
    grads = {}
    for plain in (False, True):
        w = interp.weights.clone().requires_grad_()
        q = q_slots.clone().requires_grad_()
        f = field.clone().requires_grad_()
        it = replace(interp, weights=w)
        kernels.reset_launch_counts()
        loss = (mk.spread_tiles(it, q, plain=plain) * ct_mesh).sum() + (
            mk.gather_tiles(it, f, plain=plain) * ct_vals
        ).sum()
        grads[plain] = torch.autograd.grad(loss, (w, q, f))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = (0, 0, 0) if plain else (2, 2, 2)
        assert (counts["mesh_spread"], counts["mesh_gather"], counts["mesh_wgrad"]) == want
    for got, ref in zip(grads[False], grads[True]):
        assert _rel(got, ref) <= 1e-5


def test_mesh_kernels_refuse_float64(device):
    interp, q_slots, field = _tiled_case(device, 4, 1, 128)
    a = (interp.local_x, interp.local_y, interp.start_z, interp.weights.double())
    with pytest.raises(TypeError, match="float32"):
        mk.mesh_spread(*a, q_slots.double(), interp.ns, 4)
    with pytest.raises(TypeError, match="float32"):
        mk.mesh_gather(*a, field.double(), interp.ns, 4)
    ref = mk.mesh_gather_plain(*a, field.double(), interp.ns, 4)
    assert ref.dtype == torch.float64 and ref.device.type == "cuda"


def test_calculator_call_on_the_card_matches_plain(device):
    """PMECalculator.forward + autograd through kernels D, E, F ≡ the plain
    float32 path; `auto` picks the tiled backend on the card."""
    from torchpme_tpu_torch.utils.neighbors import compute_distances, neighbor_list

    pos, q, cell = _clustered_box()
    idx, _, shifts = neighbor_list(pos, cell, cutoff=3.0)
    f32 = dict(dtype=torch.float32, device=device)
    idx_t, shifts_t = torch.as_tensor(idx, device=device), torch.as_tensor(shifts, device=device)
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=5)
    out = {}
    for plain in (False, True):
        p = torch.tensor(pos, **f32).requires_grad_()
        c = torch.tensor(cell, **f32).requires_grad_()
        qt = torch.tensor(q, **f32).requires_grad_()
        kernels.reset_launch_counts()
        pot = calc(qt, c, p, idx_t, compute_distances(p, idx_t, c, shifts_t), ns_mesh=NS, plain=plain)
        g = torch.autograd.grad((pot * qt).sum(), (p, qt, c))
        torch.cuda.synchronize()
        out[plain] = (pot.detach(), *g)
        counts = kernels.launch_counts()
        launched = {k: counts[k] for k in ("mesh_spread", "mesh_gather", "mesh_wgrad")}
        if plain:
            assert not any(launched.values()), launched
        else:
            assert launched == {"mesh_spread": 2, "mesh_gather": 2, "mesh_wgrad": 2}, launched
    for got, ref in zip(out[False], out[True]):
        assert _rel(got, ref) <= 2e-5


# -- kernel G (the dipolar window) and the dipolar paths through D, E, F ---------

G_NAMES = ("e", "d_pc", "d_mu", "d_offs", "d_mui")
# d_offs totals every j-side force of a neighbor offset (cancelling 1/d^4
# terms), which the plain version sums in float32
G_TOLS = {"e": 1e-5, "d_pc": 1e-5, "d_mu": 1e-5, "d_offs": 5e-4, "d_mui": 1e-5}


def _dipole_window_case(device, smearing, triclinic=False, capacity=None, seed=0):
    rng = np.random.default_rng(seed)
    cell = np.eye(3) * 13.0
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = 2.0, -1.3, 1.6
    pos = rng.uniform(0, 1, (450, 3)) @ cell
    mu = rng.normal(size=(450, 3))
    f32 = dict(dtype=torch.float32, device=device)
    clist = tpt.ops.compute_cell_list(pos, cell, 3.0, capacity=capacity, spill=False, device=device)
    n_cells, cap = clist.slot_mask.shape
    idx = clist.atom_index.reshape(-1).long()
    ins = rc._prepare_bucketed(
        torch.tensor(mu, **f32)[idx].reshape(n_cells, cap, 3),
        torch.tensor(pos, **f32)[idx].reshape(n_cells, cap, 3), torch.tensor(cell, **f32), clist,
    )[:4]
    return tpt.PotentialDipole(smearing=smearing, prefactor=1.3), ins


def _split_mui(mu, device, seed=0):
    """Separate i-side dipoles: ``mu`` with ~30% of its slots zeroed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    keep = (torch.rand(mu.shape[:3], generator=gen, device=device) > 0.3).float()
    return (mu * keep[..., None, None]).contiguous()


def _g_rel(name, a, b, e_scale=0.0):
    """``_rel``; the energy's error over ``max(|e|, e_scale)``: with some
    i-side dipoles zeroed the energy can cancel to a small fraction of its
    terms (float32 vs float64 then differs by ~4e-4 of it in the plain
    version too), so it is measured on the scale of the energy of all the
    dipoles, as chip_smoke.py does."""
    if name != "e":
        return _rel(a, b)
    return float((a.double() - b.double()).abs() / max(float(b.double().abs()), e_scale))


@pytest.mark.parametrize("smearing", [0.9, None], ids=["smeared", "direct"])
@pytest.mark.parametrize("triclinic", [False, True], ids=["cubic", "triclinic"])
@pytest.mark.parametrize("split", [False, True], ids=["shared", "split"])
def test_dipole_window_kernel_matches_plain(device, smearing, triclinic, split):
    pot, ins = _dipole_window_case(device, smearing, triclinic)
    mui = _split_mui(ins[1], device) if split else None
    kernels.reset_launch_counts()
    e_k, g_k = rcd.dipole_window_value_and_grad(pot, 3.0, *ins, mui)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["window_dipole"] == 1
    e_p, g_p = rcd._dw_value_and_grad(pot, 3.0, *ins, mui)
    assert len(g_k) == len(g_p) == (4 if split else 3)
    dbl = [t.double() for t in ins]
    e_scale = abs(float(rcd._dw_value_and_grad(pot, 3.0, *dbl)[0])) if split else 0.0
    for name, a, b in zip(G_NAMES, (e_k, *g_k), (e_p, *g_p)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _g_rel(name, a, b, e_scale) <= G_TOLS[name], name
    # and against float64 on the same inputs, where the kernel's double sums show
    e64, g64 = rcd._dw_value_and_grad(pot, 3.0, *dbl, None if mui is None else mui.double())
    for name, a, b in zip(G_NAMES, (e_k, *g_k), (e64, *g64)):
        assert _g_rel(name, a, b, e_scale) <= (1e-4 if name == "d_offs" else 1e-5), name


def _dense_dipole_inputs(device, capacity=None, split=False):
    """Window inputs of a 3×3×3 cell grid whose capacity exceeds one warp
    (or is ``capacity``), with separate i-side dipoles when ``split``."""
    rng = np.random.default_rng(23)
    cell = np.eye(3) * 9.5 + np.asarray([[0, 0, 0], [0.7, 0, 0], [-0.4, 0.5, 0]])
    pos = rng.uniform(0, 1, (1100, 3)) @ cell
    f32 = dict(dtype=torch.float32, device=device)
    clist = tpt.ops.compute_cell_list(pos, cell, 3.0, capacity=capacity, spill=False,
                                      device=device)
    assert clist.n_axis == (3, 3, 3) and clist.slot_mask.shape[1] > 32
    idx = clist.atom_index.long()
    ins = list(rc._prepare_bucketed(
        torch.tensor(rng.normal(size=(1100, 3)), **f32)[idx], torch.tensor(pos, **f32)[idx],
        torch.tensor(cell, **f32), clist,
    )[:4])
    mui = None
    if split:
        keep = torch.tensor(rng.uniform(size=ins[1].shape[:3]) > 0.3, **f32)
        mui = (ins[1] * keep[..., None, None]).contiguous()
    return ins, mui


# (capacity, separate i-side dipoles, home cells a block): every block shape
# of csrc/window_dipole.cu, with and without mui
EDGE_DIPOLE_WINDOWS = {
    "grid3_cap_gt_32": (None, False, 4),
    "grid3_cap_gt_32_split": (None, True, 4),
    "grid3_cap250_split": (250, True, 4),
    "grid3_cap400_split": (400, True, 2),
    "grid3_cap500": (500, False, 2),
    "grid3_cap700_split": (700, True, 1),
    "grid3_cap1000": (1000, False, 1),
    "grid3_cap1024_split": (1024, True, 1),
}


@pytest.mark.parametrize("shape", [*EDGE_DIPOLE_WINDOWS, "smeared", "direct", "split"])
def test_dipole_window_kernel_is_reproducible_and_matches_plain(device, shape):
    """Kernel G at every block shape (capacity 250 with separate i-side
    dipoles among them) and on a cubic box smeared, direct and split: within the
    plain version's bars and float64's, and d_pc, d_mu, d_mui bitwise equal
    over two launches (each row has one writer)."""
    pot = tpt.PotentialDipole(smearing=0.9, prefactor=1.3)
    if shape in EDGE_DIPOLE_WINDOWS:
        capacity, split, warps = EDGE_DIPOLE_WINDOWS[shape]
        ins, mui = _dense_dipole_inputs(device, capacity, split)
        assert rcd._window_dipole_warps(ins[0].shape[-1], split, device.index) == warps
    else:
        pot, ins = _dipole_window_case(device, None if shape == "direct" else 0.9)
        mui = _split_mui(ins[1], device) if shape == "split" else None
    kernels.reset_launch_counts()
    e_a, g_a = rcd.dipole_window_value_and_grad(pot, 3.0, *ins, mui)
    e_b, g_b = rcd.dipole_window_value_and_grad(pot, 3.0, *ins, mui)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["window_dipole"] == 2
    for i in (0, 1, 3)[: len(g_a) - 1]:
        assert torch.equal(g_a[i], g_b[i]), G_NAMES[1 + i]
    e_p, g_p = rcd._dw_value_and_grad(pot, 3.0, *ins, mui)
    dbl = [t.double() for t in ins]
    e64, g64 = rcd._dw_value_and_grad(pot, 3.0, *dbl, None if mui is None else mui.double())
    e_scale = 0.0 if mui is None else abs(float(rcd._dw_value_and_grad(pot, 3.0, *dbl)[0]))
    for name, a, b, c in zip(G_NAMES, (e_a, *g_a), (e_p, *g_p), (e64, *g64)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        # d_offs: the plain version's float32 sum is itself up to ~6e-4 off
        # float64 on the dense grid, so the kernel's is held to float64 alone
        if name != "d_offs":
            assert _g_rel(name, a, b, e_scale) <= G_TOLS[name], name
        assert _g_rel(name, a, c, e_scale) <= (1e-4 if name == "d_offs" else 1e-5), name


def test_dipole_window_kernel_takes_more_than_one_warp_of_home_atoms(device):
    """A cell capacity above 32 gives every offset two lane chunks."""
    pot, ins = _dipole_window_case(device, 0.9, capacity=40)
    assert ins[0].shape[-1] == 40
    e_k, g_k = rcd.dipole_window_value_and_grad(pot, 3.0, *ins)
    e_p, g_p = rcd._dw_value_and_grad(pot, 3.0, *ins)
    for name, a, b in zip(G_NAMES, (e_k, *g_k), (e_p, *g_p)):
        assert _rel(a, b) <= G_TOLS[name], name


def test_dipole_window_kernel_refuses_what_it_does_not_take(device):
    pot, ins = _dipole_window_case(device, 0.9)
    with pytest.raises(TypeError, match="float32"):
        rcd.dipole_window_value_and_grad(pot, 3.0, *[t.double() for t in ins])
    with pytest.raises(ValueError, match="contiguous"):
        rcd.dipole_window_value_and_grad(pot, 3.0, ins[0].transpose(0, 1), *ins[1:])
    with pytest.raises(ValueError, match="exclusion window"):
        rcd.dipole_window_value_and_grad(
            tpt.PotentialDipole(smearing=0.9, exclusion_radius=2.0), 3.0, *ins
        )
    e, _ = rcd._dw_value_and_grad(pot, 3.0, *[t.double() for t in ins])
    assert e.dtype == torch.float64 and e.device.type == "cuda"
    # a capacity whose one offset a pass exceeds shared memory: a clear error
    # that names the largest capacity it takes, with and without mui
    for split in (False, True):
        largest = torch.ops.tpme.window_dipole_plan(1, split, device.index)[1]
        assert 1024 < largest < 4000
        assert rcd._window_dipole_warps(largest, split, device.index) == 1
        big, mui = _dense_dipole_inputs(device, capacity=largest + 1, split=split)
        with pytest.raises(ValueError, match=f"at most {largest} "):
            rcd.dipole_window_value_and_grad(pot, 3.0, *big, mui)


def test_dipole_window_of_a_non_analytic_potential_raises_unless_plain(device):
    """No kernel for an exclusion window or a trainable parameter: the entry
    point raises on the card and runs plain autograd only with plain=True."""
    rng = np.random.default_rng(1)
    cell = np.eye(3) * 13.0
    pos, mu = rng.uniform(0, 13.0, (300, 3)), rng.normal(size=(300, 3))
    f32 = dict(dtype=torch.float32, device=device)
    clist = tpt.ops.compute_cell_list(pos, cell, 3.0, device=device)
    args = (torch.tensor(mu, **f32), torch.tensor(pos, **f32), torch.tensor(cell, **f32), clist)
    smearing = torch.tensor(0.9, **f32, requires_grad=True)
    for pot in (
        tpt.PotentialDipole(smearing=0.9, exclusion_radius=2.0),
        tpt.PotentialDipole(smearing=smearing),
    ):
        kernels.reset_launch_counts()
        with pytest.raises(ValueError, match="plain=True"):
            rcd.cell_list_rspace_dipole_energy(pot, *args)
        e = rcd.cell_list_rspace_dipole_energy(pot, *args, plain=True)
        assert torch.isfinite(e) and e.device.type == "cuda"
        assert kernels.launch_counts()["window_dipole"] == 0
    (g,) = torch.autograd.grad(e, smearing)
    assert torch.isfinite(g) and float(g) != 0.0


@pytest.fixture(scope="module")
def dipole_step(device):
    rng = np.random.default_rng(2)
    pos = np.concatenate([rng.uniform(0, 16.0, (400, 3)), 0.5 + 0.6 * rng.uniform(size=(30, 3))])
    mu, cell = rng.normal(size=(430, 3)), np.eye(3) * 16.0
    calc = tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=1.0), mesh_spacing=1.0)
    f32 = dict(dtype=torch.float32, device=device)
    fp = tpt.MDFastPathDipole.create(calc, torch.tensor(pos, **f32), torch.tensor(cell, **f32), 3.0)
    return fp, (pos, mu, cell), f32


def test_dipole_step_launches_its_kernels_and_matches_plain(dipole_step):
    """MDFastPathDipole.energy + autograd: kernel G once, D forward, E and F
    in the backward; `auto` took the tiled mesh on the card; spill atoms ride
    the plain side list.  ≡ the plain float32 step."""
    fp, (pos, mu, cell), f32 = dipole_step
    assert fp.tiled is not None and fp.clist.extra_index is not None
    assert fp.row_of_atom.device.type == "cuda"
    out = {}
    for plain in (False, True):
        rows = fp.bucket(torch.tensor(pos, **f32)).requires_grad_()
        m = torch.tensor(mu, **f32).requires_grad_()
        c = torch.tensor(cell, **f32).requires_grad_()
        kernels.reset_launch_counts()
        e = fp.energy(m, c, rows, plain=plain)
        grads = torch.autograd.grad(e, (rows, m, c))
        torch.cuda.synchronize()
        out[plain] = (e.detach(), *grads)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        want = {} if plain else {
            "window_dipole": 1, "mesh_spread": 1, "mesh_gather": 1, "mesh_wgrad": 1}
        assert counts == want, counts
    # the cell gradient carries d_offs, whose cancelling sum the plain version
    # takes in float32 (G_TOLS)
    for got, ref, tol in zip(out[False], out[True], (2e-5, 2e-5, 2e-5, 5e-4)):
        assert _rel(got, ref) <= tol


def test_dipole_step_refuses_float64_and_poisons_when_stale(dipole_step):
    fp, (pos, mu, cell), f32 = dipole_step
    f64 = dict(f32, dtype=torch.float64)
    args64 = (torch.tensor(mu, **f64), torch.tensor(cell, **f64))
    with pytest.raises(TypeError, match="float32"):
        fp.energy(*args64, fp.bucket(torch.tensor(pos, **f64)))
    assert np.isfinite(float(fp.energy(*args64, fp.bucket(torch.tensor(pos, **f64)), plain=True)))
    rows = fp.bucket(torch.tensor(pos, **f32))
    rows[int(fp.row_of_atom[0]), 0] += 8.0
    rows.requires_grad_()
    e = fp.energy(torch.tensor(mu, **f32), torch.tensor(cell, **f32), rows)
    (g,) = torch.autograd.grad(e, rows)
    assert torch.isnan(e) and torch.isnan(fp.unbucket(g)).all()


def test_dipole_calculator_call_on_the_card_matches_plain(device):
    """PMECalculatorDipole.forward + autograd through the dipole forms of
    kernels D, E, F ≡ the plain float32 path."""
    from torchpme_tpu_torch.utils.neighbors import neighbor_list

    rng = np.random.default_rng(4)
    pos, mu, cell = rng.uniform(0, 16.0, (400, 3)), rng.normal(size=(400, 3)), np.eye(3) * 16.0
    idx, _, shifts = neighbor_list(pos, cell, cutoff=3.0)
    f32 = dict(dtype=torch.float32, device=device)
    idx_t, shifts_t = torch.as_tensor(idx, device=device), torch.as_tensor(shifts, device=device)
    calc = tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=1.0), mesh_spacing=1.0)
    out = {}
    for plain in (False, True):
        p = torch.tensor(pos, **f32).requires_grad_()
        c = torch.tensor(cell, **f32).requires_grad_()
        m = torch.tensor(mu, **f32).requires_grad_()
        vec = p.index_select(0, idx_t[:, 1]) - p.index_select(0, idx_t[:, 0]) + shifts_t.float() @ c
        kernels.reset_launch_counts()
        pot = calc(m, c, p, idx_t, vec, plain=plain)
        g = torch.autograd.grad((pot * m).sum(), (p, m, c))
        torch.cuda.synchronize()
        out[plain] = (pot.detach(), *g)
        counts = kernels.launch_counts()
        launched = {k: counts[k] for k in ("mesh_spread", "mesh_gather", "mesh_wgrad")}
        if plain:
            assert not any(counts.values()), counts
        else:
            assert launched == {"mesh_spread": 2, "mesh_gather": 2, "mesh_wgrad": 2}, launched
    for got, ref in zip(out[False], out[True]):
        assert _rel(got, ref) <= 2e-5


# -- kernel D's dipole form ----------------------------------------------------

DIPOLE_MESH_CASES = [(nodes, 128) for nodes in (3, 4, 5, 6, 7)] + [(6, 288)]


def _dipole_tiled_case(device, nodes, nz, n=500, seed=0):
    """A float32 bucketing with weight derivatives on a (32, 32, nz) mesh,
    per-slot effective dipoles and a random mesh field."""
    rng = np.random.default_rng(seed)
    ns = (32, 32, nz)
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.tensor(rng.uniform(0, 10.0, (n, 3)), **f32)
    interp = mt.compute_tiled_interpolation(
        pos, torch.eye(3, **f32) / 10.0, ns, nodes, "Lagrange", derivatives=True
    )
    nu = mt._slot_values(interp, torch.tensor(rng.normal(size=(n, 3)), **f32))
    return interp, nu, torch.tensor(rng.normal(size=(1, *ns)), **f32)


@pytest.mark.parametrize("nodes,nz", DIPOLE_MESH_CASES)
def test_dipole_spread_matches_plain_forward_and_backward(device, nodes, nz):
    """Kernel D's dipole form against its plain version (the charge form
    over the tripled slots); and the spread and the gather of the dipolar
    mesh with their backwards (the dipole forms of E and F, and of D for the
    gather's mesh cotangent) against the plain versions' autograd."""
    interp, nu, field = _dipole_tiled_case(device, nodes, nz)
    it, ns = interp, interp.ns
    args = (it.local_x, it.local_y, it.start_z, it.weights, it.dweights, nu, ns, nodes)
    kernels.reset_launch_counts()
    got = mk.mesh_spread_dipole(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mesh_spread"] == 1
    assert got.shape == (1, *ns) and _rel(got, mk.mesh_spread_dipole_plain(*args)) <= 1e-5
    ct_mesh, ct_vals = torch.randn_like(field), torch.randn_like(nu)
    grads = {}
    for plain in (False, True):
        w = interp.weights.clone().requires_grad_()
        dw = interp.dweights.clone().requires_grad_()
        q = nu.clone().requires_grad_()
        f = field.clone().requires_grad_()
        leaf = replace(interp, weights=w, dweights=dw)
        kernels.reset_launch_counts()
        loss = (mk.spread_dipoles(leaf, q, plain=plain) * ct_mesh).sum() + (
            mk.gather_dipole_fields(leaf, f, plain=plain) * ct_vals
        ).sum()
        grads[plain] = torch.autograd.grad(loss, (w, dw, q, f))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = (0, 0, 0) if plain else (2, 2, 2)
        assert (counts["mesh_spread"], counts["mesh_gather"], counts["mesh_wgrad"]) == want
    for name, got, ref in zip(("weights", "dweights", "nu", "mesh"), grads[False], grads[True]):
        assert _rel(got, ref) <= 1e-5, name


@pytest.mark.parametrize("nodes,n_ch,nz", [(5, 1, 128), (4, 3, 128), (7, 1, 288)])
def test_mesh_spread_of_stale_slots_over_z_chunks(device, nodes, n_ch, nz):
    """Kernel D's charge form ≡ the plain version on a mesh whose z line
    takes several chunks, with half the slots stale (nodes off the window)."""
    interp, q_slots, _ = _tiled_case(device, nodes, n_ch, nz)
    lx = interp.local_x.clone()
    lx[interp.atom_of_slot < 250] = 9  # stale: nodes fall off the window
    a, ns = (lx, interp.local_y, interp.start_z, interp.weights), interp.ns
    got = mk.mesh_spread(*a, q_slots, ns, nodes)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, mk.mesh_spread_plain(*a, q_slots, ns, nodes)) <= 1e-5


# -- kernels E and F: both forms, staged windows --------------------------------

EF_FORMS = [("charges", 1), ("charges", 3), ("dipoles", 1)]


@pytest.mark.parametrize("nodes", [3, 4, 5, 6, 7])
@pytest.mark.parametrize("form,n_ch", EF_FORMS, ids=["charges", "charges3", "dipoles"])
def test_gather_wgrad_kernels_match_plain_and_reproduce(device, form, n_ch, nodes):
    """Kernels E and F, charge and dipole forms, alone and from one launch,
    ≡ their plain versions ≤ 1e-5 rel on a z line of 40 cells (a partial
    last z chunk), with a quarter of the occupied slots stale (x nodes off
    the window) and the empty slots giving zeros; two launches agree bit for
    bit."""
    interp, nu, _ = _dipole_tiled_case(device, nodes, 40)
    rng = np.random.default_rng(5)
    lx = interp.local_x.clone()
    occupied = interp.atom_of_slot < 500
    lx[occupied & (torch.arange(lx.shape[1], device=device) % 4 == 0)] = mt.TILE + 1
    ns = interp.ns
    f32 = dict(dtype=torch.float32, device=device)
    field = torch.tensor(rng.normal(size=(n_ch, *ns)), **f32)
    a = (lx, interp.local_y, interp.start_z, interp.weights)
    if form == "charges":
        q = mt._slot_values(interp, torch.tensor(rng.normal(size=(500, n_ch)), **f32))
        kern = (lambda: (mk.mesh_gather(*a, field, ns, nodes),),
                lambda: (mk.mesh_wgrad(*a, q, field, ns, nodes),),
                lambda: mk.mesh_gather_wgrad(*a, q, field, ns, nodes))
        plain = (mk.mesh_gather_plain(*a, field, ns, nodes),
                 mk.mesh_wgrad_plain(*a, q, field, ns, nodes))
    else:
        a = (*a, interp.dweights)
        kern = (lambda: (mk.mesh_gather_dipole(*a, field, ns, nodes),),
                lambda: mk.mesh_wgrad_dipole(*a, nu, field, ns, nodes),
                lambda: mk.mesh_gather_wgrad_dipole(*a, nu, field, ns, nodes))
        plain = mk.mesh_gather_wgrad_dipole_plain(*a, nu, field, ns, nodes)
    kernels.reset_launch_counts()
    gather, wgrad, both = (fn() for fn in kern)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["mesh_gather"], counts["mesh_wgrad"]) == (2, 2)
    for got, ref in zip((*gather, *wgrad), plain):
        assert got.shape == ref.shape and _rel(got, ref) <= 1e-5
    for got, ref in zip(both, (*gather, *wgrad)):
        assert torch.equal(got, ref)
    empty = interp.atom_of_slot == 500
    assert float(gather[0].transpose(1, 2)[empty].abs().max()) == 0.0
    assert all(float(g[empty].abs().max()) == 0.0 for g in wgrad)
    again = kern[2]()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(both, again))


def test_dipole_gather_wgrad_refuses_what_it_does_not_take(device):
    interp, nu, field = _dipole_tiled_case(device, 6, 128)
    a = (interp.local_x, interp.local_y, interp.start_z, interp.weights, interp.dweights)
    ns = interp.ns
    with pytest.raises(TypeError, match="float32"):
        mk.mesh_gather_dipole(*a, field.double(), ns, 6)
    with pytest.raises(TypeError, match="float32"):
        mk.mesh_wgrad_dipole(*a[:4], a[4].double(), nu, field, ns, 6)
    with pytest.raises(ValueError, match="shape"):
        mk.mesh_gather_dipole(*a, field.expand(2, *ns).contiguous(), ns, 6)
    with pytest.raises(ValueError, match="shape"):
        mk.mesh_wgrad_dipole(*a, nu[:, :2].contiguous(), field, ns, 6)


def test_dipolar_autograd_on_the_card_never_builds_tripled_slots(device, monkeypatch):
    """The card path of the dipolar spread and gather, forward and backward,
    and of the dipolar per-atom call with its gradients, runs the dipole
    forms of D, E and F: the tripled slots are never built."""
    def refuse(*args):
        raise AssertionError("the tripled slots were built on the card path")

    monkeypatch.setattr(mt, "_dipole_triple", refuse)
    monkeypatch.setattr(mk, "_dipole_triple", refuse)
    interp, nu, field = _dipole_tiled_case(device, 6, 128)
    w = interp.weights.clone().requires_grad_()
    dw = interp.dweights.clone().requires_grad_()
    q = nu.clone().requires_grad_()
    f = field.clone().requires_grad_()
    leaf = replace(interp, weights=w, dweights=dw)
    kernels.reset_launch_counts()
    loss = (mk.spread_dipoles(leaf, q) * field).sum() + (
        mk.gather_dipole_fields(leaf, f) * nu
    ).sum()
    grads = torch.autograd.grad(loss, (w, dw, q, f))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    counts = kernels.launch_counts()
    assert (counts["mesh_spread"], counts["mesh_gather"], counts["mesh_wgrad"]) == (2, 2, 2)

    from torchpme_tpu_torch.utils.neighbors import neighbor_list

    rng = np.random.default_rng(4)
    pos, mu, cell = rng.uniform(0, 16.0, (400, 3)), rng.normal(size=(400, 3)), np.eye(3) * 16.0
    idx = torch.as_tensor(neighbor_list(pos, cell, cutoff=3.0)[0], device=device)
    f32 = dict(dtype=torch.float32, device=device)
    p = torch.tensor(pos, **f32).requires_grad_()
    m = torch.tensor(mu, **f32).requires_grad_()
    calc = tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=1.0), mesh_spacing=1.0)
    vec = p.index_select(0, idx[:, 1]) - p.index_select(0, idx[:, 0])
    kernels.reset_launch_counts()
    pot = calc(m, torch.tensor(cell, **f32), p, idx, vec)
    grads = torch.autograd.grad((pot * m).sum(), (p, m))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    counts = kernels.launch_counts()
    launched = {k: counts[k] for k in ("mesh_spread", "mesh_gather", "mesh_wgrad")}
    assert launched == {"mesh_spread": 2, "mesh_gather": 2, "mesh_wgrad": 2}, launched


@pytest.mark.parametrize(
    "form,n_ch,nodes", [("charges", 1, 5), ("charges", 40, 7), ("dipoles", 1, 6)],
    ids=["charges", "charges40_7", "dipoles"],
)
def test_gather_wgrad_thread_per_slot_kernel_matches_plain(device, request, form, n_ch, nodes):
    """The kernel that reads each slot's window from the mesh in device
    memory, one thread a slot (z chunk 0, and where the staged block does not
    fit shared memory: 40 channels at 7 nodes), ≡ the plain versions."""
    interp, nu, _ = _dipole_tiled_case(device, nodes, 40)
    if n_ch == 1:
        _hold_z_chunk(request, "mesh_gather", 0)
    rng = np.random.default_rng(6)
    f32 = dict(dtype=torch.float32, device=device)
    ns = interp.ns
    field = torch.tensor(rng.normal(size=(n_ch, *ns)), **f32)
    a = (interp.local_x, interp.local_y, interp.start_z, interp.weights)
    if form == "charges":
        q = mt._slot_values(interp, torch.tensor(rng.normal(size=(500, n_ch)), **f32))
        got = mk.mesh_gather_wgrad(*a, q, field, ns, nodes)
        ref = (mk.mesh_gather_plain(*a, field, ns, nodes),
               mk.mesh_wgrad_plain(*a, q, field, ns, nodes))
    else:
        a = (*a, interp.dweights)
        got = mk.mesh_gather_wgrad_dipole(*a, nu, field, ns, nodes)
        ref = mk.mesh_gather_wgrad_dipole_plain(*a, nu, field, ns, nodes)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-5


@pytest.mark.parametrize("nz,offset", [(30, 0), (18, 0), (40, 1)],
                         ids=["nz30", "nz18", "misaligned_mesh"])
def test_gather_wgrad_kernels_stage_any_z_line(device, nz, offset):
    """The staged kernels copy 4 bytes a lane where 16 do not fit: a z line
    that is not a multiple of 4 (30, and 18, under one chunk) and a mesh
    whose storage starts off a 16-byte boundary; both forms ≡ the plain
    versions, with the charge form at 3 channels."""
    for form, n_ch, nodes in (("charges", 3, 4), ("dipoles", 1, 7)):
        interp, nu, _ = _dipole_tiled_case(device, nodes, nz)
        rng = np.random.default_rng(7)
        ns = interp.ns
        buf = torch.empty(n_ch * int(np.prod(ns)) + offset, dtype=torch.float32, device=device)
        field = buf[offset:].view(n_ch, *ns)
        field.copy_(torch.tensor(rng.normal(size=(n_ch, *ns)), dtype=torch.float32))
        a = (interp.local_x, interp.local_y, interp.start_z, interp.weights)
        if form == "charges":
            q = torch.tensor(rng.normal(size=(500, n_ch)), dtype=torch.float32, device=device)
            q = mt._slot_values(interp, q)
            got = mk.mesh_gather_wgrad(*a, q, field, ns, nodes)
            ref = (mk.mesh_gather_plain(*a, field, ns, nodes),
                   mk.mesh_wgrad_plain(*a, q, field, ns, nodes))
        else:
            a = (*a, interp.dweights)
            got = mk.mesh_gather_wgrad_dipole(*a, nu, field, ns, nodes)
            ref = mk.mesh_gather_wgrad_dipole_plain(*a, nu, field, ns, nodes)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert _rel(g, r) <= 1e-5, (form, nz, offset)


# -- kernel B (and A at lpad = 0): both layouts -----------------------------------


def _spread_slots(device, layout, nodes, n_ch, nz, nxy=32, seed=0, capacity=None,
                  method="Lagrange"):
    """float32 slots of kernels A and B on a (nxy, nxy, nz) mesh at about
    0.08 atoms per Å³: the aligned MD state's rows (layout "aligned", cell
    capacity ``capacity``) or a stencil-start bucketing (layout "fused"),
    with empty slots, and with a few occupied slots moved far from their
    tile and z cell (stale); ``method`` picks the weight tables."""
    rng = np.random.default_rng(seed)
    cell = np.diag([nxy / 2.0, nxy / 2.0, nz / 2.0])
    n = int(0.08 * np.prod(np.diag(cell)))
    pos = rng.uniform(0, 1, (n, 3)) @ cell
    f32 = dict(dtype=torch.float32, device=device)
    q_atoms = torch.tensor(rng.normal(size=(n, n_ch)), **f32)
    ns = (nxy, nxy, nz)
    if layout == "aligned":
        cls = tpt.P3MCalculator if method == "P3M" else tpt.PMECalculator
        calc = cls(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=nodes)
        fp = tpt.MDFastPath.create(calc, torch.tensor(pos, **f32), torch.tensor(cell, **f32), 3.0,
                                   ns, mesh_impl="aligned", cell_capacity=capacity)
        nx_c, ny_c, nz_c, cap = fp.cell_grid
        extent, lpad = sf.aligned_geometry(nodes, fp.aligned_pad)
        geom = sf.SpreadGeometry(ns, nodes, method, extent, lpad, nx_c * ny_c, nz_c * cap,
                                 nz_c)
        nb = geom.n_tiles * geom.slots_per_tile
        rows = fp.bucket(torch.tensor(pos, **f32))
        rel = (rows @ torch.linalg.inv(torch.tensor(cell, **f32)) * torch.tensor(ns, **f32))[:nb]
        q = torch.zeros((fp.n_rows, n_ch), **f32).index_copy(0, fp.row_of_atom.long(), q_atoms)
        rel, q = rel.contiguous(), q[:nb].contiguous()
    else:
        p = torch.tensor(pos, **f32)
        inv = torch.linalg.inv(torch.tensor(cell, **f32))
        interp = mt.compute_tiled_interpolation(p, inv, ns, nodes, method)
        rel, q, geom = sf._fused_slots(interp, p, inv, q_atoms, method)
    occupied = torch.nonzero((q != 0).any(dim=1))[:, 0]
    assert occupied.numel() < q.shape[0]  # empty slots too
    stale = occupied[:: max(1, occupied.numel() // 5)][:5]
    rel[stale] += torch.tensor([0.4 * nxy, 0.0, 0.45 * nz], **f32)
    return rel, q, geom


B_CASES = [(nodes, n_ch, nz) for nodes in (3, 4, 5, 6, 7) for n_ch, nz in ((1, 40), (3, 288))]


@pytest.mark.parametrize("layout", ["aligned", "fused"])
@pytest.mark.parametrize("nodes,n_ch,nz", B_CASES)
def test_spread_bwd_kernel_matches_plain_and_reproduces(device, layout, nodes, n_ch, nz):
    """Kernel B's staged blocks ≡ its plain version, stale and empty slots
    included (every slot has one owner whatever its position), and two
    launches are bitwise equal; nz = 40 leaves a partial last chunk."""
    rel, q, geom = _spread_slots(device, layout, nodes, n_ch, nz)
    assert (geom.lpad == 0) == (layout == "fused")
    ct = torch.randn((n_ch, *geom.ns), device=device)
    kernels.reset_launch_counts()
    got = sf.fused_spread_bwd(rel, q, ct, geom)
    again = sf.fused_spread_bwd(rel, q, ct, geom)
    ref = sf.spread_plain_bwd(rel, q, ct, geom)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["spread_bwd"] == 2
    for g, a, r in zip(got, again, ref):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, r) <= 1e-5, (layout, nodes, n_ch, nz)
        assert torch.equal(g, a)


@pytest.mark.parametrize("n_ch,nodes", [(1, 5), (40, 7)], ids=["z_chunk_0", "channels40_7"])
@pytest.mark.parametrize("layout", ["aligned", "fused"])
def test_spread_bwd_thread_per_slot_kernel_matches_plain(device, request, layout, n_ch, nodes):
    """Kernel B as one thread a slot reading the mesh in device memory: at
    z chunk 0, and where the staged block does not fit shared memory (40
    channels at 7 nodes) ≡ the plain version."""
    rel, q, geom = _spread_slots(device, layout, nodes, n_ch, 40)
    if n_ch == 1:
        _hold_z_chunk(request, "spread_bwd", 0)
    ct = torch.randn((n_ch, *geom.ns), device=device)
    got = sf.fused_spread_bwd(rel, q, ct, geom)
    ref = sf.spread_plain_bwd(rel, q, ct, geom)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-5


@pytest.mark.parametrize(
    "layout,nz,capacity,offset",
    [("aligned", 30, 9, 0), ("fused", 18, None, 0), ("fused", 40, None, 1)],
    ids=["nz30_odd_slot_rows", "nz18", "misaligned_cotangent"],
)
def test_spread_bwd_kernel_stages_any_z_line_and_slot_rows(device, layout, nz, capacity, offset):
    """Kernel B copies 4 bytes a lane where 16 do not fit: a z line that is
    not a multiple of 4 (30 and 18, under one chunk), a tile's slot rows of
    an odd length (45 slots: 5 z cells of capacity 9), and a mesh
    cotangent whose storage starts off a 16-byte boundary; ≡ the plain
    version at 2 channels."""
    rel, q, geom = _spread_slots(device, layout, 5, 2, nz, capacity=capacity)
    if capacity is not None:
        assert geom.slots_per_tile % 4
    buf = torch.empty(2 * int(np.prod(geom.ns)) + offset, dtype=torch.float32, device=device)
    ct = buf[offset:].view(2, *geom.ns)
    ct.copy_(torch.randn((2, *geom.ns), device=device))
    got = sf.fused_spread_bwd(rel, q, ct, geom)
    ref = sf.spread_plain_bwd(rel, q, ct, geom)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-5, (layout, nz, offset)


@pytest.mark.parametrize("nxy", [32, 16])
@pytest.mark.parametrize("nodes", [3, 4, 5, 6, 7])
def test_spread_fwd_kernel_at_the_fused_geometry(device, nodes, nxy):
    """Kernel A at lpad = 0 (the blocks read the 2 × 2 tiles at and before
    their own) ≡ its plain version, stale and empty slots included, on 4 × 4
    and 2 × 2 tile grids."""
    rel, q, geom = _spread_slots(device, "fused", nodes, 2, 40, nxy=nxy)
    got = sf.fused_spread(rel, q, geom)
    ref = sf.spread_plain(rel, q, geom)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-6


def test_fused_step_launches_a_b_c_and_matches_plain(device):
    """MDFastPath(mesh_impl="fused") on the card: kernels A, B and C once a
    step (no D, E, F), ≡ the plain float32 step; `auto` picks it where the
    aligned mode cannot run; float64 state is refused (it takes the tiled
    step, whose kernels are float32 only)."""
    pos, q, cell = _clustered_box()
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=5)
    f32 = dict(dtype=torch.float32, device=device)
    pos32, q32, cell32 = (torch.tensor(a, **f32) for a in (pos, q, cell))
    fp = tpt.MDFastPath.create(calc, pos32, cell32, 3.0, NS, mesh_impl="fused")
    assert fp.mesh_impl == "fused" and fp.calc.mesh_backend == "fused"
    # `auto` takes it on the card where the aligned mode cannot run (tile edge 2 Å < cutoff)
    assert tpt.MDFastPath.create(calc, pos32, cell32, 3.0, (64, 64, 32)).mesh_impl == "fused"
    out = {}
    for plain in (False, True):
        rows = fp.bucket(pos32).requires_grad_()
        c = cell32.clone().requires_grad_()
        kernels.reset_launch_counts()
        e = fp.energy(q32, c, rows, plain=plain)
        g_rows, g_cell = torch.autograd.grad(e, (rows, c))
        torch.cuda.synchronize()
        out[plain] = (float(e.detach()), g_rows, g_cell, kernels.launch_counts())
    counts = out[False][3]
    assert (counts["spread_fwd"], counts["spread_bwd"], counts["window"]) == (1, 1, 1), counts
    assert counts["mesh_spread"] == counts["mesh_gather"] == counts["mesh_wgrad"] == 0, counts
    assert all(n == 0 for n in out[True][3].values()), out[True][3]
    assert abs(out[False][0] - out[True][0]) <= 1e-5 * abs(out[True][0])
    assert _rel(out[False][1], out[True][1]) <= 1e-5
    assert _rel(out[False][2], out[True][2]) <= 1e-4
    with pytest.raises(TypeError, match="float32"):
        fp.energy(q32.double(), cell32.double(), fp.bucket(pos32.double()))
    assert np.isfinite(float(fp.energy(q32.double(), cell32.double(), fp.bucket(pos32.double()),
                                       plain=True)))


# -- P3M: kernels D, E, F at 1 and 2 nodes, A and B with the P3M tables ---------


def _p3m_tiled_case(device, nodes, n_ch, nz=40, n=500, seed=0):
    """A float32 P3M bucketing on a (32, 32, nz) mesh with a quarter of the
    occupied slots stale (x nodes off the window), per-slot charges and a
    random mesh field."""
    rng = np.random.default_rng(seed)
    ns = (32, 32, nz)
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.tensor(rng.uniform(0, 10.0, (n, 3)), **f32)
    interp = mt.compute_tiled_interpolation(pos, torch.eye(3, **f32) / 10.0, ns, nodes, "P3M")
    lx = interp.local_x.clone()
    occupied = interp.atom_of_slot < n
    lx[occupied & (torch.arange(lx.shape[1], device=device) % 4 == 0)] = mt.TILE + 1
    q = mt._slot_values(interp, torch.tensor(rng.normal(size=(n, n_ch)), **f32))
    field = torch.tensor(rng.normal(size=(n_ch, *ns)), **f32)
    return (lx, interp.local_y, interp.start_z, interp.weights), q, field, ns


@pytest.mark.parametrize("n_ch", [1, 3])
@pytest.mark.parametrize("nodes", [1, 2, 5])
def test_p3m_mesh_kernels_match_plain_and_reproduce(device, nodes, n_ch):
    """Kernels D, E, F and E + F at P3M's 1 and 2 nodes (extent 8 and 9) and
    at 5, with the P3M tables, stale and empty slots: within 1e-6 of the
    plain versions; E and F bitwise equal over two launches and to E + F."""
    a, q, field, ns = _p3m_tiled_case(device, nodes, n_ch)
    kernels.reset_launch_counts()
    rho = mk.mesh_spread(*a, q, ns, nodes)
    vals, wg = mk.mesh_gather_wgrad(*a, q, field, ns, nodes)
    vals2, wg2 = mk.mesh_gather_wgrad(*a, q, field, ns, nodes)
    gather, wgrad = mk.mesh_gather(*a, field, ns, nodes), mk.mesh_wgrad(*a, q, field, ns, nodes)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["mesh_spread"], counts["mesh_gather"], counts["mesh_wgrad"]) == (1, 3, 3)
    assert _rel(rho, mk.mesh_spread_plain(*a, q, ns, nodes)) <= 1e-6
    assert _rel(vals, mk.mesh_gather_plain(*a, field, ns, nodes)) <= 1e-6
    assert _rel(wg, mk.mesh_wgrad_plain(*a, q, field, ns, nodes)) <= 1e-6
    assert torch.equal(vals, vals2) and torch.equal(wg, wg2)
    assert torch.equal(vals, gather) and torch.equal(wg, wgrad)


@pytest.mark.parametrize("nodes", [1, 2])
def test_p3m_gather_wgrad_thread_per_slot_kernel_matches_plain(device, request, nodes):
    """E and F as one thread a slot reading the mesh (z chunk 0) at 1 and 2
    nodes ≡ the plain versions."""
    a, q, field, ns = _p3m_tiled_case(device, nodes, 2)
    _hold_z_chunk(request, "mesh_gather", 0)
    got = mk.mesh_gather_wgrad(*a, q, field, ns, nodes)
    ref = (mk.mesh_gather_plain(*a, field, ns, nodes), mk.mesh_wgrad_plain(*a, q, field, ns, nodes))
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-6


@pytest.mark.parametrize("nodes", [1, 2, 8])
def test_mesh_kernels_refuse_nodes_they_are_not_built_for(device, nodes):
    """The charge forms take 1 to 7 nodes; the dipole forms 3 to 7 (the
    dipolar mesh is Lagrange-only): a clear ValueError outside."""
    if nodes == 8:
        a, q, field, ns = _p3m_tiled_case(device, 5, 1)
        a = (*a[:3], torch.zeros((*a[3].shape[:3], 8), dtype=torch.float32, device=device))
        with pytest.raises(ValueError, match="built for 1 to 7 nodes"):
            mk.mesh_spread(*a, q, ns, 8)
        return
    a, q, field, ns = _p3m_tiled_case(device, nodes, 1)
    nu = q.expand(-1, 3, -1).contiguous()
    dw = a[3].clone()
    for call in (lambda: mk.mesh_spread_dipole(*a, dw, nu, ns, nodes),
                 lambda: mk.mesh_gather_dipole(*a, dw, field, ns, nodes),
                 lambda: mk.mesh_wgrad_dipole(*a, dw, nu, field, ns, nodes),
                 lambda: mk.mesh_gather_wgrad_dipole(*a, dw, nu, field, ns, nodes)):
        with pytest.raises(ValueError, match="dipole forms of the mesh kernels are built for 3 to 7"):
            call()


@pytest.mark.parametrize("layout", ["aligned", "fused"])
@pytest.mark.parametrize("nodes", [1, 2, 3, 5])
def test_spread_kernels_with_p3m_tables_match_plain(device, layout, nodes):
    """Kernels A and B with the P3M weight tables, both layouts, stale and
    empty slots: ≡ the plain versions; B bitwise equal over two launches."""
    rel, q, geom = _spread_slots(device, layout, nodes, 1, 40, method="P3M")
    assert geom.method == "P3M"
    assert _rel(sf.fused_spread(rel, q, geom), sf.spread_plain(rel, q, geom)) <= 1e-6
    ct = torch.randn((1, *geom.ns), device=device)
    got = sf.fused_spread_bwd(rel, q, ct, geom)
    again = sf.fused_spread_bwd(rel, q, ct, geom)
    ref = sf.spread_plain_bwd(rel, q, ct, geom)
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, ref):
        # one node: constant weights, so ct_rel is exactly 0 on both sides
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        assert err <= 1e-5 * scale or err == scale == 0.0
        assert torch.equal(g, a)


@pytest.mark.parametrize("shape", ["clustered", "grid3_cap_gt_32", "grid3_cap250_ch4"])
def test_window_kernel_unsmeared_variant_matches_plain_and_reproduces(step, shape):
    """Kernel C's unsmeared pair (direct mode: V = 1/d, V'/d = -1/d^3)
    against its plain version; d_pc and d_q bitwise equal over two
    launches, d_offs against float64."""
    if shape == "clustered":
        fp, pos, q, cell = step
        n_cells, cap = fp.clist.slot_mask.shape
        rows = fp.bucket(pos)[: n_cells * cap].reshape(n_cells, cap, 3)
        ins = rc._prepare_bucketed(q[fp.clist.atom_index.long()], rows, cell, fp.clist)[:4]
    else:
        capacity, n_ch, _ = EDGE_WINDOWS[shape]
        ins = _dense_window_inputs(step[1].device, capacity, n_ch)
    pot = tpt.CoulombPotential()
    kernels.reset_launch_counts()
    e_a, g_a = rc.window_value_and_grad(pot, 3.0, *ins)
    e_b, g_b = rc.window_value_and_grad(pot, 3.0, *ins)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["window"] == 2
    assert torch.equal(g_a[0], g_b[0]) and torch.equal(g_a[1], g_b[1])
    e_p, g_p = rc._we_value_and_grad(pot, 3.0, *ins)
    e64, g64 = rc._we_value_and_grad(pot, 3.0, *[t.double() for t in ins])
    assert abs(float(e_a) - float(e_p)) <= 1e-6 * abs(float(e_p))
    assert abs(float(e_a) - float(e64)) <= 1e-5 * abs(float(e64))
    assert _rel(g_a[0], g_p[0]) <= 1e-5 and _rel(g_a[1], g_p[1]) <= 1e-5
    assert _rel(g_a[2], g64[2]) <= 1e-5 and _rel(g_a[3], g64[3]) <= 1e-5
    # the smeared variant gives another energy on the same inputs
    e_s, _ = rc.window_value_and_grad(tpt.CoulombPotential(smearing=1.0), 3.0, *ins)
    assert abs(float(e_s) - float(e_a)) > 1e-3 * abs(float(e_a))


def test_direct_energy_over_a_cell_list_launches_the_window(device):
    """``Calculator(CoulombPotential()).energy(cell_list=)`` on the card runs
    kernel C's unsmeared variant (one launch) ≡ its plain float32 path and
    the float64 plain path."""
    pos, q, cell = _clustered_box()
    f32 = dict(dtype=torch.float32, device=device)
    p, qq, c = (torch.tensor(a, **f32) for a in (pos, q, cell))
    clist = tpt.ops.compute_cell_list(p, c, 3.0)
    calc = tpt.Calculator(tpt.CoulombPotential())
    out = {}
    for plain in (False, True):
        rows = p.clone().requires_grad_()
        kernels.reset_launch_counts()
        e = calc.energy(qq, c, rows, cell_list=clist, plain=plain)
        (g,) = torch.autograd.grad(e, rows)
        torch.cuda.synchronize()
        out[plain] = (float(e.detach()), g, kernels.launch_counts()["window"])
    assert out[False][2] == 1 and out[True][2] == 0
    e64 = float(calc.energy(qq.double(), c.double(), p.double(), cell_list=clist, plain=True))
    assert abs(out[False][0] - out[True][0]) <= 1e-5 * abs(out[True][0])
    assert abs(out[False][0] - e64) <= 1e-5 * abs(e64)
    assert _rel(out[False][1], out[True][1]) <= 1e-5


def test_p3m_step_and_call_launch_their_kernels_and_match_plain(device):
    """MDFastPath with P3MCalculator in aligned mode launches A, B, C once a
    step; the per-atom P3M call at 2 nodes launches D, E, F; both ≡ their
    plain paths."""
    pos, q, cell = _clustered_box()
    f32 = dict(dtype=torch.float32, device=device)
    p, qq, c = (torch.tensor(a, **f32) for a in (pos, q, cell))
    calc = tpt.P3MCalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=5)
    fp = tpt.MDFastPath.create(calc, p, c, 3.0, NS)
    assert fp.mesh_impl == "aligned"
    out = {}
    for plain in (False, True):
        rows = fp.bucket(p).requires_grad_()
        kernels.reset_launch_counts()
        e = fp.energy(qq, c, rows, plain=plain)
        (g,) = torch.autograd.grad(e, rows)
        torch.cuda.synchronize()
        out[plain] = (float(e.detach()), g, kernels.launch_counts())
    counts = out[False][2]
    assert (counts["spread_fwd"], counts["spread_bwd"], counts["window"]) == (1, 1, 1), counts
    assert abs(out[False][0] - out[True][0]) <= 1e-5 * abs(out[True][0])
    assert _rel(out[False][1], out[True][1]) <= 1e-5

    from torchpme_tpu_torch.utils.neighbors import compute_distances, neighbor_list

    idx, _, shifts = (torch.as_tensor(x, device=device) for x in neighbor_list(pos, cell, 3.0))
    call = tpt.P3MCalculator(tpt.CoulombPotential(smearing=1.0), interpolation_nodes=2,
                             mesh_spacing=0.5, mesh_backend="tiled")
    res = {}
    for plain in (False, True):
        pp = p.clone().requires_grad_()
        kernels.reset_launch_counts()
        pot = call(qq, c, pp, idx, compute_distances(pp, idx, c, shifts), plain=plain)
        (g,) = torch.autograd.grad(torch.sum(pot * qq), pp)
        torch.cuda.synchronize()
        res[plain] = (pot.detach(), g, kernels.launch_counts())
    counts = res[False][2]
    assert min(counts["mesh_spread"], counts["mesh_gather"], counts["mesh_wgrad"]) >= 1, counts
    assert _rel(res[False][0], res[True][0]) <= 1e-5 and _rel(res[False][1], res[True][1]) <= 1e-5


@pytest.mark.parametrize(
    "name", ["KSpaceFilter", "P3MKSpaceFilter", "MeshInterpolator", "compute_batched_kvectors"]
)
def test_power_user_state_from_a_host_cell_lands_on_the_card(device, name):
    """A host cell and no device: the filters, the interpolator and the
    batched k-vectors build their state on the card, and a host cell given
    to ``update`` follows it there."""

    class Unit:
        def kernel_from_k_sq(self, k_sq):
            return torch.ones_like(k_sq)

    cell = np.eye(3) * 4.0
    made = {
        "KSpaceFilter": lambda: tpt.ops.KSpaceFilter(cell, (4, 4, 4), Unit()),
        "P3MKSpaceFilter": lambda: tpt.ops.P3MKSpaceFilter(cell, (4, 4, 4), 3, Unit()),
        "MeshInterpolator": lambda: tpt.ops.MeshInterpolator(cell, (4, 4, 4), 3, "P3M"),
        "compute_batched_kvectors": lambda: tpt.ops.compute_batched_kvectors(1.3, cell[None]),
    }[name]()
    if isinstance(made, torch.Tensor):
        assert made.device.type == "cuda"
        return
    assert made.cell.device.type == "cuda"
    made.update(cell * 1.1)
    assert made.cell.device.type == "cuda"
    if name == "MeshInterpolator":
        made.compute_weights(torch.tensor([[0.3, 1.7, 2.2]], dtype=torch.float64, device=device))
        rho = made.points_to_mesh(torch.ones((1, 1), dtype=torch.float64, device=device))
    else:
        rho = made(torch.ones((1, 4, 4, 4), dtype=torch.float64, device=device))
    assert rho.device.type == "cuda"


# -- kernel C's pair-term table: 1/r^p, Combined, direct 1/r^p -----------------------


def _family_window_pot(name):
    if name.startswith("ipl"):
        p = int(name[3])
        smearing = None if name.endswith("direct") else 1.0
        return tpt.InversePowerLawPotential(exponent=p, smearing=smearing, prefactor=0.7)
    if name == "combined":
        return tpt.CombinedPotential(
            [tpt.CoulombPotential(smearing=1.0), tpt.InversePowerLawPotential(exponent=6, smearing=0.9)],
            initial_weights=torch.tensor([0.8, -0.35]), smearing=1.0)
    if name == "combined4":
        return tpt.CombinedPotential(
            [tpt.InversePowerLawPotential(exponent=p, smearing=1.0) for p in (1, 3, 4, 5)],
            initial_weights=torch.tensor([1.0, 0.5, -0.25, 0.125]), smearing=1.0)
    if name == "combined_direct":
        return tpt.CombinedPotential(
            [tpt.InversePowerLawPotential(exponent=1), tpt.InversePowerLawPotential(exponent=4)],
            initial_weights=torch.tensor([0.7, -0.4]))
    raise KeyError(name)


FAMILY_WINDOWS = [f"ipl{p}" for p in range(1, 7)] + ["ipl6_direct", "ipl3_direct", "combined",
                                                     "combined4", "combined_direct"]


@pytest.mark.parametrize("shape", ["clustered", "grid3_cap_gt_32", "grid3_cap250_ch4"])
@pytest.mark.parametrize("name", FAMILY_WINDOWS)
def test_window_kernel_family_matches_plain_and_reproduces(step, name, shape):
    """Each pair-term variant of kernel C against its float32 plain version
    (energy 1e-6, d_pc and d_q 1e-5 of max), d_offs and the image term
    against float64 (1e-5), d_pc and d_q bitwise equal over two launches;
    for a Combined potential
    the per-member energies (dE/dw) against the plain version's float64
    sums, and Σ w_k E_k = E."""
    if shape == "clustered":
        fp, pos, q, cell = step
        n_cells, cap = fp.clist.slot_mask.shape
        rows = fp.bucket(pos)[: n_cells * cap].reshape(n_cells, cap, 3)
        ins = rc._prepare_bucketed(q[fp.clist.atom_index.long()], rows, cell, fp.clist)[:4]
    else:
        capacity, n_ch, _ = EDGE_WINDOWS[shape]
        ins = _dense_window_inputs(step[1].device, capacity, n_ch)
    pot = _family_window_pot(name)
    kernels.reset_launch_counts()
    e_a, g_a, w_a = rc.window_value_and_grad(pot, 3.0, *ins, with_params=True)
    e_b, g_b, w_b = rc.window_value_and_grad(pot, 3.0, *ins, with_params=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["window"] == 2
    assert torch.equal(g_a[0], g_b[0]) and torch.equal(g_a[1], g_b[1])
    e_p, g_p, w_p = rc._we_value_and_grad(pot, 3.0, *ins, with_params=True)
    _, g64 = rc._we_value_and_grad(pot, 3.0, *[t.double() for t in ins])
    assert abs(float(e_a) - float(e_p)) <= 1e-6 * abs(float(e_p))
    assert _rel(g_a[0], g_p[0]) <= 1e-5 and _rel(g_a[1], g_p[1]) <= 1e-5
    assert _rel(g_a[2], g64[2]) <= 1e-5 and _rel(g_a[3], g64[3]) <= 1e-5
    assert len(w_a) == len(w_p) == (1 if name.startswith("combined") else 0)
    if w_a:
        (d_w,), (d_w_p,) = w_a, w_p
        assert d_w.dtype == pot.weights.dtype and _rel(d_w, d_w_p) <= 1e-6
        total = float(torch.dot(pot.weights.detach().to(d_w), d_w))
        assert abs(total - float(e_a)) <= 1e-6 * abs(float(e_a))


def test_window_kernel_refuses_what_it_cannot_evaluate(step):
    """No kernel for a spline, an exclusion window or a member outside the
    table: a TypeError that names plain=True, on the kernel and on the MD
    step (which never falls back to the plain version by itself)."""
    fp, pos, q, cell = step
    ins = _dense_window_inputs(pos.device)
    r = torch.linspace(0.2, 10.0, 200, dtype=torch.float64)
    spline = tpt.SplinePotential(r, torch.exp(-r) / r, smearing=1.0)
    refused = [
        spline,
        tpt.CoulombPotential(smearing=1.0, exclusion_radius=1.5),
        tpt.CombinedPotential([tpt.CoulombPotential(smearing=1.0), spline], smearing=1.0),
        tpt.CombinedPotential([tpt.InversePowerLawPotential(exponent=p, smearing=1.0)
                               for p in range(1, 6)], smearing=1.0),
    ]
    for pot in refused:
        with pytest.raises(TypeError, match="plain=True"):
            rc.window_value_and_grad(pot, 3.0, *ins)
    calc = tpt.PMECalculator(spline, interpolation_nodes=5)
    md = tpt.MDFastPath.create(calc, pos, cell, 3.0, NS)
    with pytest.raises(TypeError, match="plain=True"):
        md.energy(q, cell, md.bucket(pos))
    assert np.isfinite(float(md.energy(q, cell, md.bucket(pos), plain=True)))


def test_family_md_step_launches_and_matches_plain(step):
    """A Combined (Coulomb + 1/r^6, learnable weights on the card) MD step:
    kernels A, B, C launch once each; energy, forces, cell gradient and
    dE/dw match the plain float32 step, and the cell gradient the float64
    step (1e-4); the kernel reads the weights where they lie, so an update
    in place on the card moves the energy."""
    _, pos, q, cell = step
    pot = _family_window_pot("combined").to(pos.device)
    calc = tpt.PMECalculator(pot, interpolation_nodes=5)
    fp = tpt.MDFastPath.create(calc, pos, cell, 3.0, NS)
    out = {}
    for dtype, plain in ((torch.float32, False), (torch.float32, True), (torch.float64, True)):
        rows = fp.bucket(pos).to(dtype).requires_grad_()
        cell_g = cell.to(dtype).requires_grad_()
        kernels.reset_launch_counts()
        e = fp.energy(q.to(dtype), cell_g, rows, plain=plain)
        grads = torch.autograd.grad(e, (rows, cell_g, pot.weights))
        torch.cuda.synchronize()
        out[dtype, plain] = (float(e.detach()), *grads, kernels.launch_counts())
    kern, ref, ref64 = out[torch.float32, False], out[torch.float32, True], out[torch.float64, True]
    assert all(kern[4][k] == 1 for k in ("spread_fwd", "spread_bwd", "window"))
    assert abs(kern[0] - ref[0]) <= 1e-5 * abs(ref[0])
    for a, b in zip(kern[1:4], ref[1:4]):
        assert _rel(a, b) <= 1e-5
    assert _rel(kern[2], ref64[2]) <= 1e-4
    with torch.no_grad():
        pot.weights.mul_(2.0)
    e2 = float(fp.energy(q, cell, fp.bucket(pos)).detach())
    assert abs(e2 - 2 * kern[0]) <= 1e-5 * abs(kern[0])  # E is linear in the weights


def test_extras_table_step_launches_d_e_f(device):
    """The aligned step with the extras tile table spreads the spill rows by
    kernel D (E + F backward) and agrees with the scatter route."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 4.0, (48, 3))
    pos[:14] = rng.uniform(0.1, 0.9, (14, 3))
    q = rng.normal(size=(48, 1))
    q -= q.mean()
    f32 = dict(dtype=torch.float32, device=device)
    pos32, q32, cell32 = (torch.tensor(a, **f32) for a in (pos, q, np.eye(3) * 4.0))
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=0.35), interpolation_nodes=4)
    energies = {}
    for impl in ("tiled", "scatter"):
        fp = tpt.MDFastPath.create(calc, pos32, cell32, 0.9, (16, 16, 16), mesh_impl="aligned",
                                   cell_capacity=8, extras_impl=impl, balance=False, _spill=True)
        rows = fp.bucket(pos32).requires_grad_()
        kernels.reset_launch_counts()
        e = fp.energy(q32, cell32, rows)
        torch.autograd.grad(e, rows)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert (counts["mesh_spread"] >= 1) == (impl == "tiled"), counts
        energies[impl] = float(e.detach())
    assert abs(energies["tiled"] - energies["scatter"]) <= 1e-6 * abs(energies["scatter"])


# -- kernels D, E, F over a batch of systems in one launch ----------------------


def _batched_case(device, nodes, n_ch, n_sys, dipole=False, nz=64, seed=10):
    """Bucketings of ``n_sys`` random systems on one (32, 32, nz) mesh at one
    capacity, stacked on a leading axis, with per-slot values (charges, or
    effective dipoles) and mesh fields."""
    rng = np.random.default_rng(seed)
    ns = (32, 32, nz)
    f32 = dict(dtype=torch.float32, device=device)
    its, vals = [], []
    for _ in range(n_sys):
        pos = torch.tensor(rng.uniform(0, 10.0, (400, 3)), **f32)
        it = mt.compute_tiled_interpolation(pos, torch.eye(3, **f32) / 10.0, ns, nodes,
                                            "Lagrange" if nodes >= 3 else "P3M",
                                            capacity=128, derivatives=dipole)
        its.append(it)
        vals.append(mt._slot_values(it, torch.tensor(rng.normal(size=(400, 3 if dipole else n_ch)), **f32)))
    names = ("local_x", "local_y", "start_z", "weights", *(("dweights",) if dipole else ()))
    arrays = tuple(torch.stack([getattr(it, n) for it in its]) for n in names)
    field = torch.tensor(rng.normal(size=(n_sys, 1 if dipole else n_ch, *ns)), **f32)
    return arrays, torch.stack(vals), field, ns


BATCH_FORMS = [("charges", 1, n) for n in (1, 2, 3, 5, 7)] + [("charges", 3, 4)] + [
    ("dipoles", 1, n) for n in (3, 6, 7)]


@pytest.mark.parametrize("form,n_ch,nodes", BATCH_FORMS)
def test_batched_launch_equals_one_launch_per_system(device, form, n_ch, nodes):
    """One launch over a batch of 4 systems ≡ 4 launches of one system: E
    and F bitwise (each slot has one owner, the same sums in the same
    order), D within float32 rounding (its global atomics add in another
    order on each launch); each batched call counts one launch a kernel."""
    dipole = form == "dipoles"
    arrays, vals, field, ns = _batched_case(device, nodes, n_ch, 4, dipole)
    ops = ((mk.mesh_spread_dipole, mk.mesh_gather_wgrad_dipole) if dipole
           else (mk.mesh_spread, mk.mesh_gather_wgrad))
    kernels.reset_launch_counts()
    mesh = ops[0](*arrays, vals, ns, nodes)
    both = ops[1](*arrays, vals, field, ns, nodes)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["mesh_spread"], counts["mesh_gather"], counts["mesh_wgrad"]) == (1, 1, 1)
    for b in range(4):
        one = [a[b] for a in arrays]
        assert _rel(mesh[b], ops[0](*one, vals[b], ns, nodes)) <= 1e-6
        for got, ref in zip(both, ops[1](*one, vals[b], field[b], ns, nodes)):
            assert torch.equal(got[b], ref)
    # a batch of one is the launch of one system
    one = [a[:1] for a in arrays]
    for got, ref in zip(ops[1](*one, vals[:1], field[:1], ns, nodes),
                        ops[1](*[a[0] for a in arrays], vals[0], field[0], ns, nodes)):
        assert torch.equal(got[0], ref)


def test_batched_launch_refuses_mismatched_batches(device):
    arrays, vals, field, ns = _batched_case(device, 4, 1, 2)
    with pytest.raises(ValueError, match="shape"):
        mk.mesh_gather(*arrays[:3], arrays[3][:1].contiguous(), field, ns, 4)
    with pytest.raises(ValueError, match="shape"):
        mk.mesh_wgrad(*arrays, vals[:1].contiguous(), field, ns, 4)
    with pytest.raises(ValueError, match="shape"):
        mk.mesh_spread(*arrays, vals.transpose(0, 1).contiguous(), ns, 4)


@pytest.mark.parametrize("name", ["PME", "P3M", "dipole"])
def test_vmap_of_the_calculator_launches_each_kernel_once(device, name):
    """``torch.func.vmap`` of the per-atom call with its gradients over 4
    padded systems: D, E and F launch as often as for one system, and the
    batch equals the loop over the systems (float32) and the plain float64
    batch within the per-atom bars."""
    from torchpme_tpu_torch.utils.neighbors import compute_distances, neighbor_list

    rng = np.random.default_rng(7)
    n_sys, n_pad, box = 4, 200, 12.0
    f32 = dict(dtype=torch.float32, device=device)
    pos = rng.uniform(0, box, (n_sys, n_pad, 3))
    sizes = (198, 180, 162, 150)
    if name == "dipole":
        q = rng.normal(size=(n_sys, n_pad, 3))
    else:  # water charges, neutral in each system
        q = np.stack([np.tile([-0.84, 0.42, 0.42], n_pad // 3 + 1)[:n_pad, None]] * n_sys)
    for b, n in enumerate(sizes):
        q[b, n:] = 0.0
    lists = [neighbor_list(pos[b, :n], np.eye(3) * box, cutoff=3.0) for b, n in enumerate(sizes)]
    width = max(x[0].shape[0] for x in lists)
    idx = np.stack([np.concatenate([x[0], np.tile([0, 1], (width - x[0].shape[0], 1))]) for x in lists])
    shifts = np.stack([np.concatenate([x[2], np.zeros((width - x[0].shape[0], 3))]) for x in lists])
    pair_mask = np.stack([np.arange(width) < x[0].shape[0] for x in lists])
    node_mask = np.stack([np.arange(n_pad) < n for n in sizes])
    cell = np.stack([np.eye(3) * box] * n_sys)
    if name == "dipole":
        calc = tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=1.0), mesh_spacing=0.8)
    else:
        cls = tpt.PMECalculator if name == "PME" else tpt.P3MCalculator
        calc = cls(tpt.CoulombPotential(smearing=1.0), mesh_spacing=0.8, interpolation_nodes=4)
    ns = calc.get_ns_mesh(cell[0])

    def energy(qq, c, p, i, s, nm, pm, plain):
        if name == "dipole":
            vec = p[i[:, 1]] - p[i[:, 0]] + s @ c
            vec = torch.where(pm[:, None], vec, 1.0)
            return torch.sum(calc(qq, c, p, i, vec, ns_kvectors=ns, plain=plain) * qq)
        d = torch.where(pm, compute_distances(p, i, c, s), 1.0)
        return torch.sum(calc(qq, c, p, i, d, node_mask=nm, pair_mask=pm, ns_mesh=ns,
                              plain=plain) * qq)

    def run(dtype, plain, batch=None):
        opts = dict(dtype=dtype, device=device)
        args = [torch.tensor(a, **opts) for a in (q, cell, pos)] + [
            torch.as_tensor(idx, device=device), torch.tensor(shifts, **opts),
            torch.as_tensor(node_mask, device=device), torch.as_tensor(pair_mask, device=device)]
        grad = torch.func.grad_and_value(energy, argnums=(0, 1, 2))
        if batch is not None:
            return grad(*[a[batch] for a in args], plain)
        return torch.func.vmap(grad, in_dims=(0,) * 7 + (None,))(*args, plain)

    kernels.reset_launch_counts()
    got = run(torch.float32, False)
    torch.cuda.synchronize()
    batched = kernels.launch_counts()
    kernels.reset_launch_counts()
    run(torch.float32, False, batch=0)
    torch.cuda.synchronize()
    single = kernels.launch_counts()
    keys = ("mesh_spread", "mesh_gather", "mesh_wgrad")
    assert [batched[k] for k in keys] == [single[k] for k in keys]
    assert min(batched[k] for k in keys) >= 1
    ref = run(torch.float64, True)
    (g_q, g_cell, g_pos), e = got
    (r_q, r_cell, r_pos), r_e = ref
    assert float((e.double() - r_e).abs().max()) <= 1e-5 * float(r_e.abs().max())
    assert _rel(g_pos, r_pos) <= 1e-5 and _rel(g_q, r_q) <= 1e-5 and _rel(g_cell, r_cell) <= 1e-4
    for b in range(n_sys):
        (l_q, l_cell, l_pos), l_e = run(torch.float32, False, batch=b)
        assert abs(float(e[b] - l_e)) <= 1e-5 * abs(float(l_e))
        assert _rel(g_pos[b], l_pos) <= 1e-5 and _rel(g_cell[b], l_cell) <= 1e-5


# -- kernels A, B, C, G as tpme:: custom ops, and the exported step --------------


def _op_operands(fp, pos, q, cell):
    """Operands of the ops of A, B, C and G at the aligned state (none of
    them requires grad)."""
    pos, q, cell = pos.detach(), q.detach(), cell.detach()
    rel, q_rows, geom = _slots(fp, pos, q, cell)
    n_cells, cap = fp.clist.slot_mask.shape
    idx = fp.clist.atom_index.long()
    rows = fp.bucket(pos)[: n_cells * cap].reshape(n_cells, cap, 3)
    win = rc._prepare_bucketed(q[idx], rows, cell, fp.clist, window=True)[:4]
    mu = torch.randn((pos.shape[0], 3), generator=torch.Generator(pos.device).manual_seed(3),
                     device=pos.device)
    dwin = rc._prepare_bucketed(mu[idx], rows, cell, fp.clist)[:4]
    mui = torch.flip(dwin[1], dims=(-1,)).contiguous() * dwin[2][..., None]
    ct_rho = torch.randn((1, *NS), generator=torch.Generator(pos.device).manual_seed(4),
                         device=pos.device)
    return rel, q_rows, geom, ct_rho, win, dwin, mui


def test_ops_pass_opcheck(step):
    fp, pos, q, cell = step
    rel, q_rows, geom, ct_rho, win, dwin, mui = _op_operands(fp, pos, q, cell)
    geometry, method = geom.as_args()

    def leaf(t):
        return t.detach().clone().requires_grad_()

    table = rc.window_table(fp.calc.potential)
    cases = {
        "spread_fwd": (leaf(rel), leaf(q_rows), geometry, method),
        "spread_bwd": (rel, q_rows, ct_rho, geometry, method),
        "window": (leaf(win[0]), leaf(win[1]), win[2], win[3], leaf(cell), *table, 3.0),
        "window_dipole": (leaf(dwin[0]), leaf(dwin[1]), dwin[2], leaf(dwin[3]), leaf(mui),
                          1.0, 1.0, 3.0),
    }
    for name, args in cases.items():
        torch.library.opcheck(getattr(torch.ops.tpme, name), args)


def test_op_launch_equals_the_direct_launch(step):
    """Each op called directly against the entry point that launches it
    (both through the op's C++ CUDA kernel): C's d_pc, d_q and G's d_pc,
    d_mu, d_mui bit for bit, A and B within the kernel bar, one launch each."""
    fp, pos, q, cell = step
    cell = cell.detach()
    rel, q_rows, geom, ct_rho, win, dwin, mui = _op_operands(fp, pos, q, cell)
    geometry, method = geom.as_args()
    kernels.reset_launch_counts()
    assert _rel(sf.fused_spread(rel, q_rows, geom),
                torch.ops.tpme.spread_fwd(rel, q_rows, geometry, method)) <= 1e-5
    for a, b in zip(sf.fused_spread_bwd(rel, q_rows, ct_rho, geom),
                    torch.ops.tpme.spread_bwd(rel, q_rows, ct_rho, geometry, method)):
        assert _rel(a, b) <= 1e-5
    table = rc.window_table(fp.calc.potential)
    got = torch.ops.tpme.window(*win, cell, *table, 3.0)
    e, direct = rc.window_value_and_grad(fp.calc.potential, 3.0, *win)
    assert torch.equal(got[1], direct[0]) and torch.equal(got[2], direct[1])
    assert abs(float(got[0]) - float(e)) <= 1e-6 * abs(float(e))
    pot = tpt.PotentialDipole(smearing=1.0, prefactor=1.0)
    got = torch.ops.tpme.window_dipole(*dwin, mui, 1.0, 1.0, 3.0)
    _, direct = rcd.dipole_window_value_and_grad(pot, 3.0, *dwin, mui)
    for i, j in ((1, 0), (2, 1), (4, 3)):
        assert torch.equal(got[i], direct[j])
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "spread_fwd": 2, "spread_bwd": 2, "window": 2, "window_dipole": 2}


def test_ops_refuse_vmap_on_the_card(step):
    fp, pos, q, cell = step
    rel, q_rows, geom, ct_rho, win, dwin, mui = _op_operands(fp, pos, q, cell)
    geometry, method = geom.as_args()
    table = rc.window_table(fp.calc.potential)
    calls = {
        "spread_fwd": (lambda r: torch.ops.tpme.spread_fwd(r, q_rows, geometry, method), rel),
        "spread_bwd": (lambda r: torch.ops.tpme.spread_bwd(r, q_rows, ct_rho, geometry, method),
                       rel),
        "window": (lambda p: torch.ops.tpme.window(p, *win[1:], cell, *table, 3.0), win[0]),
        "window_dipole": (lambda p: torch.ops.tpme.window_dipole(p, *dwin[1:], None, 1.0, 1.0,
                                                                 3.0), dwin[0]),
    }
    for fn, x in calls.values():
        with pytest.raises(NotImplementedError, match="no vmap rule"):
            torch.func.vmap(fn)(torch.stack([x, x]))


def test_exported_aligned_step_launches_a_b_c_once(step):
    """``export_step`` → bytes → ``load_step`` of the aligned MD step with
    its gradients: the program keeps the ops (one launch each of A, B and C
    per step) and reproduces the eager step."""
    from torchpme_tpu_torch.deploy import _calls_tpme, export_step, load_step

    fp, pos, q, cell = (x if i == 0 else x.detach() for i, x in enumerate(step))
    rows = fp.bucket(pos)

    def energy(r, c):
        return fp.energy(q, c, r)

    blob = export_step(energy, rows, cell, with_grad=(0, 1))
    assert _calls_tpme(blob)
    restored = load_step(blob)
    kernels.reset_launch_counts()
    e, (g_rows, g_cell) = restored(rows, cell)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {"spread_fwd": 1, "spread_bwd": 1,
                                                      "window": 1}
    r, c = rows.clone().requires_grad_(), cell.clone().requires_grad_()
    e_ref = energy(r, c)
    g_ref = torch.autograd.grad(e_ref, (r, c))
    assert abs(float(e) - float(e_ref.detach())) <= 1e-5 * abs(float(e_ref.detach()))
    assert _rel(g_rows, g_ref[0]) <= 1e-5 and _rel(g_cell, g_ref[1]) <= 1e-4


#: an engine with ``torch`` alone: ``python -I`` in a scratch directory, the
#: port banned from import, the artifact run by the torch-only recipe of
#: ``deploy``'s docstring
TORCH_ONLY_ENGINE = """
import sys, importlib.abc
class Ban(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in ("torchpme_tpu_torch", "torchpme_tpu"):
            raise ImportError("banned in the engine")
sys.meta_path.insert(0, Ban())
import io, tempfile, zipfile, torch
with zipfile.ZipFile("step.zip") as archive:
    library, program = archive.read("tpme_ops.so"), archive.read("cuda.pt2")
with tempfile.NamedTemporaryFile(suffix=".so") as f:
    f.write(library)
    f.flush()
    torch.ops.load_library(f.name)
step = torch.export.load(io.BytesIO(program)).module()
rows, cell = torch.load("args.pt")
torch.ops.tpme.reset_launch_counts()
e, (g_rows, g_cell) = step(rows, cell)
torch.cuda.synchronize()
assert not [m for m in sys.modules if m.startswith("torchpme_tpu")]
torch.save({"e": e.cpu(), "g_rows": g_rows.cpu(), "g_cell": g_cell.cpu(),
            "counts": list(torch.ops.tpme.launch_counts())}, "out.pt")
"""


def test_exported_step_runs_in_a_torch_only_engine(step, tmp_path):
    """The exported aligned MD step run by a process with ``torch`` alone
    (the artifact's op library, no module of the port): A, B and C once
    each, and the values of ``load_step``'s step in this process within the
    kernel bar (A's and B's float sums are not ordered)."""
    import subprocess
    import sys

    from torchpme_tpu_torch.deploy import export_step, load_step

    fp, pos, q, cell = (x if i == 0 else x.detach() for i, x in enumerate(step))
    rows = fp.bucket(pos)
    blob = export_step(lambda r, c: fp.energy(q, c, r), rows, cell, with_grad=(0, 1))
    (tmp_path / "step.zip").write_bytes(blob)
    torch.save((rows.cpu(), cell.cpu()), tmp_path / "args.pt")
    # the engine takes CPU copies to the card itself
    script = TORCH_ONLY_ENGINE.replace('torch.load("args.pt")',
                                       '(t.cuda() for t in torch.load("args.pt"))')
    run = subprocess.run([sys.executable, "-I", "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600, check=False)
    assert run.returncode == 0, run.stderr[-3000:]
    out = torch.load(tmp_path / "out.pt")
    counts = dict(zip(kernels.COUNTER_NAMES, out["counts"]))
    assert {k: v for k, v in counts.items() if v} == {"spread_fwd": 1, "spread_bwd": 1,
                                                      "window": 1}
    e, (g_rows, g_cell) = load_step(blob)(rows, cell)
    assert abs(float(out["e"]) - float(e)) <= 1e-6 * abs(float(e))
    assert _rel(out["g_rows"], g_rows.cpu()) <= 1e-5 and _rel(out["g_cell"], g_cell.cpu()) <= 1e-5


def test_export_step_for_two_platforms(device):
    """One artifact, one program per platform: each runs on its device, the
    CPU program through the plain versions, the CUDA one through the ops."""
    from torchpme_tpu_torch.deploy import export_step, load_step
    from torchpme_tpu_torch.utils.neighbors import neighbor_list

    rng = np.random.default_rng(7)
    positions = torch.tensor(rng.uniform(0, 9.0, (40, 3)))
    charges = torch.tensor(np.tile([1.0, -1.0], 20).reshape(-1, 1))
    cell = torch.eye(3, dtype=torch.float64) * 9.0
    idx, dist, _ = (torch.as_tensor(a) for a in neighbor_list(positions, cell, 3.0))
    calc = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=2.0)
    ns_k = calc.get_ns_kvectors(cell)

    def potentials(q, c, p, d):  # the closure's pairs follow the arguments
        return calc(q, c, p, idx.to(q.device), d, ns_kvectors=ns_k)

    args = (charges, cell, positions, dist)
    blob = export_step(potentials, *args, platforms=("cpu", "cuda"))
    restored = load_step(blob)
    ref = potentials(*args)
    np.testing.assert_allclose(restored(*args).numpy(), ref.numpy(), rtol=0, atol=1e-12)
    on_card = restored(*[a.to(device) for a in args])
    np.testing.assert_allclose(on_card.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="shape mismatch"):
        restored(*[a.to(device) for a in (charges[:-2], cell, positions[:-2], dist)])


# -- kernel C's split variant (separate i-side charges, the slab window) ---------


def _split_inputs(fp, pos, q, cell):
    """Window operands of the clustered state and i-side charges zero on the
    last x plane (a slab's halo plane) and scaled by plane elsewhere."""
    pos, q, cell = pos.detach(), q.detach(), cell.detach()
    n_cells, cap = fp.clist.slot_mask.shape
    rows = fp.bucket(pos)[: n_cells * cap].reshape(n_cells, cap, 3)
    ins = rc._prepare_bucketed(q[fp.clist.atom_index.long()], rows, cell, fp.clist,
                               window=True)[:4]
    nx = ins[0].shape[0]
    scale = torch.linspace(0.5, 1.5, nx, device=pos.device)
    scale[-1] = 0.0
    return ins, (ins[1] * scale[:, None, None, None, None]).contiguous()


def test_window_split_kernel_matches_plain(step):
    """C's split variant against its plain version: the energy, d_pc and the
    i- and j-side charge cotangents; d_pc, d_q and d_qi bitwise equal over
    two launches; d_offs and the image term against float64."""
    fp, pos, q, cell = step
    ins, qi = _split_inputs(fp, pos, q, cell)
    pot = tpt.CoulombPotential(smearing=1.0)
    kernels.reset_launch_counts()
    e_a, g_a = rc.window_value_and_grad(pot, 3.0, *ins, qi_g=qi)
    e_b, g_b = rc.window_value_and_grad(pot, 3.0, *ins, qi_g=qi)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["window_split"] == 2 and counts["window"] == 0
    for i in (0, 1, 4):
        assert torch.equal(g_a[i], g_b[i])
    e_p, g_p = rc._we_value_and_grad(pot, 3.0, *ins, qi_g=qi)
    assert abs(float(e_a) - float(e_p)) <= 1e-6 * abs(float(e_p))
    for i in (0, 1, 4):
        assert g_a[i].shape == g_p[i].shape and _rel(g_a[i], g_p[i]) <= 1e-5
    _, g64 = rc._we_value_and_grad(pot, 3.0, *[t.double() for t in ins], qi_g=qi.double())
    assert _rel(g_a[2], g64[2]) <= 1e-5 and _rel(g_a[3], g64[3]) <= 1e-5


def test_window_split_with_equal_charges_is_the_unsplit_kernel(step):
    """``qi_g = q_g``: the split variant gives the unsplit kernel's energy
    and d_pc, and d_q + d_qi is its d_q (within float32 rounding: the two
    sides sum apart); the unsplit variant still equals its plain version."""
    fp, pos, q, cell = step
    ins, _ = _split_inputs(fp, pos, q, cell)
    pot = tpt.CoulombPotential(smearing=1.0)
    e0, g0 = rc.window_value_and_grad(pot, 3.0, *ins)
    e1, g1 = rc.window_value_and_grad(pot, 3.0, *ins, qi_g=ins[1].clone())
    assert abs(float(e0) - float(e1)) <= 1e-6 * abs(float(e0))
    assert _rel(g1[0], g0[0]) <= 1e-6
    assert _rel(g1[1] + g1[4], g0[1]) <= 1e-5
    e_p, g_p = rc._we_value_and_grad(pot, 3.0, *ins)
    assert abs(float(e0) - float(e_p)) <= 1e-6 * abs(float(e_p))
    assert _rel(g0[0], g_p[0]) <= 1e-5 and _rel(g0[1], g_p[1]) <= 1e-5


def test_window_split_op_passes_opcheck(step):
    fp, pos, q, cell = step
    ins, qi = _split_inputs(fp, pos, q, cell)

    def leaf(t):
        return t.detach().clone().requires_grad_()

    table = rc.window_table(fp.calc.potential)
    args = (leaf(ins[0]), leaf(ins[1]), ins[2], ins[3], leaf(cell.detach()), *table, 3.0,
            leaf(qi))
    torch.library.opcheck(torch.ops.tpme.window, args)
