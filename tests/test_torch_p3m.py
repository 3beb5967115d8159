"""The port's P3M ≡ the JAX package's: the optimal influence function (modes
0–3, differential orders 1–6, a triclinic cell with accidental near-zero
k·h, its cell gradient), ``KSpaceFilter`` / ``P3MKSpaceFilter`` (norms,
``update``, the NaN guard), ``MeshInterpolator`` and ``mesh_xyz``, the tiled
mesh at 1 and 2 nodes (the plain versions of kernels D, E, F against the
JAX tiled functions), ``P3MCalculator`` per atom with its gradients on the
scatter and tiled backends at 1–5 nodes and its fused energy, ``MDFastPath``
with P3M in aligned, fused and tiled mode, the numpy state, and the CsCl
Madelung constant.  Float64 at ≤ 1e-10 where the algorithm is the JAX
package's; float32 paths at the JAX suite's float32 bars."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import clustered_box, jax_md_state, jax_tiled_state, random_box, rel

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.ops import kspace as jks
from torchpme_tpu.ops import mesh as jmesh
from torchpme_tpu.ops import mesh_tiled as jmt
from torchpme_tpu_torch.convert import (
    calculator_from_state,
    calculator_state,
    md_from_state,
    md_state,
    tiled_interp_from_state,
)
from torchpme_tpu_torch.ops import kspace as tks
from torchpme_tpu_torch.ops import mesh as tmesh
from torchpme_tpu_torch.ops import mesh_tiled as tmt
from torchpme_tpu_torch.utils import neighbors as tnb

torch.set_num_threads(1)

TRICLINIC = np.array([[10.0, 0.0, 0.0], [0.8, 10.0, 0.0], [0.0, -0.5, 10.0]])
SMEARING = 1.0
CUTOFF = 3.0


# -- the influence function and the filter classes -----------------------------


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_p3m_influence_function_matches_jax(mode, order):
    ns = (8, 16, 12)
    ours = tks.p3m_influence_function(torch.tensor(TRICLINIC), ns, 3, mode, order).numpy()
    theirs = np.asarray(jks.p3m_influence_function(jnp.asarray(TRICLINIC), ns, 3, mode, order))
    assert ours.shape == (8, 16, 7) and np.all(np.isfinite(ours))
    assert rel(ours, theirs) <= 1e-12


def test_p3m_influence_cell_gradient_matches_jax():
    """The triclinic k-grid of tests/ops/test_kspace.py holds accidental
    near-zero k·h (~1e-17): the Taylor branch of ``_sinc`` keeps the cell
    gradient exact there (finite differences and the JAX gradient)."""
    ns = (128, 16, 16)
    proj = np.random.default_rng(0).normal(size=(128, 16, 9))

    def f_port(c):
        return torch.sum(tks.p3m_influence_function(c, ns, 3, mode=0) * torch.tensor(proj))

    cell = torch.tensor(TRICLINIC, requires_grad=True)
    (g_port,) = torch.autograd.grad(f_port(cell), cell)
    g_jax = jax.jit(jax.grad(
        lambda c: jnp.sum(jks.p3m_influence_function(c, ns, 3, mode=0) * jnp.asarray(proj))
    ))(jnp.asarray(TRICLINIC))
    assert rel(g_port.numpy(), g_jax) <= 1e-10
    eps = 1e-5
    with torch.no_grad():
        bump = torch.zeros(3, 3, dtype=torch.float64)
        bump[1, 0] = eps
        fd = (f_port(cell + bump) - f_port(cell - bump)) / (2 * eps)
    assert abs(float(g_port[1, 0]) - float(fd)) <= 1e-6 * abs(float(fd))
    x = torch.tensor([0.0, 1e-17, -3e-5, 1e-4, 0.3], dtype=torch.float64)
    np.testing.assert_allclose(tks._sinc(x).numpy(), np.asarray(jks._sinc(jnp.asarray(x.numpy()))),
                               rtol=1e-15, atol=0)


class _Gaussian:
    def __init__(self, width):
        self.width = width

    def kernel_from_k_sq(self, k_sq):
        exp = torch.exp if isinstance(k_sq, torch.Tensor) else jnp.exp
        return exp(-0.5 * self.width**2 * k_sq)


class _NaNKernel:
    def kernel_from_k_sq(self, k_sq):
        return k_sq * float("nan")


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _jax_filters(cell, field, cell2, field2, ns, ns2, norms):
    """The JAX package's ``KSpaceFilter`` and ``P3MKSpaceFilter`` on
    ``field``, and after an update to ``cell2`` and ``ns2`` on ``field2``,
    under one ``jax.jit``."""
    kf_j = jks.KSpaceFilter(cell, ns, _Gaussian(0.4), *norms)
    p3_j = jks.P3MKSpaceFilter(cell, ns, 4, tpme.CoulombPotential(smearing=0.7), *norms, mode=1,
                               differential_order=3)
    first = kf_j(field), p3_j(field)
    for f in (kf_j, p3_j):
        f.update(cell2, ns2)
    return (*first, kf_j(field2), p3_j(field2))


@pytest.mark.parametrize("norms", [("ortho", "ortho"), ("backward", "forward"), ("forward", "backward")])
def test_kspace_filters_match_jax(norms):
    ns = (8, 16, 12)
    field = np.random.default_rng(3).normal(size=(2, *ns))
    cell = TRICLINIC
    ns2, cell2 = (16, 8, 8), cell * 1.1
    field2 = np.random.default_rng(4).normal(size=(1, *ns2))
    kf_j, p3_j, kf2_j, p32_j = _jax_filters(jnp.asarray(cell), jnp.asarray(field),
                                            jnp.asarray(cell2), jnp.asarray(field2), ns, ns2,
                                            norms)
    kf = tks.KSpaceFilter(torch.tensor(cell), ns, _Gaussian(0.4), *norms)
    assert rel(kf(torch.tensor(field)).numpy(), kf_j) <= 1e-12
    # update: a new cell and mesh, the kernel of a potential
    pot = tpt.CoulombPotential(smearing=0.7)
    p3 = tks.P3MKSpaceFilter(torch.tensor(cell), ns, 4, pot, *norms, mode=1,
                             differential_order=3)
    assert rel(p3(torch.tensor(field)).numpy(), p3_j) <= 1e-12
    for f in (kf, p3):
        f.update(torch.tensor(cell2), ns2)
    assert rel(kf(torch.tensor(field2)).numpy(), kf2_j) <= 1e-12
    assert rel(p3(torch.tensor(field2)).numpy(), p32_j) <= 1e-12


def test_kspace_filter_validation_and_nan_guard():
    cell = torch.eye(3, dtype=torch.float64) * 4.0
    with pytest.raises(ValueError, match="NaNs detected"):
        tks.KSpaceFilter(cell, (4, 4, 4), _NaNKernel())(torch.ones((1, 4, 4, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="fft_norm"):
        tks.KSpaceFilter(cell, (4, 4, 4), _Gaussian(1.0), fft_norm="spam")
    with pytest.raises(ValueError, match="mode"):
        tks.P3MKSpaceFilter(cell, (4, 4, 4), 3, _Gaussian(1.0), mode=7)
    with pytest.raises(ValueError, match="differential_order"):
        tks.P3MKSpaceFilter(cell, (4, 4, 4), 3, _Gaussian(1.0), differential_order=0)
    with pytest.raises(ValueError, match=r"\(3, 3\)"):
        tks.KSpaceFilter(torch.eye(2), (4, 4, 4), _Gaussian(1.0))
    with pytest.raises(ValueError, match="has to be"):
        tks.KSpaceFilter(cell, (4, 4), _Gaussian(1.0))
    with pytest.raises(NotImplementedError, match="kernel_from_k_sq"):
        tks.KSpaceKernel().kernel_from_k_sq(torch.zeros(1))


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _jax_interpolator(cell, positions, weights, field, ns, nodes, method):
    """The JAX package's ``MeshInterpolator`` and ``mesh_xyz`` under one
    ``jax.jit`` (eager JAX compiles every operation on its own): the mesh
    points, the spread of ``weights`` and the gather of ``field``."""
    mi = jmesh.MeshInterpolator(cell, ns, nodes, method)
    xyz = mi.get_mesh_xyz()
    mi.compute_weights(positions)
    return xyz, jmesh.mesh_xyz(cell, ns), mi.points_to_mesh(weights), mi.mesh_to_points(field)


@pytest.mark.parametrize(
    "method,nodes", [("P3M", 1), ("P3M", 2), ("P3M", 3), ("P3M", 5), ("Lagrange", 4)]
)
def test_mesh_interpolator_and_mesh_xyz_match_jax(method, nodes):
    rng = np.random.default_rng(5)
    positions = rng.uniform(0, 1, (30, 3)) @ TRICLINIC
    weights = rng.normal(size=(30, 2))
    ns = (8, 12, 10)
    field = rng.normal(size=(2, *ns))
    xyz_j, mesh_xyz_j, rho_j, back_j = _jax_interpolator(
        jnp.asarray(TRICLINIC), jnp.asarray(positions), jnp.asarray(weights), jnp.asarray(field),
        ns, nodes, method)
    mi = tmesh.MeshInterpolator(torch.tensor(TRICLINIC), ns, nodes, method)
    assert rel(mi.get_mesh_xyz().numpy(), xyz_j) <= 1e-15
    assert rel(tmesh.mesh_xyz(torch.tensor(TRICLINIC), ns).numpy(), mesh_xyz_j) <= 1e-15
    with pytest.raises(ValueError, match="compute_weights"):
        mi.points_to_mesh(torch.tensor(weights))
    mi.compute_weights(torch.tensor(positions))
    rho = mi.points_to_mesh(torch.tensor(weights))
    assert rel(rho.numpy(), rho_j) <= 1e-12
    assert abs(float(rho.sum()) - weights.sum()) <= 1e-12  # charge conserved
    assert rel(mi.mesh_to_points(torch.tensor(field)).numpy(), back_j) <= 1e-12
    mi.update(ns_mesh=(16, 8, 8))
    assert mi.ns_mesh == (16, 8, 8)
    with pytest.raises(ValueError, match="P3M"):
        tmesh.MeshInterpolator(torch.eye(3), ns, 6, "P3M")


class _Unit:
    def kernel_from_k_sq(self, k_sq):
        return torch.ones_like(k_sq)


# the power users' entry points that build state from a cell
HOST_ENTRY_POINTS = {
    "KSpaceFilter": lambda cell, **kw: tks.KSpaceFilter(cell, (4, 4, 4), _Unit(), **kw),
    "P3MKSpaceFilter": lambda cell, **kw: tks.P3MKSpaceFilter(cell, (4, 4, 4), 3, _Unit(), **kw),
    "MeshInterpolator": lambda cell, **kw: tmesh.MeshInterpolator(cell, (4, 4, 4), 3, "P3M", **kw),
    "compute_batched_kvectors": lambda cell, **kw: tpt.ops.compute_batched_kvectors(
        1.3, cell[None], **kw
    ),
}


def _state_device(made):
    return made.device if isinstance(made, torch.Tensor) else made.cell.device


@pytest.mark.parametrize("name", sorted(HOST_ENTRY_POINTS))
def test_power_user_state_follows_the_default_device_rule(monkeypatch, name):
    """A host cell and no device → default_device(): a raise without a card
    that says to pass device="cpu", the card with one.  A CPU tensor or
    device="cpu" keeps the state on the CPU, and a host cell given to
    ``update`` goes where the object lives."""
    make, cell = HOST_ENTRY_POINTS[name], np.eye(3) * 4.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make(cell)
    on_cpu = [make(cell, device="cpu"), make(torch.tensor(cell))]
    assert all(_state_device(m).type == "cpu" for m in on_cpu)
    for made in on_cpu:
        if hasattr(made, "update"):
            made.update(cell * 1.1)
            assert made.cell.device.type == "cpu" and made.cell.dtype == torch.float64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # with a card, a host cell heads for it (this build of torch has none:
    # the attempt itself is the evidence)
    with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
        make(cell)


# -- the tiled mesh at P3M's 1 and 2 nodes ------------------------------------------


@pytest.mark.parametrize("nodes", [1, 2])
def test_jax_tiled_mesh_at_1_and_2_nodes_matches_the_port_plain_path(nodes):
    """JAX's tiled bucketing + spread + gather (its Pallas kernels in
    interpret mode) with the P3M tables against the port's plain versions of
    kernels D and E on the same bucketing, and the port's gradients against
    its scatter."""
    cell = np.diag([6.0, 6.0, 12.0])
    ns = (16, 16, 24)
    rng = np.random.default_rng(6)
    positions = rng.uniform(0, 1, (50, 3)) @ cell
    charges = rng.normal(size=(50, 2))
    inv = np.linalg.inv(cell)
    interp_j = jmt.compute_tiled_interpolation(jnp.asarray(positions), jnp.asarray(inv), ns,
                                               nodes, "P3M")
    interp_t = tmt.compute_tiled_interpolation(torch.tensor(positions), torch.tensor(inv), ns,
                                               nodes, "P3M")
    from_j = tiled_interp_from_state(jax_tiled_state(interp_j), device="cpu")
    for name in ("local_x", "local_y", "start_z", "atom_of_slot"):
        np.testing.assert_array_equal(getattr(interp_t, name).numpy(), getattr(from_j, name).numpy())
    rho_j = np.asarray(jax.jit(jmt.tiled_points_to_mesh)(interp_j, jnp.asarray(charges)))
    rho_t = tmt.tiled_points_to_mesh(from_j, torch.tensor(charges), plain=True)
    assert rel(rho_t.numpy(), rho_j) <= 1e-12
    field = rng.normal(size=rho_j.shape)
    back_j = np.asarray(jax.jit(jmt.tiled_mesh_to_points)(interp_j, jnp.asarray(field)))
    back_t = tmt.tiled_mesh_to_points(from_j, torch.tensor(field), plain=True)
    assert rel(back_t.numpy(), back_j) <= 1e-12
    # the backward (D ↔ E, F for the weights) against the scatter's autograd
    grads = []
    for tiled in (True, False):
        p = torch.tensor(positions, requires_grad=True)
        q = torch.tensor(charges, requires_grad=True)
        if tiled:
            it = tmt.compute_tiled_interpolation(p, torch.tensor(inv), ns, nodes, "P3M")
            rho = tmt.tiled_points_to_mesh(it, q, plain=True)
            back = tmt.tiled_mesh_to_points(it, rho * 1.5, plain=True)
        else:
            it = tmesh.compute_interpolation(p, torch.tensor(inv), ns, nodes, "P3M")
            rho = tmesh.points_to_mesh(it, q)
            back = tmesh.mesh_to_points(it, rho * 1.5)
        grads.append(torch.autograd.grad(torch.sum(rho**2) + torch.sum(back * q), (p, q)))
    for a, b in zip(*grads):
        # one node: constant weights, so the position gradient is exactly 0
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-11 * scale or scale == float(a.abs().max()) == 0.0


# -- P3MCalculator ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def p3m_box():
    positions, q, cell = random_box(120, 10.0, seed=31)
    q = np.concatenate([q, q[::-1] * 0.5], axis=1)
    idx, _, shifts = tnb.neighbor_list(positions, cell, CUTOFF)
    return positions, q, cell, idx, shifts


def _jax_p3m_call(nodes, positions, q, cell, idx, shifts):
    calc = tpme.P3MCalculator(tpme.CoulombPotential(smearing=SMEARING), mesh_spacing=1.5,
                              interpolation_nodes=nodes, mesh_backend="scatter")
    from torchpme_tpu.utils.neighbors import compute_distances

    def pot(p, qq, c):
        d = compute_distances(p, jnp.asarray(idx), c, jnp.asarray(shifts))
        return calc(qq, c, p, jnp.asarray(idx), d, ns_mesh=(16, 16, 16))

    def energy(p, qq, c):
        v = pot(p, qq, c)
        return jnp.sum(v * qq), v

    # one compilation gives the potentials, the energy and its gradients
    fn = jax.jit(jax.value_and_grad(energy, argnums=(0, 1, 2), has_aux=True))
    (e, v), grads = fn(jnp.asarray(positions), jnp.asarray(q), jnp.asarray(cell))
    return np.asarray(v), float(e), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("nodes", [1, 2, 3, 4, 5])
def test_p3m_calculator_matches_jax(p3m_box, nodes):
    """Per-atom potentials, energy and gradients (positions, charges, cell)
    on the scatter and tiled backends, against the JAX scatter backend."""
    positions, q, cell, idx, shifts = p3m_box
    pot_j, e_j, g_j = _jax_p3m_call(nodes, positions, q, cell, idx, shifts)
    for backend in ("scatter", "tiled"):
        calc = tpt.P3MCalculator(tpt.CoulombPotential(smearing=SMEARING), mesh_spacing=1.5,
                                 interpolation_nodes=nodes, mesh_backend=backend)
        assert calc.get_ns_mesh(cell) == (16, 16, 16)
        p = torch.tensor(positions, requires_grad=True)
        qq = torch.tensor(q, requires_grad=True)
        c = torch.tensor(cell, requires_grad=True)
        d = tnb.compute_distances(p, torch.tensor(idx), c, torch.tensor(shifts))
        pot = calc(qq, c, p, torch.tensor(idx), d)
        e = torch.sum(pot * qq)
        grads = torch.autograd.grad(e, (p, qq, c))
        assert rel(pot.detach().numpy(), pot_j) <= 1e-10, backend
        assert abs(float(e.detach()) - e_j) <= 1e-10 * abs(e_j), backend
        for name, a, b in zip(("positions", "charges", "cell"), grads, g_j):
            assert rel(a.numpy(), b) <= 1e-10, (backend, name)
        with torch.no_grad():
            e_quad = calc.energy(qq, c, p, torch.tensor(idx), d)
        assert abs(float(e_quad) - e_j) <= 1e-10 * abs(e_j), backend


@pytest.mark.parametrize("nodes", [2, 5])
def test_p3m_fused_energy(p3m_box, nodes):
    """The fused backend's energy (kernel A's plain version on the CPU,
    float32) against the port's float64 tiled energy (held to JAX by
    ``test_p3m_calculator_matches_jax``), at the JAX suite's float32 bar."""
    positions, q, cell, idx, shifts = p3m_box
    q = q[:, :1]
    pot = tpt.CoulombPotential(smearing=SMEARING)
    fused = tpt.P3MCalculator(pot, mesh_spacing=1.5, interpolation_nodes=nodes,
                              mesh_backend="fused", tile_capacity=64)
    f32 = torch.float32
    p32, q32, c32 = (torch.tensor(a, dtype=f32) for a in (positions, q, cell))
    interp = tmt.compute_tiled_interpolation(p32, torch.linalg.inv(c32), (16, 16, 16), nodes,
                                             "P3M", capacity=64)
    clist = tpt.ops.compute_cell_list(p32, c32, CUTOFF)
    e32 = fused.energy(q32, c32, p32, cell_list=clist, tiled_interp=interp)
    ref = tpt.P3MCalculator(pot, mesh_spacing=1.5, interpolation_nodes=nodes,
                            mesh_backend="tiled")
    p64, q64, c64 = (torch.tensor(a) for a in (positions, q, cell))
    e64 = ref.energy(q64, c64, p64, cell_list=tpt.ops.compute_cell_list(p64, c64, CUTOFF))
    assert abs(float(e32) - float(e64)) <= 2e-5 * abs(float(e64))


@pytest.mark.parametrize("calc_name", ["p3m", "pme"])
def test_cscl_madelung_constant_p3m(calc_name):
    positions = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], dtype=torch.float64)
    charges = torch.tensor([[-1.0], [1.0]], dtype=torch.float64)
    cell = torch.eye(3, dtype=torch.float64)
    idx, dist, _ = tnb.neighbor_list(positions, cell, cutoff=1.2)
    cls = tpt.P3MCalculator if calc_name == "p3m" else tpt.PMECalculator
    calc = cls(tpt.CoulombPotential(smearing=0.25), mesh_spacing=0.05, interpolation_nodes=5,
               mesh_backend="tiled")
    pot = calc(charges, cell, positions, torch.tensor(idx), torch.tensor(dist))
    assert abs(-float(torch.sum(pot * charges)) - 2.0353610945) <= 2e-5


def test_p3m_options_and_state():
    pot = tpt.CoulombPotential(smearing=1.0)
    for bad in (0, 6):
        with pytest.raises(ValueError, match="from 1 to 5 for method 'P3M'"):
            tpt.P3MCalculator(pot, interpolation_nodes=bad)
    with pytest.raises(ValueError, match="mode"):
        tpt.P3MCalculator(pot, mode=4)
    with pytest.raises(ValueError, match="differential_order"):
        tpt.P3MCalculator(pot, differential_order=7)
    with pytest.raises(ValueError, match="smearing"):
        tpt.P3MCalculator(tpt.CoulombPotential())
    calc = tpt.P3MCalculator(pot, mesh_spacing=0.7, interpolation_nodes=2, mode=1,
                             differential_order=4)
    state = calculator_state(calc)
    assert state["method"] == "P3M" and state["mode"] == 1 and state["differential_order"] == 4
    back = calculator_from_state(state, mesh_backend="scatter")
    assert isinstance(back, tpt.P3MCalculator) and calculator_state(back) == state
    assert "differential_order=4" in repr(back)
    calc_j = tpme.P3MCalculator(tpme.CoulombPotential(smearing=1.0), mesh_spacing=0.7,
                                interpolation_nodes=2, mode=1, differential_order=4)
    cell = torch.eye(3, dtype=torch.float64) * 5.0
    assert rel(back._kspace_filter(cell, (8, 8, 8)).numpy(),
               calc_j._kspace_filter(jnp.asarray(cell.numpy()), (8, 8, 8))) <= 1e-12


# -- MDFastPath with P3M ------------------------------------------------------------------


MD_NS = (16, 16, 16)


@pytest.fixture(scope="module")
def p3m_md_case():
    pos, q, cell = clustered_box(400, 16.0, seed=3, n_cluster=30)
    calc_j = tpme.P3MCalculator(tpme.CoulombPotential(smearing=1.0), mesh_spacing=1.0,
                                interpolation_nodes=5)
    fp_j = tpme.MDFastPath.create(calc_j, jnp.asarray(pos), jnp.asarray(cell), CUTOFF,
                                  MD_NS, mesh_impl="tiled")
    rows = fp_j.bucket(jnp.asarray(pos))
    e, (g_cell, g_rows) = jax.jit(jax.value_and_grad(fp_j.energy, argnums=(1, 2)))(
        jnp.asarray(q), jnp.asarray(cell), rows
    )
    ref = (float(e), -np.asarray(fp_j.unbucket(g_rows)), np.asarray(g_cell))
    return fp_j, ref, (pos, q, cell)


def _port_step(fp, pos, q, cell, dtype):
    c = torch.tensor(cell, dtype=dtype, requires_grad=True)
    rows = fp.bucket(torch.tensor(pos, dtype=dtype)).requires_grad_()
    e = fp.energy(torch.tensor(q, dtype=dtype), c, rows)
    g_rows, g_cell = torch.autograd.grad(e, (rows, c))
    return float(e.detach()), -fp.unbucket(g_rows).numpy(), g_cell.numpy()


@pytest.mark.parametrize("mode", ["aligned", "fused", "tiled"])
def test_md_fast_path_p3m_matches_jax(p3m_md_case, mode):
    """Energy, atom-order forces and cell gradient of the P3M step in each
    mode against the JAX package's tiled step in float64 (1e-9, as
    tests/test_torch_md.py holds PME); the fused mode is float32 (float64
    takes the tiled step), at the JAX suite's float32 bars."""
    fp_j, (e_j, f_j, c_j), (pos, q, cell) = p3m_md_case
    calc = tpt.P3MCalculator(tpt.CoulombPotential(smearing=1.0), mesh_spacing=1.0,
                             interpolation_nodes=5)
    dtype = torch.float32 if mode == "fused" else torch.float64
    fp = tpt.MDFastPath.create(calc, torch.tensor(pos, dtype=dtype),
                               torch.tensor(cell, dtype=dtype), CUTOFF, MD_NS,
                               mesh_impl=mode)
    assert fp.mesh_impl == mode and fp.calc._method == "P3M"
    e, f, c = _port_step(fp, pos, q, cell, dtype)
    if mode == "fused":
        assert abs(e - e_j) <= 2e-5 * abs(e_j)
        assert rel(f, f_j) <= 5e-5 and rel(c, c_j) <= 5e-5
        return
    assert abs(e - e_j) <= 1e-9 * abs(e_j)
    assert rel(f, f_j) <= 1e-9 and rel(c, c_j) <= 1e-9
    if mode == "tiled":
        # the numpy state of the JAX step builds the same port step
        port = md_from_state(jax_md_state(fp_j), device="cpu")
        assert isinstance(port.calc, tpt.P3MCalculator)
        assert md_state(port).keys() == jax_md_state(fp_j).keys()
        e2, f2, _ = _port_step(port, pos, q, cell, torch.float64)
        assert abs(e2 - e_j) <= 1e-10 * abs(e_j) and rel(f2, f_j) <= 1e-10
