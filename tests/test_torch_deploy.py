"""``torchpme_tpu_torch.deploy`` ≡ the JAX package's ``deploy`` (float64,
on the CPU): a calculator step is exported with ``torch.export``, saved to
bytes and run from them — in this process, and in a fresh one that cannot
import the port — reproducing the port's eager values and gradients and the
JAX package's exported ones.  Mirrors ``tests/test_deploy.py`` and
``examples/19_deployment_md_loop.py``: the engine here is a subprocess with
the whole port banned, on example 19's system, and the cross-process check
reads its first step.  A CPU artifact holds the kernels' plain versions:
no ``tpme::`` op is left in its graph."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchpme_tpu as tpme
import torchpme_tpu_torch as tpt
from torchpme_tpu.deploy import export_step as jax_export_step
from torchpme_tpu.deploy import load_step as jax_load_step
from torchpme_tpu.ops.rspace_cells import compute_cell_list as jax_compute_cell_list
from torchpme_tpu.utils.neighbors import neighbor_list
from torchpme_tpu_torch import deploy, kernels
from torchpme_tpu_torch.deploy import export_step, load_step
from torchpme_tpu_torch.ops.rspace_cells import compute_cell_list

torch.set_num_threads(1)

#: the engine's prologue: a meta-path hook refuses every module of the port
#: (and of the JAX package), as a deployment without the library would
BAN = (
    "import sys, importlib.abc\n"
    "class Ban(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, fullname, path=None, target=None):\n"
    "        if fullname.split('.')[0] in ('torchpme_tpu_torch', 'torchpme_tpu'):\n"
    "            raise ImportError('banned at deployment')\n"
    "        return None\n"
    "sys.meta_path.insert(0, Ban())\n"
    "import io, numpy as np, torch\n"
    "torch.set_num_threads(1)\n"
    "step = torch.export.load(io.BytesIO(open(sys.argv[1] + '/step.pt2', 'rb').read())).module()\n"
)


def _t(x):
    return torch.tensor(np.asarray(x))


def _start_engine(script: str, workdir: Path) -> subprocess.Popen:
    """The engine runs while the test computes its reference in-process."""
    return subprocess.Popen(
        [sys.executable, "-c", BAN + script, str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=workdir,
    )


def _finish(engine: subprocess.Popen) -> str:
    try:
        out, err = engine.communicate(timeout=300)
    finally:
        engine.kill()
    assert engine.returncode == 0, err[-2000:]
    return out


@pytest.fixture(scope="module", autouse=True)
def md_engine(tmp_path_factory):
    """``examples/19_deployment_md_loop.py``'s system (64 atoms, an 8.7 Å
    box, cutoff 4, ``mesh_spacing=0.9``): its float64 ``MDFastPath`` energy
    exported with its gradient, and an engine that cannot import the port
    started on it before the module's first test, so that it runs while the
    others do.  The engine evaluates the step once at the first rows, then
    drives 100 MD steps; the last two tests read what it wrote."""
    workdir = tmp_path_factory.mktemp("engine")
    rng = np.random.default_rng(0)
    n_atoms, box, cutoff = 64, 8.7, 4.0
    positions = torch.tensor(rng.uniform(0, box, (n_atoms, 3)))
    charges = torch.tensor(np.tile([1.0, -1.0], n_atoms // 2).reshape(-1, 1))
    cell = torch.eye(3, dtype=torch.float64) * box
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), mesh_spacing=0.9)
    ns = calc.get_ns_mesh(cell)
    fp = tpt.MDFastPath.create(calc, positions, cell, cutoff, ns)
    rows = fp.bucket(positions)

    def energy(r):
        return fp.energy(charges, cell, r)

    blob = export_step(energy, rows, with_grad=0)
    (workdir / "step.pt2").write_bytes(blob)
    np.save(workdir / "rows0.npy", rows.numpy())
    engine = _start_engine(
        "rows = torch.tensor(np.load(sys.argv[1] + '/rows0.npy'))\n"
        "e, g = step(rows)\n"
        "print(repr(float(e)))\n"
        "np.save(sys.argv[1] + '/g0.npy', g.numpy())\n"
        "velocity = torch.zeros_like(rows)\n"
        "for _ in range(100):\n"
        "    e, g = step(rows)\n"
        "    velocity -= 1e-3 * g\n"
        "    rows = rows + 1e-3 * velocity\n"
        "np.save(sys.argv[1] + '/rows_final.npy', rows.numpy())\n",
        workdir,
    )
    try:
        yield {"blob": blob, "energy": energy, "rows": rows, "engine": engine,
               "workdir": workdir, "out": None}
    finally:
        engine.kill()


def _engine_output(md_engine) -> str:
    if md_engine["out"] is None:
        md_engine["out"] = _finish(md_engine["engine"])
    return md_engine["out"]


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(7)
    n = 40
    positions = rng.uniform(0, 9.0, (n, 3))
    charges = np.tile([1.0, -1.0], n // 2).reshape(-1, 1)
    cell = np.eye(3) * 9.0
    idx, dist, _ = neighbor_list(positions, cell, 3.0)
    return positions, charges, cell, np.asarray(idx), np.asarray(dist)


def _ewald_pair(system):
    """The Ewald per-atom call of each package over the same pairs."""
    positions, charges, cell, idx, dist = system
    calc_j = tpme.EwaldCalculator(tpme.CoulombPotential(smearing=1.0), lr_wavelength=2.0)
    calc_t = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=1.0), lr_wavelength=2.0)
    ns_j, ns_t = calc_j.get_ns_kvectors(jnp.asarray(cell)), calc_t.get_ns_kvectors(_t(cell))
    idx_j, idx_t = jnp.asarray(idx), _t(idx)

    def potentials_j(q, c, p, d):
        return calc_j(q, c, p, idx_j, d, ns_kvectors=ns_j)

    def potentials_t(q, c, p, d):
        return calc_t(q, c, p, idx_t, d, ns_kvectors=ns_t)

    return potentials_j, potentials_t


@pytest.fixture(scope="module")
def ewald_artifact(system):
    positions, charges, cell, _, dist = system
    potentials_j, potentials_t = _ewald_pair(system)
    args = [_t(a) for a in (charges, cell, positions, dist)]
    return export_step(potentials_t, *args), potentials_t, potentials_j, args


def test_export_potentials_roundtrip(system, ewald_artifact):
    blob, potentials_t, potentials_j, args = ewald_artifact
    assert isinstance(blob, bytes) and len(blob) > 0
    assert not deploy._calls_tpme(blob)
    out = load_step(blob)(*args)
    np.testing.assert_allclose(out.numpy(), potentials_t(*args).numpy(), rtol=0, atol=1e-12)
    jax_args = [jnp.asarray(a.numpy()) for a in args]
    jax_out = jax_load_step(jax_export_step(potentials_j, *jax_args))(*jax_args)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), rtol=0, atol=1e-10)


def test_export_energy_with_grad(system):
    """The deployed MD artifact: energy + forces from the cell-list path."""
    positions, charges, cell, _, _ = system
    calc_t = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), mesh_spacing=0.45)
    calc_j = tpme.PMECalculator(tpme.CoulombPotential(smearing=1.0), mesh_spacing=0.45)
    ns = calc_t.get_ns_mesh(_t(cell))
    assert tuple(ns) == tuple(calc_j.get_ns_mesh(jnp.asarray(cell)))
    clist_t = compute_cell_list(_t(positions), _t(cell), 3.0, device="cpu")
    clist_j = jax_compute_cell_list(jnp.asarray(positions), jnp.asarray(cell), 3.0)

    def energy_t(q, c, p):
        return calc_t.energy(q, c, p, cell_list=clist_t, ns_mesh=ns)

    def energy_j(q, c, p):
        return calc_j.energy(q, c, p, cell_list=clist_j, ns_mesh=ns)

    args = [_t(a) for a in (charges, cell, positions)]
    blob = export_step(energy_t, *args, with_grad=2)
    assert not deploy._calls_tpme(blob)
    e, g = load_step(blob)(*args)
    p = args[2].clone().requires_grad_()
    e_ref = energy_t(args[0], args[1], p)
    (g_ref,) = torch.autograd.grad(e_ref, p)
    e_ref = e_ref.detach()
    assert abs(float(e) - float(e_ref)) <= 1e-12 * abs(float(e_ref))
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=0, atol=1e-12)
    e_j, g_j = jax.jit(jax.value_and_grad(energy_j, argnums=2))(
        *[jnp.asarray(a) for a in (charges, cell, positions)]
    )
    assert abs(float(e) - float(e_j)) <= 1e-10 * abs(float(e_j))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0, atol=1e-10)


def test_export_shape_mismatch_raises(ewald_artifact):
    blob, _, _, (q, cell, positions, dist) = ewald_artifact
    restored = load_step(blob)
    with pytest.raises(ValueError, match="shape mismatch"):
        restored(q[:-2], cell, positions[:-2], dist)


def test_export_multi_platform_needs_a_card(ewald_artifact):
    """Two platforms: with no card, asking for ``cuda`` raises (no CPU-only
    artifact in its place)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_kernels_cuda.py "
                    "(test_export_step_for_two_platforms) covers it")
    _, potentials_t, _, args = ewald_artifact
    with pytest.raises(RuntimeError, match="cuda"):
        export_step(potentials_t, *args, platforms=("cpu", "cuda"))
    with pytest.raises(ValueError, match="platforms"):
        export_step(potentials_t, *args, platforms=("cpu", "tpu"))


def test_aligned_step_exports_through_the_plain_kernels(monkeypatch):
    """The aligned MD step (kernels A, B and C) exported with its gradient
    for the CPU: the export traces each op's plain version once, the program
    holds none of the ops, and it reproduces the eager step."""
    rng = np.random.default_rng(11)
    box, ns = 12.8, (32, 32, 32)  # 4 cells of 3.2 Å a side: one mesh tile each
    positions = torch.tensor(rng.uniform(0, box, (200, 3)))
    q = rng.normal(size=(200, 1))
    charges, cell = torch.tensor(q - q.mean()), torch.eye(3, dtype=torch.float64) * box
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), mesh_spacing=0.4)
    fp = tpt.MDFastPath.create(calc, positions, cell, 3.0, ns, mesh_impl="aligned")
    assert fp.mesh_impl == "aligned"
    rows = fp.bucket(positions)
    calls = {}
    for name in ("spread_fwd", "spread_bwd", "window"):
        plain = kernels.PLAIN_VERSIONS[name]

        def counted(*args, _plain=plain, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*args, **kwargs)

        monkeypatch.setitem(kernels.PLAIN_VERSIONS, name, counted)

    def energy(r, c):
        return fp.energy(charges, c, r)

    program = deploy._trace(deploy._Step(energy, (0, 1)), (rows, cell), plain=True)
    assert calls == {"spread_fwd": 1, "spread_bwd": 1, "window": 1}
    assert not [n for n in program.graph.nodes if deploy._is_tpme(n)]
    e, (g_rows, g_cell) = program.module()(rows, cell)
    r, c = rows.clone().requires_grad_(), cell.clone().requires_grad_()
    e_ref = energy(r, c)
    g_ref = torch.autograd.grad(e_ref, (r, c))
    e_ref = e_ref.detach()
    assert abs(float(e) - float(e_ref)) <= 1e-12 * abs(float(e_ref))
    for got, ref in zip((g_rows, g_cell), g_ref):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-12)


def test_md_engine_without_the_library(md_engine):
    """``examples/19_deployment_md_loop.py`` with the port: the exported
    float64 energy + force step drives 100 MD steps in an engine that cannot
    import the library; its trajectory is the library's own (≤ 1e-10)."""
    energy, rows = md_engine["energy"], md_engine["rows"]
    velocity = torch.zeros_like(rows)
    for _ in range(100):
        r = rows.clone().requires_grad_()
        (g,) = torch.autograd.grad(energy(r), r)
        velocity -= 1e-3 * g
        rows = rows + 1e-3 * velocity
    _engine_output(md_engine)
    final = np.load(md_engine["workdir"] / "rows_final.npy")
    err = float(np.max(np.abs(final - rows.numpy())))
    assert err <= 1e-10, err


def test_export_cross_process(md_engine):
    """The artifact runs in a process that cannot import the port (nor the
    JAX package): ``torch.export.load`` alone, the step's energy and
    gradient as in this process."""
    assert not deploy._calls_tpme(md_engine["blob"])
    energy, rows = md_engine["energy"], md_engine["rows"]
    r = rows.clone().requires_grad_()
    e_ref = energy(r)
    (g_ref,) = torch.autograd.grad(e_ref, r)
    e_ref = e_ref.detach()
    e_engine = float(_engine_output(md_engine).strip())
    assert e_engine == pytest.approx(float(e_ref), rel=1e-13)
    np.testing.assert_allclose(np.load(md_engine["workdir"] / "g0.npy"), g_ref.numpy(),
                               rtol=0, atol=1e-12)


def _cuda_artifact(torch_version: str) -> bytes:
    """The members of a CUDA artifact (empty program and library) with what
    its library was built for."""
    import io
    import json
    import zipfile

    buffer = io.BytesIO()
    with zipfile.ZipFile(buffer, "w") as archive:
        archive.writestr(deploy._INDEX, json.dumps(["cuda"]))
        archive.writestr("cuda.pt2", b"")
        archive.writestr(deploy.LIBRARY, b"")
        archive.writestr(deploy.LIBRARY_INFO, json.dumps(
            {"torch": torch_version, "arch": "sm_90a"}))
    return buffer.getvalue()


def test_cuda_artifact_checks_what_its_library_was_built_for():
    """A CUDA artifact carries its op library: ``load_step`` refuses it under
    another torch version, and without a card, each with an error that says
    so, before it loads anything."""
    with pytest.raises(RuntimeError, match="built for torch 0.0.0"):
        load_step(_cuda_artifact("0.0.0"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            load_step(_cuda_artifact(torch.__version__))


#: a process with ``torch`` alone: the torch-only recipe of ``deploy``'s
#: docstring on ``step.zip``, the step at ``rows.npy`` / ``cell.npy``
TORCH_ONLY = BAN.split("step = ")[0] + (
    "import tempfile, zipfile\n"
    "with zipfile.ZipFile(sys.argv[1] + '/step.zip') as archive:\n"
    "    library, program = archive.read('tpme_ops.so'), archive.read('cuda.pt2')\n"
    "with tempfile.NamedTemporaryFile(suffix='.so') as f:\n"
    "    f.write(library)\n"
    "    f.flush()\n"
    "    torch.ops.load_library(f.name)\n"
    "step = torch.export.load(io.BytesIO(program)).module()\n"
    "rows, cell = (torch.tensor(np.load(sys.argv[1] + f'/{x}.npy')).cuda() for x in ('rows', 'cell'))\n"
    "torch.ops.tpme.reset_launch_counts()\n"
    "e, (g, _) = step(rows, cell)\n"
    "torch.cuda.synchronize()\n"
    "print(float(e), list(torch.ops.tpme.launch_counts()))\n"
)


@pytest.mark.cuda
def test_cuda_step_runs_in_a_torch_only_engine(tmp_path):
    """On a card: the float32 aligned MD step exported for CUDA runs in a
    process that has ``torch`` alone (the artifact's op library, no module
    of the port): kernels A, B and C once each, the energy of this
    process's run of the same program."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the artifact's kernels run on the card")
    from torchpme_tpu_torch import kernels

    rng = np.random.default_rng(11)
    f32 = dict(dtype=torch.float32, device="cuda")
    positions = torch.tensor(rng.uniform(0, 12.8, (200, 3)), **f32)
    q = rng.normal(size=(200, 1))
    charges, cell = torch.tensor(q - q.mean(), **f32), torch.eye(3, **f32) * 12.8
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=1.0), mesh_spacing=0.4)
    fp = tpt.MDFastPath.create(calc, positions, cell, 3.0, (32, 32, 32), mesh_impl="aligned")
    rows = fp.bucket(positions)
    blob = export_step(lambda r, c: fp.energy(charges, c, r), rows, cell, with_grad=(0, 1))
    (tmp_path / "step.zip").write_bytes(blob)
    np.save(tmp_path / "rows.npy", rows.cpu().numpy())
    np.save(tmp_path / "cell.npy", cell.cpu().numpy())
    run = subprocess.run([sys.executable, "-I", "-c", TORCH_ONLY, str(tmp_path)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, check=False)
    assert run.returncode == 0, run.stderr[-2000:]
    e_engine, counts = run.stdout.strip().splitlines()[-1].split(" ", 1)
    counts = dict(zip(kernels.COUNTER_NAMES, eval(counts)))
    assert {k: v for k, v in counts.items() if v} == {"spread_fwd": 1, "spread_bwd": 1,
                                                      "window": 1}
    e, _ = load_step(blob)(rows, cell)
    assert float(e_engine) == pytest.approx(float(e), rel=1e-6)
