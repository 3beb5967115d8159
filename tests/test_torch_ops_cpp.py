"""The ``tpme::`` ops' C++ host layer (``torchpme_tpu_torch/csrc/tpme_ops.cpp``)
on the CPU: its host part (the CUDA section compiled out) is built once for
the module and loaded by a process that imports ``torch`` alone, which
reports the ops' schemas, what their Meta kernels give, and the parameter
structs the C++ builds for the kernels.  They are held to the Python side of
this process: the schemas it defines where no library is loaded, its fake
kernels, and the structs the port built in Python before its host layer moved
to C++ (``tests/torch_kernel_params.py``), byte for byte.  Skips where no C++
compiler is found."""

import ctypes
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_kernel_params as kp

import torchpme_tpu_torch as tpt
from torchpme_tpu_torch import kernels
from torchpme_tpu_torch.ops import mesh_kernels  # noqa: F401  (registers the ops' fakes)
from torchpme_tpu_torch.ops import rspace_cells as rc
from torchpme_tpu_torch.ops import rspace_cells_dipole as rcd
from torchpme_tpu_torch.ops import spread_fused as sf

pytestmark = pytest.mark.skipif(kernels.host_compiler() is None,
                                reason="no C++ compiler to build csrc/tpme_ops.cpp")

F32, F64, I32 = "float32", "float64", "int32"

# -- Meta kernels: each op at the main path's shapes and at the card tests' edges


def _t(shape, dtype=F32):
    return {"tensor": list(shape), "dtype": dtype}


def _window_case(grid, n_ch=1, table=((0,), (1,), (1.0,), (1.0,), False), weights=False,
                 split=False):
    nx, ny, nz, cap = grid
    kinds, exponents, smearings, prefactors, direct = table
    return ("window", [
        _t((nx, ny, nz, 3, cap)), _t((nx, ny, nz, cap, n_ch)), _t((nx, ny, nz, cap)),
        _t((14, 3)), _t((3, 3)), _t((len(kinds),), F64) if weights else None,
        list(kinds), list(exponents), list(smearings), list(prefactors), direct, 5.0,
        _t((nx, ny, nz, cap, n_ch)) if split else None,
    ])


def _dipole_case(grid, split=False, smearing=1.0):
    nx, ny, nz, cap = grid
    return ("window_dipole", [
        _t((nx, ny, nz, 3, cap)), _t((nx, ny, nz, cap, 3)), _t((nx, ny, nz, cap)), _t((14, 3)),
        _t((nx, ny, nz, cap, 3)) if split else None, smearing, 1.0, 5.0,
    ])


def _spread_cases(geometry, method, n_ch):
    nx, ny, nz, _, _, _, n_tiles, slots, _ = geometry
    nb = n_tiles * slots
    return [
        ("spread_fwd", [_t((nb, 3)), _t((nb, n_ch)), list(geometry), method]),
        ("spread_bwd", [_t((nb, 3)), _t((nb, n_ch)), _t((n_ch, nx, ny, nz)), list(geometry),
                        method]),
    ]


def _mesh_cases(lead, ns, nodes, k, n_ch):
    t = (ns[0] // 8) * (ns[1] // 8)
    arrays = [_t((*lead, t, k), I32)] * 3 + [_t((*lead, t, k, 3, nodes))]
    dw = _t((*lead, t, k, 3, nodes))
    q, nu = _t((*lead, t, n_ch, k)), _t((*lead, t, 3, k))
    mesh, mesh1 = _t((*lead, n_ch, *ns)), _t((*lead, 1, *ns))
    rest = [list(ns), nodes]
    return [
        ("mesh_spread", [*arrays, q, *rest]),
        ("mesh_spread_dipole", [*arrays, dw, nu, *rest]),
        ("mesh_gather", [*arrays, mesh, *rest]),
        ("mesh_wgrad", [*arrays, q, mesh, *rest]),
        ("mesh_gather_wgrad", [*arrays, q, mesh, *rest]),
        ("mesh_gather_dipole", [*arrays, dw, mesh1, *rest]),
        ("mesh_wgrad_dipole", [*arrays, dw, nu, mesh1, *rest]),
        ("mesh_gather_wgrad_dipole", [*arrays, dw, nu, mesh1, *rest]),
    ]


#: the 102k main path (a 16 × 16 × 20 cell grid of capacity 24 on the 128³
#: mesh, 5 nodes), and the card tests' edges: 3 channels, a tall mesh, the
#: fused geometry, 1 to 7 nodes, a Combined of four terms, the split and
#: mui variants, a batch of 32 systems
META_CASES = [
    *_spread_cases((128, 128, 128, 5, 13, 2, 256, 480, 20), "Lagrange", 1),
    *_spread_cases((32, 32, 288, 4, 12, 1, 16, 36, 3), "P3M", 3),
    *_spread_cases((64, 64, 64, 7, 14, 0, 64, 64, 1), "Lagrange", 2),
    _window_case((16, 16, 20, 24)),
    _window_case((3, 3, 3, 250), n_ch=4),
    _window_case((16, 16, 20, 24), table=((0, 1, 1, 1), (1, 3, 5, 6), (1.0,) * 4, (1.0,) * 4,
                                          False), weights=True),
    _window_case((4, 16, 20, 40), split=True, n_ch=2),
    _dipole_case((16, 16, 20, 24)),
    _dipole_case((3, 3, 3, 72), split=True, smearing=None),
    *_mesh_cases((), (128, 128, 128), 5, 64, 1),
    *_mesh_cases((), (32, 32, 40), 1, 24, 3),
    *_mesh_cases((32,), (16, 16, 16), 7, 40, 2),
]

# -- parameter structs: the main path and the family's edges -----------------------


def _spread_param_cases():
    cases = [((128, 128, 128, 5, 13, 2, 256, 480, 20), "Lagrange", 1)]
    for nodes in range(1, 6):  # P3M 1..5 at the aligned and the fused geometry
        extent, lpad = sf.aligned_geometry(nodes)
        cases.append(((32, 32, 32, nodes, extent, lpad, 16, 96, 4), "P3M", 1))
        cases.append(((64, 64, 288, nodes, 8 + nodes - 1, 0, 64, 64, 1), "P3M", 2))
    for nodes in range(3, 8):  # Lagrange 3..7, 1 and 3 channels, and 40 (kernel B's 32)
        extent, lpad = sf.aligned_geometry(nodes, 1)
        for n_ch in (1, 3, 40):
            cases.append(((32, 32, 40, nodes, extent, lpad, 16, 72, 3), "Lagrange", n_ch))
    return cases


def _window_param_cases():
    rng = np.random.default_rng(16)
    smearings = [1.0, 0.75, 0.9, *rng.uniform(0.3, 3.0, 6).tolist()]
    cutoffs = [5.0, 3.0, 4.4, *rng.uniform(2.0, 8.0, 3).tolist()]
    pots = []
    for i, s in enumerate(smearings):
        pots.append(tpt.CoulombPotential(smearing=s, prefactor=[1.0, 14.399645][i % 2]))
        for p in range(1, 7):
            pots.append(tpt.InversePowerLawPotential(exponent=p, smearing=s,
                                                     prefactor=float(rng.uniform(0.5, 3.0))))
    for p in range(1, 7):  # direct mode
        pots.append(tpt.InversePowerLawPotential(exponent=p, prefactor=1.0 + p))
    pots.append(tpt.CoulombPotential())
    weights = torch.tensor([1.0, -0.5, 0.25, 2.0], dtype=torch.float64)
    for s in smearings[:3]:  # a Combined of four terms, smeared and direct
        members = [tpt.CoulombPotential(smearing=s), *(
            tpt.InversePowerLawPotential(exponent=p, smearing=s) for p in (3, 5, 6))]
        pots.append(tpt.CombinedPotential(members, initial_weights=weights, smearing=s))
    pots.append(tpt.CombinedPotential(
        [tpt.CoulombPotential(), tpt.InversePowerLawPotential(exponent=6)],
        initial_weights=weights[:2]))
    cases = []
    for i, pot in enumerate(pots):
        table = rc.window_table(pot)
        # the grid of the 102k step, of the sharded slab (capacity 40) and of
        # the 3 × 3 × 3 edge grid; 1 to 4 channels (the split variant's
        # struct is the same: its i-side charges only change the launch)
        grid = [(16, 16, 20, 24), (4, 16, 20, 40), (3, 3, 3, 250)][i % 3]
        cases.append((table, cutoffs[i % len(cutoffs)], grid, 1 + i % 4))
    return cases


def _dipole_param_cases():
    rng = np.random.default_rng(17)
    cases = []
    for s in [1.0, 0.75, 0.9, *rng.uniform(0.3, 3.0, 8).tolist(), None]:
        for cutoff, prefactor in ((5.0, 1.0), (3.0, 1.3), (float(rng.uniform(2, 8)), 14.399645)):
            # the 102k dipolar grid, and the edge grid (with or without mui_g:
            # the same struct)
            cases.append((s, prefactor, cutoff, (16, 16, 20, 24) if s else (3, 3, 3, 72)))
    return cases


def _mesh_param_cases():
    cases = []
    for nodes in range(1, 8):
        for n_ch, n_vals in ((1, 1), (2, 2), (3, 3), (40, 40), (1, 3)):  # (1, 3): dipole forms
            for n_sys in (1, 32):
                cases.append(((128, 128, 128), nodes, n_sys, 256, 64, n_ch, n_vals))
    cases.append(((32, 32, 288), 5, 1, 16, 24, 1, 1))
    return cases


# -- the engine: the library loaded by a process with torch alone ----------------------

ENGINE = r"""
import ctypes, json, sys
import torch

path, cases = sys.argv[1], json.loads(sys.stdin.read())
torch.ops.load_library(path)
lib = ctypes.CDLL(path)
out = {"schemas": {}, "meta": [], "params": {}}
for name in cases["names"]:
    out["schemas"][name] = str(getattr(torch.ops.tpme, name).default._schema)


def arg(a):
    if isinstance(a, dict):
        return torch.empty(a["tensor"], dtype=getattr(torch, a["dtype"]), device="meta")
    return a


for name, args in cases["meta"]:
    res = getattr(torch.ops.tpme, name)(*map(arg, args))
    res = res if isinstance(res, tuple) else (res,)
    out["meta"].append([[list(r.shape), str(r.dtype)] for r in res])

I64, F64 = ctypes.c_int64, ctypes.c_double


def build(fn, which, *args):
    size = lib.tpme_host_params_size(which)
    buf, err = ctypes.create_string_buffer(size), ctypes.create_string_buffer(512)
    if fn(*args, buf, err, 512) != 0:
        return "error: " + err.value.decode()
    return buf.raw.hex()


def arr(kind, values):
    return (kind * max(len(values), 1))(*values)


lib.tpme_host_params_size.restype = I64
lib.tpme_host_window_params.argtypes = [ctypes.c_void_p] * 4 + [
    I64, ctypes.c_int, ctypes.c_int, F64, ctypes.c_void_p, I64] + [ctypes.c_void_p] * 2 + [I64]
lib.tpme_host_window_dipole_params.argtypes = [ctypes.c_int, F64, F64, F64] + [
    ctypes.c_void_p] * 3 + [I64]
lib.tpme_host_spread_params.argtypes = [ctypes.c_void_p, ctypes.c_char_p, I64] + [
    ctypes.c_void_p] * 2 + [I64]
lib.tpme_host_mesh_params.argtypes = [ctypes.c_void_p] + [I64] * 6 + [ctypes.c_void_p] * 2 + [I64]
spread = [build(lib.tpme_host_spread_params, 0, arr(I64, g), m.encode(), n)
          for g, m, n in cases["spread"]]
window = [build(lib.tpme_host_window_params, 1, arr(I64, k), arr(I64, e), arr(F64, s),
                arr(F64, p), len(k), int(w), int(d), c, arr(I64, grid), n)
          for k, e, s, p, w, d, c, grid, n in cases["window"]]
dipole = [build(lib.tpme_host_window_dipole_params, 2, int(s is not None), s or 0.0, p, c,
                arr(I64, grid)) for s, p, c, grid in cases["dipole"]]
mesh = [build(lib.tpme_host_mesh_params, 3, arr(I64, ns), *rest) for ns, *rest in cases["mesh"]]
out["params"] = {"spread": spread, "window": window, "dipole": dipole, "mesh": mesh}
out["torch_modules"] = sorted(m for m in sys.modules if m.startswith("torchpme"))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cpp():
    """What the C++ library gives for every case, from a process with
    ``torch`` alone (the host part is built once per source hash)."""
    built = kernels.build_library(cuda=False)
    window = [(list(t[1]), list(t[2]), list(t[3]), list(t[4]), t[0] is not None, bool(t[5]),
               c, list(grid), n) for t, c, grid, n in _window_param_cases()]
    cases = {
        "names": sorted(kernels.op_schemas()),
        "meta": META_CASES,
        "spread": [(list(g), m, n) for g, m, n in _spread_param_cases()],
        "window": window,
        "dipole": [(s, p, c, list(grid)) for s, p, c, grid in _dipole_param_cases()],
        "mesh": [(list(ns), *rest) for ns, *rest in _mesh_param_cases()],
    }
    run = subprocess.run([sys.executable, "-I", "-c", ENGINE, str(built.path)],
                         input=json.dumps(cases), capture_output=True, text=True, timeout=300,
                         check=False)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout)


def test_engine_imports_nothing_of_the_port(cpp):
    assert cpp["torch_modules"] == []


def test_schemas_equal_the_python_definitions(cpp):
    """(a) Every op the C++ library defines has the schema the Python side
    defines where no library is loaded (both read ``csrc/tpme_ops.h``), and
    the kernel ops are the twelve with plain versions."""
    kernels.define_ops()
    assert sorted(cpp["schemas"]) == sorted(kernels.op_schemas())
    for name, schema in cpp["schemas"].items():
        assert schema == str(getattr(torch.ops.tpme, name).default._schema)
        assert "plain" not in schema
    assert set(kernels.PLAIN_VERSIONS) == set(kernels.op_schemas()) - {
        "launch_counts", "reset_launch_counts", "window_plan", "window_dipole_plan",
        "override_z_chunk"}


@pytest.mark.parametrize("index", range(len(META_CASES)),
                         ids=[f"{name}-{i}" for i, (name, _) in enumerate(META_CASES)])
def test_meta_kernels_equal_the_python_fakes(cpp, index):
    """(b) Each op's Meta kernel gives the shapes and dtypes of the Python
    fake on the same meta operands."""
    name, args = META_CASES[index]
    meta = [torch.empty(a["tensor"], dtype=getattr(torch, a["dtype"]), device="meta")
            if isinstance(a, dict) else a for a in args]
    res = getattr(torch.ops.tpme, name)(*meta)
    res = res if isinstance(res, tuple) else (res,)
    assert [[list(r.shape), str(r.dtype)] for r in res] == cpp["meta"][index]


def _hex(struct) -> str:
    return bytes(struct).hex()


def test_spread_params_equal_the_python_builder(cpp):
    """(c) Kernels A and B: the weight tables (P3M 1–5 nodes, Lagrange 3–7)
    and the z chunks, byte for byte."""
    for (g, m, n), got in zip(_spread_param_cases(), cpp["params"]["spread"], strict=True):
        assert got == _hex(kp.spread_params(g, m, n)), (g, m, n)


def test_window_params_equal_the_python_builder(cpp):
    """(c) Kernel C: Coulomb and 1/r^1..6 terms smeared and direct, Combined
    of four members, several cutoffs, 1–4 channels, byte for byte (each
    constant rounded to float32 from the expressions of ``ops/math.py``;
    CPython's ``math.gamma`` is not libm's ``tgamma`` at p = 1 and 5)."""
    for (t, c, grid, n), got in zip(_window_param_cases(), cpp["params"]["window"], strict=True):
        assert got == _hex(kp.window_params(t, c, grid, n)), (t, c, grid, n)


def test_window_dipole_params_equal_the_python_builder(cpp):
    """(c) Kernel G, smeared and direct, byte for byte."""
    for (s, p, c, grid), got in zip(_dipole_param_cases(), cpp["params"]["dipole"], strict=True):
        assert got == _hex(kp.window_dipole_params(s, p, c, grid)), (s, p, c)


def test_mesh_params_equal_the_python_builder(cpp):
    """(c) Kernels D, E and F at 1–7 nodes, charge and dipole forms, one
    system and a batch, byte for byte (E and F's z chunk included)."""
    for case, got in zip(_mesh_param_cases(), cpp["params"]["mesh"], strict=True):
        assert got == _hex(kp.mesh_params(*case)), case


def test_params_refuse_what_the_kernels_do_not_take(cpp):
    """The C++ builders raise where the Python ones did: a weight method
    without a table, too many nodes."""
    built = kernels.build_library(cuda=False)
    probe = (
        "import ctypes, sys, torch\n"
        "torch.ops.load_library(sys.argv[1])\n"
        "lib = ctypes.CDLL(sys.argv[1])\n"
        "buf, err = ctypes.create_string_buffer(1024), ctypes.create_string_buffer(512)\n"
        "for g, m in (([32, 32, 32, 9, 17, 4, 16, 8, 1], b'Lagrange'),\n"
        "             ([32, 32, 32, 2, 9, 0, 16, 8, 1], b'Lagrange'),\n"
        "             ([32, 32, 32, 5, 13, 2, 16, 8, 1], b'Hermite')):\n"
        "    g = (ctypes.c_int64 * 9)(*g)\n"
        "    print(lib.tpme_host_spread_params(g, m, ctypes.c_int64(1), buf, err,\n"
        "                                      ctypes.c_int64(512)), err.value.decode())\n"
    )
    run = subprocess.run([sys.executable, "-I", "-c", probe, str(built.path)],
                         capture_output=True, text=True, timeout=120, check=False)
    assert run.returncode == 0, run.stderr[-2000:]
    lines = run.stdout.splitlines()
    assert lines[0].startswith("1 the spread kernels take at most 8 nodes")
    assert lines[1].startswith("1 `interpolation_nodes` is 2 but only values from 3 to 7")
    assert lines[2].startswith("1 method 'Hermite' is not supported")
    assert ctypes.sizeof(kp.SpreadParams) == 564
