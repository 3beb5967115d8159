#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card: python3 chip_smoke.py

Drives the port's main paths at the 102k-atom water-density box (point
charges, PME and P3M: the MD step and the per-atom call, also over a cell
list; point dipoles: the same two; Ewald at 12,000 atoms) through its
hand-written CUDA kernels, and fails (non-zero exit, no result line) if any
phase fails:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles ``torchpme_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernels: each of the seven kernels against its plain PyTorch version,
   float32, at the 102k shapes (the window C also on a 3×3×3 cell grid with
   a capacity above 32, and at capacity 250 with four channels, and two of
   its launches bitwise equal in d_pc and d_q; the spread A and its VJP B
   also at nz = 288 and at the fused mode's geometry (the per-atom call's
   stencil-start bucketing, lpad 0), B also at three channels and two of its
   launches bitwise equal; the tile kernels D, E, F also at three channels and
   at the dipolar shapes: 6 nodes, D's dipole form for its two launches (the
   spread of the dipoles and of the gather's mesh cotangent), the dipole
   forms of E and F, each slot read once, and E + F from one launch bitwise
   equal over two launches; D, E, F also at P3M's 1 and 2 nodes with the P3M
   tables, A and B with the P3M tables, and C's unsmeared variant (direct
   mode) at the 102k window; the dipolar window G in smeared and direct mode
   and with separate i-side dipoles, and on the 3×3×3 cell grid at
   capacities 72 and 250 with and without them, with two launches bitwise
   equal in d_pc, d_mu, d_mui and its outputs against float64), with
   CUDA-event times of both (launches queued on the card, so that the host's
   pace does not enter) and the least time the card could take (bytes over
   memory rate, operations over the float32 rate);
4. the MD step (``MDFastPath`` in aligned mode: kernels A, B, C): float32
   kernels vs the plain float64 step (energy, forces, cell gradient), the
   launch counts and ms/step of both paths; then in fused mode (A and B at
   the stencil-start geometry, C; none of D, E, F), the same checks, with
   the tiled mode's ms/step (D, E, F) timed in the same turns;
5. the per-atom call (``PMECalculator(...)(charges, cell, positions,
   neighbor_indices, neighbor_distances)`` on the tiled mesh: kernels D, E,
   F forward and backward): potentials, forces, charge and cell gradients
   vs the plain float64 call, ``energy`` ≡ ``sum(pot·q)`` ≡ the MD step's
   energy, the launch counts, and ms per forward and forward+backward;
6. accuracy: the 1536-atom system of tools/validate_accuracy.py in float32,
   aligned mode (32³ mesh), tiled and fused mode (64³ mesh), against the JAX
   package's values and tools/ground_truth.npz (tiled, fused: the 1e-4 bar);
7. the dipolar MD step (``MDFastPathDipole`` over ``PMECalculatorDipole``:
   kernel G for the window, D forward and E + F backward for the mesh) at
   the system of tools/bench_family.py: float32 kernels vs the plain float64
   step (energy, forces, fields ``dE/dmu``, cell gradient, the cell gradient
   split into its window and mesh parts), launch counts and ms/step of both
   paths;
8. the dipolar per-atom call (``PMECalculatorDipole(...)(dipoles, cell,
   positions, neighbor_indices, neighbor_vectors)`` on the tiled mesh) with
   its gradients vs the plain float64 call, ``sum(pot·mu)`` ≡ ``energy`` ≡
   the dipolar MD step's energy, and ms per forward and forward+backward;
9. dipolar accuracy: the 3000-atom oracle of tools/bench_family.py, float32
   mesh PME on the card against the port's float64 dipolar Ewald at
   ``lr_wavelength = smearing / 2``, beside the JAX package's two energies;
11. the P3M MD step (``MDFastPath`` over ``P3MCalculator``: 5 nodes, the
    128³ mesh; aligned by ``auto``, then fused and tiled, forced): float32
    kernels vs the plain float64 step, launch counts and ms/step;
12. the P3M per-atom call on the tiled mesh (kernels D, E, F) vs the plain
    float64 call, ms per forward and forward+backward;
13. Ewald at 12,000 atoms: ``MDFastPathEwald`` (kernel C) and the
    ``EwaldCalculator`` per-atom call, float32 vs float64;
14. accuracy at 1536 atoms against tools/ground_truth.npz: float32 P3M
    (tiled, 64³) and float32 Ewald at the truth's own parameters, and P3M
    at 1 and 2 nodes against its float64 plain energy;
15. the per-atom call over a cell list (``calc(..., cell_list=clist)``) vs
    the neighbor-list call in float64, and the direct-mode energy through
    kernel C's unsmeared variant vs its float64 plain version;
16. the potential family at 102k: the MD step (aligned: kernels A, B and
    C through its pair-term table) over ``InversePowerLawPotential``
    p = 3 and 6 at the monopole-tuned parameters and over a learnable
    ``CombinedPotential`` (Coulomb + 1/r^6), float32 kernels vs the plain
    float64 step (energy, forces, cell gradient, and dE/dw), ms/step of
    both paths; in phase 3, C's variants (p = 3, p = 6, Combined, direct
    1/r^6) against their plain versions and float64, with their bounds;
17. the Combined per-atom call over the neighbor list (D, E, F) with its
    gradients and dE/dw vs the plain float64 call;
18. the extras tile table (``MDFastPath.create(extras_impl="tiled")``: the
    spill rows through a refresh and kernel D, E + F backward) against the
    scatter, at the main path's spills and at a forced >= 512, wall and
    device ms per step and agreement;
19. the port's tuning module (``torchpme_tpu_torch.tuning``) in float32:
    ``tune_over_cutoffs(tune_pme)`` on the 102k box (cutoffs 4.5, 5, 5.5 Å,
    4–6 nodes, 64³–256³ meshes, accuracy 1e-4; every timed candidate with
    its mesh backend, error bound and seconds per forward+backward, the
    pick, D, E and F's launches, the tuner's smearing at 5 Å against
    bench.py's formula, the pick in float32 against float64 plain),
    ``tune_p3m`` at 102k, ``tune_ewald`` at 12,000 atoms, ``tune_pme`` on
    the 1536-atom box with its force error against tools/ground_truth.npz,
    the dipolar tuners at 343 dipoles (D's, E's and F's dipole forms), and
    one labeled ``atomistic.PMECalculator`` call at 102k against the plain
    calculator (float32 within the kernel bar, float64 bitwise);
10. the ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Phases 11–18 run between 6 and 7, phase 19 after 9.

With ``--profile`` it also traces the 102k paths (the MD step in aligned,
fused and tiled mode) with ``torch.profiler``
and prints, for each, the device time and the number of device events per
call and the kernels that take most of it, times kernel A's z chunk
(``ops/spread_fused.py:z_chunk``), kernel B's (``bwd_z_chunk``) and kernels E
and F's (``ops/mesh_kernels.py:gather_z_chunk``) beside the neighbouring
choices, B, E and F also as one thread a slot reading the mesh, and counts
the atomic instructions of each kernel in the built library's SASS
(``cuobjdump -sass``).

``--cell-split TREE`` prints only the dipolar cell-gradient split of phase 7
for the package of another checkout (the parent commit, say), so that two
commits compare on one card.

Imports torch, numpy, scipy (through the port's neighbor list) and the
port; nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

N_ATOMS = 102_000
CUTOFF = 5.0
ACCURACY = 1e-4
NODES = 5
NS_MESH = (128, 128, 128)
CHAIN = 20  # MD steps per timed chain, one sync per chain
CALL_REPEATS = 5  # per-atom calls per timed chain
# clock cycles of the card's spin per second of host time it must cover (the
# H100 SXM's top SM clock, 1.98 GHz, rounded up: a slower clock spins longer)
SPIN_CYCLES_PER_S = 2.0e9
KERNEL_TOL = 1e-5  # kernel vs plain version, max abs error over max |plain|
# kernel C's energy and kernel A's density: float32 sums of the same terms in
# another order, ~1e-7 of max in every run so far
SUM_TOL = 1e-6
# the edge shapes of kernels C and A: a 3x3x3 cell grid whose capacity is
# above one warp (dense box, cell edges just over the cutoff), and a mesh of
# 288 z cells, whose whole tile field the first kernel A could not hold
EDGE_GRID_ATOMS = 1500
EDGE_CAPACITY = 250  # and 4 channels: kernel C stages one x plane of offsets a pass
EDGE_NZ = 288
# d_offs of a window totals every j-side force of a neighbor offset, terms
# that cancel (1/d^4 ones to ~1e-3 of their size for dipoles): the plain
# version's float32 sum carries that error (the JAX package's own bar,
# tests/ops/test_window_dipole_pallas.py:57)
D_OFFS_TOL = 5e-4

# published peaks of the H100 SXM (NVIDIA's data sheet): the yardstick of
# every bound below, whatever power limit this card runs at
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# tools/validate_accuracy.py system.  The JAX package's float32 steps on the
# CPU give these energies (tests/test_torch_md.py pins both): aligned mode at
# the 32³ mesh (the finest it allows in this box), tiled mode at the 64³ mesh
# of mesh_spacing=1.2
GT_N, GT_SMEARING, GT_NS = 1536, 1.2836, (32, 32, 32)
GT_JAX_ENERGY = -32.388634
GT_TILED_NS, GT_MESH_SPACING = (64, 64, 64), 1.2
GT_TILED_JAX_ENERGY = -32.237873
GT_FORCE_BAR = 1e-4  # ROADMAP's force accuracy, tools/validate_accuracy.py:113

# P3M (tools/bench_family.py:choose_p3m_parameters gives the 102k box the main
# path's geometry: 5 nodes, spacing 2·box/(2^7 - 1) = 1.5852, the 128^3 mesh;
# p3m_spacing below); kernels D, E, F also at its 1 and 2 nodes, against their
# plain versions at this bar; and the JAX package's float64 P3M force error on
# the 1536-atom system at 64^3 (5 nodes, tiled), measured on the CPU, printed
# beside the port's float32
P3M_SMALL_NODES = (1, 2)
P3M_MESH_TOL = 1e-6
P3M_GT_JAX_F64_FORCE = 2.69e-6
# Ewald at 12,000 atoms (bench.py:build_system(12_000): water density, box
# 49.32 A) at the main path's smearing and cutoff; its lr_wavelength is
# ewald_lr(): the largest whose error bound meets ACCURACY, rounded down
EWALD_N, EWALD_SMEARING = 12_000, 1.2826

# the dipolar system of tools/bench_family.py:177-222: the 102k box with
# normal dipoles (seed 1) at the monopole-tuned smearing and 128^3 mesh, and
# its 3000-atom accuracy oracle.  The JAX package's float64 energies of the
# oracle on the CPU (tests/test_torch_dipole_md.py pins both): mesh PME, and
# the dipolar Ewald sum converged at lr_wavelength = smearing / 2
DIPOLE_NODES = 6
DIPOLE_GT_N, DIPOLE_GT_NS = 3000, (64, 64, 64)
DIPOLE_GT_JAX_PME = 1113.8367343731925
DIPOLE_GT_JAX_EWALD = 1114.2225485046647
DIPOLE_GT_BAR = 5e-4  # mesh PME vs converged Ewald, relative energy
# float32 step vs float64: the cell gradient sums per-atom forces of up to
# ~1e5 (closest pairs 0.04 A apart under 1/d^4) whose float32 rounding alone
# is ~1e-4 of the ~1e3 cell gradient
DIPOLE_CELL_TOL = 5e-4
# kernel G's d_offs against float64: double sums of float32 per-offset sums
# (the float32 plain version is 1.2e-4 off at the 102k window, up to 6e-4 on
# the 3x3x3 grid)
G_D_OFFS_F64_TOL = 1e-4
# FLOPs of kernel G per pair inside the cutoff: 46 (smeared) or 8 (direct)
# for (B, C, C'/d) with expf and rsqrtf as one each, and 72 for the three
# contractions, the energy and the twelve i- and j-side cotangent terms
G_PAIR_FLOP = {"smeared": 118, "direct": 80}

# kernel C's operations per pair inside the cutoff, worked out from its pair
# math (csrc/window.cu, rsqrtf and expf as one each): 21 beside the pair math
# (the charge product, the energy in double, the gradient and d_q), and per
# 1/r^p term the smeared math (p = 1: the shared Gaussian, the A&S erfc
# polynomial, V and V'/d; even p: no erfc, a polynomial of z) or the direct
# one (V = P d^-p, V'/d = -p V/d^2), and in a combination 4 more a term (two
# weight products, the member's energy product and its double add)
C_PAIR_COMMON = 21
C_TERM_FLOP = {"smeared": {1: 19, 2: 10, 3: 23, 4: 13, 5: 26, 6: 16},
               "direct": {1: 5, 2: 5, 3: 6, 4: 6, 5: 7, 6: 7}}
C_MEMBER_FLOP = 4
# the potential family at 102k (tools/bench_family.py:159-174: 1/r^3 at the
# monopole-tuned smearing, 5 nodes, 128^3; the same for 1/r^6), and a
# learnable CombinedPotential of Coulomb and 1/r^6 (initial weights below);
# the Combined weights' float32 gradient is held to float64 at this bar
COMBINED_WEIGHTS = (1.0, -0.5)
WEIGHT_GRAD_TOL = 1e-5
# the chained steps of the family phases move the rows by this times the
# gradient: 0, so the rows stay where they are (forces of 1/r^6 reach 1e14
# at the closest pairs of the random box, and any step would carry atoms out
# of their cells), while each step still waits on the last one's gradient
FAMILY_CHAIN_STEP = 0.0
# the extras tile table against the scatter: the main path's spills and a
# forced >= 512 (an unbalanced cell list at a smaller capacity); float32
# energy and forces agree to EXTRAS_TOL, the float64 plain steps to
# EXTRAS_F64_TOL (the same function), and each float32 step keeps PERF.md
# section 2's bars against its float64 step
EXTRAS_FORCED = 512
EXTRAS_TOL = 1e-6
EXTRAS_F64_TOL = 1e-10
# the tuning phase: tune_over_cutoffs(tune_pme) on the 102k box over these
# cutoffs and this grid (4-6 nodes, 64^3-256^3 meshes) at ACCURACY; tune_ewald
# at 12k over ns 16-22 (the bound first meets 1e-4 at 19); the dipolar tuners
# at DIPOLE_TUNE_SIDE^3 dipoles, cutoff DIPOLE_TUNE_CUTOFF
TUNE_CUTOFFS = (4.5, 5.0, 5.5)
TUNE_GRID = dict(nodes_lo=4, nodes_hi=6, mesh_lo=6, mesh_hi=8)
EWALD_TUNE_GRID = dict(ns_lo=16, ns_hi=22)
DIPOLE_TUNE_SIDE, DIPOLE_TUNE_CUTOFF = 7, 4.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def water_box(n_atoms: int, seed: int = 0):
    """bench.py:build_system without the neighbor list."""
    rng = np.random.default_rng(seed)
    box = float((n_atoms / 0.1) ** (1 / 3))
    positions = rng.uniform(0.0, box, (n_atoms, 3))
    base = np.tile([-0.84, 0.42, 0.42], n_atoms // 3 + 1)[:n_atoms]
    base -= base.mean()
    return positions, base.reshape(-1, 1), np.eye(3) * box


def bench_smearing(charges, cell) -> float:
    """bench.py:choose_parameters in numpy (float64): the smearing whose
    real-space bound at CUTOFF is ACCURACY / 4."""
    charges = np.asarray(charges, dtype=np.float64)
    volume = float(abs(np.linalg.det(np.asarray(cell, dtype=np.float64))))
    prefac = 2 * float((charges**2).sum()) / math.sqrt(charges.shape[0])
    ratio = math.sqrt(-2 * math.log(ACCURACY / 2 / prefac * math.sqrt(CUTOFF * volume)))
    return CUTOFF / ratio


def _cpu(*arrays):
    """float64 CPU tensors of host arrays: the inputs of the port's error
    bounds and smearing estimate, which are host arithmetic here."""
    return [torch.tensor(np.asarray(a, dtype=np.float64)) for a in arrays]


def smearing_for(positions, charges, cell) -> float:
    """The main path's smearing: the port's ``TunerBase.estimate_smearing``
    at ACCURACY and CUTOFF (the formula of bench.py:choose_parameters)."""
    from torchpme_tpu_torch import PMECalculator
    from torchpme_tpu_torch.tuning import TunerBase

    q, c, p = _cpu(charges, cell, positions)
    return TunerBase(q, c, p, CUTOFF, PMECalculator).estimate_smearing(ACCURACY)


def ewald_lr(positions, charges, cell) -> float:
    """lr_wavelength of the 12k Ewald phases: the largest whose bound by the
    port's ``EwaldErrorBounds`` at EWALD_SMEARING and CUTOFF meets ACCURACY
    (bisection; the bound falls as the wavelength does), rounded down to
    1e-2: 2.61 (19^3 k extents)."""
    from torchpme_tpu_torch.tuning import EwaldErrorBounds

    bound = EwaldErrorBounds(*_cpu(charges, cell, positions))
    lo, hi = 0.5, 10.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if float(bound(smearing=EWALD_SMEARING, lr_wavelength=mid, cutoff=CUTOFF)) <= ACCURACY:
            lo = mid
        else:
            hi = mid
    return math.floor(lo * 100) / 100


def dipole_parameters() -> tuple[float, float]:
    """(smearing, mesh spacing) of the dipolar runs: bench.py's values for
    the 102k box, whose spacing 2·box/127 gives the 128³ mesh."""
    positions, charges, cell = water_box(N_ATOMS)
    return smearing_for(positions, charges, cell), 2 * float(cell[0, 0]) / 127


def dipole_oracle_box():
    """``(positions, dipoles, cell)`` of the 3000-atom dipolar accuracy
    oracle, from the same generator as tools/bench_family.py (seed 1, after
    the draw of the 102k dipoles)."""
    rng = np.random.default_rng(1)
    rng.normal(size=(N_ATOMS, 3))
    box = float((DIPOLE_GT_N / 0.1) ** (1 / 3))
    positions = rng.uniform(0, box, (DIPOLE_GT_N, 3))
    return positions, rng.normal(size=(DIPOLE_GT_N, 3)), np.eye(3) * box


def dipole_ewald_oracle(tpt, positions, dipoles, cell, smearing, device) -> float:
    """float64 dipolar Ewald energy of the port at ``lr_wavelength =
    smearing / 2`` over a cell list (explicit structure-factor sums; the
    window's plain version, the kernel being float32 only)."""
    f64 = dict(dtype=torch.float64, device=device)
    ewald = tpt.CalculatorDipole(tpt.PotentialDipole(smearing=smearing),
                                 lr_wavelength=smearing / 2)
    clist = tpt.ops.compute_cell_list(positions, cell, CUTOFF, device=device)
    with torch.no_grad():
        return float(ewald.energy(
            torch.tensor(dipoles, **f64), torch.tensor(cell, **f64),
            torch.tensor(positions, **f64), cell_list=clist,
            ns_kvectors=ewald.get_ns_kvectors(cell), plain=True,
        ))


def dense_grid_box():
    """``(positions, charges, cell)`` of the window's edge shape: 3 cells of
    edge just over the cutoff per axis, ~55 atoms a cell (seed 2)."""
    rng = np.random.default_rng(2)
    box = 3 * (CUTOFF + 0.2)
    q = rng.normal(size=(EDGE_GRID_ATOMS, 1))
    return rng.uniform(0.0, box, (EDGE_GRID_ATOMS, 3)), q - q.mean(), np.eye(3) * box


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def timed_ms(fn, repeats: int) -> float:
    """ms per call of ``repeats`` calls between two CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / repeats


def cuda_ms(fn, repeats: int = 10) -> float:
    """Mean ms per call on the card, after two warm-up calls: ``repeats``
    calls between two CUDA events, queued behind a spin of the card that
    outlasts the host's time to enqueue them, so that the host's pace does
    not enter (a wrapper may take longer on the host than its kernel on the
    card; a call that synchronises is host-paced all the same)."""
    for _ in range(2):
        fn()
    sync()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    sync()
    torch.cuda._sleep(int(min(2.0 * repeats * host_s, 1.0) * SPIN_CYCLES_PER_S))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / repeats


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error over max |ref|)."""
    err = float((got.double() - ref.double()).abs().max())
    return err, err / max(float(ref.double().abs().max()), 1e-30)


def rel_rms(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(torch.sqrt(torch.mean((got - ref) ** 2)) / torch.sqrt(torch.mean(ref**2)))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_flop: float) -> dict:
    """The least time the card could take: every input read once and every
    output written once at the memory rate, or the float32 operations at the
    peak rate, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "flop": int(n_flop)}


def check_kernel(name, source, replaces, run_kernel, run_plain, cost, report,
                 tols=None, shape=None):
    """One kernel against its plain version (same inputs), timed, with its
    bound; appends the entry of the ``kernels`` line to ``report``.  ``tols``
    are per-output bars (default ``KERNEL_TOL``) on the max abs error over
    max |plain|; ``None`` for an output that the caller holds to float64
    instead."""
    got, ref = run_kernel(), run_plain()
    sync()
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    tols = [KERNEL_TOL] * len(errs) if tols is None else tols
    worst = max(r for _, r in errs)
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "max_abs_err": max(a for a, _ in errs), "max_rel_err": worst,
             "ms": cuda_ms(run_kernel), "plain_ms": cuda_ms(run_plain),
             "bound_ms": cost["bound_ms"], "bound_by": cost["bound_by"],
             "library_ms": None}
    emit({"phase": "kernel", **entry, "shape": shape, "bytes": cost["bytes"],
          "flop": cost["flop"], "per_output_rel_err": [r for _, r in errs],
          "per_output_tol": tols})
    for i, ((_, r), tol) in enumerate(zip(errs, tols)):
        if tol is not None and not r <= tol:
            raise AssertionError(f"{name} ({shape}): output {i} kernel vs plain {r:.3e} > {tol}")
    if name not in report:  # a second shape of a kernel is checked, not listed twice
        report[name] = entry


def turns_ms(runs: dict, repeats: int) -> dict:
    """ms per call of each of ``runs`` (name → function): medians over turns
    taken forwards, then backwards, twice (a, b, b, a, a, b, b, a for two),
    after one warm-up each."""
    for fn in runs.values():
        fn()
    order = list(runs) + list(runs)[::-1]
    times = {name: [] for name in runs}
    for name in order + order:
        times[name].append(timed_ms(runs[name], repeats))
    return {name: float(np.median(t)) for name, t in times.items()}


def alternate_ms(run, repeats: int) -> tuple[float, float]:
    """(kernel ms, plain ms) per call of ``run(plain)``, in turns."""
    ms = turns_ms({"kernel": lambda: run(False), "plain": lambda: run(True)}, repeats)
    return ms["kernel"], ms["plain"]


def profile_path(name: str, fn, calls: int = 5) -> None:
    """Device time, device events and wall time per call of ``fn``, and the
    eight kernels that take most of the device time (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    wall_ms = timed_ms(fn, calls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    on_device.sort(key=lambda e: -e.self_device_time_total)
    emit({"phase": "profile", "path": name, "wall_ms_per_call": wall_ms,
          "device_ms_per_call": sum(e.self_device_time_total for e in on_device) / 1e3 / calls,
          "device_events_per_call": sum(e.count for e in on_device) / calls,
          "top": [{"name": e.key[:60], "ms_per_call": e.self_device_time_total / 1e3 / calls,
                   "per_call": e.count / calls} for e in on_device[:8]]})


def sass_atomics(kernels, path) -> None:
    """The atomic instructions of each kernel of the built library, counted
    in its SASS (``cuobjdump -sass``): shared-memory float atomics that
    compile to compare-and-swap loops show as ``ATOMS.CAS*``."""
    tool = Path(kernels._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
        elif name and "/*" in ln:
            parts = ln.split("*/", 1)[-1].strip().rstrip(";").split()
            ops = [t for t in parts if t[:1].isupper()][:1]
            if ops and ops[0].split(".")[0] in ("ATOMS", "ATOM", "ATOMG", "RED", "REDG"):
                counts.setdefault(name, {}).setdefault(ops[0], 0)
                counts[name][ops[0]] += 1
    emit({"phase": "sass_atomics", "kernels": counts})


def gather_design_sweep(mk, shape: str, launches: dict) -> None:
    """Queued ms of each of ``launches`` (kernels E and F) at the z chunk of
    ``ops/mesh_kernels.py:gather_z_chunk`` ("rule") and at 16, 32 and 64
    z cells, and at z chunk 0: one thread a slot reading its window from the
    mesh in device memory."""
    rule = mk.gather_z_chunk
    times = {}
    try:
        for zc in ("rule", 0, 16, 32, 64):
            mk.gather_z_chunk = rule if zc == "rule" else (lambda nodes, n_ch, zc=zc: zc)
            times[zc] = {name: cuda_ms(fn) for name, fn in launches.items()}
    finally:
        mk.gather_z_chunk = rule
    emit({"phase": "gather_design_sweep", "shape": shape, "ms": times})


def dipole_cell_split(fp, rows32, mu32, cell32) -> dict:
    """The dipolar MD step's cell gradient in its two parts, the window's
    (kernel G: through ``d_offs`` and the cell centres of ``d_pc``) and the
    mesh's (the k-space energy through the refresh and kernels D, E, F),
    each of the float32 kernel path and of the plain float32 path against
    the plain float64 path on the same float32-rounded inputs: max abs error
    over max |float64 total| and over max |float64 part|.  Beside them the
    window's net force, max |sum_i dE_sr/dr_i| over max |dE_sr/dr_i|: zero
    in exact arithmetic, and where the cell gradient's weighted sum of
    forces sees the rounding of action against reaction; and the window's
    float32 floor: its float64 gradients (``d_pc``, ``d_offs``) rounded to
    float32, and nothing else, pushed through the cell in float64."""
    from torchpme_tpu_torch.ops.rspace_cells import _prepare_bucketed
    from torchpme_tpu_torch.ops.rspace_cells_dipole import (
        _dw_value_and_grad,
        cell_list_rspace_dipole_energy_rows,
    )

    def parts(dtype, plain):
        r = rows32.to(dtype).detach().requires_grad_()
        m = mu32.to(dtype).detach()
        c = cell32.to(dtype).detach().requires_grad_()
        e_sr = cell_list_rspace_dipole_energy_rows(fp.calc.potential, m, r, c, fp.clist,
                                                   plain=plain)
        g_sr, g_r = torch.autograd.grad(e_sr, (c, r))
        e_k = fp.calc._compute_kspace_energy(m, c, r.detach(), ns_kvectors=fp.ns_kvectors,
                                             tiled_interp=fp.tiled, check_stale=False,
                                             plain=plain)
        (g_k,) = torch.autograd.grad(e_k, c)
        g_r = g_r.double()
        net = float(g_r.sum(0).abs().max()) / float(g_r.abs().max())
        return g_sr.double(), g_k.double(), net

    ref = parts(torch.float64, True)
    total = float((ref[0] + ref[1]).abs().max())
    out = {"window_max_abs": float(ref[0].abs().max()), "mesh_max_abs": float(ref[1].abs().max()),
           "total_max_abs": total, "window_net_force_f64": ref[2]}
    for label, plain in (("kernels", False), ("plain_f32", True)):
        got = parts(torch.float32, plain)
        for part, g, r in zip(("window", "mesh"), got, ref):
            err = float((g - r).abs().max())
            out[f"{part}_{label}_rel"] = err / total
            out[f"{part}_{label}_rel_own"] = err / float(r.abs().max())
        out[f"total_{label}_rel"] = float((got[0] + got[1] - ref[0] - ref[1]).abs().max()) / total
        out[f"window_net_force_{label}"] = got[2]

    n_cells, cap = fp.clist.slot_mask.shape
    c = cell32.double().requires_grad_()
    ins = _prepare_bucketed(
        mu32.double().index_select(0, fp.clist.atom_index.reshape(-1).long())
        .reshape(n_cells, cap, 3),
        rows32[: n_cells * cap].double().reshape(n_cells, cap, 3), c, fp.clist,
    )[:4]
    _, (g_pc, _, g_offs) = _dw_value_and_grad(fp.calc.potential, fp.clist.cutoff,
                                              *[t.detach() for t in ins])

    def through(gp, go):
        return torch.autograd.grad((ins[0], ins[3]), c, grad_outputs=(gp, go),
                                   retain_graph=True)[0]

    exact = through(g_pc, g_offs)
    floor = through(g_pc.float().double(), g_offs.float().double())
    out["window_f32_floor_rel"] = float((floor - exact).abs().max()) / total
    sync()
    return out


def cell_split_of(tree: Path) -> int:
    """``--cell-split TREE``: the 102k dipolar MD step's cell-gradient split
    (:func:`dipole_cell_split`) of the package in another checkout ``TREE``,
    so that two commits compare on one card; one JSON line."""
    sys.path.insert(0, str(tree.resolve()))
    import torchpme_tpu_torch as tpt

    f32 = dict(dtype=torch.float32, device=tpt.default_device())
    positions, _, cell = water_box(N_ATOMS)
    smearing, spacing = dipole_parameters()
    calc = tpt.PMECalculatorDipole(tpt.PotentialDipole(smearing=smearing), mesh_spacing=spacing)
    fp = tpt.MDFastPathDipole.create(calc, positions.astype(np.float32),
                                     cell.astype(np.float32), CUTOFF)
    mu32 = torch.tensor(np.random.default_rng(1).normal(size=(N_ATOMS, 3)), **f32)
    rows32 = fp.bucket(torch.tensor(positions, **f32))
    emit({"phase": "cell_grad_split", "package": tpt.__file__, "nvidia_smi": card_line(),
          **dipole_cell_split(fp, rows32, mu32, torch.tensor(cell, **f32))})
    return 0


def dipole_phases(env) -> None:
    """Phases 3 (kernel G; D, E, F at the dipolar shapes), 7, 8 and 9: the
    dipolar paths at the system of tools/bench_family.py."""
    tpt, kernels, f32, dev = env.tpt, env.kernels, env.f32, env.dev
    from torchpme_tpu_torch.ops import mesh_kernels as mk
    from torchpme_tpu_torch.ops import rspace_cells_dipole as rcd
    from torchpme_tpu_torch.ops.math import inv3
    from torchpme_tpu_torch.ops.mesh_tiled import _slot_values, compute_tiled_interpolation
    from torchpme_tpu_torch.ops.rspace_cells import _prepare_bucketed, _window_offsets

    pos32, cell32, idx_t, shifts_t = env.pos32, env.cell32, env.idx_t, env.shifts_t
    smearing, spacing = dipole_parameters()
    pot = tpt.PotentialDipole(smearing=smearing)
    calc = tpt.PMECalculatorDipole(pot, mesh_spacing=spacing)
    if calc.get_ns_mesh(env.cell) != NS_MESH or calc.interpolation_nodes != DIPOLE_NODES:
        raise AssertionError(f"dipolar mesh: {calc.get_ns_mesh(env.cell)}")
    mu32 = torch.tensor(np.random.default_rng(1).normal(size=(N_ATOMS, 3)), **f32)
    t0 = time.perf_counter()
    fp = tpt.MDFastPathDipole.create(calc, env.positions.astype(np.float32),
                                     env.cell.astype(np.float32), CUTOFF)
    create_s = time.perf_counter() - t0
    if fp.row_of_atom.device.type != dev.type or fp.tiled is None or fp.tiled.dweights is None:
        raise AssertionError("MDFastPathDipole.create: the state is not on the card, or not tiled")
    n_cells, cap = fp.clist.slot_mask.shape
    n_extra = 0 if fp.clist.extra_mask is None else int(fp.clist.extra_mask.sum())
    t0 = time.perf_counter()
    interp = compute_tiled_interpolation(pos32, inv3(cell32), NS_MESH, DIPOLE_NODES, "Lagrange",
                                         derivatives=True)
    sync()
    interp_s = time.perf_counter() - t0
    n_tiles, tile_cap = interp.local_x.shape
    emit({"phase": "dipole_create", "seconds": create_s, "smearing": smearing,
          "mesh_spacing": spacing, "n_axis": fp.clist.n_axis, "cell_capacity": cap,
          "n_rows": fp.n_rows, "spill_atoms": n_extra, "tiles": n_tiles,
          "tile_capacity": tile_cap, "tiled_interpolation_seconds": interp_s,
          "dropped": int(interp.dropped)})
    rows32 = fp.bucket(pos32)

    # -- 3. kernel G at the 102k dipolar window, and D, E, F at the dipolar tiles --
    with torch.no_grad():
        pc_t, mu_g, mf_g, offs, _ = _prepare_bucketed(
            mu32.index_select(0, fp.clist.atom_index.reshape(-1).long()).reshape(n_cells, cap, 3),
            rows32[: n_cells * cap].reshape(n_cells, cap, 3), cell32, fp.clist,
        )
    def window(fn, potential, ins, mui, e_ref):
        e, grads = fn(potential, CUTOFF, *ins, mui)
        if mui is not None:
            # with some i-side dipoles zeroed the energy loses the close pairs
            # that dominate it, not its rounding error: its error is taken
            # over the energy of all the dipoles, which rides beside it
            e = torch.stack([e, e_ref.to(e.dtype)])
        return (e, *grads)

    def window_dipole_check(potential, ins, mui, shape):
        """Kernel G against its plain version on ``ins`` (bound: the work of
        this data, the candidate pairs of occupied slots of the half window
        and those inside the cutoff), against float64, and two launches
        bitwise equal in d_pc, d_mu[, d_mui]."""
        pc_i, mu_i, mf_i, offs_i = ins
        occ_i = mf_i.sum(-1).double()
        cut2 = torch.tensor(CUTOFF, **f32) ** 2
        n_cand, n_in = 0.0, 0
        for k, offset in enumerate(_window_offsets(pc_i.shape[-1])):
            shift = tuple(-o for o in offset)
            n_cand += float((occ_i * torch.roll(occ_i, shift, dims=(0, 1, 2))).sum())
            ok = rcd._offset_geometry(k, offset, pc_i, mu_i, mf_i, offs_i, cut2)[2]
            n_in += int((ok & (mf_i[..., :, None] > 0.5)).sum())
        del ok
        extra = [] if mui is None else [mui]
        with torch.no_grad():
            e_all = rcd._dw_value_and_grad(potential, CUTOFF, *ins)[0]
            # float64 on the same inputs, the reference of both float32 versions
            dbl = [t.double() for t in ins]
            e64 = rcd._dw_value_and_grad(potential, CUTOFF, *dbl)[0]
            ref64 = window(rcd._dw_value_and_grad, potential, dbl,
                           None if mui is None else mui.double(), e64)
            ref = window(rcd._dw_value_and_grad, potential, ins, mui, e_all)
        plain_f64 = [rel_err(a, b)[1] for a, b in zip(ref, ref64)]
        # d_offs: the plain version's float32 sum of a cancelling total is
        # itself up to ~6e-4 off float64 on the 3x3x3 grid, so the kernel's
        # d_offs is held to float64 alone (below), at G_D_OFFS_F64_TOL
        tols = [KERNEL_TOL, KERNEL_TOL, KERNEL_TOL, None, KERNEL_TOL]
        check_kernel(
            "window_dipole", "torchpme_tpu_torch/csrc/window_dipole.cu",
            "torchpme_tpu/ops/pallas/window_dipole_pallas.py:81",
            lambda: window(rcd.dipole_window_value_and_grad, potential, ins, mui, e_all),
            lambda: window(rcd._dw_value_and_grad, potential, ins, mui, e_all),
            # inputs once, outputs (e in double, d_pc, d_mu, d_offs[, d_mui]) once; 11
            # operations to place and test a candidate, G_PAIR_FLOP more inside the cutoff
            bound(nbytes(*ins, *extra, pc_i, mu_i, offs_i, *extra) + 8,
                  11 * n_cand + G_PAIR_FLOP["direct" if potential.smearing is None
                                            else "smeared"] * n_in),
            env.report, tols=tols[: 4 + len(extra)], shape=shape,
        )
        got = window(rcd.dipole_window_value_and_grad, potential, ins, mui, e_all)
        kernel_f64 = [rel_err(a, b)[1] for a, b in zip(got, ref64)]
        emit({"phase": "kernel_vs_float64", "name": "window_dipole", "shape": shape,
              "candidate_pairs": n_cand, "pairs_inside_cutoff": n_in,
              "kernel_rel_err": kernel_f64,
              "plain_f32_rel_err": plain_f64})
        f64_tols = [KERNEL_TOL, KERNEL_TOL, KERNEL_TOL, G_D_OFFS_F64_TOL, KERNEL_TOL]
        if not all(err <= tol for err, tol in zip(kernel_f64, f64_tols)):
            raise AssertionError(f"kernel G vs float64 {kernel_f64} ({shape})")
        # each row of d_pc, d_mu and d_mui has one writer: launches agree bit for bit
        first, again = (rcd.dipole_window_value_and_grad(potential, CUTOFF, *ins, mui)[1]
                        for _ in range(2))
        sync()
        same = [bool(torch.equal(first[i], again[i])) for i in (0, 1, 3)[: 2 + len(extra)]]
        emit({"phase": "kernel_reproducible", "name": "window_dipole", "shape": shape,
              "d_pc_d_mu_d_mui_bitwise_equal": same})
        if not all(same):
            raise AssertionError(f"kernel G's row gradients differ between two launches ({shape})")
        del dbl, ref64, got, ref, first, again

    gen = torch.Generator(device=dev).manual_seed(1)
    keep = (torch.rand(mu_g.shape[:3], generator=gen, device=dev) > 0.3).to(mu_g.dtype)
    mui_split = (mu_g * keep[..., None, None]).contiguous()
    ins = (pc_t, mu_g, mf_g, offs)
    for shape, potential, mui in (("smeared", pot, None), ("direct", tpt.PotentialDipole(), None),
                                  ("smeared, separate i-side dipoles", pot, mui_split)):
        window_dipole_check(potential, ins, mui, shape)
    del mui_split
    # the 3x3x3 cell grid at its own capacity and at EDGE_CAPACITY, with and
    # without separate i-side dipoles
    lib = kernels.load_library().lib
    emit({"phase": "window_dipole_capacity", "largest_capacity": {
        "mu": lib.tpme_window_dipole_max_cap(0, torch.cuda.current_device()),
        "mu_and_mui": lib.tpme_window_dipole_max_cap(1, torch.cuda.current_device())}})
    epos, _, ecell = dense_grid_box()
    emu = torch.tensor(np.random.default_rng(3).normal(size=(EDGE_GRID_ATOMS, 3)), **f32)
    for capacity in (None, EDGE_CAPACITY):
        eclist = tpt.ops.compute_cell_list(epos, ecell, CUTOFF, capacity=capacity, spill=False,
                                           device=dev)
        e_cap = eclist.slot_mask.shape[1]
        if eclist.n_axis != (3, 3, 3) or e_cap <= 32:
            raise AssertionError(f"edge grid {eclist.n_axis}, capacity {e_cap}")
        eidx = eclist.atom_index.long()
        with torch.no_grad():
            e_ins = _prepare_bucketed(emu[eidx], torch.tensor(epos, **f32)[eidx],
                                      torch.tensor(ecell, **f32), eclist)[:4]
        e_keep = (torch.rand(e_ins[1].shape[:3], generator=gen, device=dev) > 0.3).float()
        for mui in (None, (e_ins[1] * e_keep[..., None, None]).contiguous()):
            split = mui is not None
            warps = rcd._window_dipole_warps(e_cap, split, e_ins[0].device.index)
            window_dipole_check(
                pot, e_ins, mui, f"3x3x3 cells, capacity {e_cap}"
                f"{', separate i-side dipoles' if split else ''}, {warps} home cells a block")
        del e_ins

    # what the dipolar kernels must move: each slot's indices, weights and
    # weight derivatives once
    once = (interp.local_x, interp.local_y, interp.start_z, interp.weights, interp.dweights)
    nu = (mu32 @ inv3(cell32)) * torch.tensor(NS_MESH, **f32)
    nu_slots = _slot_values(interp, nu)
    field, n3 = env.ct_rho, DIPOLE_NODES**3
    mesh_src, mesh_ref = "torchpme_tpu_torch/csrc/mesh.cu", "torchpme_tpu/ops/pallas/mesh_pallas.py"
    # kernel D's dipole form, one pass per slot: the spread of the dipoles
    # (forward) and of the gather's mesh cotangent, per-slot values (T, 3, K)
    # that are zero in empty slots (the backward of the atom gather)
    dip_args = once
    occupied = (interp.atom_of_slot < N_ATOMS).to(torch.float32)[:, None, :]
    ct_slots = torch.randn((n_tiles, 3, tile_cap), generator=gen, **f32) * occupied
    for label, vals in (("the spread of the dipoles", nu_slots),
                        ("the gather's mesh cotangent", ct_slots)):
        check_kernel(
            "mesh_spread", mesh_src, f"{mesh_ref}:213",
            lambda vals=vals: (mk.mesh_spread_dipole(*dip_args, vals, NS_MESH, DIPOLE_NODES),),
            lambda vals=vals: (mk.mesh_spread_dipole_plain(*dip_args, vals, NS_MESH,
                                                           DIPOLE_NODES),),
            bound(nbytes(*once, vals, field), 3 * N_ATOMS * 2 * n3), env.report,
            shape=f"dipole form, {label}: {DIPOLE_NODES} nodes, T={n_tiles}, K={tile_cap}",
        )
    del ct_slots
    # the dipole forms of E and F, one pass per slot
    shape = f"dipole form: {DIPOLE_NODES} nodes, T={n_tiles}, K={tile_cap}"
    check_kernel(
        "mesh_gather", mesh_src, f"{mesh_ref}:239",
        lambda: (mk.mesh_gather_dipole(*dip_args, field, NS_MESH, DIPOLE_NODES),),
        lambda: (mk.mesh_gather_dipole_plain(*dip_args, field, NS_MESH, DIPOLE_NODES),),
        bound(nbytes(*once, field, nu_slots), 3 * N_ATOMS * 2 * n3), env.report, shape=shape,
    )
    check_kernel(
        "mesh_wgrad", mesh_src, f"{mesh_ref}:263",
        lambda: mk.mesh_wgrad_dipole(*dip_args, nu_slots, field, NS_MESH, DIPOLE_NODES),
        lambda: mk.mesh_wgrad_dipole_plain(*dip_args, nu_slots, field, NS_MESH, DIPOLE_NODES),
        bound(nbytes(*once, nu_slots, field, interp.weights, interp.dweights),
              3 * N_ATOMS * 8 * n3), env.report,
        shape=shape,
    )
    both = lambda: mk.mesh_gather_wgrad_dipole(*dip_args, nu_slots, field, NS_MESH, DIPOLE_NODES)
    first, again = both(), both()
    split = (mk.mesh_gather_dipole(*dip_args, field, NS_MESH, DIPOLE_NODES),
             *mk.mesh_wgrad_dipole(*dip_args, nu_slots, field, NS_MESH, DIPOLE_NODES))
    sync()
    if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(first, again, split)):
        raise AssertionError("mesh_gather_wgrad_dipole differs between launches or from E and F")
    emit({"phase": "kernel", "name": "mesh_gather_wgrad", "shape": shape, "ms": cuda_ms(both),
          "bitwise_equal_over_two_launches_and_to_e_and_f": True})
    del first, again, split
    if env.profile:
        gather_design_sweep(mk, f"dipole form, {DIPOLE_NODES} nodes", {
            "mesh_gather": lambda: mk.mesh_gather_dipole(*dip_args, field, NS_MESH, DIPOLE_NODES),
            "mesh_wgrad": lambda: mk.mesh_wgrad_dipole(*dip_args, nu_slots, field, NS_MESH,
                                                       DIPOLE_NODES),
            "mesh_gather_wgrad": both})
    del nu_slots, nu

    # -- 7. the dipolar MD step (kernels G, D, E, F) -------------------------------
    def step(dtype, plain):
        """(energy, d/drows, d/ddipoles, d/dcell) of the dipolar step."""
        r = rows32.to(dtype).detach().requires_grad_()
        m = mu32.to(dtype).detach().requires_grad_()
        c = cell32.to(dtype).detach().requires_grad_()
        e = fp.energy(m, c, r, plain=plain)
        return (e.detach(), *torch.autograd.grad(e, (r, m, c)))

    kernels.reset_launch_counts()
    got = step(torch.float32, plain=False)
    sync()
    counts = kernels.launch_counts()
    md_kernels = ("window_dipole", "mesh_spread", "mesh_gather", "mesh_wgrad")
    if min(counts[name] for name in md_kernels) < 1:
        raise AssertionError(f"a kernel of the dipolar MD step never launched: {counts}")
    ref = step(torch.float64, plain=True)  # on the same float32-rounded inputs
    e_md = float(got[0])
    e_rel = abs(e_md - float(ref[0])) / abs(float(ref[0]))
    f_rms = rel_rms(fp.unbucket(got[1]), fp.unbucket(ref[1]))
    field_rel = rel_err(got[2], ref[2])[1]
    c_rel = rel_err(got[3], ref[3])[1]
    max_force = float(ref[1].abs().max())
    del got, ref

    def md_chain(plain: bool):
        # forces reach ~1e7 here (pairs 0.04 A apart under 1/d^4): atoms that
        # moved by 1e-7 of them would leave their cells and time NaN
        return md_chain_of(fp, mu32, cell32, rows32, plain, step=1e-12)

    kernel_ms, plain_ms = (t / CHAIN for t in alternate_ms(md_chain, 1))
    if not bool(torch.isfinite(md_chain(False)).all()):
        raise AssertionError("the dipolar MD chain left its bucketing")
    cell_split = dipole_cell_split(fp, rows32, mu32, cell32)
    emit({"phase": "dipole_slice", "atoms": N_ATOMS, "energy_f32": e_md,
          "energy_rel": e_rel, "force_rel_rms": f_rms, "field_rel": field_rel,
          "cell_grad_rel": c_rel, "cell_grad_split": cell_split, "max_abs_force": max_force,
          "launches": {k: counts[k] for k in md_kernels}, "create_seconds": create_s,
          "ms_per_step": kernel_ms, "plain_f32_ms_per_step": plain_ms, "nvidia_smi": env.smi})
    if not (e_rel <= 1e-5 and f_rms <= 1e-5 and field_rel <= 1e-5 and c_rel <= DIPOLE_CELL_TOL):
        raise AssertionError(
            f"102k dipolar f32 step vs f64 plain: energy {e_rel:.3e}, forces {f_rms:.3e}, "
            f"fields {field_rel:.3e}, cell {c_rel:.3e}"
        )
    if not all(math.isfinite(x) for x in (e_md, kernel_ms, plain_ms)):
        raise AssertionError("non-finite dipolar slice result")
    env.counts["window_dipole"] = counts["window_dipole"]
    env.dipole_launches = {"step": {k: counts[k] for k in md_kernels}}

    # -- 8. the dipolar per-atom call on the tiled mesh (kernels D, E, F) ----------
    def per_atom(dtype, plain, backward=True):
        """(potential vectors, d/dpositions, d/ddipoles, d/dcell of sum(pot·mu),
        the sum itself); the neighbor vectors are rebuilt inside so the
        gradients reach positions and cell."""
        p = pos32.to(dtype).detach().requires_grad_(backward)
        m = mu32.to(dtype).detach().requires_grad_(backward)
        c = cell32.to(dtype).detach().requires_grad_(backward)
        vec = (p.index_select(0, idx_t[:, 1]) - p.index_select(0, idx_t[:, 0])
               + shifts_t.to(dtype) @ c)
        pot_i = calc(m, c, p, idx_t, vec, ns_kvectors=NS_MESH, tiled_interp=interp, plain=plain)
        if not backward:
            return (pot_i,)
        total = torch.sum(pot_i * m)
        return (pot_i.detach(), *torch.autograd.grad(total, (p, m, c)), total.detach())

    kernels.reset_launch_counts()
    got = per_atom(torch.float32, plain=False)
    sync()
    call_counts = kernels.launch_counts()
    call_kernels = ("mesh_spread", "mesh_gather", "mesh_wgrad")
    if min(call_counts[name] for name in call_kernels) < 1:
        raise AssertionError(f"a kernel of the dipolar per-atom call never launched: {call_counts}")
    ref = per_atom(torch.float64, plain=True)
    pot_rel = rel_err(got[0], ref[0])[1]
    force_rms = rel_rms(got[1], ref[1])
    dmu_rel = rel_err(got[2], ref[2])[1]
    dcell_rel = rel_err(got[3], ref[3])[1]
    e_sum, e_sum64 = float(got[4]), float(ref[4])
    with torch.no_grad():
        vec32 = (pos32.index_select(0, idx_t[:, 1]) - pos32.index_select(0, idx_t[:, 0])
                 + shifts_t.to(torch.float32) @ cell32)
        e_quad = float(calc.energy(mu32, cell32, pos32, idx_t, vec32, ns_kvectors=NS_MESH,
                                   tiled_interp=interp))
    e_sum_rel = abs(e_sum - e_sum64) / abs(e_sum64)
    e_quad_rel = abs(e_quad - e_sum) / abs(e_sum)
    e_md_rel = abs(e_md - e_sum) / abs(e_sum)
    del got, ref, vec32

    fwd_ms, fwd_plain_ms = alternate_ms(
        lambda plain: per_atom(torch.float32, plain, backward=False), CALL_REPEATS)
    full_ms, full_plain_ms = alternate_ms(
        lambda plain: per_atom(torch.float32, plain), CALL_REPEATS)
    emit({"phase": "dipole_per_atom_call", "atoms": N_ATOMS, "pairs": env.n_pairs,
          "energy_sum_pot_mu_f32": e_sum, "energy_sum_pot_mu_f64_plain": e_sum64,
          "energy_rel": e_sum_rel, "potential_rel": pot_rel, "force_rel_rms": force_rms,
          "dipole_grad_rel": dmu_rel, "cell_grad_rel": dcell_rel,
          "energy_method_rel_vs_sum": e_quad_rel, "md_step_energy_rel_vs_sum": e_md_rel,
          "launches": {k: call_counts[k] for k in call_kernels},
          "forward_ms": fwd_ms, "forward_plain_f32_ms": fwd_plain_ms,
          "forward_backward_ms": full_ms, "forward_backward_plain_f32_ms": full_plain_ms,
          "nvidia_smi": env.smi})
    if not (e_sum_rel <= 1e-5 and pot_rel <= 1e-5 and force_rms <= 1e-5
            and dmu_rel <= 1e-5 and dcell_rel <= DIPOLE_CELL_TOL):
        raise AssertionError(
            f"102k dipolar f32 per-atom call vs f64 plain: energy {e_sum_rel:.3e}, potentials "
            f"{pot_rel:.3e}, forces {force_rms:.3e}, dipole gradient {dmu_rel:.3e}, "
            f"cell gradient {dcell_rel:.3e}"
        )
    if not (e_quad_rel <= 1e-5 and e_md_rel <= 1e-5):
        raise AssertionError(
            f"dipolar sum(pot*mu) vs calc.energy {e_quad_rel:.3e}, vs the MD step {e_md_rel:.3e}"
        )
    env.dipole_launches["call"] = {k: call_counts[k] for k in call_kernels}
    if env.profile:
        profile_path("dipole_md_step", lambda: md_chain(False), calls=2)  # 2 chains of CHAIN
        profile_path("dipole_per_atom_forward",
                     lambda: per_atom(torch.float32, False, backward=False))
        profile_path("dipole_per_atom_forward_backward", lambda: per_atom(torch.float32, False))

    # -- 9. dipolar accuracy: mesh PME (float32) vs the converged dipolar Ewald ----
    gpos, gmu, gcell = dipole_oracle_box()
    if calc.get_ns_mesh(gcell) != DIPOLE_GT_NS:
        raise AssertionError(f"mesh of the dipolar oracle: {calc.get_ns_mesh(gcell)}")
    gpos32, gmu32, gcell32 = (torch.tensor(a, **f32) for a in (gpos, gmu, gcell))
    gfp = tpt.MDFastPathDipole.create(calc, gpos32, gcell32, CUTOFF)
    kernels.reset_launch_counts()
    with torch.no_grad():
        e_pme = float(gfp.energy(gmu32, gcell32, gfp.bucket(gpos32)))
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    e_ewald = dipole_ewald_oracle(tpt, gpos, gmu, gcell, smearing, dev)
    accuracy = {"energy_pme_f32": e_pme, "energy_ewald_f64": e_ewald,
                "pme_rel_vs_ewald": abs(e_pme - e_ewald) / abs(e_ewald),
                "jax_energy_pme_f64": DIPOLE_GT_JAX_PME, "jax_energy_ewald_f64": DIPOLE_GT_JAX_EWALD,
                "pme_rel_vs_jax_pme": abs(e_pme - DIPOLE_GT_JAX_PME) / abs(DIPOLE_GT_JAX_PME),
                "ewald_rel_vs_jax_ewald":
                    abs(e_ewald - DIPOLE_GT_JAX_EWALD) / abs(DIPOLE_GT_JAX_EWALD),
                "launches": launched}
    emit({"phase": "dipole_accuracy", "atoms": DIPOLE_GT_N, "ns_mesh": DIPOLE_GT_NS, **accuracy})
    if not (accuracy["pme_rel_vs_ewald"] <= DIPOLE_GT_BAR
            and accuracy["ewald_rel_vs_jax_ewald"] <= 1e-9
            and accuracy["pme_rel_vs_jax_pme"] <= 1e-5):
        raise AssertionError(f"3000-atom dipolar accuracy: {accuracy}")
    if not {"window_dipole", "mesh_spread"} <= set(launched):
        raise AssertionError(f"the dipolar accuracy step launched {launched}")


def md_chain_of(fp, q, cell, rows, plain: bool, step: float = 1e-7):
    """CHAIN chained energy + force steps of ``fp`` from ``rows`` (a data
    dependency between steps, not a trajectory)."""
    p = rows
    for _ in range(CHAIN):
        p = p.detach().requires_grad_()
        e = fp.energy(q, cell, p, plain=plain)
        (g,) = torch.autograd.grad(e, p)
        p = p - step * g
    return p


def fused_md_phase(tpt, kernels, calc, positions, cell, pos32, q32, cell32, smi, profile):
    """Phase 4b: ``MDFastPath(mesh_impl="fused")`` at 102k in float32 against
    the plain float64 step (the tiled mode's: float64 takes it), its launches
    (A, B, C and none of D, E, F), and the ms/step of its kernel and plain
    paths with the tiled mode's, forced, in the same turns; with ``profile``
    the profiler's breakdown of the fused and the tiled step."""
    t0 = time.perf_counter()
    modes = {mode: tpt.MDFastPath.create(calc, positions.astype(np.float32),
                                         cell.astype(np.float32), CUTOFF, NS_MESH,
                                         mesh_impl=mode)
             for mode in ("fused", "tiled")}
    create_s = time.perf_counter() - t0
    fp = modes["fused"]
    if fp.mesh_impl != "fused" or fp.calc.mesh_backend != "fused":
        raise AssertionError("MDFastPath.create(mesh_impl='fused') built another mode")
    rows = fp.bucket(pos32)
    cell_g = cell32.clone().requires_grad_()
    rows_g = rows.clone().requires_grad_()
    kernels.reset_launch_counts()
    e32 = fp.energy(q32, cell_g, rows_g)
    g_rows, g_cell = torch.autograd.grad(e32, (rows_g, cell_g))
    sync()
    counts = kernels.launch_counts()
    fused_kernels, off = ("spread_fwd", "spread_bwd", "window"), ("mesh_spread", "mesh_gather",
                                                                  "mesh_wgrad")
    if min(counts[k] for k in fused_kernels) < 1 or any(counts[k] for k in off):
        raise AssertionError(f"the fused MD step launched {counts}")
    cell64 = cell32.double().requires_grad_()
    rows64 = rows.double().requires_grad_()
    e64 = fp.energy(q32.double(), cell64, rows64, plain=True)
    g_rows64, g_cell64 = torch.autograd.grad(e64, (rows64, cell64))
    e_rel = abs(float(e32.detach()) - float(e64.detach())) / abs(float(e64.detach()))
    f_rms = rel_rms(fp.unbucket(g_rows), fp.unbucket(g_rows64))
    c_rel = rel_err(g_cell, g_cell64)[1]
    del rows64, g_rows64
    rows_t = modes["tiled"].bucket(pos32)
    ms = turns_ms({
        "fused": lambda: md_chain_of(fp, q32, cell32, rows, False),
        "fused_plain": lambda: md_chain_of(fp, q32, cell32, rows, True),
        "tiled": lambda: md_chain_of(modes["tiled"], q32, cell32, rows_t, False),
    }, 1)
    ms = {k: v / CHAIN for k, v in ms.items()}
    if not bool(torch.isfinite(md_chain_of(fp, q32, cell32, rows, False)).all()):
        raise AssertionError("the fused MD chain left its bucketing")
    out = {"phase": "fused_slice", "atoms": N_ATOMS, "energy_f32": float(e32.detach()),
           "energy_rel": e_rel, "force_rel_rms": f_rms, "cell_grad_rel": c_rel,
           "launches": {k: counts[k] for k in fused_kernels + off},
           "tiles": fp.tiled.local_x.shape[0], "tile_capacity": fp.tiled.local_x.shape[1],
           "create_seconds_fused_and_tiled": create_s, "ms_per_step": ms["fused"],
           "plain_f32_ms_per_step": ms["fused_plain"], "tiled_mode_ms_per_step": ms["tiled"],
           "nvidia_smi": smi}
    emit(out)
    if not (e_rel <= 1e-5 and f_rms <= 1e-5 and c_rel <= 1e-4):
        raise AssertionError(
            f"102k fused f32 step vs f64 plain: energy {e_rel:.3e}, forces {f_rms:.3e}, "
            f"cell {c_rel:.3e}"
        )
    if not all(math.isfinite(x) for x in (float(e32.detach()), *ms.values())):
        raise AssertionError("non-finite fused slice result")
    if profile:
        profile_path("md_step_fused", lambda: md_chain_of(fp, q32, cell32, rows, False), calls=2)
        profile_path("md_step_tiled",
                     lambda: md_chain_of(modes["tiled"], q32, cell32, rows_t, False), calls=2)
    return {k: counts[k] for k in fused_kernels}


def p3m_spacing(cell) -> float:
    """tools/bench_family.py's P3M mesh spacing for a cubic box, 2·box/(n - 1)
    for the NS_MESH[0] planes, a hair wider so that get_ns_mesh rounds to n."""
    return 2 * float(cell[0, 0]) / (NS_MESH[0] - 1) * (1 + 1e-9)


def p3m_bound(positions, charges, cell, smearing) -> float:
    """The port's ``P3MErrorBounds`` at the P3M phases' parameters (5 nodes,
    p3m_spacing, CUTOFF): the main path's P3M geometry must meet ACCURACY."""
    from torchpme_tpu_torch.tuning import P3MErrorBounds

    bound = P3MErrorBounds(*_cpu(charges, cell, positions))
    return float(bound(smearing=smearing, mesh_spacing=p3m_spacing(cell), cutoff=CUTOFF,
                       interpolation_nodes=NODES))


def md_step_check(fp, q32, cell32, rows, expect, forbid=()):
    """One float32 energy + force step of ``fp`` through the kernels and the
    plain float64 step on the same float32-rounded inputs: the launch counts
    (each of ``expect`` at least once, none of ``forbid``), energy, force rel
    RMS and cell gradient errors."""
    import torchpme_tpu_torch.kernels as kernels

    cell_g = cell32.clone().requires_grad_()
    rows_g = rows.clone().requires_grad_()
    kernels.reset_launch_counts()
    e32 = fp.energy(q32, cell_g, rows_g)
    g_rows, g_cell = torch.autograd.grad(e32, (rows_g, cell_g))
    sync()
    counts = kernels.launch_counts()
    if min(counts[k] for k in expect) < 1 or any(counts[k] for k in forbid):
        raise AssertionError(f"the step launched {counts}, expected {expect}, not {forbid}")
    cell64 = cell32.double().requires_grad_()
    rows64 = rows.double().requires_grad_()
    e64 = fp.energy(q32.double(), cell64, rows64, plain=True)
    g_rows64, g_cell64 = torch.autograd.grad(e64, (rows64, cell64))
    e32, e64 = float(e32.detach()), float(e64.detach())
    return {"energy_f32": e32, "energy_f64_plain": e64, "energy_rel": abs(e32 - e64) / abs(e64),
            "force_rel_rms": rel_rms(fp.unbucket(g_rows), fp.unbucket(g_rows64)),
            "cell_grad_rel": rel_err(g_cell, g_cell64)[1],
            "launches": {k: counts[k] for k in (*expect, *forbid)}}


def energy_error_split(fp, q32, cell32, rows32) -> dict:
    """Where an aligned MD step's float32 energy error comes from, each part
    over |E| of the float64 plain step on the same inputs: the window (kernel
    C), the density (kernel A's float32 mesh, carried through the float64
    transform and filter) and the transform and filter in float32 (cuFFT,
    the k-space filter, the quadratic form)."""
    from torchpme_tpu_torch.ops.math import inv3
    from torchpme_tpu_torch.ops.rspace_cells import cell_list_rspace_energy_rows
    from torchpme_tpu_torch.ops.spread_fused import aligned_tiled_density

    calc, parts = fp.calc, {}
    with torch.no_grad():
        for dt, plain in ((torch.float32, False), (torch.float64, True)):
            rows, cell, q = rows32.to(dt), cell32.to(dt), q32.to(dt)
            q_rows = q.new_zeros((fp.n_rows, q.shape[-1])).index_copy(0, fp.row_of_atom.long(), q)
            rho = aligned_tiled_density(rows, q_rows, inv3(cell), fp.ns_mesh,
                                        calc.interpolation_nodes, calc._method, fp.cell_grid,
                                        pad_cells=fp.aligned_pad, plain=plain)
            e_sr = cell_list_rspace_energy_rows(calc.potential, q, rows, cell, fp.clist, plain=plain)
            parts[dt] = (float(e_sr), rho, float(calc._kspace_energy_from_rho(
                rho, cell, q, rows, None, fp.ns_mesh)))
        (sr32, rho32, k32), (sr64, _, k64) = parts[torch.float32], parts[torch.float64]
        k_mixed = float(calc._kspace_energy_from_rho(
            rho32.double(), cell32.double(), q32.double(), rows32.double(), None, fp.ns_mesh))
    e64 = abs(sr64 + k64)
    return {"window": (sr32 - sr64) / e64, "density": (k_mixed - k64) / e64,
            "transform_and_filter": (k32 - k_mixed) / e64, "total": (sr32 + k32 - sr64 - k64) / e64}


def check_bars(label, out, energy=1e-5, forces=1e-5, cell=1e-4):
    """PERF.md section 2's float32-vs-float64 bars for point charges."""
    if not (out["energy_rel"] <= energy and out["force_rel_rms"] <= forces
            and out["cell_grad_rel"] <= cell):
        raise AssertionError(
            f"{label} f32 vs f64: energy {out['energy_rel']:.3e}, forces "
            f"{out['force_rel_rms']:.3e}, cell {out['cell_grad_rel']:.3e}"
        )


def per_atom_call(calc, pos32, q32, cell32, idx, shifts, dtype, plain, backward=True, **kw):
    """(potentials, d/dpositions, d/dcharges, d/dcell of sum(pot·q), the sum)
    of ``calc``'s per-atom call over a neighbor list, or over ``cell_list=``
    when ``idx`` is None; distances are recomputed inside so the gradients
    reach positions and cell."""
    from torchpme_tpu_torch.utils.neighbors import compute_distances

    p = pos32.to(dtype).detach().requires_grad_(backward)
    q = q32.to(dtype).detach().requires_grad_(backward)
    c = cell32.to(dtype).detach().requires_grad_(backward)
    if idx is None:
        pot_i = calc(q, c, p, plain=plain, **kw)
    else:
        pot_i = calc(q, c, p, idx, compute_distances(p, idx, c, shifts), plain=plain, **kw)
    if not backward:
        return (pot_i,)
    total = torch.sum(pot_i * q)
    return (pot_i.detach(), *torch.autograd.grad(total, (p, q, c)), total.detach())


def call_errors(got, ref) -> dict:
    return {"potential_rel": rel_err(got[0], ref[0])[1], "force_rel_rms": rel_rms(got[1], ref[1]),
            "charge_grad_rel": rel_err(got[2], ref[2])[1],
            "cell_grad_rel": rel_err(got[3], ref[3])[1],
            "energy_rel": abs(float(got[4]) - float(ref[4])) / abs(float(ref[4]))}


def check_call(label, errs):
    if not (errs["energy_rel"] <= 1e-5 and errs["potential_rel"] <= 1e-5
            and errs["force_rel_rms"] <= 1e-5 and errs["charge_grad_rel"] <= 1e-5
            and errs["cell_grad_rel"] <= 1e-4):
        raise AssertionError(f"{label} f32 vs f64: {errs}")


def p3m_phases(env) -> dict:
    """Phases 11 and 12: the P3M MD step at 102k (``MDFastPath`` over
    ``P3MCalculator``: aligned by ``auto``, then fused and tiled, forced) and
    the P3M per-atom call on the tiled mesh (kernels D, E, F at 5 nodes),
    float32 kernels against the plain float64 paths.  Returns the launches of
    the aligned step and of the call."""
    tpt, kernels, dev = env.tpt, env.kernels, env.dev
    from torchpme_tpu_torch.ops.math import inv3
    from torchpme_tpu_torch.ops.mesh_tiled import compute_tiled_interpolation

    spacing = p3m_spacing(env.cell)
    calc = tpt.P3MCalculator(tpt.CoulombPotential(smearing=env.smearing), mesh_spacing=spacing,
                             interpolation_nodes=NODES)
    if calc.get_ns_mesh(env.cell) != NS_MESH:
        raise AssertionError(f"P3M mesh of the 102k box: {calc.get_ns_mesh(env.cell)}")
    error_bound = p3m_bound(env.positions, env.charges, env.cell, env.smearing)
    if not error_bound <= ACCURACY:
        raise AssertionError(f"P3M geometry of the 102k box: error bound {error_bound:.3e}")
    pos_np, cell_np = env.positions.astype(np.float32), env.cell.astype(np.float32)
    t0 = time.perf_counter()
    modes = {mode: tpt.MDFastPath.create(calc, pos_np, cell_np, CUTOFF, NS_MESH, mesh_impl=mode)
             for mode in ("auto", "fused", "tiled")}
    create_s = time.perf_counter() - t0
    if [fp.mesh_impl for fp in modes.values()] != ["aligned", "fused", "tiled"]:
        raise AssertionError(f"P3M MD modes {[fp.mesh_impl for fp in modes.values()]}")
    rows = {mode: fp.bucket(env.pos32) for mode, fp in modes.items()}
    mesh_k = ("mesh_spread", "mesh_gather", "mesh_wgrad")
    expect = {"auto": (("spread_fwd", "spread_bwd", "window"), mesh_k),
              "fused": (("spread_fwd", "spread_bwd", "window"), mesh_k),
              "tiled": (("mesh_spread", "mesh_wgrad", "window"), ("spread_fwd", "spread_bwd"))}
    out = {}
    for mode, fp in modes.items():
        out[mode] = md_step_check(fp, env.q32, env.cell32, rows[mode], *expect[mode])
    step_counts = out["auto"]["launches"]
    # the float32 energy error of the aligned step, P3M beside PME, by part
    split = {"pme": energy_error_split(env.fp, env.q32, env.cell32, env.fp.bucket(env.pos32)),
             "p3m": energy_error_split(modes["auto"], env.q32, env.cell32, rows["auto"])}
    ms = turns_ms({
        **{mode: (lambda m=mode: md_chain_of(modes[m], env.q32, env.cell32, rows[m], False))
           for mode in modes},
        "auto_plain": lambda: md_chain_of(modes["auto"], env.q32, env.cell32, rows["auto"], True),
    }, 1)
    ms = {k: v / CHAIN for k, v in ms.items()}
    if not bool(torch.isfinite(md_chain_of(modes["auto"], env.q32, env.cell32, rows["auto"],
                                           False)).all()):
        raise AssertionError("the P3M MD chain left its bucketing")
    emit({"phase": "p3m_slice", "atoms": N_ATOMS, "smearing": env.smearing, "nodes": NODES,
          "mesh_spacing": spacing, "error_bound": error_bound,
          "ns_mesh": NS_MESH, "create_seconds_three_modes": create_s,
          **{mode: out[mode] for mode in modes}, "energy_error_split_aligned": split,
          "ms_per_step": {"aligned": ms["auto"], "fused": ms["fused"], "tiled": ms["tiled"],
                          "aligned_plain_f32": ms["auto_plain"]},
          "nvidia_smi": env.smi})
    for mode in modes:
        check_bars(f"102k P3M step ({modes[mode].mesh_impl})", out[mode])
    if not all(math.isfinite(x) for x in ms.values()):
        raise AssertionError("non-finite P3M step times")
    if env.profile:
        profile_path("p3m_md_step_aligned",
                     lambda: md_chain_of(modes["auto"], env.q32, env.cell32, rows["auto"], False),
                     calls=2)
    del modes, rows

    # -- 12. the P3M per-atom call on the tiled mesh (kernels D, E, F) ---------
    calc = tpt.P3MCalculator(calc.potential, mesh_spacing=spacing, interpolation_nodes=NODES,
                             mesh_backend="tiled")
    interp = compute_tiled_interpolation(env.pos32, inv3(env.cell32), NS_MESH, NODES, "P3M")
    args = (env.pos32, env.q32, env.cell32, env.idx_t, env.shifts_t)
    kw = dict(ns_mesh=NS_MESH, tiled_interp=interp)
    kernels.reset_launch_counts()
    got = per_atom_call(calc, *args, torch.float32, False, **kw)
    sync()
    counts = kernels.launch_counts()
    if min(counts[k] for k in mesh_k) < 1:
        raise AssertionError(f"a kernel of the P3M per-atom call never launched: {counts}")
    call_counts = {k: counts[k] for k in mesh_k}
    errs = call_errors(got, per_atom_call(calc, *args, torch.float64, True, **kw))
    fwd_ms, fwd_plain_ms = alternate_ms(
        lambda plain: per_atom_call(calc, *args, torch.float32, plain, backward=False, **kw),
        CALL_REPEATS)
    full_ms, full_plain_ms = alternate_ms(
        lambda plain: per_atom_call(calc, *args, torch.float32, plain, **kw), CALL_REPEATS)
    emit({"phase": "p3m_per_atom_call", "atoms": N_ATOMS, "pairs": env.n_pairs, **errs,
          "energy_sum_pot_q_f32": float(got[4]), "launches": call_counts,
          "forward_ms": fwd_ms, "forward_plain_f32_ms": fwd_plain_ms,
          "forward_backward_ms": full_ms, "forward_backward_plain_f32_ms": full_plain_ms,
          "nvidia_smi": env.smi})
    check_call("102k P3M per-atom call", errs)
    if env.profile:
        profile_path("p3m_per_atom_forward_backward",
                     lambda: per_atom_call(calc, *args, torch.float32, False, **kw))
    return {"p3m_step": step_counts, "p3m_call": call_counts}


def ewald_phases(env) -> dict:
    """Phase 13: Ewald at 12,000 atoms: ``MDFastPathEwald`` energy + forces
    (kernel C for the window, the structure factor in PyTorch) and the
    ``EwaldCalculator`` per-atom call over a neighbor list (no kernel: pair
    list and structure factor in PyTorch), float32 against float64 plain."""
    tpt, kernels, dev = env.tpt, env.kernels, env.dev
    from torchpme_tpu_torch.utils.neighbors import neighbor_list

    positions, charges, cell = water_box(EWALD_N)
    lr_wavelength = ewald_lr(positions, charges, cell)
    calc = tpt.EwaldCalculator(tpt.CoulombPotential(smearing=EWALD_SMEARING),
                               lr_wavelength=lr_wavelength)
    ns_k = calc.get_ns_kvectors(cell)
    pos32, q32, cell32 = (torch.tensor(a, **env.f32) for a in (positions, charges, cell))
    fp = tpt.MDFastPathEwald.create(calc, positions.astype(np.float32), cell.astype(np.float32),
                                    CUTOFF)
    rows = fp.bucket(pos32)
    step = md_step_check(fp, q32, cell32, rows, ("window",),
                         ("spread_fwd", "spread_bwd", "mesh_spread", "mesh_gather", "mesh_wgrad"))
    step_ms, step_plain_ms = (t / CHAIN for t in alternate_ms(
        lambda plain: md_chain_of(fp, q32, cell32, rows, plain), 1))
    nl_idx, _, nl_shifts = neighbor_list(positions.astype(np.float32), cell, CUTOFF)
    idx, shifts = torch.as_tensor(nl_idx, device=dev), torch.as_tensor(nl_shifts, device=dev)
    args = (pos32, q32, cell32, idx, shifts)
    got = per_atom_call(calc, *args, torch.float32, False, ns_kvectors=ns_k)
    errs = call_errors(got, per_atom_call(calc, *args, torch.float64, True, ns_kvectors=ns_k))
    e_step_rel = abs(step["energy_f32"] - float(got[4])) / abs(float(got[4]))
    fwd_ms = turns_ms({"f": lambda: per_atom_call(calc, *args, torch.float32, False,
                                                  backward=False, ns_kvectors=ns_k)},
                      CALL_REPEATS)["f"]
    full_ms = turns_ms({"f": lambda: per_atom_call(calc, *args, torch.float32, False,
                                                   ns_kvectors=ns_k)}, CALL_REPEATS)["f"]
    emit({"phase": "ewald", "atoms": EWALD_N, "box": float(cell[0, 0]), "smearing": EWALD_SMEARING,
          "lr_wavelength": lr_wavelength, "ns_kvectors": ns_k, "k_vectors": int(np.prod(ns_k)), "pairs": int(nl_idx.shape[0]),
          "md_step": step, "md_ms_per_step": step_ms, "md_plain_f32_ms_per_step": step_plain_ms,
          "per_atom_call": errs, "md_step_energy_rel_vs_sum": e_step_rel,
          "forward_ms": fwd_ms, "forward_backward_ms": full_ms, "nvidia_smi": env.smi})
    if env.profile:
        profile_path("ewald_md_step", lambda: md_chain_of(fp, q32, cell32, rows, False), calls=2)
    check_bars("12k Ewald MD step", step)
    check_call("12k Ewald per-atom call", errs)
    if not e_step_rel <= 1e-5:
        raise AssertionError(f"Ewald MD step vs sum(pot*q): {e_step_rel:.3e}")
    return {"ewald_step": step["launches"]}


def p3m_ewald_accuracy(env) -> None:
    """Phase 14: the 1536-atom system of tools/validate_accuracy.py against
    tools/ground_truth.npz (the JAX package's float64 Ewald at
    lr_wavelength = smearing / 2): float32 P3M at 64^3 in tiled mode (5
    nodes) and float32 Ewald at the truth's own parameters (the 1e-4 bar);
    and the float32 P3M calculators at 1 and 2 nodes on the tiled backend
    against their float64 plain energy."""
    tpt, kernels = env.tpt, env.kernels
    gt = np.load(REPO / "tools" / "ground_truth.npz")
    f_ref = torch.tensor(gt["forces"], device=env.dev)
    e_truth = float(gt["energy"])
    gpos, gq, gcell = water_box(GT_N)
    gpos32, gq32, gcell32 = (torch.tensor(a, **env.f32) for a in (gpos, gq, gcell))
    pot = tpt.CoulombPotential(smearing=GT_SMEARING)
    out = {}

    def step(label, fp):
        grows = fp.bucket(gpos32).requires_grad_()
        kernels.reset_launch_counts()
        ge = fp.energy(gq32, gcell32, grows)
        (gg,) = torch.autograd.grad(ge, grows)
        sync()
        ge = float(ge.detach())
        out[label] = {"energy": ge, "energy_rel_vs_truth": abs(ge - e_truth) / abs(e_truth),
                      "force_rel_rms_vs_truth": rel_rms(-fp.unbucket(gg), f_ref),
                      "launches": {k: v for k, v in kernels.launch_counts().items() if v}}

    p3m = tpt.P3MCalculator(pot, mesh_spacing=GT_MESH_SPACING, interpolation_nodes=NODES)
    step("p3m_tiled", tpt.MDFastPath.create(p3m, gpos32, gcell32, CUTOFF, GT_TILED_NS,
                                            mesh_impl="tiled"))
    out["p3m_tiled"]["jax_f64_force_rel_rms_vs_truth"] = P3M_GT_JAX_F64_FORCE
    ewald = tpt.EwaldCalculator(pot, lr_wavelength=GT_SMEARING / 2)
    step("ewald", tpt.MDFastPathEwald.create(ewald, gpos32, gcell32, CUTOFF))
    out["ewald"]["ns_kvectors"] = ewald.get_ns_kvectors(gcell)
    clist = tpt.ops.compute_cell_list(gpos32, gcell32, CUTOFF)
    for nodes in P3M_SMALL_NODES:
        small = tpt.P3MCalculator(pot, mesh_spacing=GT_MESH_SPACING, interpolation_nodes=nodes,
                                  mesh_backend="tiled")
        kernels.reset_launch_counts()
        e32 = float(small.energy(gq32, gcell32, gpos32, cell_list=clist, ns_mesh=GT_TILED_NS))
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        e64 = float(small.energy(gq32.double(), gcell32.double(), gpos32.double(),
                                 cell_list=clist, ns_mesh=GT_TILED_NS, plain=True))
        out[f"p3m_{nodes}_nodes"] = {"energy_f32": e32, "energy_f64_plain": e64,
                                     "energy_rel": abs(e32 - e64) / abs(e64),
                                     "energy_rel_vs_truth": abs(e64 - e_truth) / abs(e_truth),
                                     "launches": launched}
    emit({"phase": "p3m_ewald_accuracy", "atoms": GT_N, "ns_mesh": GT_TILED_NS, **out})
    for label in ("p3m_tiled", "ewald"):
        acc = out[label]
        if not (acc["force_rel_rms_vs_truth"] <= GT_FORCE_BAR
                and acc["energy_rel_vs_truth"] <= GT_FORCE_BAR):
            raise AssertionError(f"1536-atom accuracy, {label}: {acc}")
    if not {"window", "mesh_spread", "mesh_wgrad"} <= set(out["p3m_tiled"]["launches"]):
        raise AssertionError(f"the P3M tiled step launched {out['p3m_tiled']['launches']}")
    if set(out["ewald"]["launches"]) != {"window"}:
        raise AssertionError(f"the Ewald step launched {out['ewald']['launches']}")
    for nodes in P3M_SMALL_NODES:
        acc = out[f"p3m_{nodes}_nodes"]
        if not (acc["energy_rel"] <= 1e-5 and "mesh_spread" in acc["launches"]):
            raise AssertionError(f"P3M at {nodes} node(s): {acc}")


def direct_f64_on_f32_pairs(potential, clist, q32, cell32, pos32):
    """Float64 reference of the direct-mode (unsmeared) cell-list energy on
    the pairs that the float32 inputs select.  The truncated 1/r jumps by
    q_i q_j / r_c at the cutoff, so a pair within float32 rounding of it may
    count in float32 and not in float64: the masks here come from the
    float32 window inputs, formed as the step forms them for kernel C
    (``_prepare`` with ``window=True``, ``_offset_pairs``, ``_extras_pairs``),
    and the values and the position gradient from float64.  Returns ``(energy, gradient, energy over the
    float64 pair set, pairs the two sets hold differently)``."""
    from torchpme_tpu_torch.ops import rspace_cells as rs

    def window_inputs(dtype, grad):
        pos = pos32.detach().to(dtype).requires_grad_(grad)
        q, cell = q32.to(dtype), cell32.to(dtype)
        pc_t, q_g, mf_g, offs, _ = rs._prepare(q, pos, cell, clist, window=True)
        extras = None
        if clist.extra_index is not None:
            extras = rs._prepare_extras(q, pos, cell, clist, window=True)[:3]
        return pos, cell, pc_t, q_g, mf_g, offs, extras

    with torch.no_grad():
        _, cell_s, pc_s, q_s, mf_s, offs_s, ex_s = window_inputs(torch.float32, False)
    pos, cell, pc_t, q_g, mf_g, offs, ex = window_inputs(torch.float64, True)
    dev, cap = pos.device, pc_t.shape[-1]
    eye = torch.eye(cap, dtype=torch.bool, device=dev)
    cut_s = torch.tensor(clist.cutoff, dtype=torch.float32, device=dev) ** 2
    cut = torch.tensor(clist.cutoff, dtype=torch.float64, device=dev) ** 2
    e = torch.zeros((), dtype=torch.float64, device=dev)
    e_own, flips = 0.0, 0
    for k, off in enumerate(rs._window_offsets(cap)):
        ok_s = rs._offset_pairs(pc_s, mf_s, offs_s, k, off, cut_s, eye)[2]
        _, d_sq, ok = rs._offset_pairs(pc_t, mf_g, offs, k, off, cut, eye)
        w = 0.5 if off == (0, 0, 0) else 1.0
        qq = torch.einsum("...ic,...jc->...ij", q_g,
                          torch.roll(q_g, tuple(-o for o in off), dims=(0, 1, 2)) * w)
        e = e + torch.sum(qq * rs._masked_pair_values(potential, d_sq, ok_s))
        with torch.no_grad():
            e_own += float(torch.sum(qq * rs._masked_pair_values(potential, d_sq, ok)))
            flips += int((ok != ok_s).sum())
    if ex is not None:  # the spill pairs, as _extras_energy sums them
        pe, pe_abs, qe = ex
        d2_em, ok_em, rows_q, _, d2_ee, ok_ee = rs._extras_pairs(
            pc_t, q_g, mf_g, pe, pe_abs, clist, cell, window=True)
        _, ok_em_s, _, _, _, ok_ee_s = rs._extras_pairs(
            pc_s, q_s, mf_s, ex_s[0], ex_s[1], clist, cell_s, window=True)
        qq_em = (rows_q * qe[:, None, None, :]).sum(-1).reshape(ok_em.shape)
        qq_ee = qe @ qe.T
        for em, ee, own in ((ok_em_s, ok_ee_s, False), (ok_em, ok_ee, True)):
            part = (torch.sum(qq_em * rs._masked_pair_values(potential, d2_em, em))
                    + 0.5 * torch.sum(qq_ee * rs._masked_pair_values(potential, d2_ee, ee)))
            if own:
                e_own += float(part.detach())
            else:
                e = e + part
        flips += int((ok_em != ok_em_s).sum() + (ok_ee != ok_ee_s).sum())
    (g,) = torch.autograd.grad(e, pos)
    return float(e.detach()), g, e_own, flips


def cell_list_phases(env) -> dict:
    """Phase 15: the per-atom call over a cell list at 102k
    (``PMECalculator(...)(charges, cell, positions, cell_list=clist)``:
    the real space in plain PyTorch, the mesh through kernels D, E, F)
    against the neighbor-list call in float64, forward and forward+backward;
    and the direct-mode energy over the same cell list through kernel C's
    unsmeared variant against its float32 plain version and against float64
    on the pairs the float32 inputs select (:func:`direct_f64_on_f32_pairs`)."""
    tpt, kernels = env.tpt, env.kernels
    clist = tpt.ops.compute_cell_list(env.positions.astype(np.float32), env.cell, CUTOFF,
                                      device=env.dev)
    calc = env.calc
    kw = dict(ns_mesh=NS_MESH, tiled_interp=env.interp)
    base = (env.pos32, env.q32, env.cell32)
    kernels.reset_launch_counts()
    got = per_atom_call(calc, *base, None, None, torch.float32, False, cell_list=clist, **kw)
    sync()
    counts = kernels.launch_counts()
    mesh_k = ("mesh_spread", "mesh_gather", "mesh_wgrad")
    if min(counts[k] for k in mesh_k) < 1:
        raise AssertionError(f"the cell-list call launched {counts}")
    ref = per_atom_call(calc, *base, env.idx_t, env.shifts_t, torch.float64, True, **kw)
    errs = call_errors(got, ref)
    same = per_atom_call(calc, *base, None, None, torch.float64, True, cell_list=clist, **kw)
    errs64 = call_errors(same, ref)
    del same
    fwd_ms = turns_ms({"f": lambda: per_atom_call(calc, *base, None, None, torch.float32, False,
                                                  backward=False, cell_list=clist, **kw)},
                      CALL_REPEATS)["f"]
    full_ms = turns_ms({"f": lambda: per_atom_call(calc, *base, None, None, torch.float32, False,
                                                   cell_list=clist, **kw)}, CALL_REPEATS)["f"]
    # direct mode: kernel C's unsmeared variant, against its plain version in
    # float32 and against float64 on the pair set the float32 inputs select
    direct = tpt.Calculator(tpt.CoulombPotential())
    direct_counts = {}
    res = {}
    for label, plain in (("kernel", False), ("plain_f32", True)):
        p = env.pos32.detach().requires_grad_()
        kernels.reset_launch_counts()
        e = direct.energy(env.q32, env.cell32, p, cell_list=clist, plain=plain)
        (g,) = torch.autograd.grad(e, p)
        sync()
        direct_counts[label] = kernels.launch_counts()["window"]
        res[label] = (float(e.detach()), g)
    kernels.reset_launch_counts()
    e64, g64, e64_own, flips = direct_f64_on_f32_pairs(direct.potential, clist, env.q32,
                                                       env.cell32, env.pos32)
    sync()
    direct_counts["reference_f64"] = kernels.launch_counts()["window"]
    e32, g32 = res["kernel"]
    direct_out = {
        "energy_f32": e32, "energy_f32_plain": res["plain_f32"][0],
        "energy_f64_on_f32_pairs": e64,
        "energy_rel_vs_f32_plain": abs(e32 - res["plain_f32"][0]) / abs(res["plain_f32"][0]),
        "force_rel_rms_vs_f32_plain": rel_rms(g32, res["plain_f32"][1]),
        "energy_rel_vs_f64": abs(e32 - e64) / abs(e64), "force_rel_rms_vs_f64": rel_rms(g32, g64),
        # informational: float64's own pair set differs from float32's by
        # pairs within rounding of the cutoff, each worth q_i q_j / r_c
        "pairs_held_differently_in_f64": flips, "energy_f64_on_own_pairs": e64_own,
        "launches": direct_counts,
        "ms": turns_ms({"f": lambda: direct.energy(env.q32, env.cell32, env.pos32,
                                                   cell_list=clist)}, CALL_REPEATS)["f"]}
    del res, g32, g64
    emit({"phase": "cell_list_per_atom_call", "atoms": N_ATOMS,
          "capacity": clist.slot_mask.shape[1],
          "spill_atoms": 0 if clist.extra_mask is None else int(clist.extra_mask.sum()),
          "f32_vs_neighbor_list_f64": errs, "f64_vs_neighbor_list_f64": errs64,
          "launches": {k: counts[k] for k in mesh_k}, "forward_ms": fwd_ms,
          "forward_backward_ms": full_ms, "direct_mode_energy": direct_out,
          "nvidia_smi": env.smi})
    if env.profile:
        profile_path("cell_list_per_atom_forward_backward",
                     lambda: per_atom_call(calc, *base, None, None, torch.float32, False,
                                           cell_list=clist, **kw))
        profile_path("direct_energy_over_cell_list",
                     lambda: direct.energy(env.q32, env.cell32, env.pos32, cell_list=clist))
    check_call("102k cell-list call", errs)
    if not all(v <= 1e-10 for v in errs64.values()):
        raise AssertionError(f"102k cell-list call vs the neighbor list in float64: {errs64}")
    d = direct_out
    if not (direct_counts == {"kernel": 1, "plain_f32": 0, "reference_f64": 0}
            and d["energy_rel_vs_f32_plain"] <= SUM_TOL and d["force_rel_rms_vs_f32_plain"] <= 1e-5
            and d["energy_rel_vs_f64"] <= 1e-5 and d["force_rel_rms_vs_f64"] <= 1e-5):
        raise AssertionError(f"102k direct-mode energy: {direct_out}")
    return {"direct_energy": {"window": direct_counts["kernel"]}}

def c_pair_flop(potential) -> int:
    """Kernel C's operations per pair inside the cutoff for ``potential``'s
    terms (``C_PAIR_COMMON``, ``C_TERM_FLOP``, ``C_MEMBER_FLOP``)."""
    from torchpme_tpu_torch.ops.rspace_cells import _window_terms

    terms = _window_terms(potential)
    form = "smeared" if potential.smearing is not None else "direct"
    flop = C_PAIR_COMMON + sum(C_TERM_FLOP[form][p] for _, p in terms)
    if len(terms) > 1 or type(potential).__name__ == "CombinedPotential":
        flop += C_MEMBER_FLOP * len(terms)
    return flop


def family_potentials(tpt, smearing, device=None) -> dict:
    """The potentials of the family phases, at the main path's smearing (on
    ``device``: the Combined weights live on the card, as its gradient)."""
    pots = {
        "ipl3": tpt.InversePowerLawPotential(exponent=3, smearing=smearing),
        "ipl6": tpt.InversePowerLawPotential(exponent=6, smearing=smearing),
        "combined": tpt.CombinedPotential(
            [tpt.CoulombPotential(smearing=smearing),
             tpt.InversePowerLawPotential(exponent=6, smearing=smearing)],
            initial_weights=torch.tensor(COMBINED_WEIGHTS, dtype=torch.float64),
            learnable_weights=True, smearing=smearing),
    }
    return {k: v.to(device) if device is not None else v for k, v in pots.items()}


def wpot_repr(potential) -> str:
    if type(potential).__name__ == "CombinedPotential":
        return "Combined(" + ", ".join(wpot_repr(p) for p in potential.potentials) + ")"
    if type(potential).__name__ == "CoulombPotential":
        return "Coulomb"
    return f"1/r^{potential.exponent}"


def family_step(fp, q32, cell32, rows32, expect):
    """One float32 step of ``fp`` through the kernels and the plain float64
    step on the same inputs, with dE/dw where the potential has learnable
    weights: errors, launches."""
    import torchpme_tpu_torch.kernels as kernels

    pot = fp.calc.potential
    weights = [pot.weights] if isinstance(getattr(pot, "weights", None), torch.nn.Parameter) else []
    out = {}
    for label, dtype, plain in (("f32", torch.float32, False), ("f64", torch.float64, True)):
        cell_g = cell32.to(dtype).detach().requires_grad_()
        rows_g = rows32.to(dtype).detach().requires_grad_()
        kernels.reset_launch_counts()
        e = fp.energy(q32.to(dtype), cell_g, rows_g, plain=plain)
        grads = torch.autograd.grad(e, [rows_g, cell_g, *weights])
        sync()
        out[label] = (float(e.detach()), *grads, kernels.launch_counts())
    (e32, gr32, gc32, *rest32), (e64, gr64, gc64, *rest64) = out["f32"], out["f64"]
    counts = rest32[-1]
    if min(counts[k] for k in expect) < 1 or any(rest64[-1].values()):
        raise AssertionError(f"the family step launched {counts} (plain: {rest64[-1]})")
    res = {"energy_f32": e32, "energy_f64_plain": e64, "energy_rel": abs(e32 - e64) / abs(e64),
           "force_rel_rms": rel_rms(fp.unbucket(gr32), fp.unbucket(gr64)),
           "cell_grad_rel": rel_err(gc32, gc64)[1],
           "launches": {k: counts[k] for k in expect}}
    if weights:
        res.update(weight_grad_f32=rest32[0].tolist(), weight_grad_f64=rest64[0].tolist(),
                   weight_grad_rel=rel_err(rest32[0], rest64[0])[1])
    return res


def charge_cell_split(fp, rows32, q32, cell32) -> dict:
    """The point-charge MD step's cell gradient in its window part (kernel
    C's image term, the spill pairs and the wrap) and mesh part, float32
    kernels and the plain float32 step against the plain float64 step on the
    same inputs (max abs error over max |float64 total|)."""
    from torchpme_tpu_torch.ops.rspace_cells import cell_list_rspace_energy_rows

    def parts(dtype, plain):
        r = rows32.to(dtype).detach().requires_grad_()
        c = cell32.to(dtype).detach().requires_grad_()
        q = q32.to(dtype)
        e_sr = cell_list_rspace_energy_rows(fp.calc.potential, q, r, c, fp.clist, plain=plain)
        e = fp.energy(q, c, r, plain=plain)
        (g_sr,) = torch.autograd.grad(e_sr, c)
        (g,) = torch.autograd.grad(e, c)
        return g_sr.double(), (g - g_sr).double()

    ref = parts(torch.float64, True)
    total = float((ref[0] + ref[1]).abs().max())
    out = {"total_max_abs": total}
    for label, plain in (("kernels", False), ("plain_f32", True)):
        got = parts(torch.float32, plain)
        for part, g, r in zip(("window", "mesh"), got, ref):
            out[f"{part}_{label}_rel"] = float((g - r).abs().max()) / total
    sync()
    return out


def family_phases(env) -> dict:
    """Phases 16-18: the 102k MD step over 1/r^3, 1/r^6 and a learnable
    Combined (Coulomb + 1/r^6) in aligned mode (kernels A, B, C; C through
    its pair-term table), kernel path and plain path in turns, float32
    against float64 (and dE/dw); the 102k per-atom Combined PMECalculator
    call over the neighbor list (D, E, F); the extras tile table against the
    scatter at the main path's spills and at a forced >= 512."""
    tpt, kernels = env.tpt, env.kernels
    launches = {}
    pos_f32, cell_f32 = env.positions.astype(np.float32), env.cell.astype(np.float32)
    for label, potential in family_potentials(tpt, env.smearing, env.dev).items():
        calc = tpt.PMECalculator(potential, interpolation_nodes=NODES)
        fp = tpt.MDFastPath.create(calc, pos_f32, cell_f32, CUTOFF, NS_MESH)
        if fp.mesh_impl != "aligned":
            raise AssertionError(f"{label}: MDFastPath took {fp.mesh_impl}")
        rows = fp.bucket(env.pos32)
        res = family_step(fp, env.q32, env.cell32, rows, ("spread_fwd", "spread_bwd", "window"))
        def chain(plain, fp=fp, rows=rows):
            return md_chain_of(fp, env.q32, env.cell32, rows, plain, step=FAMILY_CHAIN_STEP)

        ms = turns_ms({"kernel": lambda: chain(False), "plain": lambda: chain(True)}, 1)
        if not bool(torch.isfinite(chain(False)).all()):
            raise AssertionError(f"the {label} MD chain left its bucketing")
        split = charge_cell_split(fp, rows, env.q32, env.cell32)
        emit({"phase": f"{label}_slice", "potential": wpot_repr(potential), "atoms": N_ATOMS,
              **res, "cell_grad_split": split, "ms_per_step": ms["kernel"] / CHAIN,
              "plain_f32_ms_per_step": ms["plain"] / CHAIN, "nvidia_smi": env.smi})
        if env.profile:
            profile_path(f"md_step_{label}", lambda: chain(False), calls=2)
        check_bars(f"102k {label} step", res)
        if "weight_grad_rel" in res and not res["weight_grad_rel"] <= WEIGHT_GRAD_TOL:
            raise AssertionError(f"102k {label} step dE/dw: {res}")
        launches[f"{label}_step"] = res["launches"]
        del fp, rows

    # the per-atom Combined call over the neighbor list: D, E, F
    pot = family_potentials(tpt, env.smearing, env.dev)["combined"]
    calc = tpt.PMECalculator(pot, interpolation_nodes=NODES)
    kw = dict(ns_mesh=NS_MESH, tiled_interp=env.interp)
    base = (env.pos32, env.q32, env.cell32)

    def with_weights(dtype, plain):
        from torchpme_tpu_torch.utils.neighbors import compute_distances

        p = env.pos32.to(dtype).detach().requires_grad_()
        q = env.q32.to(dtype).detach().requires_grad_()
        c = env.cell32.to(dtype).detach().requires_grad_()
        pot_i = calc(q, c, p, env.idx_t, compute_distances(p, env.idx_t, c, env.shifts_t),
                     plain=plain, **kw)
        total = torch.sum(pot_i * q)
        grads = torch.autograd.grad(total, (p, q, c, pot.weights))
        return (pot_i.detach(), *grads[:3], total.detach()), grads[3]

    kernels.reset_launch_counts()
    got, w32 = with_weights(torch.float32, False)
    sync()
    counts = kernels.launch_counts()
    mesh_k = ("mesh_spread", "mesh_gather", "mesh_wgrad")
    if min(counts[k] for k in mesh_k) < 1:
        raise AssertionError(f"the Combined per-atom call launched {counts}")
    ref, w64 = with_weights(torch.float64, True)
    errs = call_errors(got, ref)
    errs["weight_grad_rel"] = rel_err(w32, w64)[1]
    del got, ref
    fwd_ms = turns_ms({"f": lambda: per_atom_call(calc, *base, env.idx_t, env.shifts_t,
                                                  torch.float32, False, False, **kw)},
                      CALL_REPEATS)["f"]
    full_ms = turns_ms({"f": lambda: with_weights(torch.float32, False)}, CALL_REPEATS)["f"]
    emit({"phase": "combined_per_atom_call", "atoms": N_ATOMS, "potential": wpot_repr(pot),
          "f32_vs_f64_plain": errs, "weight_grad_f32": w32.tolist(), "weight_grad_f64": w64.tolist(),
          "launches": {k: counts[k] for k in mesh_k}, "forward_ms": fwd_ms,
          "forward_backward_with_weights_ms": full_ms, "nvidia_smi": env.smi})
    if env.profile:
        profile_path("combined_per_atom_forward_backward",
                     lambda: with_weights(torch.float32, False))
    check_call("102k Combined per-atom call", errs)
    if not errs["weight_grad_rel"] <= WEIGHT_GRAD_TOL:
        raise AssertionError(f"102k Combined per-atom call dE/dw: {errs}")
    launches["combined_call"] = {k: counts[k] for k in mesh_k}
    launches.update(extras_phase(env, pos_f32, cell_f32))
    return launches


def extras_phase(env, pos_f32, cell_f32) -> dict:
    """The aligned step with the extras tile table (``extras_impl="tiled"``:
    refresh + kernel D, E + F backward) against the scatter, at the main
    path's spills and at a forced >= EXTRAS_FORCED (an unbalanced cell list
    at the largest capacity that spills that many): wall and device ms per
    step in turns, energy, forces and cell gradient agreement in float32 and
    in float64 (plain), and each float32 step against its float64 step."""
    tpt, kernels = env.tpt, env.kernels
    calc = env.calc
    out, launches = {}, {}
    configs = [("main", {})]
    for capacity in range(26, 16, -1):
        clist = tpt.ops.compute_cell_list(pos_f32, cell_f32, CUTOFF, capacity=capacity, spill=True,
                                          xy_cells=(NS_MESH[0] // 8, NS_MESH[1] // 8),
                                          balance=False, device="cpu")
        if int(clist.extra_mask.sum()) >= EXTRAS_FORCED:
            configs.append(("forced", dict(cell_capacity=capacity, balance=False, _spill=True)))
            break
    for label, kw in configs:
        fps = {impl: tpt.MDFastPath.create(calc, pos_f32, cell_f32, CUTOFF, NS_MESH,
                                           mesh_impl="aligned", extras_impl=impl, **kw)
               for impl in ("tiled", "scatter")}
        auto = tpt.MDFastPath.create(calc, pos_f32, cell_f32, CUTOFF, NS_MESH, mesh_impl="aligned",
                                     extras_impl="auto", **kw).extras_tiled is not None
        res, res64 = {}, {}
        for impl, fp in fps.items():
            for dtype, plain, out in ((torch.float32, False, res), (torch.float64, True, res64)):
                rows = fp.bucket(env.pos32).to(dtype).requires_grad_()
                # detached: `.to` of the same dtype is env.cell32 itself
                cell_g = env.cell32.to(dtype).detach().requires_grad_()
                kernels.reset_launch_counts()
                e = fp.energy(env.q32.to(dtype), cell_g, rows, plain=plain)
                g_rows, g_cell = torch.autograd.grad(e, (rows, cell_g))
                sync()
                out[impl] = (float(e.detach()), fp.unbucket(g_rows).double(), g_cell.double(),
                             kernels.launch_counts())
        (e_t, f_t, c_t, n_t), (e_s, f_s, c_s, _) = res["tiled"], res["scatter"]
        (e_t64, f_t64, c_t64, _), (e_s64, f_s64, c_s64, _) = res64["tiled"], res64["scatter"]
        vs_f64 = {impl: {"energy_rel": abs(res[impl][0] - res64[impl][0]) / abs(res64[impl][0]),
                         "force_rel_rms": rel_rms(res[impl][1], res64[impl][1]),
                         "cell_grad_rel": rel_err(res[impl][2], res64[impl][2])[1]}
                  for impl in fps}
        rows_t, rows_s = fps["tiled"].bucket(env.pos32), fps["scatter"].bucket(env.pos32)
        ms = turns_ms({"tiled": lambda: md_chain_of(fps["tiled"], env.q32, env.cell32, rows_t,
                                                    False),
                       "scatter": lambda: md_chain_of(fps["scatter"], env.q32, env.cell32, rows_s,
                                                      False)}, 1)
        device = {impl: device_ms_per_call(
            lambda impl=impl, r=r: md_chain_of(fps[impl], env.q32, env.cell32, r, False)) / CHAIN
            for impl, r in (("tiled", rows_t), ("scatter", rows_s))}
        line = {"phase": "extras_tiled", "spills": label,
                "spill_atoms": int(fps["tiled"].clist.extra_mask.sum()),
                "cell_capacity": fps["tiled"].clist.slot_mask.shape[1],
                "energy_rel_tiled_vs_scatter": abs(e_t - e_s) / abs(e_s),
                "force_rel_rms_tiled_vs_scatter": rel_rms(f_t, f_s),
                "cell_grad_rel_tiled_vs_scatter": rel_err(c_t, c_s)[1],
                "f64_tiled_vs_scatter": {"energy_rel": abs(e_t64 - e_s64) / abs(e_s64),
                                         "force_rel_rms": rel_rms(f_t64, f_s64),
                                         "cell_grad_rel": rel_err(c_t64, c_s64)[1]},
                "f32_vs_f64": vs_f64,
                "tiled_ms_per_step": ms["tiled"] / CHAIN, "scatter_ms_per_step": ms["scatter"] / CHAIN,
                "tiled_device_ms_per_step": device["tiled"],
                "scatter_device_ms_per_step": device["scatter"],
                "auto_takes_table": auto, "launches_tiled": n_t, "nvidia_smi": env.smi}
        emit(line)
        if not (line["energy_rel_tiled_vs_scatter"] <= EXTRAS_TOL
                and line["force_rel_rms_tiled_vs_scatter"] <= EXTRAS_TOL
                and max(line["f64_tiled_vs_scatter"].values()) <= EXTRAS_F64_TOL
                and n_t["mesh_spread"] >= 1 and n_t["window"] >= 1):
            raise AssertionError(f"extras tile table ({label}): {line}")
        for impl, errs in vs_f64.items():
            check_bars(f"extras {impl} ({label})", errs)
        launches[f"extras_{label}_step"] = {k: n_t[k] for k in n_t}
        del fps
    if len(configs) < 2:
        raise AssertionError(f"no capacity from 26 down to 17 spills {EXTRAS_FORCED} atoms")
    return launches


class TimedCandidates:
    """Records each candidate that the port's ``TuningTimings`` and the
    dipolar tuners' timer time (its calculator, the seconds per step and the
    kernel launches it made), around the timers' own ``__call__``."""

    def __init__(self, kernels):
        from torchpme_tpu_torch.tuning import dipole, tuner

        self.kernels, self.rows = kernels, []
        self._timers = (tuner.TuningTimings, dipole._DipoleTimings)
        self._calls = [t.__call__ for t in self._timers]

    def __enter__(self):
        def wrap(call):
            def timed(timer, calculator, **extra):
                before = self.kernels.launch_counts()
                seconds = call(timer, calculator, **extra)
                after = self.kernels.launch_counts()
                self.rows.append({"calculator": calculator, "extra": extra, "seconds": seconds,
                                  "n_pairs": int((timer.idx if hasattr(timer, "idx")
                                                  else timer.neighbor_indices).shape[0]),
                                  "launches": {k: after[k] - before[k] for k in after
                                               if after[k] > before[k]}})
                return seconds
            return timed

        for t, call in zip(self._timers, self._calls):
            t.__call__ = wrap(call)
        return self

    def __exit__(self, *exc):
        for t, call in zip(self._timers, self._calls):
            t.__call__ = call


def mesh_candidate(row, bounds, cutoff) -> dict:
    """A timed mesh candidate as printed: its parameters, the backend its
    mesh took, its error bound and its seconds per forward+backward."""
    from torchpme_tpu_torch.ops.mesh_tiled import supports_tiling

    calc = row["calculator"]
    ns = tuple(row["extra"]["ns_mesh"])
    smearing = float(calc.potential.smearing)
    return {"cutoff": cutoff, "smearing": smearing, "nodes": calc.interpolation_nodes,
            "mesh_spacing": calc.mesh_spacing, "ns_mesh": ns,
            "mesh_backend": "tiled" if supports_tiling(ns, calc.interpolation_nodes) else "scatter",
            "error_bound": float(bounds(smearing=smearing, mesh_spacing=calc.mesh_spacing,
                                        cutoff=cutoff,
                                        interpolation_nodes=calc.interpolation_nodes)),
            "seconds": row["seconds"], "launches": row["launches"]}


def _filtered(idx, dist, cutoff):
    """The pairs of a neighbor list (indices, distances) closer than ``cutoff``."""
    keep = dist < cutoff
    return idx[keep], dist[keep]


def abs_rms_force(forces, ref) -> float:
    """Absolute RMS of the force error per atom, sqrt(mean |F - F_ref|^2)."""
    return float(torch.sqrt(torch.mean(torch.sum((forces.double() - ref.double()) ** 2, -1))))


def dipole_tuning_box():
    """``(positions, dipoles, cell)`` of the dipolar tuners' system: 7^3
    dipoles on a cubic lattice at density 0.1, each moved by up to 0.3 Å
    (seed 11, no pair closer than ~1.5 Å: float32 forces of a few units),
    normal dipoles."""
    rng = np.random.default_rng(11)
    box = float((DIPOLE_TUNE_SIDE**3 / 0.1) ** (1 / 3))
    grid = np.stack(np.meshgrid(*[np.arange(DIPOLE_TUNE_SIDE)] * 3, indexing="ij"), -1)
    positions = (grid.reshape(-1, 3) + 0.5) * (box / DIPOLE_TUNE_SIDE)
    positions += rng.uniform(-0.3, 0.3, positions.shape)
    return positions, rng.normal(size=positions.shape), np.eye(3) * box


def tuning_phases(env) -> dict:
    """Phase 19: the port's tuning module on the card, float32.  (a) The
    main path's parameters chosen by the port: ``tune_over_cutoffs(tune_pme)``
    on the 102k box over one 5.5 Å neighbor list, every timed candidate with
    its backend and bound, the pick run in float32 against float64 plain;
    (b) ``tune_p3m`` at 102k, ``tune_ewald`` at 12k and ``tune_pme`` on the
    1536-atom truth box (its force error against tools/ground_truth.npz);
    (c) the dipolar tuners at 343 dipoles; (d) one labeled
    ``atomistic.PMECalculator`` call at 102k against the plain calculator.
    Returns the launches of the PME tuning and of ``tune_pme_dipole``."""
    tpt, kernels, dev, f32 = env.tpt, env.kernels, env.dev, env.f32
    from torchpme_tpu_torch import atomistic
    from torchpme_tpu_torch.tuning import (
        P3MErrorBounds,
        PMEErrorBounds,
        tune_ewald,
        tune_ewald_dipole,
        tune_over_cutoffs,
        tune_p3m,
        tune_pme,
        tune_pme_dipole,
    )
    from torchpme_tpu_torch.utils.neighbors import compute_distances, neighbor_list

    t_phase = time.perf_counter()
    cpu_inputs = _cpu(env.charges, env.cell, env.positions)

    # -- (a) tune_over_cutoffs(tune_pme) at 102k ----------------------------------
    cut_max = max(TUNE_CUTOFFS)
    t0 = time.perf_counter()
    nl_idx, _, nl_shifts = neighbor_list(env.positions.astype(np.float32), env.cell, cut_max)
    nl_s = time.perf_counter() - t0
    idx = torch.as_tensor(nl_idx, device=dev)
    shifts = torch.as_tensor(nl_shifts, device=dev)
    with torch.no_grad():
        dist = compute_distances(env.pos32, idx, env.cell32, shifts)
    dist_host = dist.cpu().numpy()
    cutoff_of = {int((dist_host < c).sum()): c for c in TUNE_CUTOFFS}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with TimedCandidates(kernels) as rec:
        pick = tune_over_cutoffs(tune_pme, env.q32, env.cell32, env.pos32, TUNE_CUTOFFS, idx, dist,
                                 accuracy=ACCURACY, **TUNE_GRID)
    sync()
    tune_s = time.perf_counter() - t0
    tune_counts = kernels.launch_counts()
    bounds = PMEErrorBounds(*cpu_inputs)
    timed = [mesh_candidate(row, bounds, cutoff_of[row["n_pairs"]]) for row in rec.rows]
    cutoff, smearing, params, seconds = pick
    # the tuner's smearing at the main path's cutoff against bench.py's
    # formula on the same (float32-rounded) charges and cell, and against the
    # main path's smearing from the float64 ones
    at_main = {c["smearing"] for c in timed if c["cutoff"] == CUTOFF}
    tuned_main = at_main.pop() if len(at_main) == 1 else float("nan")
    formula = bench_smearing(env.q32.cpu().numpy(), env.cell32.cpu().numpy())
    smearing_rel = abs(tuned_main - formula) / formula
    smearing_rel_main = abs(tuned_main - env.smearing) / env.smearing
    # the pick in float32 (kernels) against float64 (plain) on the same inputs
    # and the mesh the tuner timed: the candidates' spacing 2·box/(2^m - 1)
    # puts 2·box/spacing + 1 at 2^m up to rounding, so get_ns_mesh of the
    # float64 cell may round to 2^(m+1) where the float32 cell gives 2^m
    keep = torch.as_tensor(dist_host < cutoff, device=dev)
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=smearing), **params)
    ns_pick = calc.get_ns_mesh(env.cell32)
    args = (env.pos32, env.q32, env.cell32, idx[keep], shifts[keep])
    got = per_atom_call(calc, *args, torch.float32, False, ns_mesh=ns_pick)
    pick_errs = call_errors(got, per_atom_call(calc, *args, torch.float64, True, ns_mesh=ns_pick))
    # the pick against the main path's parameters (5 A, 5 nodes, 128^3), timed
    # by the tuner's own timer in turns (pick, main, main, pick, twice)
    from torchpme_tpu_torch.tuning import TuningTimings

    rivals = {"pick": (cutoff, calc, ns_pick),
              "main_path": (CUTOFF, tpt.PMECalculator(tpt.CoulombPotential(smearing=tuned_main),
                                                      interpolation_nodes=NODES,
                                                      mesh_spacing=2 * float(env.cell[0, 0]) / 127),
                            NS_MESH)}
    turns = {name: [] for name in rivals}
    timers = {name: TuningTimings(env.q32, env.cell32, env.pos32, *_filtered(idx, dist, c))
              for name, (c, _, _) in rivals.items()}
    for name in ["pick", "main_path", "main_path", "pick"] * 2:
        _, rival, ns = rivals[name]
        turns[name].append(timers[name](rival, ns_mesh=ns))
    del timers
    emit({"phase": "tune_pme_102k", "atoms": N_ATOMS, "cutoffs": TUNE_CUTOFFS,
          "grid": TUNE_GRID, "accuracy": ACCURACY, "pairs_at_max_cutoff": int(nl_idx.shape[0]),
          "neighbor_list_seconds": nl_s, "tuning_seconds": tune_s, "timed": timed,
          "pick": {"cutoff": cutoff, "smearing": smearing, **params, "seconds": seconds,
                   "ns_mesh": ns_pick, "ns_mesh_of_the_float64_cell": calc.get_ns_mesh(env.cell)},
          "main_path": {"cutoff": CUTOFF, "smearing": env.smearing, "nodes": NODES,
                        "ns_mesh": NS_MESH},
          "smearing_at_5A": tuned_main, "smearing_rel_vs_formula": smearing_rel,
          "smearing_rel_vs_main_path_f64_charges": smearing_rel_main,
          "pick_f32_vs_f64": pick_errs,
          "pick_vs_main_path_in_turns_seconds": turns,
          "launches": {k: v for k, v in tune_counts.items() if v}, "nvidia_smi": env.smi})
    if not timed or max(c["error_bound"] for c in timed) > ACCURACY:
        raise AssertionError(f"a timed candidate is above {ACCURACY}: {timed}")
    if not smearing_rel <= 1e-12:
        raise AssertionError(f"the tuner's smearing at {CUTOFF} A: {tuned_main} vs {formula}")
    if min(tune_counts[k] for k in ("mesh_spread", "mesh_gather", "mesh_wgrad")) < 1:
        raise AssertionError(f"the PME tuning did not launch D, E and F: {tune_counts}")
    if not (pick_errs["energy_rel"] <= 1e-5 and pick_errs["force_rel_rms"] <= 1e-5):
        raise AssertionError(f"the pick's float32 call vs float64: {pick_errs}")
    del got, dist, idx, shifts, keep

    # -- (b) tune_p3m at 102k, tune_ewald at 12k, tune_pme on the truth box -------
    with torch.no_grad():
        dist5 = compute_distances(env.pos32, env.idx_t, env.cell32, env.shifts_t)
    with TimedCandidates(kernels) as rec:
        t0 = time.perf_counter()
        p3m_pick = tune_p3m(env.q32, env.cell32, env.pos32, CUTOFF, env.idx_t, dist5,
                            accuracy=ACCURACY)
        sync()
        p3m_s = time.perf_counter() - t0
    p3m_timed = [mesh_candidate(row, P3MErrorBounds(*cpu_inputs), CUTOFF) for row in rec.rows]
    del dist5
    epos, eq, ecell = water_box(EWALD_N)
    e_idx, _, e_shifts = neighbor_list(epos.astype(np.float32), ecell, CUTOFF)
    epos32, eq32, ecell32 = (torch.tensor(a, **f32) for a in (epos, eq, ecell))
    e_idx = torch.as_tensor(e_idx, device=dev)
    with torch.no_grad():
        e_dist = compute_distances(epos32, e_idx, ecell32, torch.as_tensor(e_shifts, device=dev))
    with TimedCandidates(kernels) as rec:
        t0 = time.perf_counter()
        ewald_pick = tune_ewald(eq32, ecell32, epos32, CUTOFF, e_idx, e_dist, accuracy=ACCURACY,
                                **EWALD_TUNE_GRID)
        sync()
        ewald_s = time.perf_counter() - t0
    ewald_timed = [{"lr_wavelength": row["calculator"].lr_wavelength,
                    "ns_kvectors": tuple(row["extra"]["ns_kvectors"]), "seconds": row["seconds"]}
                   for row in rec.rows]
    gpos, gq, gcell = water_box(GT_N)
    g_idx, _, g_shifts = neighbor_list(gpos.astype(np.float32), gcell, CUTOFF)
    gpos32, gq32, gcell32 = (torch.tensor(a, **f32) for a in (gpos, gq, gcell))
    g_idx, g_shifts = torch.as_tensor(g_idx, device=dev), torch.as_tensor(g_shifts, device=dev)
    with torch.no_grad():
        g_dist = compute_distances(gpos32, g_idx, gcell32, g_shifts)
    t0 = time.perf_counter()
    g_smearing, g_params, g_seconds = tune_pme(gq32, gcell32, gpos32, CUTOFF, g_idx, g_dist,
                                               accuracy=ACCURACY)
    sync()
    g_s = time.perf_counter() - t0
    g_calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=g_smearing), **g_params)
    g_ns = g_calc.get_ns_mesh(gcell32)
    f_truth = torch.tensor(np.load(REPO / "tools" / "ground_truth.npz")["forces"], device=dev)
    g_args = (gpos32, gq32, gcell32, g_idx, g_shifts)
    truth_err = {}
    for label, dtype, plain in (("f32", torch.float32, False), ("f64_plain", torch.float64, True)):
        grad_positions = per_atom_call(g_calc, *g_args, dtype, plain, ns_mesh=g_ns)[1]
        truth_err[label] = abs_rms_force(-grad_positions, f_truth)
    emit({"phase": "tune_others", "accuracy": ACCURACY,
          "p3m_102k": {"cutoff": CUTOFF, "pick": {"smearing": p3m_pick[0], **p3m_pick[1],
                                                  "seconds": p3m_pick[2]},
                       "timed": p3m_timed, "tuning_seconds": p3m_s},
          "ewald_12k": {"cutoff": CUTOFF, "pick": {"smearing": ewald_pick[0], **ewald_pick[1],
                                                   "seconds": ewald_pick[2]},
                        "grid": EWALD_TUNE_GRID, "timed": ewald_timed, "tuning_seconds": ewald_s},
          "pme_1536": {"cutoff": CUTOFF, "pick": {"smearing": g_smearing, **g_params,
                                                  "seconds": g_seconds,
                                                  "ns_mesh": g_ns},
                       "tuning_seconds": g_s,
                       "abs_rms_force_error_vs_truth": truth_err,
                       "ratio_to_accuracy": {k: v / ACCURACY for k, v in truth_err.items()}},
          "nvidia_smi": env.smi})
    for label, timed_list in (("P3M", p3m_timed), ("Ewald", ewald_timed)):
        if not timed_list:
            raise AssertionError(f"the {label} tuner timed no candidate")
    if max(c["error_bound"] for c in p3m_timed) > ACCURACY:
        raise AssertionError(f"a timed P3M candidate is above {ACCURACY}: {p3m_timed}")
    if not all(math.isfinite(x) for x in (p3m_pick[2], ewald_pick[2], g_seconds,
                                          *truth_err.values())):
        raise AssertionError("a tuner returned no timed candidate, or a non-finite error")

    # -- (c) the dipolar tuners at 343 dipoles ------------------------------------
    dpos, dmu, dcell = dipole_tuning_box()
    d_idx, _, d_shifts = neighbor_list(dpos.astype(np.float32), dcell, DIPOLE_TUNE_CUTOFF)
    dpos32, dmu32, dcell32 = (torch.tensor(a, **f32) for a in (dpos, dmu, dcell))
    d_idx, d_shifts = torch.as_tensor(d_idx, device=dev), torch.as_tensor(d_shifts, device=dev)
    d_vec = dpos32[d_idx[:, 1]] - dpos32[d_idx[:, 0]] + d_shifts.to(torch.float32) @ dcell32
    dipole_out, dipole_counts = {}, {}
    for name, tune in (("ewald", tune_ewald_dipole), ("pme", tune_pme_dipole)):
        kernels.reset_launch_counts()
        with TimedCandidates(kernels) as rec:
            t0 = time.perf_counter()
            d_smearing, d_params, d_seconds = tune(dmu32, dcell32, dpos32, DIPOLE_TUNE_CUTOFF,
                                                   d_idx, d_vec, d_shifts, accuracy=1e-3)
            sync()
            d_s = time.perf_counter() - t0
        dipole_counts[name] = {k: v for k, v in kernels.launch_counts().items() if v}
        dipole_out[name] = {"pick": {"smearing": d_smearing, **d_params, "seconds": d_seconds},
                            "timed": [{"seconds": r["seconds"], "launches": r["launches"]}
                                      for r in rec.rows],
                            "tuning_seconds": d_s, "launches": dipole_counts[name]}
    emit({"phase": "tune_dipoles", "dipoles": int(dpos.shape[0]), "box": float(dcell[0, 0]),
          "cutoff": DIPOLE_TUNE_CUTOFF, "accuracy": 1e-3, **dipole_out, "nvidia_smi": env.smi})
    if not all(math.isfinite(v["pick"]["seconds"]) for v in dipole_out.values()):
        raise AssertionError(f"a dipolar tuner met no candidate: {dipole_out}")
    if min(dipole_counts["pme"].get(k, 0) for k in ("mesh_spread", "mesh_gather",
                                                     "mesh_wgrad")) < 1:
        raise AssertionError(f"tune_pme_dipole did not launch D, E and F: {dipole_counts}")

    # -- (d) one labeled atomistic.PMECalculator call at 102k ---------------------
    system = atomistic.System(torch.zeros(N_ATOMS, dtype=torch.int32, device=dev), env.pos32,
                              env.cell32).add_data("charge", env.q32)
    vectors = (env.pos32[env.idx_t[:, 1]] - env.pos32[env.idx_t[:, 0]]
               + env.shifts_t.to(torch.float32) @ env.cell32)
    neighbors = atomistic.NeighborList(torch.cat([env.idx_t, env.shifts_t], dim=1), vectors)
    labeled_calc = atomistic.PMECalculator(env.calc.potential, interpolation_nodes=NODES)
    kw = dict(ns_mesh=NS_MESH, tiled_interp=env.interp)
    kernels.reset_launch_counts()
    labeled = labeled_calc(system, neighbors, **kw).values
    sync()
    labeled_counts = {k: v for k, v in kernels.launch_counts().items() if v}
    plain = env.calc(env.q32, env.cell32, env.pos32, neighbors.indices, neighbors.distances, **kw)
    f32_rel = rel_err(labeled, plain)[1]
    # bitwise: the same call in float64 through the plain versions, with
    # PyTorch's deterministic algorithms (the kernels' float atomics and
    # index_add's sum in another order each run)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        sys64 = atomistic.System(system.types, env.pos32.double(), env.cell32.double()).add_data(
            "charge", env.q32.double())
        nb64 = atomistic.NeighborList(neighbors.samples, vectors.double())
        labeled64 = labeled_calc(sys64, nb64, plain=True, **kw).values
        plain64 = env.calc(sys64.get_data("charge"), sys64.cell, sys64.positions, nb64.indices,
                           nb64.distances, plain=True, **kw)
        bitwise = bool(torch.equal(labeled64, plain64))
    finally:
        torch.use_deterministic_algorithms(False)
    emit({"phase": "labeled_call", "atoms": N_ATOMS, "f32_rel_vs_plain_calculator": f32_rel,
          "f64_bitwise_equal": bitwise, "launches": labeled_counts,
          "phase_seconds": time.perf_counter() - t_phase, "nvidia_smi": env.smi})
    if not (bitwise and f32_rel <= KERNEL_TOL and "mesh_spread" in labeled_counts):
        raise AssertionError(f"labeled call: f32 {f32_rel:.3e}, f64 bitwise {bitwise}, "
                             f"launches {labeled_counts}")
    return {"tuning_pme": {k: v for k, v in tune_counts.items() if v},
            "tuning_pme_dipole": dipole_counts["pme"]}


def device_ms_per_call(fn, calls: int = 2) -> float:
    """Device time per call of ``fn`` by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in on_device) / 1e3 / calls


def main() -> int:
    # -- 1. device --------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--cell-split" in sys.argv[1:]:
        return cell_split_of(Path(sys.argv[sys.argv.index("--cell-split") + 1]))
    sys.path.insert(0, str(REPO))
    import torchpme_tpu_torch as tpt
    from torchpme_tpu_torch import kernels
    from torchpme_tpu_torch.ops import mesh_kernels as mk
    from torchpme_tpu_torch.ops import spread_fused as sf
    from torchpme_tpu_torch.ops.math import inv3
    from torchpme_tpu_torch.ops.mesh_tiled import _slot_values, compute_tiled_interpolation
    from torchpme_tpu_torch.ops.rspace_cells import (
        _prepare_bucketed,
        _we_value_and_grad,
        _window_group,
        _window_offsets,
        window_value_and_grad,
    )
    from torchpme_tpu_torch.ops.spread_fused import (
        SpreadGeometry,
        aligned_geometry,
        fused_spread,
        fused_spread_bwd,
        spread_plain,
        spread_plain_bwd,
    )
    from torchpme_tpu_torch.utils.neighbors import compute_distances, neighbor_list

    # float32 products in full float32, stated rather than assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = tpt.default_device()
    profile = "--profile" in sys.argv[1:]
    smi = card_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": kind})

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.load_library()
    # ptxas per kernel entry: registers, spill stores and loads (a cached
    # library was built by an earlier run and carries no log)
    ptxas, entry = {}, ""
    for ln in built.build_log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif entry and ("registers" in ln or "spill" in ln):
            ptxas[entry] = (ptxas.get(entry, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built.build_seconds, "ptxas": ptxas})
    if profile:
        sass_atomics(kernels, built.path)

    # -- the 102k system (host build; the state lands on the card by default) ---
    positions, charges, cell = water_box(N_ATOMS)
    smearing = smearing_for(positions, charges, cell)
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=smearing), interpolation_nodes=NODES)
    f32 = dict(dtype=torch.float32, device=dev)
    pos32 = torch.tensor(positions, **f32)
    q32 = torch.tensor(charges, **f32)
    cell32 = torch.tensor(cell, **f32)
    t0 = time.perf_counter()
    fp = tpt.MDFastPath.create(calc, positions.astype(np.float32), cell.astype(np.float32),
                               CUTOFF, NS_MESH)
    create_s = time.perf_counter() - t0
    if fp.row_of_atom.device.type != dev.type or fp.mesh_impl != "aligned":
        raise AssertionError("MDFastPath.create: the state is not on the card, or not aligned")
    n_extra = 0 if fp.clist.extra_mask is None else int(fp.clist.extra_mask.sum())
    emit({"phase": "create", "seconds": create_s, "smearing": smearing,
          "cell_grid": fp.cell_grid, "aligned_pad": fp.aligned_pad,
          "n_rows": fp.n_rows, "spill_atoms": n_extra})
    rows32 = fp.bucket(pos32)

    t0 = time.perf_counter()
    nl_idx, _, nl_shifts = neighbor_list(positions.astype(np.float32), cell, CUTOFF)
    nl_s = time.perf_counter() - t0
    idx_t = torch.as_tensor(nl_idx, device=dev)
    shifts_t = torch.as_tensor(nl_shifts, device=dev)
    t0 = time.perf_counter()
    interp = compute_tiled_interpolation(pos32, inv3(cell32), NS_MESH, NODES, "Lagrange")
    sync()
    interp_s = time.perf_counter() - t0
    n_tiles, tile_cap = interp.local_x.shape
    emit({"phase": "host_build", "neighbor_list_seconds": nl_s, "pairs": int(nl_idx.shape[0]),
          "tiled_interpolation_seconds": interp_s, "tiles": n_tiles, "tile_capacity": tile_cap,
          "dropped": int(interp.dropped)})

    # -- 3. kernels vs plain versions at the paths' own shapes --------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    nx_c, ny_c, nz_c, cap = fp.cell_grid
    extent, lpad = aligned_geometry(NODES, fp.aligned_pad)
    geom = SpreadGeometry(NS_MESH, NODES, "Lagrange", extent, lpad, nx_c * ny_c, nz_c * cap,
                          nz_c)
    nb = geom.n_tiles * geom.slots_per_tile
    q_rows = torch.zeros((fp.n_rows, 1), **f32).index_copy(0, fp.row_of_atom.long(), q32)
    rel = (rows32 @ inv3(cell32) * torch.tensor(NS_MESH, **f32))[:nb].contiguous()
    q_main = q_rows[:nb].contiguous()
    ct_rho = torch.randn((1, *NS_MESH), generator=gen, **f32)
    with torch.no_grad():
        pc_t, q_g, mf_g, offs, _ = _prepare_bucketed(
            q32[fp.clist.atom_index.long()],
            rows32[: nx_c * ny_c * nz_c * cap].reshape(-1, cap, 3), cell32, fp.clist,
        )
    pot = calc.potential
    n3 = NODES**3
    stencil = 6 * NODES * NODES  # the three 1D weight polynomials of one atom
    n_main = N_ATOMS - n_extra
    mesh1 = ct_rho
    n_pairs = int(nl_idx.shape[0])
    report: dict[str, dict] = {}
    spread_src = "torchpme_tpu_torch/csrc/spread.cu"
    check_kernel(
        "spread_fwd", spread_src, "torchpme_tpu/ops/pallas/spread_fused.py:169",
        lambda: (fused_spread(rel, q_main, geom),),
        lambda: (spread_plain(rel, q_main, geom),),
        bound(nbytes(rel, q_main, mesh1), n_main * (2 * n3 + stencil)), report,
        tols=[SUM_TOL],
    )
    # the same slots on a mesh of EDGE_NZ z cells
    ns_tall = (*NS_MESH[:2], EDGE_NZ)
    geom_tall = SpreadGeometry(ns_tall, NODES, "Lagrange", extent, lpad, nx_c * ny_c,
                               nz_c * cap, nz_c)
    rel_tall = (rows32 @ inv3(cell32) * torch.tensor(ns_tall, **f32))[:nb].contiguous()
    check_kernel(
        "spread_fwd", spread_src, "torchpme_tpu/ops/pallas/spread_fused.py:169",
        lambda: (fused_spread(rel_tall, q_main, geom_tall),),
        lambda: (spread_plain(rel_tall, q_main, geom_tall),),
        bound(nbytes(rel_tall, q_main) + 4 * math.prod(ns_tall), n_main * (2 * n3 + stencil)),
        report, tols=[SUM_TOL], shape=f"mesh {ns_tall}",
    )
    if profile:
        # kernel A's z chunk (ops/spread_fused.py:z_chunk) beside its neighbours
        rule = sf.z_chunk
        try:
            for g, r in ((geom, rel), (geom_tall, rel_tall)):
                nz, times = g.ns[2], {}
                for zc in sorted({zc for zc in (32, 64, 96, 128) if zc <= nz} | {rule(nz)}):
                    sf.z_chunk = lambda _nz, zc=zc: zc
                    times[zc] = cuda_ms(lambda g=g, r=r: fused_spread(r, q_main, g))
                emit({"phase": "z_chunk_sweep", "name": "spread_fwd", "nz": nz,
                      "rule": rule(nz), "ms": times})
        finally:
            sf.z_chunk = rule
    # kernel B: 8 operations a node (the weight and derivative contractions of
    # the z line, three products a column), two stencil sets an atom; each
    # input read once, ct_rel and ct_q written once
    def bwd_bound(r, q, ct, n_ch, n_atoms):
        return bound(nbytes(r, q, ct, r, q), n_atoms * (n_ch * 8 * n3 + 2 * stencil))

    bwd_ref = "torchpme_tpu/ops/pallas/spread_fused.py:216"
    check_kernel(
        "spread_bwd", spread_src, bwd_ref,
        lambda: fused_spread_bwd(rel, q_main, ct_rho, geom),
        lambda: spread_plain_bwd(rel, q_main, ct_rho, geom),
        bwd_bound(rel, q_main, ct_rho, 1, n_main), report,
    )
    # each slot has one writer: two launches agree bit for bit
    first, again = (fused_spread_bwd(rel, q_main, ct_rho, geom) for _ in range(2))
    sync()
    same = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
    emit({"phase": "kernel_reproducible", "name": "spread_bwd", "ct_rel_ct_q_bitwise_equal": same})
    if not all(same):
        raise AssertionError("kernel B's outputs differ between two launches")
    del first, again
    ct_tall = torch.randn((1, *ns_tall), generator=gen, **f32)
    check_kernel(
        "spread_bwd", spread_src, bwd_ref,
        lambda: fused_spread_bwd(rel_tall, q_main, ct_tall, geom_tall),
        lambda: spread_plain_bwd(rel_tall, q_main, ct_tall, geom_tall),
        bwd_bound(rel_tall, q_main, ct_tall, 1, n_main), report, shape=f"mesh {ns_tall}",
    )
    del rel_tall, ct_tall
    q3 = torch.zeros((fp.n_rows, 3), **f32).index_copy(
        0, fp.row_of_atom.long(), torch.randn((N_ATOMS, 3), generator=gen, **f32))[:nb].contiguous()
    ct3 = torch.randn((3, *NS_MESH), generator=gen, **f32)
    check_kernel(
        "spread_bwd", spread_src, bwd_ref,
        lambda: fused_spread_bwd(rel, q3, ct3, geom),
        lambda: spread_plain_bwd(rel, q3, ct3, geom),
        bwd_bound(rel, q3, ct3, 3, n_main), report, shape="3 channels",
    )
    del q3, ct3
    # A and B at the fused mode's geometry: the stencil-start bucketing of the
    # per-atom call (lpad 0, tile slots in bucketing order)
    rel_f, q_f, geom_f = sf._fused_slots(interp, pos32, inv3(cell32), q32, "Lagrange")
    fused_shape = f"fused geometry: lpad 0, T={geom_f.n_tiles}, K={geom_f.slots_per_tile}"
    check_kernel(
        "spread_fwd", spread_src, "torchpme_tpu/ops/pallas/spread_fused.py:169",
        lambda: (fused_spread(rel_f, q_f, geom_f),),
        lambda: (spread_plain(rel_f, q_f, geom_f),),
        bound(nbytes(rel_f, q_f, mesh1), N_ATOMS * (2 * n3 + stencil)), report,
        tols=[SUM_TOL], shape=fused_shape,
    )
    check_kernel(
        "spread_bwd", spread_src, bwd_ref,
        lambda: fused_spread_bwd(rel_f, q_f, ct_rho, geom_f),
        lambda: spread_plain_bwd(rel_f, q_f, ct_rho, geom_f),
        bwd_bound(rel_f, q_f, ct_rho, 1, N_ATOMS), report, shape=fused_shape,
    )
    if profile:
        # kernel B's z chunk (ops/spread_fused.py:bwd_z_chunk) beside its
        # neighbours, and 0: one thread a slot reading device memory
        rule = sf.bwd_z_chunk
        try:
            for label, g, r, qq in (("aligned", geom, rel, q_main), ("fused", geom_f, rel_f, q_f)):
                times = {}
                for zc in ("rule", 0, 16, 32, 64, 128):
                    sf.bwd_z_chunk = rule if zc == "rule" else (lambda *_, zc=zc: zc)
                    times[zc] = cuda_ms(lambda g=g, r=r, qq=qq: fused_spread_bwd(r, qq, ct_rho, g))
                emit({"phase": "z_chunk_sweep", "name": "spread_bwd", "layout": label,
                      "rule": rule(g.nodes, g.extent, 1), "ms": times})
        finally:
            sf.bwd_z_chunk = rule
    del rel_f, q_f
    def window_check(ins, n_inside, shape=None, wpot=pot):
        """Kernel C against its plain version on ``ins``; the bound counts
        the half-window work (each pair once), whatever evaluates it: the
        candidate pairs of occupied slots of each home cell against those of
        its 13 half-window neighbours and itself, and the pair math of
        ``wpot``'s terms (:func:`c_pair_flop`).  ``wpot`` without smearing
        runs the kernel's unsmeared variant (direct mode); a Combined
        potential also its per-member energies (dE/dw), held to float64."""
        occ = ins[2].sum(-1).double()
        n_cand = sum(float((occ * torch.roll(occ, (-dx, -dy, -dz), dims=(0, 1, 2))).sum())
                     for dx, dy, dz in _window_offsets(ins[0].shape[-1]))
        check_kernel(
            "window", "torchpme_tpu_torch/csrc/window.cu",
            "torchpme_tpu/ops/rspace_cells.py:813",
            lambda: (lambda e, g: (e, *g))(*window_value_and_grad(wpot, CUTOFF, *ins)),
            lambda: (lambda e, g: (e, *g))(*_we_value_and_grad(wpot, CUTOFF, *ins)),
            # 11 operations to place and test a candidate, c_pair_flop more
            # for a pair inside the cutoff; inputs once, (e, d_pc, d_q,
            # d_offs, d_image) once
            bound(nbytes(*ins, ins[0], ins[1], ins[3]) + 8 + 72,
                  11 * n_cand + c_pair_flop(wpot) * n_inside),
            # d_offs: the plain version's float32 sum of a cancelling total
            # leaves up to ~1e-4 of max in the self row, which is 0 in exact
            # arithmetic and in the kernel; the kernel is held to float64 below
            report, tols=[SUM_TOL, KERNEL_TOL, KERNEL_TOL, D_OFFS_TOL, KERNEL_TOL], shape=shape,
        )
        with torch.no_grad():
            e64, g64, w64 = _we_value_and_grad(wpot, CUTOFF, *[t.double() for t in ins],
                                               with_params=True)
            e32, g32, w32 = window_value_and_grad(wpot, CUTOFF, *ins, with_params=True)
            ep, _, wp = _we_value_and_grad(wpot, CUTOFF, *ins, with_params=True)
        d_offs_rel, image_rel = rel_err(g32[2], g64[2])[1], rel_err(g32[3], g64[3])[1]
        line = {"phase": "kernel_vs_float64", "name": "window", "shape": shape,
                "d_offs_rel_err": d_offs_rel, "d_image_rel_err": image_rel,
                "energy_rel_err": abs(float(e32) - float(e64)) / abs(float(e64)),
                "d_pc_rel_err": rel_err(g32[0], g64[0])[1], "d_q_rel_err": rel_err(g32[1], g64[1])[1]}
        if w32:
            # dE/dw: each member's energy, double sums in the kernel
            line.update(member_energy_rel_err_vs_f64=rel_err(w32[0], w64[0])[1],
                        member_energy_rel_err_vs_f32_plain=rel_err(w32[0], wp[0])[1],
                        weights_dot_members_vs_energy=abs(
                            float(torch.dot(wpot.weights.detach().to(w32[0]), w32[0])) - float(e32))
                        / abs(float(e32)))
        emit(line)
        if not (d_offs_rel <= KERNEL_TOL and image_rel <= KERNEL_TOL):
            raise AssertionError(f"kernel C's d_offs, d_image vs float64 {d_offs_rel:.3e}, "
                                 f"{image_rel:.3e} ({shape})")
        if w32 and not (line["member_energy_rel_err_vs_f64"] <= WEIGHT_GRAD_TOL
                        and line["member_energy_rel_err_vs_f32_plain"] <= SUM_TOL
                        and line["weights_dot_members_vs_energy"] <= SUM_TOL):
            raise AssertionError(f"kernel C's member energies ({shape}): {line}")
        # each row of d_pc and d_q has one writer: launches agree bit for bit
        first, again = (window_value_and_grad(wpot, CUTOFF, *ins)[1] for _ in range(2))
        sync()
        same = [bool(torch.equal(a, b)) for a, b in zip(first[:2], again[:2])]
        emit({"phase": "kernel_reproducible", "name": "window", "shape": shape,
              "d_pc_d_q_bitwise_equal": same})
        if not all(same):
            raise AssertionError(f"kernel C's d_pc, d_q differ between two launches ({shape})")

    window_check((pc_t, q_g, mf_g, offs), n_pairs)
    # the unsmeared variant (V = 1/d: the calculators' direct mode)
    window_check((pc_t, q_g, mf_g, offs), n_pairs, shape="unsmeared pair (direct mode)",
                 wpot=tpt.CoulombPotential())
    # the pair-term table: 1/r^3 and 1/r^6 at the main path's smearing, the
    # Combined (Coulomb + 1/r^6) of the combined phase, direct 1/r^6
    for label, wpot in family_potentials(tpt, smearing, dev).items():
        window_check((pc_t, q_g, mf_g, offs), n_pairs, shape=f"{label}: {wpot_repr(wpot)}",
                     wpot=wpot)
    window_check((pc_t, q_g, mf_g, offs), n_pairs, shape="direct 1/r^6 (unsmeared)",
                 wpot=tpt.InversePowerLawPotential(exponent=6))
    epos, eq, ecell = dense_grid_box()
    e_pairs = int(neighbor_list(epos, ecell, CUTOFF)[0].shape[0])
    lib = built.lib
    emit({"phase": "window_capacity", "largest_capacity_by_channels": {
        n: lib.tpme_window_max_cap(n, torch.cuda.current_device())
        for n in range(1, kernels.MAX_CHANNELS + 1)}})
    # the grid at its own capacity (all 27 offsets a pass), and at
    # EDGE_CAPACITY with MAX_CHANNELS channels (one x plane of 9 a pass)
    for capacity, n_ch in ((None, 1), (EDGE_CAPACITY, kernels.MAX_CHANNELS)):
        eclist = tpt.ops.compute_cell_list(epos, ecell, CUTOFF, capacity=capacity, spill=False,
                                           device=dev)
        e_cap = eclist.slot_mask.shape[1]
        if eclist.n_axis != (3, 3, 3) or e_cap <= 32:
            raise AssertionError(f"edge grid {eclist.n_axis}, capacity {e_cap}")
        eidx = eclist.atom_index.long()
        e_q = torch.tensor(eq, **f32) * torch.linspace(1.0, 2.0, n_ch, **f32)
        with torch.no_grad():
            e_ins = _prepare_bucketed(e_q[eidx], torch.tensor(epos, **f32)[eidx],
                                      torch.tensor(ecell, **f32), eclist)[:4]
        window_check(e_ins, e_pairs, shape=f"3x3x3 cells, capacity {e_cap}, {n_ch} channel(s), "
                     f"{_window_group(e_cap, n_ch, e_ins[0].device.index)} offsets a pass")
        del e_ins

    # kernels D, E, F at the 102k tile shapes, one channel and three
    mesh_src = "torchpme_tpu_torch/csrc/mesh.cu"
    mesh_ref = "torchpme_tpu/ops/pallas/mesh_pallas.py"
    arrays = (interp.local_x, interp.local_y, interp.start_z, interp.weights)
    for n_ch in (1, 3):
        values = q32 if n_ch == 1 else torch.randn((N_ATOMS, n_ch), generator=gen, **f32)
        q_slots = _slot_values(interp, values)
        field = ct_rho if n_ch == 1 else torch.randn((n_ch, *NS_MESH), generator=gen, **f32)
        wg = interp.weights
        check_kernel(
            "mesh_spread", mesh_src, f"{mesh_ref}:213",
            lambda: (mk.mesh_spread(*arrays, q_slots, NS_MESH, NODES),),
            lambda: (mk.mesh_spread_plain(*arrays, q_slots, NS_MESH, NODES),),
            bound(nbytes(*arrays, q_slots, field), N_ATOMS * n_ch * 2 * n3), report,
        )
        check_kernel(
            "mesh_gather", mesh_src, f"{mesh_ref}:239",
            lambda: (mk.mesh_gather(*arrays, field, NS_MESH, NODES),),
            lambda: (mk.mesh_gather_plain(*arrays, field, NS_MESH, NODES),),
            bound(nbytes(*arrays, field, q_slots), N_ATOMS * n_ch * 2 * n3), report,
        )
        check_kernel(
            "mesh_wgrad", mesh_src, f"{mesh_ref}:263",
            lambda: (mk.mesh_wgrad(*arrays, q_slots, field, NS_MESH, NODES),),
            lambda: (mk.mesh_wgrad_plain(*arrays, q_slots, field, NS_MESH, NODES),),
            bound(nbytes(*arrays, q_slots, field, wg), N_ATOMS * n_ch * 8 * n3), report,
        )
        # E and F from one launch, as the backward of the spread runs them;
        # each slot has one writer: two launches agree bit for bit
        def both():
            return mk.mesh_gather_wgrad(*arrays, q_slots, field, NS_MESH, NODES)

        first, again = both(), both()
        split = (mk.mesh_gather(*arrays, field, NS_MESH, NODES),
                 mk.mesh_wgrad(*arrays, q_slots, field, NS_MESH, NODES))
        sync()
        if not all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(first, again, split)):
            raise AssertionError("mesh_gather_wgrad differs between launches or from E and F")
        emit({"phase": "kernel", "name": "mesh_gather_wgrad", "channels": n_ch, "ms": cuda_ms(both),
              "bitwise_equal_over_two_launches_and_to_e_and_f": True})
        if profile:
            gather_design_sweep(mk, f"charges, {NODES} nodes, {n_ch} channel(s)", {
                "mesh_gather": lambda: mk.mesh_gather(*arrays, field, NS_MESH, NODES),
                "mesh_wgrad": lambda: mk.mesh_wgrad(*arrays, q_slots, field, NS_MESH, NODES),
                "mesh_gather_wgrad": both})
    del q_slots, field, values, first, again, split

    # kernels D, E, F at P3M's 1 and 2 nodes (extent 8 and 9) with the P3M
    # tables, on the 102k atoms' tiles of the 128^3 mesh
    for nodes in P3M_SMALL_NODES:
        interp_n = compute_tiled_interpolation(pos32, inv3(cell32), NS_MESH, nodes, "P3M")
        arrays_n = (interp_n.local_x, interp_n.local_y, interp_n.start_z, interp_n.weights)
        q_slots = _slot_values(interp_n, q32)
        shape = f"P3M, {nodes} node(s), T={interp_n.local_x.shape[0]}, K={interp_n.local_x.shape[1]}"
        n3_n = nodes**3
        check_kernel(
            "mesh_spread", mesh_src, f"{mesh_ref}:213",
            lambda: (mk.mesh_spread(*arrays_n, q_slots, NS_MESH, nodes),),
            lambda: (mk.mesh_spread_plain(*arrays_n, q_slots, NS_MESH, nodes),),
            bound(nbytes(*arrays_n, q_slots, ct_rho), N_ATOMS * 2 * n3_n), report,
            tols=[P3M_MESH_TOL], shape=shape,
        )
        check_kernel(
            "mesh_gather", mesh_src, f"{mesh_ref}:239",
            lambda: (mk.mesh_gather(*arrays_n, ct_rho, NS_MESH, nodes),),
            lambda: (mk.mesh_gather_plain(*arrays_n, ct_rho, NS_MESH, nodes),),
            bound(nbytes(*arrays_n, ct_rho, q_slots), N_ATOMS * 2 * n3_n), report,
            tols=[P3M_MESH_TOL], shape=shape,
        )
        check_kernel(
            "mesh_wgrad", mesh_src, f"{mesh_ref}:263",
            lambda: (mk.mesh_wgrad(*arrays_n, q_slots, ct_rho, NS_MESH, nodes),),
            lambda: (mk.mesh_wgrad_plain(*arrays_n, q_slots, ct_rho, NS_MESH, nodes),),
            bound(nbytes(*arrays_n, q_slots, ct_rho, interp_n.weights), N_ATOMS * 8 * n3_n),
            report, tols=[P3M_MESH_TOL], shape=shape,
        )
        first, again = (mk.mesh_gather_wgrad(*arrays_n, q_slots, ct_rho, NS_MESH, nodes)
                        for _ in range(2))
        split = (mk.mesh_gather(*arrays_n, ct_rho, NS_MESH, nodes),
                 mk.mesh_wgrad(*arrays_n, q_slots, ct_rho, NS_MESH, nodes))
        sync()
        same = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(first, again, split))
        emit({"phase": "kernel", "name": "mesh_gather_wgrad", "shape": shape,
              "ms": cuda_ms(lambda: mk.mesh_gather_wgrad(*arrays_n, q_slots, ct_rho, NS_MESH,
                                                         nodes)),
              "bitwise_equal_over_two_launches_and_to_e_and_f": same})
        if not same:
            raise AssertionError(f"mesh_gather_wgrad ({shape}) differs between launches or from E, F")
        del interp_n, arrays_n, q_slots, first, again, split
    # kernels A and B with the P3M tables at the main path's geometry
    geom_p3m = SpreadGeometry(NS_MESH, NODES, "P3M", extent, lpad, nx_c * ny_c, nz_c * cap, nz_c)
    check_kernel(
        "spread_fwd", spread_src, "torchpme_tpu/ops/pallas/spread_fused.py:169",
        lambda: (fused_spread(rel, q_main, geom_p3m),),
        lambda: (spread_plain(rel, q_main, geom_p3m),),
        bound(nbytes(rel, q_main, mesh1), n_main * (2 * n3 + stencil)), report,
        tols=[SUM_TOL], shape="P3M tables, 5 nodes",
    )
    check_kernel(
        "spread_bwd", spread_src, bwd_ref,
        lambda: fused_spread_bwd(rel, q_main, ct_rho, geom_p3m),
        lambda: spread_plain_bwd(rel, q_main, ct_rho, geom_p3m),
        bwd_bound(rel, q_main, ct_rho, 1, n_main), report, shape="P3M tables, 5 nodes",
    )

    # -- 4. the MD step: energy + forces in aligned mode (kernels A, B, C) --------
    cell_g = cell32.clone().requires_grad_()
    rows_g = rows32.clone().requires_grad_()
    kernels.reset_launch_counts()
    e32 = fp.energy(q32, cell_g, rows_g)
    g_rows, g_cell = torch.autograd.grad(e32, (rows_g, cell_g))
    sync()
    counts = kernels.launch_counts()
    md_kernels = ("spread_fwd", "spread_bwd", "window")
    if min(counts[name] for name in md_kernels) < 1:
        raise AssertionError(f"a kernel of the MD step never launched: {counts}")

    # the float64 reference takes the same float32-rounded inputs, so the
    # comparison measures float32 arithmetic, not input rounding
    cell64 = cell32.double().requires_grad_()
    rows64 = rows32.double().requires_grad_()
    e64 = fp.energy(q32.double(), cell64, rows64, plain=True)
    g_rows64, g_cell64 = torch.autograd.grad(e64, (rows64, cell64))
    e32, e64 = e32.detach(), e64.detach()
    e_rel = abs(float(e32) - float(e64)) / abs(float(e64))
    f_rms = rel_rms(fp.unbucket(g_rows), fp.unbucket(g_rows64))
    _, c_rel = rel_err(g_cell, g_cell64)
    del rows64, g_rows64

    def md_chain(plain: bool):
        return md_chain_of(fp, q32, cell32, rows32, plain)

    kernel_ms, plain_ms = (t / CHAIN for t in alternate_ms(md_chain, 1))
    if not bool(torch.isfinite(md_chain(False)).all()):
        raise AssertionError("the MD chain left its bucketing")
    emit({"phase": "slice", "atoms": N_ATOMS, "energy_f32": float(e32),
          "energy_f64_plain": float(e64), "energy_rel": e_rel, "force_rel_rms": f_rms,
          "cell_grad_rel": c_rel, "launches": {k: counts[k] for k in md_kernels},
          "create_seconds": create_s, "ms_per_step": kernel_ms,
          "plain_f32_ms_per_step": plain_ms, "nvidia_smi": smi})
    if not (e_rel <= 1e-5 and f_rms <= 1e-5 and c_rel <= 1e-4):
        raise AssertionError(
            f"102k f32 step vs f64 plain: energy {e_rel:.3e}, forces {f_rms:.3e}, "
            f"cell {c_rel:.3e}"
        )
    if not all(math.isfinite(x) for x in (float(e32), kernel_ms, plain_ms)):
        raise AssertionError("non-finite slice result")

    # -- 4b. the MD step in fused mode: kernels A and B at the stencil-start
    # geometry, C for the window; beside it the tiled mode (D, E, F) --------------
    counts_fused = fused_md_phase(tpt, kernels, calc, positions, cell, pos32, q32, cell32, smi,
                                  profile)

    # -- 5. the per-atom call on the tiled mesh (kernels D, E, F) -----------------
    def per_atom(dtype, plain, backward=True):
        """(potentials, d/dpositions, d/dcharges, d/dcell of sum(pot·q), the
        sum itself) of the calculator call; distances are recomputed inside
        so the gradients reach positions and cell."""
        # detached views: `.to` of the same dtype is the tensor itself, and the
        # shared inputs must not come to require grad
        p = pos32.to(dtype).detach().requires_grad_(backward)
        q = q32.to(dtype).detach().requires_grad_(backward)
        c = cell32.to(dtype).detach().requires_grad_(backward)
        dist = compute_distances(p, idx_t, c, shifts_t)
        pot_i = calc(q, c, p, idx_t, dist, ns_mesh=NS_MESH, tiled_interp=interp, plain=plain)
        if not backward:
            return (pot_i,)
        total = torch.sum(pot_i * q)
        return (pot_i.detach(), *torch.autograd.grad(total, (p, q, c)), total.detach())

    kernels.reset_launch_counts()
    got = per_atom(torch.float32, plain=False)
    sync()
    call_counts = kernels.launch_counts()
    call_kernels = ("mesh_spread", "mesh_gather", "mesh_wgrad")
    if min(call_counts[name] for name in call_kernels) < 1:
        raise AssertionError(f"a kernel of the per-atom call never launched: {call_counts}")
    ref = per_atom(torch.float64, plain=True)
    pot_rel = rel_err(got[0], ref[0])[1]
    force_rms = rel_rms(got[1], ref[1])
    dq_rel = rel_err(got[2], ref[2])[1]
    dcell_rel = rel_err(got[3], ref[3])[1]
    e_sum, e_sum64 = float(got[4]), float(ref[4])
    with torch.no_grad():
        e_quad = float(calc.energy(
            q32, cell32, pos32, idx_t, compute_distances(pos32, idx_t, cell32, shifts_t),
            ns_mesh=NS_MESH, tiled_interp=interp,
        ))
    e_sum_rel = abs(e_sum - e_sum64) / abs(e_sum64)
    e_quad_rel = abs(e_quad - e_sum) / abs(e_sum)
    e_md_rel = abs(float(e32) - e_sum) / abs(e_sum)
    del got, ref

    fwd_ms, fwd_plain_ms = alternate_ms(
        lambda plain: per_atom(torch.float32, plain, backward=False), CALL_REPEATS)
    full_ms, full_plain_ms = alternate_ms(
        lambda plain: per_atom(torch.float32, plain), CALL_REPEATS)
    emit({"phase": "per_atom_call", "atoms": N_ATOMS, "pairs": n_pairs,
          "tiles": n_tiles, "tile_capacity": tile_cap,
          "energy_sum_pot_q_f32": e_sum, "energy_sum_pot_q_f64_plain": e_sum64,
          "energy_rel": e_sum_rel, "potential_rel": pot_rel, "force_rel_rms": force_rms,
          "charge_grad_rel": dq_rel, "cell_grad_rel": dcell_rel,
          "energy_method_rel_vs_sum": e_quad_rel, "md_step_energy_rel_vs_sum": e_md_rel,
          "launches": {k: call_counts[k] for k in call_kernels},
          "forward_ms": fwd_ms, "forward_plain_f32_ms": fwd_plain_ms,
          "forward_backward_ms": full_ms, "forward_backward_plain_f32_ms": full_plain_ms,
          "neighbor_list_seconds": nl_s, "tiled_interpolation_seconds": interp_s,
          "nvidia_smi": smi})
    if not (e_sum_rel <= 1e-5 and pot_rel <= 1e-5 and force_rms <= 1e-5
            and dq_rel <= 1e-5 and dcell_rel <= 1e-4):
        raise AssertionError(
            f"102k f32 per-atom call vs f64 plain: energy {e_sum_rel:.3e}, potentials "
            f"{pot_rel:.3e}, forces {force_rms:.3e}, charge gradient {dq_rel:.3e}, "
            f"cell gradient {dcell_rel:.3e}"
        )
    if not (e_quad_rel <= 1e-5 and e_md_rel <= 1e-5):
        raise AssertionError(
            f"sum(pot*q) vs calc.energy {e_quad_rel:.3e}, vs the MD step {e_md_rel:.3e}"
        )
    counts.update({k: call_counts[k] for k in call_kernels})
    if profile:
        profile_path("md_step_aligned", lambda: md_chain(False), calls=2)  # 2 chains of CHAIN steps
        profile_path("per_atom_forward", lambda: per_atom(torch.float32, False, backward=False))
        profile_path("per_atom_forward_backward", lambda: per_atom(torch.float32, False))

    # -- 6. accuracy against the converged Ewald ground truth ---------------------
    gt = np.load(REPO / "tools" / "ground_truth.npz")
    f_ref = torch.tensor(gt["forces"], device=dev)
    e_truth = float(gt["energy"])
    gpos, gq, gcell = water_box(GT_N)
    gcalc = tpt.PMECalculator(tpt.CoulombPotential(smearing=GT_SMEARING),
                              mesh_spacing=GT_MESH_SPACING, interpolation_nodes=NODES)
    if gcalc.get_ns_mesh(gcell) != GT_TILED_NS:
        raise AssertionError(f"mesh of the accuracy system: {gcalc.get_ns_mesh(gcell)}")
    gpos32, gq32, gcell32 = (torch.tensor(a, **f32) for a in (gpos, gq, gcell))
    accuracy = {}
    for mode, ns, e_jax in (("aligned", GT_NS, GT_JAX_ENERGY),
                            ("tiled", GT_TILED_NS, GT_TILED_JAX_ENERGY),
                            ("fused", GT_TILED_NS, GT_TILED_JAX_ENERGY)):
        gfp = tpt.MDFastPath.create(gcalc, gpos32, gcell32, CUTOFF, ns, mesh_impl=mode)
        grows = gfp.bucket(gpos32).requires_grad_()
        kernels.reset_launch_counts()
        ge = gfp.energy(gq32, gcell32, grows)
        (gg,) = torch.autograd.grad(ge, grows)
        sync()
        ge = float(ge.detach())
        accuracy[mode] = {
            "ns_mesh": ns, "energy": ge, "energy_rel_vs_jax": abs(ge - e_jax) / abs(e_jax),
            "energy_rel_vs_truth": abs(ge - e_truth) / abs(e_truth),
            "force_rel_rms_vs_truth": rel_rms(-gfp.unbucket(gg), f_ref),
            "launches": {k: v for k, v in kernels.launch_counts().items() if v},
        }
    # where the aligned mode cannot run, `auto` takes the fused mode on the card
    auto_mode = tpt.MDFastPath.create(gcalc, gpos32, gcell32, CUTOFF, GT_TILED_NS).mesh_impl
    emit({"phase": "accuracy", "atoms": GT_N, **accuracy, "auto_mode_at_64": auto_mode})
    if auto_mode != "fused":
        raise AssertionError(f"MDFastPath.create(mesh_impl='auto') took {auto_mode!r} at 64^3")
    aligned = accuracy["aligned"]
    if not (aligned["energy_rel_vs_jax"] <= 1e-5 and aligned["force_rel_rms_vs_truth"] <= 1.0e-3):
        raise AssertionError(f"1536-atom accuracy, aligned mode: {aligned}")
    for mode in ("tiled", "fused"):
        acc = accuracy[mode]
        if not (acc["energy_rel_vs_jax"] <= 1e-5 and acc["force_rel_rms_vs_truth"] <= GT_FORCE_BAR
                and acc["energy_rel_vs_truth"] <= GT_FORCE_BAR):
            raise AssertionError(f"1536-atom accuracy, {mode} mode: {acc}")
    # tiled mode: kernel D forward, kernel F backward (kernel E joins when the
    # charges want a gradient), fused mode: A and B; kernel C for the window
    if not {"window", "mesh_spread", "mesh_wgrad"} <= set(accuracy["tiled"]["launches"]):
        raise AssertionError(f"tiled mode launched {accuracy['tiled']['launches']}")
    if set(accuracy["fused"]["launches"]) != {"window", "spread_fwd", "spread_bwd"}:
        raise AssertionError(f"fused mode launched {accuracy['fused']['launches']}")

    del gfp, grows, gg, f_ref
    env = SimpleNamespace(
        tpt=tpt, kernels=kernels, dev=dev, f32=f32, smi=smi, positions=positions, cell=cell,
        pos32=pos32, q32=q32, cell32=cell32, idx_t=idx_t, shifts_t=shifts_t, n_pairs=n_pairs,
        ct_rho=ct_rho, report=report, counts=counts, profile=profile, smearing=smearing,
        calc=calc, interp=interp, fp=fp, charges=charges,
    )
    # -- 11, 12. P3M: the 102k MD step (A, B, C with the P3M tables) and the
    # per-atom call (D, E, F) -------------------------------------------------------
    paths = p3m_phases(env)
    # -- 13. Ewald at 12k: the MD step (C) and the per-atom call -------------------
    paths.update(ewald_phases(env))
    # -- 14. P3M and Ewald against the converged Ewald ground truth ----------------
    p3m_ewald_accuracy(env)
    # -- 15. the per-atom call over a cell list, and direct mode through C ---------
    paths.update(cell_list_phases(env))
    # -- 16-18. the potential family: 1/r^3, 1/r^6 and Combined MD steps, the
    # Combined per-atom call, the extras tile table ----------------------------------
    paths.update(family_phases(env))

    # -- 3 (kernel G; D, E, F at the dipolar shapes), 7, 8, 9: the dipolar paths --
    dipole_phases(env)

    # -- 19. the port's tuning module and a labeled call on the card ----------------
    paths.update(tuning_phases(env))

    # -- 10. result ---------------------------------------------------------------
    # launches: of the MD step (A, B, C), the per-atom call (D, E, F) and the
    # dipolar MD step (G); A, B, C's on the fused MD step and D, E, F's on the
    # two dipolar paths beside them
    paths = {"fused_step": counts_fused, **paths,
             **{f"dipole_{path}": n for path, n in env.dipole_launches.items()}}
    emit({"kernels": [{k: v for k, v in report[name].items() if k != "max_rel_err"}
                      | {"launches": counts[name]}
                      | {f"launches_{path}": n[name] for path, n in paths.items() if name in n}
                      for name in report]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
