#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card: python3 chip_smoke.py

Drives the port's main path, the 102k-atom PME MD step (energy + forces of
``torchpme_tpu_torch.MDFastPath`` in aligned mode), through its hand-written
CUDA kernels, and fails (non-zero exit, no result line) if any phase fails:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles ``torchpme_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernels: each kernel against its plain PyTorch twin, float32, on the
   102k step's own inputs, with CUDA-event times of both;
4. the slice: the float32 kernel step vs the port's plain float64 step on
   the card (energy, forces, cell gradient), the launch count of every
   kernel during the step, and ms/step of the kernel and plain paths;
5. accuracy: the 1536-atom system of tools/validate_accuracy.py in float32
   against the JAX package's value and tools/ground_truth.npz;
6. the last line: ``{"ok": true, "device": {...}}``.

Imports torch, numpy and the port; nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

N_ATOMS = 102_000
CUTOFF = 5.0
ACCURACY = 1e-4
NODES = 5
NS_MESH = (128, 128, 128)
CHAIN = 20  # steps per timed chain, one sync per chain
KERNEL_TOL = 1e-5  # kernel vs plain twin, max abs error over max |plain|

# tools/validate_accuracy.py system; the JAX package's aligned float32 step on
# CPU at these settings gives this energy (tests/test_torch_md.py pins it)
GT_N, GT_SMEARING, GT_NS = 1536, 1.2836, (32, 32, 32)
GT_JAX_ENERGY = -32.388634


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


def smearing_for(charges, cell, n_atoms: int) -> float:
    """bench.py:choose_parameters, the real-space bound at ACCURACY."""
    volume = float(abs(np.linalg.det(cell)))
    prefac = 2 * float((charges**2).sum()) / math.sqrt(n_atoms)
    ratio = math.sqrt(-2 * math.log(ACCURACY / 2 / prefac * math.sqrt(CUTOFF * volume)))
    return CUTOFF / ratio


def cuda_ms(fn, repeats: int = 10) -> float:
    """Mean ms per call from CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error over max |ref|)."""
    err = float((got.double() - ref.double()).abs().max())
    return err, err / max(float(ref.double().abs().max()), 1e-30)


def main() -> int:
    # -- 1. device --------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import torchpme_tpu_torch as tpt
    from torchpme_tpu_torch import kernels
    from torchpme_tpu_torch.ops.math import inv3
    from torchpme_tpu_torch.ops.rspace_cells import (
        _prepare_bucketed,
        _we_value_and_grad,
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

    # float32 products in full float32, stated rather than assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0)})

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.load_library()
    ptxas = [ln for ln in built.build_log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built.build_seconds, "ptxas": ptxas})

    # -- the 102k system (host build) -------------------------------------------
    positions, charges, cell = water_box(N_ATOMS)
    smearing = smearing_for(charges, cell, N_ATOMS)
    calc = tpt.PMECalculator(tpt.CoulombPotential(smearing=smearing), interpolation_nodes=NODES)
    f32 = dict(dtype=torch.float32, device=dev)
    pos32 = torch.tensor(positions, **f32)
    q32 = torch.tensor(charges, **f32)
    cell32 = torch.tensor(cell, **f32)
    t0 = time.perf_counter()
    fp = tpt.MDFastPath.create(calc, pos32, cell32, CUTOFF, NS_MESH)
    create_s = time.perf_counter() - t0
    n_extra = 0 if fp.clist.extra_mask is None else int(fp.clist.extra_mask.sum())
    emit({"phase": "create", "seconds": create_s, "smearing": smearing,
          "cell_grid": fp.cell_grid, "aligned_pad": fp.aligned_pad,
          "n_rows": fp.n_rows, "spill_atoms": n_extra})
    rows32 = fp.bucket(pos32)

    # -- 3. kernels vs plain twins at the step's own shapes ----------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    nx_c, ny_c, nz_c, cap = fp.cell_grid
    extent, lpad = aligned_geometry(NODES, fp.aligned_pad)
    geom = SpreadGeometry(NS_MESH, NODES, "Lagrange", extent, lpad, nx_c * ny_c, nz_c * cap)
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
    cases = {
        "spread_fwd": (
            "torchpme_tpu_torch/csrc/spread.cu",
            "torchpme_tpu/ops/pallas/spread_fused.py:169",
            lambda: (fused_spread(rel, q_main, geom),),
            lambda: (spread_plain(rel, q_main, geom),),
        ),
        "spread_bwd": (
            "torchpme_tpu_torch/csrc/spread.cu",
            "torchpme_tpu/ops/pallas/spread_fused.py:216",
            lambda: fused_spread_bwd(rel, q_main, ct_rho, geom),
            lambda: spread_plain_bwd(rel, q_main, ct_rho, geom),
        ),
        "window": (
            "torchpme_tpu_torch/csrc/window.cu",
            "torchpme_tpu/ops/rspace_cells.py:813",
            lambda: (lambda e, g: (e, *g))(
                *window_value_and_grad(pot, CUTOFF, pc_t, q_g, mf_g, offs)),
            lambda: (lambda e, g: (e, *g))(
                *_we_value_and_grad(pot, CUTOFF, pc_t, q_g, mf_g, offs)),
        ),
    }
    report = {}
    for name, (source, replaces, run_kernel, run_plain) in cases.items():
        got, ref = run_kernel(), run_plain()
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        worst = max(r for _, r in errs)
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "max_abs_err": max(a for a, _ in errs), "max_rel_err": worst,
                 "ms": cuda_ms(run_kernel), "plain_ms": cuda_ms(run_plain)}
        emit({"phase": "kernel", **entry, "per_output_rel_err": [r for _, r in errs]})
        if not worst <= KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain {worst:.3e} > {KERNEL_TOL}")
        report[name] = entry

    # -- 4. the slice: one energy + force step through the kernels ---------------
    cell_g = cell32.clone().requires_grad_()
    rows_g = rows32.clone().requires_grad_()
    kernels.reset_launch_counts()
    e32 = fp.energy(q32, cell_g, rows_g)
    g_rows, g_cell = torch.autograd.grad(e32, (rows_g, cell_g))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")

    # the float64 reference takes the same float32-rounded inputs, so the
    # comparison measures float32 arithmetic, not input rounding
    cell64 = cell32.double().requires_grad_()
    rows64 = rows32.double().requires_grad_()
    e64 = fp.energy(q32.double(), cell64, rows64, plain=True)
    g_rows64, g_cell64 = torch.autograd.grad(e64, (rows64, cell64))
    forces32 = -fp.unbucket(g_rows).double()
    forces64 = -fp.unbucket(g_rows64)
    e32, e64 = e32.detach(), e64.detach()
    e_rel = abs(float(e32) - float(e64)) / abs(float(e64))
    f_rms = float(torch.sqrt(torch.mean((forces32 - forces64) ** 2))
                  / torch.sqrt(torch.mean(forces64**2)))
    _, c_rel = rel_err(g_cell, g_cell64)

    def chain_ms(plain: bool) -> float:
        def chain():
            p = rows32
            for _ in range(CHAIN):
                p = p.detach().requires_grad_()
                e = fp.energy(q32, cell32, p, plain=plain)
                (g,) = torch.autograd.grad(e, p)
                p = p - 1e-7 * g
            return p
        chain()
        per_step = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize()
            per_step.append(start.elapsed_time(end) / CHAIN)
        return float(np.median(per_step))

    kernel_ms = chain_ms(plain=False)
    plain_ms = chain_ms(plain=True)
    emit({"phase": "slice", "atoms": N_ATOMS, "energy_f32": float(e32),
          "energy_f64_plain": float(e64), "energy_rel": e_rel, "force_rel_rms": f_rms,
          "cell_grad_rel": c_rel, "launches": counts, "create_seconds": create_s,
          "ms_per_step": kernel_ms, "plain_f32_ms_per_step": plain_ms,
          "nvidia_smi": smi})
    if not (e_rel <= 1e-5 and f_rms <= 1e-5 and c_rel <= 1e-4):
        raise AssertionError(
            f"102k f32 step vs f64 plain: energy {e_rel:.3e}, forces {f_rms:.3e}, "
            f"cell {c_rel:.3e}"
        )
    if not all(math.isfinite(x) for x in (float(e32), kernel_ms, plain_ms)):
        raise AssertionError("non-finite slice result")

    # -- 5. accuracy against the converged Ewald ground truth --------------------
    gt = np.load(REPO / "tools" / "ground_truth.npz")
    gpos, gq, gcell = water_box(GT_N)
    gcalc = tpt.PMECalculator(tpt.CoulombPotential(smearing=GT_SMEARING), interpolation_nodes=NODES)
    gpos32 = torch.tensor(gpos, **f32)
    gfp = tpt.MDFastPath.create(gcalc, gpos32, torch.tensor(gcell, **f32), CUTOFF, GT_NS)
    grows = gfp.bucket(gpos32).requires_grad_()
    ge = gfp.energy(torch.tensor(gq, **f32), torch.tensor(gcell, **f32), grows)
    (gg,) = torch.autograd.grad(ge, grows)
    ge = ge.detach()
    gforces = -gfp.unbucket(gg).double().cpu().numpy()
    f_ref = gt["forces"]
    gt_rms = float(np.sqrt(np.mean((gforces - f_ref) ** 2)) / np.sqrt(np.mean(f_ref**2)))
    gt_e_rel = abs(float(ge) - GT_JAX_ENERGY) / abs(GT_JAX_ENERGY)
    emit({"phase": "accuracy", "atoms": GT_N, "energy": float(ge),
          "energy_rel_vs_jax": gt_e_rel,
          "energy_rel_vs_truth": abs(float(ge) - float(gt["energy"])) / abs(float(gt["energy"])),
          "force_rel_rms_vs_truth": gt_rms, "aligned_pad": gfp.aligned_pad,
          "spill": gfp.clist.extra_index is not None})
    if not (gt_e_rel <= 1e-5 and gt_rms <= 1.0e-3):
        raise AssertionError(
            f"1536-atom accuracy: energy {gt_e_rel:.3e} vs JAX, force rms {gt_rms:.3e}"
        )

    # -- 6. result --------------------------------------------------------------
    emit({"kernels": [{k: v for k, v in report[name].items() if k != "max_rel_err"}
                      | {"launches": counts[name]} for name in report]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
