// The tpme:: operator library's schemas and launch counters, the one source of
// both definitions: csrc/tpme_ops.cpp includes this file to register the ops
// in C++ (TORCH_LIBRARY), and torchpme_tpu_torch/kernels reads it to define
// the same ops in Python where no library is loaded (a machine without a
// card).  One TPME_OP(name, "schema") or TPME_COUNTER(name) a line.

// kernel A: (nb, 3) rel, (nb, C) charges -> (C, nx, ny, nz) density;
// geometry = [nx, ny, nz, nodes, extent, lpad, n_tiles, slots_per_tile, z_cells]
TPME_OP(spread_fwd, "spread_fwd(Tensor rel, Tensor q, int[] geometry, str method) -> Tensor")
// kernel B: A's VJP, (rel, q, dE/drho) -> (dE/drel, dE/dq)
TPME_OP(spread_bwd, "spread_bwd(Tensor rel, Tensor q, Tensor ct_rho, int[] geometry, str method) -> (Tensor, Tensor)")
// kernel C: (e, d_pc, d_q, d_offs, d_image, d_qi, members) of the window for a
// pair-term table (ops/rspace_cells.py:window_table); with qi_g the split variant
TPME_OP(window, "window(Tensor pc_t, Tensor q_g, Tensor mf_g, Tensor offs, Tensor cell, Tensor? weights, int[] kinds, int[] exponents, float[] smearings, float[] prefactors, bool direct, float cutoff, Tensor? qi_g=None) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
// kernel G: (e, d_pc, d_mu, d_offs, d_mui) of the dipolar window
TPME_OP(window_dipole, "window_dipole(Tensor pc_t, Tensor mu_g, Tensor mf_g, Tensor offs, Tensor? mui_g, float? smearing, float prefactor, float cutoff) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
// kernel D, its dipole form, E, F and E + F in both forms: one system, or a
// batch with leading axes in one launch
TPME_OP(mesh_spread, "mesh_spread(Tensor lx, Tensor ly, Tensor sz, Tensor weights, Tensor q_slots, int[] ns, int nodes) -> Tensor")
TPME_OP(mesh_spread_dipole, "mesh_spread_dipole(Tensor lx, Tensor ly, Tensor sz, Tensor weights, Tensor dweights, Tensor nu_slots, int[] ns, int nodes) -> Tensor")
TPME_OP(mesh_gather, "mesh_gather(Tensor lx, Tensor ly, Tensor sz, Tensor weights, Tensor mesh, int[] ns, int nodes) -> Tensor")
TPME_OP(mesh_wgrad, "mesh_wgrad(Tensor lx, Tensor ly, Tensor sz, Tensor weights, Tensor q_slots, Tensor mesh, int[] ns, int nodes) -> Tensor")
TPME_OP(mesh_gather_wgrad, "mesh_gather_wgrad(Tensor lx, Tensor ly, Tensor sz, Tensor weights, Tensor q_slots, Tensor mesh, int[] ns, int nodes) -> (Tensor, Tensor)")
TPME_OP(mesh_gather_dipole, "mesh_gather_dipole(Tensor lx, Tensor ly, Tensor sz, Tensor weights, Tensor dweights, Tensor mesh, int[] ns, int nodes) -> Tensor")
TPME_OP(mesh_wgrad_dipole, "mesh_wgrad_dipole(Tensor lx, Tensor ly, Tensor sz, Tensor weights, Tensor dweights, Tensor nu_slots, Tensor mesh, int[] ns, int nodes) -> (Tensor, Tensor)")
TPME_OP(mesh_gather_wgrad_dipole, "mesh_gather_wgrad_dipole(Tensor lx, Tensor ly, Tensor sz, Tensor weights, Tensor dweights, Tensor nu_slots, Tensor mesh, int[] ns, int nodes) -> (Tensor, Tensor, Tensor)")
// the launch counters, in the order of the TPME_COUNTER lines
TPME_OP(launch_counts, "launch_counts() -> int[]")
TPME_OP(reset_launch_counts, "reset_launch_counts() -> ()")
// kernel C at a capacity on a device: [offsets a pass (0: none fits), the
// largest capacity it takes]; kernel G: [home cells a block, the largest capacity]
TPME_OP(window_plan, "window_plan(int cap, int n_ch, bool split, int device) -> int[]")
TPME_OP(window_dipole_plan, "window_dipole_plan(int cap, bool split, int device) -> int[]")
// the z chunk of kernel A ("spread_fwd"), B ("spread_bwd") or E and F
// ("mesh_gather") held at z_chunk for the launches that follow (-1: the rule
// again); returns the value it replaces
TPME_OP(override_z_chunk, "override_z_chunk(str kernel, int z_chunk) -> int")

TPME_COUNTER(spread_fwd)
TPME_COUNTER(spread_bwd)
TPME_COUNTER(window)
TPME_COUNTER(window_split)  // kernel C's split variant: separate i-side charges
TPME_COUNTER(mesh_spread)
TPME_COUNTER(mesh_gather)
TPME_COUNTER(mesh_wgrad)
TPME_COUNTER(window_dipole)
