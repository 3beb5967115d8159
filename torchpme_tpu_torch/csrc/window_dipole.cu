// Dipolar real-space window on Hopper: kernel G, the cell-list energy of
// point dipoles and its whole gradient in one pass.
//
// Replaces torchpme_tpu/ops/pallas/window_dipole_pallas.py:_dipole_window_kernel
// (launched by _run_dipole_window_kernel), including the un-roll of the j-side
// cotangents that the JAX package does outside its kernel.  Every dipolar pair
// kernel is K(r) = B(d) I - C(d) r r^T, so with r = p_j + offs[k] - p_i,
// M = mu_i.mu_j, Ri = mu_i.r, Rj = mu_j.r the pair energy is B M - C Ri Rj,
// summed over the 13 half-window neighbor offsets plus the self cell of every
// home cell.  Pairs need 0 < d^2 < cutoff^2 and an occupied j slot; the self
// cell's pairs count at 1/2.  With s = -C M - (C'/d) Ri Rj (B' = -C d holds
// identically):
//   dE/dp_i  = -s r + C (Rj mu_i + Ri mu_j)   and dE/dp_j = -dE/dp_i,
//   dE/dmu_i =  B mu_j - C Rj r,   dE/dmu_j = B mu_i - C Ri r,
// term for term ops/rspace_cells_dipole.py:_dw_value_and_grad.  The pair math
// is PotentialDipole.window_scalar_math_sq in float32: (B, C, C'/d) from d^2
// with one shared Gaussian (Abramowitz & Stegun 7.1.26 erfc) and rsqrt; direct
// mode (no smearing) is pure rationals.  Outputs: acc (double, zeroed by the
// caller: [0] the energy, [1, 43) the d_offs sums, then a block counter), and,
// written whole by the kernel, d_pc (cells, 3, cap), d_mu (cells, cap, 3),
// d_offs (14, 3) and d_mui (cells, cap, 3) when the i side has dipoles of its
// own (mui); without mui every dipole cotangent goes to d_mu.  Like mu, mui
// is zero in empty slots (as _prepare_bucketed makes mu).
//
// What bounds it on the H100.  At the 102k dipolar window (8000 cells, cap
// 24) the work is ~37M candidate pairs of occupied slots over the 27 offsets
// and 6.5M pair evaluations (both ends of 3.3M pairs) of ~250 instructions
// per 32 (one expf, one rsqrtf, one reciprocal each, then a segmented warp
// sum): instruction issue and its latency, with no reuse across cells; the
// inputs are a few MB.  The first version (one block per home cell, warps
// over (offset, 32 home atoms), lanes looping over j in lockstep) ran the
// pair path on the whole warp whenever one lane had a pair, ran it for the
// 47% of home slots that are empty, and sent the j side home with six 5-step
// butterflies and six global atomics per (warp, j).  A block-per-cell form of
// this design (all 27 neighbours staged at once, per-item sums, block-wide
// syncs) held 4-5 blocks a SM and waited on its phases.  This design:
//
// * One warp per home cell, blockDim / 32 cells a block, no block-wide sync
//   until the end; every pair is evaluated from the home side only, as kernel
//   C (window.cu) does: no shuffles or atomics for a j side, and every row of
//   d_pc, d_mu and d_mui has one writer, a fixed-order sum in the warp's
//   shared memory written once with plain stores, so they are bitwise
//   reproducible.  The warp stages its home atoms (the occupied slots,
//   compacted in slot order) and, a group of three offsets (one x, y
//   neighbour column) at a time, the neighbours' occupied slots that lie
//   within the cutoff of the home atoms' box (position shifted by the offset
//   vector, and the one dipole that the home atom's role reads, see Roles;
//   the self cell's partners with mui also their mui).  tpme_window_dipole_warps
//   picks 4, 2 or 1 cells a block, the most whose shared memory fits.
// * Items are (offset, home atom).  The home atoms are the occupied slots
//   plus one "centre" item that stands for every empty slot: empty slots sit
//   at the cell centre with zero dipoles, so they share one value, the only
//   non-zero part of their gradient (the dipole cotangent of the plain
//   version's half window, the self cell at 1/2).
// * The pair math runs on full warps.  Lanes are home atoms; each tests its
//   atom against an offset's partners, JCH at a time, into a bit mask, and
//   the pairs that pass go to the warp's queue in shared memory in (offset,
//   atom, partner) order (a warp scan of the counts).  The queue drains 32
//   pairs at a time, one pair a lane: the scalars, the contractions, then a
//   segmented warp sum over the runs of one (offset, atom), whose head lanes
//   add into the atoms' row sums, those of one atom one after the other in
//   lane order (__match_any_sync).  Pairs left over (< 32) wait for the next
//   offsets of the group; so the pair path costs in proportion to the pairs,
//   not to the warp-iterations.  The queue content and the sum trees depend
//   on the data only.
// * Roles.  A pair is met from both ends.  With weights wi (the home atom as
//   i: 1 on the 13 half-window offsets +k, 1/2 on the self cell) and wj (as
//   j: 1 on the mirrors -k, 1/2 on the self cell; only for an occupied home
//   atom, the j slot of the plain version's mask), the home atom takes wi
//   times the i-side terms and wj times the j-side ones; the energy comes
//   from the i side only, so each pair counts once.  Without mui both sides
//   read mu and the two are one formula with weight wi + wj.  With mui the
//   pair energy is mui_i.K.mu_j: as i the home atom reads mui, its partner
//   mu, and its cotangent goes to d_mui; as j it reads mu, its partner mui,
//   and it goes to d_mu.  The lane picks the operands by role; on the self
//   cell with mui it evaluates both roles from one set of scalars.  On an
//   offset other than the self cell the role is the offset's sign, so a
//   partner is staged with the dipole of that role only (mu on +k, mui on
//   -k): with mui a warp holds seven vectors per partner slot, not nine.
// * d_offs.  The plain version's d_offs[k] is the total j-side position
//   gradient of half-window offset k.  A pair at offset +k is met from its i
//   end at +k (its home-side gradient is -that) and from its j end at -k
//   (+that), so with S(+k), S(-k) the home-side gradient sums over the two
//   offsets, d_offs[k] = 1/2 (S(-k) - S(+k)) over all cells.  The lanes sum
//   their pairs' gradients per offset of the group, the warp adds them up and
//   keeps them in double; the block adds its cells' values with one double
//   atomic per value.  The self row is 0 without mui (its pairs cancel); with
//   mui it is 1/2 (S_j - S_i) of the self cell's two roles.  The last block
//   to finish writes the float d_offs.
//
// Plain CUDA C++, float32 only; the op (csrc/tpme_ops.cpp:window_dipole_cuda)
// checks shapes, dtypes and the capacity.

#include <cuda_runtime.h>

#define N_OFF 14
#define N_WIN 27
#define SELF_O 13
#define JCH 32                 // partner slots a lane tests per round
#define QCAP (32 * JCH + 32)   // per-warp pair queue: a round on top of < 32 pending
#define J_BITS 12              // a queue entry is offset << 2 J_BITS | atom << J_BITS | partner
#define MAX_CAP ((1 << J_BITS) - 1)
#define WARP_DOUBLES 86        // per warp: 27 x 3 offset sums, the energy, the self row, a pad
#define FULL_MASK 0xffffffffu

struct WindowDipoleParams {
  int nx, ny, nz, cap, self_k, direct;
  int warps;  // home cells (warps) a block: 4, 2 or 1
  float cutoff_sq, alpha, sqrt_alpha, prefactor, c_gauss;
  int offsets[3 * N_OFF];  // (dx, dy, dz) per offset, in the order of offs
};

__device__ __forceinline__ int wrap_cell(int a, int n) { return (a % n + n) % n; }

// PotentialDipole.window_scalar_math_sq: (B(d), C(d), C'(d)/d) from d^2.
// The reciprocal of the erfc polynomial's argument is __fdividef's (2 ulp, no
// slow path); the approximation itself is good to 1.5e-7.
template <bool DIRECT>
__device__ __forceinline__ void dipole_math(float d2, const WindowDipoleParams& p, float* b,
                                            float* c, float* cpd) {
  const float rd = rsqrtf(d2);
  const float rd2 = rd * rd;
  if (DIRECT) {
    *b = p.prefactor * rd2 * rd;
    *c = 3.0f * *b * rd2;
    *cpd = -15.0f * *b * (rd2 * rd2);
    return;
  }
  const float gauss = expf(-p.alpha * d2);
  const float y = p.sqrt_alpha * (d2 * rd);
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * y);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erfc = poly * gauss;
  const float g = p.c_gauss * gauss;
  *b = p.prefactor * (erfc * (rd2 * rd) + g * rd2);
  *c = p.prefactor * (3.0f * erfc * (rd2 * rd2 * rd) + g * (2.0f * p.alpha + 3.0f * rd2) * rd2);
  *cpd = -(15.0f * *b * (rd2 * rd2) +
           p.prefactor * g * (4.0f * p.alpha * p.alpha * rd2 + 10.0f * p.alpha * (rd2 * rd2)));
}

// One role of a pair: home dipole mh, partner dipole mp.  Returns the pair
// energy; g += w dE/dp_home, h = w dE/dmh.
__device__ __forceinline__ float pair_role(float rx, float ry, float rz, float4 mh, float4 mp,
                                           float b, float c, float cpd, float w, float* g,
                                           float* h) {
  const float mm = mh.x * mp.x + mh.y * mp.y + mh.z * mp.z;
  const float rh = mh.x * rx + mh.y * ry + mh.z * rz;
  const float rp = mp.x * rx + mp.y * ry + mp.z * rz;
  const float rhrp = rh * rp;
  const float s = -(c * mm) - cpd * rhrp;
  const float crp = c * rp, crh = c * rh;
  g[0] += w * (-s * rx + crp * mh.x + crh * mp.x);
  g[1] += w * (-s * ry + crp * mh.y + crh * mp.y);
  g[2] += w * (-s * rz + crp * mh.z + crh * mp.z);
  h[0] = w * (b * mp.x - crp * rx);
  h[1] = w * (b * mp.y - crp * ry);
  h[2] = w * (b * mp.z - crp * rz);
  return b * mm - c * rhrp;
}

// Shared memory of one warp (one home cell): its doubles (the per-offset
// home-side gradient sums, the energy, the self row of d_offs), the home
// atoms (compacted, plus the centre: position, mu[, mui]), the partners of
// one group of three offsets (position and one dipole each[, the self
// cell's mui]), the row sums, the slot -> home atom map and the pair queue.
__host__ __device__ inline size_t window_dipole_warp_smem(int cap, int split) {
  const size_t cap1 = (size_t)cap + 1, nhome = split ? 3 : 2, npart = split ? 7 : 6,
               nv = split ? 9 : 6;
  const size_t bytes = WARP_DOUBLES * 8 + (nhome * cap1 + npart * (size_t)cap) * 16 +
                       (nv * cap1 + cap + QCAP) * 4;
  return (bytes + 15) / 16 * 16;
}

// pc (cells, 3, cap), mu (cells, cap, 3), mf (cells, cap), offs (14, 3),
// mui (cells, cap, 3) or null.  One warp per home cell, blockDim.x / 32 cells
// a block.
template <bool DIRECT, bool SPLIT>
__global__ void __launch_bounds__(4 * 32, 4)
window_dipole_kernel(const float* __restrict__ pc, const float* __restrict__ mu,
                     const float* __restrict__ mf, const float* __restrict__ offs,
                     const float* __restrict__ mui, double* __restrict__ acc,
                     float* __restrict__ d_pc, float* __restrict__ d_mu,
                     float* __restrict__ d_offs, float* __restrict__ d_mui,
                     WindowDipoleParams p) {
  constexpr int NV = SPLIT ? 9 : 6;  // row sums: g (3), cotangent to d_mu (3) [, to d_mui (3)]
  extern __shared__ float4 smem4[];
  __shared__ int s_sign[N_WIN], s_k[N_WIN];
  __shared__ bool s_last;
  const int cap = p.cap, cap1 = cap + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const size_t stride = window_dipole_warp_smem(cap, SPLIT);
  char* base = reinterpret_cast<char*>(smem4) + warp * stride;
  double* w_gsum = reinterpret_cast<double*>(base);  // (27, 3), then e, self row (3)
  float4* hp = reinterpret_cast<float4*>(base + WARP_DOUBLES * 8);  // (cap + 1) home positions
  float4* hm = hp + cap1;                                             // (cap + 1) home mu
  float4* hmi = hm + cap1;                                            // (cap + 1) home mui
  float4* pp = hmi + (SPLIT ? cap1 : 0);                              // (3, cap) partners
  float4* pm = pp + 3 * cap;                      // (3, cap) partner mu, or mui on -k
  float4* pmi = pm + 3 * cap;                     // (cap) self cell's partner mui
  float* rows = reinterpret_cast<float*>(pmi + (SPLIT ? cap : 0));  // (NV, cap + 1)
  int* hidx = reinterpret_cast<int*>(rows + NV * cap1);                // (cap)
  int* queue = hidx + cap;                                             // (QCAP)

  if (threadIdx.x < N_WIN) {
    const int o = threadIdx.x;
    const int dx = o / 9 - 1, dy = (o / 3) % 3 - 1, dz = o % 3 - 1;
    int k = 0, sign = 0;
    for (int kk = 0; kk < N_OFF && sign == 0; ++kk) {
      const int* r = p.offsets + 3 * kk;
      if (r[0] == dx && r[1] == dy && r[2] == dz) k = kk, sign = 1;
      else if (r[0] == -dx && r[1] == -dy && r[2] == -dz) k = kk, sign = -1;
    }
    s_sign[o] = sign;
    s_k[o] = k;
  }
  for (int i = lane; i < WARP_DOUBLES; i += 32) w_gsum[i] = 0.0;
  __syncthreads();

  const int n_cells = p.nx * p.ny * p.nz;
  const int home = blockIdx.x * n_warps + warp;
  if (home < n_cells) {
    const int hx = home / (p.ny * p.nz), hy = (home / p.nz) % p.ny, hz = home % p.nz;
    // the home cell's occupied slots, compacted in slot order, then the centre
    int nh = 0;
    for (int j0 = 0; j0 < cap; j0 += 32) {
      const int j = j0 + lane;
      bool occ = false;
      float4 cp, cm, cmi;
      if (j < cap) {
        const float* src = pc + (size_t)home * 3 * cap + j;
        const float* m = mu + ((size_t)home * cap + j) * 3;
        occ = mf[(size_t)home * cap + j] > 0.5f;
        cp = make_float4(src[0], src[cap], src[2 * cap], 0.0f);
        cm = make_float4(m[0], m[1], m[2], 0.0f);
        if (SPLIT) {
          const float* mi = mui + ((size_t)home * cap + j) * 3;
          cmi = make_float4(mi[0], mi[1], mi[2], 0.0f);
        }
      }
      const unsigned b = __ballot_sync(FULL_MASK, occ);
      const int at = nh + __popc(b & lanes_below);
      if (occ) {
        hp[at] = cp;
        hm[at] = cm;
        if (SPLIT) hmi[at] = cmi;
      }
      if (j < cap) hidx[j] = occ ? at : -1;
      nh += __popc(b);
    }
    if (lane == 0) {
      hp[nh] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      hm[nh] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (SPLIT) hmi[nh] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int i = lane; i < NV * cap1; i += 32) rows[i] = 0.0f;
    const int n_home = nh < cap ? nh + 1 : nh;  // the centre stands for every empty slot
    // the box of the home atoms (and of the centre): a partner farther from it
    // than the cutoff has no pair, and is not staged
    float lo[3] = {3.0e38f, 3.0e38f, 3.0e38f}, hi[3] = {-3.0e38f, -3.0e38f, -3.0e38f};
    __syncwarp();
    for (int a = lane; a < n_home; a += 32) {
      const float4 h = hp[a];
      lo[0] = fminf(lo[0], h.x), lo[1] = fminf(lo[1], h.y), lo[2] = fminf(lo[2], h.z);
      hi[0] = fmaxf(hi[0], h.x), hi[1] = fmaxf(hi[1], h.y), hi[2] = fmaxf(hi[2], h.z);
    }
    for (int m = 16; m > 0; m >>= 1)
      for (int c = 0; c < 3; ++c) {
        lo[c] = fminf(lo[c], __shfl_xor_sync(FULL_MASK, lo[c], m));
        hi[c] = fmaxf(hi[c], __shfl_xor_sync(FULL_MASK, hi[c], m));
      }
    double e_acc = 0.0, so_acc[3] = {0.0, 0.0, 0.0};

    for (int grp = 0; grp < N_WIN / 3; ++grp) {
      // stage the group's three neighbour cells (dz = -1, 0, 1): the occupied
      // slots within the cutoff of the home box, compacted in slot order,
      // positions shifted by the offset vector
      int nocc[3] = {0, 0, 0}, nbr[3];
      float ov[3][3];
      for (int q = 0; q < 3; ++q) {
        const int o = 3 * grp + q;
        nbr[q] = (wrap_cell(hx + o / 9 - 1, p.nx) * p.ny + wrap_cell(hy + (o / 3) % 3 - 1, p.ny)) *
                     p.nz + wrap_cell(hz + q - 1, p.nz);
        for (int c = 0; c < 3; ++c) ov[q][c] = (float)s_sign[o] * offs[3 * s_k[o] + c];
      }
      __syncwarp();  // the previous group's readers are done
      for (int j0 = 0; j0 < cap; j0 += 32) {
        const int j = j0 + lane;
        // the occupancy and positions of the three cells first, so that those
        // loads are in flight together, then the dipoles of the slots kept
        bool keep[3];
        float4 cp[3];
        int at[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          keep[q] = false;
          if (j < cap) {
            const float* src = pc + (size_t)nbr[q] * 3 * cap + j;
            keep[q] = mf[(size_t)nbr[q] * cap + j] > 0.5f;
            cp[q] = make_float4(src[0] + ov[q][0], src[cap] + ov[q][1], src[2 * cap] + ov[q][2], 0.0f);
          }
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (keep[q]) {
            const float ex = fmaxf(0.0f, fmaxf(lo[0] - cp[q].x, cp[q].x - hi[0]));
            const float ey = fmaxf(0.0f, fmaxf(lo[1] - cp[q].y, cp[q].y - hi[1]));
            const float ez = fmaxf(0.0f, fmaxf(lo[2] - cp[q].z, cp[q].z - hi[2]));
            keep[q] = ex * ex + ey * ey + ez * ez < p.cutoff_sq;
          }
          const unsigned b = __ballot_sync(FULL_MASK, keep[q]);
          at[q] = q * cap + nocc[q] + __popc(b & lanes_below);
          if (keep[q]) pp[at[q]] = cp[q];
          nocc[q] += __popc(b);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (keep[q]) {
            // the dipole of the home atom's role: the partner's mu where the
            // home atom is i (+k and the self cell), its mui where it is j
            const int o = 3 * grp + q;
            const size_t slot = ((size_t)nbr[q] * cap + j) * 3;
            const float* m = (SPLIT && s_sign[o] < 0 ? mui : mu) + slot;
            pm[at[q]] = make_float4(m[0], m[1], m[2], 0.0f);
            if (SPLIT && o == SELF_O)
              pmi[at[q] - q * cap] = make_float4(mui[slot], mui[slot + 1], mui[slot + 2], 0.0f);
          }
        }
      }
      __syncwarp();

      // per-lane sums of the weighted home-side gradient by offset (d_offs)
      float og[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
      int qlen = 0;
      // evaluate queue entries [b0, b0 + n), one a lane, and add each run of
      // one (offset, home atom) into that atom's row sums
      auto drain = [&](int b0, int n) {
        const bool live = lane < n;
        const int entry = live ? queue[b0 + lane] : -1;
        const int q = (entry >> (2 * J_BITS)) & 3, ai = (entry >> J_BITS) & MAX_CAP,
                  j = entry & MAX_CAP;
        float v[NV];
        for (int c = 0; c < NV; ++c) v[c] = 0.0f;
        if (live) {
          const int o = 3 * grp + q;
          const float4 pa = hp[ai], pb = pp[q * cap + j];
          const float rx = pb.x - pa.x, ry = pb.y - pa.y, rz = pb.z - pa.z;
          float b, c, cpd;
          dipole_math<DIRECT>(rx * rx + ry * ry + rz * rz, p, &b, &c, &cpd);
          const int sign = s_sign[o];
          const bool self_cell = o == SELF_O, occupied = ai < nh;
          const float wi = sign > 0 ? (self_cell ? 0.5f : 1.0f) : 0.0f;
          const float wj = occupied && (sign < 0 || self_cell) ? (self_cell ? 0.5f : 1.0f) : 0.0f;
          float h[3];
          if (!SPLIT) {
            e_acc += (double)(wi * pair_role(rx, ry, rz, hm[ai], pm[q * cap + j], b, c, cpd,
                                             wi + wj, v, h));
            v[3] = h[0], v[4] = h[1], v[5] = h[2];
          } else {
            // the home atom as i (mui_home, mu_partner -> d_mui) where wi > 0,
            // else as j (mu_home, mui_partner -> d_mu); on the self cell both
            const bool as_i = wi > 0.0f;
            const float4 mh = as_i ? hmi[ai] : hm[ai];
            e_acc += (double)(wi * pair_role(rx, ry, rz, mh, pm[q * cap + j], b, c, cpd,
                                             as_i ? wi : wj, v, h));
            v[6] = as_i ? h[0] : 0.0f, v[7] = as_i ? h[1] : 0.0f, v[8] = as_i ? h[2] : 0.0f;
            v[3] = as_i ? 0.0f : h[0], v[4] = as_i ? 0.0f : h[1], v[5] = as_i ? 0.0f : h[2];
            if (self_cell && wj > 0.0f) {
              float g_j[3] = {0.0f, 0.0f, 0.0f};
              pair_role(rx, ry, rz, hm[ai], pmi[j], b, c, cpd, wj, g_j, h);
              for (int t = 0; t < 3; ++t) {
                so_acc[t] += 0.5 * ((double)g_j[t] - (double)v[t]);
                v[t] += g_j[t];
                v[3 + t] = h[t];
              }
            }
          }
          for (int t = 0; t < 3; ++t)
            og[0][t] += q == 0 ? v[t] : 0.0f, og[1][t] += q == 1 ? v[t] : 0.0f,
                og[2][t] += q == 2 ? v[t] : 0.0f;
        }
        // segmented sum over the runs of one (offset, home atom)
        const int key = entry >> J_BITS;
        const int prev = __shfl_up_sync(FULL_MASK, key, 1);
        const unsigned heads = __ballot_sync(FULL_MASK, live && (lane == 0 || prev != key));
        const unsigned after = heads & ~((2u << lane) - 1u);
        const int end = after ? __ffs(after) - 1 : n;
#pragma unroll
        for (int m = 1; m < 32; m <<= 1) {
          const bool take = lane + m < end;
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            const float other = __shfl_down_sync(FULL_MASK, v[c], m);
            if (take) v[c] += other;
          }
        }
        // heads of one home atom (its runs of several offsets, or of several
        // test rounds) add one after the other, in lane order
        const bool head = (heads >> lane) & 1u;
        const unsigned same = __match_any_sync(FULL_MASK, head ? ai : -1 - lane);
        const int rank = head ? __popc(same & lanes_below) : 0;
        const int ranks = __reduce_max_sync(FULL_MASK, rank);
        for (int r = 0; r <= ranks; ++r) {
          if (head && rank == r)
            for (int c = 0; c < NV; ++c) rows[c * cap1 + ai] += v[c];
          __syncwarp();
        }
      };

      // items: (offset q of the group, home atom) with the home atoms in
      // chunks of 32 lanes; a lane tests its atom against the offset's
      // partners, JCH at a time, and queues the pairs inside the cutoff in
      // (offset, atom, partner) order; the queue drains 32 pairs at a time
      for (int hc = 0; hc < n_home; hc += 32) {
        const int ai = hc + lane;
        const float4 pa = hp[ai < n_home ? ai : 0];
        for (int q = 0; q < 3; ++q) {
          const int o = 3 * grp + q;
          // the centre item only where the plain version counts empty slots
          const bool live = ai < nh || (ai < n_home && s_sign[o] > 0);
          const float4* pj = pp + q * cap;
          for (int jb = 0; jb < nocc[q]; jb += JCH) {
            const int n = min(JCH, nocc[q] - jb);
            unsigned mask = 0u;
#pragma unroll 4
            for (int jj = 0; jj < n; ++jj) {
              const float4 b = pj[jb + jj];
              const float dx = b.x - pa.x, dy = b.y - pa.y, dz = b.z - pa.z;
              const float d2 = dx * dx + dy * dy + dz * dz;
              mask |= (unsigned)(live && d2 > 0.0f && d2 < p.cutoff_sq) << jj;
            }
            const int cnt = __popc(mask);
            int incl = cnt;
#pragma unroll
            for (int m = 1; m < 32; m <<= 1) {
              const int up = __shfl_up_sync(FULL_MASK, incl, m);
              if (lane >= m) incl += up;
            }
            int at = qlen + incl - cnt;
            const int tag = (q << (2 * J_BITS)) | (ai << J_BITS) | jb;
            while (mask) {
              queue[at++] = tag + __ffs(mask) - 1;
              mask &= mask - 1u;
            }
            qlen += __shfl_sync(FULL_MASK, incl, 31);
            __syncwarp();
            int b0 = 0;
            for (; b0 + 32 <= qlen; b0 += 32) drain(b0, 32);
            if (b0 > 0) {
              // carry the rest (< 32, never overlapping its source) to the front
              const int rest = qlen - b0;
              const int moved = lane < rest ? queue[b0 + lane] : 0;
              __syncwarp();
              if (lane < rest) queue[lane] = moved;
              __syncwarp();
              qlen = rest;
            }
          }
        }
      }
      if (qlen > 0) drain(0, qlen);
      // the group's per-offset gradient sums: over the lanes, then in double
      for (int q = 0; q < 3; ++q)
        for (int t = 0; t < 3; ++t) {
          float s = og[q][t];
          for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(FULL_MASK, s, m);
          if (lane == 0) w_gsum[3 * (3 * grp + q) + t] = (double)s;
        }
    }
    __syncwarp();
    // every slot's rows, written once: empty slots take the centre's
    for (int idx = lane; idx < NV * cap; idx += 32) {
      const int c = idx / cap, slot = idx - c * cap;
      const int ai = hidx[slot] < 0 ? nh : hidx[slot];
      const float sum = rows[c * cap1 + ai];
      if (c < 3) d_pc[((size_t)home * 3 + c) * cap + slot] = sum;
      else if (c < 6) d_mu[((size_t)home * cap + slot) * 3 + (c - 3)] = sum;
      else d_mui[((size_t)home * cap + slot) * 3 + (c - 6)] = sum;
    }
    for (int m = 16; m > 0; m >>= 1) {
      e_acc += __shfl_xor_sync(FULL_MASK, e_acc, m);
      for (int t = 0; t < 3; ++t) so_acc[t] += __shfl_xor_sync(FULL_MASK, so_acc[t], m);
    }
    if (lane == 0) {
      w_gsum[3 * N_WIN] = e_acc;
      for (int t = 0; t < 3; ++t) w_gsum[3 * N_WIN + 1 + t] = so_acc[t];
    }
  }
  __syncthreads();

  // the block's d_offs and energy: d_offs[k] = 1/2 (S(-k) - S(+k)), the self
  // row from the lanes' sums; one double atomic per value
  const char* all = reinterpret_cast<const char*>(smem4);
  for (int t = threadIdx.x; t < 3 * N_OFF; t += blockDim.x) {
    const int k = t / 3, c = t % 3;
    double v = 0.0;
    for (int w = 0; w < n_warps; ++w) {
      const double* g = reinterpret_cast<const double*>(all + w * stride);
      if (k != p.self_k) {
        const int* r = p.offsets + 3 * k;
        const int o_plus = (r[0] + 1) * 9 + (r[1] + 1) * 3 + r[2] + 1, o_minus = N_WIN - 1 - o_plus;
        v += 0.5 * (g[3 * o_minus + c] - g[3 * o_plus + c]);
      } else if (SPLIT) {
        v += g[3 * N_WIN + 1 + c];
      }
    }
    if (v != 0.0) atomicAdd(acc + 1 + t, v);
  }
  if (threadIdx.x == 0) {
    double e_block = 0.0;
    for (int w = 0; w < n_warps; ++w)
      e_block += reinterpret_cast<const double*>(all + w * stride)[3 * N_WIN];
    atomicAdd(acc, e_block);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = reinterpret_cast<unsigned*>(acc + 1 + 3 * N_OFF);
    s_last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int t = threadIdx.x; t < 3 * N_OFF; t += blockDim.x)
      d_offs[t] = (float)((volatile double*)acc)[1 + t];
  }
}

extern "C" {

// Home cells (warps) a block takes at a capacity on `device` (split:
// separate i-side dipoles): the most of 4, 2, 1 whose shared memory fits the
// block's opt-in limit; 0 when none does (then the capacity exceeds
// tpme_window_dipole_max_cap).
int tpme_window_dipole_warps(int cap, int split, int device) {
  if (cap < 1 || cap > MAX_CAP) return 0;
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, window_dipole_kernel<false, true>) != cudaSuccess)
    return 0;
  const size_t limit = (size_t)optin - attr.sharedSizeBytes;
  const int warps[3] = {4, 2, 1};
  for (int w : warps)
    if (w * window_dipole_warp_smem(cap, split) <= limit) return w;
  return 0;
}

// The largest capacity that the kernel takes (one home cell a block).
int tpme_window_dipole_max_cap(int split, int device) {
  int lo = 0, hi = MAX_CAP;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tpme_window_dipole_warps(mid, split, device) > 0) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

int tpme_window_dipole(const float* pc, const float* mu, const float* mf, const float* offs,
                       const float* mui, double* acc, float* d_pc, float* d_mu, float* d_offs,
                       float* d_mui, const WindowDipoleParams* p, void* stream) {
  if ((mui == nullptr) != (d_mui == nullptr) || p->cap > MAX_CAP || p->warps < 1 || p->warps > 4)
    return (int)cudaErrorInvalidValue;
  const int n_cells = p->nx * p->ny * p->nz;
  const bool split = mui != nullptr;
  const size_t smem = p->warps * window_dipole_warp_smem(p->cap, split);
  const int blocks = (n_cells + p->warps - 1) / p->warps;
  cudaStream_t st = (cudaStream_t)stream;
#define WD_LAUNCH(D, S)                                                                          \
  {                                                                                              \
    if (cudaFuncSetAttribute(window_dipole_kernel<D, S>,                                         \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=          \
        cudaSuccess)                                                                             \
      return (int)cudaGetLastError();                                                            \
    window_dipole_kernel<D, S><<<blocks, 32 * p->warps, smem, st>>>(pc, mu, mf, offs, mui, acc,  \
                                                                    d_pc, d_mu, d_offs, d_mui,   \
                                                                    *p);                         \
  }
  if (p->direct) {
    if (split) WD_LAUNCH(true, true) else WD_LAUNCH(true, false)
  } else {
    if (split) WD_LAUNCH(false, true) else WD_LAUNCH(false, false)
  }
#undef WD_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
