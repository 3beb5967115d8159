// Real-space window on Hopper: kernel C, the cell-list energy and its whole
// gradient in one pass.
//
// Replaces torchpme_tpu/ops/rspace_cells.py:_we_value_and_grad (XLA code in
// the JAX package; its Pallas variant was retired there, but it is the
// largest phase of the step).  Energy sum_{pairs} q_i q_j V_SR(d_ij) over
// the cell-list torus window of every home cell; pairs need d^2 < cutoff^2,
// d^2 > 0 and an occupied j slot, and the self pair is excluded by identity
// (its d^2 is 0).  The pair math is a table of up to four 1/r^p terms
// (WindowMember): InversePowerLawPotential.sr_window_math in float32 for
// p = 1..6 (CoulombPotential's is p = 1), V and V'/d from d^2 with one shared
// Gaussian (Abramowitz & Stegun 7.1.26 erfc for odd p) and rsqrt; or, in the
// compile-time DIRECT variant (potentials without smearing, the calculators'
// direct mode), the unsmeared V = P d^-p, V'/d = -p V / d^2.  KIND 0 is one
// term at p = 1 (compiled for it), KIND 1 one term of any p, KIND 2 a
// CombinedPotential: V = sum_k w_k V_k over its terms, a loop whose branch
// on p every warp takes the same way (the table is uniform), and each term's
// energy sum q_i q_j V_k accumulated in double besides, which is dE/dw_k.
// The weights are read from device memory (`weights`, float, one a term), so
// that trainable weights on the card need no copy to the host.
// Outputs: acc (double, zeroed by the caller: [0] the energy, [1, 43) the
// d_offs sums, [43] a block counter, [44, 48) the members' energies, [48, 57)
// the image term of the cell gradient), d_pc (cells, 3, cap), d_q (cells,
// cap, C) and d_offs (14, 3), written whole by the kernel; the caller's
// autograd carries them to positions, charges, the cell and the weights.
//
// What bounds it on the H100.  At the main path (5120 cells, cap 24) the
// window is ~80M candidate pairs of occupied slots over 27 offsets, each
// placed and tested in ~12 instructions, and 5.3M pairs inside the cutoff at
// ~50 more (one expf, one rsqrtf, one divide; per term of a combination, in
// KIND 2): instruction issue and its
// latency, with no reuse across blocks.  The first version evaluated each
// pair once (the 14 half-window offsets) and sent the j side home with warp
// shuffles and global float atomics: ~7M atomics on rows that 14 blocks hit
// at once, 8 of 32 lanes idle at cap 24, 96 registers.  This design spends
// the arithmetic twice to drop all of that:
//
// * One block per home cell stages its own cell and its 26 torus neighbours
//   into shared memory with coalesced loads: one float4 per slot (position
//   shifted by the offset vector, occupancy), an empty slot parked far away
//   so that no distance test passes, and the charges.  It takes the 27
//   offsets in passes of `group` (27, 9, 3 or 1; tpme_window_group picks the
//   most that fit the opt-in shared memory): all 27 in one pass up to a
//   capacity of ~200 at one channel (~130 at four), one x plane a pass up to
//   ~580 (~360), and one offset a pass up to ~3000 (~1850;
//   tpme_window_max_cap).
// * Work items are (offset o of 27, home slot i).  An item whose
//   neighbour's atoms all lie (by their bounding box) beyond the cutoff has
//   no pair; the others go to a compacted list that the 224 threads share,
//   so no lane idles on an empty item or for cap < 32.  An item loops over
//   the neighbour's j slots twice: the first pass only tests d^2 and keeps a
//   bit mask, the second evaluates the pair math for the set bits and keeps
//   only i-side terms: g_i = sum s (pc_i - pj),
//   dq_i = sum V q_j, and the energy (in double) at 1/2 a pair, so each pair
//   is counted once from each end.
// * Items store their sums in shared memory; after each pass they are added
//   to the home rows' sums in offset order, the same order for every group
//   size, and the rows of d_pc and d_q are written once with plain stores.
//   Each row has one writer and each item one thread, no atomics, so d_pc
//   and d_q are bitwise reproducible.
// * Empty home slots carry charge 0 (as _prepare_bucketed makes them), so
//   only their d_q is non-zero; they keep the plain version's value, the
//   half window with the self cell at 1/2 (the plain version sums it only
//   where the slot is home).
// * d_offs.  The plain version's d_offs[k] is the total j-side gradient of
//   half-window offset k, sum over its pairs of s (pj - pc_i) = -(sum of
//   the i-side g over those pairs).  Here each such pair is met from its i
//   end at offset +k (g) and from its j end at offset -k, where the i-side
//   gradient of the same pair is -g.  So with S(+k), S(-k) the block's
//   i-side sums over offsets +k and -k, d_offs[k] = 1/2 (S(-k) - S(+k)) over
//   all blocks; the self row is 0 (its pairs cancel).  A block sums them in
//   double and adds one double atomic per value, as the energy; the last
//   block to finish writes the float d_offs.
// * The image term.  The window's cell gradient at fixed positions is
//   -sum over pairs of m_ij (x) g_ij, where m_ij is the integer image vector
//   of the pair (1 or -1 on an axis where the neighbour cell lies across the
//   box's periodic boundary, 0 elsewhere) and g_ij the pair's i-side
//   gradient.  Pushing d_pc through the cell centres instead (the chain
//   rule) sums float per-atom gradients of 1e6 and more times centres of up
//   to the box's edge, and their rounding alone reaches 1e-4 of the result at
//   102k atoms; this sum has none of it.  A boundary block adds its
//   -1/2 sum_o m(home, o) (x) S(o) (each pair is met from both ends, with
//   m and g both negated) by one double atomic per entry.
//
// * Split i-side charges (SPLIT, the x-slab sharded window).  The energy is
//   sum over pairs of qi_i q_j V with a second charge set qi, which the slab
//   zeroes on its halo plane so that each unordered pair counts once, on the
//   rank of its lower-x cell.  A pair is met from both ends, and the role of
//   the home atom is the offset's sign: on the 13 half-window offsets +k it
//   is i (it reads its qi, its partner q, and its charge cotangent goes to
//   d_qi), on their mirrors -k it is j (q against the partner's qi, into
//   d_q), and on the self cell it is both at 1/2 each.  A slot stages both
//   charge sets, as 2C channels (the shared memory of 2C).  An empty home
//   slot keeps the plain version's d_qi (its i-side sums) and a d_q of 0;
//   the self row of d_offs stays 0 (its offset is the zero vector).  Each
//   pair at +k is still met with the home-side gradients g and -g, so
//   d_offs and the image term are those above.  The variants without SPLIT
//   are the code above, unchanged.
//
// Plain CUDA C++, float32 only; the op (csrc/tpme_ops.cpp:window_cuda) checks
// shapes and dtypes.

#include <cuda_runtime.h>

#define N_OFF 14
#define N_WIN 27
#define SELF_O 13
#define MAX_CH 4
#define MAX_MEMBERS 4
#define MEMBER_ROW (2 + 3 * N_OFF)  // acc row of the first member's energy
#define IMAGE_ROW (MEMBER_ROW + MAX_MEMBERS)  // acc rows of the image term, (3, 3)
#define THREADS 224  // 7 full warps: every shuffle and ballot names 32 live lanes
#define FULL_MASK 0xffffffffu
#define FAR 1.0e18f  // where empty slots are parked: (FAR)^2 still fits a float

// One 1/r^p pair term; the constants are rounded to float from the double
// expressions of the plain version's pair math (csrc/tpme_ops.cpp:window_params).
struct WindowMember {
  int p;  // exponent, 1..6
  float alpha, alpha_sq, prefactor, c_gauss;  // c_gauss: the Gaussian term of V'
};

struct WindowParams {
  int nx, ny, nz, cap, n_ch, self_k;
  int group;  // neighbour offsets staged per pass: 27, 9, 3 or 1
  int direct;  // 1: the unsmeared pair (direct mode), 0: the SR part of the Ewald split
  int kind;  // 0: one term, p = 1; 1: one term; 2: a combination of n_members terms
  int n_members;
  float cutoff_sq;
  WindowMember members[MAX_MEMBERS];
  int offsets[3 * N_OFF];
};

__device__ __forceinline__ int wrap_i(int a, int n) { return (a % n + n) % n; }

// (V, V'/d) of one term at compile-time exponent P, from d^2, rsqrt(d^2) and its square
template <int P, bool DIRECT>
__device__ __forceinline__ float2 term_math(float d2, float rd, float rd2, const WindowMember& m) {
  float inv_dp;  // d^-p as products of rd and rd2, in the plain version's order
  if (P == 1) inv_dp = rd;
  else if (P == 2) inv_dp = rd2;
  else if (P == 3) inv_dp = rd2 * rd;
  else if (P == 4) inv_dp = rd2 * rd2;
  else if (P == 5) inv_dp = (rd2 * rd2) * rd;
  else inv_dp = (rd2 * rd2) * rd2;
  if (DIRECT) {
    const float v = m.prefactor * inv_dp;
    return make_float2(v, (-(float)P * v) * rd2);
  }
  const float z = m.alpha_sq * d2;
  const float gauss = expf(-z);
  float q_upper;  // regularized upper incomplete gamma Q(p/2, z)
  if (P % 2) {
    const float sz = m.alpha * (d2 * rd);
    const float t = 1.0f / (1.0f + 0.3275911f * sz);
    const float poly =
        t * (0.254829592f +
             t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
    const float erfc = poly * gauss;
    const float two_rpi = 1.1283791670955126f;  // 2 / sqrt(pi)
    if (P == 1) q_upper = erfc;
    else if (P == 3) q_upper = erfc + (two_rpi * sz) * gauss;
    else q_upper = erfc + ((two_rpi * sz) * (1.0f + (2.0f / 3.0f) * z)) * gauss;
  } else {
    if (P == 2) q_upper = gauss;
    else if (P == 4) q_upper = (1.0f + z) * gauss;
    else q_upper = (1.0f + z * (1.0f + 0.5f * z)) * gauss;
  }
  const float v = (m.prefactor * q_upper) * inv_dp;
  return make_float2(v, -((float)P * v + m.c_gauss * gauss) * rd2);
}

// the same with the exponent read from the table (uniform across the block)
template <bool DIRECT>
__device__ __forceinline__ float2 term_math_rt(float d2, float rd, float rd2, const WindowMember& m) {
  switch (m.p) {
    case 1: return term_math<1, DIRECT>(d2, rd, rd2, m);
    case 2: return term_math<2, DIRECT>(d2, rd, rd2, m);
    case 3: return term_math<3, DIRECT>(d2, rd, rd2, m);
    case 4: return term_math<4, DIRECT>(d2, rd, rd2, m);
    case 5: return term_math<5, DIRECT>(d2, rd, rd2, m);
    default: return term_math<6, DIRECT>(d2, rd, rd2, m);
  }
}

// Shared memory of one block: the home cell (float4 slots, charges) and its
// per-row sums over the offsets, and for the `group` offsets of one pass
// their staged slots (float4) and charges, the item sums and the item list.
// The float4 arrays come first, so that they stay 16-byte aligned.
__host__ __device__ inline size_t window_smem(int cap, int n_ch, int group) {
  const size_t home = (size_t)cap * (4 + n_ch + 3 + n_ch);
  const size_t per_offset = (size_t)cap * (4 + n_ch + 3 + n_ch + 1);
  return (home + group * per_offset) * sizeof(float);
}

// pc (cells, 3, cap), q (cells, cap, C), mf (cells, cap), offs (14, 3).
// G neighbour offsets a pass; with all 27 in one pass the row sums go
// straight to d_pc and d_q.  DIRECT: the unsmeared pair math.  KIND: the
// pair-term table's form (WindowParams::kind); KIND 2 holds the members'
// energies in registers, so it is given more of them.  SPLIT: separate
// i-side charges qi_g (cells, cap, C), their cotangent d_qi_g; a slot then
// holds CQ = 2C charge columns, q first, and the kernel is given the
// registers of KIND 2.
template <int G, bool DIRECT, int KIND, bool SPLIT>
__global__ void __launch_bounds__(THREADS, (KIND == 2 || SPLIT) ? 4 : 6)
window_kernel(const float* __restrict__ pc, const float* __restrict__ q, const float* __restrict__ mf,
        const float* __restrict__ offs, const float* __restrict__ weights,
        const float* __restrict__ qi_g, double* __restrict__ acc, float* __restrict__ d_pc,
        float* __restrict__ d_q, float* __restrict__ d_offs, float* __restrict__ d_qi_g,
        WindowParams p) {
  extern __shared__ float4 smem4[];
  constexpr int NQ = SPLIT ? 2 * MAX_CH : MAX_CH;  // charge-column registers
  const int cap = p.cap, C = p.n_ch, CQ = SPLIT ? 2 * C : C, nv = 3 + CQ;
  float4* s_home = smem4;                                      // (cap) home slots
  float4* s_p = s_home + cap;                                  // (G, cap) staged slots
  float* s_qh = reinterpret_cast<float*>(s_p + G * cap);       // (cap, CQ) home charges
  float* s_sum = s_qh + cap * CQ;                              // (3 + CQ, cap) row sums
  float* s_q = s_sum + nv * cap;                               // (G, cap, CQ)
  float* s_res = s_q + G * cap * CQ;                           // (G, 3 + CQ, cap) item sums
  int* s_list = reinterpret_cast<int*>(s_res + G * nv * cap);  // (G cap) item list
  __shared__ int s_nbr[N_WIN], s_sign[N_WIN], s_jend[N_WIN], s_count;
  __shared__ float s_off[3 * N_WIN], s_box[6 * N_WIN], s_w[MAX_MEMBERS];
  __shared__ double s_gsum[3 * N_WIN];  // per offset: the block's i-side gradient sum
  __shared__ double s_e[THREADS / 32 + 1];
  __shared__ bool s_last;

  const int home = blockIdx.x;
  const int hx = home / (p.ny * p.nz), hy = (home / p.nz) % p.ny, hz = home % p.nz;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
    s_nbr[o] = (wrap_i(hx + dx, p.nx) * p.ny + wrap_i(hy + dy, p.ny)) * p.nz + wrap_i(hz + dz, p.nz);
    for (int c = 0; c < 3; ++c) s_off[3 * o + c] = sign * offs[3 * k + c];
    s_jend[o] = 0;
  }
  if (KIND == 2 && threadIdx.x < p.n_members) s_w[threadIdx.x] = weights[threadIdx.x];
  __syncthreads();
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    const float* src = pc + (size_t)home * 3 * cap + j;
    s_home[j] = make_float4(src[0] + s_off[3 * SELF_O], src[cap] + s_off[3 * SELF_O + 1],
                            src[2 * cap] + s_off[3 * SELF_O + 2], mf[(size_t)home * cap + j]);
  }
  if (!SPLIT) {
    for (int idx = threadIdx.x; idx < cap * C; idx += blockDim.x) s_qh[idx] = q[(size_t)home * cap * C + idx];
  } else {
    for (int idx = threadIdx.x; idx < cap * CQ; idx += blockDim.x) {
      const int j = idx / CQ, c = idx - j * CQ;
      s_qh[idx] = c < C ? q[((size_t)home * cap + j) * C + c] : qi_g[((size_t)home * cap + j) * C + c - C];
    }
  }
  if (G < N_WIN)
    for (int idx = threadIdx.x; idx < nv * cap; idx += blockDim.x) s_sum[idx] = 0.0f;

  double e_acc = 0.0;
  double e_mem[MAX_MEMBERS];  // KIND 2: each member's energy
#pragma unroll
  for (int mi = 0; mi < MAX_MEMBERS; ++mi) e_mem[mi] = 0.0;
  for (int g0 = 0; g0 < N_WIN; g0 += G) {
    __syncthreads();  // the previous pass's readers are done
    if (threadIdx.x == 0) s_count = 0;
    for (int idx = threadIdx.x; idx < G * cap; idx += blockDim.x) {
      const int o = g0 + idx / cap, j = idx % cap;
      const float* src = pc + (size_t)s_nbr[o] * 3 * cap + j;
      const float m = mf[(size_t)s_nbr[o] * cap + j];
      const float x = src[0] + s_off[3 * o], y = src[cap] + s_off[3 * o + 1],
                  z = src[2 * cap] + s_off[3 * o + 2];
      // an empty j slot sits far away: no d^2 test passes
      s_p[idx] = m > 0.5f ? make_float4(x, y, z, m) : make_float4(FAR, FAR, FAR, m);
      if (m > 0.5f) atomicMax(&s_jend[o], j + 1);
    }
    if (!SPLIT) {
      for (int idx = threadIdx.x; idx < G * cap * C; idx += blockDim.x) {
        const int o = g0 + idx / (cap * C);
        s_q[idx] = q[(size_t)s_nbr[o] * cap * C + idx % (cap * C)];
      }
    } else {
      for (int idx = threadIdx.x; idx < G * cap * CQ; idx += blockDim.x) {
        const int o = g0 + idx / (cap * CQ), r = idx % (cap * CQ), j = r / CQ, c = r - j * CQ;
        const size_t src = ((size_t)s_nbr[o] * cap + j) * C;
        s_q[idx] = c < C ? q[src + c] : qi_g[src + c - C];
      }
    }
    __syncthreads();
    // the box of each neighbour cell's occupied atoms, one warp per offset
    for (int ol = warp; ol < G; ol += blockDim.x / 32) {
      float lo[3] = {FAR, FAR, FAR}, hi[3] = {-FAR, -FAR, -FAR};
      for (int j = lane; j < cap; j += 32) {
        const float4 b = s_p[ol * cap + j];
        if (b.w > 0.5f) {
          lo[0] = fminf(lo[0], b.x), lo[1] = fminf(lo[1], b.y), lo[2] = fminf(lo[2], b.z);
          hi[0] = fmaxf(hi[0], b.x), hi[1] = fmaxf(hi[1], b.y), hi[2] = fmaxf(hi[2], b.z);
        }
      }
      for (int m = 16; m > 0; m >>= 1)
        for (int c = 0; c < 3; ++c) {
          lo[c] = fminf(lo[c], __shfl_xor_sync(FULL_MASK, lo[c], m));
          hi[c] = fmaxf(hi[c], __shfl_xor_sync(FULL_MASK, hi[c], m));
        }
      if (lane < 3) s_box[6 * (g0 + ol) + lane] = lo[lane], s_box[6 * (g0 + ol) + 3 + lane] = hi[lane];
    }
    __syncthreads();
    // items with a neighbour atom possibly within the cutoff go to the list; the others
    // have no pair: their sums are 0
    for (int r = 0; r < G * cap; r += blockDim.x) {
      const int it = r + threadIdx.x;
      bool keep = false;
      if (it < G * cap) {
        const int o = g0 + it / cap, i = it % cap;
        const float4 pi = s_home[i];
        const bool work = pi.w > 0.5f || s_sign[o] > 0;
        const float* bx = s_box + 6 * o;
        const float ex = fmaxf(0.0f, fmaxf(bx[0] - pi.x, pi.x - bx[3]));
        const float ey = fmaxf(0.0f, fmaxf(bx[1] - pi.y, pi.y - bx[4]));
        const float ez = fmaxf(0.0f, fmaxf(bx[2] - pi.z, pi.z - bx[5]));
        keep = work && ex * ex + ey * ey + ez * ez < p.cutoff_sq;
        if (!keep) {
          float* res = s_res + (it / cap) * nv * cap + i;
          for (int c = 0; c < nv; ++c) res[c * cap] = 0.0f;
        }
      }
      const unsigned b = __ballot_sync(FULL_MASK, keep);
      if (b) {
        const int leader = __ffs(b) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&s_count, __popc(b));
        at = __shfl_sync(FULL_MASK, at, leader);
        if (keep) s_list[at + __popc(b & ((1u << lane) - 1u))] = it;
      }
    }
    __syncthreads();
    const int n_items = s_count;

    for (int k = threadIdx.x; k < n_items; k += blockDim.x) {
      const int it = s_list[k];
      const int ol = it / cap, i = it - ol * cap, o = g0 + ol;
      const float4 pi = s_home[i];
      const float wq = pi.w > 0.5f ? 1.0f : s_sign[o] < 0 ? 0.0f : o == SELF_O ? 0.5f : 1.0f;
      // SPLIT: the home atom's weight as i (fa) and as j (fb)
      const float fa = s_sign[o] > 0 ? (o == SELF_O ? 0.5f : 1.0f) : 0.0f;
      const float fb = s_sign[o] < 0 ? 1.0f : (o == SELF_O ? 0.5f : 0.0f);
      float gx = 0.0f, gy = 0.0f, gz = 0.0f, dq[NQ];
      for (int c = 0; c < NQ; ++c) dq[c] = 0.0f;
      if (SPLIT || wq > 0.0f) {
        float qi[NQ];  // the home charges (SPLIT: q, then qi)
        for (int c = 0; c < NQ; ++c) qi[c] = c < CQ ? s_qh[i * CQ + c] : 0.0f;
        const float4* pj = s_p + ol * cap;
        const float* qj = s_q + ol * cap * CQ;
        const int jend = s_jend[o];
        for (int jb = 0; jb < jend; jb += 32) {
          const int jlim = min(jb + 32, jend);
          unsigned mask = 0u;
#pragma unroll 4
          for (int j = jb; j < jlim; ++j) {
            const float4 b = pj[j];
            const float dx = pi.x - b.x, dy = pi.y - b.y, dz = pi.z - b.z;
            const float d2 = dx * dx + dy * dy + dz * dz;
            mask |= (unsigned)(d2 > 0.0f && d2 < p.cutoff_sq) << (j - jb);
          }
          while (mask) {
            const int j = jb + __ffs(mask) - 1;
            mask &= mask - 1;
            const float4 b = pj[j];
            const float dx = pi.x - b.x, dy = pi.y - b.y, dz = pi.z - b.z;
            const float d2 = dx * dx + dy * dy + dz * dz;
            const float rd = rsqrtf(d2), rd2 = rd * rd;
            float v, w, vm[MAX_MEMBERS];
            if (KIND == 0) {
              const float2 r = term_math<1, DIRECT>(d2, rd, rd2, p.members[0]);
              v = r.x, w = r.y;
            } else if (KIND == 1) {
              const float2 r = term_math_rt<DIRECT>(d2, rd, rd2, p.members[0]);
              v = r.x, w = r.y;
            } else {
              v = 0.0f, w = 0.0f;
#pragma unroll
              for (int mi = 0; mi < MAX_MEMBERS; ++mi) {
                vm[mi] = 0.0f;
                if (mi < p.n_members) {
                  const float2 r = term_math_rt<DIRECT>(d2, rd, rd2, p.members[mi]);
                  vm[mi] = r.x;
                  v += s_w[mi] * r.x;
                  w += s_w[mi] * r.y;
                }
              }
            }
            float qpair = 0.0f;
            if (!SPLIT) {
              for (int c = 0; c < C; ++c) qpair += qi[c] * qj[j * C + c];
            } else {
              float qa = 0.0f, qb = 0.0f;  // the pair charge with home as i, as j
              for (int c = 0; c < C; ++c) {
                qa += qi[C + c] * qj[j * CQ + c];
                qb += qi[c] * qj[j * CQ + C + c];
              }
              qpair = fa * qa + fb * qb;
            }
            e_acc += 0.5 * (double)(qpair * v);
            if (KIND == 2) {
#pragma unroll
              for (int mi = 0; mi < MAX_MEMBERS; ++mi)
                if (mi < p.n_members) e_mem[mi] += 0.5 * (double)(qpair * vm[mi]);
            }
            const float s = qpair * w;
            gx += s * dx;
            gy += s * dy;
            gz += s * dz;
            if (!SPLIT) {
              for (int c = 0; c < C; ++c) dq[c] += v * qj[j * C + c];
            } else {
              for (int c = 0; c < C; ++c) {
                dq[c] += v * qj[j * CQ + C + c];  // to d_q: the partner's qi
                dq[C + c] += v * qj[j * CQ + c];  // to d_qi: the partner's q
              }
            }
          }
        }
      }
      float* res = s_res + ol * nv * cap + i;
      res[0] = gx;
      res[cap] = gy;
      res[2 * cap] = gz;
      if (!SPLIT) {
        for (int c = 0; c < C; ++c) res[(3 + c) * cap] = dq[c] * wq;
      } else {
        const float wj = pi.w > 0.5f ? fb : 0.0f;
        for (int c = 0; c < CQ; ++c) res[(3 + c) * cap] = dq[c] * (c < C ? wj : fa);
      }
    }
    __syncthreads();
    // fold the pass into the row sums in offset order (the same order for every
    // group size), and keep each offset's gradient sum for d_offs
    for (int idx = threadIdx.x; idx < nv * cap; idx += blockDim.x) {
      const int c = idx / cap, i = idx - c * cap;
      float sum = G < N_WIN ? s_sum[idx] : 0.0f;
      for (int ol = 0; ol < G; ++ol) sum += s_res[(ol * nv + c) * cap + i];
      if (G < N_WIN && g0 + G < N_WIN) s_sum[idx] = sum;
      else if (c < 3) d_pc[((size_t)home * 3 + c) * cap + i] = sum;
      else if (!SPLIT || c < 3 + C) d_q[((size_t)home * cap + i) * C + (c - 3)] = sum;
      else d_qi_g[((size_t)home * cap + i) * C + (c - 3 - C)] = sum;
    }
    for (int t = threadIdx.x; t < 3 * G; t += blockDim.x) {
      const int ol = t / 3, c = t % 3;
      double s = 0.0;
      for (int i = 0; i < cap; ++i) s += s_res[(ol * nv + c) * cap + i];
      s_gsum[3 * (g0 + ol) + c] = s;
    }
  }
  for (int m = 16; m > 0; m >>= 1) e_acc += __shfl_xor_sync(FULL_MASK, e_acc, m);
  if (lane == 0) s_e[warp] = e_acc;
  __syncthreads();
  if (threadIdx.x < 3 * N_OFF) {
    const int k = threadIdx.x / 3, c = threadIdx.x % 3;
    if (k != p.self_k) {
      const int* r = p.offsets + 3 * k;
      const int o_plus = (r[0] + 1) * 9 + (r[1] + 1) * 3 + r[2] + 1, o_minus = N_WIN - 1 - o_plus;
      atomicAdd(acc + 1 + threadIdx.x, 0.5 * (s_gsum[3 * o_minus + c] - s_gsum[3 * o_plus + c]));
    }
  }
  if (threadIdx.x == 0) {
    double e_block = 0.0;
    for (int w = 0; w < (blockDim.x + 31) / 32; ++w) e_block += s_e[w];
    atomicAdd(acc, e_block);
  }
  // the image term, row a (the image axis) and column c: m = floor((h + d) / n)
  // is -1 on the 9 offsets with d = -1 at h = 0 and +1 on those with d = +1 at
  // h = n - 1 (both when n = 1), 0 elsewhere; only a block on the box's
  // boundary has such offsets
  const bool edge = hx == 0 || hy == 0 || hz == 0 || hx == p.nx - 1 || hy == p.ny - 1 ||
                    hz == p.nz - 1;
  if (edge && threadIdx.x < 9) {
    const int a = threadIdx.x / 3, c = threadIdx.x % 3;
    const int h = a == 0 ? hx : a == 1 ? hy : hz, n = a == 0 ? p.nx : a == 1 ? p.ny : p.nz;
    double s = 0.0;
    for (int side = -1; side <= 1; side += 2) {
      if (h != (side < 0 ? 0 : n - 1)) continue;
      for (int t = 0; t < 9; ++t) {  // the offsets whose component a is `side`
        const int u = t / 3 * (a == 0 ? 3 : 9), v = t % 3 * (a == 2 ? 3 : 1);
        const int o = u + v + (side + 1) * (a == 0 ? 9 : a == 1 ? 3 : 1);
        s += side * s_gsum[3 * o + c];
      }
    }
    if (s != 0.0) atomicAdd(acc + IMAGE_ROW + threadIdx.x, -0.5 * s);
  }
  if (KIND == 2) {
    // each member's energy, reduced as the energy is (s_e reused)
#pragma unroll
    for (int mi = 0; mi < MAX_MEMBERS; ++mi) {
      if (mi < p.n_members) {
        double em = e_mem[mi];
        for (int m = 16; m > 0; m >>= 1) em += __shfl_xor_sync(FULL_MASK, em, m);
        __syncthreads();  // s_e's readers are done
        if (lane == 0) s_e[warp] = em;
        __syncthreads();
        if (threadIdx.x == 0) {
          double e_block = 0.0;
          for (int w = 0; w < (blockDim.x + 31) / 32; ++w) e_block += s_e[w];
          atomicAdd(acc + MEMBER_ROW + mi, e_block);
        }
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = reinterpret_cast<unsigned*>(acc + 1 + 3 * N_OFF);
    s_last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x < 3 * N_OFF) {
    __threadfence();
    d_offs[threadIdx.x] = (float)((volatile double*)acc)[1 + threadIdx.x];
  }
}

extern "C" {

// Offsets per pass for a capacity and channel count on `device`: the most of
// 27, 9, 3, 1 whose shared memory fits the block's opt-in limit; 0 when none
// does (then the capacity exceeds tpme_window_max_cap).
int tpme_window_group(int cap, int n_ch, int device) {
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, window_kernel<N_WIN, false, 2, false>) != cudaSuccess)
    return 0;
  const size_t limit = (size_t)optin - attr.sharedSizeBytes;
  const int groups[4] = {27, 9, 3, 1};
  for (int group : groups)
    if (window_smem(cap, n_ch, group) <= limit) return group;
  return 0;
}

// The largest capacity that the kernel takes at n_ch channels (one offset a pass).
int tpme_window_max_cap(int n_ch, int device) {
  int lo = 0, hi = 1 << 16;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tpme_window_group(mid, n_ch, device) > 0) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// weights: the KIND 2 terms' weights on the device (float, n_members), else unused.
// qi, d_qi: the separate i-side charges and their cotangent (cells, cap, C),
// both given (the SPLIT variant) or both null.
int tpme_window(const float* pc, const float* q, const float* mf, const float* offs,
                const float* weights, const float* qi, double* acc, float* d_pc, float* d_q,
                float* d_offs, float* d_qi, const WindowParams* p, void* stream) {
  const int split = qi != nullptr;
  if ((qi == nullptr) != (d_qi == nullptr) ||
      p->n_ch < 1 || p->n_ch > MAX_CH || p->n_members < 1 || p->n_members > MAX_MEMBERS ||
      p->kind < 0 || p->kind > 2 || (p->kind < 2 && p->n_members != 1) ||
      (p->kind == 2 && weights == nullptr) ||
      (p->kind == 0 && p->members[0].p != 1))
    return (int)cudaErrorInvalidValue;
  for (int mi = 0; mi < p->n_members; ++mi)
    if (p->members[mi].p < 1 || p->members[mi].p > 6) return (int)cudaErrorInvalidValue;
  const int n_cells = p->nx * p->ny * p->nz;
  const size_t smem = window_smem(p->cap, split ? 2 * p->n_ch : p->n_ch, p->group);
  cudaStream_t st = (cudaStream_t)stream;
  switch ((((p->group * 2 + (p->direct != 0)) * 3 + p->kind) * 2) + split) {
#define WINDOW_CASE(G, D, K, S)                                                                  \
  case ((G * 2 + D) * 3 + K) * 2 + S:                                                            \
    if (cudaFuncSetAttribute(window_kernel<G, D, K, S>,                                          \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess) \
      return (int)cudaGetLastError();                                                            \
    window_kernel<G, D, K, S><<<n_cells, THREADS, smem, st>>>(pc, q, mf, offs, weights, qi, acc, \
                                                              d_pc, d_q, d_offs, d_qi, *p);      \
    break;
#define WINDOW_SPLITS(G, D, K) WINDOW_CASE(G, D, K, 0) WINDOW_CASE(G, D, K, 1)
#define WINDOW_KINDS(G, D) WINDOW_SPLITS(G, D, 0) WINDOW_SPLITS(G, D, 1) WINDOW_SPLITS(G, D, 2)
    WINDOW_KINDS(27, 0) WINDOW_KINDS(9, 0) WINDOW_KINDS(3, 0) WINDOW_KINDS(1, 0)
    WINDOW_KINDS(27, 1) WINDOW_KINDS(9, 1) WINDOW_KINDS(3, 1) WINDOW_KINDS(1, 1)
#undef WINDOW_KINDS
#undef WINDOW_SPLITS
#undef WINDOW_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
