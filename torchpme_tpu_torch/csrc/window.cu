// Real-space window on Hopper: kernel C, the cell-list energy and its whole
// gradient in one pass.
//
// Replaces torchpme_tpu/ops/rspace_cells.py:_we_value_and_grad (XLA code in
// the JAX package; its Pallas variant was retired there, but it is the
// largest phase of the step).  Energy sum_{pairs} q_i q_j V_SR(d_ij) over
// the 13 half-window neighbor offsets plus the self cell of every home cell;
// pairs need d^2 < cutoff^2, d^2 > 0 and an occupied j slot, the self pair
// is excluded by identity and the self cell's j-side charges carry 1/2.
// The pair math is CoulombPotential.sr_window_math in float32: V and V'/d
// from d^2 with one shared Gaussian (Abramowitz & Stegun 7.1.26 erfc) and
// rsqrt.  Outputs (zeroed by the caller): e (double), d_pc (cells, 3, cap),
// d_q (cells, cap, C), d_offs (14, 3); the caller's autograd carries them
// to positions, charges and the cell.
//
// What bounds it on the H100.  At the main path (5120 cells, cap 24) the
// window is 41M candidate pairs, about 40 FLOPs and one exp each, with no
// reuse across blocks: it is bound by instruction issue, plus the j-side
// gradient traffic.  Design: one block per home cell, its atoms and its
// gradient accumulators in shared memory; the block finds its neighbor
// cells on the torus itself (no rolled copies, which the TPU version
// materialised).  Each warp takes (offset, 32 home atoms) items; lanes are
// home atoms i and loop over the neighbor cell's j atoms in lockstep, so
// the j-side terms are reduced across the warp with shuffles and added to
// the neighbor rows with one global atomic per value; a j whose pairs are
// all masked in the warp is skipped.  d_offs is a block reduction in
// shared memory followed by one atomic per component.
//
// First version: plain CUDA C++, float32 only.  The wrapper
// (ops/rspace_cells.py:window_value_and_grad) checks shapes and dtypes.

#include <cuda_runtime.h>

#define N_OFF 14
#define MAX_CH 4
#define FULL_MASK 0xffffffffu

struct WindowParams {
  int nx, ny, nz, cap, n_ch, self_k;
  float cutoff_sq, alpha, alpha_sq, prefactor, c_gauss;
  int offsets[3 * N_OFF];  // (dx, dy, dz) per offset, in the order of offs
};

__device__ __forceinline__ int wrap_i(int a, int n) { return (a % n + n) % n; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL_MASK, v, m);
  return v;
}

// CoulombPotential.sr_window_math: (V_SR(d), V_SR'(d)/d) from d^2
__device__ __forceinline__ void window_math(float d2, const WindowParams& p, float* v,
                                            float* w) {
  const float rd = rsqrtf(d2);
  const float gauss = expf(-p.alpha_sq * d2);
  const float y = p.alpha * (d2 * rd);
  const float t = 1.0f / (1.0f + 0.3275911f * y);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  *v = p.prefactor * (poly * gauss) * rd;
  *w = -(*v + p.c_gauss * gauss) * (rd * rd);
}

// pc (cells, 3, cap), q (cells, cap, C), mf (cells, cap), offs (14, 3).
__global__ void window_kernel(const float* __restrict__ pc, const float* __restrict__ q,
                              const float* __restrict__ mf, const float* __restrict__ offs,
                              double* __restrict__ e_out, float* __restrict__ d_pc,
                              float* __restrict__ d_q, float* __restrict__ d_offs,
                              WindowParams p) {
  extern __shared__ float smem[];
  const int cap = p.cap, C = p.n_ch;
  float* s_pc = smem;             // 3 * cap, home coordinates
  float* s_q = s_pc + 3 * cap;    // cap * C, home charges
  float* s_dpc = s_q + cap * C;   // 3 * cap, home-side gradient
  float* s_dq = s_dpc + 3 * cap;  // cap * C
  float* s_doff = s_dq + cap * C; // 3 * N_OFF
  __shared__ double s_e;
  __shared__ int s_offsets[3 * N_OFF];

  const int home = blockIdx.x;
  const int hx = home / (p.ny * p.nz), hy = (home / p.nz) % p.ny, hz = home % p.nz;
  for (int i = threadIdx.x; i < 3 * cap; i += blockDim.x) {
    s_pc[i] = pc[(size_t)home * 3 * cap + i];
    s_dpc[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < cap * C; i += blockDim.x) {
    s_q[i] = q[(size_t)home * cap * C + i];
    s_dq[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < 3 * N_OFF; i += blockDim.x) {
    s_doff[i] = 0.0f;
    s_offsets[i] = p.offsets[i];
  }
  if (threadIdx.x == 0) s_e = 0.0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int n_chunks = (cap + 31) / 32;
  // the energy is a sum of terms far larger than their total: accumulate
  // it in double
  double e_acc = 0.0;
  for (int item = warp; item < N_OFF * n_chunks; item += n_warps) {
    const int k = item / n_chunks;
    const int i = (item % n_chunks) * 32 + lane;
    const bool active = i < cap;
    const int nbr = (wrap_i(hx + s_offsets[3 * k], p.nx) * p.ny +
                     wrap_i(hy + s_offsets[3 * k + 1], p.ny)) * p.nz +
                    wrap_i(hz + s_offsets[3 * k + 2], p.nz);
    const bool self_cell = k == p.self_k;
    const float wj = self_cell ? 0.5f : 1.0f;
    const float ofx = offs[3 * k], ofy = offs[3 * k + 1], ofz = offs[3 * k + 2];
    float pix = 0.0f, piy = 0.0f, piz = 0.0f, qi[MAX_CH], dqi[MAX_CH];
    for (int c = 0; c < MAX_CH; ++c) qi[c] = dqi[c] = 0.0f;
    if (active) {
      pix = s_pc[i];
      piy = s_pc[cap + i];
      piz = s_pc[2 * cap + i];
      for (int c = 0; c < C; ++c) qi[c] = s_q[i * C + c];
    }
    float gix = 0.0f, giy = 0.0f, giz = 0.0f;
    float off_acc = 0.0f;  // lane c < 3 accumulates d_offs[k][c]
    const float* npc = pc + (size_t)nbr * 3 * cap;
    const float* nq = q + (size_t)nbr * cap * C;
    const float* nm = mf + (size_t)nbr * cap;
    for (int j = 0; j < cap; ++j) {
      const float dx = pix - (npc[j] + ofx);
      const float dy = piy - (npc[cap + j] + ofy);
      const float dz = piz - (npc[2 * cap + j] + ofz);
      const float d2 = dx * dx + dy * dy + dz * dz;
      const bool ok = active && d2 > 0.0f && d2 < p.cutoff_sq && nm[j] > 0.5f &&
                      !(self_cell && i == j);
      if (!__any_sync(FULL_MASK, ok)) continue;
      float gj[3 + MAX_CH];
      for (int c = 0; c < 3 + MAX_CH; ++c) gj[c] = 0.0f;
      if (ok) {
        float v, w;
        window_math(d2, p, &v, &w);
        float qj[MAX_CH], qpair = 0.0f;
        for (int c = 0; c < C; ++c) {
          qj[c] = nq[j * C + c] * wj;
          qpair += qi[c] * qj[c];
        }
        e_acc += (double)(qpair * v);
        const float s = qpair * w;
        gix += s * dx;
        giy += s * dy;
        giz += s * dz;
        gj[0] = -s * dx;
        gj[1] = -s * dy;
        gj[2] = -s * dz;
        for (int c = 0; c < C; ++c) {
          dqi[c] += v * qj[c];
          gj[3 + c] = v * qi[c] * wj;
        }
      }
      // j-side terms: butterfly sums leave every total on every lane; lane c
      // issues the atomic of value c
      for (int c = 0; c < 3 + C; ++c) {
        const float tot = warp_sum(gj[c]);
        if (lane == c) {
          if (c < 3) {
            atomicAdd(d_pc + ((size_t)nbr * 3 + c) * cap + j, tot);
            off_acc += tot;
          } else {
            atomicAdd(d_q + ((size_t)nbr * cap + j) * C + (c - 3), tot);
          }
        }
      }
    }
    if (active) {
      atomicAdd(s_dpc + i, gix);
      atomicAdd(s_dpc + cap + i, giy);
      atomicAdd(s_dpc + 2 * cap + i, giz);
      for (int c = 0; c < C; ++c) atomicAdd(s_dq + i * C + c, dqi[c]);
    }
    if (lane < 3) atomicAdd(s_doff + 3 * k + lane, off_acc);
  }
  e_acc = warp_sum(e_acc);
  if (lane == 0) atomicAdd(&s_e, e_acc);
  __syncthreads();

  for (int i = threadIdx.x; i < 3 * cap; i += blockDim.x)
    atomicAdd(d_pc + (size_t)home * 3 * cap + i, s_dpc[i]);
  for (int i = threadIdx.x; i < cap * C; i += blockDim.x)
    atomicAdd(d_q + (size_t)home * cap * C + i, s_dq[i]);
  for (int i = threadIdx.x; i < 3 * N_OFF; i += blockDim.x) atomicAdd(d_offs + i, s_doff[i]);
  if (threadIdx.x == 0) atomicAdd(e_out, s_e);
}

extern "C" int tpme_window(const float* pc, const float* q, const float* mf, const float* offs,
                           double* e, float* d_pc, float* d_q, float* d_offs,
                           const WindowParams* p, void* stream) {
  if (p->n_ch < 1 || p->n_ch > MAX_CH) return (int)cudaErrorInvalidValue;
  const int n_cells = p->nx * p->ny * p->nz;
  const size_t smem = (size_t)(6 * p->cap + 2 * p->cap * p->n_ch + 3 * N_OFF) * sizeof(float);
  window_kernel<<<n_cells, 128, smem, (cudaStream_t)stream>>>(pc, q, mf, offs, e, d_pc, d_q,
                                                             d_offs, *p);
  return (int)cudaGetLastError();
}
