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
// pair is excluded by identity and the self cell's j-side dipoles carry 1/2.
// With s = -C M - (C'/d) Ri Rj (B' = -C d holds identically):
//   dE/dp_i  = -s r + C (Rj mu_i + Ri mu_j)   and dE/dp_j = -dE/dp_i,
//   dE/dmu_i =  B mu_j - C Rj r,   dE/dmu_j = B mu_i - C Ri r,
// term for term ops/rspace_cells_dipole.py:_dw_value_and_grad.  The pair math
// is PotentialDipole.window_scalar_math_sq in float32: (B, C, C'/d) from d^2
// with one shared Gaussian (Abramowitz & Stegun 7.1.26 erfc) and rsqrt; direct
// mode (no smearing) is pure rationals.  The Chebyshev fits the TPU kernel
// evaluates exist because its compiler lowers no erfc; the card has expf.
// Outputs (zeroed by the caller): e (double), d_pc (cells, 3, cap), d_mu
// (cells, cap, 3), d_offs (14, 3; double), and d_mui (cells, cap, 3) when the
// i side has dipoles of its own (mui); without mui the i-side dipole
// cotangent is added into d_mu.
//
// What bounds it on the H100.  At the main path (8000 cells, cap 24) the
// window is tens of millions of candidate pairs, about 90 FLOPs and one exp
// for each pair inside the cutoff, with no reuse across blocks: it is bound
// by instruction issue and the j-side gradient traffic, not by bytes (the
// inputs are a few MB).  Design, as kernel C (window.cu): one block per home
// cell, its atoms and its gradient accumulators in shared memory; the block
// finds its neighbor cells on the torus itself, so the pre-rolled copies, the
// lane chunking, the SELF plane and the j-side write-backs of the TPU version
// do not exist.  Each warp takes (offset, 32 home atoms) items; lanes are home
// atoms i and loop over the neighbor cell's j atoms in lockstep, so the six
// j-side cotangents are reduced across the warp with shuffles and added to
// their home slot with one global atomic per value; a j whose pairs are all
// masked in the warp is skipped.  d_offs is a block reduction in shared
// memory followed by one atomic per component.  The energy and d_offs (the
// total of every j-side force of an offset, 1/d^4 terms that cancel) are sums
// of terms far larger than their total and accumulate in double.
//
// First version: plain CUDA C++, float32 only.  The wrapper
// (ops/rspace_cells_dipole.py:dipole_window_value_and_grad) checks shapes and
// dtypes.

#include <cuda_runtime.h>

#define N_OFF 14
#define FULL_MASK 0xffffffffu

struct WindowDipoleParams {
  int nx, ny, nz, cap, self_k, direct;
  float cutoff_sq, alpha, sqrt_alpha, prefactor, c_gauss;
  int offsets[3 * N_OFF];  // (dx, dy, dz) per offset, in the order of offs
};

__device__ __forceinline__ int wrap_cell(int a, int n) { return (a % n + n) % n; }

template <typename T>
__device__ __forceinline__ T warp_total(T v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL_MASK, v, m);
  return v;
}

// PotentialDipole.window_scalar_math_sq: (B(d), C(d), C'(d)/d) from d^2
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
  const float t = 1.0f / (1.0f + 0.3275911f * y);
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

// pc (cells, 3, cap), mu (cells, cap, 3), mf (cells, cap), offs (14, 3),
// mui (cells, cap, 3) or null (then the i side reads mu).
template <bool DIRECT>
__global__ void window_dipole_kernel(const float* __restrict__ pc, const float* __restrict__ mu,
                                     const float* __restrict__ mf,
                                     const float* __restrict__ offs,
                                     const float* __restrict__ mui, double* __restrict__ e_out,
                                     float* __restrict__ d_pc, float* __restrict__ d_mu,
                                     double* __restrict__ d_offs, float* __restrict__ d_mui,
                                     WindowDipoleParams p) {
  extern __shared__ float smem[];
  const int cap = p.cap;
  float* s_pc = smem;              // 3 * cap, home coordinates (3, cap)
  float* s_mu = s_pc + 3 * cap;    // 3 * cap, home i-side dipoles (cap, 3)
  float* s_dpc = s_mu + 3 * cap;   // 3 * cap, home-side position gradient (3, cap)
  float* s_dmu = s_dpc + 3 * cap;  // 3 * cap, home-side dipole gradient (cap, 3)
  __shared__ double s_e;
  __shared__ double s_doff[3 * N_OFF];
  __shared__ int s_offsets[3 * N_OFF];

  const int home = blockIdx.x;
  const int hx = home / (p.ny * p.nz), hy = (home / p.nz) % p.ny, hz = home % p.nz;
  const float* mu_i = mui != nullptr ? mui : mu;
  for (int i = threadIdx.x; i < 3 * cap; i += blockDim.x) {
    s_pc[i] = pc[(size_t)home * 3 * cap + i];
    s_mu[i] = mu_i[(size_t)home * 3 * cap + i];
    s_dpc[i] = 0.0f;
    s_dmu[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < 3 * N_OFF; i += blockDim.x) {
    s_doff[i] = 0.0;
    s_offsets[i] = p.offsets[i];
  }
  if (threadIdx.x == 0) s_e = 0.0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int n_chunks = (cap + 31) / 32;
  double e_acc = 0.0;
  for (int item = warp; item < N_OFF * n_chunks; item += n_warps) {
    const int k = item / n_chunks;
    const int i = (item % n_chunks) * 32 + lane;
    const bool active = i < cap;
    const int nbr = (wrap_cell(hx + s_offsets[3 * k], p.nx) * p.ny +
                     wrap_cell(hy + s_offsets[3 * k + 1], p.ny)) * p.nz +
                    wrap_cell(hz + s_offsets[3 * k + 2], p.nz);
    const bool self_cell = k == p.self_k;
    const float wj = self_cell ? 0.5f : 1.0f;
    const float ofx = offs[3 * k], ofy = offs[3 * k + 1], ofz = offs[3 * k + 2];
    float pix = 0.0f, piy = 0.0f, piz = 0.0f, mix = 0.0f, miy = 0.0f, miz = 0.0f;
    if (active) {
      pix = s_pc[i];
      piy = s_pc[cap + i];
      piz = s_pc[2 * cap + i];
      mix = s_mu[3 * i];
      miy = s_mu[3 * i + 1];
      miz = s_mu[3 * i + 2];
    }
    float gix = 0.0f, giy = 0.0f, giz = 0.0f;  // dE/dp_i
    float hix = 0.0f, hiy = 0.0f, hiz = 0.0f;  // dE/dmu_i
    double off_acc = 0.0;  // lane c < 3 accumulates d_offs[k][c]
    const float* npc = pc + (size_t)nbr * 3 * cap;
    const float* nmu = mu + (size_t)nbr * 3 * cap;
    const float* nm = mf + (size_t)nbr * cap;
    for (int j = 0; j < cap; ++j) {
      const float rx = (npc[j] + ofx) - pix;
      const float ry = (npc[cap + j] + ofy) - piy;
      const float rz = (npc[2 * cap + j] + ofz) - piz;
      const float d2 = rx * rx + ry * ry + rz * rz;
      const bool ok = active && d2 > 0.0f && d2 < p.cutoff_sq && nm[j] > 0.5f &&
                      !(self_cell && i == j);
      if (!__any_sync(FULL_MASK, ok)) continue;
      float gj[6];  // dE/dp_j (3), dE/dmu_j (3, for the unscaled home dipole)
      for (int c = 0; c < 6; ++c) gj[c] = 0.0f;
      if (ok) {
        float b, c, cpd;
        dipole_math<DIRECT>(d2, p, &b, &c, &cpd);
        const float mjx = nmu[3 * j] * wj, mjy = nmu[3 * j + 1] * wj, mjz = nmu[3 * j + 2] * wj;
        const float mm = mix * mjx + miy * mjy + miz * mjz;
        const float ri = mix * rx + miy * ry + miz * rz;
        const float rj = mjx * rx + mjy * ry + mjz * rz;
        const float rirj = ri * rj;
        e_acc += (double)(b * mm - c * rirj);
        const float s = -(c * mm) - cpd * rirj;
        const float crj = c * rj, cri = c * ri;
        // dE/dp_i = -s r + C (Rj mu_i + Ri mu_j); the j side is its mirror
        const float fx = -s * rx + crj * mix + cri * mjx;
        const float fy = -s * ry + crj * miy + cri * mjy;
        const float fz = -s * rz + crj * miz + cri * mjz;
        gix += fx;
        giy += fy;
        giz += fz;
        gj[0] = -fx;
        gj[1] = -fy;
        gj[2] = -fz;
        hix += b * mjx - crj * rx;
        hiy += b * mjy - crj * ry;
        hiz += b * mjz - crj * rz;
        gj[3] = wj * (b * mix - cri * rx);
        gj[4] = wj * (b * miy - cri * ry);
        gj[5] = wj * (b * miz - cri * rz);
      }
      // j-side terms: butterfly sums leave every total on every lane; lane c
      // issues the atomic of value c
      for (int c = 0; c < 6; ++c) {
        const float tot = warp_total(gj[c]);
        if (lane == c) {
          if (c < 3) {
            atomicAdd(d_pc + ((size_t)nbr * 3 + c) * cap + j, tot);
            off_acc += (double)tot;
          } else {
            atomicAdd(d_mu + ((size_t)nbr * cap + j) * 3 + (c - 3), tot);
          }
        }
      }
    }
    if (active) {
      atomicAdd(s_dpc + i, gix);
      atomicAdd(s_dpc + cap + i, giy);
      atomicAdd(s_dpc + 2 * cap + i, giz);
      atomicAdd(s_dmu + 3 * i, hix);
      atomicAdd(s_dmu + 3 * i + 1, hiy);
      atomicAdd(s_dmu + 3 * i + 2, hiz);
    }
    if (lane < 3) atomicAdd(s_doff + 3 * k + lane, off_acc);
  }
  e_acc = warp_total(e_acc);
  if (lane == 0) atomicAdd(&s_e, e_acc);
  __syncthreads();

  // the i-side dipole cotangent goes to d_mui when the i side has its own
  // dipoles, else into d_mu beside the j-side terms
  float* d_mu_i = mui != nullptr ? d_mui : d_mu;
  for (int i = threadIdx.x; i < 3 * cap; i += blockDim.x) {
    atomicAdd(d_pc + (size_t)home * 3 * cap + i, s_dpc[i]);
    atomicAdd(d_mu_i + (size_t)home * 3 * cap + i, s_dmu[i]);
  }
  for (int i = threadIdx.x; i < 3 * N_OFF; i += blockDim.x) atomicAdd(d_offs + i, s_doff[i]);
  if (threadIdx.x == 0) atomicAdd(e_out, s_e);
}

extern "C" int tpme_window_dipole(const float* pc, const float* mu, const float* mf,
                                  const float* offs, const float* mui, double* e, float* d_pc,
                                  float* d_mu, double* d_offs, float* d_mui,
                                  const WindowDipoleParams* p, void* stream) {
  if ((mui == nullptr) != (d_mui == nullptr)) return (int)cudaErrorInvalidValue;
  const int n_cells = p->nx * p->ny * p->nz;
  const size_t smem = (size_t)(12 * p->cap) * sizeof(float);
  if (p->direct)
    window_dipole_kernel<true><<<n_cells, 128, smem, (cudaStream_t)stream>>>(
        pc, mu, mf, offs, mui, e, d_pc, d_mu, d_offs, d_mui, *p);
  else
    window_dipole_kernel<false><<<n_cells, 128, smem, (cudaStream_t)stream>>>(
        pc, mu, mf, offs, mui, e, d_pc, d_mu, d_offs, d_mui, *p);
  return (int)cudaGetLastError();
}
