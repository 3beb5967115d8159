// Aligned charge spreading on Hopper: kernels A (forward) and B (backward).
//
// Replaces torchpme_tpu/ops/pallas/spread_fused.py:_fwd_kernel (launched by
// fused_spread) and :_bwd_kernel (launched by _fused_bwd).  The math is that
// of _fwd_math/_bwd_math: per slot, scaled fractional coordinates
// rel = (pos @ cell^-1) * ns give a stencil start (floor for even node
// counts, round-half-even for odd ones) and an offset, the 1D weights are
// Horner polynomials of the offset (Lagrange / P3M coefficient tables), and
// node o of the x (y) stencil lands on local window cell lx + o (ly + o)
// of its tile, dropped beyond the window extent; z wraps modulo nz.
//
// What bounds it on the H100.  A: at the main path (256 tiles, 480 slots,
// 5^3 stencil) the spread is 15.4M weighted adds into a 128^3 mesh, few
// FLOPs per byte; the cost is the scattered accumulation.  The TPU kernel
// produced per-tile fields and folded them with reshapes because TPU
// scatters serialize.  Here one block owns one tile: it accumulates the
// tile's (E, E, nz) local field in shared memory with shared-memory float
// atomics (15*15*128*4 B = 115 KB at the main path, dynamic shared memory
// above the 48 KB default), then adds that field into the periodic mesh with
// global atomics, which fuses the TPU package's tile fold and roll(-lpad).
// B: one thread per slot reads its 5^3 window of the mesh cotangent (wrapping
// modulo the mesh) and contracts it against the weight and derivative
// stencils; it needs no atomics, and reads of neighbouring slots of one tile
// hit the same cache lines.
//
// First version: plain CUDA C++, no TMA / wgmma.  float32 only; the wrapper
// (ops/spread_fused.py) checks shapes, dtypes and the shared-memory size.

#include <cuda_runtime.h>

#define MAX_NODES 8
#define TILE 8

struct SpreadParams {
  int nx, ny, nz;
  int nodes, extent, lpad, ty_count;
  int n_tiles, kp, n_ch;
  float coeff[MAX_NODES * MAX_NODES];  // [node][power]
  float deriv[MAX_NODES * MAX_NODES];  // [node][power], nodes-1 powers used
};

__device__ __forceinline__ int fmod_i(int a, int n) { return (a % n + n) % n; }

// (base, offset) per the grid-centering parity rule of ops/mesh.py
__device__ __forceinline__ void axis_offset(float r, int nodes, int* base, float* off) {
  if (nodes % 2 == 0) {
    float b = floorf(r);
    *base = (int)b;
    *off = r - (b + 0.5f);
  } else {
    float b = rintf(r);  // round half to even, as jnp.round / torch.round
    *base = (int)b;
    *off = r - b;
  }
}

__device__ __forceinline__ float horner(const float* c, int n, float x) {
  float acc = c[n - 1];
  for (int i = n - 2; i >= 0; --i) acc = acc * x + c[i];
  return acc;
}

// Local window start of a slot along x or y, and the global z start.
struct SlotGeom {
  int lx, ly, sz;
  float offx, offy, offz;
};

__device__ __forceinline__ SlotGeom slot_geom(const float* rel3, int tile, const SpreadParams& p) {
  const int shift0 = 1 - (p.nodes + 1) / 2;
  const int ox = tile / p.ty_count * TILE;
  const int oy = tile % p.ty_count * TILE;
  int bx, by, bz;
  SlotGeom g;
  axis_offset(rel3[0], p.nodes, &bx, &g.offx);
  axis_offset(rel3[1], p.nodes, &by, &g.offy);
  axis_offset(rel3[2], p.nodes, &bz, &g.offz);
  g.lx = fmod_i(fmod_i(bx + shift0, p.nx) + p.lpad - ox, p.nx);
  g.ly = fmod_i(fmod_i(by + shift0, p.ny) + p.lpad - oy, p.ny);
  g.sz = fmod_i(bz + shift0, p.nz);
  return g;
}

// Kernel A: one block per tile.  rel (nb, 3), q (nb, C) in slot order
// (slot = tile * kp + k); rho (C, nx, ny, nz) zeroed by the caller.
__global__ void spread_fwd_kernel(const float* __restrict__ rel,
                                  const float* __restrict__ q,
                                  float* __restrict__ rho, SpreadParams p) {
  extern __shared__ float field[];  // (E, E, nz) local tile field
  __shared__ float s_coeff[MAX_NODES * MAX_NODES];
  for (int i = threadIdx.x; i < MAX_NODES * MAX_NODES; i += blockDim.x) s_coeff[i] = p.coeff[i];
  const int tile = blockIdx.x;
  const int n = p.nodes, e = p.extent, nz = p.nz;
  const int field_size = e * e * nz;
  const int ox = tile / p.ty_count * TILE;
  const int oy = tile % p.ty_count * TILE;
  const int items = p.kp * n;  // (slot, x node) pairs

  for (int ch = 0; ch < p.n_ch; ++ch) {
    for (int i = threadIdx.x; i < field_size; i += blockDim.x) field[i] = 0.0f;
    __syncthreads();
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int k = it / n, a = it % n;
      const int slot = tile * p.kp + k;
      const SlotGeom g = slot_geom(rel + 3 * slot, tile, p);
      if (g.lx + a >= e) continue;
      const float wx = horner(s_coeff + a * MAX_NODES, n, g.offx);
      const float qv = q[slot * p.n_ch + ch];
      float wz[MAX_NODES];
      for (int c = 0; c < n; ++c) wz[c] = horner(s_coeff + c * MAX_NODES, n, g.offz) * qv;
      float* row = field + (g.lx + a) * e * nz;
      for (int b = 0; b < n; ++b) {
        if (g.ly + b >= e) continue;
        const float wxy = wx * horner(s_coeff + b * MAX_NODES, n, g.offy);
        float* col = row + (g.ly + b) * nz;
        for (int c = 0; c < n; ++c) {
          int z = g.sz + c;
          if (z >= nz) z -= nz;
          atomicAdd(col + z, wxy * wz[c]);
        }
      }
    }
    __syncthreads();
    // fold: local cell (ex, ey) is mesh cell (ox - lpad + ex, oy - lpad + ey)
    float* out = rho + (size_t)ch * p.nx * p.ny * nz;
    for (int i = threadIdx.x; i < field_size; i += blockDim.x) {
      const float v = field[i];
      if (v == 0.0f) continue;
      const int z = i % nz;
      const int ey = (i / nz) % e;
      const int ex = i / (nz * e);
      const int gx = fmod_i(ox - p.lpad + ex, p.nx);
      const int gy = fmod_i(oy - p.lpad + ey, p.ny);
      atomicAdd(out + ((size_t)gx * p.ny + gy) * nz + z, v);
    }
    __syncthreads();
  }
}

// Kernel B: one thread per slot.  ct (C, nx, ny, nz) is dE/drho; writes
// ct_rel (nb, 3) and ct_q (nb, C).
__global__ void spread_bwd_kernel(const float* __restrict__ rel,
                                  const float* __restrict__ q,
                                  const float* __restrict__ ct,
                                  float* __restrict__ ct_rel,
                                  float* __restrict__ ct_q, SpreadParams p) {
  __shared__ float s_coeff[MAX_NODES * MAX_NODES], s_deriv[MAX_NODES * MAX_NODES];
  for (int i = threadIdx.x; i < MAX_NODES * MAX_NODES; i += blockDim.x) {
    s_coeff[i] = p.coeff[i];
    s_deriv[i] = p.deriv[i];
  }
  __syncthreads();
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= p.n_tiles * p.kp) return;
  const int tile = slot / p.kp;
  const int n = p.nodes, e = p.extent, nz = p.nz;
  const int ox = tile / p.ty_count * TILE;
  const int oy = tile % p.ty_count * TILE;
  const SlotGeom g = slot_geom(rel + 3 * slot, tile, p);
  const int nd = n > 1 ? n - 1 : 1;

  float wx[MAX_NODES], wy[MAX_NODES], wz[MAX_NODES];
  float dwx[MAX_NODES], dwy[MAX_NODES], dwz[MAX_NODES];
  for (int o = 0; o < n; ++o) {
    wx[o] = horner(s_coeff + o * MAX_NODES, n, g.offx);
    wy[o] = horner(s_coeff + o * MAX_NODES, n, g.offy);
    wz[o] = horner(s_coeff + o * MAX_NODES, n, g.offz);
    dwx[o] = horner(s_deriv + o * MAX_NODES, nd, g.offx);
    dwy[o] = horner(s_deriv + o * MAX_NODES, nd, g.offy);
    dwz[o] = horner(s_deriv + o * MAX_NODES, nd, g.offz);
  }
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  for (int ch = 0; ch < p.n_ch; ++ch) {
    const float qv = q[slot * p.n_ch + ch];
    const float* mesh = ct + (size_t)ch * p.nx * p.ny * nz;
    float cq = 0.0f;
    for (int a = 0; a < n; ++a) {
      if (g.lx + a >= e) continue;
      const int gx = fmod_i(ox - p.lpad + g.lx + a, p.nx);
      for (int b = 0; b < n; ++b) {
        if (g.ly + b >= e) continue;
        const int gy = fmod_i(oy - p.lpad + g.ly + b, p.ny);
        const float* col = mesh + ((size_t)gx * p.ny + gy) * nz;
        // z contractions of this (a, b) column: weights and derivatives
        float sw = 0.0f, sd = 0.0f;
        for (int c = 0; c < n; ++c) {
          int z = g.sz + c;
          if (z >= nz) z -= nz;
          const float v = col[z];
          sw += wz[c] * v;
          sd += dwz[c] * v;
        }
        cq += wx[a] * wy[b] * sw;
        cx += qv * dwx[a] * wy[b] * sw;
        cy += qv * wx[a] * dwy[b] * sw;
        cz += qv * wx[a] * wy[b] * sd;
      }
    }
    ct_q[slot * p.n_ch + ch] = cq;
  }
  ct_rel[3 * slot + 0] = cx;
  ct_rel[3 * slot + 1] = cy;
  ct_rel[3 * slot + 2] = cz;
}

extern "C" {

const char* tpme_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

int tpme_max_smem_optin(int device) {
  int value = 0;
  if (cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return 0;
  return value;
}

int tpme_spread_fwd(const float* rel, const float* q, float* rho, const SpreadParams* p,
                    void* stream) {
  const size_t smem = (size_t)p->extent * p->extent * p->nz * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(spread_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  spread_fwd_kernel<<<p->n_tiles, 256, smem, (cudaStream_t)stream>>>(rel, q, rho, *p);
  return (int)cudaGetLastError();
}

int tpme_spread_bwd(const float* rel, const float* q, const float* ct, float* ct_rel,
                    float* ct_q, const SpreadParams* p, void* stream) {
  const int n_slots = p->n_tiles * p->kp;
  const int threads = 128;
  spread_bwd_kernel<<<(n_slots + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      rel, q, ct, ct_rel, ct_q, *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
