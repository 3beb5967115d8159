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
// What bounds A on the H100.  At the main path (256 tiles of 480 slots,
// 5^3 stencil, 128^3 mesh) the spread is 12.7M weighted adds into an 8 MB
// mesh: few FLOPs per byte, bound by where the adds land.  The TPU kernel
// forms each tile's (E^2, K) @ (K, C.nz) product and folds the tile fields
// with reshapes, because TPU scatters serialize.  That product is >95%
// zeros at this density, and tensor cores in TF32 keep ~3 digits where the
// step's bar is 1e-5 in energy, so A stays on CUDA cores.  Its first
// version kept one tile's whole (E, E, nz) field in shared memory (115 KB at
// E = 15: one block of 8 warps per SM, 1.94 waves), recomputed each slot's
// geometry per x node, folded ~7.4M field cells into the mesh with global
// atomics over tiles that overlap 3.5x, needed a zeroed mesh and capped nz
// at the shared-memory opt-in.  This design owns the output instead:
//
// * One block per (mesh tile, z chunk, channel) holds the tile's 8 x 8 x zc
//   mesh cells in shared memory (16 KB at zc = 64; the wrapper's z_chunk
//   picks 2-3 chunks a column): 512 blocks at the main path, no opt-in, and
//   no ceiling on nz.
// * It reads the slots of the 3 x 3 torus tiles around it (2 distinct ones
//   along an axis of 2 tiles): extent <= 2 TILE means a stencil reaches at
//   most one tile over.  Slots are tile * kp + zcell * cap + s, so the z
//   cells whose atoms can reach the chunk are an index range, one segment
//   of cap slots per (tile, z cell), whose starts the block tabulates: an
//   atom stays within one z cell of its own while the staleness check
//   accepts it (slack < 1/2 cell edge), a stale one may be missed (its
//   energy is NaN).
// * A thread takes one candidate slot: an empty one (charge 0) stops after
//   one load, the z nodes are tested next, then x and y, with wraps by a
//   float reciprocal instead of integer divides; only a slot with a node in
//   the block's cells evaluates its 3n Horners, once, and adds the nodes
//   that land there with shared-memory atomics.
// * The block stores its cells with coalesced plain stores: every mesh cell
//   has one writer, no global atomics, no fold and no zeroed mesh.
// * What is left bounds it: a float atomicAdd to shared memory is a
//   compare-and-swap loop on this card, and a warp walks the union of its
//   lanes' stencil nodes.  Two variants ran slower on the card: compacting
//   the slots first, so that full warps take (slot, x node, y node)
//   columns, and binning the nodes per column to drop the atomics.
//
// B: one thread per slot reads its 5^3 window of the mesh cotangent (wrapping
// modulo the mesh) and contracts it against the weight and derivative
// stencils; it needs no atomics, and reads of neighbouring slots of one tile
// hit the same cache lines.
//
// Plain CUDA C++, no TMA / wgmma; float32 only; the wrapper
// (ops/spread_fused.py) checks shapes and dtypes.

#include <cuda_runtime.h>

#define MAX_NODES 8
#define TILE 8

struct SpreadParams {
  int nx, ny, nz;
  int nodes, extent, lpad, ty_count;
  int n_tiles, kp, n_ch;
  int z_cells, z_chunk;  // cell-list z cells of a tile column; mesh z cells a block of A owns
  float coeff[MAX_NODES * MAX_NODES];  // [node][power]
  float deriv[MAX_NODES * MAX_NODES];  // [node][power], nodes-1 powers used
};

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

// floor-mod of an int by n (any sign, |a| < 2^24) with float arithmetic, no
// integer divide
__device__ __forceinline__ int wrap_f(int a, int n, float inv_n) {
  int r = a - (int)floorf((float)a * inv_n) * n;
  if (r < 0) r += n;
  if (r >= n) r -= n;
  return r;
}

// Global stencil start along one axis of n mesh cells, wrapped into [0, n),
// and the weights' offset
__device__ __forceinline__ int axis_start(float r, int nodes, int n, float inv_n, float* off) {
  int b;
  axis_offset(r, nodes, &b, off);
  return wrap_f(b + 1 - (nodes + 1) / 2, n, inv_n);
}

// Index of a global stencil start in the local window of the tile whose
// origin along this axis is o (the window begins lpad cells before it)
__device__ __forceinline__ int window_index(int start, int o, int lpad, int n, float inv_n) {
  return wrap_f(start + lpad - o, n, inv_n);
}

// Local window start of a slot along x or y, and the global z start.
struct SlotGeom {
  int lx, ly, sz;
  float offx, offy, offz;
};

__device__ __forceinline__ SlotGeom slot_geom(const float* rel3, int tile, const SpreadParams& p) {
  const float inv_nx = 1.0f / p.nx, inv_ny = 1.0f / p.ny, inv_nz = 1.0f / p.nz;
  SlotGeom g;
  const int X = axis_start(rel3[0], p.nodes, p.nx, inv_nx, &g.offx);
  const int Y = axis_start(rel3[1], p.nodes, p.ny, inv_ny, &g.offy);
  g.sz = axis_start(rel3[2], p.nodes, p.nz, inv_nz, &g.offz);
  g.lx = window_index(X, tile / p.ty_count * TILE, p.lpad, p.nx, inv_nx);
  g.ly = window_index(Y, tile % p.ty_count * TILE, p.lpad, p.ny, inv_ny);
  return g;
}

// Kernel A: one block per (tile, z chunk, channel).  rel (nb, 3), q (nb, C)
// in slot order (slot = tile * kp + zcell * cap + s); writes every cell of
// rho (C, nx, ny, nz).  Dynamic shared memory: the owned cells (TILE, TILE,
// z_chunk), then the first slot of each (neighbour tile, z cell) segment the
// block reads.
template <int N>
__global__ void __launch_bounds__(256)
spread_fwd_kernel(const float* __restrict__ rel, const float* __restrict__ q,
                  float* __restrict__ rho, SpreadParams p) {
  extern __shared__ float field[];
  int* s_seg = reinterpret_cast<int*>(field + TILE * TILE * p.z_chunk);
  __shared__ float s_coeff[MAX_NODES * MAX_NODES];
  const int tile = blockIdx.x, ch = blockIdx.z;
  const int nx = p.nx, ny = p.ny, nz = p.nz, zc = p.z_chunk;
  const int tx_count = nx / TILE, ty_count = p.ty_count;
  const int tx = tile / ty_count, ty = tile - tx * ty_count;
  const int ox = tx * TILE, oy = ty * TILE;
  const int z0 = blockIdx.y * zc, zlen = min(zc, nz - z0);
  const float inv_nx = 1.0f / nx, inv_ny = 1.0f / ny, inv_nz = 1.0f / nz;

  // z cells whose atoms can reach [z0, z0 + zlen): an atom of z cell c has
  // rel_z in (hz (c - 1), hz (c + 2)) and its nodes within N + 1 of rel_z
  const int cap = p.kp / p.z_cells;
  const float hz = (float)nz / (float)p.z_cells;
  int c_lo = (int)floorf((float)(z0 - N - 1) / hz) - 2;
  int n_zc = (int)ceilf((float)(z0 + zlen + N + 1) / hz) + 1 - c_lo + 1;
  if (n_zc >= p.z_cells) c_lo = 0, n_zc = p.z_cells;
  // distinct neighbour tiles along each axis (an axis of 2 tiles has 2)
  const int x_tiles = tx_count >= 3 ? 3 : 2, y_tiles = ty_count >= 3 ? 3 : 2;
  const int x_first = tx_count >= 3 ? -1 : 0, y_first = ty_count >= 3 ? -1 : 0;
  const int n_seg = x_tiles * y_tiles * n_zc;
  const int candidates = n_seg * cap;

  for (int i = threadIdx.x; i < MAX_NODES * MAX_NODES; i += blockDim.x) s_coeff[i] = p.coeff[i];
  for (int i = threadIdx.x; i < TILE * TILE * zc; i += blockDim.x) field[i] = 0.0f;
  for (int sg = threadIdx.x; sg < n_seg; sg += blockDim.x) {
    const int t = sg / n_zc, m = sg - t * n_zc;
    const int ntx = (tx + x_first + t / y_tiles + tx_count) % tx_count;
    const int nty = (ty + y_first + t % y_tiles + ty_count) % ty_count;
    const int zcell = (c_lo + m + p.z_cells) % p.z_cells;
    s_seg[sg] = (ntx * ty_count + nty) * p.kp + zcell * cap;
  }
  __syncthreads();

  for (int it = threadIdx.x; it < candidates; it += blockDim.x) {
    const int seg = it / cap;
    const int slot = s_seg[seg] + (it - seg * cap);
    const float qv = q[slot * p.n_ch + ch];
    if (qv == 0.0f) continue;  // empty slot (or no charge): adds nothing
    const float* r = rel + 3 * slot;
    // z first: nodes sz .. sz + N - 1 (mod nz) against [z0, z0 + zlen)
    float offz;
    const int dz = wrap_f(axis_start(r[2], N, nz, inv_nz, &offz) - z0, nz, inv_nz);
    if (!(dz < zlen || dz > nz - N)) continue;
    // x and y: node o lies at column (X - ox + o) mod nx of this tile, and
    // inside the window of the slot's own tile while lx0 + o < extent
    float offx, offy;
    const int X = axis_start(r[0], N, nx, inv_nx, &offx);
    const int Y = axis_start(r[1], N, ny, inv_ny, &offy);
    const int ntile = slot / p.kp, ntx = ntile / ty_count, nty = ntile - ntx * ty_count;
    const int lx0 = window_index(X, ntx * TILE, p.lpad, nx, inv_nx);
    const int ly0 = window_index(Y, nty * TILE, p.lpad, ny, inv_ny);
    const int dx = wrap_f(X - ox, nx, inv_nx), dy = wrap_f(Y - oy, ny, inv_ny);
    int lx[N], ly[N], lz[N];
    bool any_x = false, any_y = false;
#pragma unroll
    for (int o = 0; o < N; ++o) {
      int gx = dx + o, gy = dy + o, z = dz + o;
      if (gx >= nx) gx -= nx;
      if (gy >= ny) gy -= ny;
      if (z >= nz) z -= nz;
      lx[o] = (lx0 + o < p.extent && gx < TILE) ? gx : -1;
      ly[o] = (ly0 + o < p.extent && gy < TILE) ? gy : -1;
      lz[o] = z < zlen ? z : -1;
      any_x |= lx[o] >= 0;
      any_y |= ly[o] >= 0;
    }
    if (!(any_x && any_y)) continue;
    float wz[N];
#pragma unroll
    for (int c = 0; c < N; ++c) wz[c] = horner(s_coeff + c * MAX_NODES, N, offz) * qv;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if (lx[a] < 0) continue;
      const float wx = horner(s_coeff + a * MAX_NODES, N, offx);
#pragma unroll
      for (int b = 0; b < N; ++b) {
        if (ly[b] < 0) continue;
        const float wxy = wx * horner(s_coeff + b * MAX_NODES, N, offy);
        float* col = field + (lx[a] * TILE + ly[b]) * zc;
#pragma unroll
        for (int c = 0; c < N; ++c)
          if (lz[c] >= 0) atomicAdd(col + lz[c], wxy * wz[c]);
      }
    }
  }
  __syncthreads();
  float* out = rho + (size_t)ch * nx * ny * nz;
  for (int i = threadIdx.x; i < TILE * TILE * zlen; i += blockDim.x) {
    const int xy = i / zlen, z = i - xy * zlen;
    out[((size_t)(ox + xy / TILE) * ny + oy + xy % TILE) * nz + z0 + z] = field[xy * zc + z];
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
  const float inv_nx = 1.0f / p.nx, inv_ny = 1.0f / p.ny;
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
      const int gx = wrap_f(ox - p.lpad + g.lx + a, p.nx, inv_nx);
      for (int b = 0; b < n; ++b) {
        if (g.ly + b >= e) continue;
        const int gy = wrap_f(oy - p.lpad + g.ly + b, p.ny, inv_ny);
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
  const dim3 grid(p->n_tiles, (p->nz + p->z_chunk - 1) / p->z_chunk, p->n_ch);
  // owned cells, then up to 9 segment starts per z cell
  const size_t smem = (size_t)TILE * TILE * p->z_chunk * sizeof(float) +
                      (size_t)9 * p->z_cells * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->nodes) {
#define SPREAD_CASE(N)                                                                    \
  case N:                                                                                 \
    if (cudaFuncSetAttribute(spread_fwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             (int)smem) != cudaSuccess)                                   \
      return (int)cudaGetLastError();                                                     \
    spread_fwd_kernel<N><<<grid, 256, smem, st>>>(rel, q, rho, *p);                      \
    break;
    SPREAD_CASE(1) SPREAD_CASE(2) SPREAD_CASE(3) SPREAD_CASE(4)
    SPREAD_CASE(5) SPREAD_CASE(6) SPREAD_CASE(7) SPREAD_CASE(8)
#undef SPREAD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
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
