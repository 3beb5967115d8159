// Charge spreading from scaled fractional coordinates on Hopper: kernels A
// (forward) and B (backward), for the aligned MD state (position-bucketed
// slots, a window that begins lpad cells before the tile) and for the
// stencil-start bucketing of fused_tiled_density (lpad = 0, extent =
// TILE + nodes - 1, tile slots in bucketing order).
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
//   most one tile over.  With lpad = 0 every window begins at its own
//   tile's origin, so only the 2 x 2 tiles at and before the block's reach
//   it.  In the aligned layout slots are tile * kp + zcell * cap + s, so the
//   z cells whose atoms can reach the chunk are an index range, one segment
//   of cap slots per (tile, z cell), whose starts the block tabulates: an
//   atom stays within one z cell of its own while the staleness check
//   accepts it (slack < 1/2 cell edge), a stale one may be missed (its
//   energy is NaN).  The stencil-start bucketing has one z cell (z_cells =
//   1): the block reads every slot of its tiles.
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
// What bounds B.  Its work is a gather: per slot n^3 reads of the mesh
// cotangent against the weight and derivative stencils (8 MB of mesh, 1.5 MB
// of rel, 0.5 MB of charges in and 2 MB out at the main path), bound by
// bytes.  Its first version took one thread a slot with runtime node loops
// (the six stencil arrays in local memory) and 4-byte reads of device memory
// scattered over the (x, y) columns of a warp's slots, every slot of a tile
// reading the same window again.  This design stages the window once per
// block, as kernels E and F do (csrc/mesh.cu):
//
// * One block of 256 threads per (tile, z chunk) copies the tile's slot
//   rows (rel, q) and its (E, E, zc + n - 1) window of every channel into
//   shared memory with 16-byte cp.async, and owns the slots whose z stencil
//   start lies in its chunk.  It finds them by scanning all of its tile's
//   slots while the window is in flight, in both layouts: ranges from the
//   cell list's z cells, as A uses, would leave a slot that drifted past
//   them without an owner and its outputs unwritten.  The copy loops walk
//   x columns by warp and (y column, vector) by lane, with one conditional
//   wrap per index: the first version indexed columns with integer
//   divisions, and its staging took most of the kernel.
//   The z chunk (csrc/tpme_ops.cpp:spread_bwd_z_chunk) is 64 cells where the
//   windows take at most 64 KB, 32 otherwise (the best of 32 / 64 / 128
//   cells and 128 / 256 threads at the main path's shapes); where a block
//   does not fit shared memory at all (tens of channels), one thread a slot
//   reads device memory instead.
// * The node count is a template parameter: weights and derivatives are
//   Horner polynomials evaluated into registers, with the coefficient
//   tables read from the kernel's parameters as constants.
// * One pass per (a, b) column forms sum wz F and sum dwz F, which feed
//   ct_q, ct_x, ct_y and ct_z.  Each slot has one owner and one thread:
//   plain stores, no atomics, bitwise equal launches.  Occupied slots run
//   first in each warp's list, empty ones (ct_rel = 0; ct_q is their gather,
//   which the output contract keeps) after them.
//
// Plain CUDA C++, no TMA / wgmma; float32 only; the op (csrc/tpme_ops.cpp)
// checks shapes and dtypes.

#include <cuda_runtime.h>

#define MAX_NODES 8
#define TILE 8

struct SpreadParams {
  int nx, ny, nz;
  int nodes, extent, lpad, ty_count;
  int n_tiles, kp, n_ch;
  int z_cells, z_chunk;  // cell-list z cells of a tile column; mesh z cells a block of A owns
  int bwd_z_chunk;       // mesh z cells a block of B stages (0: one thread a slot)
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
  // distinct neighbour tiles along each axis (an axis of 2 tiles has 2).
  // With lpad = 0 (the stencil-start bucketing) a slot's window begins at its
  // tile's origin and spans extent <= 2 TILE cells, so only the tile itself
  // and the one before it reach the block, stale slots included
  const bool near = p.lpad > 0;
  const int x_tiles = near && tx_count >= 3 ? 3 : 2, y_tiles = near && ty_count >= 3 ? 3 : 2;
  const int x_first = near && tx_count < 3 ? 0 : -1, y_first = near && ty_count < 3 ? 0 : -1;
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

// -- kernel B --------------------------------------------------------------------

#define BWD_THREADS 256

// floats a staged window column of kernel B takes: the chunk and the
// stencil's reach, rounded up to whole 16-byte vectors
__host__ __device__ __forceinline__ int bwd_row(int zc, int n) { return (zc + n - 1 + 3) & ~3; }

// ints of a warp's slot list in kernel B: 32 for each of its scan rounds
__host__ __device__ __forceinline__ int bwd_list(int kp) {
  return (kp + BWD_THREADS - 1) / BWD_THREADS * 32;
}

static __device__ __forceinline__ void bwd_cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

static __device__ __forceinline__ void bwd_cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// n contiguous floats into shared memory (dst 16-byte aligned), 16 bytes a
// thread where the source allows it
static __device__ __forceinline__ void bwd_copy(float* dst, const float* src, int n) {
  if (n % 4 == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) bwd_cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) bwd_cp_async4(dst + i, src + i);
  }
}

// floats of the staged slot rows of kernel B: the tile's rel (kp, 3) and q
// (kp, C), each rounded up to whole 16-byte vectors
__host__ __device__ __forceinline__ int bwd_slot_floats(int kp, int n_ch) {
  return ((3 * kp + 3) & ~3) + ((n_ch * kp + 3) & ~3);
}

// Horner evaluation of a polynomial of M coefficients (a compile-time count,
// so that a table row held in the kernel's parameters, __grid_constant__, is
// read in place rather than copied to the stack)
template <int M>
__device__ __forceinline__ float horner_n(const float* c, float x) {
  float acc = c[M - 1];
#pragma unroll
  for (int i = M - 2; i >= 0; --i) acc = acc * x + c[i];
  return acc;
}

// One slot's stencil for kernel B: the local window starts along x and y
// (dropped nodes: lx + a >= extent), the global z start, and the weights and
// their derivatives along each axis, in registers
template <int N>
struct Stencil {
  int lx, ly, sz;
  float wx[N], wy[N], wz[N], dx[N], dy[N], dz[N];
};

template <int N>
__device__ __forceinline__ void stencil_of(const float* rel3, int ox, int oy, const SpreadParams& p,
                                           Stencil<N>& s) {
  constexpr int ND = N > 1 ? N - 1 : 1;
  const float inv_nx = 1.0f / p.nx, inv_ny = 1.0f / p.ny, inv_nz = 1.0f / p.nz;
  float offx, offy, offz;
  const int X = axis_start(rel3[0], N, p.nx, inv_nx, &offx);
  const int Y = axis_start(rel3[1], N, p.ny, inv_ny, &offy);
  s.sz = axis_start(rel3[2], N, p.nz, inv_nz, &offz);
  s.lx = window_index(X, ox, p.lpad, p.nx, inv_nx);
  s.ly = window_index(Y, oy, p.lpad, p.ny, inv_ny);
#pragma unroll
  for (int o = 0; o < N; ++o) {
    const float* c = p.coeff + o * MAX_NODES;
    const float* d = p.deriv + o * MAX_NODES;
    s.wx[o] = horner_n<N>(c, offx);
    s.wy[o] = horner_n<N>(c, offy);
    s.wz[o] = horner_n<N>(c, offz);
    s.dx[o] = horner_n<ND>(d, offx);
    s.dy[o] = horner_n<ND>(d, offy);
    s.dz[o] = horner_n<ND>(d, offz);
  }
}

// A slot's cotangent window as its block staged it: (C, E, E, zs) floats in
// shared memory, z contiguous from the block's first z cell.
struct StagedCols {
  const float* field;
  int e, zs, ch_stride, base;  // base: (lx e + ly) zs + the slot's z start in the chunk
  __device__ __forceinline__ const float* col(int ch, int a, int b) const {
    return field + ch * ch_stride + base + (a * e + b) * zs;
  }
  __device__ __forceinline__ int z(int c) const { return c; }
};

// The same window read from the periodic mesh in device memory.
template <int N>
struct MeshCols {
  const float* mesh;
  size_t ch_stride;
  int nx, ny, nz, gx0, gy0;  // mesh column of the slot's first node
  int zi[N];
  __device__ __forceinline__ const float* col(int ch, int a, int b) const {
    int gx = gx0 + a, gy = gy0 + b;
    if (gx >= nx) gx -= nx;
    if (gy >= ny) gy -= ny;
    return mesh + ch * ch_stride + ((size_t)gx * ny + gy) * nz;
  }
  __device__ __forceinline__ int z(int c) const { return zi[c]; }
};

// Kernel B for one slot: its window contracted with the weight and the
// derivative stencils.  Per (a, b) column it forms sum_c wz F and sum_c dwz F
// once, and per x node the sums over b of wy (.), dwy (.) and wy (sum dwz F),
// which feed ct_q = sum wx wy wz F per channel and ct_rel = sum_ch q_ch
// (sum dwx wy wz F, sum wx dwy wz F, sum wx wy dwz F).  Nodes beyond the
// window in x or y are dropped; an empty slot (q = 0) gets ct_rel = 0 and
// its gather as ct_q.
template <int N, class Window>
__device__ __forceinline__ void bwd_slot(const Window& win, const Stencil<N>& s, int e,
                                         const float* __restrict__ qs, int n_ch,
                                         float* __restrict__ ct_q, float* __restrict__ ct_rel) {
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  for (int ch = 0; ch < n_ch; ++ch) {
    const float qv = qs[ch];
    float cq = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if (s.lx + a >= e) continue;
      float sw = 0.0f, sdy = 0.0f, sdz = 0.0f;
#pragma unroll
      for (int b = 0; b < N; ++b) {
        if (s.ly + b >= e) continue;
        const float* col = win.col(ch, a, b);
        float w = 0.0f, d = 0.0f;
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const float v = col[win.z(c)];
          w += s.wz[c] * v;
          d += s.dz[c] * v;
        }
        sw += s.wy[b] * w;
        sdy += s.dy[b] * w;
        sdz += s.wy[b] * d;
      }
      cq += s.wx[a] * sw;
      gx += s.dx[a] * sw;
      gy += s.wx[a] * sdy;
      gz += s.wx[a] * sdz;
    }
    ct_q[ch] = cq;
    cx += qv * gx;
    cy += qv * gy;
    cz += qv * gz;
  }
  ct_rel[0] = cx;
  ct_rel[1] = cy;
  ct_rel[2] = cz;
}

// Kernel B, staged.  grid (T, z chunks of bwd_z_chunk cells).  The block
// stages its tile's slot rows (rel and q) and its (E, E, zn + N - 1) window
// of every channel of the mesh cotangent (wrapping modulo the mesh) with
// asynchronous copies, 16 bytes a lane where the data allow it (4 bytes a
// lane otherwise, a column a warp), in two groups.  When the rows have landed, each warp scans its share of the
// tile's slots in shared memory and lists those whose z start lies in the
// chunk, occupied slots from the front of its list and empty ones (q = 0 in
// every channel) from the back, so that runs of 32 mostly take one kind,
// while the window is still in flight.  Each slot has one owner in the
// grid, whatever its position, and one thread computes it: plain stores,
// the same sums in the same order on every launch.
template <int N>
__global__ void __launch_bounds__(BWD_THREADS)
spread_bwd_staged_kernel(const float* __restrict__ rel, const float* __restrict__ q,
                         const float* __restrict__ ct, float* __restrict__ ct_rel,
                         float* __restrict__ ct_q, const __grid_constant__ SpreadParams p) {
  // (C, E, E, zs) window, the tile's rel (kp, 3) and q (kp, C), the warps' lists
  extern __shared__ float field[];
  const int e = p.extent, nz = p.nz, kp = p.kp, n_ch = p.n_ch, zc = p.bwd_z_chunk;
  const int tile = blockIdx.x, z0 = blockIdx.y * zc, zn = min(zc, nz - z0), zlen = zn + N - 1;
  const int zs = bwd_row(zc, N), ch_stride = e * e * zs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int tx = tile / p.ty_count, ty = tile - tx * p.ty_count;
  const int ox = tx * TILE, oy = ty * TILE;
  const int list_cap = bwd_list(kp);
  float* s_rel = field + n_ch * ch_stride;
  float* s_q = s_rel + ((3 * kp + 3) & ~3);
  int* list = reinterpret_cast<int*>(s_rel + bwd_slot_floats(kp, n_ch)) + warp * list_cap;
  const size_t slot0 = (size_t)tile * kp;

  bwd_copy(s_rel, rel + 3 * slot0, 3 * kp);
  bwd_copy(s_q, q + n_ch * slot0, n_ch * kp);
  asm volatile("cp.async.commit_group;\n" ::);

  // window column (ex, ey) of channel c is mesh column (ox - lpad + ex,
  // oy - lpad + ey) mod the mesh
  const int vecs = zs / 4;
  if (nz % 4 == 0 && zc % 4 == 0 && vecs <= 32 && (reinterpret_cast<size_t>(ct) & 15) == 0) {
    // 16 bytes a lane: warps over x columns, a warp step over 32 / vecs y
    // columns of zs / 4 vectors each; z0 and nz are multiples of 4, so no
    // vector straddles the wrap
    const int per = 32 / vecs, ly_ = lane / vecs, lv = lane - ly_ * vecs;
    int gz = z0 + 4 * lv;
    while (gz >= nz) gz -= nz;
    if (ly_ < per) {
      for (int c = 0; c < n_ch; ++c) {
        for (int ex = warp; ex < e; ex += n_warps) {
          int gx = ox - p.lpad + ex;
          if (gx < 0) gx += p.nx;
          if (gx >= p.nx) gx -= p.nx;
          const float* src = ct + ((size_t)c * p.nx + gx) * p.ny * nz + gz;
          float* dst = field + c * ch_stride + ex * e * zs + 4 * lv;
          for (int ey = ly_; ey < e; ey += per) {
            int gy = oy - p.lpad + ey;
            if (gy < 0) gy += p.ny;
            if (gy >= p.ny) gy -= p.ny;
            bwd_cp_async16(dst + ey * zs, src + (size_t)gy * nz);
          }
        }
      }
    }
  } else {
    const int n_cols = n_ch * e * e;
    for (int col = warp; col < n_cols; col += n_warps) {
      const int c = col / (e * e), r = col - c * e * e, ex = r / e, ey = r - ex * e;
      int gx = ox - p.lpad + ex, gy = oy - p.lpad + ey;
      while (gx < 0) gx += p.nx;
      while (gx >= p.nx) gx -= p.nx;
      while (gy < 0) gy += p.ny;
      while (gy >= p.ny) gy -= p.ny;
      const float* src = ct + (((size_t)c * p.nx + gx) * p.ny + gy) * nz;
      for (int zz = lane; zz < zlen; zz += 32) {
        int gz = z0 + zz;
        while (gz >= nz) gz -= nz;
        bwd_cp_async4(field + col * zs + zz, src + gz);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 1;\n" ::);  // the slot rows
  __syncthreads();

  // the warp's list of the slots it owns
  const float inv_nz = 1.0f / nz;
  const unsigned below = (1u << lane) - 1u;
  int n_occ = 0, n_emp = 0;
  for (int r0 = warp * 32; r0 < kp; r0 += blockDim.x) {
    const int k = r0 + lane;
    bool mine = false, occupied = false;
    if (k < kp) {
      float off;
      const int sz = axis_start(s_rel[3 * k + 2], N, nz, inv_nz, &off);
      mine = sz >= z0 && sz < z0 + zn;
      for (int ch = 0; ch < n_ch && mine && !occupied; ++ch) occupied = s_q[k * n_ch + ch] != 0.0f;
    }
    const unsigned b_occ = __ballot_sync(0xffffffffu, mine && occupied);
    const unsigned b_emp = __ballot_sync(0xffffffffu, mine && !occupied);
    if (mine && occupied) list[n_occ + __popc(b_occ & below)] = k;
    if (mine && !occupied) list[list_cap - 1 - n_emp - __popc(b_emp & below)] = k;
    n_occ += __popc(b_occ);
    n_emp += __popc(b_emp);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // the window
  __syncthreads();

  const int n_own = n_occ + n_emp;
  for (int j = lane; j < n_own; j += 32) {
    const int k = j < n_occ ? list[j] : list[list_cap - 1 - (j - n_occ)];
    const size_t slot = slot0 + k;
    Stencil<N> s;
    stencil_of<N>(s_rel + 3 * k, ox, oy, p, s);
    const StagedCols win{field, e, zs, ch_stride, (s.lx * e + s.ly) * zs + s.sz - z0};
    bwd_slot<N>(win, s, e, s_q + k * n_ch, n_ch, ct_q + slot * n_ch, ct_rel + 3 * slot);
  }
}

// Kernel B, one thread a slot reading its window from the mesh in device
// memory: where the staged block does not fit shared memory (tens of
// channels), or bwd_z_chunk 0.
template <int N>
__global__ void __launch_bounds__(BWD_THREADS)
spread_bwd_direct_kernel(const float* __restrict__ rel, const float* __restrict__ q,
                         const float* __restrict__ ct, float* __restrict__ ct_rel,
                         float* __restrict__ ct_q, const __grid_constant__ SpreadParams p) {
  const size_t slot = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= (size_t)p.n_tiles * p.kp) return;
  const int tile = (int)(slot / p.kp);
  const int ox = tile / p.ty_count * TILE, oy = tile % p.ty_count * TILE;
  Stencil<N> s;
  stencil_of<N>(rel + 3 * slot, ox, oy, p, s);
  MeshCols<N> win;
  win.mesh = ct;
  win.ch_stride = (size_t)p.nx * p.ny * p.nz;
  win.nx = p.nx;
  win.ny = p.ny;
  win.nz = p.nz;
  win.gx0 = wrap_f(ox - p.lpad + s.lx, p.nx, 1.0f / p.nx);
  win.gy0 = wrap_f(oy - p.lpad + s.ly, p.ny, 1.0f / p.ny);
#pragma unroll
  for (int c = 0; c < N; ++c) {
    int z = s.sz + c;
    if (z >= p.nz) z -= p.nz;
    win.zi[c] = z;
  }
  bwd_slot<N>(win, s, p.extent, q + slot * p.n_ch, p.n_ch, ct_q + slot * p.n_ch, ct_rel + 3 * slot);
}

template <int N>
static int launch_bwd(const float* rel, const float* q, const float* ct, float* ct_rel,
                      float* ct_q, SpreadParams p, cudaStream_t stream) {
  // the windows of every channel, the slot rows and the warps' lists
  auto smem = [&](int zc) {
    return ((size_t)p.n_ch * p.extent * p.extent * bwd_row(zc, N) +
            bwd_slot_floats(p.kp, p.n_ch) + (size_t)(BWD_THREADS / 32) * bwd_list(p.kp)) *
           sizeof(float);
  };
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  int zc = min(p.bwd_z_chunk, p.nz);
  while (zc > 1 && smem(zc) > (size_t)optin) zc = (zc + 1) / 2;
  if (zc <= 0 || smem(zc) > (size_t)optin) {
    const size_t n_slots = (size_t)p.n_tiles * p.kp;
    const unsigned blocks = (unsigned)((n_slots + BWD_THREADS - 1) / BWD_THREADS);
    spread_bwd_direct_kernel<N><<<blocks, BWD_THREADS, 0, stream>>>(rel, q, ct, ct_rel, ct_q, p);
    return (int)cudaGetLastError();
  }
  p.bwd_z_chunk = zc;
  static int granted = 48 * 1024;  // the largest dynamic shared memory asked for so far
  if ((int)smem(zc) > granted) {
    if (cudaFuncSetAttribute(spread_bwd_staged_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem(zc)) !=
        cudaSuccess)
      return (int)cudaGetLastError();
    granted = (int)smem(zc);
  }
  const dim3 grid(p.n_tiles, (p.nz + zc - 1) / zc);
  spread_bwd_staged_kernel<N><<<grid, BWD_THREADS, smem(zc), stream>>>(rel, q, ct, ct_rel, ct_q, p);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->nodes) {
#define BWD_CASE(N) \
  case N:           \
    return launch_bwd<N>(rel, q, ct, ct_rel, ct_q, *p, st);
    BWD_CASE(1) BWD_CASE(2) BWD_CASE(3) BWD_CASE(4)
    BWD_CASE(5) BWD_CASE(6) BWD_CASE(7) BWD_CASE(8)
#undef BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
