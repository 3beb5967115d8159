// Tile-bucketed mesh spreading and gathering on Hopper: kernels D (spread),
// E (gather) and F (weight gradient).
//
// Replaces torchpme_tpu/ops/pallas/mesh_pallas.py:_spread_kernel (launched by
// _spread_impl), :_gather_kernel (_gather_impl) and :_wgrad_kernel
// (_wgrad_impl).  The data is that of a TiledInterpolation: atoms bucketed
// into 8x8 xy mesh tiles (T tiles, K slots each), per slot the stencil start
// inside the tile (lx, ly in [0, 8)), the z start (sz in [0, nz)) and the 1D
// stencil weights w (T, K, 3, n); charges or values per slot as (T, C, K).
// Node o of the x (y) stencil lands on local window cell lx + o (ly + o) of
// the tile's E = 8 + n - 1 wide window and is dropped beyond it (a stale
// bucketing; the validity flag of the refresh reports it); z wraps modulo nz.
// Empty slots carry zero weights and contribute nothing.
//
// What bounds them on the H100.  The TPU kernels densify the weights and run
// an (E^2, K) x (K, C nz) product per tile only because TPU scatters
// serialize; the work itself is n^3 multiply-adds per atom and channel, a few
// FLOPs per byte moved, so all three are bound by bytes: the slot data
// (weights, indices, charges) read once and the mesh written or read once.
// Unlike the TPU kernels, none of them materializes per-tile fields in device
// memory: D adds into the periodic (C, nx, ny, nz) mesh and E/F read it, so
// the tile fold and the tile extraction of the TPU path are fused away.
//
// D: one block per (tile, channel, z chunk) accumulates the tile's (E, E, zc)
// local field in shared memory with shared-memory float atomics (12*12*128*4
// B = 72 KB at n = 5, nz = 128: dynamic shared memory above the 48 KB
// default; longer z or a smaller budget splits z into chunks), then adds the
// non-zero part of that field into the mesh with global atomics (neighbouring
// tiles overlap by n - 1 cells).  A thread takes one (slot, z node) pair so
// that the threads of one slot hit different banks.  The sum order is
// run-dependent; everything accumulates in float32.
// E and F: one thread per slot reads its n^3 window of the mesh (wrapping
// modulo the mesh) once and contracts it with the weights: E leaves nothing
// open (the per-slot value), F leaves one axis open at a time (the cotangent
// of each 1D weight).  One launch can produce both, which is what the
// backward of the spread wants; no atomics.  The stencil size is a template
// parameter so the per-thread weight and accumulator arrays stay in registers.
//
// First version: plain CUDA C++, no TMA / wgmma.  float32 only; the wrapper
// (ops/mesh_kernels.py) checks shapes, dtypes and the shared-memory size.

#include <cuda_runtime.h>

#define TILE 8

struct MeshParams {
  int nx, ny, nz;
  int nodes, extent, ty_count;
  int n_tiles, cap, n_ch;
  int z_chunk, n_chunks;  // D only: z cells per block and blocks per z line
};

// Kernel D.  grid (T, C * n_chunks); mesh (C, nx, ny, nz) zeroed by the caller.
template <int N>
__global__ void mesh_spread_kernel(const int* __restrict__ lx, const int* __restrict__ ly,
                                   const int* __restrict__ sz, const float* __restrict__ w,
                                   const float* __restrict__ q, float* __restrict__ mesh,
                                   MeshParams p) {
  extern __shared__ float field[];  // (E, E, zn) local tile field
  const int tile = blockIdx.x;
  const int ch = blockIdx.y / p.n_chunks;
  const int z0 = (blockIdx.y % p.n_chunks) * p.z_chunk;
  const int zn = min(p.z_chunk, p.nz - z0);
  const int e = p.extent, nz = p.nz, cap = p.cap;
  const int field_size = e * e * zn;
  for (int i = threadIdx.x; i < field_size; i += blockDim.x) field[i] = 0.0f;
  __syncthreads();

  const float* q_t = q + ((size_t)tile * p.n_ch + ch) * cap;
  for (int it = threadIdx.x; it < cap * N; it += blockDim.x) {
    const int k = it / N, c = it % N;
    const size_t slot = (size_t)tile * cap + k;
    const float* ws = w + slot * 3 * N;
    const float wzq = ws[2 * N + c] * q_t[k];
    if (wzq == 0.0f) continue;
    const int z = (sz[slot] + c) % nz - z0;
    if (z < 0 || z >= zn) continue;
    const int x0 = lx[slot], y0 = ly[slot];
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if (x0 + a >= e) continue;
      const float wxz = ws[a] * wzq;
#pragma unroll
      for (int b = 0; b < N; ++b) {
        if (y0 + b >= e) continue;
        atomicAdd(field + ((x0 + a) * e + y0 + b) * zn + z, wxz * ws[N + b]);
      }
    }
  }
  __syncthreads();

  // local cell (ex, ey) of tile (tx, ty) is mesh cell (tx*8 + ex, ty*8 + ey)
  const int ox = tile / p.ty_count * TILE;
  const int oy = tile % p.ty_count * TILE;
  float* out = mesh + (size_t)ch * p.nx * p.ny * nz;
  for (int i = threadIdx.x; i < field_size; i += blockDim.x) {
    const float v = field[i];
    if (v == 0.0f) continue;
    const int z = i % zn;
    const int ey = (i / zn) % e;
    const int ex = i / (zn * e);
    const int gx = (ox + ex) % p.nx;
    const int gy = (oy + ey) % p.ny;
    atomicAdd(out + ((size_t)gx * p.ny + gy) * nz + z0 + z, v);
  }
}

// Kernels E and F in one pass over the slot's window.  mesh (C, nx, ny, nz);
// vals (T, C, K) when GATHER; q (T, C, K) in and wg (T, K, 3, N) out when
// WGRAD:  wg[k][axis][o] = d/dw[k][axis][o] sum_c q[c][k] sum_xyz wx wy wz F_c.
template <int N, bool WGRAD>
__global__ void mesh_gather_wgrad_kernel(const int* __restrict__ lx, const int* __restrict__ ly,
                                         const int* __restrict__ sz, const float* __restrict__ w,
                                         const float* __restrict__ q,
                                         const float* __restrict__ mesh,
                                         float* __restrict__ vals, float* __restrict__ wg,
                                         MeshParams p) {
  const size_t slot = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= (size_t)p.n_tiles * p.cap) return;
  const int tile = (int)(slot / p.cap), k = (int)(slot % p.cap);
  const int e = p.extent, nz = p.nz;
  const int ox = tile / p.ty_count * TILE;
  const int oy = tile % p.ty_count * TILE;
  const int x0 = lx[slot], y0 = ly[slot], z0 = sz[slot];

  float wx[N], wy[N], wz[N];
  int zi[N];
#pragma unroll
  for (int o = 0; o < N; ++o) {
    wx[o] = w[slot * 3 * N + o];
    wy[o] = w[slot * 3 * N + N + o];
    wz[o] = w[slot * 3 * N + 2 * N + o];
    zi[o] = (z0 + o) % nz;
  }
  // an empty slot (all weights zero) reads no window: every output is zero
  float wsum = 0.0f;
#pragma unroll
  for (int o = 0; o < N; ++o) wsum += fabsf(wx[o]) + fabsf(wy[o]) + fabsf(wz[o]);
  if (wsum == 0.0f) {
    if (vals != nullptr)
      for (int ch = 0; ch < p.n_ch; ++ch) vals[((size_t)tile * p.n_ch + ch) * p.cap + k] = 0.0f;
    if (WGRAD)
      for (int o = 0; o < 3 * N; ++o) wg[slot * 3 * N + o] = 0.0f;
    return;
  }
  float gx[N], gy[N], gz[N];
#pragma unroll
  for (int o = 0; o < N; ++o) gx[o] = gy[o] = gz[o] = 0.0f;

  for (int ch = 0; ch < p.n_ch; ++ch) {
    const float* m = mesh + (size_t)ch * p.nx * p.ny * nz;
    const size_t ck = ((size_t)tile * p.n_ch + ch) * p.cap + k;
    const float qv = WGRAD ? q[ck] : 0.0f;
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if (x0 + a >= e) continue;
      const int gxi = (ox + x0 + a) % p.nx;
      float sa = 0.0f;  // sum_b wy[b] sum_c wz[c] F
#pragma unroll
      for (int b = 0; b < N; ++b) {
        if (y0 + b >= e) continue;
        const int gyi = (oy + y0 + b) % p.ny;
        const float* col = m + ((size_t)gxi * p.ny + gyi) * nz;
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const float v = col[zi[c]];
          s += wz[c] * v;
          if (WGRAD) gz[c] += wx[a] * wy[b] * qv * v;
        }
        sa += wy[b] * s;
        if (WGRAD) gy[b] += wx[a] * qv * s;
      }
      acc += wx[a] * sa;
      if (WGRAD) gx[a] += qv * sa;
    }
    if (vals != nullptr) vals[ck] = acc;
  }
  if (WGRAD) {
#pragma unroll
    for (int o = 0; o < N; ++o) {
      wg[slot * 3 * N + o] = gx[o];
      wg[slot * 3 * N + N + o] = gy[o];
      wg[slot * 3 * N + 2 * N + o] = gz[o];
    }
  }
}

template <int N>
static int launch_spread(const int* lx, const int* ly, const int* sz, const float* w,
                         const float* q, float* mesh, const MeshParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)p.extent * p.extent * p.z_chunk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mesh_spread_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_tiles, p.n_ch * p.n_chunks);
  mesh_spread_kernel<N><<<grid, 256, smem, stream>>>(lx, ly, sz, w, q, mesh, p);
  return (int)cudaGetLastError();
}

template <int N>
static int launch_gather_wgrad(const int* lx, const int* ly, const int* sz, const float* w,
                               const float* q, const float* mesh, float* vals, float* wg,
                               const MeshParams& p, cudaStream_t stream) {
  const size_t n_slots = (size_t)p.n_tiles * p.cap;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n_slots + threads - 1) / threads);
  if (wg != nullptr)
    mesh_gather_wgrad_kernel<N, true><<<blocks, threads, 0, stream>>>(lx, ly, sz, w, q, mesh, vals,
                                                                      wg, p);
  else
    mesh_gather_wgrad_kernel<N, false><<<blocks, threads, 0, stream>>>(lx, ly, sz, w, q, mesh,
                                                                       vals, wg, p);
  return (int)cudaGetLastError();
}

// the stencil sizes of the Lagrange tables (3 to 7 nodes)
#define DISPATCH_NODES(CALL)            \
  switch (p->nodes) {                   \
    case 3: return CALL(3);             \
    case 4: return CALL(4);             \
    case 5: return CALL(5);             \
    case 6: return CALL(6);             \
    case 7: return CALL(7);             \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// Kernel D: q (T, C, K) -> mesh (C, nx, ny, nz), added into a zeroed mesh.
int tpme_mesh_spread(const int* lx, const int* ly, const int* sz, const float* w, const float* q,
                     float* mesh, const MeshParams* p, void* stream) {
#define SPREAD_CALL(N) launch_spread<N>(lx, ly, sz, w, q, mesh, *p, (cudaStream_t)stream)
  DISPATCH_NODES(SPREAD_CALL)
#undef SPREAD_CALL
}

// Kernels E and/or F: vals (T, C, K) unless null; wg (T, K, 3, n) from
// q (T, C, K) unless wg is null.
int tpme_mesh_gather_wgrad(const int* lx, const int* ly, const int* sz, const float* w,
                           const float* q, const float* mesh, float* vals, float* wg,
                           const MeshParams* p, void* stream) {
  if (vals == nullptr && wg == nullptr) return (int)cudaErrorInvalidValue;
  if (wg != nullptr && q == nullptr) return (int)cudaErrorInvalidValue;
#define GATHER_CALL(N) \
  launch_gather_wgrad<N>(lx, ly, sz, w, q, mesh, vals, wg, *p, (cudaStream_t)stream)
  DISPATCH_NODES(GATHER_CALL)
#undef GATHER_CALL
}

}  // extern "C"
