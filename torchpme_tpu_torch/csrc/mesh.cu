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
// FLOPs per byte moved, so all three are bound by bytes in principle: the
// slot data (weights, indices, charges) read once and the mesh written or
// read once.  Unlike the TPU kernels, none of them materializes per-tile
// fields in device memory, so the tile fold and the tile extraction of the
// TPU path are fused away.
//
// D: one block per (tile, channel, z chunk) accumulates the tile's (E, E,
// zc) window in shared memory with shared-memory float atomics
// (compare-and-swap loops on this card, ATOMS.CAST.SPIN in the SASS), then
// adds its non-zero cells into a mesh zeroed by the caller with global
// atomics (neighbouring tiles overlap by n - 1 cells).  The z chunk
// (SPREAD_Z_CHUNK, 32 cells) splits the z line so that the grid fills the
// card: 1024 blocks on the 132 SMs at the 102k shapes (256 tiles).  The work
// items are (slot, z node) columns of n x n nodes, so that the lanes of one
// slot hit different banks; each warp scans its share of them and keeps
// those whose z node lies in the chunk (with non-zero weights) in a list that
// it runs 32 at a time: a lane that idled through another lane's atomic loops
// cost as much as a busy one.  Owner blocks (plain stores of the cells a
// block owns, gathered from the four tiles whose windows reach them, no zero
// fill) were measured slower at every z chunk (PERF.md section 5).
// The dipole form (dw given, one channel) spreads Q(m) = sum_j sum_a nu_ja
// d_a[W_x W_y W_z](m) in one pass per slot: from nu (T, 3, K), w and their
// derivatives dw it builds the node value nu_x dw_x w_y w_z + nu_y w_x dw_y
// w_z + nu_z w_x w_y dw_z in registers, (P_a w_y + Q_a dw_y) with P_a, Q_a per
// x node, and issues one shared atomic per node, a third of the reads and
// atomics of the charge form over every slot three times (dipole_slots).
// Everything accumulates in float32.
// E and F: one thread per slot reads its n^3 window of the mesh (wrapping
// modulo the mesh) once and contracts it with the weights: E leaves nothing
// open (the per-slot value), F leaves one axis open at a time (the cotangent
// of each 1D weight).  One launch can produce both, which is what the
// backward of the spread wants; no atomics.  The stencil size is a template
// parameter so the per-thread weight and accumulator arrays stay in registers.
//
// Plain CUDA C++, no TMA / wgmma.  float32 only; the wrapper
// (ops/mesh_kernels.py) checks shapes, dtypes and the shared-memory size.

#include <cuda_runtime.h>

#define TILE 8

struct MeshParams {
  int nx, ny, nz;
  int nodes, extent, ty_count;
  int n_tiles, cap, n_ch;
};

#define SPREAD_THREADS 256
#define SPREAD_Z_CHUNK 32  // z cells a block of kernel D takes
#define SPREAD_PEND 64  // per-warp list of the candidates that land in the block

// One (slot, z node) of kernel D: its N x N nodes into the block's (e, e, zn)
// field, dropped beyond the window; col is the node's z row of the field.
template <int N, bool DIPOLE>
__device__ __forceinline__ void spread_node_column(const float* __restrict__ ws,
                                                   const float* __restrict__ ds, float q0,
                                                   float q1, float q2, int c, int x0, int y0,
                                                   int e, int zn, float* col) {
  if (!DIPOLE) {
    const float wzq = ws[2 * N + c] * q0;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if (x0 + a >= e) continue;
      const float wxz = ws[a] * wzq;
#pragma unroll
      for (int b = 0; b < N; ++b) {
        if (y0 + b >= e) continue;
        atomicAdd(col + ((x0 + a) * e + y0 + b) * zn, wxz * ws[N + b]);
      }
    }
  } else {
    const float wz = ws[2 * N + c];
    const float al = q0 * wz, be = q1 * wz, ga = q2 * ds[2 * N + c];
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if (x0 + a >= e) continue;
      // node (a, b): w_y[b] (nu_x wz dw_x[a] + nu_z dwz w_x[a]) + dw_y[b] nu_y wz w_x[a]
      const float pa = al * ds[a] + ga * ws[a], qa = be * ws[a];
#pragma unroll
      for (int b = 0; b < N; ++b) {
        if (y0 + b >= e) continue;
        atomicAdd(col + ((x0 + a) * e + y0 + b) * zn, pa * ws[N + b] + qa * ds[N + b]);
      }
    }
  }
}

// Kernel D.  grid (T, C * z chunks).  Charges: q (T, C, K) with dw null;
// dipole form: nu = q (T, 3, K) with dw (T, K, 3, n) and C = 1.
template <int N, bool DIPOLE>
__global__ void __launch_bounds__(SPREAD_THREADS)
mesh_spread_kernel(const int* __restrict__ lx, const int* __restrict__ ly,
                   const int* __restrict__ sz, const float* __restrict__ w,
                   const float* __restrict__ dw, const float* __restrict__ q,
                   float* __restrict__ mesh, MeshParams p) {
  extern __shared__ float field[];  // (E, E, zn): the tile's window
  const int tile = blockIdx.x;
  const int n_chunks = (p.nz + SPREAD_Z_CHUNK - 1) / SPREAD_Z_CHUNK;
  const int ch = blockIdx.y / n_chunks;
  const int z0 = (blockIdx.y % n_chunks) * SPREAD_Z_CHUNK;
  const int zn = min(SPREAD_Z_CHUNK, p.nz - z0);
  const int e = p.extent, nz = p.nz, cap = p.cap;
  const int field_size = e * e * zn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* pend = reinterpret_cast<int*>(field + e * e * SPREAD_Z_CHUNK) + warp * SPREAD_PEND;
  for (int i = threadIdx.x; i < field_size; i += blockDim.x) field[i] = 0.0f;
  __syncthreads();

  const int tx = tile / p.ty_count, ty = tile % p.ty_count;
  // candidates (slot k, z node c).  A candidate whose z node lies outside
  // the chunk is dropped; the others go to the warp's list and run 32 at a
  // time, so that every lane of the atomic loops has a node column to add
  const int n_cand = cap * N;
  int npend = 0;
  auto run = [&](int n) {
    if (lane < n) {
      const int it = pend[lane];
      const int k = it / N, c = it - k * N;
      const size_t slot = (size_t)tile * cap + k;
      int z = sz[slot] + c;
      while (z >= nz) z -= nz;
      const float* ws = w + slot * 3 * N;
      const float* qs = DIPOLE ? q + (size_t)tile * 3 * cap + k
                               : q + ((size_t)tile * p.n_ch + ch) * cap + k;
      spread_node_column<N, DIPOLE>(ws, DIPOLE ? dw + slot * 3 * N : nullptr, qs[0],
                                    DIPOLE ? qs[cap] : 0.0f, DIPOLE ? qs[2 * cap] : 0.0f, c,
                                    lx[slot], ly[slot], e, zn, field + z - z0);
    }
  };
  for (int r0 = warp * 32; r0 < n_cand; r0 += blockDim.x) {
    const int it = r0 + lane;
    bool keep = false;
    if (it < n_cand) {
      const int k = it / N, c = it - k * N;
      const size_t slot = (size_t)tile * cap + k;
      int z = sz[slot] + c;
      while (z >= nz) z -= nz;
      // an empty slot has zero weights: nothing to add
      keep = z >= z0 && z < z0 + zn &&
             (w[slot * 3 * N + 2 * N + c] != 0.0f || (DIPOLE && dw[slot * 3 * N + 2 * N + c] != 0.0f));
    }
    const unsigned b = __ballot_sync(0xffffffffu, keep);
    if (keep) pend[npend + __popc(b & ((1u << lane) - 1u))] = it;
    npend += __popc(b);
    __syncwarp();
    if (npend >= 32) {
      run(32);
      const int moved = lane < npend - 32 ? pend[32 + lane] : 0;
      __syncwarp();
      if (lane < npend - 32) pend[lane] = moved;
      __syncwarp();
      npend -= 32;
    }
  }
  run(npend);
  __syncthreads();

  float* out = mesh + (size_t)ch * p.nx * p.ny * nz;
  // window cell (ex, ey) of tile (tx, ty) is mesh cell (tx*8 + ex, ty*8 + ey) mod the mesh
  for (int i = threadIdx.x; i < field_size; i += blockDim.x) {
    const float v = field[i];
    if (v == 0.0f) continue;
    const int z = i % zn;
    const int ey = (i / zn) % e;
    const int ex = i / (zn * e);
    const int gx = (tx * TILE + ex) % p.nx;
    const int gy = (ty * TILE + ey) % p.ny;
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

template <int N, bool DIPOLE>
static int launch_spread_as(const int* lx, const int* ly, const int* sz, const float* w,
                            const float* dw, const float* q, float* mesh, const MeshParams& p,
                            cudaStream_t stream) {
  // at most 14 x 14 x 32 floats and the lists: 27 KB, under the default 48 KB
  const size_t smem = (size_t)p.extent * p.extent * SPREAD_Z_CHUNK * sizeof(float) +
                      (SPREAD_THREADS / 32) * SPREAD_PEND * sizeof(int);
  const dim3 grid(p.n_tiles, p.n_ch * ((p.nz + SPREAD_Z_CHUNK - 1) / SPREAD_Z_CHUNK));
  mesh_spread_kernel<N, DIPOLE><<<grid, SPREAD_THREADS, smem, stream>>>(lx, ly, sz, w, dw, q,
                                                                        mesh, p);
  return (int)cudaGetLastError();
}

template <int N>
static int launch_spread(const int* lx, const int* ly, const int* sz, const float* w,
                         const float* dw, const float* q, float* mesh, const MeshParams& p,
                         cudaStream_t stream) {
  if (dw != nullptr && p.n_ch != 1) return (int)cudaErrorInvalidValue;
  if (dw != nullptr) return launch_spread_as<N, true>(lx, ly, sz, w, dw, q, mesh, p, stream);
  return launch_spread_as<N, false>(lx, ly, sz, w, dw, q, mesh, p, stream);
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

// Kernel D: q (T, C, K) -> mesh (C, nx, ny, nz), or with dw the dipole form
// nu (T, 3, K) -> mesh (1, nx, ny, nz), added into the mesh (zeroed by the
// caller).
int tpme_mesh_spread(const int* lx, const int* ly, const int* sz, const float* w, const float* dw,
                     const float* q, float* mesh, const MeshParams* p, void* stream) {
#define SPREAD_CALL(N) launch_spread<N>(lx, ly, sz, w, dw, q, mesh, *p, (cudaStream_t)stream)
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
