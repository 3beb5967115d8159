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
// E and F: each slot's n^3 window of the mesh (wrapping modulo the mesh) is
// contracted with its weights by one thread: E leaves nothing open (the
// per-slot value), F leaves one axis open at a time (the cotangent of each
// 1D weight).  One launch can produce both, which is what the backward of
// the spread wants; each slot has one writer, so no atomics.  A block takes
// one (tile, z chunk): it stages the tile's (E, E, zc + n - 1) window of
// every channel in shared memory with 16-byte asynchronous copies (neighbour
// slots share most of their window: the first kernel read it from L1/L2 once
// per slot, each lane at its own address), and owns the slots whose z start
// lies in its chunk.  The slots' weight rows come in, and F's cotangent rows
// go out, through shared memory in contiguous segments.  The z chunk
// (csrc/tpme_ops.cpp:gather_z_chunk) keeps the windows under 36 KB: 32
// cells at one channel, 1024 blocks at the 102k shapes.  Where the staged
// block does not fit shared memory (tens of channels, a capacity of
// thousands) one thread a slot reads its window from device memory.  The
// dipole form (dw given, one channel) contracts the three gradient stencils
// d_a[W_x W_y W_z] of each slot in one pass: E gives the three values, F the
// cotangents of the weights and of their derivatives of sum_a nu_a E_a, a
// third of the window reads of the charge form over every slot three times.
// The stencil size is a template parameter so the per-thread weight and
// accumulator arrays stay in registers.
//
// A batch of systems (torch.func.vmap over the per-atom calculators, which
// the TPU kernels got from pallas_call's batching rule) runs in one launch of
// each kernel: the system is the grid's z index (the flat grid of the
// one-thread-a-slot variant counts slots system-major), and each block
// offsets its pointers by its system's strides in MeshParams.  A single
// system is a batch of 1, the same blocks and the same arithmetic.
//
// Plain CUDA C++, no TMA / wgmma.  float32 only; the op (csrc/tpme_ops.cpp)
// checks shapes and dtypes.

#include <cuda_runtime.h>

#define TILE 8

struct MeshParams {
  int nx, ny, nz;
  int nodes, extent, ty_count;
  int n_tiles, cap, n_ch;
  int z_chunk;  // kernels E and F: z cells a block takes
  // a batch of systems in one launch: system s reads and writes its arrays
  // at s times these strides (in elements); a single system is n_sys 1
  int n_sys;
  long long slot_stride;  // lx, ly, sz: T K (the weights and their cotangents: 3 n of these)
  long long val_stride;   // q and vals: T C K (dipole form: T 3 K)
  long long mesh_stride;  // the mesh: C nx ny nz
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

// Kernel D.  grid (T, C * z chunks, systems).  Charges: q (T, C, K) with dw
// null; dipole form: nu = q (T, 3, K) with dw (T, K, 3, n) and C = 1; each
// system's arrays at its offsets (MeshParams).
template <int N, bool DIPOLE>
__global__ void __launch_bounds__(SPREAD_THREADS)
mesh_spread_kernel(const int* __restrict__ lx, const int* __restrict__ ly,
                   const int* __restrict__ sz, const float* __restrict__ w,
                   const float* __restrict__ dw, const float* __restrict__ q,
                   float* __restrict__ mesh, MeshParams p) {
  extern __shared__ float field[];  // (E, E, zn): the tile's window
  const long long sys = blockIdx.z;
  lx += sys * p.slot_stride;
  ly += sys * p.slot_stride;
  sz += sys * p.slot_stride;
  w += sys * p.slot_stride * 3 * N;
  if (DIPOLE) dw += sys * p.slot_stride * 3 * N;
  q += sys * p.val_stride;
  mesh += sys * p.mesh_stride;
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

// -- kernels E and F ------------------------------------------------------------

#define GATHER_THREADS 128

// floats a staged window column takes: the chunk and the stencil's reach,
// rounded up to whole 16-byte vectors
__host__ __device__ __forceinline__ int gather_row(int zc, int n) { return (zc + n - 1 + 3) & ~3; }

// ints of a warp's list of kernels E and F: 32 for each of its scan rounds
__host__ __device__ __forceinline__ int gather_list(int cap) {
  return (cap + GATHER_THREADS - 1) / GATHER_THREADS * 32;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most `pending` of this thread's committed copy groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// A slot's mesh window as staged by its block: (C, E, E, zs) floats in shared
// memory, z contiguous; node (a, b, c) of channel ch is col(ch, a, b)[z(c)].
struct StagedWindow {
  const float* field;
  int e, zs, ch_stride, base;  // base: (x0 e + y0) zs + the slot's z start in the chunk
  __device__ __forceinline__ const float* col(int ch, int a, int b) const {
    return field + ch * ch_stride + base + (a * e + b) * zs;
  }
  __device__ __forceinline__ int z(int c) const { return c; }
};

// The same window read from the periodic mesh in device memory.
template <int N>
struct MeshWindow {
  const float* mesh;
  size_t ch_stride;
  int ny, nz, gx0, gy0, nx;
  int zi[N];
  __device__ __forceinline__ const float* col(int ch, int a, int b) const {
    int gx = gx0 + a, gy = gy0 + b;
    gx = gx % nx;
    gy = gy % ny;
    return mesh + ch * ch_stride + ((size_t)gx * ny + gy) * nz;
  }
  __device__ __forceinline__ int z(int c) const { return zi[c]; }
};

// Kernels E and F for one slot: its stencil weights (and, in the dipole form,
// their derivatives) contracted with its window.  Charge form: per channel
// the value sum w_x w_y w_z F into vals[ch * stride] and, with WGRAD, the
// weight cotangent of S = sum_ch q_ch sum w_x w_y w_z F_ch into wg (3, N).
// Dipole form (one channel): the three values sum d_a[W_x W_y W_z] F into
// vals[a * stride] and, with WGRAD, the cotangents of w into wg and of dw
// into dwg of S = sum_a nu_a sum d_a[W_x W_y W_z] F, nu_a = q[a * stride].
// Nodes beyond the window in x or y are dropped.  A slot with all weights
// (and derivatives) zero is empty: every output is zero.
template <int N, bool DIPOLE, bool WGRAD, class Window>
__device__ __forceinline__ void contract_slot(const Window& win, int x0, int y0, int e,
                                              const float* ws, const float* ds,
                                              const float* __restrict__ qs, int stride, int n_ch,
                                              float* __restrict__ vals, float* wg, float* dwg) {
  float wx[N], wy[N], wz[N], dx[N], dy[N], dz[N];
  float wsum = 0.0f;
#pragma unroll
  for (int o = 0; o < N; ++o) {
    wx[o] = ws[o];
    wy[o] = ws[N + o];
    wz[o] = ws[2 * N + o];
    wsum += fabsf(wx[o]) + fabsf(wy[o]) + fabsf(wz[o]);
    if (DIPOLE) {
      dx[o] = ds[o];
      dy[o] = ds[N + o];
      dz[o] = ds[2 * N + o];
      wsum += fabsf(dx[o]) + fabsf(dy[o]) + fabsf(dz[o]);
    }
  }
  const int n_vals = DIPOLE ? 3 : n_ch;
  if (wsum == 0.0f) {
    if (vals != nullptr)
      for (int i = 0; i < n_vals; ++i) vals[i * stride] = 0.0f;
    if (WGRAD) {
#pragma unroll
      for (int o = 0; o < 3 * N; ++o) {
        wg[o] = 0.0f;
        if (DIPOLE) dwg[o] = 0.0f;
      }
    }
    return;
  }
  // cotangents: gw of the weights, gd of the derivatives (dipole form)
  float gwx[N], gwy[N], gwz[N], gdx[N], gdy[N], gdz[N];
#pragma unroll
  for (int o = 0; o < N; ++o) gwx[o] = gwy[o] = gwz[o] = gdx[o] = gdy[o] = gdz[o] = 0.0f;

  if (!DIPOLE) {
    for (int ch = 0; ch < n_ch; ++ch) {
      const float qv = WGRAD ? qs[ch * stride] : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < N; ++a) {
        if (x0 + a >= e) continue;
        float sa = 0.0f;  // sum_b wy[b] s_ab
        const float qa = wx[a] * qv;
#pragma unroll
        for (int b = 0; b < N; ++b) {
          if (y0 + b >= e) continue;
          const float* col = win.col(ch, a, b);
          float f[N];
#pragma unroll
          for (int c = 0; c < N; ++c) f[c] = col[win.z(c)];
          float s = 0.0f;  // sum_c wz[c] F
#pragma unroll
          for (int c = 0; c < N; ++c) s += wz[c] * f[c];
          sa += wy[b] * s;
          if (WGRAD) {
            const float t = qa * wy[b];
#pragma unroll
            for (int c = 0; c < N; ++c) gwz[c] += t * f[c];
            gwy[b] += qa * s;
          }
        }
        acc += wx[a] * sa;
        if (WGRAD) gwx[a] += qv * sa;
      }
      if (vals != nullptr) vals[ch * stride] = acc;
    }
  } else {
    const float nux = WGRAD ? qs[0] : 0.0f;
    const float nuy = WGRAD ? qs[stride] : 0.0f;
    const float nuz = WGRAD ? qs[2 * stride] : 0.0f;
    float ex = 0.0f, ey = 0.0f, ez = 0.0f;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if (x0 + a >= e) continue;
      // over b: sum wy s, sum dwy s, sum wy sd
      float sw = 0.0f, sdy = 0.0f, sdz = 0.0f;
      const float cxa = nux * dx[a], cya = nuy * wx[a], cza = nuz * wx[a];
#pragma unroll
      for (int b = 0; b < N; ++b) {
        if (y0 + b >= e) continue;
        const float* col = win.col(0, a, b);
        float f[N];
#pragma unroll
        for (int c = 0; c < N; ++c) f[c] = col[win.z(c)];
        float s = 0.0f, sd = 0.0f;  // sum_c wz[c] F, sum_c dwz[c] F
#pragma unroll
        for (int c = 0; c < N; ++c) {
          s += wz[c] * f[c];
          sd += dz[c] * f[c];
        }
        sw += wy[b] * s;
        sdy += dy[b] * s;
        sdz += wy[b] * sd;
        if (WGRAD) {
          const float cw = cxa * wy[b] + cya * dy[b], cd = cza * wy[b];
#pragma unroll
          for (int c = 0; c < N; ++c) {
            gwz[c] += cw * f[c];
            gdz[c] += cd * f[c];
          }
          gwy[b] += cxa * s + cza * sd;
          gdy[b] += cya * s;
        }
      }
      ex += dx[a] * sw;
      ey += wx[a] * sdy;
      ez += wx[a] * sdz;
      if (WGRAD) {
        gwx[a] = nuy * sdy + nuz * sdz;
        gdx[a] = nux * sw;
      }
    }
    if (vals != nullptr) {
      vals[0] = ex;
      vals[stride] = ey;
      vals[2 * stride] = ez;
    }
  }
  if (WGRAD) {
#pragma unroll
    for (int o = 0; o < N; ++o) {
      wg[o] = gwx[o];
      wg[N + o] = gwy[o];
      wg[2 * N + o] = gwz[o];
      if (DIPOLE) {
        dwg[o] = gdx[o];
        dwg[N + o] = gdy[o];
        dwg[2 * N + o] = gdz[o];
      }
    }
  }
}

// Kernels E and F, staged.  grid (T, z chunks, systems; each system's arrays
// at its offsets, MeshParams): the block stages its tile's
// z starts and its (E, E, zn + N - 1) window of every channel, wrapping
// modulo the mesh, with asynchronous copies (16 bytes a lane where the mesh
// and the slot arrays allow it), and contracts the slots whose z start lies
// in its chunk, one thread a slot (each slot has one owner: no atomics, the
// same sums in the same order on every launch).  Each warp lists the slots
// of its chunk among its share of the tile's and runs them 32 at a time; a
// run loads its slots' weight rows, and stores their weight cotangents,
// through shared memory in contiguous segments, and the first run's rows
// are fetched while the window is in flight.
template <int N, bool DIPOLE, bool WGRAD>
__global__ void __launch_bounds__(GATHER_THREADS)
mesh_gather_wgrad_kernel(const int* __restrict__ lx, const int* __restrict__ ly,
                         const int* __restrict__ sz, const float* __restrict__ w,
                         const float* __restrict__ dw, const float* __restrict__ q,
                         const float* __restrict__ mesh, float* __restrict__ vals,
                         float* __restrict__ wg, float* __restrict__ dwg, MeshParams p) {
  const long long sys = blockIdx.z;
  lx += sys * p.slot_stride;
  ly += sys * p.slot_stride;
  sz += sys * p.slot_stride;
  w += sys * p.slot_stride * 3 * N;
  if (DIPOLE) dw += sys * p.slot_stride * 3 * N;
  if (WGRAD) {
    q += sys * p.val_stride;
    wg += sys * p.slot_stride * 3 * N;
    if (DIPOLE) dwg += sys * p.slot_stride * 3 * N;
  }
  if (vals != nullptr) vals += sys * p.val_stride;
  mesh += sys * p.mesh_stride;
  constexpr int E = TILE + N - 1;
  constexpr int ROW = 3 * N, STRIDE = 3 * N + 1;  // a slot's weights; its shared row
  constexpr int N_ROWS = DIPOLE ? 2 : 1;           // weights (and derivatives)
  extern __shared__ float field[];  // (C, E, E, zs), then the slot data below
  const int tile = blockIdx.x;
  const int zc = p.z_chunk, z0 = blockIdx.y * zc, nz = p.nz;
  const int zn = min(zc, nz - z0), zlen = zn + N - 1;
  const int zs = gather_row(zc, N), n_ch = p.n_ch, ch_stride = E * E * zs, cap = p.cap;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int tx = tile / p.ty_count, ty = tile % p.ty_count;
  const int list_cap = gather_list(cap);
  int* s_sz = reinterpret_cast<int*>(field + n_ch * ch_stride);
  int* list = s_sz + cap + warp * list_cap;
  float* rows = reinterpret_cast<float*>(s_sz + cap + n_warps * list_cap) +
                warp * 32 * STRIDE * N_ROWS;
  const size_t slot0 = (size_t)tile * cap;

  // the tile's z starts: one copy group
  if (cap % 4 == 0 && (reinterpret_cast<size_t>(sz) & 15) == 0) {
    for (int k = 4 * threadIdx.x; k < cap; k += 4 * blockDim.x)
      cp_async16(s_sz + k, sz + slot0 + k);
  } else {
    for (int k = threadIdx.x; k < cap; k += blockDim.x)
      cp_async4(reinterpret_cast<float*>(s_sz + k), reinterpret_cast<const float*>(sz + slot0 + k));
  }
  cp_async_commit();

  // the windows, another: window column (ex, ey) of tile (tx, ty) is mesh
  // column (tx*8 + ex, ty*8 + ey) mod the mesh
  const int n_cols = n_ch * E * E;
  auto column = [&](int col) {
    const int c = col / (E * E), ex = col / E % E, ey = col % E;
    int gx = tx * TILE + ex, gy = ty * TILE + ey;
    while (gx >= p.nx) gx -= p.nx;
    while (gy >= p.ny) gy -= p.ny;
    return mesh + (((size_t)c * p.nx + gx) * p.ny + gy) * nz;
  };
  if (nz % 4 == 0 && zc % 4 == 0 && (reinterpret_cast<size_t>(mesh) & 15) == 0) {
    // 16 bytes a lane: zs / 4 vectors a column, a warp step over as many
    // whole columns as its lanes cover; z0 and nz are multiples of 4, so no
    // vector straddles the wrap
    const int vecs = zs / 4, per_step = max(32 / vecs, 1);
    const int lane_col = vecs <= 32 ? lane / vecs : 0;
    for (int col0 = warp * per_step; col0 < n_cols; col0 += n_warps * per_step) {
      const int col = col0 + lane_col;
      if (lane_col >= per_step || col >= n_cols) continue;
      const float* src = column(col);
      for (int v = vecs <= 32 ? lane % vecs : lane; v < vecs; v += 32) {
        int gz = z0 + 4 * v;
        while (gz >= nz) gz -= nz;
        cp_async16(field + col * zs + 4 * v, src + gz);
      }
    }
  } else {
    for (int col = warp; col < n_cols; col += n_warps) {
      const float* src = column(col);
      for (int zz = lane; zz < zlen; zz += 32) {
        int gz = z0 + zz;
        while (gz >= nz) gz -= nz;
        cp_async4(field + col * zs + zz, src + gz);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<1>();  // the z starts
  __syncthreads();

  // the warp's list: the slots of its share whose z start lies in the chunk
  int n_list = 0;
  for (int r0 = warp * 32; r0 < cap; r0 += blockDim.x) {
    const int k = r0 + lane;
    const bool keep = k < cap && s_sz[k] >= z0 && s_sz[k] < z0 + zn;
    const unsigned b = __ballot_sync(0xffffffffu, keep);
    if (keep) list[n_list + __popc(b & ((1u << lane) - 1u))] = k;
    n_list += __popc(b);
  }
  __syncwarp();

  // a run's weight (and derivative) rows: each lane fetches ROW of the
  // run's n * ROW floats of each into registers, then puts them in the
  // rows; and the x, y starts of its own slot
  const int nq = DIPOLE ? 3 : n_ch;  // rows of q and vals per tile
  float pre[ROW * N_ROWS];
  int x0 = 0, y0 = 0;
  auto fetch = [&](const int* run, int n) {
    if (lane < n) {
      x0 = lx[slot0 + run[lane]];
      y0 = ly[slot0 + run[lane]];
    }
#pragma unroll
    for (int j = 0; j < ROW; ++j) {
      const int e = lane + 32 * j;
      if (e < n * ROW) {
        const int r = e / ROW;
        const size_t at = (slot0 + run[r]) * ROW + e - r * ROW;
        pre[j] = w[at];
        if (DIPOLE) pre[ROW * (N_ROWS - 1) + j] = dw[at];
      }
    }
  };
  auto put = [&](int n) {
#pragma unroll
    for (int j = 0; j < ROW; ++j) {
      const int e = lane + 32 * j;
      if (e < n * ROW) {
        const int r = e / ROW, c = e - r * ROW;
        rows[r * STRIDE + c] = pre[j];
        if (DIPOLE) rows[(32 + r) * STRIDE + c] = pre[ROW * (N_ROWS - 1) + j];
      }
    }
    __syncwarp();
  };
  if (n_list > 0) fetch(list, min(n_list, 32));
  cp_async_wait<0>();  // the windows
  __syncthreads();

  float* own = rows + lane * STRIDE;
  for (int r0 = 0; r0 < n_list; r0 += 32) {
    const int* run = list + r0;
    const int n = min(32, n_list - r0);
    if (r0 > 0) fetch(run, n);
    put(n);
    if (lane < n) {
      const int k = run[lane];
      const StagedWindow win{field, E, zs, ch_stride, (x0 * E + y0) * zs + s_sz[k] - z0};
      const size_t row = (size_t)tile * nq * cap + k;
      // reads its rows first; its weight cotangents then overwrite them
      contract_slot<N, DIPOLE, WGRAD>(win, x0, y0, E, own, own + 32 * STRIDE,
                                      WGRAD ? q + row : nullptr, cap, n_ch,
                                      vals != nullptr ? vals + row : nullptr, own,
                                      own + 32 * STRIDE);
    }
    __syncwarp();
    if (WGRAD) {
      for (int e = lane; e < n * ROW; e += 32) {
        const int r = e / ROW, c = e - r * ROW;
        const size_t at = (slot0 + run[r]) * ROW + c;
        wg[at] = rows[r * STRIDE + c];
        if (DIPOLE) dwg[at] = rows[(32 + r) * STRIDE + c];
      }
      __syncwarp();
    }
  }
}

// Kernels E and F, one thread a slot reading its window from the mesh in
// device memory: where the staged block does not fit shared memory (many
// channels, a large capacity), or z_chunk 0.  The flat grid covers the slots
// of every system, system-major.
template <int N, bool DIPOLE, bool WGRAD>
__global__ void mesh_gather_wgrad_direct_kernel(
    const int* __restrict__ lx, const int* __restrict__ ly, const int* __restrict__ sz,
    const float* __restrict__ w, const float* __restrict__ dw, const float* __restrict__ q,
    const float* __restrict__ mesh, float* __restrict__ vals, float* __restrict__ wg,
    float* __restrict__ dwg, MeshParams p) {
  const size_t n_slots = (size_t)p.n_tiles * p.cap;
  const size_t flat = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (flat >= n_slots * p.n_sys) return;
  const long long sys = (long long)(flat / n_slots);
  const size_t slot = flat - (size_t)sys * n_slots;
  lx += sys * p.slot_stride;
  ly += sys * p.slot_stride;
  sz += sys * p.slot_stride;
  w += sys * p.slot_stride * 3 * N;
  if (DIPOLE) dw += sys * p.slot_stride * 3 * N;
  if (WGRAD) {
    q += sys * p.val_stride;
    wg += sys * p.slot_stride * 3 * N;
    if (DIPOLE) dwg += sys * p.slot_stride * 3 * N;
  }
  if (vals != nullptr) vals += sys * p.val_stride;
  mesh += sys * p.mesh_stride;
  const int tile = (int)(slot / p.cap), k = (int)(slot % p.cap);
  const int x0 = lx[slot], y0 = ly[slot];
  MeshWindow<N> win;
  win.mesh = mesh;
  win.ch_stride = (size_t)p.nx * p.ny * p.nz;
  win.nx = p.nx;
  win.ny = p.ny;
  win.nz = p.nz;
  win.gx0 = tile / p.ty_count * TILE + x0;
  win.gy0 = tile % p.ty_count * TILE + y0;
#pragma unroll
  for (int c = 0; c < N; ++c) win.zi[c] = (sz[slot] + c) % p.nz;
  const int nq = DIPOLE ? 3 : p.n_ch;
  const size_t row = (size_t)tile * nq * p.cap + k;
  contract_slot<N, DIPOLE, WGRAD>(
      win, x0, y0, p.extent, w + slot * 3 * N, DIPOLE ? dw + slot * 3 * N : nullptr,
      WGRAD ? q + row : nullptr, p.cap, p.n_ch, vals != nullptr ? vals + row : nullptr,
      WGRAD ? wg + slot * 3 * N : nullptr, DIPOLE && WGRAD ? dwg + slot * 3 * N : nullptr);
}

template <int N, bool DIPOLE>
static int launch_spread_as(const int* lx, const int* ly, const int* sz, const float* w,
                            const float* dw, const float* q, float* mesh, const MeshParams& p,
                            cudaStream_t stream) {
  // at most 14 x 14 x 32 floats and the lists: 27 KB, under the default 48 KB
  const size_t smem = (size_t)p.extent * p.extent * SPREAD_Z_CHUNK * sizeof(float) +
                      (SPREAD_THREADS / 32) * SPREAD_PEND * sizeof(int);
  const dim3 grid(p.n_tiles, p.n_ch * ((p.nz + SPREAD_Z_CHUNK - 1) / SPREAD_Z_CHUNK), p.n_sys);
  mesh_spread_kernel<N, DIPOLE><<<grid, SPREAD_THREADS, smem, stream>>>(lx, ly, sz, w, dw, q,
                                                                        mesh, p);
  return (int)cudaGetLastError();
}

template <int N>
static int launch_spread(const int* lx, const int* ly, const int* sz, const float* w,
                         const float* dw, const float* q, float* mesh, const MeshParams& p,
                         cudaStream_t stream) {
  if constexpr (N < 3) {
    if (dw != nullptr) return (int)cudaErrorInvalidValue;
  } else {
    if (dw != nullptr && p.n_ch != 1) return (int)cudaErrorInvalidValue;
    if (dw != nullptr) return launch_spread_as<N, true>(lx, ly, sz, w, dw, q, mesh, p, stream);
  }
  return launch_spread_as<N, false>(lx, ly, sz, w, dw, q, mesh, p, stream);
}

template <int N, bool DIPOLE, bool WGRAD>
static int launch_gather_as(const int* lx, const int* ly, const int* sz, const float* w,
                            const float* dw, const float* q, const float* mesh, float* vals,
                            float* wg, float* dwg, MeshParams p, cudaStream_t stream) {
  constexpr int E = TILE + N - 1;
  // the windows, the tile's z starts, the lists, the weight rows of a run
  auto smem = [&](int zc) {
    return ((size_t)p.n_ch * E * E * gather_row(zc, N) + (size_t)p.cap +
            (GATHER_THREADS / 32) * (gather_list(p.cap) + 32 * (3 * N + 1) * (DIPOLE ? 2 : 1))) *
           sizeof(float);
  };
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  int zc = min(p.z_chunk, p.nz);
  while (zc > 1 && smem(zc) > (size_t)optin) zc = (zc + 1) / 2;
  if (zc == 0 || smem(zc) > (size_t)optin) {
    // one thread a slot, the window read from the mesh in device memory
    const size_t n_slots = (size_t)p.n_tiles * p.cap * p.n_sys;
    const unsigned blocks = (unsigned)((n_slots + GATHER_THREADS - 1) / GATHER_THREADS);
    mesh_gather_wgrad_direct_kernel<N, DIPOLE, WGRAD><<<blocks, GATHER_THREADS, 0, stream>>>(
        lx, ly, sz, w, dw, q, mesh, vals, wg, dwg, p);
    return (int)cudaGetLastError();
  }
  p.z_chunk = zc;
  static int granted = 48 * 1024;  // the largest dynamic shared memory asked for so far
  if ((int)smem(zc) > granted) {
    if (cudaFuncSetAttribute(mesh_gather_wgrad_kernel<N, DIPOLE, WGRAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem(zc)) !=
        cudaSuccess)
      return (int)cudaGetLastError();
    granted = (int)smem(zc);
  }
  const dim3 grid(p.n_tiles, (p.nz + zc - 1) / zc, p.n_sys);
  mesh_gather_wgrad_kernel<N, DIPOLE, WGRAD><<<grid, GATHER_THREADS, smem(zc), stream>>>(
      lx, ly, sz, w, dw, q, mesh, vals, wg, dwg, p);
  return (int)cudaGetLastError();
}

template <int N>
static int launch_gather_wgrad(const int* lx, const int* ly, const int* sz, const float* w,
                               const float* dw, const float* q, const float* mesh, float* vals,
                               float* wg, float* dwg, const MeshParams& p, cudaStream_t stream) {
  if constexpr (N < 3) {
    if (dw != nullptr) return (int)cudaErrorInvalidValue;
  } else if (dw != nullptr) {
    if (p.n_ch != 1 || (wg != nullptr && dwg == nullptr)) return (int)cudaErrorInvalidValue;
    if (wg != nullptr)
      return launch_gather_as<N, true, true>(lx, ly, sz, w, dw, q, mesh, vals, wg, dwg, p, stream);
    return launch_gather_as<N, true, false>(lx, ly, sz, w, dw, q, mesh, vals, wg, dwg, p, stream);
  }
  if (wg != nullptr)
    return launch_gather_as<N, false, true>(lx, ly, sz, w, dw, q, mesh, vals, wg, dwg, p, stream);
  return launch_gather_as<N, false, false>(lx, ly, sz, w, dw, q, mesh, vals, wg, dwg, p, stream);
}

// the stencil sizes of the P3M tables (1 to 5 nodes) and of the Lagrange
// tables (3 to 7); the dipole forms only at 3 to 7 (the dipolar mesh is
// Lagrange-only)
#define DISPATCH_NODES(CALL)            \
  switch (p->nodes) {                   \
    case 1: return CALL(1);             \
    case 2: return CALL(2);             \
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
// caller); p->n_sys systems in one launch, at the strides of p.
int tpme_mesh_spread(const int* lx, const int* ly, const int* sz, const float* w, const float* dw,
                     const float* q, float* mesh, const MeshParams* p, void* stream) {
  if (p->n_sys < 1 || p->n_sys > 65535) return (int)cudaErrorInvalidValue;
#define SPREAD_CALL(N) launch_spread<N>(lx, ly, sz, w, dw, q, mesh, *p, (cudaStream_t)stream)
  DISPATCH_NODES(SPREAD_CALL)
#undef SPREAD_CALL
}

// Kernels E and/or F: vals (T, C, K) unless null; wg (T, K, 3, n) from
// q (T, C, K) unless wg is null.  With dw (T, K, 3, n) the dipole form (one
// channel): vals (T, 3, K), and from nu = q (T, 3, K) the cotangents wg of w
// and dwg of dw.  p->z_chunk: the z cells a block takes (halved until the
// staged windows fit shared memory).  p->n_sys systems in one launch, at the
// strides of p.
int tpme_mesh_gather_wgrad(const int* lx, const int* ly, const int* sz, const float* w,
                           const float* dw, const float* q, const float* mesh, float* vals,
                           float* wg, float* dwg, const MeshParams* p, void* stream) {
  if (p->n_sys < 1 || p->n_sys > 65535) return (int)cudaErrorInvalidValue;
  if (vals == nullptr && wg == nullptr) return (int)cudaErrorInvalidValue;
  if (wg != nullptr && q == nullptr) return (int)cudaErrorInvalidValue;
#define GATHER_CALL(N) \
  launch_gather_wgrad<N>(lx, ly, sz, w, dw, q, mesh, vals, wg, dwg, *p, (cudaStream_t)stream)
  DISPATCH_NODES(GATHER_CALL)
#undef GATHER_CALL
}

}  // extern "C"
