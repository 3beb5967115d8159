// The tpme:: operator library: kernels A-G as PyTorch operators registered in
// C++, so that a process with libtorch alone (no Python of this package) runs
// a program that calls them, e.g. an exported MD step (deploy.py).
//
// This is host code only: it checks each op's operands, builds the kernel's
// parameter struct, allocates the outputs, launches the kernel through the
// plain C interface of csrc/*.cu on PyTorch's current stream and counts the
// launch.  TORCH_LIBRARY defines the ops from the schemas of tpme_ops.h (the
// Python side defines the same ones from there where no library is loaded);
// TORCH_LIBRARY_IMPL gives their Meta kernels (output shapes, for fake-tensor
// tracing and torch.export) and, built with TPME_WITH_CUDA, their CUDA kernels.
// The plain versions (CPU), the autograd and the vmap rules are registered
// onto these ops from Python (ops/*.py).
//
// Built without TPME_WITH_CUDA (no CUDA headers) the file holds the schemas,
// the Meta kernels and the parameter builders, which extern "C" functions
// expose so that a CPU test can hold them byte for byte against the plain
// versions' constants.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/zeros.h>
#include <c10/util/Exception.h>
#include <torch/library.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <optional>
#include <sstream>
#include <string>
#include <tuple>
#include <vector>

namespace {

constexpr int TILE = 8;
constexpr int MAX_NODES = 8;     // csrc/spread.cu: coefficient table rows/cols
constexpr int N_OFFSETS = 14;    // csrc/window.cu, window_dipole.cu: half-window offsets + self
constexpr int MAX_CHANNELS = 4;  // csrc/window.cu: per-thread charge-channel registers
constexpr int MAX_MEMBERS = 4;   // csrc/window.cu: pair terms of a combined potential
// csrc/window.cu: the accumulator rows (energy, 14 x 3 d_offs sums, a block
// counter), then the members' energies, then the 3 x 3 image term
constexpr int WINDOW_MEMBER_ROW = 2 + 3 * N_OFFSETS;
constexpr int WINDOW_IMAGE_ROW = WINDOW_MEMBER_ROW + MAX_MEMBERS;
constexpr int64_t MAX_SYSTEMS = 65535;  // csrc/mesh.cu: the grid's z extent

// Mirrors of the parameter structs of csrc/*.cu.
struct SpreadParams {
  int nx, ny, nz;
  int nodes, extent, lpad, ty_count;
  int n_tiles, kp, n_ch;
  int z_cells, z_chunk;
  int bwd_z_chunk;
  float coeff[MAX_NODES * MAX_NODES];
  float deriv[MAX_NODES * MAX_NODES];
};

struct WindowMember {
  int p;
  float alpha, alpha_sq, prefactor, c_gauss;
};

struct WindowParams {
  int nx, ny, nz, cap, n_ch, self_k;
  int group;
  int direct;
  int kind;
  int n_members;
  float cutoff_sq;
  WindowMember members[MAX_MEMBERS];
  int offsets[3 * N_OFFSETS];
};

struct WindowDipoleParams {
  int nx, ny, nz, cap, self_k, direct;
  int warps;
  float cutoff_sq, alpha, sqrt_alpha, prefactor, c_gauss;
  int offsets[3 * N_OFFSETS];
};

struct MeshParams {
  int nx, ny, nz;
  int nodes, extent, ty_count;
  int n_tiles, cap, n_ch;
  int z_chunk;
  int n_sys;
  long long slot_stride;
  long long val_stride;
  long long mesh_stride;
};

static_assert(sizeof(SpreadParams) == 564, "SpreadParams layout");
static_assert(sizeof(WindowParams) == 292, "WindowParams layout");
static_assert(sizeof(WindowDipoleParams) == 216, "WindowDipoleParams layout");
static_assert(sizeof(MeshParams) == 72, "MeshParams layout");

// -- launch counters: one per kernel, kernel C's split variant apart ----------

enum Counter {
#define TPME_OP(name, schema)
#define TPME_COUNTER(name) COUNT_##name,
#include "tpme_ops.h"
#undef TPME_COUNTER
#undef TPME_OP
  N_COUNTERS
};

std::atomic<int64_t> g_counts[N_COUNTERS];

void count(Counter c) { g_counts[c].fetch_add(1, std::memory_order_relaxed); }

std::vector<int64_t> launch_counts() {
  std::vector<int64_t> out(N_COUNTERS);
  for (int i = 0; i < N_COUNTERS; ++i) out[i] = g_counts[i].load(std::memory_order_relaxed);
  return out;
}

void reset_launch_counts() {
  for (auto& c : g_counts) c.store(0, std::memory_order_relaxed);
}

// -- z-chunk rules, and their overrides for sweeps and tests -----------------

enum ChunkKernel { CHUNK_SPREAD_FWD, CHUNK_SPREAD_BWD, CHUNK_MESH_GATHER, N_CHUNK_KERNELS };
std::atomic<int64_t> g_chunk_override[N_CHUNK_KERNELS] = {{-1}, {-1}, {-1}};

int64_t override_z_chunk(c10::string_view kernel, int64_t z_chunk) {
  int which = 0;
  if (kernel == "spread_fwd") which = CHUNK_SPREAD_FWD;
  else if (kernel == "spread_bwd") which = CHUNK_SPREAD_BWD;
  else if (kernel == "mesh_gather") which = CHUNK_MESH_GATHER;
  else TORCH_CHECK_VALUE(false, "no z chunk to override for '", kernel,
                         "': spread_fwd, spread_bwd or mesh_gather");
  return g_chunk_override[which].exchange(z_chunk < 0 ? -1 : z_chunk);
}

int64_t chunk_or(ChunkKernel which, int64_t rule) {
  const int64_t v = g_chunk_override[which].load();
  return v < 0 ? rule : v;
}

// Mesh z cells that one block of kernel A owns: nz split into
// max(2, ceil(nz / 128)) chunks (the last may be short).
int64_t spread_z_chunk(int64_t nz) {
  const int64_t n_chunks = std::max<int64_t>(2, (nz + 127) / 128);
  return (nz + n_chunks - 1) / n_chunks;
}

// Mesh z cells that one block of kernel B stages: 64 where the windows of all
// channels, (extent, extent, zc + nodes - 1) rounded to whole 16-byte
// vectors, take at most 64 KB of shared memory, 32 otherwise (0: one thread a
// slot, which the launcher also takes where no block fits).
int64_t spread_bwd_z_chunk(int64_t nodes, int64_t extent, int64_t n_ch) {
  const int64_t row = (64 + nodes - 1 + 3) / 4 * 4;
  return n_ch * extent * extent * row * 4 <= 64 * 1024 ? 64 : 32;
}

// Z cells a block of kernels E and F stages: 32, halved while the staged
// windows of all channels take more than 36 KB of shared memory.
int64_t gather_z_chunk(int64_t nodes, int64_t n_ch) {
  const int64_t extent = TILE + nodes - 1;
  int64_t zc = 32;
  while (zc > 4 && n_ch * extent * extent * ((zc + nodes + 2) / 4) * 16 > 36 * 1024) zc /= 2;
  return zc;
}

// -- messages as the Python side words them -----------------------------------

std::string tuple_str(c10::IntArrayRef v) {
  std::ostringstream s;
  s << "(";
  for (size_t i = 0; i < v.size(); ++i) s << (i ? ", " : "") << v[i];
  s << (v.size() == 1 ? ",)" : ")");
  return s.str();
}

std::string dtype_str(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return "torch.float32";
    case at::kDouble: return "torch.float64";
    case at::kHalf: return "torch.float16";
    case at::kBFloat16: return "torch.bfloat16";
    case at::kInt: return "torch.int32";
    case at::kLong: return "torch.int64";
    case at::kShort: return "torch.int16";
    case at::kChar: return "torch.int8";
    case at::kByte: return "torch.uint8";
    case at::kBool: return "torch.bool";
    default: return std::string("torch.") + c10::toString(t);
  }
}

// A kernel operand: of `dtype`, on a CUDA device, of `shape`, contiguous.
void check_cuda_tensor(const at::Tensor& t, const char* name, c10::IntArrayRef shape,
                       at::ScalarType dtype = at::kFloat) {
  TORCH_CHECK_TYPE(t.scalar_type() == dtype, name, " is ", dtype_str(t.scalar_type()),
                   "; the CUDA kernels take ", dtype_str(dtype), " only");
  TORCH_CHECK_VALUE(t.is_cuda(), name, " must be a CUDA tensor, got ", t.device());
  TORCH_CHECK_VALUE(t.sizes() == shape, name, " has shape ", tuple_str(t.sizes()), ", expected ",
                    tuple_str(shape));
  TORCH_CHECK_VALUE(t.is_contiguous(), name, " must be contiguous");
}

std::vector<int64_t> cat(c10::IntArrayRef a, std::initializer_list<int64_t> b) {
  std::vector<int64_t> out(a.begin(), a.end());
  out.insert(out.end(), b);
  return out;
}

// -- kernels A and B: the spread geometry and its parameters ------------------

struct SpreadGeometry {
  int64_t nx, ny, nz, nodes, extent, lpad, n_tiles, slots, z_cells;
  int64_t ty_count() const { return ny / TILE; }
};

SpreadGeometry spread_geometry(c10::IntArrayRef g) {
  TORCH_CHECK_VALUE(g.size() == 9,
                    "geometry is [nx, ny, nz, nodes, extent, lpad, n_tiles, slots_per_tile, "
                    "z_cells], got ", g.size(), " entries");
  return {g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[8]};
}

// Weight polynomials of ops/mesh.py:_weight_coefficients, rows = stencil node,
// cols = ascending powers: integer numerators over one denominator.
struct CoeffTable {
  int nodes;
  int denominator;
  int num[7][7];
};

const CoeffTable P3M_TABLES[] = {
    {1, 1, {{1}}},
    {2, 2, {{1, -2}, {1, 2}}},
    {3, 8, {{1, -4, 4}, {6, 0, -8}, {1, 4, 4}}},
    {4, 48, {{1, -6, 12, -8}, {23, -30, -12, 24}, {23, 30, -12, -24}, {1, 6, 12, 8}}},
    {5, 384,
     {{1, -8, 24, -32, 16},
      {76, -176, 96, 64, -64},
      {230, 0, -240, 0, 96},
      {76, 176, 96, -64, -64},
      {1, 8, 24, 32, 16}}},
};

const CoeffTable LAGRANGE_TABLES[] = {
    {3, 2, {{0, -1, 1}, {2, 0, -2}, {0, 1, 1}}},
    {4, 48, {{-3, 2, 12, -8}, {27, -54, -12, 24}, {27, 54, -12, -24}, {-3, -2, 12, 8}}},
    {5, 24,
     {{0, 2, -1, -2, 1},
      {0, -16, 16, 4, -4},
      {24, 0, -30, 0, 6},
      {0, 16, 16, -4, -4},
      {0, -2, -1, 2, 1}}},
    {6, 3840,
     {{45, -18, -200, 80, 80, -32},
      {-375, 250, 1560, -1040, -240, 160},
      {2250, -4500, -1360, 2720, 160, -320},
      {2250, 4500, -1360, -2720, 160, 320},
      {-375, -250, 1560, 1040, -240, -160},
      {45, 18, -200, -80, 80, 32}}},
    {7, 720,
     {{0, -12, 4, 15, -5, -3, 1},
      {0, 108, -54, -120, 60, 12, -6},
      {0, -540, 540, 195, -195, -15, 15},
      {720, 0, -980, 0, 280, 0, -20},
      {0, 540, 540, -195, -195, 15, 15},
      {0, -108, -54, 120, 60, -12, -6},
      {0, 12, 4, -15, -5, 3, 1}}},
};

const CoeffTable& coefficient_table(c10::string_view method, int64_t nodes) {
  if (method == "P3M") {
    for (const auto& t : P3M_TABLES)
      if (t.nodes == nodes) return t;
    TORCH_CHECK_VALUE(false, "`interpolation_nodes` is ", nodes,
                      " but only values from 1 to 5 for method 'P3M' are allowed");
  }
  if (method == "Lagrange") {
    for (const auto& t : LAGRANGE_TABLES)
      if (t.nodes == nodes) return t;
    TORCH_CHECK_VALUE(false, "`interpolation_nodes` is ", nodes,
                      " but only values from 3 to 7 for method 'Lagrange' are allowed");
  }
  TORCH_CHECK_VALUE(false, "method '", method,
                    "' is not supported. Choose from 'Lagrange' or 'P3M'");
}

SpreadParams spread_params(const SpreadGeometry& g, c10::string_view method, int64_t n_ch) {
  TORCH_CHECK_VALUE(g.nodes <= MAX_NODES, "the spread kernels take at most ", MAX_NODES,
                    " nodes");
  const CoeffTable& table = coefficient_table(method, g.nodes);
  SpreadParams p;
  std::memset(&p, 0, sizeof p);
  p.nx = (int)g.nx;
  p.ny = (int)g.ny;
  p.nz = (int)g.nz;
  p.nodes = (int)g.nodes;
  p.extent = (int)g.extent;
  p.lpad = (int)g.lpad;
  p.ty_count = (int)g.ty_count();
  p.n_tiles = (int)g.n_tiles;
  p.kp = (int)g.slots;
  p.n_ch = (int)n_ch;
  p.z_cells = (int)g.z_cells;
  p.z_chunk = (int)chunk_or(CHUNK_SPREAD_FWD, spread_z_chunk(g.nz));
  p.bwd_z_chunk = (int)chunk_or(CHUNK_SPREAD_BWD, spread_bwd_z_chunk(g.nodes, g.extent, n_ch));
  // float64 coefficients (numerator / denominator) and their derivatives
  // (m c_m), each rounded once to float, as the plain version's tables
  for (int o = 0; o < g.nodes; ++o) {
    for (int m = 0; m < g.nodes; ++m) {
      const double c = (double)table.num[o][m] / (double)table.denominator;
      p.coeff[o * MAX_NODES + m] = (float)c;
      if (m > 0) p.deriv[o * MAX_NODES + m - 1] = (float)(c * (double)m);
    }
  }
  return p;
}

// -- kernel C: the pair-term table and its parameters -------------------------

// CPython's math.gamma(p / 2) for p = 1..6 (its own Lanczos sum, which is not
// libm's tgamma at p = 1 and 5): ops/math.py:power_law_c_gauss divides by it.
const double GAMMA_HALF[7] = {0.0,
                              0x1.c5bf891b4ef6ap+0,
                              0x1.0000000000000p+0,
                              0x1.c5bf891b4ef6bp-1,
                              0x1.0000000000000p+0,
                              0x1.544fa6d47b391p+0,
                              0x1.0000000000000p+1};

// The half window (ops/rspace_cells.py:_window_offsets): the offsets after
// (0, 0, 0) in lexicographic order, then the self cell.
void window_offsets(int* out) {
  int k = 0;
  for (int dx = -1; dx <= 1; ++dx)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dz = -1; dz <= 1; ++dz)
        if (dx > 0 || (dx == 0 && (dy > 0 || (dy == 0 && dz > 0)))) {
          out[3 * k] = dx;
          out[3 * k + 1] = dy;
          out[3 * k + 2] = dz;
          ++k;
        }
  out[3 * k] = out[3 * k + 1] = out[3 * k + 2] = 0;
}

constexpr int SELF_K = N_OFFSETS - 1;

float cutoff_sq(double cutoff) {
  const float c = (float)cutoff;
  return c * c;
}

// Kernel C's parameters for a pair-term table (ops/rspace_cells.py:window_table),
// each constant rounded to float from the expressions of ops/math.py:
// coulomb_alpha, coulomb_c_gauss, power_law_alpha_sq, power_law_c_gauss.
WindowParams window_params(c10::IntArrayRef kinds, c10::IntArrayRef exponents,
                           c10::ArrayRef<double> smearings, c10::ArrayRef<double> prefactors,
                           bool has_weights, bool direct, double cutoff, int64_t nx, int64_t ny,
                           int64_t nz, int64_t cap, int64_t n_ch) {
  const size_t n = kinds.size();
  TORCH_CHECK_VALUE(n >= 1 && n <= (size_t)MAX_MEMBERS && exponents.size() == n &&
                        smearings.size() == n && prefactors.size() == n,
                    "the window kernel takes 1 to ", MAX_MEMBERS,
                    " pair terms, each with a kind, an exponent, a smearing and a prefactor");
  TORCH_CHECK_VALUE(has_weights || n == 1, "a table of ", n, " terms needs their weights");
  WindowParams p;
  std::memset(&p, 0, sizeof p);
  p.nx = (int)nx;
  p.ny = (int)ny;
  p.nz = (int)nz;
  p.cap = (int)cap;
  p.n_ch = (int)n_ch;
  p.direct = direct ? 1 : 0;
  // 0: one Coulomb-form term (p = 1), 1: one 1/r^p term, 2: a combination
  p.kind = has_weights ? 2 : (exponents[0] == 1 ? 0 : 1);
  p.n_members = (int)n;
  p.self_k = SELF_K;
  p.cutoff_sq = cutoff_sq(cutoff);
  for (size_t i = 0; i < n; ++i) {
    const int64_t e = exponents[i];
    TORCH_CHECK_VALUE(e >= 1 && e <= 6, "the window kernel takes 1/r^p terms of p = 1..6, got ",
                      e);
    WindowMember& m = p.members[i];
    const double s = smearings[i], prefactor = prefactors[i];
    m.p = (int)e;
    m.prefactor = (float)prefactor;
    if (direct) continue;
    if (kinds[i] == 0) {  // CoulombPotential
      const double alpha = 1.0 / (s * std::pow(2.0, 0.5));
      m.alpha = (float)alpha;
      m.alpha_sq = (float)(alpha * alpha);
      m.c_gauss = (float)(prefactor * (2.0 * alpha / std::pow(M_PI, 0.5)));
    } else {  // InversePowerLawPotential
      const double alpha_sq = 0.5 / std::pow(s, 2.0);
      m.alpha = (float)std::pow(alpha_sq, 0.5);
      m.alpha_sq = (float)alpha_sq;
      m.c_gauss =
          (float)(prefactor * 2.0 * std::pow(alpha_sq, (double)e / 2.0) / GAMMA_HALF[e]);
    }
  }
  window_offsets(p.offsets);
  return p;
}

// -- kernel G's parameters ------------------------------------------------------

WindowDipoleParams window_dipole_params(std::optional<double> smearing, double prefactor,
                                        double cutoff, int64_t nx, int64_t ny, int64_t nz,
                                        int64_t cap) {
  WindowDipoleParams p;
  std::memset(&p, 0, sizeof p);
  p.nx = (int)nx;
  p.ny = (int)ny;
  p.nz = (int)nz;
  p.cap = (int)cap;
  p.self_k = SELF_K;
  p.direct = smearing.has_value() ? 0 : 1;
  p.cutoff_sq = cutoff_sq(cutoff);
  p.prefactor = (float)prefactor;
  if (smearing.has_value()) {
    const double alpha = 1.0 / (2.0 * std::pow(*smearing, 2.0));
    p.alpha = (float)alpha;
    p.sqrt_alpha = (float)std::pow(alpha, 0.5);
    p.c_gauss = (float)(2.0 * std::pow(alpha / M_PI, 0.5));
  }
  window_offsets(p.offsets);
  return p;
}

// -- kernels D, E, F --------------------------------------------------------------

MeshParams mesh_params(c10::IntArrayRef ns, int64_t nodes, int64_t n_sys, int64_t t, int64_t k,
                       int64_t n_ch, int64_t n_vals) {
  MeshParams p;
  std::memset(&p, 0, sizeof p);
  p.nx = (int)ns[0];
  p.ny = (int)ns[1];
  p.nz = (int)ns[2];
  p.nodes = (int)nodes;
  p.extent = (int)(TILE + nodes - 1);
  p.ty_count = (int)(ns[1] / TILE);
  p.n_tiles = (int)t;
  p.cap = (int)k;
  p.n_ch = (int)n_ch;
  p.z_chunk = (int)chunk_or(CHUNK_MESH_GATHER, gather_z_chunk(nodes, n_ch));
  p.n_sys = (int)n_sys;
  p.slot_stride = t * k;
  p.val_stride = t * n_vals * k;
  p.mesh_stride = n_ch * ns[0] * ns[1] * ns[2];
  return p;
}

// -- Meta kernels: the output shapes and dtypes ---------------------------------

using c10::SymInt;

std::vector<SymInt> sym(c10::SymIntArrayRef lead, std::initializer_list<SymInt> rest) {
  std::vector<SymInt> out(lead.begin(), lead.end());
  out.insert(out.end(), rest);
  return out;
}

at::Tensor spread_fwd_meta(const at::Tensor& rel, const at::Tensor& q, c10::IntArrayRef geometry,
                           c10::string_view) {
  const SpreadGeometry g = spread_geometry(geometry);
  return rel.new_empty_symint(sym({}, {q.sym_size(-1), g.nx, g.ny, g.nz}));
}

std::tuple<at::Tensor, at::Tensor> spread_bwd_meta(const at::Tensor& rel, const at::Tensor& q,
                                                   const at::Tensor&, c10::IntArrayRef,
                                                   c10::string_view) {
  return {at::empty_like(rel), at::empty_like(q)};
}

using WindowOut =
    std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor, at::Tensor, at::Tensor, at::Tensor>;

WindowOut window_meta(const at::Tensor& pc_t, const at::Tensor& q_g, const at::Tensor&,
                      const at::Tensor& offs, const at::Tensor&,
                      const std::optional<at::Tensor>&, c10::IntArrayRef kinds, c10::IntArrayRef,
                      c10::ArrayRef<double>, c10::ArrayRef<double>, bool, double,
                      const std::optional<at::Tensor>& qi_g) {
  const auto wide = pc_t.options().dtype(at::kDouble);
  return {pc_t.new_empty({}),
          at::empty_like(pc_t),
          at::empty_like(q_g),
          at::empty_like(offs),
          at::empty({3, 3}, wide),
          qi_g.has_value() ? at::empty_like(q_g) : q_g.new_empty({0}),
          at::empty({(int64_t)kinds.size()}, wide)};
}

using DipoleOut = std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor, at::Tensor>;

DipoleOut window_dipole_meta(const at::Tensor& pc_t, const at::Tensor& mu_g, const at::Tensor&,
                             const at::Tensor& offs, const std::optional<at::Tensor>& mui_g,
                             std::optional<double>, double, double) {
  return {pc_t.new_empty({}), at::empty_like(pc_t), at::empty_like(mu_g), at::empty_like(offs),
          mui_g.has_value() ? at::empty_like(mu_g) : mu_g.new_empty({0})};
}

at::Tensor mesh_like(const at::Tensor& weights, const at::Tensor& lx, const SymInt& n_ch,
                     c10::IntArrayRef ns) {
  TORCH_CHECK_VALUE(ns.size() == 3, "ns must be (nx, ny, nz)");
  const auto s = lx.sym_sizes();
  return weights.new_empty_symint(sym(s.slice(0, s.size() - 2), {n_ch, ns[0], ns[1], ns[2]}));
}

at::Tensor slots_like(const at::Tensor& weights, const at::Tensor& lx, const SymInt& n_vals) {
  const auto s = lx.sym_sizes();
  const size_t d = s.size();
  return weights.new_empty_symint(sym(s.slice(0, d - 2), {s[d - 2], n_vals, s[d - 1]}));
}

at::Tensor mesh_spread_meta(const at::Tensor& lx, const at::Tensor&, const at::Tensor&,
                            const at::Tensor& weights, const at::Tensor& q_slots,
                            c10::IntArrayRef ns, int64_t) {
  return mesh_like(weights, lx, q_slots.sym_size(-2), ns);
}

at::Tensor mesh_spread_dipole_meta(const at::Tensor& lx, const at::Tensor&, const at::Tensor&,
                                   const at::Tensor& weights, const at::Tensor&, const at::Tensor&,
                                   c10::IntArrayRef ns, int64_t) {
  return mesh_like(weights, lx, 1, ns);
}

at::Tensor mesh_gather_meta(const at::Tensor& lx, const at::Tensor&, const at::Tensor&,
                            const at::Tensor& weights, const at::Tensor& mesh, c10::IntArrayRef,
                            int64_t) {
  return slots_like(weights, lx, mesh.sym_size(-4));
}

at::Tensor mesh_wgrad_meta(const at::Tensor&, const at::Tensor&, const at::Tensor&,
                           const at::Tensor& weights, const at::Tensor&, const at::Tensor&,
                           c10::IntArrayRef, int64_t) {
  return at::empty_like(weights);
}

std::tuple<at::Tensor, at::Tensor> mesh_gather_wgrad_meta(
    const at::Tensor& lx, const at::Tensor&, const at::Tensor&, const at::Tensor& weights,
    const at::Tensor&, const at::Tensor& mesh, c10::IntArrayRef, int64_t) {
  return {slots_like(weights, lx, mesh.sym_size(-4)), at::empty_like(weights)};
}

at::Tensor mesh_gather_dipole_meta(const at::Tensor& lx, const at::Tensor&, const at::Tensor&,
                                   const at::Tensor& weights, const at::Tensor&, const at::Tensor&,
                                   c10::IntArrayRef, int64_t) {
  return slots_like(weights, lx, 3);
}

std::tuple<at::Tensor, at::Tensor> mesh_wgrad_dipole_meta(
    const at::Tensor&, const at::Tensor&, const at::Tensor&, const at::Tensor& weights,
    const at::Tensor&, const at::Tensor&, const at::Tensor&, c10::IntArrayRef, int64_t) {
  return {at::empty_like(weights), at::empty_like(weights)};
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> mesh_gather_wgrad_dipole_meta(
    const at::Tensor& lx, const at::Tensor&, const at::Tensor&, const at::Tensor& weights,
    const at::Tensor&, const at::Tensor&, const at::Tensor&, c10::IntArrayRef, int64_t) {
  return {slots_like(weights, lx, 3), at::empty_like(weights), at::empty_like(weights)};
}

}  // namespace

// -- the parameter builders for tests: 0, or 1 with the message in err ------------

namespace {

template <typename Params, typename Build>
int host_build(void* out, char* err, int64_t err_len, Build build) {
  try {
    const Params p = build();
    std::memcpy(out, &p, sizeof p);
    return 0;
  } catch (const c10::Error& e) {
    if (err != nullptr && err_len > 0) {
      std::strncpy(err, e.what_without_backtrace(), (size_t)err_len - 1);
      err[err_len - 1] = '\0';
    }
    return 1;
  }
}

}  // namespace

extern "C" {

int64_t tpme_host_params_size(int which) {
  const int64_t sizes[4] = {sizeof(SpreadParams), sizeof(WindowParams),
                            sizeof(WindowDipoleParams), sizeof(MeshParams)};
  return which >= 0 && which < 4 ? sizes[which] : 0;
}

int tpme_host_spread_params(const int64_t* geometry, const char* method, int64_t n_ch, void* out,
                            char* err, int64_t err_len) {
  return host_build<SpreadParams>(out, err, err_len, [&] {
    return spread_params(spread_geometry(c10::IntArrayRef(geometry, 9)), method, n_ch);
  });
}

// grid: (nx, ny, nz, cap)
int tpme_host_window_params(const int64_t* kinds, const int64_t* exponents,
                            const double* smearings, const double* prefactors, int64_t n_terms,
                            int has_weights, int direct, double cutoff, const int64_t* grid,
                            int64_t n_ch, void* out, char* err, int64_t err_len) {
  return host_build<WindowParams>(out, err, err_len, [&] {
    return window_params(c10::IntArrayRef(kinds, n_terms), c10::IntArrayRef(exponents, n_terms),
                         c10::ArrayRef<double>(smearings, n_terms),
                         c10::ArrayRef<double>(prefactors, n_terms), has_weights != 0,
                         direct != 0, cutoff, grid[0], grid[1], grid[2], grid[3], n_ch);
  });
}

int tpme_host_window_dipole_params(int has_smearing, double smearing, double prefactor,
                                   double cutoff, const int64_t* grid, void* out, char* err,
                                   int64_t err_len) {
  return host_build<WindowDipoleParams>(out, err, err_len, [&] {
    return window_dipole_params(has_smearing ? std::optional<double>(smearing) : std::nullopt,
                                prefactor, cutoff, grid[0], grid[1], grid[2], grid[3]);
  });
}

int tpme_host_mesh_params(const int64_t* ns, int64_t nodes, int64_t n_sys, int64_t t, int64_t k,
                          int64_t n_ch, int64_t n_vals, void* out, char* err, int64_t err_len) {
  return host_build<MeshParams>(out, err, err_len, [&] {
    return mesh_params(c10::IntArrayRef(ns, 3), nodes, n_sys, t, k, n_ch, n_vals);
  });
}

}  // extern "C"

// -- the CUDA implementations --------------------------------------------------------

#ifdef TPME_WITH_CUDA

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" {
const char* tpme_error_string(int status);
int tpme_spread_fwd(const float* rel, const float* q, float* rho, const SpreadParams* p,
                    void* stream);
int tpme_spread_bwd(const float* rel, const float* q, const float* ct, float* ct_rel,
                    float* ct_q, const SpreadParams* p, void* stream);
int tpme_window_group(int cap, int n_ch, int device);
int tpme_window_max_cap(int n_ch, int device);
int tpme_window(const float* pc, const float* q, const float* mf, const float* offs,
                const float* weights, const float* qi, double* acc, float* d_pc, float* d_q,
                float* d_offs, float* d_qi, const WindowParams* p, void* stream);
int tpme_window_dipole_warps(int cap, int split, int device);
int tpme_window_dipole_max_cap(int split, int device);
int tpme_window_dipole(const float* pc, const float* mu, const float* mf, const float* offs,
                       const float* mui, double* acc, float* d_pc, float* d_mu, float* d_offs,
                       float* d_mui, const WindowDipoleParams* p, void* stream);
int tpme_mesh_spread(const int* lx, const int* ly, const int* sz, const float* w, const float* dw,
                     const float* q, float* mesh, const MeshParams* p, void* stream);
int tpme_mesh_gather_wgrad(const int* lx, const int* ly, const int* sz, const float* w,
                           const float* dw, const float* q, const float* mesh, float* vals,
                           float* wg, float* dwg, const MeshParams* p, void* stream);
}

namespace {

void check_status(int status, const char* name) {
  TORCH_CHECK(status == 0, "CUDA kernel ", name, " failed: error ", status, " (",
              tpme_error_string(status), ")");
}

void* stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

const float* fptr(const at::Tensor& t) { return t.data_ptr<float>(); }
float* fptr_mut(const at::Tensor& t) { return t.data_ptr<float>(); }
const float* fptr(const std::optional<at::Tensor>& t) {
  return t.has_value() ? t->data_ptr<float>() : nullptr;
}

// -- kernels A and B

int64_t check_slots(const at::Tensor& rel, const at::Tensor& q, const SpreadGeometry& g) {
  const int64_t nb = g.n_tiles * g.slots;
  check_cuda_tensor(rel, "rel", {nb, 3});
  TORCH_CHECK_VALUE(q.dim() == 2, "q must be (slots, channels), got ", tuple_str(q.sizes()));
  check_cuda_tensor(q, "q", {nb, q.size(1)});
  TORCH_CHECK_VALUE(q.device() == rel.device(), "rel and q must be on the same device");
  return q.size(1);
}

at::Tensor spread_fwd_cuda(const at::Tensor& rel, const at::Tensor& q, c10::IntArrayRef geometry,
                           c10::string_view method) {
  const SpreadGeometry g = spread_geometry(geometry);
  const int64_t n_ch = check_slots(rel, q, g);
  // the blocks own every mesh cell once: the tiles must cover the mesh
  TORCH_CHECK_VALUE(g.nx % TILE == 0 && g.ny % TILE == 0 &&
                        g.n_tiles == (g.nx / TILE) * g.ty_count(),
                    g.n_tiles, " tiles do not cover the ", tuple_str({g.nx, g.ny, g.nz}),
                    " mesh");
  TORCH_CHECK_VALUE(g.z_cells > 0 && g.slots % g.z_cells == 0, g.slots,
                    " slots per tile do not split into ", g.z_cells, " z cells");
  const SpreadParams p = spread_params(g, method, n_ch);
  const c10::cuda::CUDAGuard guard(rel.device());
  at::Tensor rho = at::empty({n_ch, g.nx, g.ny, g.nz}, rel.options());
  check_status(tpme_spread_fwd(fptr(rel), fptr(q), fptr_mut(rho), &p, stream_of(rel)),
               "spread_fwd");
  count(COUNT_spread_fwd);
  return rho;
}

std::tuple<at::Tensor, at::Tensor> spread_bwd_cuda(const at::Tensor& rel, const at::Tensor& q,
                                                   const at::Tensor& ct_rho,
                                                   c10::IntArrayRef geometry,
                                                   c10::string_view method) {
  const SpreadGeometry g = spread_geometry(geometry);
  const int64_t n_ch = check_slots(rel, q, g);
  check_cuda_tensor(ct_rho, "ct_rho", {n_ch, g.nx, g.ny, g.nz});
  const SpreadParams p = spread_params(g, method, n_ch);
  const c10::cuda::CUDAGuard guard(rel.device());
  at::Tensor ct_rel = at::empty_like(rel);
  at::Tensor ct_q = at::empty_like(q);
  check_status(tpme_spread_bwd(fptr(rel), fptr(q), fptr(ct_rho), fptr_mut(ct_rel),
                               fptr_mut(ct_q), &p, stream_of(rel)),
               "spread_bwd");
  count(COUNT_spread_bwd);
  return {ct_rel, ct_q};
}

// -- kernel C

std::mutex g_plan_mutex;
std::map<std::tuple<int64_t, int64_t, int64_t>, int> g_window_groups;
std::map<std::tuple<int64_t, int64_t, int64_t>, int> g_dipole_warps;

int window_group(int64_t cap, int64_t cols, int64_t device) {
  std::lock_guard<std::mutex> lock(g_plan_mutex);
  const auto key = std::make_tuple(cap, cols, device);
  auto it = g_window_groups.find(key);
  if (it == g_window_groups.end())
    it = g_window_groups.emplace(key, tpme_window_group((int)cap, (int)cols, (int)device)).first;
  return it->second;
}

int window_dipole_warps(int64_t cap, bool split, int64_t device) {
  std::lock_guard<std::mutex> lock(g_plan_mutex);
  const auto key = std::make_tuple(cap, (int64_t)split, device);
  auto it = g_dipole_warps.find(key);
  if (it == g_dipole_warps.end())
    it = g_dipole_warps.emplace(key, tpme_window_dipole_warps((int)cap, split, (int)device)).first;
  return it->second;
}

void check_window_grid(const at::Tensor& pc_t) {
  TORCH_CHECK_VALUE(pc_t.dim() == 5 && pc_t.size(3) == 3, "pc_t must be (nx, ny, nz, 3, cap), got ",
                    tuple_str(pc_t.sizes()));
}

WindowOut window_cuda(const at::Tensor& pc_t, const at::Tensor& q_g, const at::Tensor& mf_g,
                      const at::Tensor& offs, const at::Tensor&,
                      const std::optional<at::Tensor>& weights, c10::IntArrayRef kinds,
                      c10::IntArrayRef exponents, c10::ArrayRef<double> smearings,
                      c10::ArrayRef<double> prefactors, bool direct, double cutoff,
                      const std::optional<at::Tensor>& qi_g) {
  check_window_grid(pc_t);
  const int64_t nx = pc_t.size(0), ny = pc_t.size(1), nz = pc_t.size(2), cap = pc_t.size(4);
  TORCH_CHECK_VALUE(q_g.dim() >= 1, "q_g must be (nx, ny, nz, cap, C)");
  const int64_t n_ch = q_g.size(-1);
  TORCH_CHECK_VALUE(n_ch <= MAX_CHANNELS, "the window kernel takes at most ", MAX_CHANNELS,
                    " channels");
  check_cuda_tensor(pc_t, "pc_t", {nx, ny, nz, 3, cap});
  check_cuda_tensor(q_g, "q_g", {nx, ny, nz, cap, n_ch});
  check_cuda_tensor(mf_g, "mf_g", {nx, ny, nz, cap});
  check_cuda_tensor(offs, "offs", {N_OFFSETS, 3});
  const bool split = qi_g.has_value();
  if (split) check_cuda_tensor(*qi_g, "qi_g", {nx, ny, nz, cap, n_ch});
  WindowParams p = window_params(kinds, exponents, smearings, prefactors, weights.has_value(),
                                 direct, cutoff, nx, ny, nz, cap, n_ch);
  const int64_t device = pc_t.device().index();
  const int64_t cols = split ? 2 * n_ch : n_ch;
  p.group = window_group(cap, cols, device);
  TORCH_CHECK_VALUE(p.group != 0, "the window kernel takes a cell capacity of at most ",
                    tpme_window_max_cap((int)cols, (int)device), " at ", n_ch, " channel(s)",
                    split ? " with separate i-side charges" : "", ", got ", cap,
                    "; plain=True runs the plain version");
  const c10::cuda::CUDAGuard guard(pc_t.device());
  // the kernel writes every row of its outputs; its double accumulators
  // (energy, d_offs, a block counter, the members' energies, the image term)
  // start at zero
  at::Tensor acc = at::zeros({WINDOW_IMAGE_ROW + 9}, pc_t.options().dtype(at::kDouble));
  at::Tensor d_pc = at::empty_like(pc_t);
  at::Tensor d_q = at::empty_like(q_g);
  at::Tensor d_offs = at::empty_like(offs);
  at::Tensor d_qi = split ? at::empty_like(q_g) : q_g.new_empty({0});
  // a CombinedPotential's weights as the kernel reads them: float32 on the card
  std::optional<at::Tensor> w;
  if (weights.has_value()) w = weights->to(pc_t.options().dtype(at::kFloat)).contiguous();
  check_status(tpme_window(fptr(pc_t), fptr(q_g), fptr(mf_g), fptr(offs), fptr(w), fptr(qi_g),
                           acc.data_ptr<double>(), fptr_mut(d_pc), fptr_mut(d_q),
                           fptr_mut(d_offs), split ? fptr_mut(d_qi) : nullptr, &p,
                           stream_of(pc_t)),
               "window");
  count(split ? COUNT_window_split : COUNT_window);
  // an op's outputs are fresh tensors, not views of the accumulator
  at::Tensor d_image = acc.slice(0, WINDOW_IMAGE_ROW).reshape({3, 3}).clone();
  at::Tensor members =
      acc.slice(0, WINDOW_MEMBER_ROW, WINDOW_MEMBER_ROW + (int64_t)kinds.size()).clone();
  return {acc.select(0, 0).to(at::kFloat), d_pc, d_q, d_offs, d_image, d_qi, members};
}

// -- kernel G

DipoleOut window_dipole_cuda(const at::Tensor& pc_t, const at::Tensor& mu_g,
                             const at::Tensor& mf_g, const at::Tensor& offs,
                             const std::optional<at::Tensor>& mui_g,
                             std::optional<double> smearing, double prefactor, double cutoff) {
  check_window_grid(pc_t);
  const int64_t nx = pc_t.size(0), ny = pc_t.size(1), nz = pc_t.size(2), cap = pc_t.size(4);
  check_cuda_tensor(pc_t, "pc_t", {nx, ny, nz, 3, cap});
  check_cuda_tensor(mu_g, "mu_g", {nx, ny, nz, cap, 3});
  check_cuda_tensor(mf_g, "mf_g", {nx, ny, nz, cap});
  check_cuda_tensor(offs, "offs", {N_OFFSETS, 3});
  const bool split = mui_g.has_value();
  if (split) check_cuda_tensor(*mui_g, "mui_g", {nx, ny, nz, cap, 3});
  WindowDipoleParams p = window_dipole_params(smearing, prefactor, cutoff, nx, ny, nz, cap);
  const int64_t device = pc_t.device().index();
  p.warps = window_dipole_warps(cap, split, device);
  TORCH_CHECK_VALUE(p.warps != 0, "the dipolar window kernel takes a cell capacity of at most ",
                    tpme_window_dipole_max_cap(split, (int)device), " ",
                    split ? "with" : "without", " separate i-side dipoles, got ", cap,
                    "; plain=True runs the plain version");
  const c10::cuda::CUDAGuard guard(pc_t.device());
  // the kernel writes every row of its outputs; its double accumulators
  // (energy, d_offs, a block counter) start at zero
  at::Tensor acc = at::zeros({2 + 3 * N_OFFSETS}, pc_t.options().dtype(at::kDouble));
  at::Tensor d_pc = at::empty_like(pc_t);
  at::Tensor d_mu = at::empty_like(mu_g);
  at::Tensor d_offs = at::empty_like(offs);
  at::Tensor d_mui = split ? at::empty_like(mu_g) : mu_g.new_empty({0});
  check_status(tpme_window_dipole(fptr(pc_t), fptr(mu_g), fptr(mf_g), fptr(offs), fptr(mui_g),
                                  acc.data_ptr<double>(), fptr_mut(d_pc), fptr_mut(d_mu),
                                  fptr_mut(d_offs), split ? fptr_mut(d_mui) : nullptr, &p,
                                  stream_of(pc_t)),
               "window_dipole");
  count(COUNT_window_dipole);
  return {acc.select(0, 0).to(at::kFloat), d_pc, d_mu, d_offs, d_mui};
}

// -- kernels D, E, F

struct MeshShape {
  std::vector<int64_t> lead;
  int64_t t, k, n_sys;
};

// The bucketing arrays of one system (T, K) or of a batch (..., T, K); the
// charge forms take 1 to 7 nodes, the dipole forms 3 to 7.
MeshShape check_mesh(const at::Tensor& lx, const at::Tensor& ly, const at::Tensor& sz,
                     const at::Tensor& weights, c10::IntArrayRef ns, int64_t nodes, bool dipole) {
  const int64_t lo = dipole ? 3 : 1;
  TORCH_CHECK_VALUE(lo <= nodes && nodes <= 7, "the ",
                    dipole ? "dipole forms of the mesh kernels are" : "mesh kernels are",
                    " built for ", lo, " to 7 nodes, got ", nodes);
  TORCH_CHECK_VALUE(ns.size() == 3, "ns must be (nx, ny, nz), got ", tuple_str(ns));
  TORCH_CHECK_VALUE(ns[0] % TILE == 0 && ns[1] % TILE == 0, "mesh ", tuple_str(ns),
                    " is not a whole number of ", TILE, "x", TILE, " tiles");
  TORCH_CHECK_VALUE(lx.dim() >= 2, "local_x has shape ", tuple_str(lx.sizes()),
                    ", expected (..., T, K)");
  MeshShape s;
  s.lead.assign(lx.sizes().begin(), lx.sizes().end() - 2);
  s.t = lx.size(-2);
  s.k = lx.size(-1);
  s.n_sys = 1;
  for (int64_t d : s.lead) s.n_sys *= d;
  TORCH_CHECK_VALUE(s.t == (ns[0] / TILE) * (ns[1] / TILE), s.t, " tiles do not cover the ",
                    tuple_str(ns), " mesh");
  TORCH_CHECK_VALUE(1 <= s.n_sys && s.n_sys <= MAX_SYSTEMS, "a launch takes 1 to ", MAX_SYSTEMS,
                    " systems, got batch axes ", tuple_str(s.lead));
  const auto slots = cat(s.lead, {s.t, s.k});
  check_cuda_tensor(lx, "local_x", slots, at::kInt);
  check_cuda_tensor(ly, "local_y", slots, at::kInt);
  check_cuda_tensor(sz, "start_z", slots, at::kInt);
  check_cuda_tensor(weights, "weights", cat(s.lead, {s.t, s.k, 3, nodes}));
  return s;
}

at::Tensor launch_spread(const at::Tensor& lx, const at::Tensor& ly, const at::Tensor& sz,
                         const at::Tensor& weights, const std::optional<at::Tensor>& dweights,
                         const at::Tensor& values, c10::IntArrayRef ns, int64_t nodes,
                         const MeshShape& s) {
  const int64_t n_ch = dweights.has_value() ? 1 : values.size(-2);
  const MeshParams p = mesh_params(ns, nodes, s.n_sys, s.t, s.k, n_ch, values.size(-2));
  const c10::cuda::CUDAGuard guard(weights.device());
  // the kernel adds into the mesh
  at::Tensor mesh = at::zeros(cat(s.lead, {n_ch, ns[0], ns[1], ns[2]}), weights.options());
  check_status(tpme_mesh_spread(lx.data_ptr<int>(), ly.data_ptr<int>(), sz.data_ptr<int>(),
                                fptr(weights), fptr(dweights), fptr(values), fptr_mut(mesh), &p,
                                stream_of(weights)),
               "mesh_spread");
  count(COUNT_mesh_spread);
  return mesh;
}

at::Tensor mesh_spread_cuda(const at::Tensor& lx, const at::Tensor& ly, const at::Tensor& sz,
                            const at::Tensor& weights, const at::Tensor& q_slots,
                            c10::IntArrayRef ns, int64_t nodes) {
  const MeshShape s = check_mesh(lx, ly, sz, weights, ns, nodes, false);
  TORCH_CHECK_VALUE(q_slots.dim() >= 2, "q_slots must be (..., T, C, K), got ",
                    tuple_str(q_slots.sizes()));
  check_cuda_tensor(q_slots, "q_slots", cat(s.lead, {s.t, q_slots.size(-2), s.k}));
  return launch_spread(lx, ly, sz, weights, std::nullopt, q_slots, ns, nodes, s);
}

at::Tensor mesh_spread_dipole_cuda(const at::Tensor& lx, const at::Tensor& ly,
                                   const at::Tensor& sz, const at::Tensor& weights,
                                   const at::Tensor& dweights, const at::Tensor& nu_slots,
                                   c10::IntArrayRef ns, int64_t nodes) {
  const MeshShape s = check_mesh(lx, ly, sz, weights, ns, nodes, true);
  check_cuda_tensor(dweights, "dweights", cat(s.lead, {s.t, s.k, 3, nodes}));
  check_cuda_tensor(nu_slots, "nu_slots", cat(s.lead, {s.t, 3, s.k}));
  return launch_spread(lx, ly, sz, weights, dweights, nu_slots, ns, nodes, s);
}

// Kernels E and/or F in one launch: the charge form, or with dweights the
// dipole form (q_slots is then nu (..., T, 3, K)); (values, ct_w, ct_dw),
// undefined where not asked for.
std::tuple<at::Tensor, at::Tensor, at::Tensor> launch_gather_wgrad(
    const at::Tensor& lx, const at::Tensor& ly, const at::Tensor& sz, const at::Tensor& weights,
    const std::optional<at::Tensor>& dweights, const std::optional<at::Tensor>& q_slots,
    const at::Tensor& mesh, c10::IntArrayRef ns, int64_t nodes, bool gather, bool wgrad) {
  const bool dipole = dweights.has_value();
  const MeshShape s = check_mesh(lx, ly, sz, weights, ns, nodes, dipole);
  TORCH_CHECK_VALUE(mesh.dim() >= 4, "mesh must be (..., C, nx, ny, nz), got ",
                    tuple_str(mesh.sizes()));
  const int64_t n_ch = dipole ? 1 : mesh.size(-4);
  check_cuda_tensor(mesh, "mesh", cat(s.lead, {n_ch, ns[0], ns[1], ns[2]}));
  if (dipole) check_cuda_tensor(*dweights, "dweights", cat(s.lead, {s.t, s.k, 3, nodes}));
  const int64_t n_vals = dipole ? 3 : n_ch;
  const c10::cuda::CUDAGuard guard(weights.device());
  at::Tensor vals, wg, dwg;
  if (wgrad) {
    check_cuda_tensor(*q_slots, dipole ? "nu_slots" : "q_slots", cat(s.lead, {s.t, n_vals, s.k}));
    wg = at::empty(cat(s.lead, {s.t, s.k, 3, nodes}), weights.options());
    if (dipole) dwg = at::empty_like(wg);
  }
  if (gather) vals = at::empty(cat(s.lead, {s.t, n_vals, s.k}), weights.options());
  const MeshParams p = mesh_params(ns, nodes, s.n_sys, s.t, s.k, n_ch, n_vals);
  auto opt = [](const at::Tensor& t) { return t.defined() ? t.data_ptr<float>() : nullptr; };
  check_status(tpme_mesh_gather_wgrad(lx.data_ptr<int>(), ly.data_ptr<int>(), sz.data_ptr<int>(),
                                      fptr(weights), fptr(dweights),
                                      wgrad ? fptr(q_slots) : nullptr, fptr(mesh), opt(vals),
                                      opt(wg), opt(dwg), &p, stream_of(weights)),
               "mesh_gather_wgrad");
  if (gather) count(COUNT_mesh_gather);
  if (wgrad) count(COUNT_mesh_wgrad);
  return {vals, wg, dwg};
}

at::Tensor mesh_gather_cuda(const at::Tensor& lx, const at::Tensor& ly, const at::Tensor& sz,
                            const at::Tensor& weights, const at::Tensor& mesh,
                            c10::IntArrayRef ns, int64_t nodes) {
  return std::get<0>(launch_gather_wgrad(lx, ly, sz, weights, std::nullopt, std::nullopt, mesh,
                                         ns, nodes, true, false));
}

at::Tensor mesh_wgrad_cuda(const at::Tensor& lx, const at::Tensor& ly, const at::Tensor& sz,
                           const at::Tensor& weights, const at::Tensor& q_slots,
                           const at::Tensor& mesh, c10::IntArrayRef ns, int64_t nodes) {
  return std::get<1>(launch_gather_wgrad(lx, ly, sz, weights, std::nullopt, q_slots, mesh, ns,
                                         nodes, false, true));
}

std::tuple<at::Tensor, at::Tensor> mesh_gather_wgrad_cuda(
    const at::Tensor& lx, const at::Tensor& ly, const at::Tensor& sz, const at::Tensor& weights,
    const at::Tensor& q_slots, const at::Tensor& mesh, c10::IntArrayRef ns, int64_t nodes) {
  auto out = launch_gather_wgrad(lx, ly, sz, weights, std::nullopt, q_slots, mesh, ns, nodes,
                                 true, true);
  return {std::get<0>(out), std::get<1>(out)};
}

at::Tensor mesh_gather_dipole_cuda(const at::Tensor& lx, const at::Tensor& ly,
                                   const at::Tensor& sz, const at::Tensor& weights,
                                   const at::Tensor& dweights, const at::Tensor& mesh,
                                   c10::IntArrayRef ns, int64_t nodes) {
  return std::get<0>(launch_gather_wgrad(lx, ly, sz, weights, dweights, std::nullopt, mesh, ns,
                                         nodes, true, false));
}

std::tuple<at::Tensor, at::Tensor> mesh_wgrad_dipole_cuda(
    const at::Tensor& lx, const at::Tensor& ly, const at::Tensor& sz, const at::Tensor& weights,
    const at::Tensor& dweights, const at::Tensor& nu_slots, const at::Tensor& mesh,
    c10::IntArrayRef ns, int64_t nodes) {
  auto out = launch_gather_wgrad(lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes, false,
                                 true);
  return {std::get<1>(out), std::get<2>(out)};
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> mesh_gather_wgrad_dipole_cuda(
    const at::Tensor& lx, const at::Tensor& ly, const at::Tensor& sz, const at::Tensor& weights,
    const at::Tensor& dweights, const at::Tensor& nu_slots, const at::Tensor& mesh,
    c10::IntArrayRef ns, int64_t nodes) {
  return launch_gather_wgrad(lx, ly, sz, weights, dweights, nu_slots, mesh, ns, nodes, true,
                             true);
}

std::vector<int64_t> window_plan(int64_t cap, int64_t n_ch, bool split, int64_t device) {
  const int64_t cols = split ? 2 * n_ch : n_ch;
  return {window_group(cap, cols, device), tpme_window_max_cap((int)cols, (int)device)};
}

std::vector<int64_t> window_dipole_plan(int64_t cap, bool split, int64_t device) {
  return {window_dipole_warps(cap, split, device), tpme_window_dipole_max_cap(split, (int)device)};
}

}  // namespace

#else  // a library for the host only: no kernel to plan

namespace {

std::vector<int64_t> window_plan(int64_t, int64_t, bool, int64_t) {
  TORCH_CHECK(false, "this tpme library was built without CUDA");
}

std::vector<int64_t> window_dipole_plan(int64_t, bool, int64_t) {
  TORCH_CHECK(false, "this tpme library was built without CUDA");
}

}  // namespace

#endif  // TPME_WITH_CUDA

// -- registration -----------------------------------------------------------------------

TORCH_LIBRARY(tpme, m) {
#define TPME_OP(name, schema) m.def(schema);
#define TPME_COUNTER(name)
#include "tpme_ops.h"
#undef TPME_COUNTER
#undef TPME_OP
  m.impl("launch_counts", TORCH_FN(launch_counts));
  m.impl("reset_launch_counts", TORCH_FN(reset_launch_counts));
  m.impl("window_plan", TORCH_FN(window_plan));
  m.impl("window_dipole_plan", TORCH_FN(window_dipole_plan));
  m.impl("override_z_chunk", TORCH_FN(override_z_chunk));
}

TORCH_LIBRARY_IMPL(tpme, Meta, m) {
  m.impl("spread_fwd", TORCH_FN(spread_fwd_meta));
  m.impl("spread_bwd", TORCH_FN(spread_bwd_meta));
  m.impl("window", TORCH_FN(window_meta));
  m.impl("window_dipole", TORCH_FN(window_dipole_meta));
  m.impl("mesh_spread", TORCH_FN(mesh_spread_meta));
  m.impl("mesh_spread_dipole", TORCH_FN(mesh_spread_dipole_meta));
  m.impl("mesh_gather", TORCH_FN(mesh_gather_meta));
  m.impl("mesh_wgrad", TORCH_FN(mesh_wgrad_meta));
  m.impl("mesh_gather_wgrad", TORCH_FN(mesh_gather_wgrad_meta));
  m.impl("mesh_gather_dipole", TORCH_FN(mesh_gather_dipole_meta));
  m.impl("mesh_wgrad_dipole", TORCH_FN(mesh_wgrad_dipole_meta));
  m.impl("mesh_gather_wgrad_dipole", TORCH_FN(mesh_gather_wgrad_dipole_meta));
}

#ifdef TPME_WITH_CUDA
TORCH_LIBRARY_IMPL(tpme, CUDA, m) {
  m.impl("spread_fwd", TORCH_FN(spread_fwd_cuda));
  m.impl("spread_bwd", TORCH_FN(spread_bwd_cuda));
  m.impl("window", TORCH_FN(window_cuda));
  m.impl("window_dipole", TORCH_FN(window_dipole_cuda));
  m.impl("mesh_spread", TORCH_FN(mesh_spread_cuda));
  m.impl("mesh_spread_dipole", TORCH_FN(mesh_spread_dipole_cuda));
  m.impl("mesh_gather", TORCH_FN(mesh_gather_cuda));
  m.impl("mesh_wgrad", TORCH_FN(mesh_wgrad_cuda));
  m.impl("mesh_gather_wgrad", TORCH_FN(mesh_gather_wgrad_cuda));
  m.impl("mesh_gather_dipole", TORCH_FN(mesh_gather_dipole_cuda));
  m.impl("mesh_wgrad_dipole", TORCH_FN(mesh_wgrad_dipole_cuda));
  m.impl("mesh_gather_wgrad_dipole", TORCH_FN(mesh_gather_wgrad_dipole_cuda));
}
#endif  // TPME_WITH_CUDA
