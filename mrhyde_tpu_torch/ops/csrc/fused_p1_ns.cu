// Node-scatter assembly of 2D incompressible Navier-Stokes (equal-order
// p1 quads, PSPG/SUPG), steady or a transient stage, for Hopper (sm_90a).
//
// Replaces: the TPU node-scatter kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_node_call` (its pallas_call body is
// `FusedP1Assembly._kernel(node=True)`), in mode "full" with three
// variables (ux, uy, pr; nd = 12 local dofs): the node-scattered residual
// and the element-varying Jacobian rows off one read of the element data.
//
// Weak form (mrhyde_tpu_torch/physics/navierstokes.py ns_density), per
// element e and quadrature point q, at u_eval =
// alpha_u u + beta_u and u_dot = alpha_t u + beta_t (steady: alpha_u = 1,
// no u_dot): the density gives (S_v, F_v) for v in (ux, uy, pr);
//   r_(v,c)  = sum_q w_q (phi_c S_v + grad phi_c . F_v), summed to the
//              node of corner c over its (up to) four elements;
//   J[(v,c),(w,c')] = sum_q w_q (phi_c T[S_v] + grad phi_c . T[F_v]),
//   T[o] = alpha_u phi_c' do/du_w + alpha_t phi_c' do/du_dot_w
//          + alpha_u grad phi_c' . do/d(grad u_w).
// Row k = row*12 + col, row = v*4 + c, col = w*4 + c', corners
// (0,0),(1,0),(1,1),(0,1) on (axis 0, axis 1). Only the rows the host
// probe classified element-varying are stored, as jac[pos*E + e] with pos
// = row_pos[k] >= 0; the constant rows are the probe's values.
//
// Design. The weak form is written once, `ns_density` (ns_density.cuh,
// shared with fused_elem_ns.cu, at DIM = 2 here), a template over its
// scalar type: evaluated on T it gives the densities; on the forward-mode
// Dual<T, N> it gives the Jacobian's derivative tables (the Sacado SFad
// analog the reference MrHyDE uses; the JAX kernel traced the density and
// differentiated it by sparse forward AD at trace time). Nothing is
// differentiated by hand. Here it takes its RECIP form: the quotients by
// h and rho through their reciprocals and tau through drsqrt (3 divisions
// per dual pass where the quotients as written take 17, which took a
// third of the kernel; PERF.md). A block owns a tile of kTa x kTb = 8 x
// 16 nodes and the elements of which they are corner 0, a thread per
// element, each element's quadrature computed once per column variable:
//   Jacobian: for each column variable w = 0, 1, 2 in turn, one pass of
//     the density per qp on Dual<T, N> seeded along w's inputs (u_w,
//     d u_w/dx, d u_w/dy, and u_dot_w in a stage: N = 3 steady, 4 at a
//     stage), its tangents contracted per column c' with the basis tables
//     into the 12 x 4 entries of the column block in registers (48
//     accumulators: the whole 12 x 12 block would not fit the 255 f64
//     registers), stored coalesced over the tile row's elements;
//   residual: the values of the w = 0 pass are the primal densities, so
//     that pass also sums the element's 12 residual rows, into shared
//     memory. The 25 halo elements (the element row below the tile and
//     the column left of it, whose corners are tile nodes too) take one
//     primal density per (element, qp), spread over the block's threads,
//     into shared memory; then each node sums its (up to) four elements'
//     rows, corner 0..3 in order: no atomics, deterministic.
// Mesh edges are masked by index; any N0, N1 >= 1 works (N0 N1 < 2^31); a
// quadrature whose halo densities do not fit the card's shared memory per
// block is refused (f64 past 122 qps; ops/_launch.py ns_node_smem_words).
//
// What bounds it on the H100: `chip_smoke.py` counts the bytes (the
// grids, coefficient tensors and the 112 or 144 Jacobian rows per
// element) and the weak form's operations (its sparse forward AD on one
// element's stand-ins) and reports the larger, the bytes. The kernel is
// far from either: its dual passes and contraction run from registers
// (f64 takes every register with no block minimum: a minimum spills,
// PERF.md), and the dual passes lead.

#include <cuda_runtime.h>

#include "ns_density.cuh"

namespace {

constexpr int kVars = 3;      // ux, uy, pr
constexpr int kRows = 12;     // kVars * 4 corners
constexpr int kOuts = 9;      // S_ux, S_uy, S_pr, F_ux0, F_ux1, F_uy0,
                              // F_uy1, F_pr0, F_pr1
// A block's tile: kTa x kTb nodes (axis 0 x axis 1, axis 1 contiguous)
// and the elements of which they are corner 0 (its own), one thread each;
// its halo: the other elements its nodes touch, row i0 - 1 (kTb + 1 of
// them, from column j0 - 1) and column j0 - 1 (kTa, from row i0)
constexpr int kTa = 8, kTb = 16;
constexpr int kThreads = kTa * kTb;
constexpr int kHalo = kTa + kTb + 1;
// blocks per SM the registers must allow (__launch_bounds__): none for
// f64, whose pass takes every register (a minimum spills); f32 4 steady
// and 3 at a stage
template <typename T>
constexpr int min_blocks(bool transient) {
  return sizeof(T) == 8 ? 1 : (transient ? 3 : 4);
}

// The C interface's arguments, filled by ctypes (ops/fused_ns.py _NSArgs).
struct NsArgs {
  const void* ue;       // (3, N0+1, N1+1) u_eval grids
  const void* ud;       // (3, N0+1, N1+1) u_dot grids, or null (steady)
  const void* coef[4];  // density, viscosity, source ux, source uy: (E, Q)
  double coef0[4];      // ... or these scalars where the pointer is null
  const void* phi;      // (4, Q)
  const void* grad;     // (4, Q, 2)
  const void* wts;      // (Q,)
  const int* row_pos;   // (144,) position of row k in jac, or -1
  void* res;            // (3, N0+1, N1+1) node residual
  void* jac;            // (n_rows, E)
  double alpha_u, alpha_t, h, tau_dt2;  // tau_dt2 = (C3 / dt)^2
  int Q, N0, N1, pspg, supg, transient;
};

// shared memory of a block, in T: its own elements' residual rows
// (kThreads x 12) and the halo elements' primal densities (kHalo x Q x 9)
__host__ __device__ inline long long ns_smem_words(int Q) {
  return (long long)kThreads * kRows + (long long)kHalo * Q * kOuts;
}

// ---------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------

__device__ __forceinline__ int corner_i(int c) { return (c == 1 || c == 2); }
__device__ __forceinline__ int corner_j(int c) { return (c >= 2); }

template <typename T>
__device__ __forceinline__ T coef_at(const NsArgs& a, int k, long long e,
                                     int q) {
  return a.coef[k] ? static_cast<const T*>(a.coef[k])[e * a.Q + q]
                   : T(a.coef0[k]);
}

// corner values uc[v][c] of element (ea, eb) from the (3, N0+1, N1+1) grid
template <typename T>
__device__ __forceinline__ void load_corners(const T* __restrict__ grid,
                                             int ea, int eb, int N0, int N1,
                                             T uc[kVars][4]) {
  const long long nodes = (long long)(N0 + 1) * (N1 + 1);
  const T* g = grid + (long long)ea * (N1 + 1) + eb;
#pragma unroll
  for (int v = 0; v < kVars; ++v)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      uc[v][c] = g[v * nodes + corner_i(c) * (N1 + 1) + corner_j(c)];
}

// values and gradients at quadrature point q from corner values
template <typename T>
__device__ __forceinline__ void at_qp(const T* __restrict__ phi,
                                      const T* __restrict__ grad, int Q,
                                      int q, const T uc[kVars][4],
                                      T val[kVars], T g[kVars][2]) {
#pragma unroll
  for (int v = 0; v < kVars; ++v) {
    T s = T(0), g0 = T(0), g1 = T(0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s += phi[c * Q + q] * uc[v][c];
      g0 += grad[(c * Q + q) * 2 + 0] * uc[v][c];
      g1 += grad[(c * Q + q) * 2 + 1] * uc[v][c];
    }
    val[v] = s;
    g[v][0] = g0;
    g[v][1] = g1;
  }
}

template <typename T>
__device__ __forceinline__ void qp_vals(const T* __restrict__ phi, int Q,
                                        int q, const T uc[kVars][4],
                                        T val[kVars]) {
#pragma unroll
  for (int v = 0; v < kVars; ++v) {
    T s = T(0);
#pragma unroll
    for (int c = 0; c < 4; ++c) s += phi[c * Q + q] * uc[v][c];
    val[v] = s;
  }
}

// The 12 x 4 column block of column variable w of element e: one pass of
// the density per qp on Dual<T, N> seeded along w's inputs, contracted
// with the basis tables into 48 accumulators, stored at its rows'
// positions. ROWS: the pass's values, the primal densities, also sum the
// element's 12 residual rows into rows[0 .. 11], qp by qp.
template <typename T, bool TR, bool ROWS>
__device__ __forceinline__ void column_block(const NsArgs& a, int w,
                                             long long e,
                                             const T uc[kVars][4],
                                             const T udc[kVars][4],
                                             T* rows) {
  constexpr int N = TR ? 4 : 3;  // tangents: u_w, d/dx, d/dy [, u_dot_w]
  using D = Dual<T, N>;
  const int Q = a.Q;
  const T* __restrict__ phi = static_cast<const T*>(a.phi);
  const T* __restrict__ grad = static_cast<const T*>(a.grad);
  const T* __restrict__ wts = static_cast<const T*>(a.wts);
  const T au = T(a.alpha_u), at = T(a.alpha_t);
  T J[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int cp = 0; cp < 4; ++cp) J[r][cp] = T(0);

  for (int q = 0; q < Q; ++q) {
    T uv[kVars], udv[kVars], gv[kVars][2];
    at_qp(phi, grad, Q, q, uc, uv, gv);
    if constexpr (TR) qp_vals(phi, Q, q, udc, udv);
    D u[kVars], ud[kVars], g[kVars][2], out[kOuts];
#pragma unroll
    for (int v = 0; v < kVars; ++v) {
      const T on = (v == w) ? T(1) : T(0);
      u[v].v = uv[v];
      g[v][0].v = gv[v][0];
      g[v][1].v = gv[v][1];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        u[v].d[k] = (k == 0) ? on : T(0);
        g[v][0].d[k] = (k == 1) ? on : T(0);
        g[v][1].d[k] = (k == 2) ? on : T(0);
      }
      if constexpr (TR) {
        ud[v].v = udv[v];
#pragma unroll
        for (int k = 0; k < N; ++k) ud[v].d[k] = (k == 3) ? on : T(0);
      }
    }
    const T src[2] = {coef_at<T>(a, 2, e, q), coef_at<T>(a, 3, e, q)};
    ns_density<TR, 2, D, T, false, true>(
        u, ud, g, coef_at<T>(a, 0, e, q), coef_at<T>(a, 1, e, q), src, T(a.h),
        T(a.tau_dt2), a.pspg, a.supg, out);
    const T wq = wts[q];
    if constexpr (ROWS) {
#pragma unroll
      for (int v = 0; v < kVars; ++v)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          rows[v * 4 + c] += wq * (phi[c * Q + q] * out[v].v +
                                   grad[(c * Q + q) * 2 + 0] *
                                       out[3 + 2 * v].v +
                                   grad[(c * Q + q) * 2 + 1] *
                                       out[4 + 2 * v].v);
    }
#pragma unroll
    for (int cp = 0; cp < 4; ++cp) {
      const T pcp = phi[cp * Q + q];
      const T gcp0 = grad[(cp * Q + q) * 2 + 0];
      const T gcp1 = grad[(cp * Q + q) * 2 + 1];
      // column (w, c'): the tangent of every density output
      T tcol[kOuts];
#pragma unroll
      for (int o = 0; o < kOuts; ++o) {
        T t = au * pcp * out[o].d[0];
        if constexpr (TR) t += at * pcp * out[o].d[3];
        t += au * gcp0 * out[o].d[1];
        t += au * gcp1 * out[o].d[2];
        tcol[o] = t;
      }
#pragma unroll
      for (int v = 0; v < kVars; ++v)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          J[v * 4 + c][cp] +=
              wq * (phi[c * Q + q] * tcol[v] +
                    grad[(c * Q + q) * 2 + 0] * tcol[3 + 2 * v] +
                    grad[(c * Q + q) * 2 + 1] * tcol[4 + 2 * v]);
    }
  }
  const long long E = (long long)a.N0 * a.N1;
  T* __restrict__ jac = static_cast<T*>(a.jac);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int cp = 0; cp < 4; ++cp) {
      const int pos = __ldg(a.row_pos + r * kRows + w * 4 + cp);
      if (pos >= 0) jac[pos * E + e] = J[r][cp];
    }
}

// the primal density of element (ea, eb) at quadrature point q, into
// dst[0 .. 8]
template <typename T, bool TR>
__device__ __forceinline__ void primal_density(const NsArgs& a, int ea,
                                               int eb, int q, T* dst) {
  const T* __restrict__ phi = static_cast<const T*>(a.phi);
  const T* __restrict__ grad = static_cast<const T*>(a.grad);
  const long long e = (long long)ea * a.N1 + eb;
  T uc[kVars][4], udc[kVars][4];
  load_corners(static_cast<const T*>(a.ue), ea, eb, a.N0, a.N1, uc);
  if constexpr (TR)
    load_corners(static_cast<const T*>(a.ud), ea, eb, a.N0, a.N1, udc);
  T u[kVars], ud[kVars], g[kVars][2], out[kOuts];
  at_qp(phi, grad, a.Q, q, uc, u, g);
  if constexpr (TR) qp_vals(phi, a.Q, q, udc, ud);
  const T src[2] = {coef_at<T>(a, 2, e, q), coef_at<T>(a, 3, e, q)};
  ns_density<TR, 2, T, T, false, true>(
      u, ud, g, coef_at<T>(a, 0, e, q), coef_at<T>(a, 1, e, q), src, T(a.h),
      T(a.tau_dt2), a.pspg, a.supg, out);
#pragma unroll
  for (int o = 0; o < kOuts; ++o) dst[o] = out[o];
}

// Block b is node tile (b / tiles_j, b % tiles_j): the column blocks of
// its own elements, w = 0 (whose pass also sums the element's residual
// rows), 1, 2, a thread per element; the halo's primal densities; then
// the node residual of its nodes.
template <typename T, bool TR>
__global__ void __launch_bounds__(kThreads, min_blocks<T>(TR))
    ns_node_full_kernel(const NsArgs a, const int tiles_j) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows = reinterpret_cast<T*>(smem_raw);
  T* halo = rows + kThreads * kRows;
  const int N0 = a.N0, N1 = a.N1, Q = a.Q, tid = threadIdx.x;
  const int ti = (int)blockIdx.x / tiles_j;
  const int i0 = ti * kTa, j0 = ((int)blockIdx.x - ti * tiles_j) * kTb;
  const int li = tid / kTb, lj = tid - li * kTb;
  const int i = i0 + li, j = j0 + lj;
  if (i < N0 && j < N1) {
    const long long e = (long long)i * N1 + j;
    T uc[kVars][4], udc[kVars][4];
    load_corners(static_cast<const T*>(a.ue), i, j, N0, N1, uc);
    if constexpr (TR)
      load_corners(static_cast<const T*>(a.ud), i, j, N0, N1, udc);
    T* own = rows + tid * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) own[r] = T(0);
    column_block<T, TR, true>(a, 0, e, uc, udc, own);
#pragma unroll 1
    for (int w = 1; w < kVars; ++w)
      column_block<T, TR, false>(a, w, e, uc, udc, nullptr);
  }
  // the halo's densities, task k = (h, q): h <= kTb the element (i0 - 1,
  // j0 - 1 + h), else (i0 + h - kTb - 1, j0 - 1)
  for (int k = tid; k < kHalo * Q; k += kThreads) {
    const int h = k / Q, q = k - h * Q;
    const int ha = h <= kTb ? i0 - 1 : i0 + h - kTb - 1;
    const int hb = h <= kTb ? j0 - 1 + h : j0 - 1;
    if (ha >= 0 && ha < N0 && hb >= 0 && hb < N1)
      primal_density<T, TR>(a, ha, hb, q, halo + k * kOuts);
  }
  __syncthreads();

  // node (i, j): the rows of its (up to) four elements, corner 0..3 in
  // order, a halo element's summed over its qps here as an own element's
  // were, as the plain pad+sum version sums
  if (i > N0 || j > N1) return;
  const T* __restrict__ phi = static_cast<const T*>(a.phi);
  const T* __restrict__ grad = static_cast<const T*>(a.grad);
  const T* __restrict__ wts = static_cast<const T*>(a.wts);
  T acc[kVars] = {T(0), T(0), T(0)};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int ea = i - corner_i(c), eb = j - corner_j(c);
    if (ea < 0 || ea >= N0 || eb < 0 || eb >= N1) continue;
    if (ea >= i0 && eb >= j0) {
      const T* r = rows + ((ea - i0) * kTb + eb - j0) * kRows + c;
#pragma unroll
      for (int v = 0; v < kVars; ++v) acc[v] += r[v * 4];
      continue;
    }
    const int h = ea < i0 ? eb - j0 + 1 : kTb + 1 + ea - i0;
    const T* o = halo + h * Q * kOuts;
    T r[kVars] = {T(0), T(0), T(0)};
    for (int q = 0; q < Q; ++q, o += kOuts)
#pragma unroll
      for (int v = 0; v < kVars; ++v)
        r[v] += wts[q] * (phi[c * Q + q] * o[v] +
                          grad[(c * Q + q) * 2 + 0] * o[3 + 2 * v] +
                          grad[(c * Q + q) * 2 + 1] * o[4 + 2 * v]);
#pragma unroll
    for (int v = 0; v < kVars; ++v) acc[v] += r[v];
  }
  const long long nodes = (long long)(N0 + 1) * (N1 + 1);
  T* res = static_cast<T*>(a.res) + (long long)i * (N1 + 1) + j;
#pragma unroll
  for (int v = 0; v < kVars; ++v) res[v * nodes] = acc[v];
}

// what a launch returns where the halo's densities of Q qps do not fit
// the card's shared memory per block (the provider refuses such a Q)
constexpr int kErrSharedMemory = -1;

template <typename T, bool TR>
int launch_case(const NsArgs& a, void* stream) {
  auto kernel = ns_node_full_kernel<T, TR>;
  const size_t smem = sizeof(T) * ns_smem_words(a.Q);
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > (size_t)optin) return kErrSharedMemory;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int tiles_j = (a.N1 + kTb) / kTb;  // ceil((N1 + 1) / kTb)
  const long long tiles = (long long)((a.N0 + kTa) / kTa) * tiles_j;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(a,
                                                                    tiles_j);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const NsArgs* a, void* stream) {
  if (a->Q < 1 || a->N0 < 1 || a->N1 < 1 ||
      (long long)a->N0 * a->N1 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return a->transient ? launch_case<T, true>(*a, stream)
                      : launch_case<T, false>(*a, stream);
}

}  // namespace

// Plain C entry points, bound with ctypes (see ops/_build.py). Each takes
// the host address of an NsArgs and the stream, and returns the
// cudaGetLastError() of its launch (kErrSharedMemory where the halo's
// densities do not fit the card's shared memory).
extern "C" {

int ns_node_full_f64(const void* args, void* stream) {
  return launch<double>(static_cast<const NsArgs*>(args), stream);
}

int ns_node_full_f32(const void* args, void* stream) {
  return launch<float>(static_cast<const NsArgs*>(args), stream);
}

}  // extern "C"
