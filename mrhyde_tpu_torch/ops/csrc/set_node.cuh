// Node-scatter assembly of a module set (navier stokes, thermal, cdr in
// any combination, with coefficients that may read the state) on uniform
// 2D p1 quads, steady or a transient stage, for Hopper (sm_90a): the
// kernel template `set_node_full`, which functions/codegen.py completes
// per deck with the deck's density (a struct with a static `eval`) and
// instantiates through SET_NODE_ENTRY_POINTS. The generated source
// defines SET_NV, the number of variables, before including this header.
//
// Replaces: the TPU node-scatter kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_node_call` (:1320-1379, pallas_call at
// :1350; body `FusedP1Assembly._kernel(node=True)`), in mode "full" for
// module sets (`_density`, :293-314, sums the set's qp densities) and for
// coefficients that read the state (`QpCtx.resolve`, :94-106): the
// node-scattered residual and the element-varying Jacobian rows.
//
// Weak form, per element e and quadrature point q, at u_eval = alpha_u u
// + beta_u and u_dot = alpha_t u + beta_t (steady: alpha_u = 1, no
// u_dot): the generated density gives (S_v, F_v) for every variable v;
//   r_(v,c)  = sum_q w_q (phi_c S_v + grad phi_c . F_v), summed to the
//              node of corner c over its (up to) four elements;
//   J[(v,c),(w,c')] = sum_q w_q (phi_c T[S_v] + grad phi_c . T[F_v]),
//   T[o] = the derivative of density output o along u_w += alpha_u
//          phi_c', grad u_w += alpha_u grad phi_c', u_dot_w += alpha_t
//          phi_c' (the JAX kernel's column tangents).
// Row k = row*nd + col, row = v*4 + c, col = w*4 + c', nd = 4 SET_NV,
// corners (0,0),(1,0),(1,1),(0,1) on (axis 0, axis 1); the qp's
// coordinates are origin + (I, J) h + q_off[q], as the JAX kernel
// synthesizes them. Only the rows the host probe classified
// element-varying are stored, as jac[pos*E + e] with pos = row_pos[k] >=
// 0; the constant rows are the probe's values.
//
// Design. One launch holds two roles, split by block index:
//   residual blocks: one thread per node, as fused_p1_ns.cu's: it gathers
//     the corner values of its (up to) four elements, evaluates the
//     primal density at their quadrature points and sums their
//     contributions to itself in a fixed order: no atomics.
//   Jacobian blocks: ns_elem_full's scheme (fused_elem_ns.cu). A block
//     owns kElems elements; the tables, the corner values and the qp
//     state of all variables go to shared memory; then each thread
//     (element, slot) walks the columns slot, slot + kSlots, ...: a
//     column is one forward pass of the density on Dual<T, 1> at every
//     qp, its nd sums kept in registers and written where the probe says
//     the row varies. One tangent per pass keeps the registers of nd =
//     16-20 columns in bounds, where ns_node_full's Dual<T, 4> per
//     column variable would spill.
// Mesh edges are masked by index; any N0, N1 >= 1 works; offsets are
// 64-bit.
//
// What bounds it on the H100: the writes of the Jacobian rows (up to nd^2
// = 400 per element) against the density's operations, which chip_smoke.py
// counts on the plain version (its sparse forward AD) and reports as the
// bound. No tiling over rows, TMA or wgmma yet: this version is the
// simple, right one.

#pragma once

#include <cuda_runtime.h>

#include "ns_density.cuh"
#include "scalar_density.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kElems = 16;                  // elements per Jacobian block
constexpr int kSlots = kThreads / kElems;   // threads per element
constexpr int kMaxQ = 16;
constexpr int kMaxScalars = 32;

// The C interface's arguments, filled by ctypes (ops/fused_set.py
// _SetArgs).
struct SetArgs {
  const void* ue;       // (SET_NV, N0+1, N1+1) u_eval grids
  const void* ud;       // the u_dot grids, or null (steady)
  const void* phi;      // (4, Q)
  const void* grad;     // (4, Q, 2)
  const void* wts;      // (Q,)
  const int* row_pos;   // (nd*nd,) position of row k in jac, or -1
  void* res;            // (SET_NV, N0+1, N1+1) node residual
  void* jac;            // (n_rows, E) Jacobian rows
  double alpha_u, alpha_t, h, tau_dt2;  // tau_dt2 = (C3 / dt)^2
  double origin[2], hax[2];             // the box's origin and spacing
  double qoff[kMaxQ][2];                // the qps' offsets in an element
  double sc[kMaxScalars];  // t, beta, T_ambient, the deck's parameters
  int Q, N0, N1, n_rows, pspg, supg, transient;
};

__device__ __forceinline__ int corner_i(int c) { return (c == 1 || c == 2); }
__device__ __forceinline__ int corner_j(int c) { return (c >= 2); }

// residual role: node n = (i, j) sums the rows of its corners
template <typename T, bool TR, int NV, class Dens>
__device__ __forceinline__ void set_residual_node(const SetArgs& a,
                                                  long long n) {
  const int N0 = a.N0, N1 = a.N1, Q = a.Q;
  const long long nodes = (long long)(N0 + 1) * (N1 + 1);
  if (n >= nodes) return;
  const T* __restrict__ ue = static_cast<const T*>(a.ue);
  const T* __restrict__ udg = static_cast<const T*>(a.ud);
  const T* __restrict__ phi = static_cast<const T*>(a.phi);
  const T* __restrict__ grad = static_cast<const T*>(a.grad);
  const T* __restrict__ wts = static_cast<const T*>(a.wts);
  const int i = (int)(n / (N1 + 1)), j = (int)(n % (N1 + 1));
  T acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = T(0);
#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    // node (i, j) is corner c of element (ea, eb)
    const int ea = i - corner_i(c), eb = j - corner_j(c);
    if (ea < 0 || ea >= N0 || eb < 0 || eb >= N1) continue;
    T uc[NV][4], udc[NV][4];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long p = v * nodes +
                            (long long)(ea + corner_i(k)) * (N1 + 1) + eb +
                            corner_j(k);
        uc[v][k] = ue[p];
        udc[v][k] = TR ? udg[p] : T(0);
      }
    T r[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) r[v] = T(0);
    for (int q = 0; q < Q; ++q) {
      T u[NV], ud[NV], g[NV][2], out[3 * NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        T s = T(0), s_t = T(0), g0 = T(0), g1 = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s += phi[k * Q + q] * uc[v][k];
          s_t += phi[k * Q + q] * udc[v][k];
          g0 += grad[(k * Q + q) * 2 + 0] * uc[v][k];
          g1 += grad[(k * Q + q) * 2 + 1] * uc[v][k];
        }
        u[v] = s;
        ud[v] = s_t;
        g[v][0] = g0;
        g[v][1] = g1;
      }
      const T x = (T(a.origin[0]) + T(ea) * T(a.hax[0])) + T(a.qoff[q][0]);
      const T y = (T(a.origin[1]) + T(eb) * T(a.hax[1])) + T(a.qoff[q][1]);
      Dens::template eval<TR, T>(u, ud, g, x, y, a, out);
      const T pc = phi[c * Q + q];
      const T g0 = grad[(c * Q + q) * 2 + 0], g1 = grad[(c * Q + q) * 2 + 1];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        r[v] += wts[q] * (pc * out[v] + g0 * out[NV + 2 * v] +
                          g1 * out[NV + 2 * v + 1]);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] += r[v];
  }
  T* __restrict__ res = static_cast<T*>(a.res);
#pragma unroll
  for (int v = 0; v < NV; ++v) res[v * nodes + n] = acc[v];
}

// shared memory of a Jacobian block, in T: tables phi (4Q), grad (8Q),
// wts (Q); the corner values (kElems x NS0 x ND); the qp state u, g[, ud]
// (kElems x Q x NQ)
template <int NV, bool TR>
struct SetLayout {
  static constexpr int ND = 4 * NV;
  static constexpr int NS0 = TR ? 2 : 1;             // u_eval [, u_dot]
  static constexpr int NQ = 3 * NV + (TR ? NV : 0);
  __host__ __device__ static int tables(int Q) { return 13 * Q; }
  __host__ __device__ static int corners() { return kElems * NS0 * ND; }
  __host__ __device__ static int total(int Q) {
    return tables(Q) + corners() + kElems * Q * NQ;
  }
};

// Jacobian role: the columns of kElems elements
template <typename T, bool TR, int NV, class Dens>
__device__ __forceinline__ void set_jacobian_tile(const SetArgs& a,
                                                  long long tile, T* s) {
  using L = SetLayout<NV, TR>;
  constexpr int ND = L::ND, NQ = L::NQ;
  using D = Dual<T, 1>;
  const int Q = a.Q, N1 = a.N1;
  const long long E = (long long)a.N0 * N1;
  const long long nodes = (long long)(a.N0 + 1) * (N1 + 1);
  T* phi = s;
  T* grad = phi + 4 * Q;
  T* wts = grad + 8 * Q;
  T* corner = s + L::tables(Q);
  T* qst = corner + L::corners();
  const int tid = threadIdx.x;
  const long long e0 = tile * kElems;

  // phase 1: tables and corner values
  {
    const T* phi_g = static_cast<const T*>(a.phi);
    const T* grad_g = static_cast<const T*>(a.grad);
    const T* wts_g = static_cast<const T*>(a.wts);
    for (int i = tid; i < 13 * Q; i += kThreads)
      s[i] = i < 4 * Q ? phi_g[i]
                       : (i < 12 * Q ? grad_g[i - 4 * Q] : wts_g[i - 12 * Q]);
  }
  for (int i = tid; i < L::corners(); i += kThreads) {
    const int le = i / (L::NS0 * ND), rest = i % (L::NS0 * ND);
    const int which = rest / ND, k = rest % ND;
    const long long e = e0 + le;
    T val = T(0);
    if (e < E) {
      const T* grid = static_cast<const T*>(which ? a.ud : a.ue);
      const int ea = (int)(e / N1), eb = (int)(e % N1), c = k % 4;
      val = grid[(k / 4) * nodes + (long long)(ea + corner_i(c)) * (N1 + 1) +
                 eb + corner_j(c)];
    }
    corner[i] = val;
  }
  __syncthreads();

  // phase 2: the qp state per (element, qp)
  for (int i = tid; i < kElems * Q; i += kThreads) {
    const int le = i / Q, q = i % Q;
    const T* uc = corner + le * L::NS0 * ND;
    T* st = qst + (le * Q + q) * NQ;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      T val = T(0), dot = T(0), g0 = T(0), g1 = T(0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T x = uc[v * 4 + c];
        val += phi[c * Q + q] * x;
        g0 += grad[(c * Q + q) * 2 + 0] * x;
        g1 += grad[(c * Q + q) * 2 + 1] * x;
        if constexpr (TR) dot += phi[c * Q + q] * uc[ND + v * 4 + c];
      }
      st[v] = val;
      st[NV + 2 * v] = g0;
      st[NV + 2 * v + 1] = g1;
      if constexpr (TR) st[3 * NV + v] = dot;
    }
  }
  __syncthreads();

  const int le = tid % kElems, slot = tid / kElems;
  const long long e = e0 + le;
  if (e >= E) return;
  const int ea = (int)(e / N1), eb = (int)(e % N1);
  T* jac = static_cast<T*>(a.jac);
  const T au = T(a.alpha_u), at = T(a.alpha_t);
#pragma unroll 1
  for (int col = slot; col < ND; col += kSlots) {
    const int w = col / 4, cp = col % 4;
    T J[ND];
#pragma unroll
    for (int r = 0; r < ND; ++r) J[r] = T(0);
    for (int q = 0; q < Q; ++q) {
      const T* st = qst + (le * Q + q) * NQ;
      const T pcp = phi[cp * Q + q];
      D u[NV], ud[NV], g[NV][2], out[3 * NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const bool on = v == w;
        u[v].v = st[v];
        u[v].d[0] = on ? au * pcp : T(0);
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          g[v][d].v = st[NV + 2 * v + d];
          g[v][d].d[0] = on ? au * grad[(cp * Q + q) * 2 + d] : T(0);
        }
        ud[v].v = TR ? st[3 * NV + v] : T(0);
        ud[v].d[0] = (TR && on) ? at * pcp : T(0);
      }
      const T x = (T(a.origin[0]) + T(ea) * T(a.hax[0])) + T(a.qoff[q][0]);
      const T y = (T(a.origin[1]) + T(eb) * T(a.hax[1])) + T(a.qoff[q][1]);
      Dens::template eval<TR, D>(u, ud, g, x, y, a, out);
      const T wq = wts[q];
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const T t = phi[c * Q + q] * out[v].d[0] +
                      grad[(c * Q + q) * 2 + 0] * out[NV + 2 * v].d[0] +
                      grad[(c * Q + q) * 2 + 1] * out[NV + 2 * v + 1].d[0];
          J[v * 4 + c] += wq * t;
        }
    }
#pragma unroll
    for (int r = 0; r < ND; ++r) {
      const int pos = __ldg(a.row_pos + r * ND + col);
      if (pos >= 0) jac[(long long)pos * E + e] = J[r];
    }
  }
}

template <typename T, bool TR, int NV, class Dens>
__global__ void __launch_bounds__(kThreads)
    set_node_full_kernel(const SetArgs a, const long long res_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x < res_blocks) {
    set_residual_node<T, TR, NV, Dens>(
        a, (long long)blockIdx.x * kThreads + threadIdx.x);
    return;
  }
  set_jacobian_tile<T, TR, NV, Dens>(a, (long long)blockIdx.x - res_blocks,
                                     reinterpret_cast<T*>(smem_raw));
}

template <typename T, bool TR, int NV, class Dens>
int set_launch_case(const SetArgs& a, void* stream) {
  auto kernel = set_node_full_kernel<T, TR, NV, Dens>;
  const size_t smem = sizeof(T) * (size_t)SetLayout<NV, TR>::total(a.Q);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long nodes = (long long)(a.N0 + 1) * (a.N1 + 1);
  const long long E = (long long)a.N0 * a.N1;
  const long long res_blocks = (nodes + kThreads - 1) / kThreads;
  const long long jac_blocks = a.n_rows > 0 ? (E + kElems - 1) / kElems : 0;
  kernel<<<(unsigned)(res_blocks + jac_blocks), kThreads, smem,
           (cudaStream_t)stream>>>(a, res_blocks);
  return (int)cudaGetLastError();
}

template <typename T, int NV, class Dens>
int set_launch(const SetArgs* a, void* stream) {
  if (a->Q < 1 || a->Q > kMaxQ || a->N0 < 1 || a->N1 < 1)
    return (int)cudaErrorInvalidValue;
  return a->transient ? set_launch_case<T, true, NV, Dens>(*a, stream)
                      : set_launch_case<T, false, NV, Dens>(*a, stream);
}

}  // namespace

// Plain C entry points of a generated library, bound with ctypes (see
// ops/_build.py load_generated): each takes the host address of a SetArgs
// and the stream, and returns the cudaGetLastError() of its launch.
#define SET_NODE_ENTRY_POINTS(DENS)                                     \
  extern "C" int set_node_full_f64(const void* args, void* stream) {    \
    return set_launch<double, SET_NV, DENS>(                            \
        static_cast<const SetArgs*>(args), stream);                     \
  }                                                                     \
  extern "C" int set_node_full_f32(const void* args, void* stream) {    \
    return set_launch<float, SET_NV, DENS>(                             \
        static_cast<const SetArgs*>(args), stream);                     \
  }
