// Node-scatter assembly of a module set (navier stokes, thermal, cdr in
// any combination, with coefficients that may read the state) on uniform
// 2D p1 quads, steady or a transient stage, for Hopper (sm_90a): the
// kernel templates `set_node_full` and `set_node_state`, which
// functions/codegen.py completes per deck with the deck's density (a
// struct with a static `eval`) and instantiates through
// SET_NODE_ENTRY_POINTS. The generated source defines SET_NV, the number
// of variables, before including this header.
//
// Replaces: the TPU node-scatter kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_node_call` (:1320-1379, pallas_call at
// :1350; body `FusedP1Assembly._kernel(node=True)`) for module sets
// (`_density`, :293-314, sums the set's qp densities) and for
// coefficients that read the state (`QpCtx.resolve`, :94-106): in mode
// "full" (:1414, set_node_full) the node-scattered residual and the
// element-varying Jacobian rows; in mode "state" (:1400, set_node_state)
// the state part of an AFFINE set's residual (JAX's split path), node-
// scattered, and no Jacobian.
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
// Mode "state" (JAX's `_accumulate` mode "lin", :330-345): the kernel
// reads the u grid alone, u_eval = alpha_u u and u_dot = alpha_t u (no
// betas; steady: u, no u_dot), and replaces each density output o by its
// directional derivative along the state, sum_k (d o / d z_k) z_k over
// the qp state z = (u, u_dot, grad u): one Dual<T, 1> pass whose value
// and tangent are both z. For an affine density that is the state part;
// the state-independent rest (the density at the betas and the Jacobian)
// is the provider's plain-torch coord part.
//
// Design. One launch holds two roles, split by block index:
//   residual blocks: one thread per node, as fused_p1_ns.cu's: it gathers
//     the corner values of its (up to) four elements, evaluates the
//     primal density at their quadrature points and sums their
//     contributions to itself in a fixed order: no atomics.
//   Jacobian blocks: ns_elem_full's scheme (fused_elem_ns.cu). A block
//     owns `elems` elements (16, or fewer where the layout of 16 would
//     not fit the card's shared memory: any quadrature works); the
//     tables, the corner values and the qp state of all variables go to
//     shared memory; then each thread
//     (element, slot) walks the columns slot, slot + slots, ...: a
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
constexpr int kElems = 16;  // elements per Jacobian block, at most
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
  const double* qoff;                   // (Q, 2) the qps' offsets in an
                                        // element, on the device
  double sc[kMaxScalars];  // t, beta, T_ambient, the deck's parameters
  int Q, N0, N1, n_rows, pspg, supg, transient;
};

__device__ __forceinline__ int corner_i(int c) { return (c == 1 || c == 2); }
__device__ __forceinline__ int corner_j(int c) { return (c >= 2); }

// residual role: node n = (i, j) sums the rows of its corners; LIN: the
// state part of mode "state" (the densities' derivative along the state,
// from the u grid alone)
template <typename T, bool TR, int NV, class Dens, bool LIN>
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
        if constexpr (LIN) {
          uc[v][k] = T(a.alpha_u) * ue[p];
          udc[v][k] = T(a.alpha_t) * ue[p];
        } else {
          uc[v][k] = ue[p];
          udc[v][k] = TR ? udg[p] : T(0);
        }
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
      const T x =
          (T(a.origin[0]) + T(ea) * T(a.hax[0])) + T(a.qoff[2 * q + 0]);
      const T y =
          (T(a.origin[1]) + T(eb) * T(a.hax[1])) + T(a.qoff[2 * q + 1]);
      if constexpr (LIN) {
        using D = Dual<T, 1>;
        D zu[NV], zud[NV], zg[NV][2], zo[3 * NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          zu[v].v = zu[v].d[0] = u[v];
          zud[v].v = zud[v].d[0] = ud[v];
#pragma unroll
          for (int d = 0; d < 2; ++d) zg[v][d].v = zg[v][d].d[0] = g[v][d];
        }
        Dens::template eval<TR, D>(zu, zud, zg, x, y, a, zo);
#pragma unroll
        for (int k = 0; k < 3 * NV; ++k) out[k] = zo[k].d[0];
      } else {
        Dens::template eval<TR, T>(u, ud, g, x, y, a, out);
      }
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

// shared memory of a Jacobian block of `elems` elements, in T: tables phi
// (4Q), grad (8Q), wts (Q); the corner values (elems x NS0 x ND); the qp
// state u, g[, ud] (elems x Q x NQ). ops/_launch.py `node_smem_words`
// is the same formula.
template <int NV, bool TR>
struct SetLayout {
  static constexpr int ND = 4 * NV;
  static constexpr int NS0 = TR ? 2 : 1;             // u_eval [, u_dot]
  static constexpr int NQ = 3 * NV + (TR ? NV : 0);
  __host__ __device__ static long long tables(int Q) { return 13LL * Q; }
  __host__ __device__ static long long corners(int elems) {
    return (long long)elems * NS0 * ND;
  }
  __host__ __device__ static long long total(int Q, int elems) {
    return tables(Q) + corners(elems) + (long long)elems * Q * NQ;
  }
};

// Jacobian role: the columns of `elems` elements
template <typename T, bool TR, int NV, class Dens>
__device__ __forceinline__ void set_jacobian_tile(const SetArgs& a,
                                                  long long tile, T* s,
                                                  const int elems) {
  using L = SetLayout<NV, TR>;
  constexpr int ND = L::ND, NQ = L::NQ;
  using D = Dual<T, 1>;
  const int Q = a.Q, N1 = a.N1, slots = kThreads / elems;
  const long long E = (long long)a.N0 * N1;
  const long long nodes = (long long)(a.N0 + 1) * (N1 + 1);
  T* phi = s;
  T* grad = phi + 4 * Q;
  T* wts = grad + 8 * Q;
  T* corner = s + L::tables(Q);
  T* qst = corner + L::corners(elems);
  const int tid = threadIdx.x;
  const long long e0 = tile * elems;

  // phase 1: tables and corner values
  {
    const T* phi_g = static_cast<const T*>(a.phi);
    const T* grad_g = static_cast<const T*>(a.grad);
    const T* wts_g = static_cast<const T*>(a.wts);
    for (int i = tid; i < 13 * Q; i += kThreads)
      s[i] = i < 4 * Q ? phi_g[i]
                       : (i < 12 * Q ? grad_g[i - 4 * Q] : wts_g[i - 12 * Q]);
  }
  for (int i = tid; i < L::corners(elems); i += kThreads) {
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
  for (int i = tid; i < elems * Q; i += kThreads) {
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

  const int le = tid % elems, slot = tid / elems;
  const long long e = e0 + le;
  if (e >= E) return;
  const int ea = (int)(e / N1), eb = (int)(e % N1);
  T* jac = static_cast<T*>(a.jac);
  const T au = T(a.alpha_u), at = T(a.alpha_t);
#pragma unroll 1
  for (int col = slot; col < ND; col += slots) {
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
      const T x =
          (T(a.origin[0]) + T(ea) * T(a.hax[0])) + T(a.qoff[2 * q + 0]);
      const T y =
          (T(a.origin[1]) + T(eb) * T(a.hax[1])) + T(a.qoff[2 * q + 1]);
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

template <typename T, bool TR, int NV, class Dens, bool LIN>
__global__ void __launch_bounds__(kThreads)
    set_node_full_kernel(const SetArgs a, const long long res_blocks,
                         const int elems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x < res_blocks) {
    set_residual_node<T, TR, NV, Dens, LIN>(
        a, (long long)blockIdx.x * kThreads + threadIdx.x);
    return;
  }
  if constexpr (!LIN)
    set_jacobian_tile<T, TR, NV, Dens>(a, (long long)blockIdx.x - res_blocks,
                                       reinterpret_cast<T*>(smem_raw), elems);
}

// The elements per Jacobian block: the most (16, 8, ..., 1) whose layout
// fits the card's opt-in shared memory per block, and that layout's
// bytes; 0 where one element does not fit.
template <typename T, int NV, bool TR>
int set_node_elems(int Q, long long optin, size_t* smem) {
  for (int elems = kElems; elems >= 1; elems /= 2) {
    const long long bytes =
        (long long)sizeof(T) * SetLayout<NV, TR>::total(Q, elems);
    if (bytes <= optin) {
      *smem = (size_t)bytes;
      return elems;
    }
  }
  return 0;
}

// what a launch returns where the qp state of one element does not fit
// the card's shared memory (ops/fused_set.py raises on it)
constexpr int kErrSharedMemory = -1;

template <typename T, bool TR, int NV, class Dens, bool LIN>
int set_launch_case(const SetArgs& a, void* stream) {
  auto kernel = set_node_full_kernel<T, TR, NV, Dens, LIN>;
  const long long nodes = (long long)(a.N0 + 1) * (a.N1 + 1);
  const long long E = (long long)a.N0 * a.N1;
  const long long res_blocks = (nodes + kThreads - 1) / kThreads;
  size_t smem = 0;
  int elems = kElems;
  long long jac_blocks = 0;
  if (!LIN && a.n_rows > 0) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    elems = set_node_elems<T, NV, TR>(a.Q, optin, &smem);
    if (elems == 0) return kErrSharedMemory;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    jac_blocks = (E + elems - 1) / elems;
  }
  kernel<<<(unsigned)(res_blocks + jac_blocks), kThreads, smem,
           (cudaStream_t)stream>>>(a, res_blocks, elems);
  return (int)cudaGetLastError();
}

template <typename T, int NV, class Dens, bool LIN>
int set_launch(const SetArgs* a, void* stream) {
  if (a->Q < 1 || a->N0 < 1 || a->N1 < 1) return (int)cudaErrorInvalidValue;
  return a->transient
             ? set_launch_case<T, true, NV, Dens, LIN>(*a, stream)
             : set_launch_case<T, false, NV, Dens, LIN>(*a, stream);
}

}  // namespace

// Plain C entry points of a generated library, bound with ctypes (see
// ops/_build.py load_generated): each takes the host address of a SetArgs
// and the stream, and returns the cudaGetLastError() of its launch, or
// kErrSharedMemory. set_node_state reads a.ue (the u grid) and writes
// a.res only.
#define SET_NODE_ENTRY_POINTS(DENS)                                     \
  extern "C" int set_node_full_f64(const void* args, void* stream) {    \
    return set_launch<double, SET_NV, DENS, false>(                     \
        static_cast<const SetArgs*>(args), stream);                     \
  }                                                                     \
  extern "C" int set_node_full_f32(const void* args, void* stream) {    \
    return set_launch<float, SET_NV, DENS, false>(                      \
        static_cast<const SetArgs*>(args), stream);                     \
  }                                                                     \
  extern "C" int set_node_state_f64(const void* args, void* stream) {   \
    return set_launch<double, SET_NV, DENS, true>(                      \
        static_cast<const SetArgs*>(args), stream);                     \
  }                                                                     \
  extern "C" int set_node_state_f32(const void* args, void* stream) {   \
    return set_launch<float, SET_NV, DENS, true>(                       \
        static_cast<const SetArgs*>(args), stream);                     \
  }
