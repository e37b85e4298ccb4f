// Element-tile assembly of a module set (navier stokes, thermal, cdr in
// any combination, with coefficients that may read the state) on uniform
// 3D hex (p1, nc = 8) and 2D p2 quads (nc = 9), steady or a transient
// stage, for Hopper (sm_90a): the kernel templates `set_elem_full` and
// `set_elem_state`, which functions/codegen.py completes per deck with the
// deck's density (a struct with a static `eval`) and instantiates through
// SET_ELEM_ENTRY_POINTS. The generated source defines SET_NV (the number
// of variables), SET_DIM and SET_NC before including this header.
//
// Replaces: the TPU element-tile kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_call` (:1283-1318, pallas_call at
// :1303; body `FusedP1Assembly._kernel(node=False)`) for module sets
// (`_density`, :293-314, sums the set's qp densities) and for
// coefficients that read the state (`QpCtx.resolve`, :94-106): in mode
// "full" (:1417, set_elem_full) the nd residual rows and the
// element-varying Jacobian rows of every element; in mode "state"
// (:1402, set_elem_state) the nd residual rows of an AFFINE set's state
// part (JAX's split path; as set_node.cuh's set_node_state: the
// densities' derivative along the state, from the u grid alone, u_eval =
// alpha_u u, u_dot = alpha_t u), and no Jacobian. The caller scatters the
// residual rows to the grids
// (pad+sum on the p1 node grid, strided adds on the p2 fine lattice), as
// the JAX package does after its kernel.
//
// Weak form, per element e and quadrature point q, at u_eval = alpha_u u
// + beta_u and u_dot = alpha_t u + beta_t (steady: alpha_u = 1, no
// u_dot): the generated density gives (S_v, F_v) for every variable v;
//   r_(v,c)  = sum_q w_q (phi_c S_v + grad phi_c . F_v);
//   J[(v,c),(w,c')] = sum_q w_q (phi_c T[S_v] + grad phi_c . T[F_v]),
//   T[o] = the derivative of density output o along u_w += alpha_u
//          phi_c', grad u_w += alpha_u grad phi_c', u_dot_w += alpha_t
//          phi_c' (the JAX kernel's column tangents).
// Row k = row*nd + col, row = v*nc + c, col = w*nc + c', nd = nc SET_NV.
// Local dof c of element (I, J[, K]) is grid point stride*(I, J[, K]) +
// off[c] of each variable's grid (stride 1: the p1 node grid; 2: the p2
// fine lattice), as in fused_elem_ns.cu; element e is C-order over the
// element grid, and the qp's coordinates are origin + (I, J[, K]) h +
// q_off[q], as the JAX kernel synthesizes them. Residual row r is stored
// as res[r*E + e]; only the Jacobian rows the host probe classified
// element-varying are stored, as jac[pos*E + e] with pos = row_pos[k] >=
// 0 (the constant rows are the probe's values).
//
// Design: ns_elem_full's scheme (fused_elem_ns.cu). A block owns `elems`
// elements (16, or fewer where the layout of 16 would not fit the card's
// shared memory: any quadrature works) and runs in phases through shared
// memory:
//   1. the reference tables and the elements' corner values (u_eval and,
//      in a stage, u_dot) of all variables;
//   2. one thread per (element, qp): the values, gradients (and u_dot) of
//      all variables at the qp, and the primal density there (in mode
//      "state" its derivative along the state, one Dual<T, 1> pass);
//   3. each thread (element, slot) sums the residual rows slot, slot +
//      slots, ... from the stored densities, then (mode "full") walks the
//      columns slot, slot + slots, ...: a column is one forward pass of the
//      density on Dual<T, 1> at every qp, read from the stored qp state,
//      its nd sums kept in registers and written where the probe says the
//      row varies.
// The shared memory exceeds the 48 KB static limit for the larger sets
// (NS + thermal + cdr on p2 in a stage: 87 KB in f64), so it is dynamic
// and the launch raises the kernel's limit. The sums are deterministic
// (no atomics); any element grid works (the last block masks its missing
// elements); element and row offsets are 64-bit.
//
// What bounds it on the H100: the writes of the Jacobian rows (up to nd^2
// = 2,304 per element for NS + thermal + cdr on hex) against the
// density's operations, which chip_smoke.py counts on the plain version
// (its sparse forward AD) and reports as the bound. No tiling over rows,
// TMA or wgmma yet: this version is the simple, right one.

#pragma once

#include <cuda_runtime.h>

#include "ns_density.cuh"
#include "scalar_density.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kElems = 16;  // elements per block, at most
constexpr int kMaxNc = 9;
constexpr int kMaxScalars = 32;

// The C interface's arguments, filled by ctypes (ops/fused_set.py
// _SetElemArgs).
struct SetArgs {
  const void* ue;       // (SET_NV, G0, G1[, G2]) u_eval grids
  const void* ud;       // the u_dot grids, or null (steady)
  const void* phi;      // (nc, Q)
  const void* grad;     // (nc, Q, dim)
  const void* wts;      // (Q,)
  const int* row_pos;   // (nd*nd,) position of row k in jac, or -1
  void* res;            // (nd, E) residual rows
  void* jac;            // (n_rows, E) Jacobian rows
  double alpha_u, alpha_t, h, tau_dt2;  // tau_dt2 = (C3 / dt)^2
  double origin[3], hax[3];             // the box's origin and spacing
  const double* qoff;                   // (Q, dim) the qps' offsets in an
                                        // element, on the device
  double sc[kMaxScalars];  // t, beta, T_ambient, the deck's parameters
  int Q, stride, N0, N1, N2, n_rows, pspg, supg, transient;
  int off[kMaxNc][3];      // lattice offset of local dof c (axis 2: 0 in
                           // 2D)
};

struct ElemGeometry {
  int N1, N2;      // element grid axes 1, 2 (N2 = 1 in 2D)
  int G1, G2;      // grid axes 1 and 2 (G2 = 1 in 2D)
  long long G;     // points of one variable's grid
  long long E;
};

// element e's index on each axis (K = 0 in 2D)
__device__ __forceinline__ void elem_index(const ElemGeometry& g,
                                           long long e, int idx[3]) {
  idx[2] = (int)(e % g.N2);
  const long long r = e / g.N2;
  idx[1] = (int)(r % g.N1);
  idx[0] = (int)(r / g.N1);
}

// the generated density at a qp of coordinates xq
template <bool TR, int DIM, class Dens, typename S, int NV>
__device__ __forceinline__ void eval_density(
    const S (&u)[NV], const S (&ud)[NV], const S (&g)[NV][DIM],
    const typename Passive<S>::type (&xq)[DIM], const SetArgs& a,
    S (&out)[NV * (1 + DIM)]) {
  if constexpr (DIM == 3)
    Dens::template eval<TR, S>(u, ud, g, xq[0], xq[1], xq[2], a, out);
  else
    Dens::template eval<TR, S>(u, ud, g, xq[0], xq[1], a, out);
}

// shared memory of a block of `elems` elements, in T: tables phi (NC*Q),
// grad (NC*Q*DIM), wts (Q); the corner values (elems x NS0 x ND); the qp
// state u, g[, ud] (elems x Q x NQ); the primal densities (elems x Q x
// NO). ops/_launch.py `elem_smem_words` is the same formula.
template <int DIM, int NC, int NV, bool TR>
struct SetElemLayout {
  static constexpr int ND = NV * NC, NO = NV * (1 + DIM);
  static constexpr int NS0 = TR ? 2 : 1;            // u_eval [, u_dot]
  static constexpr int NQ = NV * (1 + DIM) + (TR ? NV : 0);
  __host__ __device__ static long long tables(int Q) {
    return (long long)NC * Q * (1 + DIM) + Q;
  }
  __host__ __device__ static long long corners(int elems) {
    return (long long)elems * NS0 * ND;
  }
  __host__ __device__ static long long total(int Q, int elems) {
    return tables(Q) + corners(elems) + (long long)elems * Q * (NQ + NO);
  }
};

template <typename T, bool TR, int DIM, int NC, int NV, class Dens,
          bool LIN>
__global__ void __launch_bounds__(kThreads)
    set_elem_full_kernel(const SetArgs a, const ElemGeometry geo,
                         const int elems) {
  using L = SetElemLayout<DIM, NC, NV, TR>;
  constexpr int ND = L::ND, NO = L::NO, NQ = L::NQ;
  using D = Dual<T, 1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int Q = a.Q;
  T* phi = s;
  T* grad = phi + NC * Q;
  T* wts = grad + NC * Q * DIM;
  T* corner = s + L::tables(Q);
  T* qst = corner + L::corners(elems);
  T* qout = qst + (long long)elems * Q * NQ;
  const int tid = threadIdx.x, slots = kThreads / elems;
  const long long e0 = (long long)blockIdx.x * elems;

  // phase 1: tables and corner values
  {
    const T* phi_g = static_cast<const T*>(a.phi);
    const T* grad_g = static_cast<const T*>(a.grad);
    const T* wts_g = static_cast<const T*>(a.wts);
    const int n = L::tables(Q), na = NC * Q, nb = NC * Q * DIM;
    for (int i = tid; i < n; i += kThreads)
      s[i] = i < na ? phi_g[i]
                    : (i < na + nb ? grad_g[i - na] : wts_g[i - na - nb]);
  }
  for (int i = tid; i < L::corners(elems); i += kThreads) {
    const int le = i / (L::NS0 * ND), rest = i % (L::NS0 * ND);
    const int which = rest / ND, k = rest % ND;
    const long long e = e0 + le;
    T val = T(0);
    if (e < geo.E) {
      // mode "state" reads the u grid alone, as alpha_u u [, alpha_t u]
      const T* grid = static_cast<const T*>(which && !LIN ? a.ud : a.ue);
      int idx[3];
      elem_index(geo, e, idx);
      const int c = k % NC, p = a.stride;
      const long long gi = (long long)(p * idx[0] + a.off[c][0]) * geo.G1 +
                           (p * idx[1] + a.off[c][1]);
      val = grid[(k / NC) * geo.G + gi * geo.G2 + p * idx[2] +
                 a.off[c][2]];
      if constexpr (LIN) val = T(which ? a.alpha_t : a.alpha_u) * val;
    }
    corner[i] = val;
  }
  __syncthreads();

  // phase 2: the qp state and the primal density (mode "state": its
  // derivative along the state) per (element, qp)
  for (int i = tid; i < elems * Q; i += kThreads) {
    const int le = i / Q, q = i % Q;
    const long long e = e0 + le;
    if (e >= geo.E) continue;
    const T* uc = corner + le * L::NS0 * ND;
    T u[NV], ud[NV], g[NV][DIM], out[NO];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      T val = T(0), dot = T(0), gd[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) gd[d] = T(0);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const T x = uc[v * NC + c];
        val += phi[c * Q + q] * x;
#pragma unroll
        for (int d = 0; d < DIM; ++d) gd[d] += grad[(c * Q + q) * DIM + d] * x;
        if constexpr (TR) dot += phi[c * Q + q] * uc[ND + v * NC + c];
      }
      u[v] = val;
      ud[v] = dot;
#pragma unroll
      for (int d = 0; d < DIM; ++d) g[v][d] = gd[d];
    }
    T* st = qst + (le * Q + q) * NQ;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      st[v] = u[v];
#pragma unroll
      for (int d = 0; d < DIM; ++d) st[NV + v * DIM + d] = g[v][d];
      if constexpr (TR) st[NV * (1 + DIM) + v] = ud[v];
    }
    int idx[3];
    elem_index(geo, e, idx);
    T xq[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      xq[d] = (T(a.origin[d]) + T(idx[d]) * T(a.hax[d])) +
              T(a.qoff[DIM * q + d]);
    if constexpr (LIN) {
      D zu[NV], zud[NV], zg[NV][DIM], zo[NO];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        zu[v].v = zu[v].d[0] = u[v];
        zud[v].v = zud[v].d[0] = ud[v];
#pragma unroll
        for (int d = 0; d < DIM; ++d) zg[v][d].v = zg[v][d].d[0] = g[v][d];
      }
      eval_density<TR, DIM, Dens>(zu, zud, zg, xq, a, zo);
#pragma unroll
      for (int k = 0; k < NO; ++k) out[k] = zo[k].d[0];
    } else {
      eval_density<TR, DIM, Dens>(u, ud, g, xq, a, out);
    }
    T* o = qout + (le * Q + q) * NO;
#pragma unroll
    for (int k = 0; k < NO; ++k) o[k] = out[k];
  }
  __syncthreads();

  const int le = tid % elems, slot = tid / elems;
  const long long e = e0 + le;
  if (e >= geo.E) return;

  // phase 3a: residual rows slot, slot + slots, ...
  T* res = static_cast<T*>(a.res);
#pragma unroll 1
  for (int r = slot; r < ND; r += slots) {
    const int v = r / NC, c = r % NC;
    T acc = T(0);
    for (int q = 0; q < Q; ++q) {
      const T* o = qout + (le * Q + q) * NO;
      T t = phi[c * Q + q] * o[v];
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        t += grad[(c * Q + q) * DIM + d] * o[NV + v * DIM + d];
      acc += wts[q] * t;
    }
    res[(long long)r * geo.E + e] = acc;
  }
  if (LIN || a.n_rows == 0) return;

  // phase 3b: Jacobian columns slot, slot + slots, ...
  int idx[3];
  elem_index(geo, e, idx);
  T* jac = static_cast<T*>(a.jac);
  const T au = T(a.alpha_u), at = T(a.alpha_t);
#pragma unroll 1
  for (int col = slot; col < ND; col += slots) {
    const int w = col / NC, cp = col % NC;
    T J[ND];
#pragma unroll
    for (int r = 0; r < ND; ++r) J[r] = T(0);
    for (int q = 0; q < Q; ++q) {
      const T* st = qst + (le * Q + q) * NQ;
      const T pcp = phi[cp * Q + q];
      D u[NV], ud[NV], g[NV][DIM], out[NO];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const bool on = v == w;
        u[v].v = st[v];
        u[v].d[0] = on ? au * pcp : T(0);
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          g[v][d].v = st[NV + v * DIM + d];
          g[v][d].d[0] = on ? au * grad[(cp * Q + q) * DIM + d] : T(0);
        }
        ud[v].v = TR ? st[NV * (1 + DIM) + v] : T(0);
        ud[v].d[0] = (TR && on) ? at * pcp : T(0);
      }
      T xq[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        xq[d] = (T(a.origin[d]) + T(idx[d]) * T(a.hax[d])) +
                T(a.qoff[DIM * q + d]);
      eval_density<TR, DIM, Dens>(u, ud, g, xq, a, out);
      const T wq = wts[q];
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          T t = phi[c * Q + q] * out[v].d[0];
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            t += grad[(c * Q + q) * DIM + d] * out[NV + v * DIM + d].d[0];
          J[v * NC + c] += wq * t;
        }
    }
#pragma unroll
    for (int r = 0; r < ND; ++r) {
      const int pos = __ldg(a.row_pos + r * ND + col);
      if (pos >= 0) jac[(long long)pos * geo.E + e] = J[r];
    }
  }
}

// The elements per block: the most (16, 8, ..., 1) whose layout fits the
// card's opt-in shared memory per block, and that layout's bytes; 0 where
// one element does not fit.
template <typename T, int DIM, int NC, int NV, bool TR>
int set_elem_elems(int Q, long long optin, size_t* smem) {
  for (int elems = kElems; elems >= 1; elems /= 2) {
    const long long bytes =
        (long long)sizeof(T) * SetElemLayout<DIM, NC, NV, TR>::total(Q, elems);
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

template <typename T, bool TR, int DIM, int NC, int NV, class Dens, bool LIN>
int set_elem_launch_case(const SetArgs& a, const ElemGeometry& geo,
                         void* stream) {
  auto kernel = set_elem_full_kernel<T, TR, DIM, NC, NV, Dens, LIN>;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  size_t smem = 0;
  const int elems = set_elem_elems<T, DIM, NC, NV, TR>(a.Q, optin, &smem);
  if (elems == 0) return kErrSharedMemory;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (geo.E + elems - 1) / elems;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a, geo,
                                                                    elems);
  return (int)cudaGetLastError();
}

template <typename T, int DIM, int NC, int NV, class Dens, bool LIN>
int set_elem_launch(const SetArgs* a, void* stream) {
  if (a->Q < 1 || a->N0 < 1 || a->N1 < 1 || a->N2 < 1 ||
      (DIM == 2 && a->N2 != 1) || a->stride < 1)
    return (int)cudaErrorInvalidValue;
  ElemGeometry geo;
  geo.N1 = a->N1;
  geo.N2 = DIM == 3 ? a->N2 : 1;
  geo.G1 = a->stride * a->N1 + 1;
  geo.G2 = DIM == 3 ? a->stride * a->N2 + 1 : 1;
  geo.G = (long long)(a->stride * a->N0 + 1) * geo.G1 * geo.G2;
  geo.E = (long long)a->N0 * a->N1 * geo.N2;
  return a->transient
             ? set_elem_launch_case<T, true, DIM, NC, NV, Dens, LIN>(*a, geo,
                                                                     stream)
             : set_elem_launch_case<T, false, DIM, NC, NV, Dens, LIN>(
                   *a, geo, stream);
}

}  // namespace

// Plain C entry points of a generated library, bound with ctypes (see
// ops/_build.py load_generated): each takes the host address of a SetArgs
// and the stream, and returns the cudaGetLastError() of its launch, or
// kErrSharedMemory. set_elem_state reads a.ue (the u grid) and writes
// a.res only.
#define SET_ELEM_ENTRY_POINTS(DENS)                                      \
  extern "C" int set_elem_full_f64(const void* args, void* stream) {     \
    return set_elem_launch<double, SET_DIM, SET_NC, SET_NV, DENS, false>( \
        static_cast<const SetArgs*>(args), stream);                      \
  }                                                                      \
  extern "C" int set_elem_full_f32(const void* args, void* stream) {     \
    return set_elem_launch<float, SET_DIM, SET_NC, SET_NV, DENS, false>(  \
        static_cast<const SetArgs*>(args), stream);                      \
  }                                                                      \
  extern "C" int set_elem_state_f64(const void* args, void* stream) {    \
    return set_elem_launch<double, SET_DIM, SET_NC, SET_NV, DENS, true>(  \
        static_cast<const SetArgs*>(args), stream);                      \
  }                                                                      \
  extern "C" int set_elem_state_f32(const void* args, void* stream) {    \
    return set_elem_launch<float, SET_DIM, SET_NC, SET_NV, DENS, true>(   \
        static_cast<const SetArgs*>(args), stream);                      \
  }
