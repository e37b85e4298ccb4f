// Element-tile assembly of a module set (navier stokes, thermal, cdr in
// any combination, with coefficients that may read the state) on uniform
// 3D hex (p1, nc = 8) and 2D p2 quads (nc = 9), steady or a transient
// stage, for Hopper (sm_90a): the kernel template `set_elem_full`, which
// functions/codegen.py completes per deck with the deck's density (a
// struct with a static `eval`) and instantiates through
// SET_ELEM_ENTRY_POINTS. The generated source defines SET_NV (the number
// of variables), SET_DIM and SET_NC before including this header.
//
// Replaces: the TPU element-tile kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_call` (:1283-1318, pallas_call at
// :1303; body `FusedP1Assembly._kernel(node=False)`), in mode "full"
// (:1417) for module sets (`_density`, :293-314, sums the set's qp
// densities) and for coefficients that read the state (`QpCtx.resolve`,
// :94-106): the nd residual rows and the element-varying Jacobian rows
// of every element. The caller scatters the residual rows to the grids
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
// Design: ns_elem_full's scheme (fused_elem_ns.cu). A block owns kElems
// elements and runs in phases through shared memory:
//   1. the reference tables and the elements' corner values (u_eval and,
//      in a stage, u_dot) of all variables;
//   2. one thread per (element, qp): the values, gradients (and u_dot) of
//      all variables at the qp, and the primal density there;
//   3. each thread (element, slot) sums the residual rows slot, slot +
//      kSlots, ... from the stored densities, then walks the columns
//      slot, slot + kSlots, ...: a column is one forward pass of the
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
constexpr int kElems = 16;                  // elements per block
constexpr int kSlots = kThreads / kElems;   // threads per element
constexpr int kMaxQ = 27;
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
  double qoff[kMaxQ][3];                // the qps' offsets in an element
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

// shared memory, in T: tables phi (NC*Q), grad (NC*Q*DIM), wts (Q); the
// corner values (kElems x NS0 x ND); the qp state u, g[, ud] (kElems x Q
// x NQ); the primal densities (kElems x Q x NO)
template <int DIM, int NC, int NV, bool TR>
struct SetElemLayout {
  static constexpr int ND = NV * NC, NO = NV * (1 + DIM);
  static constexpr int NS0 = TR ? 2 : 1;            // u_eval [, u_dot]
  static constexpr int NQ = NV * (1 + DIM) + (TR ? NV : 0);
  __host__ __device__ static int tables(int Q) {
    return NC * Q * (1 + DIM) + Q;
  }
  __host__ __device__ static int corners() { return kElems * NS0 * ND; }
  __host__ __device__ static int total(int Q) {
    return tables(Q) + corners() + kElems * Q * (NQ + NO);
  }
};

template <typename T, bool TR, int DIM, int NC, int NV, class Dens>
__global__ void __launch_bounds__(kThreads)
    set_elem_full_kernel(const SetArgs a, const ElemGeometry geo) {
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
  T* qst = corner + L::corners();
  T* qout = qst + kElems * Q * NQ;
  const int tid = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * kElems;

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
  for (int i = tid; i < L::corners(); i += kThreads) {
    const int le = i / (L::NS0 * ND), rest = i % (L::NS0 * ND);
    const int which = rest / ND, k = rest % ND;
    const long long e = e0 + le;
    T val = T(0);
    if (e < geo.E) {
      const T* grid = static_cast<const T*>(which ? a.ud : a.ue);
      int idx[3];
      elem_index(geo, e, idx);
      const int c = k % NC, p = a.stride;
      const long long gi = (long long)(p * idx[0] + a.off[c][0]) * geo.G1 +
                           (p * idx[1] + a.off[c][1]);
      val = grid[(k / NC) * geo.G + gi * geo.G2 + p * idx[2] +
                 a.off[c][2]];
    }
    corner[i] = val;
  }
  __syncthreads();

  // phase 2: the qp state and the primal density per (element, qp)
  for (int i = tid; i < kElems * Q; i += kThreads) {
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
      xq[d] = (T(a.origin[d]) + T(idx[d]) * T(a.hax[d])) + T(a.qoff[q][d]);
    eval_density<TR, DIM, Dens>(u, ud, g, xq, a, out);
    T* o = qout + (le * Q + q) * NO;
#pragma unroll
    for (int k = 0; k < NO; ++k) o[k] = out[k];
  }
  __syncthreads();

  const int le = tid % kElems, slot = tid / kElems;
  const long long e = e0 + le;
  if (e >= geo.E) return;

  // phase 3a: residual rows slot, slot + kSlots, ...
  T* res = static_cast<T*>(a.res);
#pragma unroll 1
  for (int r = slot; r < ND; r += kSlots) {
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
  if (a.n_rows == 0) return;

  // phase 3b: Jacobian columns slot, slot + kSlots, ...
  int idx[3];
  elem_index(geo, e, idx);
  T* jac = static_cast<T*>(a.jac);
  const T au = T(a.alpha_u), at = T(a.alpha_t);
#pragma unroll 1
  for (int col = slot; col < ND; col += kSlots) {
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
        xq[d] = (T(a.origin[d]) + T(idx[d]) * T(a.hax[d])) + T(a.qoff[q][d]);
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

template <typename T, bool TR, int DIM, int NC, int NV, class Dens>
int set_elem_launch_case(const SetArgs& a, const ElemGeometry& geo,
                         void* stream) {
  auto kernel = set_elem_full_kernel<T, TR, DIM, NC, NV, Dens>;
  const size_t smem =
      sizeof(T) * (size_t)SetElemLayout<DIM, NC, NV, TR>::total(a.Q);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (geo.E + kElems - 1) / kElems;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a, geo);
  return (int)cudaGetLastError();
}

template <typename T, int DIM, int NC, int NV, class Dens>
int set_elem_launch(const SetArgs* a, void* stream) {
  if (a->Q < 1 || a->Q > kMaxQ || a->N0 < 1 || a->N1 < 1 || a->N2 < 1 ||
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
             ? set_elem_launch_case<T, true, DIM, NC, NV, Dens>(*a, geo,
                                                                stream)
             : set_elem_launch_case<T, false, DIM, NC, NV, Dens>(*a, geo,
                                                                 stream);
}

}  // namespace

// Plain C entry points of a generated library, bound with ctypes (see
// ops/_build.py load_generated): each takes the host address of a SetArgs
// and the stream, and returns the cudaGetLastError() of its launch.
#define SET_ELEM_ENTRY_POINTS(DENS)                                      \
  extern "C" int set_elem_full_f64(const void* args, void* stream) {     \
    return set_elem_launch<double, SET_DIM, SET_NC, SET_NV, DENS>(       \
        static_cast<const SetArgs*>(args), stream);                      \
  }                                                                      \
  extern "C" int set_elem_full_f32(const void* args, void* stream) {     \
    return set_elem_launch<float, SET_DIM, SET_NC, SET_NV, DENS>(        \
        static_cast<const SetArgs*>(args), stream);                      \
  }
