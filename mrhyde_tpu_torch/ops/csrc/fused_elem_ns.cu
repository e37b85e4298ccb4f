// Element-tile assembly of incompressible Navier-Stokes (equal-order,
// PSPG/SUPG) on uniform 3D hex (p1: ux, uy, uz, pr x 8 corners, nd = 32)
// and 2D p2 quads (ux, uy, pr x 9 lattice dofs, nd = 27), steady or a
// transient stage, for Hopper (sm_90a).
//
// Replaces: the TPU element-tile kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_call` (:1283-1318, pallas_call at
// :1303; body `FusedP1Assembly._kernel(node=False)`), in mode "full"
// (:1417) for the Navier-Stokes weak form: the nd residual rows and the
// element-varying Jacobian rows of every element. The caller scatters the
// residual rows to the nodes (pad+sum on the p1 node grid, strided adds
// on the p2 fine lattice), as the JAX package does after its kernel.
//
// Weak form (mrhyde_tpu_torch/physics/navierstokes.py ns_density), per
// element e and quadrature point q, at u_eval = alpha_u u + beta_u and
// u_dot = alpha_t u + beta_t (steady: alpha_u = 1, no u_dot): the density
// gives (S_v, F_v) for v in (ux, uy[, uz], pr);
//   r_(v,c)  = sum_q w_q (phi_c S_v + grad phi_c . F_v);
//   J[(v,c),(w,c')] = sum_q w_q (phi_c T[S_v] + grad phi_c . T[F_v]),
//   T[o] = the derivative of density output o along the direction
//          u_w += alpha_u phi_c', grad u_w += alpha_u grad phi_c',
//          u_dot_w += alpha_t phi_c' (the JAX kernel's column tangents).
// Row k = row*nd + col, row = v*nc + c, col = w*nc + c'. Local dof c of
// element (I, J[, K]) is grid point stride*(I, J[, K]) + off[c] of each
// variable's grid (stride 1: the p1 node grid; 2: the p2 fine lattice);
// element e is C-order over the element grid. Residual row r is stored as
// res[r*E + e]; only the Jacobian rows the host probe classified
// element-varying are stored, as jac[pos*E + e] with pos = row_pos[k] >=
// 0 (the constant rows are the probe's values).
//
// Design. The weak form is written once, `ns_density` over its scalar
// type (ns_density.cuh, shared with fused_p1_ns.cu), and differentiated
// by the dual numbers of dual.cuh. Nothing is
// differentiated by hand. A column's tangent is ONE direction, so the
// Jacobian of column (w, c') is one forward pass on Dual<T, 1>: no 32 x 8
// column-variable block of accumulators, and no tangent of a variable that
// is not w (the seed of those is 0 at run time). A block owns kElems
// elements and runs in phases through shared memory:
//   1. the reference tables and the elements' corner values (u_eval and,
//      in a stage, u_dot) of all variables;
//   2. one thread per (element, qp): the values, gradients (and u_dot) of
//      all variables at the qp, and the primal density there;
//   3. each thread (element, slot) sums the residual rows slot, slot +
//      kSlots, ... from the stored densities, then walks the columns slot,
//      slot + kSlots, ...: for each it re-evaluates the density on
//      Dual<T, 1> at every qp from the stored qp state, keeps the nd sums
//      of the column in registers and writes them.
// Neighbouring threads of a warp own neighbouring elements, so each row
// is written 16 elements (128 bytes in f64) at a time. The sums are
// deterministic (no atomics); any element grid works (the last block
// masks its missing elements); element and row offsets are 64-bit.
//
// What bounds it on the H100: the writes of the Jacobian rows (up to nd^2
// = 1,024 per hex element); `chip_smoke.py` counts them and the weak
// form's operations (its sparse forward AD on one element's stand-ins)
// and reports the larger bound. No tiling over rows, TMA or wgmma yet: this version is the
// simple, right one.

#include <cuda_runtime.h>

#include "ns_density.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kElems = 16;                  // elements per block
constexpr int kSlots = kThreads / kElems;   // threads per element
constexpr int kMaxNc = 9;
constexpr int kCoefs = 5;  // density, viscosity, source ux, uy, uz

// The C interface's arguments, filled by ctypes (ops/fused_ns.py
// _ElemNSArgs).
struct ElemNsArgs {
  const void* ue;            // (dim+1, G0, G1[, G2]) u_eval grids
  const void* ud;            // the u_dot grids, or null (steady)
  const void* coef[kCoefs];  // (E, Q) per coefficient ...
  double coef0[kCoefs];      // ... or these scalars where it is null
  const void* phi;           // (nc, Q)
  const void* grad;          // (nc, Q, dim)
  const void* wts;           // (Q,)
  const int* row_pos;        // (nd*nd,) position of row k in jac, or -1
  void* res;                 // (nd, E) residual rows
  void* jac;                 // (n_rows, E) Jacobian rows
  double alpha_u, alpha_t, h, tau_dt2;  // tau_dt2 = (C3 / dt)^2
  int Q, nc, dim, stride, N0, N1, N2, pspg, supg, transient;
  int off[kMaxNc][3];        // lattice offset of local dof c (axis 2: 0
                             // in 2D)
};

// ---------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------

struct Geometry {
  int N1, N2;      // element grid axes 1, 2 (N2 = 1 in 2D)
  int G1, G2;      // grid axes 1 and 2 (G2 = 1 in 2D)
  long long G;     // points of one variable's grid
  long long E;
};

template <typename T>
__device__ __forceinline__ T coef_at(const ElemNsArgs& a, int k,
                                     long long e, int q) {
  return a.coef[k] ? static_cast<const T*>(a.coef[k])[e * a.Q + q]
                   : T(a.coef0[k]);
}

// flat grid index of local dof c of element e on one variable's grid
template <int DIM>
__device__ __forceinline__ long long grid_index(const ElemNsArgs& a,
                                                const Geometry& g,
                                                long long e, int c) {
  int I, J, K = 0;
  if (DIM == 3) {
    K = (int)(e % g.N2);
    const long long r = e / g.N2;
    J = (int)(r % g.N1);
    I = (int)(r / g.N1);
  } else {
    J = (int)(e % g.N1);
    I = (int)(e / g.N1);
  }
  const int p = a.stride;
  const long long i = p * I + a.off[c][0], j = p * J + a.off[c][1],
                  k = p * K + a.off[c][2];
  return (i * g.G1 + j) * g.G2 + k;
}

// shared memory, in T: tables phi (NC*Q), grad (NC*Q*DIM), wts (Q); the
// corner values (kElems x NS0 x ND); the qp state u, ud, g (kElems x Q x
// NQ); the primal densities (kElems x Q x NO)
template <int DIM, int NC, bool TR>
struct Layout {
  static constexpr int NV = DIM + 1, ND = NV * NC, NO = NV * (1 + DIM);
  static constexpr int NS0 = TR ? 2 : 1;            // u_eval [, u_dot]
  static constexpr int NQ = NV * (1 + DIM) + (TR ? NV : 0);
  __host__ __device__ static int tables(int Q) { return NC * Q * (1 + DIM) + Q; }
  __host__ __device__ static int corners() { return kElems * NS0 * ND; }
  __host__ __device__ static int total(int Q) {
    return tables(Q) + corners() + kElems * Q * (NQ + NO);
  }
};

template <typename T, int DIM, int NC, bool TR>
__global__ void __launch_bounds__(kThreads)
    ns_elem_full_kernel(const ElemNsArgs a, const Geometry geo) {
  using L = Layout<DIM, NC, TR>;
  constexpr int NV = L::NV, ND = L::ND, NO = L::NO, NQ = L::NQ;
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
      val = grid[(k / NC) * geo.G + grid_index<DIM>(a, geo, e, k % NC)];
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
    T src[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) src[d] = coef_at<T>(a, 2 + d, e, q);
    ns_density<TR, DIM, T>(u, ud, g, coef_at<T>(a, 0, e, q),
                           coef_at<T>(a, 1, e, q), src, T(a.h),
                           T(a.tau_dt2), a.pspg, a.supg, out);
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

  // phase 3b: Jacobian columns slot, slot + kSlots, ...
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
        if constexpr (TR) {
          ud[v].v = st[NV * (1 + DIM) + v];
          ud[v].d[0] = on ? at * pcp : T(0);
        }
      }
      T src[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) src[d] = coef_at<T>(a, 2 + d, e, q);
      ns_density<TR, DIM, D>(u, ud, g, coef_at<T>(a, 0, e, q),
                             coef_at<T>(a, 1, e, q), src, T(a.h),
                             T(a.tau_dt2), a.pspg, a.supg, out);
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

template <typename T, int DIM, int NC>
int launch_case(const ElemNsArgs& a, const Geometry& geo, void* stream) {
  auto kernel = a.transient ? ns_elem_full_kernel<T, DIM, NC, true>
                            : ns_elem_full_kernel<T, DIM, NC, false>;
  const int words = a.transient ? Layout<DIM, NC, true>::total(a.Q)
                                : Layout<DIM, NC, false>::total(a.Q);
  const size_t smem = sizeof(T) * (size_t)words;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (geo.E + kElems - 1) / kElems;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a, geo);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const ElemNsArgs* a, void* stream) {
  if (a->Q < 1 || a->N0 < 1 || a->N1 < 1 || a->N2 < 1 ||
      (a->dim == 2 && a->N2 != 1))
    return (int)cudaErrorInvalidValue;
  Geometry geo;
  geo.N1 = a->N1;
  geo.N2 = a->dim == 3 ? a->N2 : 1;
  geo.G1 = a->stride * a->N1 + 1;
  geo.G2 = a->dim == 3 ? a->stride * a->N2 + 1 : 1;
  geo.G = (long long)(a->stride * a->N0 + 1) * geo.G1 * geo.G2;
  geo.E = (long long)a->N0 * a->N1 * geo.N2;
  if (a->dim == 3 && a->nc == 8) return launch_case<T, 3, 8>(*a, geo, stream);
  if (a->dim == 2 && a->nc == 9) return launch_case<T, 2, 9>(*a, geo, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes (see ops/_build.py). Each takes
// the host address of an ElemNsArgs and the stream, and returns the
// cudaGetLastError() of its launch (cudaErrorInvalidValue for a (dim, nc)
// with no instantiation).
extern "C" {

int ns_elem_full_f64(const void* args, void* stream) {
  return launch<double>(static_cast<const ElemNsArgs*>(args), stream);
}

int ns_elem_full_f32(const void* args, void* stream) {
  return launch<float>(static_cast<const ElemNsArgs*>(args), stream);
}

}  // extern "C"
