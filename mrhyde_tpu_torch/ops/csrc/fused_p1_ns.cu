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
// Design. The weak form is written once, `ns_density`, a template over its
// scalar type: evaluated on T it gives the residual's densities; on the
// forward-mode Dual<T, N> it gives the Jacobian's derivative tables (the
// Sacado SFad analog the reference MrHyDE uses; the JAX kernel traced the
// density and differentiated it by sparse forward AD at trace time).
// Nothing is differentiated by hand. One launch holds both roles, split
// by block index:
//   residual blocks: one thread per node, as fused_p1_thermal.cu does: it
//     gathers the 3x3 node patch of all three variables (and of u_dot),
//     recomputes the primal density of its four elements and sums their
//     contributions to itself in a fixed order: no atomics, deterministic.
//   Jacobian blocks: one thread per (element, column variable w), w-major
//     so that neighbouring threads write neighbouring elements of a row.
//     It seeds only w's tangents (u_w, d u_w/dx, d u_w/dy, and u_dot_w in
//     a stage: N = 3 steady, 4 transient) and keeps the 12 x 4 entries of
//     its column block: 48 accumulators, not 144 (288 registers of f64,
//     over the cap of 255 before any dual).
// Mesh edges are masked by index; any N0, N1 >= 1 works.
//
// What bounds it on the H100: the writes of the Jacobian rows (112 or 144
// per element) and the dual arithmetic, about 10^4 operations per element
// at f64's 34 TFLOP/s; `chip_smoke.py` counts both from the shapes and the
// code and reports the larger bound. No shared memory, tiling or TMA yet:
// this version is the simple, right one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVars = 3;      // ux, uy, pr
constexpr int kRows = 12;     // kVars * 4 corners
constexpr int kOuts = 9;      // S_ux, S_uy, S_pr, F_ux0, F_ux1, F_uy0,
                              // F_uy1, F_pr0, F_pr1

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

// ---------------------------------------------------------------------
// forward-mode dual numbers
// ---------------------------------------------------------------------

template <typename T, int N>
struct Dual {
  using scalar = T;
  T v;
  T d[N];
};

template <typename T>
struct Passive {
  using type = T;
};
template <typename T, int N>
struct Passive<Dual<T, N>> {
  using type = T;
};

template <typename T>
__device__ __forceinline__ T value(T x) {
  return x;
}
template <typename T, int N>
__device__ __forceinline__ T value(const Dual<T, N>& x) {
  return x.v;
}

template <typename T>
__device__ __forceinline__ T dsqrt(T x) {
  return sqrt(x);
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> dsqrt(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = sqrt(a.v);
  const T c = T(0.5) / r.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = c * a.d[i];
  return r;
}

#define SCAL(T, N) typename Dual<T, N>::scalar

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a,
                                                SCAL(T, N) b) {
  Dual<T, N> r = a;
  r.v = a.v + b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(SCAL(T, N) a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r = b;
  r.v = a + b.v;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a,
                                                SCAL(T, N) b) {
  Dual<T, N> r = a;
  r.v = a.v - b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a,
                                                SCAL(T, N) b) {
  Dual<T, N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(SCAL(T, N) a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a * b.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a,
                                                SCAL(T, N) b) {
  Dual<T, N> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(SCAL(T, N) a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a / b.v;
  const T c = -a / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = c * b.d[i];
  return r;
}

// ---------------------------------------------------------------------
// the weak form, once
// ---------------------------------------------------------------------

// Per-qp densities out = [S_ux, S_uy, S_pr, F_ux0, F_ux1, F_uy0, F_uy1,
// F_pr0, F_pr1] of ns_density at the point: u, g (g[v][d] = d u_v / d x_d)
// and, in a stage, ud for the three variables; rho, visc, src the
// coefficients there. Steady: no u_dot terms (the JAX kernel's steady
// specialization, u_dot = 0).
template <bool TR, typename S>
__device__ __forceinline__ void ns_density(
    S u[kVars], S ud[kVars], S g[kVars][2],
    typename Passive<S>::type rho, typename Passive<S>::type visc,
    const typename Passive<S>::type src[2], typename Passive<S>::type h,
    typename Passive<S>::type tau_dt2, bool pspg, bool supg,
    S out[kOuts]) {
  using T = typename Passive<S>::type;
  S conv[2], F[2][2], stab[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    conv[i] = u[0] * g[i][0] + u[1] * g[i][1];
    S m = conv[i] - src[i];
    if constexpr (TR) m = (ud[i] + conv[i]) - src[i];
    out[i] = rho * m;
    F[i][0] = visc * g[i][0];
    F[i][1] = visc * g[i][1];
    F[i][i] = F[i][i] - u[2];
  }
  out[2] = g[0][0] + g[1][1];
  S fpr0 = u[2] * T(0), fpr1 = u[2] * T(0);
  if (pspg || supg) {
    const S u2 = u[0] * u[0] + u[1] * u[1];
    const S nvel = value(u2) > T(1e-12) ? dsqrt(u2) : u2;
    const T a = T(4) * visc / (h * h);
    const S b = T(2) * nvel / h;
    const S tau = T(1) / dsqrt((b * b + a * a) + tau_dt2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      S s = rho * conv[i] + g[2][i];
      if constexpr (TR) s = (rho * ud[i] + rho * conv[i]) + g[2][i];
      stab[i] = s - rho * src[i];
    }
    if (supg) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const S ts = tau * stab[i];
        F[i][0] = F[i][0] + ts * u[0];
        F[i][1] = F[i][1] + ts * u[1];
      }
    }
    if (pspg) {
      fpr0 = tau * stab[0] / rho;
      fpr1 = tau * stab[1] / rho;
    }
  }
  out[3] = F[0][0];
  out[4] = F[0][1];
  out[5] = F[1][0];
  out[6] = F[1][1];
  out[7] = fpr0;
  out[8] = fpr1;
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
#pragma unroll
  for (int v = 0; v < kVars; ++v)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      uc[v][c] = grid[v * nodes + (long long)(ea + corner_i(c)) * (N1 + 1) +
                      eb + corner_j(c)];
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

// residual role: node n = (i, j) sums the rows of its corners
template <typename T, bool TR>
__device__ __forceinline__ void residual_node(const NsArgs& a, long long n) {
  const int N0 = a.N0, N1 = a.N1, Q = a.Q;
  const T* __restrict__ ue = static_cast<const T*>(a.ue);
  const T* __restrict__ udg = static_cast<const T*>(a.ud);
  const T* __restrict__ phi = static_cast<const T*>(a.phi);
  const T* __restrict__ grad = static_cast<const T*>(a.grad);
  const T* __restrict__ wts = static_cast<const T*>(a.wts);
  const long long nodes = (long long)(N0 + 1) * (N1 + 1);
  const int i = (int)(n / (N1 + 1)), j = (int)(n % (N1 + 1));
  T acc[kVars] = {T(0), T(0), T(0)};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    // node (i, j) is corner c of element (ea, eb)
    const int ea = i - corner_i(c), eb = j - corner_j(c);
    if (ea < 0 || ea >= N0 || eb < 0 || eb >= N1) continue;
    const long long e = (long long)ea * N1 + eb;
    T uc[kVars][4], udc[kVars][4];
    load_corners(ue, ea, eb, N0, N1, uc);
    if constexpr (TR) load_corners(udg, ea, eb, N0, N1, udc);
    T r[kVars] = {T(0), T(0), T(0)};
    for (int q = 0; q < Q; ++q) {
      T u[kVars], ud[kVars], g[kVars][2], out[kOuts];
      at_qp(phi, grad, Q, q, uc, u, g);
      if constexpr (TR) qp_vals(phi, Q, q, udc, ud);
      const T src[2] = {coef_at<T>(a, 2, e, q), coef_at<T>(a, 3, e, q)};
      ns_density<TR, T>(u, ud, g, coef_at<T>(a, 0, e, q),
                        coef_at<T>(a, 1, e, q), src, T(a.h), T(a.tau_dt2),
                        a.pspg, a.supg, out);
      const T pc = phi[c * Q + q];
      const T g0 = grad[(c * Q + q) * 2 + 0], g1 = grad[(c * Q + q) * 2 + 1];
#pragma unroll
      for (int v = 0; v < kVars; ++v)
        r[v] += wts[q] * (pc * out[v] + g0 * out[3 + 2 * v] +
                          g1 * out[4 + 2 * v]);
    }
#pragma unroll
    for (int v = 0; v < kVars; ++v) acc[v] += r[v];
  }
  T* __restrict__ res = static_cast<T*>(a.res);
#pragma unroll
  for (int v = 0; v < kVars; ++v) res[v * nodes + n] = acc[v];
}

// Jacobian role: the 12 x 4 column block of column variable w of element e
template <typename T, bool TR>
__device__ __forceinline__ void jacobian_block(const NsArgs& a, int w,
                                               long long e) {
  constexpr int N = TR ? 4 : 3;  // tangents: u_w, d/dx, d/dy [, u_dot_w]
  using D = Dual<T, N>;
  const int N1 = a.N1, Q = a.Q;
  const T* __restrict__ phi = static_cast<const T*>(a.phi);
  const T* __restrict__ grad = static_cast<const T*>(a.grad);
  const T* __restrict__ wts = static_cast<const T*>(a.wts);
  const int ea = (int)(e / N1), eb = (int)(e % N1);
  T uc[kVars][4], udc[kVars][4];
  load_corners(static_cast<const T*>(a.ue), ea, eb, a.N0, N1, uc);
  if constexpr (TR)
    load_corners(static_cast<const T*>(a.ud), ea, eb, a.N0, N1, udc);
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
    ns_density<TR, D>(u, ud, g, coef_at<T>(a, 0, e, q),
                      coef_at<T>(a, 1, e, q), src, T(a.h), T(a.tau_dt2),
                      a.pspg, a.supg, out);
    const T wq = wts[q];
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
  const long long E = (long long)a.N0 * N1;
  T* __restrict__ jac = static_cast<T*>(a.jac);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int cp = 0; cp < 4; ++cp) {
      const int pos = a.row_pos[r * kRows + w * 4 + cp];
      if (pos >= 0) jac[pos * E + e] = J[r][cp];
    }
}

template <typename T, bool TR>
__global__ void __launch_bounds__(kThreads)
    ns_node_full_kernel(const NsArgs a, int res_blocks) {
  const long long E = (long long)a.N0 * a.N1;
  if ((int)blockIdx.x < res_blocks) {
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n < (long long)(a.N0 + 1) * (a.N1 + 1)) residual_node<T, TR>(a, n);
    return;
  }
  const long long t =
      (long long)(blockIdx.x - res_blocks) * blockDim.x + threadIdx.x;
  if (t >= kVars * E) return;
  jacobian_block<T, TR>(a, (int)(t / E), t % E);
}

template <typename T>
int launch(const NsArgs* a, void* stream) {
  const long long nodes = (long long)(a->N0 + 1) * (a->N1 + 1);
  const long long E = (long long)a->N0 * a->N1;
  const int res_blocks = (int)((nodes + kThreads - 1) / kThreads);
  const int jac_blocks = (int)((kVars * E + kThreads - 1) / kThreads);
  auto kernel = a->transient ? ns_node_full_kernel<T, true>
                             : ns_node_full_kernel<T, false>;
  kernel<<<res_blocks + jac_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      *a, res_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (see ops/_build.py). Each takes
// the host address of an NsArgs and the stream, and returns the
// cudaGetLastError() of its launch.
extern "C" {

int ns_node_full_f64(const void* args, void* stream) {
  return launch<double>(static_cast<const NsArgs*>(args), stream);
}

int ns_node_full_f32(const void* args, void* stream) {
  return launch<float>(static_cast<const NsArgs*>(args), stream);
}

}  // extern "C"
