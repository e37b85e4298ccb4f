// Node-scatter assembly of the 2D scalar advection-diffusion-reaction
// weak form (thermal, with or without advection, and cdr) on uniform p1
// quads, steady or a transient stage, for Hopper (sm_90a).
//
// Replaces: the TPU node-scatter kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_node_call` (the pallas_call body is
// `FusedP1Assembly._kernel(node=True)`), in its two launched modes:
//   thermal_node_state  <- mode "state" (affine split: the residual's
//                          state part, reading only the u node grid)
//   thermal_node_full   <- mode "full"  (residual + the 16 SoA Jacobian
//                          rows off one read of the element data)
//
// Weak form (mrhyde_tpu/physics/thermal.py and cdr.py qp_density): S =
// m u_t + b . grad u - f (thermal: m = rho cp, b the advection x|y or
// none; cdr: m = 1, f = source - reaction), flux F = kappa grad u (cdr:
// kappa = diffusion / (rho cp)), at u_eval = alpha_u u + beta_u and u_dot
// = alpha_t u + beta_t (the stage seeding of the time integrator; steady:
// alpha_u = 1, alpha_t = 0, no betas).
//   state (affine split, the part linear in u; betas go to the
//   coordinate part, which the caller adds):
//     steady:    r_n = sum_{e ni n} sum_q w_q kappa grad phi_c . grad u_h
//     transient: r_n = sum_{e ni n} sum_q w_q (m alpha_t u_h phi_c
//                                  + kappa alpha_u grad phi_c . grad u_h)
//     ADVECT adds sum_{e ni n} sum_q w_q phi_c alpha_u b . grad u_h
//   full (u is the u_eval grid; S carries its m u_dot term, not b):
//     r_n = sum_{e ni n} sum_q w_q (phi_c (S + b . grad u_h)
//                                   + kappa grad phi_c . grad u_h)
//     J_e[c][c'] = sum_q w_q (phi_c (alpha_u (dS/de phi_c'
//                                             + b . grad phi_c')
//                                    + alpha_t m phi_c')
//                  + alpha_u grad phi_c . (dkappa/de phi_c' grad u_h
//                                          + kappa grad phi_c'))
// with c the local corner of node n in element e (row c the test function
// phi_c, column c' the trial function: the b . grad phi_c' term makes J
// nonsymmetric). kappa, m and each component of b are a scalar or one
// value per (element, qp). Template flags select the transient variant
// and advection; the steady instantiation is the arithmetic of the
// steady-only kernels (no mass lane, no alpha), and ADVECT = false that
// of the kernels without b. Corners are
// (0,0),(1,0),(1,1),(0,1) on (axis 0, axis 1); element e = i*N1 + j;
// node (i, j) is entry i*(N1+1) + j of the node grid. Jacobian row
// k = c*4 + c' is stored as jac[k*E + e].
//
// Design. The TPU kernel walks element tiles on a grid that runs in
// order and carries each tile's spills (right, bottom, corner) to the
// next step in VMEM. CUDA blocks run in no order, so nothing is carried:
// one thread owns one node, gathers the 3x3 node patch around it, and
// sums the contributions of its (up to) four adjacent elements to
// itself. Each element's quadrature is recomputed by the four threads
// of its corners — a little arithmetic for no atomics and a sum in a
// fixed order (corner 0..3, then q = 0..Q-1, as the plain pad+sum
// version sums), so results are deterministic. Mesh edges are masked by
// index; any N0, N1 works (no tiles, no padding). In "full" the thread
// of node (i, j) with i < N0, j < N1 also writes element (i, j)'s 16
// Jacobian rows; consecutive threads write consecutive elements.
//
// What bounds it on the H100: bytes, not flops. "state" reads about one
// value per node (the 3x3 patch is shared through L1/L2 by neighbouring
// threads) and writes one, plus Q values per element for each of kappa
// and m that varies. "full" reads the u_eval grid and the per-qp tensors
// S, dS/de, kappa, dkappa/de (4*Q values per element; Q more when m
// varies) and writes 16 rows per element. The transient "full" reads the
// u_eval grid the caller forms (alpha_u u + beta_u, which the torch
// coefficient pre-pass needs anyway) rather than u and beta_u: one grid
// instead of two. A velocity component adds Q values per element where it
// varies (the rotating field: 2*Q) and nothing where it is a scalar.
// The TPU kernel traced the coefficient expressions into its body; here
// a torch pre-pass evaluates them, which costs those ~4*Q extra values
// per element of traffic in "full". Generating the DSL expression into
// the kernel over a dual-number type is a ROADMAP item. No shared
// memory, tiling, TMA or wgmma yet: this version is the simple, right
// one; making it fast is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// local corner c -> offset on axis 0 / axis 1
__device__ __forceinline__ int corner_i(int c) { return (c == 1 || c == 2); }
__device__ __forceinline__ int corner_j(int c) { return (c >= 2); }

// 3x3 node patch P[di][dj] = u(i-1+di, j-1+dj), zero outside the grid
template <typename T>
__device__ __forceinline__ void load_patch(const T* __restrict__ u, int i,
                                           int j, int N0, int N1,
                                           T P[3][3]) {
#pragma unroll
  for (int di = 0; di < 3; ++di) {
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int ii = i - 1 + di, jj = j - 1 + dj;
      P[di][dj] = (ii >= 0 && ii <= N0 && jj >= 0 && jj <= N1)
                      ? u[(long long)ii * (N1 + 1) + jj]
                      : T(0);
    }
  }
}

// the advection velocity: component d is p[d][e*Q + q] or, where p[d] is
// null, the scalar s[d] (a kernel parameter); an (E, Q) component is read
// at each qp where it is used
template <typename T>
struct Velocity {
  const T* p[2];
  T s[2];
  __device__ __forceinline__ T at(int d, long long eq) const {
    return p[d] ? p[d][eq] : s[d];
  }
};

// corner values of the element whose corner (0,0) sits at patch (pi, pj)
template <typename T>
__device__ __forceinline__ void element_corners(const T P[3][3], int pi,
                                                int pj, T uc[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) uc[c] = P[pi + corner_i(c)][pj + corner_j(c)];
}

// u_h at quadrature point q of an element with corner values uc
template <typename T>
__device__ __forceinline__ T qp_val(const T* __restrict__ phi, int Q, int q,
                                    const T uc[4]) {
  T v = T(0);
#pragma unroll
  for (int c = 0; c < 4; ++c) v += phi[c * Q + q] * uc[c];
  return v;
}

// grad u_h at quadrature point q of an element with corner values uc
template <typename T>
__device__ __forceinline__ void qp_grad(const T* __restrict__ grad, int Q,
                                        int q, const T uc[4], T& g0, T& g1) {
  g0 = T(0);
  g1 = T(0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    g0 += grad[(c * Q + q) * 2 + 0] * uc[c];
    g1 += grad[(c * Q + q) * 2 + 1] * uc[c];
  }
}

template <typename T, bool TRANSIENT, bool ADVECT>
__global__ void __launch_bounds__(kThreads)
    node_state_kernel(const T* __restrict__ u, const T* __restrict__ kappa,
                      T kappa0, int kappa_is_scalar,
                      const T* __restrict__ mass, T mass0,
                      int mass_is_scalar, T alpha_u, T alpha_t,
                      Velocity<T> vel, const T* __restrict__ phi,
                      const T* __restrict__ grad,
                      const T* __restrict__ wts, int Q, int N0, int N1,
                      T* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)(N0 + 1) * (N1 + 1)) return;
  const int i = (int)(n / (N1 + 1)), j = (int)(n % (N1 + 1));
  T P[3][3];
  load_patch(u, i, j, N0, N1, P);
  T acc = T(0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    // node (i, j) is corner c of element (a, b)
    const int a = i - corner_i(c), b = j - corner_j(c);
    if (a < 0 || a >= N0 || b < 0 || b >= N1) continue;
    T uc[4];
    element_corners(P, 1 - corner_i(c), 1 - corner_j(c), uc);
    const long long e = (long long)a * N1 + b;
    T r = T(0);
    for (int q = 0; q < Q; ++q) {
      T g0, g1;
      qp_grad(grad, Q, q, uc, g0, g1);
      const T k = kappa_is_scalar ? kappa0 : kappa[e * Q + q];
      if constexpr (ADVECT) {
        // the source lane: m alpha_t u_h in a stage, plus b . grad(alpha_u
        // u_h)
        if constexpr (TRANSIENT) {
          g0 = alpha_u * g0;
          g1 = alpha_u * g1;
        }
        T sl = vel.at(0, e * Q + q) * g0 + vel.at(1, e * Q + q) * g1;
        if constexpr (TRANSIENT) {
          const T m = mass_is_scalar ? mass0 : mass[e * Q + q];
          sl = m * (alpha_t * qp_val(phi, Q, q, uc)) + sl;
        }
        r += wts[q] * (phi[c * Q + q] * sl +
                       grad[(c * Q + q) * 2 + 0] * (k * g0) +
                       grad[(c * Q + q) * 2 + 1] * (k * g1));
      } else if constexpr (TRANSIENT) {
        const T m = mass_is_scalar ? mass0 : mass[e * Q + q];
        const T uh = qp_val(phi, Q, q, uc);
        r += wts[q] * (phi[c * Q + q] * (m * (alpha_t * uh)) +
                       grad[(c * Q + q) * 2 + 0] * (k * (alpha_u * g0)) +
                       grad[(c * Q + q) * 2 + 1] * (k * (alpha_u * g1)));
      } else {
        r += wts[q] * (grad[(c * Q + q) * 2 + 0] * (k * g0) +
                       grad[(c * Q + q) * 2 + 1] * (k * g1));
      }
    }
    acc += r;
  }
  out[n] = acc;
}

template <typename T, bool TRANSIENT, bool ADVECT>
__global__ void __launch_bounds__(kThreads)
    node_full_kernel(const T* __restrict__ u, const T* __restrict__ S,
                     const T* __restrict__ dS, const T* __restrict__ K,
                     const T* __restrict__ dK, const T* __restrict__ mass,
                     T mass0, int mass_is_scalar, T alpha_u, T alpha_t,
                     Velocity<T> vel, const T* __restrict__ phi,
                     const T* __restrict__ grad, const T* __restrict__ wts,
                     int Q, int N0, int N1, T* __restrict__ out,
                     T* __restrict__ jac) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)(N0 + 1) * (N1 + 1)) return;
  const int i = (int)(n / (N1 + 1)), j = (int)(n % (N1 + 1));
  T P[3][3];
  load_patch(u, i, j, N0, N1, P);
  T acc = T(0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a = i - corner_i(c), b = j - corner_j(c);
    if (a < 0 || a >= N0 || b < 0 || b >= N1) continue;
    T uc[4];
    element_corners(P, 1 - corner_i(c), 1 - corner_j(c), uc);
    const long long e = (long long)a * N1 + b;
    T r = T(0);
    for (int q = 0; q < Q; ++q) {
      T g0, g1;
      qp_grad(grad, Q, q, uc, g0, g1);
      const T k = K[e * Q + q];
      T sq = S[e * Q + q];
      if constexpr (ADVECT)
        sq += vel.at(0, e * Q + q) * g0 + vel.at(1, e * Q + q) * g1;
      r += wts[q] * (phi[c * Q + q] * sq +
                     grad[(c * Q + q) * 2 + 0] * (k * g0) +
                     grad[(c * Q + q) * 2 + 1] * (k * g1));
    }
    acc += r;
  }
  out[n] = acc;

  if (i >= N0 || j >= N1) return;
  // element (i, j): node (i, j) is its corner 0, patch offset (1, 1)
  T uc[4];
  element_corners(P, 1, 1, uc);
  const long long E = (long long)N0 * N1;
  const long long e = (long long)i * N1 + j;
  T J[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) J[k] = T(0);
  for (int q = 0; q < Q; ++q) {
    T g0, g1;
    qp_grad(grad, Q, q, uc, g0, g1);
    const T kq = K[e * Q + q], dkq = dK[e * Q + q], dsq = dS[e * Q + q];
    [[maybe_unused]] T mq = T(0), b0 = T(0), b1 = T(0);
    if constexpr (TRANSIENT) mq = mass_is_scalar ? mass0 : mass[e * Q + q];
    if constexpr (ADVECT) {
      b0 = vel.at(0, e * Q + q);
      b1 = vel.at(1, e * Q + q);
    }
    const T w = wts[q];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T pc = phi[c * Q + q];
      const T gc0 = grad[(c * Q + q) * 2 + 0];
      const T gc1 = grad[(c * Q + q) * 2 + 1];
#pragma unroll
      for (int cp = 0; cp < 4; ++cp) {
        const T pcp = phi[cp * Q + q];
        // column (c'): tangent of S and of F_d along phi_c'
        T ts = pcp * dsq, tf0, tf1;
        if constexpr (ADVECT)
          ts += b0 * grad[(cp * Q + q) * 2 + 0] +
                b1 * grad[(cp * Q + q) * 2 + 1];
        if constexpr (TRANSIENT) {
          ts = alpha_u * ts + alpha_t * (pcp * mq);
          tf0 = alpha_u *
                (pcp * (dkq * g0) + grad[(cp * Q + q) * 2 + 0] * kq);
          tf1 = alpha_u *
                (pcp * (dkq * g1) + grad[(cp * Q + q) * 2 + 1] * kq);
        } else {
          tf0 = pcp * (dkq * g0) + grad[(cp * Q + q) * 2 + 0] * kq;
          tf1 = pcp * (dkq * g1) + grad[(cp * Q + q) * 2 + 1] * kq;
        }
        J[c * 4 + cp] += w * (pc * ts + gc0 * tf0 + gc1 * tf1);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) jac[k * E + e] = J[k];
}

int blocks_for(int N0, int N1) {
  const long long nodes = (long long)(N0 + 1) * (N1 + 1);
  return (int)((nodes + kThreads - 1) / kThreads);
}

template <typename T>
Velocity<T> make_velocity(const void* v0, double v0s, const void* v1,
                          double v1s) {
  Velocity<T> b;
  b.p[0] = (const T*)v0;
  b.p[1] = (const T*)v1;
  b.s[0] = (T)v0s;
  b.s[1] = (T)v1s;
  return b;
}

template <typename T>
int launch_state(const void* u, const void* kappa, double kappa0,
                 int kappa_is_scalar, const void* mass, double mass0,
                 int mass_is_scalar, double alpha_u, double alpha_t,
                 int transient, int advect, const void* v0, double v0s,
                 const void* v1, double v1s, const void* phi,
                 const void* grad, const void* wts, int Q, int N0, int N1,
                 void* out, void* stream) {
  auto kernel = advect ? (transient ? node_state_kernel<T, true, true>
                                    : node_state_kernel<T, false, true>)
                       : (transient ? node_state_kernel<T, true, false>
                                    : node_state_kernel<T, false, false>);
  kernel<<<blocks_for(N0, N1), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)kappa, (T)kappa0, kappa_is_scalar,
      (const T*)mass, (T)mass0, mass_is_scalar, (T)alpha_u, (T)alpha_t,
      make_velocity<T>(v0, v0s, v1, v1s), (const T*)phi, (const T*)grad,
      (const T*)wts, Q, N0, N1, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_full(const void* u, const void* S, const void* dS, const void* K,
                const void* dK, const void* mass, double mass0,
                int mass_is_scalar, double alpha_u, double alpha_t,
                int transient, int advect, const void* v0, double v0s,
                const void* v1, double v1s, const void* phi,
                const void* grad, const void* wts, int Q, int N0, int N1,
                void* out, void* jac, void* stream) {
  auto kernel = advect ? (transient ? node_full_kernel<T, true, true>
                                    : node_full_kernel<T, false, true>)
                       : (transient ? node_full_kernel<T, true, false>
                                    : node_full_kernel<T, false, false>);
  kernel<<<blocks_for(N0, N1), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)S, (const T*)dS, (const T*)K, (const T*)dK,
      (const T*)mass, (T)mass0, mass_is_scalar, (T)alpha_u, (T)alpha_t,
      make_velocity<T>(v0, v0s, v1, v1s), (const T*)phi, (const T*)grad,
      (const T*)wts, Q, N0, N1, (T*)out, (T*)jac);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (see ops/_build.py). Each
// returns the cudaGetLastError() of its launch. transient = 0 selects the
// steady kernels, which read neither mass nor the alphas; advect = 0 the
// kernels without advection, which read no velocity. Velocity component d
// is the (E, Q) array v<d> or, where that is null, the scalar v<d>s; the
// third component (3D) is unused here.
extern "C" {

#define VEL_ARGS                                                            \
  int advect, const void *v0, double v0s, const void *v1, double v1s,      \
      const void *, double
#define STATE_ARGS                                                          \
  const void *u, const void *kappa, double kappa0, int kappa_is_scalar,     \
      const void *mass, double mass0, int mass_is_scalar, double alpha_u,   \
      double alpha_t, int transient, VEL_ARGS, const void *phi,             \
      const void *grad, const void *wts, int Q, int N0, int N1, void *out,  \
      void *stream
#define STATE_PASS                                                          \
  u, kappa, kappa0, kappa_is_scalar, mass, mass0, mass_is_scalar, alpha_u,  \
      alpha_t, transient, advect, v0, v0s, v1, v1s, phi, grad, wts, Q, N0,  \
      N1, out, stream
#define FULL_ARGS                                                           \
  const void *u, const void *S, const void *dS, const void *K,              \
      const void *dK, const void *mass, double mass0, int mass_is_scalar,   \
      double alpha_u, double alpha_t, int transient, VEL_ARGS,              \
      const void *phi, const void *grad, const void *wts, int Q, int N0,    \
      int N1, void *out, void *jac, void *stream
#define FULL_PASS                                                           \
  u, S, dS, K, dK, mass, mass0, mass_is_scalar, alpha_u, alpha_t,           \
      transient, advect, v0, v0s, v1, v1s, phi, grad, wts, Q, N0, N1, out,  \
      jac, stream

int thermal_node_state_f64(STATE_ARGS) {
  return launch_state<double>(STATE_PASS);
}

int thermal_node_state_f32(STATE_ARGS) {
  return launch_state<float>(STATE_PASS);
}

int thermal_node_full_f64(FULL_ARGS) { return launch_full<double>(FULL_PASS); }

int thermal_node_full_f32(FULL_ARGS) { return launch_full<float>(FULL_PASS); }

}  // extern "C"
