// Element-tile assembly of the scalar advection-diffusion-reaction weak
// form (thermal, with or without advection, and cdr) on uniform 3D hex
// (p1, nc = 8) and 2D p2 quads (nc = 9), steady or a transient stage, for
// Hopper (sm_90a).
//
// Replaces: the TPU element-tile kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_call` (:1283-1318, pallas_call at
// :1303; body `FusedP1Assembly._kernel(node=False)`), in its two launched
// modes for that weak form:
//   thermal_elem_state  <- mode "state" (:1402, the affine split: the
//                          residual rows of the part linear in u)
//   thermal_elem_full   <- mode "full"  (:1417, residual rows and all
//                          nc*nc Jacobian rows at u_eval)
// The caller scatters the rows to the nodes (pad+sum on the p1 node grid,
// strided adds on the p2 fine lattice), as the JAX package does after
// its kernel.
//
// Weak form (mrhyde_tpu/physics/thermal.py and cdr.py qp_density): S =
// m u_t + b . grad u - f (thermal: m = rho cp, b the advection x|y|z or
// none; cdr: m = 1, f = source - reaction), flux F = kappa grad u (cdr:
// kappa = diffusion / (rho cp)), at u_eval = alpha_u u + beta_u and u_dot
// = alpha_t u + beta_t (steady: alpha_u = 1, alpha_t = 0, no betas).
//   state:  r_c = sum_q w_q kappa grad phi_c . grad u_h            (steady)
//           r_c = sum_q w_q (m alpha_t u_h phi_c
//                            + kappa alpha_u grad phi_c . grad u_h) (stage)
//           ADVECT adds sum_q w_q phi_c alpha_u b . grad u_h
//   full (the grid is u_eval; S carries its m u_dot term, not b):
//           r_c = sum_q w_q (phi_c (S + b . grad u_h)
//                            + kappa grad phi_c . grad u_h)
//           J[c][c'] = sum_q w_q (phi_c (alpha_u (dS/de phi_c'
//                                                 + b . grad phi_c')
//                                        + alpha_t m phi_c')
//                      + alpha_u grad phi_c . (dkappa/de phi_c' grad u_h
//                                              + kappa grad phi_c'))
// The b . grad phi_c' column term is the one that makes J nonsymmetric:
// row c is the test function phi_c, column c' the trial function. kappa,
// m and each component of b are a scalar or one value per (element, qp);
// the ADVECT template flag adds b (false compiles to the kernels without
// it). Local dof
// c of element (I, J[, K]) is grid point stride*(I, J[, K]) + off[c]
// (stride 1: the p1 node grid; 2: the p2 fine lattice). Element e is
// C-order over the element grid; row c is stored as rows[c*E + e] and
// Jacobian row k = c*nc + c' as jac[k*E + e].
//
// Design. The TPU kernel DMAs (+1)-halo slabs of the node grids into VMEM
// tiles with a double-buffered pipeline; none of that carries over. One
// thread owns one element: it gathers its nc grid values (neighbouring
// threads read neighbouring addresses, and the values shared between
// elements come from L1/L2), loops over the quadrature points with the
// reference tables phi, grad, wts in shared memory, and writes its rows
// SoA, so a warp writes 32 consecutive addresses per row. The sums run in
// the plain version's order (q outer, corners inner), so results are
// deterministic; any element grid works (no tiles, no padding). The
// kernels write every row: for thermal, "state" varies in all nc rows and
// "full" in all nc and nc*nc (the JAX package's probe finds the same), so
// there are no constant rows to fold.
//
// A scalar velocity component is read from the kernel's parameters; an
// (E, Q) one at each qp where it is used, never held across qps.
//
// "full" holds nc*nc = 64 (hex) or 81 (p2) Jacobian sums per element; in
// f64 that alone is 128-162 registers, and with the rest it would press on
// the cap of 255. So the thread walks the Jacobian one column c' at a
// time (nc sums live), recomputing grad u_h at each qp of each pass and
// reading the per-qp inputs again from L1.
//
// What bounds it on the H100: "state" by bytes once a coefficient varies
// per qp (the grid once, those (E, Q) tensors, nc rows written per
// element); with scalar kappa and m the grid and the rows alone weigh
// about as much as its operations (about 2 nc (1 + DIM) per qp and
// corner), and the operations lead on hex. A velocity component adds Q
// values per element where it varies. "full" writes nc + nc*nc rows
// and reads 4-5 (E, Q) tensors: bytes still lead the count of the
// function's operations (nc*nc*(2 + 2 DIM) per qp), but the column passes
// repeat the gradient (nc passes) and re-read the per-qp inputs, which the
// bound does not charge. The TPU kernel traced the coefficient expressions
// into its body; here a torch pre-pass evaluates them (ROADMAP: in-kernel
// coefficient codegen). No tiling, TMA or wgmma yet: this version is the
// simple, right one; making it fast is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNc = 9;

struct Lattice {
  int off[kMaxNc][3];  // local dof c -> offset on axes 0, 1, 2
  int stride;
};

struct Geometry {
  int N0, N1, N2;  // element grid (N2 = 1 in 2D)
  int G1, G2;      // grid axes 1 and 2 (G2 = 1 in 2D)
  long long E;
};

// the advection velocity: component d is p[d][e*Q + q] or, where p[d] is
// null, the scalar s[d]
template <typename T>
struct Velocity {
  const T* p[3];
  T s[3];
  __device__ __forceinline__ T at(int d, long long eq) const {
    return p[d] ? p[d][eq] : s[d];
  }
};

// b . v at entry eq = e*Q + q
template <typename T, int DIM>
__device__ __forceinline__ T dot_b(const Velocity<T>& b, long long eq,
                                   const T v[DIM]) {
  T a = b.at(0, eq) * v[0];
#pragma unroll
  for (int d = 1; d < DIM; ++d) a += b.at(d, eq) * v[d];
  return a;
}

// shared-memory tables: phi (nc, Q), grad (nc, Q, DIM), wts (Q)
template <typename T, int DIM, int NC>
__device__ __forceinline__ void load_tables(const T* __restrict__ phi,
                                            const T* __restrict__ grad,
                                            const T* __restrict__ wts, int Q,
                                            T* s) {
  const int n = NC * Q * (1 + DIM) + Q;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int a = NC * Q, b = NC * Q * DIM;
    s[i] = i < a ? phi[i] : (i < a + b ? grad[i - a] : wts[i - a - b]);
  }
  __syncthreads();
}

// the element's nc grid values, local dofs in dofmap order
template <typename T, int DIM, int NC>
__device__ __forceinline__ void gather(const T* __restrict__ grid,
                                       const Lattice& lat,
                                       const Geometry& g, long long e,
                                       T uc[NC]) {
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
  const int p = lat.stride;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const long long i = p * I + lat.off[c][0], j = p * J + lat.off[c][1],
                    k = p * K + lat.off[c][2];
    uc[c] = grid[(i * g.G1 + j) * g.G2 + k];
  }
}

template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT>
__global__ void __launch_bounds__(kThreads)
    elem_state_kernel(const T* __restrict__ grid, const T* __restrict__ kappa,
                      T kappa0, int kappa_is_scalar,
                      const T* __restrict__ mass, T mass0, int mass_is_scalar,
                      T alpha_u, T alpha_t, Velocity<T> vel,
                      const T* __restrict__ phi_g,
                      const T* __restrict__ grad_g,
                      const T* __restrict__ wts_g, int Q, Lattice lat,
                      Geometry geo, T* __restrict__ rows) {
  extern __shared__ unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  load_tables<T, DIM, NC>(phi_g, grad_g, wts_g, Q, s);
  const T* phi = s;
  const T* grad = s + NC * Q;
  const T* wts = s + NC * Q * (1 + DIM);

  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= geo.E) return;
  T uc[NC];
  gather<T, DIM, NC>(grid, lat, geo, e, uc);
  T r[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) r[c] = T(0);
  for (int q = 0; q < Q; ++q) {
    T gq[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      T v = T(0);
#pragma unroll
      for (int c = 0; c < NC; ++c) v += grad[(c * Q + q) * DIM + d] * uc[c];
      gq[d] = v;
    }
    const T k = kappa_is_scalar ? kappa0 : kappa[e * Q + q];
    T flux[DIM];
    // the source lane of the state part: m alpha_t u_h in a stage, plus
    // b . grad(alpha_u u_h) with advection
    [[maybe_unused]] T mu = T(0);
    if constexpr (TRANSIENT) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) gq[d] = alpha_u * gq[d];
      T uh = T(0);
#pragma unroll
      for (int c = 0; c < NC; ++c) uh += phi[c * Q + q] * uc[c];
      const T m = mass_is_scalar ? mass0 : mass[e * Q + q];
      mu = m * (alpha_t * uh);
    }
#pragma unroll
    for (int d = 0; d < DIM; ++d) flux[d] = k * gq[d];
    if constexpr (ADVECT) {
      const T adv = dot_b<T, DIM>(vel, e * Q + q, gq);
      mu = TRANSIENT ? mu + adv : adv;
    }
    const T w = wts[q];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T a = T(0);
#pragma unroll
      for (int d = 0; d < DIM; ++d) a += grad[(c * Q + q) * DIM + d] * flux[d];
      if constexpr (TRANSIENT || ADVECT) a = phi[c * Q + q] * mu + a;
      r[c] += w * a;
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) rows[c * geo.E + e] = r[c];
}

template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT>
__global__ void __launch_bounds__(kThreads)
    elem_full_kernel(const T* __restrict__ grid, const T* __restrict__ S,
                     const T* __restrict__ dS, const T* __restrict__ K,
                     const T* __restrict__ dK, const T* __restrict__ mass,
                     T mass0, int mass_is_scalar, T alpha_u, T alpha_t,
                     Velocity<T> vel, const T* __restrict__ phi_g, const T* __restrict__ grad_g,
                     const T* __restrict__ wts_g, int Q, Lattice lat,
                     Geometry geo, T* __restrict__ rows,
                     T* __restrict__ jac) {
  extern __shared__ unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  load_tables<T, DIM, NC>(phi_g, grad_g, wts_g, Q, s);
  const T* phi = s;
  const T* grad = s + NC * Q;
  const T* wts = s + NC * Q * (1 + DIM);

  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= geo.E) return;
  T uc[NC];
  gather<T, DIM, NC>(grid, lat, geo, e, uc);

  // grad u_h at qp q
  auto qp_grad = [&](int q, T gq[DIM]) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      T v = T(0);
#pragma unroll
      for (int c = 0; c < NC; ++c) v += grad[(c * Q + q) * DIM + d] * uc[c];
      gq[d] = v;
    }
  };

  {  // residual rows
    T r[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) r[c] = T(0);
    for (int q = 0; q < Q; ++q) {
      T gq[DIM];
      qp_grad(q, gq);
      const T kq = K[e * Q + q], w = wts[q];
      T sq = S[e * Q + q];
      if constexpr (ADVECT) sq += dot_b<T, DIM>(vel, e * Q + q, gq);
      T flux[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) flux[d] = kq * gq[d];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        T a = phi[c * Q + q] * sq;
#pragma unroll
        for (int d = 0; d < DIM; ++d)
          a += grad[(c * Q + q) * DIM + d] * flux[d];
        r[c] += w * a;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) rows[c * geo.E + e] = r[c];
  }

  // Jacobian, one column c' per pass
#pragma unroll 1
  for (int cp = 0; cp < NC; ++cp) {
    T J[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) J[c] = T(0);
    for (int q = 0; q < Q; ++q) {
      T gq[DIM];
      qp_grad(q, gq);
      const T kq = K[e * Q + q], dkq = dK[e * Q + q], dsq = dS[e * Q + q];
      const T w = wts[q], pcp = phi[cp * Q + q];
      // column c': tangent of S and of F_d along phi_c'
      T ts = pcp * dsq;
      if constexpr (ADVECT) ts += dot_b<T, DIM>(vel, e * Q + q,
                                                &grad[(cp * Q + q) * DIM]);
      T tf[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        tf[d] = pcp * (dkq * gq[d]) + grad[(cp * Q + q) * DIM + d] * kq;
      if constexpr (TRANSIENT) {
        const T mq = mass_is_scalar ? mass0 : mass[e * Q + q];
        ts = alpha_u * ts + alpha_t * (pcp * mq);
#pragma unroll
        for (int d = 0; d < DIM; ++d) tf[d] = alpha_u * tf[d];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        T a = phi[c * Q + q] * ts;
#pragma unroll
        for (int d = 0; d < DIM; ++d) a += grad[(c * Q + q) * DIM + d] * tf[d];
        J[c] += w * a;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      jac[(long long)(c * NC + cp) * geo.E + e] = J[c];
  }
}

bool make_geometry(const int* lattice, int nc, int dim, int stride, int N0,
                   int N1, int N2, Lattice& lat, Geometry& geo) {
  if (nc > kMaxNc || (dim != 2 && dim != 3)) return false;
  for (int c = 0; c < nc; ++c)
    for (int d = 0; d < 3; ++d)
      lat.off[c][d] = d < dim ? lattice[c * dim + d] : 0;
  lat.stride = stride;
  geo.N0 = N0;
  geo.N1 = N1;
  geo.N2 = dim == 3 ? N2 : 1;
  geo.G1 = stride * N1 + 1;
  geo.G2 = dim == 3 ? stride * N2 + 1 : 1;
  geo.E = (long long)N0 * N1 * geo.N2;
  return true;
}

int blocks_for(long long E) { return (int)((E + kThreads - 1) / kThreads); }

template <typename T, int DIM, int NC>
size_t smem_bytes(int Q) {
  return sizeof(T) * (size_t)(NC * Q * (1 + DIM) + Q);
}

template <typename T>
Velocity<T> make_velocity(const void* const v[3], const double s[3]) {
  Velocity<T> b;
  for (int d = 0; d < 3; ++d) {
    b.p[d] = (const T*)v[d];
    b.s[d] = (T)s[d];
  }
  return b;
}

template <typename T, int DIM, int NC>
int launch_state_case(const void* grid, const void* kappa, double kappa0,
                      int kappa_is_scalar, const void* mass, double mass0,
                      int mass_is_scalar, double alpha_u, double alpha_t,
                      int transient, int advect, const Velocity<T>& vel,
                      const void* phi, const void* grad, const void* wts,
                      int Q, const Lattice& lat, const Geometry& geo,
                      void* rows, void* stream) {
  auto kernel =
      advect ? (transient ? elem_state_kernel<T, DIM, NC, true, true>
                          : elem_state_kernel<T, DIM, NC, false, true>)
             : (transient ? elem_state_kernel<T, DIM, NC, true, false>
                          : elem_state_kernel<T, DIM, NC, false, false>);
  kernel<<<blocks_for(geo.E), kThreads, smem_bytes<T, DIM, NC>(Q),
           (cudaStream_t)stream>>>(
      (const T*)grid, (const T*)kappa, (T)kappa0, kappa_is_scalar,
      (const T*)mass, (T)mass0, mass_is_scalar, (T)alpha_u, (T)alpha_t, vel,
      (const T*)phi, (const T*)grad, (const T*)wts, Q, lat, geo, (T*)rows);
  return (int)cudaGetLastError();
}

template <typename T, int DIM, int NC>
int launch_full_case(const void* grid, const void* S, const void* dS,
                     const void* K, const void* dK, const void* mass,
                     double mass0, int mass_is_scalar, double alpha_u,
                     double alpha_t, int transient, int advect,
                     const Velocity<T>& vel, const void* phi,
                     const void* grad, const void* wts, int Q,
                     const Lattice& lat, const Geometry& geo, void* rows,
                     void* jac, void* stream) {
  auto kernel =
      advect ? (transient ? elem_full_kernel<T, DIM, NC, true, true>
                          : elem_full_kernel<T, DIM, NC, false, true>)
             : (transient ? elem_full_kernel<T, DIM, NC, true, false>
                          : elem_full_kernel<T, DIM, NC, false, false>);
  kernel<<<blocks_for(geo.E), kThreads, smem_bytes<T, DIM, NC>(Q),
           (cudaStream_t)stream>>>(
      (const T*)grid, (const T*)S, (const T*)dS, (const T*)K, (const T*)dK,
      (const T*)mass, (T)mass0, mass_is_scalar, (T)alpha_u, (T)alpha_t, vel,
      (const T*)phi, (const T*)grad, (const T*)wts, Q, lat, geo, (T*)rows,
      (T*)jac);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_state(const void* grid, const void* kappa, double kappa0,
                 int kappa_is_scalar, const void* mass, double mass0,
                 int mass_is_scalar, double alpha_u, double alpha_t,
                 int transient, int advect, const void* const v[3],
                 const double vs[3], const void* phi, const void* grad,
                 const void* wts, int Q, int nc, int dim, const int* lattice,
                 int stride, int N0, int N1, int N2, void* rows,
                 void* stream) {
  Lattice lat;
  Geometry geo;
  if (!make_geometry(lattice, nc, dim, stride, N0, N1, N2, lat, geo))
    return (int)cudaErrorInvalidValue;
  const Velocity<T> vel = make_velocity<T>(v, vs);
  if (dim == 3 && nc == 8)
    return launch_state_case<T, 3, 8>(
        grid, kappa, kappa0, kappa_is_scalar, mass, mass0, mass_is_scalar,
        alpha_u, alpha_t, transient, advect, vel, phi, grad, wts, Q, lat,
        geo, rows, stream);
  if (dim == 2 && nc == 9)
    return launch_state_case<T, 2, 9>(
        grid, kappa, kappa0, kappa_is_scalar, mass, mass0, mass_is_scalar,
        alpha_u, alpha_t, transient, advect, vel, phi, grad, wts, Q, lat,
        geo, rows, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_full(const void* grid, const void* S, const void* dS,
                const void* K, const void* dK, const void* mass, double mass0,
                int mass_is_scalar, double alpha_u, double alpha_t,
                int transient, int advect, const void* const v[3],
                const double vs[3], const void* phi, const void* grad,
                const void* wts, int Q, int nc, int dim, const int* lattice,
                int stride, int N0, int N1, int N2, void* rows, void* jac,
                void* stream) {
  Lattice lat;
  Geometry geo;
  if (!make_geometry(lattice, nc, dim, stride, N0, N1, N2, lat, geo))
    return (int)cudaErrorInvalidValue;
  const Velocity<T> vel = make_velocity<T>(v, vs);
  if (dim == 3 && nc == 8)
    return launch_full_case<T, 3, 8>(
        grid, S, dS, K, dK, mass, mass0, mass_is_scalar, alpha_u, alpha_t,
        transient, advect, vel, phi, grad, wts, Q, lat, geo, rows, jac,
        stream);
  if (dim == 2 && nc == 9)
    return launch_full_case<T, 2, 9>(
        grid, S, dS, K, dK, mass, mass0, mass_is_scalar, alpha_u, alpha_t,
        transient, advect, vel, phi, grad, wts, Q, lat, geo, rows, jac,
        stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes (see ops/_build.py). Each
// returns the cudaGetLastError() of its launch (cudaErrorInvalidValue for
// a (dim, nc) with no instantiation). transient = 0 selects the steady
// kernels, which read neither mass nor the alphas; advect = 0 the kernels
// without advection, which read no velocity. Velocity component d is the
// (E, Q) array v<d> or, where that is null, the scalar v<d>s. lattice is
// a HOST array of nc*dim ints.
extern "C" {

#define VEL_ARGS                                                            \
  int advect, const void *v0, double v0s, const void *v1, double v1s,      \
      const void *v2, double v2s

#define ELEM_GEOMETRY                                                       \
  const void *phi, const void *grad, const void *wts, int Q, int nc,        \
      int dim, const int *lattice, int stride, int N0, int N1, int N2
#define ELEM_GEOMETRY_PASS \
  phi, grad, wts, Q, nc, dim, lattice, stride, N0, N1, N2
#define VEL_PASS advect, v, vs
#define STATE_ARGS                                                          \
  const void *grid, const void *kappa, double kappa0, int kappa_is_scalar,  \
      const void *mass, double mass0, int mass_is_scalar, double alpha_u,   \
      double alpha_t, int transient, VEL_ARGS, ELEM_GEOMETRY, void *rows,   \
      void *stream
#define STATE_PASS                                                          \
  grid, kappa, kappa0, kappa_is_scalar, mass, mass0, mass_is_scalar,        \
      alpha_u, alpha_t, transient, VEL_PASS, ELEM_GEOMETRY_PASS, rows,      \
      stream
#define FULL_ARGS                                                           \
  const void *grid, const void *S, const void *dS, const void *K,           \
      const void *dK, const void *mass, double mass0, int mass_is_scalar,   \
      double alpha_u, double alpha_t, int transient, VEL_ARGS,              \
      ELEM_GEOMETRY, void *rows, void *jac, void *stream
#define FULL_PASS                                                           \
  grid, S, dS, K, dK, mass, mass0, mass_is_scalar, alpha_u, alpha_t,        \
      transient, VEL_PASS, ELEM_GEOMETRY_PASS, rows, jac, stream
#define VEL_ARRAYS                                                          \
  const void* const v[3] = {v0, v1, v2};                                    \
  const double vs[3] = {v0s, v1s, v2s}

int thermal_elem_state_f64(STATE_ARGS) {
  VEL_ARRAYS;
  return launch_state<double>(STATE_PASS);
}

int thermal_elem_state_f32(STATE_ARGS) {
  VEL_ARRAYS;
  return launch_state<float>(STATE_PASS);
}

int thermal_elem_full_f64(FULL_ARGS) {
  VEL_ARRAYS;
  return launch_full<double>(FULL_PASS);
}

int thermal_elem_full_f32(FULL_ARGS) {
  VEL_ARRAYS;
  return launch_full<float>(FULL_PASS);
}

}  // extern "C"
