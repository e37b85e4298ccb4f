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
// tiles with a double-buffered pipeline; none of that carries over. The
// kernels write every row: for thermal, "state" varies in all nc rows and
// "full" in all nc and nc*nc (the JAX package's probe finds the same), so
// there are no constant rows to fold. Any element grid works (the last
// tile masks its missing elements), and the sums are deterministic.
//
// "state": one thread owns one element: it gathers its nc grid values
// (neighbouring threads read neighbouring addresses, and the values shared
// between elements come from L1/L2), loops over the quadrature points with
// the reference tables phi, grad, wts in shared memory, and writes its
// rows SoA, so a warp writes 32 consecutive addresses per row. The sums
// run in the plain version's order (q outer, corners inner). A scalar
// velocity component is read from the kernel's parameters; an (E, Q) one
// at each qp where it is used.
//
// "full": linearize each qp once, then contract. The weak form's
// linearization at a qp is 2 + DIM scalars (2 + 2 DIM with advection),
// and on a uniform grid the basis products they multiply are the same in
// every element, so the Jacobian rows of a block of elements are one
// small GEMM, (elements x Q kinds) times (Q kinds x nc^2) (FullLayout).
// A persistent grid of 256-thread blocks builds the weighted basis
// products once per block in shared memory, in the B-fragment order of
// mma.sync m8n8k4, and walks tiles of 64 elements, 8 per warp (a warp's
// octet, M = 8). Each lane owns one element and one qp of every group of
// 4 (K = 4): it reads its qp's S, dS, K, dK (m, b) once, a group ahead of
// their use, computes grad u_h there and the qp scalars, and the warp
// steps its octet's sums through the fragments, 8 entries at a time (N =
// 8): 2 f64 sums per lane and fragment, 16 (hex) or 22 (p2) in all, where
// one thread per element would hold 64-81. f64 steps on the tensor cores
// (DMMA); f32 (TF32 would not hold 1e-5) and the host build of the tests
// on FMA, each lane summing its two entries from the group's A values
// (warp shuffles) and the fragments' B values. The residual rows are the
// same GEMM with 1 + DIM kinds. Rows are stored SoA from the fragments, 8
// consecutive elements (64 bytes) per row and lane group. Where the
// fragments of all qps would pass kFragBytes (a high quadrature), they
// are rebuilt per chunk of qp groups.
//
// What bounds it on the H100: "state" by bytes once a coefficient varies
// per qp (the grid once, those (E, Q) tensors, nc rows written per
// element); with scalar kappa and m the grid and the rows alone weigh
// about as much as its operations (about 2 nc (1 + DIM) per qp and
// corner), and the operations lead on hex. A velocity component adds Q
// values per element where it varies. "full" writes nc + nc*nc rows and
// reads 4-5 (E, Q) tensors once: bytes lead. Its GEMM (about 2.6 K FMA
// per hex element, 4.1 K with advection) runs on DMMA in f64, under the
// bytes; a thread per element walking the Jacobian a column c' per pass
// (nc sums live) would repeat grad u_h and re-read the inputs nc times,
// bound by its FMAs (PERF.md). The TPU kernel traced the coefficient
// expressions into its body; here a torch pre-pass evaluates them
// (ROADMAP: in-kernel coefficient codegen).

#include <cuda_runtime.h>

#include <type_traits>

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

// ---------------------------------------------------------------------
// mode "full": linearize each qp once, then contract (the note above)
// ---------------------------------------------------------------------

// f64 contracts on the tensor cores (DMMA, mma.sync m8n8k4); f32, and the
// host build of the tests, on FMA through the same fragments
template <typename T>
struct UseDmma {
#if defined(__CUDA_ARCH__)
  static constexpr bool value = std::is_same<T, double>::value;
#else
  static constexpr bool value = false;
#endif
};

// The GEMM of mode "full", per qp q and element e: the qp scalars A (E x
// kinds) times the weighted basis products B (kinds x entries), summed
// over the qps. Jacobian kinds: a = alpha_u dS + alpha_t m with phi_c
// phi_c'; p_d = alpha_u dK d_d u_h with d_d phi_c phi_c'; kappa =
// alpha_u K with grad phi_c . grad phi_c'; with advection beta_d =
// alpha_u b_d with phi_c d_d phi_c'. Residual kinds: s = S + b . grad
// u_h with phi_c; f_d = K d_d u_h with d_d phi_c. Each m8n8k4 step takes
// 8 elements (a warp's octet) on M, 4 qps of one kind on K and 8 entries
// (c nc + c', or c) on N; lane l = 4 g + t holds A[g][t] (element g, qp
// 4 i + t), the B fragment B[t][g] and the sums C[g][2 t], C[g][2 t + 1].
template <int DIM, int NC, bool ADVECT>
struct FullLayout {
  static constexpr int NKJ = 2 + DIM + (ADVECT ? DIM : 0);
  static constexpr int NKR = 1 + DIM;
  static constexpr int NTJ = (NC * NC + 7) / 8;  // fragments of entries
  static constexpr int NTR = (NC + 7) / 8;
  static constexpr int NF = NKJ * NTJ + NKR * NTR;  // fragments per 4 qps
  static constexpr int kTile = kThreads / 4;  // elements: 8 per warp
  // shared memory, in T: the tables phi, grad, wts (as load_tables), then
  // from a 16-byte boundary the B fragments of `qic` groups of 4 qps
  __host__ __device__ static long long fragments(int Q) {
    return ((long long)NC * Q * (1 + DIM) + Q + 3) / 4 * 4;
  }
  __host__ __device__ static long long total(int Q, int qic) {
    return fragments(Q) + (long long)qic * NF * 32;
  }
};
// the B fragments a block keeps at once, in bytes; past them the qps
// take several chunks, the fragments rebuilt per chunk
#ifndef THERMAL_FULL_FRAG_BYTES
#define THERMAL_FULL_FRAG_BYTES (96 * 1024)
#endif
constexpr long long kFragBytes = THERMAL_FULL_FRAG_BYTES;

// the B fragments of qp groups qi0 .. qi0 + nqi - 1, 32 values each, in
// order (group, Jacobian kind, entry fragment), then (group, residual
// kind, entry fragment): value l of a fragment is B[l % 4][l / 4]
// the weighted basis product of Jacobian kind `kind` at qp q, entry (c,
// c'), and of residual kind `kind` at qp q, row c (FullLayout's kinds)
template <typename T, int DIM, int NC>
__device__ __forceinline__ T jac_table(const T* phi, const T* grad,
                                       const T* wts, int Q, int kind, int q,
                                       int c, int cp) {
  const T w = wts[q];
  const T* gc = grad + (c * Q + q) * DIM;
  const T* gcp = grad + (cp * Q + q) * DIM;
  if (kind == 0) return w * (phi[c * Q + q] * phi[cp * Q + q]);
  if (kind <= DIM) return w * (gc[kind - 1] * phi[cp * Q + q]);
  if (kind == DIM + 1) {
    T x = gc[0] * gcp[0];
    for (int d = 1; d < DIM; ++d) x += gc[d] * gcp[d];
    return w * x;
  }
  return w * (phi[c * Q + q] * gcp[kind - DIM - 2]);
}

template <typename T, int DIM, int NC>
__device__ __forceinline__ T res_table(const T* phi, const T* grad,
                                       const T* wts, int Q, int kind, int q,
                                       int c) {
  return wts[q] * (kind == 0 ? phi[c * Q + q]
                             : grad[(c * Q + q) * DIM + kind - 1]);
}

// the B fragments of qp groups qi0 .. qi0 + nqi - 1, 32 values each, in
// order (group, Jacobian kind, entry fragment), then (group, residual
// kind, entry fragment): value l of a fragment is B[l % 4][l / 4]
template <typename T, int DIM, int NC, bool ADVECT>
__device__ __forceinline__ void build_fragments(const T* phi, const T* grad,
                                                const T* wts, int Q,
                                                int qi0, int nqi, T* fr) {
  using F = FullLayout<DIM, NC, ADVECT>;
  const int n = nqi * F::NF * 32;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int l = i % 32, f = (i / 32) % F::NF, qq = i / (32 * F::NF);
    const int q = 4 * (qi0 + qq) + l % 4;
    T v = T(0);
    if (q < Q) {
      if (f < F::NKJ * F::NTJ) {
        const int k = 8 * (f % F::NTJ) + l / 4;
        if (k < NC * NC)
          v = jac_table<T, DIM, NC>(phi, grad, wts, Q, f / F::NTJ, q,
                                    k / NC, k % NC);
      } else {
        const int r = f - F::NKJ * F::NTJ;
        const int c = 8 * (r % F::NTR) + l / 4;
        if (c < NC)
          v = res_table<T, DIM, NC>(phi, grad, wts, Q, r / F::NTR, q, c);
      }
    }
    fr[i] = v;
  }
}

// f32's layout: a thread owns one element and half of its entries
// (kThreads / 2 elements per tile; warp w holds half w % 2 of 32
// consecutive elements, so its rows are stored 128 bytes at a time), and
// sums them from the qp scalars and the weighted basis products per qp,
// kind-major, the entries padded to NN: the same values as the fragments,
// read as broadcasts. The first half also sums the residual rows.
template <int DIM, int NC, bool ADVECT>
struct RowLayout {
  using F = FullLayout<DIM, NC, ADVECT>;
  static constexpr int NN = (NC * NC + 7) / 8 * 8;
  static constexpr int H = NN / 2;  // entries per thread
  static constexpr int NR = (NC + 3) / 4 * 4;
  static constexpr int PQ = F::NKJ * NN + F::NKR * NR;  // per qp
  static constexpr int kTile = kThreads / 2;
  __host__ __device__ static long long total(int Q, int qc) {
    return F::fragments(Q) + (long long)qc * PQ;
  }
};

// the per-qp products of qps q0 .. q0 + nq - 1 (RowLayout)
template <typename T, int DIM, int NC, bool ADVECT>
__device__ __forceinline__ void build_rows(const T* phi, const T* grad,
                                           const T* wts, int Q, int q0,
                                           int nq, T* tb) {
  using R = RowLayout<DIM, NC, ADVECT>;
  constexpr int NJ = R::F::NKJ * R::NN;
  const int n = nq * R::PQ;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i % R::PQ, q = q0 + i / R::PQ;
    T v = T(0);
    if (r < NJ) {
      const int k = r % R::NN;
      if (k < NC * NC)
        v = jac_table<T, DIM, NC>(phi, grad, wts, Q, r / R::NN, q, k / NC,
                                  k % NC);
    } else {
      const int c = (r - NJ) % R::NR;
      if (c < NC)
        v = res_table<T, DIM, NC>(phi, grad, wts, Q, (r - NJ) / R::NR, q, c);
    }
    tb[i] = v;
  }
}

// the A values of the 4 lanes of this lane's group (element), FMA path
template <typename T>
__device__ __forceinline__ void group_values(const T a, T (&ag)[4],
                                             const int lane) {
  if constexpr (!UseDmma<T>::value) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ag[k] = __shfl_sync(0xffffffffu, a, (lane & ~3) | k);
  }
}

// four consecutive values of shared memory from a 16-byte boundary
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const double2 x = *reinterpret_cast<const double2*>(p);
    const double2 y = *reinterpret_cast<const double2*>(p + 2);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = y.x;
    v[3] = y.y;
  }
#else
  for (int k = 0; k < 4; ++k) v[k] = p[k];
#endif
}

// one m8n8k4 step, C += A B: on DMMA from this lane's a and fragment
// value b[lane], else on FMA from the group's A values ag and the B
// values of lanes 8 t + k (column 2 t) and 8 t + 4 + k (column 2 t + 1)
template <typename T>
__device__ __forceinline__ void frag_step(T& c0, T& c1, const T a,
                                          const T (&ag)[4],
                                          const T* __restrict__ b,
                                          const int lane) {
  if constexpr (UseDmma<T>::value) {
#if defined(__CUDA_ARCH__)
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
        "{%3}, {%0, %1};"
        : "+d"(c0), "+d"(c1)
        : "d"(a), "d"(b[lane]));
#endif
  } else {
    T b0[4], b1[4];
    load4<T>(b + 8 * (lane & 3), b0);
    load4<T>(b + 8 * (lane & 3) + 4, b1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c0 += ag[k] * b0[k];
      c1 += ag[k] * b1[k];
    }
  }
}

// one lane's inputs at a qp
template <typename T, int DIM>
struct QpIn {
  T s, ds, k, dk, m, b[DIM];
};

// this lane's qp scalars at qp q from its inputs `in` and corner values
// uc: the Jacobian kinds aj and the residual kinds ar (FullLayout)
template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT>
__device__ __forceinline__ void qp_scalars(
    const QpIn<T, DIM>& in, const T (&uc)[NC], const T* grad, int Q, int q,
    T alpha_u, T alpha_t, T (&aj)[FullLayout<DIM, NC, ADVECT>::NKJ],
    T (&ar)[FullLayout<DIM, NC, ADVECT>::NKR]) {
  T gq[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    T v = T(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) v += grad[(c * Q + q) * DIM + d] * uc[c];
    gq[d] = v;
  }
  ar[0] = in.s;
  if constexpr (ADVECT) {
    T adv = in.b[0] * gq[0];
#pragma unroll
    for (int d = 1; d < DIM; ++d) adv += in.b[d] * gq[d];
    ar[0] += adv;
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) ar[1 + d] = in.k * gq[d];
  const T au = TRANSIENT ? alpha_u : T(1);
  aj[0] = TRANSIENT ? alpha_u * in.ds + alpha_t * in.m : in.ds;
#pragma unroll
  for (int d = 0; d < DIM; ++d) aj[1 + d] = au * (in.dk * gq[d]);
  aj[1 + DIM] = au * in.k;
  if constexpr (ADVECT) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) aj[2 + DIM + d] = au * in.b[d];
  }
}

// the arguments of mode "full"
template <typename T>
struct FullArgs {
  const T* __restrict__ grid;
  const T* __restrict__ S;
  const T* __restrict__ dS;
  const T* __restrict__ K;
  const T* __restrict__ dK;
  const T* __restrict__ mass;
  T mass0;
  int mass_is_scalar;
  T alpha_u, alpha_t;
  Velocity<T> vel;
  int Q;
  int qc;  // fragments: qp groups per chunk; rows: qps per chunk
  Lattice lat;
  Geometry geo;
  T* __restrict__ rows;
  T* __restrict__ jac;
};

// one lane's inputs at qp entry eq (S, dS, K, dK; m in a stage; b with
// advection), read a qp group ahead of their use; 0 where `on` is false
template <typename T, int DIM, bool TRANSIENT, bool ADVECT>
__device__ __forceinline__ QpIn<T, DIM> load_qp(const FullArgs<T>& a,
                                                const bool on,
                                                const long long eq) {
  QpIn<T, DIM> in;
  in.s = in.ds = in.k = in.dk = in.m = T(0);
#pragma unroll
  for (int d = 0; d < DIM; ++d) in.b[d] = T(0);
  if (on) {
    in.s = a.S[eq];
    in.ds = a.dS[eq];
    in.k = a.K[eq];
    in.dk = a.dK[eq];
    if constexpr (TRANSIENT) in.m = a.mass_is_scalar ? a.mass0 : a.mass[eq];
    if constexpr (ADVECT) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) in.b[d] = a.vel.at(d, eq);
    }
  }
  return in;
}

// f64 (and the f64 FMA form): the fragments' GEMM (FullLayout)
template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT>
__device__ __forceinline__ void full_fragments(const FullArgs<T>& a,
                                               const T* phi, const T* grad,
                                               const T* wts, T* fr) {
  using F = FullLayout<DIM, NC, ADVECT>;
  constexpr int NKJ = F::NKJ, NKR = F::NKR, NTJ = F::NTJ, NTR = F::NTR;
  const int Q = a.Q, qic = a.qc;
  const Geometry& geo = a.geo;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int qis = (Q + 3) / 4, nch = (qis + qic - 1) / qic;
  const long long tiles = (geo.E + F::kTile - 1) / F::kTile;
  // every thread of the block walks the same tiles (the barriers below)
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long e = tile * F::kTile + (threadIdx.x >> 2);
    const bool valid = e < geo.E;
    // the first qp group's inputs, read beside the corner values
    QpIn<T, DIM> cur =
        load_qp<T, DIM, TRANSIENT, ADVECT>(a, valid && t < Q, e * Q + t);
    T uc[NC];
    if (valid) {
      gather<T, DIM, NC>(a.grid, a.lat, geo, e, uc);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) uc[c] = T(0);
    }
    T cj[NTJ][2], cr[NTR][2];
#pragma unroll
    for (int n = 0; n < NTJ; ++n) cj[n][0] = cj[n][1] = T(0);
#pragma unroll
    for (int n = 0; n < NTR; ++n) cr[n][0] = cr[n][1] = T(0);
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const int qi0 = ch * qic;
      const int nqi = qis - qi0 < qic ? qis - qi0 : qic;
      if (ch > 0)
        cur = load_qp<T, DIM, TRANSIENT, ADVECT>(
            a, valid && 4 * qi0 + t < Q, e * Q + 4 * qi0 + t);
      if (nch > 1 || tile == blockIdx.x) {
        if (tile != blockIdx.x || ch > 0) __syncthreads();
        build_fragments<T, DIM, NC, ADVECT>(phi, grad, wts, Q, qi0, nqi,
                                            fr);
        __syncthreads();
      }
#pragma unroll 1
      for (int qq = 0; qq < nqi; ++qq) {
        // linearize: this lane's qp scalars (0 past Q and past E), while
        // the next group's inputs load
        const int q = 4 * (qi0 + qq) + t;
        const QpIn<T, DIM> nxt = load_qp<T, DIM, TRANSIENT, ADVECT>(
            a, valid && qq + 1 < nqi && q + 4 < Q, e * Q + q + 4);
        T aj[NKJ], ar[NKR];
#pragma unroll
        for (int k = 0; k < NKJ; ++k) aj[k] = T(0);
#pragma unroll
        for (int k = 0; k < NKR; ++k) ar[k] = T(0);
        if (valid && q < Q)
          qp_scalars<T, DIM, NC, TRANSIENT, ADVECT>(
              cur, uc, grad, Q, q, a.alpha_u, a.alpha_t, aj, ar);
        cur = nxt;
        // contract with the fragments of these 4 qps
        const T* fq = fr + (long long)qq * F::NF * 32;
#pragma unroll
        for (int k = 0; k < NKJ; ++k) {
          T ag[4];
          group_values<T>(aj[k], ag, lane);
#pragma unroll
          for (int n = 0; n < NTJ; ++n)
            frag_step<T>(cj[n][0], cj[n][1], aj[k], ag,
                         fq + (k * NTJ + n) * 32, lane);
        }
#pragma unroll
        for (int k = 0; k < NKR; ++k) {
          T ag[4];
          group_values<T>(ar[k], ag, lane);
#pragma unroll
          for (int n = 0; n < NTR; ++n)
            frag_step<T>(cr[n][0], cr[n][1], ar[k], ag,
                         fq + (NKJ * NTJ + k * NTR + n) * 32, lane);
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int n = 0; n < NTR; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 8 * n + 2 * t + i;
          if (c < NC) a.rows[c * geo.E + e] = cr[n][i];
        }
#pragma unroll
      for (int n = 0; n < NTJ; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = 8 * n + 2 * t + i;
          if (k < NC * NC) a.jac[(long long)k * geo.E + e] = cj[n][i];
        }
    }
  }
}

// f32: a thread per (element, half of its entries) (RowLayout)
template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT>
__device__ __forceinline__ void full_rows(const FullArgs<T>& a,
                                          const T* phi, const T* grad,
                                          const T* wts, T* tb) {
  using R = RowLayout<DIM, NC, ADVECT>;
  constexpr int NKJ = R::F::NKJ, NKR = R::F::NKR, NN = R::NN, H = R::H;
  constexpr int NR = R::NR;
  const int Q = a.Q, qc = a.qc, nch = (Q + qc - 1) / qc;
  const Geometry& geo = a.geo;
  const int warp = threadIdx.x >> 5, half = warp & 1;
  const long long tiles = (geo.E + R::kTile - 1) / R::kTile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long e = tile * R::kTile + (warp >> 1) * 32 + (threadIdx.x & 31);
    const bool valid = e < geo.E;
    QpIn<T, DIM> cur = load_qp<T, DIM, TRANSIENT, ADVECT>(a, valid, e * Q);
    T uc[NC];
    if (valid) {
      gather<T, DIM, NC>(a.grid, a.lat, geo, e, uc);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) uc[c] = T(0);
    }
    T acc[H], res[NR];
#pragma unroll
    for (int n = 0; n < H; ++n) acc[n] = T(0);
#pragma unroll
    for (int n = 0; n < NR; ++n) res[n] = T(0);
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const int q0 = ch * qc, nq = Q - q0 < qc ? Q - q0 : qc;
      if (ch > 0)
        cur = load_qp<T, DIM, TRANSIENT, ADVECT>(a, valid, e * Q + q0);
      if (nch > 1 || tile == blockIdx.x) {
        if (tile != blockIdx.x || ch > 0) __syncthreads();
        build_rows<T, DIM, NC, ADVECT>(phi, grad, wts, Q, q0, nq, tb);
        __syncthreads();
      }
#pragma unroll 1
      for (int qq = 0; qq < nq; ++qq) {
        const int q = q0 + qq;
        const QpIn<T, DIM> nxt = load_qp<T, DIM, TRANSIENT, ADVECT>(
            a, valid && qq + 1 < nq, e * Q + q + 1);
        T aj[NKJ], ar[NKR];
#pragma unroll
        for (int k = 0; k < NKJ; ++k) aj[k] = T(0);
#pragma unroll
        for (int k = 0; k < NKR; ++k) ar[k] = T(0);
        if (valid)
          qp_scalars<T, DIM, NC, TRANSIENT, ADVECT>(
              cur, uc, grad, Q, q, a.alpha_u, a.alpha_t, aj, ar);
        cur = nxt;
        const T* tq = tb + (long long)qq * R::PQ;
#pragma unroll
        for (int k = 0; k < NKJ; ++k)
#pragma unroll
          for (int j = 0; j < H / 4; ++j) {
            T b[4];
            load4<T>(tq + k * NN + half * H + 4 * j, b);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[4 * j + i] += aj[k] * b[i];
          }
        if (half == 0) {
#pragma unroll
          for (int k = 0; k < NKR; ++k)
#pragma unroll
            for (int j = 0; j < NR / 4; ++j) {
              T b[4];
              load4<T>(tq + NKJ * NN + k * NR + 4 * j, b);
#pragma unroll
              for (int i = 0; i < 4; ++i) res[4 * j + i] += ar[k] * b[i];
            }
        }
      }
    }
    if (valid) {
      if (half == 0) {
#pragma unroll
        for (int c = 0; c < NC; ++c) a.rows[c * geo.E + e] = res[c];
      }
#pragma unroll
      for (int n = 0; n < H; ++n) {
        const int k = half * H + n;
        if (k < NC * NC) a.jac[(long long)k * geo.E + e] = acc[n];
      }
    }
  }
}

// f64 steps the fragments on DMMA; f32 takes a thread per (element, half
// of its entries), whose FMAs read the products as broadcasts
template <typename T>
struct RowsPath {
  static constexpr bool value = std::is_same<T, float>::value;
};

template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT>
__global__ void __launch_bounds__(kThreads, 2)
    elem_full_kernel(const FullArgs<T> a, const T* __restrict__ phi_g,
                     const T* __restrict__ grad_g,
                     const T* __restrict__ wts_g) {
  using F = FullLayout<DIM, NC, ADVECT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  load_tables<T, DIM, NC>(phi_g, grad_g, wts_g, a.Q, s);
  const T* phi = s;
  const T* grad = s + NC * a.Q;
  const T* wts = s + NC * a.Q * (1 + DIM);
  T* products = s + F::fragments(a.Q);
  if constexpr (RowsPath<T>::value)
    full_rows<T, DIM, NC, TRANSIENT, ADVECT>(a, phi, grad, wts, products);
  else
    full_fragments<T, DIM, NC, TRANSIENT, ADVECT>(a, phi, grad, wts,
                                                  products);
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


// what a launch returns where one chunk of mode "full" does not fit the
// card's shared memory per block (the wrapper raises on it)
constexpr int kErrSharedMemory = -1;

template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT>
int launch_full_kernel(const void* grid, const void* S, const void* dS,
                       const void* K, const void* dK, const void* mass,
                       double mass0, int mass_is_scalar, double alpha_u,
                       double alpha_t, const Velocity<T>& vel,
                       const void* phi, const void* grad, const void* wts,
                       int Q, const Lattice& lat, const Geometry& geo,
                       void* rows, void* jac, void* stream) {
  using F = FullLayout<DIM, NC, ADVECT>;
  using R = RowLayout<DIM, NC, ADVECT>;
  constexpr bool kRows = RowsPath<T>::value;
  auto kernel = elem_full_kernel<T, DIM, NC, TRANSIENT, ADVECT>;
  // the chunk, the shared memory and the resident blocks of the last Q
  // this kernel took, reused while it repeats
  static int last_q = 0, qc = 0, per_sm = 0, sms = 0;
  static size_t smem = 0;
  if (Q != last_q) {
    // fragments: qp groups of 4; rows: qps
    const int units = kRows ? Q : (Q + 3) / 4;
    const long long fit =
        kFragBytes / (long long)(sizeof(T) * (kRows ? R::PQ : F::NF * 32));
    qc = fit < 1 ? 1 : (fit < units ? (int)fit : units);
    smem = sizeof(T) * (size_t)(kRows ? R::total(Q, qc) : F::total(Q, qc));
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if ((long long)smem > optin) return kErrSharedMemory;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  smem);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    last_q = Q;
  }
  FullArgs<T> a;
  a.grid = (const T*)grid;
  a.S = (const T*)S;
  a.dS = (const T*)dS;
  a.K = (const T*)K;
  a.dK = (const T*)dK;
  a.mass = (const T*)mass;
  a.mass0 = (T)mass0;
  a.mass_is_scalar = mass_is_scalar;
  a.alpha_u = (T)alpha_u;
  a.alpha_t = (T)alpha_t;
  a.vel = vel;
  a.Q = Q;
  a.qc = qc;
  a.lat = lat;
  a.geo = geo;
  a.rows = (T*)rows;
  a.jac = (T*)jac;
  // a persistent grid: each block builds the products once and walks
  // tiles blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long tile = kRows ? R::kTile : F::kTile;
  const long long tiles = (geo.E + tile - 1) / tile;
  const long long fill = (long long)sms * (per_sm < 1 ? 1 : per_sm);
  const unsigned blocks = (unsigned)(tiles < fill ? tiles : fill);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      a, (const T*)phi, (const T*)grad, (const T*)wts);
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
  auto launch =
      advect ? (transient ? launch_full_kernel<T, DIM, NC, true, true>
                          : launch_full_kernel<T, DIM, NC, false, true>)
             : (transient ? launch_full_kernel<T, DIM, NC, true, false>
                          : launch_full_kernel<T, DIM, NC, false, false>);
  return launch(grid, S, dS, K, dK, mass, mass0, mass_is_scalar, alpha_u,
                alpha_t, vel, phi, grad, wts, Q, lat, geo, rows, jac,
                stream);
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
