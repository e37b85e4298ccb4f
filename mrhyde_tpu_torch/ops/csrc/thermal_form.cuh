// The scalar advection-diffusion-reaction weak form of the thermal
// kernels (fused_elem_thermal.cu, fused_p1_thermal.cu), linearized once
// per quadrature point and contracted with weighted basis products that a
// block builds once: the qp scalars ("kinds") of a lane's element at its
// qp, the products each kind multiplies, and their layouts in shared
// memory.
//
// Residual kinds (both modes), with the products w phi_c and w d_d phi_c:
//   s = S + b . grad u_h ("full"), or the state part's source lane
//       m alpha_t u_h + alpha_u b . grad u_h ("state");
//   f_d = K d_d u_h ("full"), or kappa alpha_u d_d u_h ("state").
// (qp_scalars forms those of "full"; the state kernel forms its own.)
// Jacobian kinds (mode "full"), with w phi_c phi_c', w d_d phi_c phi_c',
// w grad phi_c . grad phi_c' and, with advection, w phi_c d_d phi_c':
//   a = alpha_u dS + alpha_t m; p_d = alpha_u dK d_d u_h; kappa = alpha_u
//   K; beta_d = alpha_u b_d.
// The kinds of a qp are 1 + DIM residual scalars (and 2 + DIM, or 2 + 2
// DIM with advection, Jacobian ones); on a uniform grid the products are
// the same in every element, so the rows of a tile of elements are one
// small GEMM over (qps x kinds).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// Per qp q and element e: the qp scalars A (E x kinds) times the weighted
// basis products B (kinds x entries), summed over the qps. Each m8n8k4
// step takes 8 elements (a warp's octet) on M, 4 qps of one kind on K and
// 8 entries (c nc + c', or c) on N; lane l = 4 g + t holds A[g][t]
// (element g, qp 4 i + t), the B fragment B[t][g] and the sums C[g][2 t],
// C[g][2 t + 1].
template <int DIM, int NC, bool ADVECT>
struct FullLayout {
  static constexpr int NKJ = 2 + DIM + (ADVECT ? DIM : 0);
  static constexpr int NKR = 1 + DIM;
  static constexpr int NTJ = (NC * NC + 7) / 8;  // fragments of entries
  static constexpr int NTR = (NC + 7) / 8;
  static constexpr int NF = NKJ * NTJ + NKR * NTR;  // fragments per 4 qps
  static constexpr int kTile = kThreads / 4;  // elements: 8 per warp
  // shared memory, in T: the tables phi, grad, wts, then from a 16-byte
  // boundary the B fragments of `qic` groups of 4 qps
  __host__ __device__ static long long fragments(int Q) {
    return ((long long)NC * Q * (1 + DIM) + Q + 3) / 4 * 4;
  }
  __host__ __device__ static long long total(int Q, int qic) {
    return fragments(Q) + (long long)qic * NF * 32;
  }
};

// The weighted basis product of Jacobian kind `kind` at qp q, entry (c,
// c'), and of residual kind `kind` at qp q, row c (FullLayout's kinds),
// from the tables phi (nc, Q), grad (nc, Q, DIM), wts (Q)
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

// The layout where a thread owns one element, or half of its Jacobian
// entries, and sums them from the qp scalars and the products per qp,
// kind-major, the entries padded to NN and the rows to NR: the same
// values as the fragments, read as broadcasts (kTile elements a tile: two
// threads an element, the first half also summing the residual rows)
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

// f64 contracts on the tensor cores (DMMA, mma.sync m8n8k4); f32 takes
// other layouts, and the host build of the tests steps the same
// fragments on FMA
template <typename T>
struct UseDmma {
#if defined(__CUDA_ARCH__)
  static constexpr bool value = std::is_same<T, double>::value;
#else
  static constexpr bool value = false;
#endif
};

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

// one lane's inputs at a qp: S, dS, K, dK; m in a stage, b with
// advection
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

}  // namespace
