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
// next step in VMEM. CUDA blocks run in no order, so nothing is carried
// and there are no atomics; every sum runs in a fixed order (corner 0..3,
// then q = 0..Q-1, as the plain pad+sum version sums), so results are
// deterministic. Mesh edges are masked by index; any N0, N1 works.
//   "state": a persistent grid (as many blocks as the card holds at once,
//     block b walking tiles b, b + gridDim.x, ...: a 1D index, 32-bit tile
//     math) whose blocks read the basis tables into shared memory once. A
//     tile is 16 x 32 elements, two per thread, and the 15 x 31 nodes
//     whose four elements it holds. The tile's 17 x 33 node patch (its
//     nodes and a halo) is staged in shared memory; each thread computes
//     its elements' qp terms and four corner rows once, into shared
//     memory, while the next tile's patch is in flight into registers
//     (then into the other buffer: patches and rows are double-buffered,
//     so a tile takes one barrier); then each node thread sums its (up
//     to) four rows, corner 0..3 in order. An element on a tile's border
//     is computed by both tiles that touch it (10% more elements than
//     the mesh holds).
//     One design for every case: kappa, m and each velocity component a
//     scalar (a kernel parameter) or one value per (element, qp), read in
//     the qp loop; steady, a stage (TRANSIENT) and advection (ADVECT).
//     Q = 4 (the decks' quadrature 2) has an instance of its own, its qp
//     loop unrolled and an element's (E, Q) values read in 16-byte loads;
//     any other Q takes the runtime-Q instance, as long as the tables fit
//     the card's shared memory per block (the provider refuses a larger
//     Q, ops/_launch.py state_smem_words). The advection instances take
//     2 blocks per SM, the others 4 (64 registers).
//   "full": two phases of one launch. The same tile walk with the
//     residual's rows (from S, K and b: each element's quadrature once),
//     node-scattered; then each block sweeps a contiguous range of
//     elements, a thread per element, for the 16 Jacobian rows: each qp
//     linearized once into the weak form's kinds (thermal_form.cuh: a,
//     p_d, kappa and, with advection, beta_d) and contracted with the
//     weighted basis products, which a block builds once in shared
//     memory (per qp, kind-major, 16 entries per kind), read as
//     broadcasts; consecutive threads at consecutive elements, so the
//     reads are coalesced and each row is stored 256 bytes at a time, in
//     runs as long as a block's range. Q = 4 reads an element's (E, Q)
//     inputs in 16-byte loads up front in both phases. The walk's tiles
//     would cut each Jacobian row into 248-byte pieces a block, and the
//     card moved them slower (PERF.md: the Jacobian inside the walk, by
//     DMMA octets or a thread per element, lost to the thread-per-node
//     kernel this replaces in the steady and stage cases).
//
// What bounds it on the H100: bytes, not flops. "state" reads the node
// grid and writes one value per node (16.8 MB at 1024^2 f64, 5 us at
// 3.35 TB/s), plus Q values per element for each of kappa, m and a
// velocity component that varies. It reaches 60-66% of that bound where
// a coefficient varies; with scalars its tile walk (a DRAM latency per
// tile, ~5 tiles per block at 1024^2) and its launch take about as long
// as its bytes; at the decks' sizes a call is mostly its launch and the
// wrapper's host time (PERF.md). "full" (285 MB at 1024^2 f64, 85 us)
// was its access pattern in the thread-per-node design it replaces: each
// node's thread read its four elements' inputs Q values apart across the
// warp, and its loads and stores alone took as long as the kernel
// (PERF.md); here each phase reads each element's inputs once (the
// walk's border elements' S and K twice, the sweep's K again). "full" reads the
// u_eval grid and the per-qp tensors S, dS/de, kappa, dkappa/de (4*Q
// values per element; Q more when m varies) and writes 16 rows per
// element. The transient "full" reads the u_eval grid the caller forms
// (alpha_u u + beta_u, which the torch coefficient pre-pass needs anyway)
// rather than u and beta_u: one grid instead of two. A velocity component
// adds Q values per element where it varies (the rotating field: 2*Q)
// and nothing where it is a scalar. The TPU kernel traced the coefficient
// expressions into its body; here a torch pre-pass evaluates them, which
// costs those ~4*Q extra values per element of traffic in "full".
// Generating the DSL expression into the kernel over a dual-number type
// is a ROADMAP item.

#include <cuda_runtime.h>

#include <initializer_list>

#include "launch.cuh"
#include "node_walk.cuh"
#include "thermal_form.cuh"

namespace {

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

// The tile of both modes' walk (node_walk.cuh): 16 x 32 elements, two
// per thread (rows la and la + 8), and the 15 x 31 nodes whose four
// elements they hold
using NodeTile = WalkTile<16, 32, kThreads>;
// state blocks per SM the registers must allow (__launch_bounds__): 4 (64
// registers), but 2 with the velocity lane, whose Q = 4 instance holds
// the element's velocity values and is faster with up to 128 (PERF.md)
template <bool ADVECT>
constexpr int state_min_blocks() {
  return ADVECT ? 2 : 4;
}

// shared memory of a state block, in T: the tables phi (4Q), grad (8Q),
// wts (Q); two node patches and two sets of the tile's elements' four
// corner rows (a tile's and the next one's)
__host__ __device__ inline long long state_smem_words(int Q) {
  return 13LL * Q + NodeTile::words(1);
}

// the weak form's layout of "full" at nc = 4 (thermal_form.cuh): per qp
// its NKJ Jacobian kinds' 16 entries (and NKR residual kinds' 4 rows)
template <bool ADVECT>
using NodeRows = RowLayout<2, 4, ADVECT>;

// shared memory of a "full" block, in T: the tables, from a 16-byte
// boundary the products of every qp (NodeRows), then the state block's
// patches and rows
__host__ __device__ inline long long full_products(int Q) {
  return (13LL * Q + 3) / 4 * 4;
}
__host__ __device__ inline long long full_smem_words(int Q, bool advect) {
  const long long pq = advect ? NodeRows<true>::PQ : NodeRows<false>::PQ;
  return full_products(Q) + Q * pq + NodeTile::words(1);
}

// an element's Q = 4 values of an (E, 4) coefficient at p + eq (16-byte
// aligned: the launch checks) in 16-byte loads, or the scalar s where p is
// null
template <typename T>
struct alignas(16) Pack16 {
  T v[16 / sizeof(T)];
};
template <typename T>
__device__ __forceinline__ void load_q4(const T* p, long long eq, T s,
                                        T dst[4]) {
  constexpr int kPer = 16 / sizeof(T);
  if (p) {
    const Pack16<T>* pp = reinterpret_cast<const Pack16<T>*>(p + eq);
#pragma unroll
    for (int h = 0; h < 4 / kPer; ++h) {
      const Pack16<T> x = pp[h];
#pragma unroll
      for (int k = 0; k < kPer; ++k) dst[h * kPer + k] = x.v[k];
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = s;
  }
}

// Mode "state": the walk, each element's four corner rows of the state
// part. kappa, mass and each velocity component: an (E, Q) array, or the
// scalar where the pointer is null. QF > 0: Q = QF at compile time.
template <typename T, bool TRANSIENT, bool ADVECT, int QF>
__global__ void __launch_bounds__(kThreads, state_min_blocks<ADVECT>())
    node_state_kernel(const T* __restrict__ u, const T* __restrict__ kappa,
                      T kappa0, const T* __restrict__ mass, T mass0,
                      T alpha_u, T alpha_t, Velocity<T> vel,
                      const T* __restrict__ phi_g,
                      const T* __restrict__ grad_g,
                      const T* __restrict__ wts_g, const int Q_, const int N0,
                      const int N1, const int tiles_j, const int tiles,
                      T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = QF > 0 ? QF : Q_;
  T* phi = reinterpret_cast<T*>(smem_raw);
  T* grad = phi + 4 * Q;
  T* wts = grad + 8 * Q;
  T* patches = wts + Q;                   // 2 x kPatch
  T* rows = patches + 2 * NodeTile::kPatch;  // 2 x 4 kTileElems
  for (int k = threadIdx.x; k < 13 * Q; k += kThreads)
    phi[k] = k < 4 * Q ? phi_g[k]
                       : (k < 12 * Q ? grad_g[k - 4 * Q] : wts_g[k - 12 * Q]);
  auto element = [&](int, int, int a, int b, const T (&uc)[4],
                     T (&r)[4]) {
    const long long eq = ((long long)a * N1 + b) * Q;
    // Q = 4: the element's coefficients up front, in 16-byte loads
    [[maybe_unused]] T k4[4], m4[4], b4[2][4];
    if constexpr (QF == 4) {
      load_q4(kappa, eq, kappa0, k4);
      if constexpr (TRANSIENT) load_q4(mass, eq, mass0, m4);
      if constexpr (ADVECT) {
        load_q4(vel.p[0], eq, vel.s[0], b4[0]);
        load_q4(vel.p[1], eq, vel.s[1], b4[1]);
      }
    }
#pragma unroll(QF > 0 ? QF : 1)
    for (int q = 0; q < Q; ++q) {
      T g0, g1;
      qp_grad(grad, Q, q, uc, g0, g1);
      const T k =
          QF == 4 ? k4[q] : (kappa ? __ldg(kappa + eq + q) : kappa0);
      // the source lane: m alpha_t u_h in a stage, plus b .
      // grad(alpha_u u_h) with advection
      [[maybe_unused]] T sl = T(0);
      if constexpr (TRANSIENT) {
        g0 = alpha_u * g0;
        g1 = alpha_u * g1;
        const T m =
            QF == 4 ? m4[q] : (mass ? __ldg(mass + eq + q) : mass0);
        sl = m * (alpha_t * qp_val(phi, Q, q, uc));
      }
      if constexpr (ADVECT) {
        if constexpr (QF == 4)
          sl += b4[0][q] * g0 + b4[1][q] * g1;
        else
          sl += vel.at(0, eq + q) * g0 + vel.at(1, eq + q) * g1;
      }
      const T f0 = k * g0, f1 = k * g1;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        T v = grad[(c * Q + q) * 2 + 0] * f0 +
              grad[(c * Q + q) * 2 + 1] * f1;
        if constexpr (TRANSIENT || ADVECT) v += phi[c * Q + q] * sl;
        r[c] += wts[q] * v;
      }
    }
  };
  node_walk<T, NodeTile, 1, NodeTile::kElemsPerThread>(
      u, 0, N0, N1, tiles_j, tiles, patches, rows, out, element);
}

// "full" blocks per SM the registers must allow: 2 (128 registers: an
// element's 16 Jacobian sums and, at Q = 4, its inputs)
constexpr int kFullMinBlocks = 2;

// one thread's inputs of the Jacobian at qp entry eq: dS, K, dK; m in a
// stage, b with advection (S, which the Jacobian does not read, 0)
template <typename T, bool TRANSIENT, bool ADVECT>
__device__ __forceinline__ QpIn<T, 2> jac_qp(
    const T* __restrict__ dS, const T* __restrict__ K,
    const T* __restrict__ dK, const T* __restrict__ mass, T mass0,
    const Velocity<T>& vel, long long eq) {
  QpIn<T, 2> in;
  in.s = T(0);
  in.ds = __ldg(dS + eq);
  in.k = __ldg(K + eq);
  in.dk = __ldg(dK + eq);
  in.m = T(0);
  if constexpr (TRANSIENT) in.m = mass ? __ldg(mass + eq) : mass0;
  in.b[0] = in.b[1] = T(0);
  if constexpr (ADVECT) {
    in.b[0] = vel.at(0, eq);
    in.b[1] = vel.at(1, eq);
  }
  return in;
}

// Mode "full" in two phases of one launch. The walk: each element's four
// corner rows of the residual, from S, K (and b) and the tables, each
// node the sum of its elements' rows. The sweep: block b takes the
// elements [b per, (b + 1) per) in a row, a thread per element,
// consecutive threads at consecutive elements, and writes each element's
// 16 Jacobian rows from its qp kinds (qp_scalars) and the weighted basis
// products (NodeRows, read as broadcasts): the Jacobian's reads and
// 256-byte row stores move through device memory in long runs per block,
// which the walk's tiles (15 x 31 nodes) would cut into 248-byte pieces.
// S, dS, K, dK: (E, Q) arrays; mass and each velocity component an (E,
// Q) array or the scalar where the pointer is null. QF > 0: Q = QF at
// compile time.
template <typename T, bool TRANSIENT, bool ADVECT, int QF>
__global__ void __launch_bounds__(kThreads, kFullMinBlocks)
    node_full_kernel(const T* __restrict__ u, const T* __restrict__ S,
                     const T* __restrict__ dS, const T* __restrict__ K,
                     const T* __restrict__ dK, const T* __restrict__ mass,
                     T mass0, T alpha_u, T alpha_t, Velocity<T> vel,
                     const T* __restrict__ phi_g,
                     const T* __restrict__ grad_g,
                     const T* __restrict__ wts_g, const int Q_, const int N0,
                     const int N1, const int tiles_j, const int tiles,
                     T* __restrict__ out, T* __restrict__ jac) {
  using R = NodeRows<ADVECT>;
  constexpr int NKJ = R::F::NKJ, NKR = R::F::NKR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = QF > 0 ? QF : Q_;
  T* phi = reinterpret_cast<T*>(smem_raw);
  T* grad = phi + 4 * Q;
  T* wts = grad + 8 * Q;
  T* prod = phi + full_products(Q);   // Q x R::PQ
  T* patches = prod + Q * R::PQ;             // 2 x kPatch
  T* rows = patches + 2 * NodeTile::kPatch;  // 2 x 4 kTileElems
  for (int k = threadIdx.x; k < 13 * Q; k += kThreads)
    phi[k] = k < 4 * Q ? phi_g[k]
                       : (k < 12 * Q ? grad_g[k - 4 * Q] : wts_g[k - 12 * Q]);
  __syncthreads();
  build_rows<T, 2, 4, ADVECT>(phi, grad, wts, Q, 0, Q, prod);
  // the walk: the residual rows, r_c = sum_q w (phi_c (S + b . grad u_h)
  // + K grad phi_c . grad u_h)
  auto element = [&](int, int, int a, int b, const T (&uc)[4], T (&r)[4]) {
    const long long eq = ((long long)a * N1 + b) * Q;
    // Q = 4: the element's S, K (and b) up front, in 16-byte loads
    [[maybe_unused]] T s4[4], k4[4], b4[2][4];
    if constexpr (QF == 4) {
      load_q4(S, eq, T(0), s4);
      load_q4(K, eq, T(0), k4);
      if constexpr (ADVECT) {
        load_q4(vel.p[0], eq, vel.s[0], b4[0]);
        load_q4(vel.p[1], eq, vel.s[1], b4[1]);
      }
    }
#pragma unroll(QF > 0 ? QF : 1)
    for (int q = 0; q < Q; ++q) {
      T g0, g1;
      qp_grad(grad, Q, q, uc, g0, g1);
      const T k = QF == 4 ? k4[q] : __ldg(K + eq + q);
      T sq = QF == 4 ? s4[q] : __ldg(S + eq + q);
      if constexpr (ADVECT) {
        if constexpr (QF == 4)
          sq += b4[0][q] * g0 + b4[1][q] * g1;
        else
          sq += vel.at(0, eq + q) * g0 + vel.at(1, eq + q) * g1;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        r[c] += wts[q] * (phi[c * Q + q] * sq +
                          grad[(c * Q + q) * 2 + 0] * (k * g0) +
                          grad[(c * Q + q) * 2 + 1] * (k * g1));
    }
  };
  node_walk<T, NodeTile, 1, NodeTile::kElemsPerThread>(
      u, 0, N0, N1, tiles_j, tiles, patches, rows, out, element);
  // the sweep: the Jacobian rows of this block's elements; element e =
  // (a, b) steps by kThreads elements, (da, db), with a carry
  const long long E = (long long)N0 * N1;
  const long long per = (E + gridDim.x - 1) / gridDim.x;
  const long long e1 = (long long)(blockIdx.x + 1) * per < E
                           ? (long long)(blockIdx.x + 1) * per
                           : E;
  long long e = (long long)blockIdx.x * per + threadIdx.x;
  int a = (int)(e / N1), b = (int)(e - (long long)a * N1);
  const int da = kThreads / N1, db = kThreads - da * N1;
  const int G1 = N1 + 1;
  for (; e < e1; e += kThreads) {
    const long long eq = e * Q;
    const T* pu = u + (long long)a * G1 + b;
    const T uc[4] = {__ldg(pu), __ldg(pu + G1), __ldg(pu + G1 + 1),
                     __ldg(pu + 1)};
    // Q = 4: the element's inputs up front, in 16-byte loads
    [[maybe_unused]] T ds4[4], k4[4], dk4[4], m4[4], b4[2][4];
    if constexpr (QF == 4) {
      load_q4(dS, eq, T(0), ds4);
      load_q4(K, eq, T(0), k4);
      load_q4(dK, eq, T(0), dk4);
      if constexpr (TRANSIENT) load_q4(mass, eq, mass0, m4);
      if constexpr (ADVECT) {
        load_q4(vel.p[0], eq, vel.s[0], b4[0]);
        load_q4(vel.p[1], eq, vel.s[1], b4[1]);
      }
    }
    T J[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) J[k] = T(0);
#pragma unroll(QF > 0 ? QF : 1)
    for (int q = 0; q < Q; ++q) {
      QpIn<T, 2> in;
      if constexpr (QF == 4) {
        in.s = T(0);
        in.ds = ds4[q];
        in.k = k4[q];
        in.dk = dk4[q];
        in.m = TRANSIENT ? m4[q] : T(0);
        in.b[0] = ADVECT ? b4[0][q] : T(0);
        in.b[1] = ADVECT ? b4[1][q] : T(0);
      } else {
        in = jac_qp<T, TRANSIENT, ADVECT>(dS, K, dK, mass, mass0, vel,
                                           eq + q);
      }
      T aj[NKJ], ar[NKR];
      qp_scalars<T, 2, 4, TRANSIENT, ADVECT>(in, uc, grad, Q, q, alpha_u,
                                             alpha_t, aj, ar);
      const T* tq = prod + q * R::PQ;
#pragma unroll
      for (int k = 0; k < NKJ; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T bv[4];
          load4<T>(tq + k * R::NN + 4 * j, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i) J[4 * j + i] += aj[k] * bv[i];
        }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) jac[k * E + e] = J[k];
    b += db;
    a += da;
    if (b >= N1) {
      b -= N1;
      ++a;
    }
  }
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

template <typename T, bool TRANSIENT, bool ADVECT, int QF>
int launch_state_case(const T* u, const T* kappa, T kappa0, const T* mass,
                      T mass0, T alpha_u, T alpha_t, Velocity<T> vel,
                      const T* phi, const T* grad, const T* wts, int Q,
                      int N0, int N1, T* out, void* stream) {
  auto kernel = node_state_kernel<T, TRANSIENT, ADVECT, QF>;
  const size_t smem = sizeof(T) * state_smem_words(Q);
  thread_local Resident resident;
  const int err = query_resident(kernel, kThreads, smem, resident);
  if (err != 0) return err;
  int tiles_j, tiles, blocks;
  if (!walk_grid<NodeTile>(N0, N1, resident.blocks, tiles_j, tiles, blocks))
    return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      u, kappa, kappa0, mass, mass0, alpha_u, alpha_t, vel, phi, grad, wts, Q,
      N0, N1, tiles_j, tiles, out);
  return (int)cudaGetLastError();
}

template <typename T, bool TRANSIENT, bool ADVECT>
int launch_state_q(const T* u, const T* kappa, T kappa0, const T* mass,
                   T mass0, T alpha_u, T alpha_t, Velocity<T> vel,
                   const T* phi, const T* grad, const T* wts, int Q, int N0,
                   int N1, T* out, void* stream) {
  auto launch = Q == 4 ? launch_state_case<T, TRANSIENT, ADVECT, 4>
                       : launch_state_case<T, TRANSIENT, ADVECT, 0>;
  return launch(u, kappa, kappa0, mass, mass0, alpha_u, alpha_t, vel, phi,
                grad, wts, Q, N0, N1, out, stream);
}

// Q = 4 reads an element's (E, Q) values in 16-byte loads
inline bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if ((size_t)p % 16) return false;
  return true;
}

template <typename T>
int launch_state(const void* u, const void* kappa, double kappa0,
                 int kappa_is_scalar, const void* mass, double mass0,
                 int mass_is_scalar, double alpha_u, double alpha_t,
                 int transient, int advect, const void* v0, double v0s,
                 const void* v1, double v1s, const void* phi,
                 const void* grad, const void* wts, int Q, int N0, int N1,
                 void* out, void* stream) {
  if (Q < 1 || N0 < 1 || N1 < 1) return (int)cudaErrorInvalidValue;
  if (Q == 4 && !aligned16({kappa_is_scalar ? nullptr : kappa,
                            mass_is_scalar ? nullptr : mass, v0, v1}))
    return (int)cudaErrorInvalidValue;
  auto launch = advect ? (transient ? launch_state_q<T, true, true>
                                    : launch_state_q<T, false, true>)
                       : (transient ? launch_state_q<T, true, false>
                                    : launch_state_q<T, false, false>);
  // a scalar coefficient is a null pointer from here on; a steady call
  // reads no mass
  return launch((const T*)u, kappa_is_scalar ? nullptr : (const T*)kappa,
                (T)kappa0, mass_is_scalar ? nullptr : (const T*)mass,
                (T)mass0, (T)alpha_u, (T)alpha_t,
                make_velocity<T>(v0, v0s, v1, v1s), (const T*)phi,
                (const T*)grad, (const T*)wts, Q, N0, N1, (T*)out, stream);
}

template <typename T, bool TRANSIENT, bool ADVECT, int QF>
int launch_full_case(const T* u, const T* S, const T* dS, const T* K,
                     const T* dK, const T* mass, T mass0, T alpha_u,
                     T alpha_t, Velocity<T> vel, const T* phi, const T* grad,
                     const T* wts, int Q, int N0, int N1, T* out, T* jac,
                     void* stream) {
  auto kernel = node_full_kernel<T, TRANSIENT, ADVECT, QF>;
  const size_t smem = sizeof(T) * full_smem_words(Q, ADVECT);
  thread_local Resident resident;
  const int err = query_resident(kernel, kThreads, smem, resident);
  if (err != 0) return err;
  int tiles_j, tiles, blocks;
  if (!walk_grid<NodeTile>(N0, N1, resident.blocks, tiles_j, tiles, blocks))
    return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      u, S, dS, K, dK, mass, mass0, alpha_u, alpha_t, vel, phi, grad, wts, Q,
      N0, N1, tiles_j, tiles, out, jac);
  return (int)cudaGetLastError();
}

template <typename T, bool TRANSIENT, bool ADVECT>
int launch_full_q(const T* u, const T* S, const T* dS, const T* K,
                  const T* dK, const T* mass, T mass0, T alpha_u, T alpha_t,
                  Velocity<T> vel, const T* phi, const T* grad, const T* wts,
                  int Q, int N0, int N1, T* out, T* jac, void* stream) {
  auto launch = Q == 4 ? launch_full_case<T, TRANSIENT, ADVECT, 4>
                       : launch_full_case<T, TRANSIENT, ADVECT, 0>;
  return launch(u, S, dS, K, dK, mass, mass0, alpha_u, alpha_t, vel, phi,
                grad, wts, Q, N0, N1, out, jac, stream);
}

template <typename T>
int launch_full(const void* u, const void* S, const void* dS, const void* K,
                const void* dK, const void* mass, double mass0,
                int mass_is_scalar, double alpha_u, double alpha_t,
                int transient, int advect, const void* v0, double v0s,
                const void* v1, double v1s, const void* phi,
                const void* grad, const void* wts, int Q, int N0, int N1,
                void* out, void* jac, void* stream) {
  if (Q < 1 || N0 < 1 || N1 < 1) return (int)cudaErrorInvalidValue;
  if (Q == 4 && !aligned16({S, dS, K, dK, mass_is_scalar ? nullptr : mass,
                            v0, v1}))
    return (int)cudaErrorInvalidValue;
  auto launch = advect ? (transient ? launch_full_q<T, true, true>
                                    : launch_full_q<T, false, true>)
                       : (transient ? launch_full_q<T, true, false>
                                    : launch_full_q<T, false, false>);
  // a scalar mass is a null pointer from here on; a steady call reads no
  // mass
  return launch((const T*)u, (const T*)S, (const T*)dS, (const T*)K,
                (const T*)dK, mass_is_scalar ? nullptr : (const T*)mass,
                (T)mass0, (T)alpha_u, (T)alpha_t,
                make_velocity<T>(v0, v0s, v1, v1s), (const T*)phi,
                (const T*)grad, (const T*)wts, Q, N0, N1, (T*)out, (T*)jac,
                stream);
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
