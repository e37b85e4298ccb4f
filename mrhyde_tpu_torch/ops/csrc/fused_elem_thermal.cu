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
// Both modes: linearize each qp once, then contract (thermal_form.cuh).
// The weak form's linearization at a qp is 1 + DIM residual scalars and,
// in "full", 2 + DIM Jacobian ones (2 + 2 DIM with advection); on a
// uniform grid the basis products they multiply are the same in every
// element, so the rows of a block of elements are one small GEMM,
// (elements x Q kinds) times (Q kinds x entries). A persistent grid of
// 256-thread blocks builds the weighted basis products once per block in
// shared memory and walks tiles of elements; a thread steps its
// element's grid position from tile to tile by the grid's stride (no
// division per tile) and gathers its corner values at offsets fixed per
// lattice.
//   "full" (nc + nc^2 rows): the products in the B-fragment order of
// mma.sync m8n8k4, tiles of 64 elements, 8 per warp (a warp's octet, M =
// 8). Each lane owns one element and one qp of every group of 4 (K = 4):
// it reads its qp's inputs once, a group ahead of their use, computes
// grad u_h there and the qp scalars, and the warp steps its octet's sums
// through the fragments, 8 entries at a time (N = 8): 2 f64 sums per
// lane and fragment, 16 (hex) or 22 (p2) in all, where one thread per
// element would hold 64-81. f64 steps on the tensor cores (DMMA); f32
// (TF32 would not hold 1e-5) takes a thread per half of an element's
// entries, summing from the per-qp products read as broadcasts; the host
// build of the tests steps the fragments on FMA (each lane sums its two
// entries from the group's A values, by warp shuffles, and the
// fragments' B values). Rows are stored SoA from the fragments, 8
// consecutive elements (64 bytes) per row and lane group.
//   "state" (nc rows), one of two layouts by type and nc (StateRole):
// - DMMA octets where the type has DMMA and one row fragment holds all nc
//   rows (hex f64): "full"'s octets, each lane loading only the corners
//   its A fragment holds; per group of 4 qps grad u_h (and u_h in a
//   stage) is one more product on DMMA, corner values times the
//   unweighted tables, whose C fragment hands each lane its own qp's
//   kinds in the contraction's A layout; a warp takes 32 consecutive
//   elements (4 octets) and stores its rows through shared memory, 256
//   bytes a row. No FMA table reads, (E, Q) reads coalesced by qp.
// - else a thread per element (p2: its 9 corners and rows would take a
//   third corner step and a second row fragment for one value each;
//   f32: no DMMA), one or two elements per thread (StateLayout). Per qp
//   one block of shared memory holds the table values grad u_h needs
//   and the weighted products of the residual kinds, read as 16-byte
//   broadcasts, each value used by all of a thread's elements.
// Both sum the source lane s and the flux f_d, then the rows; a steady
// call without advection skips the source kind, which is 0. The layouts
// were chosen on the card (PERF.md): the thread-per-element kernel this
// replaces read a table value from shared memory for every FMA; octets
// beat a thread per element in every hex f64 case (1.03-2.0x) but lost
// on p2 with scalar coefficients (0.79-0.85x), and one element per
// thread is the better f32 and f64-stage-with-advection choice.
// Where the products of all qps would pass kFragBytes (a high
// quadrature), they are rebuilt per chunk of qps.
//
// What bounds it on the H100: "state" by bytes where a coefficient varies
// per qp (the grid once, the (E, Q) coefficient tensors, nc rows written
// per element); with scalars its arithmetic (about nc (2 DIM + 1) FMA per
// qp and element, 3 nc more in a stage, on DMMA in the octets) weighs
// about as much as its bytes. A velocity component adds Q values per
// element where it varies. "full"
// writes nc + nc*nc rows and reads 4-5 (E, Q) tensors once: bytes lead.
// Its GEMM (about 2.6 K FMA per hex element, 4.1 K with advection) runs
// on DMMA in f64, under the bytes; a thread per element walking the
// Jacobian a column c' per pass (nc sums live) would repeat grad u_h and
// re-read the inputs nc times, bound by its FMAs (PERF.md). The TPU
// kernel traced the coefficient expressions into its body; here a torch
// pre-pass evaluates them (ROADMAP: in-kernel coefficient codegen).

#include <cuda_runtime.h>

#include <type_traits>

#include "thermal_form.cuh"

namespace {

constexpr int kMaxNc = 9;

struct Lattice {
  int off[kMaxNc][3];  // local dof c -> offset on axes 0, 1, 2
  int coff[kMaxNc];    // local dof c -> its offset on the flat grid
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

// an element's position (I, J, K) on the element grid (K = 0 in 2D)
struct ElemPos {
  int I, J, K;
};

__device__ __forceinline__ ElemPos elem_pos(const Geometry& g, long long e) {
  ElemPos p;
  p.K = (int)(e % g.N2);
  const long long r = e / g.N2;
  p.J = (int)(r % g.N1);
  p.I = (int)(r / g.N1);
  return p;
}

// the position of element e + s from that of e, where d = elem_pos(s)
// (d.J < N1, d.K < N2: one carry per axis at most)
__device__ __forceinline__ void elem_step(const Geometry& g, const ElemPos& d,
                                          ElemPos& p) {
  p.K += d.K;
  const int ck = p.K >= g.N2;
  if (ck) p.K -= g.N2;
  p.J += d.J + ck;
  const int cj = p.J >= g.N1;
  if (cj) p.J -= g.N1;
  p.I += d.I + cj;
}

// the element's nc grid values, local dofs in dofmap order
template <typename T, int NC>
__device__ __forceinline__ void gather(const T* __restrict__ grid,
                                       const Lattice& lat,
                                       const Geometry& g, const ElemPos& p,
                                       T uc[NC]) {
  const int s = lat.stride;
  const int base = ((s * p.I) * g.G1 + s * p.J) * g.G2 + s * p.K;
#pragma unroll
  for (int c = 0; c < NC; ++c) uc[c] = grid[base + lat.coff[c]];
}

// ---------------------------------------------------------------------
// the tile kernel: linearize each qp once, then contract (the note
// above); mode "full" is its JAC = true instance, mode "state" its JAC =
// false one
// ---------------------------------------------------------------------

// the B fragments a block keeps at once, in bytes; past them the qps
// take several chunks, the fragments rebuilt per chunk
#ifndef THERMAL_FULL_FRAG_BYTES
#define THERMAL_FULL_FRAG_BYTES (96 * 1024)
#endif
constexpr long long kFragBytes = THERMAL_FULL_FRAG_BYTES;

// the arguments of both modes ("state": K the kappa tensor, or null and
// kappa0 its scalar; S, dS, dK and jac unused)
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
  T kappa0;
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

// "full", f64: the fragments' GEMM (FullLayout)
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
  const long long step = (long long)gridDim.x * F::kTile;
  long long e = (long long)blockIdx.x * F::kTile + (threadIdx.x >> 2);
  ElemPos pos = elem_pos(geo, e);
  const ElemPos dpos = elem_pos(geo, step);
  // every thread of the block walks the same tiles (the barriers below)
  for (long long tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, e += step, elem_step(geo, dpos, pos)) {
    const bool valid = e < geo.E;
    // the first qp group's inputs, read beside the corner values
    QpIn<T, DIM> cur =
        load_qp<T, DIM, TRANSIENT, ADVECT>(a, valid && t < Q, e * Q + t);
    T uc[NC];
    if (valid) {
      gather<T, NC>(a.grid, a.lat, geo, pos, uc);
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
        build_fragments<T, DIM, NC, ADVECT>(phi, grad, wts, Q, qi0, nqi, fr);
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

// "full", f32: a thread per (element, half of its entries) (RowLayout)
template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT>
__device__ __forceinline__ void full_rows(const FullArgs<T>& a, const T* phi,
                                          const T* grad, const T* wts,
                                          T* tb) {
  using R = RowLayout<DIM, NC, ADVECT>;
  constexpr int NKJ = R::F::NKJ, NKR = R::F::NKR, NN = R::NN, H = R::H;
  constexpr int NR = R::NR;
  const int Q = a.Q, qc = a.qc, nch = (Q + qc - 1) / qc;
  const Geometry& geo = a.geo;
  const int warp = threadIdx.x >> 5, half = warp & 1;
  const long long tiles = (geo.E + R::kTile - 1) / R::kTile;
  const long long step = (long long)gridDim.x * R::kTile;
  long long e = (long long)blockIdx.x * R::kTile + (warp >> 1) * 32 +
                (threadIdx.x & 31);
  ElemPos pos = elem_pos(geo, e);
  const ElemPos dpos = elem_pos(geo, step);
  for (long long tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, e += step, elem_step(geo, dpos, pos)) {
    const bool valid = e < geo.E;
    QpIn<T, DIM> cur = load_qp<T, DIM, TRANSIENT, ADVECT>(a, valid, e * Q);
    T uc[NC];
    if (valid) {
      gather<T, NC>(a.grid, a.lat, geo, pos, uc);
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

// "state": a thread per element, kElems elements per thread (kThreads
// apart), each qp's table values and weighted products in one block read
// as broadcasts, 16 bytes at a time, by both elements: grad u_h (and u_h
// in a stage) from the element's corner values, the state part's
// residual kinds (the source lane s and the flux f_d), then the rows
// contracted with the products w phi_c, w d_d phi_c
template <typename T, int DIM, int NC, bool TRANSIENT = false,
          bool ADVECT = false>
struct StateLayout {
  static constexpr int NKR = 1 + DIM;
  static constexpr int NR = (NC + 3) / 4 * 4;
  // per qp: grad (c, d) c-major, then phi (c), padded; then the products
  // of the residual kinds, NR rows each
  static constexpr int NL = (NC * (DIM + 1) + 3) / 4 * 4;
  static constexpr int PQ = NL + NKR * NR;
  // elements per thread: f64 two (each table value feeds both) but one
  // at a stage with advection (two spill there), f32 one (4 blocks per
  // SM; its (E, Q) reads stay in L1)
  static constexpr int kElems =
      sizeof(T) == 8 && !(TRANSIENT && ADVECT) ? 2 : 1;
  static constexpr int kTile = kThreads * kElems;
};

// the per-qp blocks of qps q0 .. q0 + nq - 1 (StateLayout)
template <typename T, int DIM, int NC>
__device__ __forceinline__ void build_state_rows(const T* phi, const T* grad,
                                                 const T* wts, int Q, int q0,
                                                 int nq, T* tb) {
  using L = StateLayout<T, DIM, NC>;
  const int n = nq * L::PQ;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i % L::PQ, q = q0 + i / L::PQ;
    T v = T(0);
    if (r < NC * DIM) {
      v = grad[((r / DIM) * Q + q) * DIM + r % DIM];
    } else if (r < NC * (DIM + 1)) {
      v = phi[(r - NC * DIM) * Q + q];
    } else if (r >= L::NL) {
      const int c = (r - L::NL) % L::NR;
      if (c < NC)
        v = res_table<T, DIM, NC>(phi, grad, wts, Q, (r - L::NL) / L::NR, q,
                                  c);
    }
    tb[i] = v;
  }
}

// the state part's inputs at a qp: kappa; m in a stage; b with advection
template <typename T, int DIM>
struct StateIn {
  T k, m, b[DIM];
};

template <typename T, int DIM, bool TRANSIENT, bool ADVECT>
__device__ __forceinline__ StateIn<T, DIM> load_state(const FullArgs<T>& a,
                                                      const bool on,
                                                      const long long eq) {
  StateIn<T, DIM> in;
  in.k = in.m = T(0);
#pragma unroll
  for (int d = 0; d < DIM; ++d) in.b[d] = T(0);
  if (on) {
    in.k = a.K ? a.K[eq] : a.kappa0;
    if constexpr (TRANSIENT) in.m = a.mass_is_scalar ? a.mass0 : a.mass[eq];
    if constexpr (ADVECT) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) in.b[d] = a.vel.at(d, eq);
    }
  }
  return in;
}

template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT>
__device__ __forceinline__ void state_rows(const FullArgs<T>& a,
                                           const T* phi, const T* grad,
                                           const T* wts, T* tb) {
  using L = StateLayout<T, DIM, NC, TRANSIENT, ADVECT>;
  constexpr int NR = L::NR, NL = L::NL, EL = L::kElems;
  // the source lane is 0 in a steady call without advection
  constexpr int K0 = TRANSIENT || ADVECT ? 0 : 1;
  const int Q = a.Q, qc = a.qc, nch = (Q + qc - 1) / qc;
  const Geometry& geo = a.geo;
  const long long tiles = (geo.E + L::kTile - 1) / L::kTile;
  const long long step = (long long)gridDim.x * L::kTile;
  long long e0 = (long long)blockIdx.x * L::kTile + threadIdx.x;
  ElemPos pos[EL];
#pragma unroll
  for (int j = 0; j < EL; ++j) pos[j] = elem_pos(geo, e0 + j * kThreads);
  const ElemPos dpos = elem_pos(geo, step);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    bool valid[EL];
    T uc[EL][NC], res[EL][NC];
    StateIn<T, DIM> cur[EL];
#pragma unroll
    for (int j = 0; j < EL; ++j) {
      const long long e = e0 + j * kThreads;
      valid[j] = e < geo.E;
      cur[j] = load_state<T, DIM, TRANSIENT, ADVECT>(a, valid[j], e * Q);
      if (valid[j]) {
        gather<T, NC>(a.grid, a.lat, geo, pos[j], uc[j]);
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) uc[j][c] = T(0);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) res[j][c] = T(0);
    }
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const int q0 = ch * qc, nq = Q - q0 < qc ? Q - q0 : qc;
      if (ch > 0) {
#pragma unroll
        for (int j = 0; j < EL; ++j)
          cur[j] = load_state<T, DIM, TRANSIENT, ADVECT>(
              a, valid[j], (e0 + j * kThreads) * Q + q0);
      }
      if (nch > 1 || tile == blockIdx.x) {
        if (tile != blockIdx.x || ch > 0) __syncthreads();
        build_state_rows<T, DIM, NC>(phi, grad, wts, Q, q0, nq, tb);
        __syncthreads();
      }
#pragma unroll 1
      for (int qq = 0; qq < nq; ++qq) {
        const T* tq = tb + (long long)qq * L::PQ;
        StateIn<T, DIM> in[EL];
#pragma unroll
        for (int j = 0; j < EL; ++j) {
          in[j] = cur[j];
          cur[j] = load_state<T, DIM, TRANSIENT, ADVECT>(
              a, valid[j] && qq + 1 < nq,
              (e0 + j * kThreads) * Q + q0 + qq + 1);
        }
        // linearize: grad u_h, c-major as the plain version sums it (and
        // u_h), from the block's table values
        T gq[EL][DIM], uh[EL];
#pragma unroll
        for (int j = 0; j < EL; ++j) {
          uh[j] = T(0);
#pragma unroll
          for (int d = 0; d < DIM; ++d) gq[j][d] = T(0);
        }
#pragma unroll
        for (int i4 = 0; i4 < NL / 4; ++i4) {
          T v[4];
          load4<T>(tq + 4 * i4, v);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 4 * i4 + i;
#pragma unroll
            for (int j = 0; j < EL; ++j) {
              if (r < NC * DIM)
                gq[j][r % DIM] += v[i] * uc[j][r / DIM];
              else if (TRANSIENT && r < NC * (DIM + 1))
                uh[j] += v[i] * uc[j][r - NC * DIM];
            }
          }
        }
        // the residual kinds, in the plain version's order
        T ar[EL][1 + DIM];
#pragma unroll
        for (int j = 0; j < EL; ++j) {
          T s = T(0);
          if constexpr (TRANSIENT) {
#pragma unroll
            for (int d = 0; d < DIM; ++d) gq[j][d] = a.alpha_u * gq[j][d];
            s = in[j].m * (a.alpha_t * uh[j]);
          }
#pragma unroll
          for (int d = 0; d < DIM; ++d) ar[j][1 + d] = in[j].k * gq[j][d];
          if constexpr (ADVECT) {
            T adv = in[j].b[0] * gq[j][0];
#pragma unroll
            for (int d = 1; d < DIM; ++d) adv += in[j].b[d] * gq[j][d];
            s = TRANSIENT ? s + adv : adv;
          }
          ar[j][0] = s;
        }
        // contract
#pragma unroll
        for (int k = K0; k < 1 + DIM; ++k)
#pragma unroll
          for (int i4 = 0; i4 < NR / 4; ++i4) {
            T v[4];
            load4<T>(tq + NL + k * NR + 4 * i4, v);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < EL; ++j)
                if (4 * i4 + i < NC) res[j][4 * i4 + i] += ar[j][k] * v[i];
          }
      }
    }
#pragma unroll
    for (int j = 0; j < EL; ++j) {
      if (valid[j]) {
        const long long e = e0 + j * kThreads;
#pragma unroll
        for (int c = 0; c < NC; ++c) a.rows[c * geo.E + e] = res[j][c];
      }
      elem_step(geo, dpos, pos[j]);
    }
    e0 += step;
  }
}

// "state", f64: the octet layout of "full" with the linearization on
// DMMA too. Lane 4 g + t of a warp's octet loads only the corners its A
// fragment holds (4 s + t of element g, s < KS); per group of 4 qps the
// octet's grad u_h (and u_h in a stage) is one product, corner values (8
// x NC) times the unweighted tables (NC x 8 columns per pair of kinds,
// column 2 t + i kind 2 p + i at qp t), so the C fragment of pair p
// hands each lane its own qp's two kinds in the A layout of the
// contraction; then the residual kinds step the rows through the
// weighted products as in "full". Fragments per group: NLP KS
// linearization ones, then NKR NTR residual ones. The layout needs nc a
// multiple of 8 (hex): p2's 9 corners and rows would take a third corner
// step and a second row fragment for one value each (StateRole).
template <int DIM, int NC, bool TRANSIENT>
struct StateFrags {
  static constexpr int NLK = DIM + (TRANSIENT ? 1 : 0);  // grad u_h, u_h
  static constexpr int NLP = (NLK + 1) / 2;              // pairs of kinds
  static constexpr int KS = NC / 4;  // corner steps
  static constexpr int NKR = 1 + DIM;
  static constexpr int NTR = NC / 8;  // row fragments
  static constexpr int NLF = NLP * KS;
  static constexpr int NF = NLF + NKR * NTR;
  // a tile: 32 consecutive elements per warp, 4 octets; the warp's rows
  // staged in shared memory (NC x 33 values a warp) for 256-byte stores
  static constexpr int kWarpOctets = 4;
  static constexpr int kTile = kThreads;
  static constexpr int kStage = NC * 33;
};

// the fragments of qp groups qi0 .. qi0 + nqi - 1 (StateFrags): value l of
// a fragment is B[l % 4][l / 4]
template <typename T, int DIM, int NC, bool TRANSIENT>
__device__ __forceinline__ void build_state_fragments(const T* phi,
                                                      const T* grad,
                                                      const T* wts, int Q,
                                                      int qi0, int nqi,
                                                      T* fr) {
  using L = StateFrags<DIM, NC, TRANSIENT>;
  const int n = nqi * L::NF * 32;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int l = i % 32, f = (i / 32) % L::NF, qq = i / (32 * L::NF);
    T v = T(0);
    if (f < L::NLF) {
      const int c = 4 * (f % L::KS) + l % 4, col = l / 4;
      const int q = 4 * (qi0 + qq) + col / 2, kind = 2 * (f / L::KS) + col % 2;
      if (c < NC && q < Q && kind < L::NLK)
        v = kind < DIM ? grad[(c * Q + q) * DIM + kind] : phi[c * Q + q];
    } else {
      const int r = f - L::NLF;
      const int c = 8 * (r % L::NTR) + l / 4, q = 4 * (qi0 + qq) + l % 4;
      if (c < NC && q < Q)
        v = res_table<T, DIM, NC>(phi, grad, wts, Q, r / L::NTR, q, c);
    }
    fr[i] = v;
  }
}

template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT>
__device__ __forceinline__ void state_fragments(const FullArgs<T>& a,
                                                const T* phi, const T* grad,
                                                const T* wts, T* fr,
                                                T* stage) {
  using L = StateFrags<DIM, NC, TRANSIENT>;
  constexpr int NLP = L::NLP, KS = L::KS, NTR = L::NTR, NLF = L::NLF;
  // the source lane is 0 in a steady call without advection
  constexpr int K0 = TRANSIENT || ADVECT ? 0 : 1;
  const int Q = a.Q, qic = a.qc;
  const Geometry& geo = a.geo;
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const int warp = threadIdx.x >> 5;
  T* st = stage + warp * L::kStage;  // this warp's rows, [c][33]
  const int qis = (Q + 3) / 4, nch = (qis + qic - 1) / qic;
  const long long tiles = (geo.E + L::kTile - 1) / L::kTile;
  const long long step = (long long)gridDim.x * L::kTile;
  // octet m's element of this lane: e0 + 8 m, e0 = the warp's first + g
  long long e0 = (long long)blockIdx.x * L::kTile + 32 * warp + g;
  ElemPos pos0 = elem_pos(geo, e0);
  const ElemPos dpos = elem_pos(geo, step), d8 = elem_pos(geo, 8);
  // every thread of the block walks the same tiles (the barriers below)
  for (long long tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, e0 += step, elem_step(geo, dpos, pos0)) {
    static_assert(NC % 8 == 0, "whole corner steps and row fragments");
    ElemPos pos = pos0;
#pragma unroll 1
    for (int m = 0; m < L::kWarpOctets; ++m, elem_step(geo, d8, pos)) {
      const long long e = e0 + 8 * m;
      const bool valid = e < geo.E;
      StateIn<T, DIM> cur = load_state<T, DIM, TRANSIENT, ADVECT>(
          a, valid && t < Q, e * Q + t);
      // this lane's corner values: the A fragments of the linearization
      // (corner 4 s + t)
      T ua[KS], ug[KS][4];
      const int s0 = a.lat.stride;
      const int base =
          ((s0 * pos.I) * geo.G1 + s0 * pos.J) * geo.G2 + s0 * pos.K;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        ua[s] = valid ? a.grid[base + a.lat.coff[4 * s + t]] : T(0);
        group_values<T>(ua[s], ug[s], lane);
      }
      T cr[NTR][2];
#pragma unroll
      for (int n = 0; n < NTR; ++n) cr[n][0] = cr[n][1] = T(0);
#pragma unroll 1
      for (int ch = 0; ch < nch; ++ch) {
        const int qi0 = ch * qic;
        const int nqi = qis - qi0 < qic ? qis - qi0 : qic;
        if (ch > 0)
          cur = load_state<T, DIM, TRANSIENT, ADVECT>(
              a, valid && 4 * qi0 + t < Q, e * Q + 4 * qi0 + t);
        if (nch > 1 || (tile == blockIdx.x && m == 0)) {
          if (tile != blockIdx.x || m > 0 || ch > 0) __syncthreads();
          build_state_fragments<T, DIM, NC, TRANSIENT>(phi, grad, wts, Q,
                                                       qi0, nqi, fr);
          __syncthreads();
        }
#pragma unroll 1
        for (int qq = 0; qq < nqi; ++qq) {
          const int q = 4 * (qi0 + qq) + t;
          const StateIn<T, DIM> nxt = load_state<T, DIM, TRANSIENT, ADVECT>(
              a, valid && qq + 1 < nqi && q + 4 < Q, e * Q + q + 4);
          const T* fq = fr + (long long)qq * L::NF * 32;
          // linearize: pair p's C fragment holds kinds 2 p, 2 p + 1 at
          // this lane's qp
          T lc[NLP][2];
#pragma unroll
          for (int p = 0; p < NLP; ++p) {
            lc[p][0] = lc[p][1] = T(0);
#pragma unroll
            for (int s = 0; s < KS; ++s)
              frag_step<T>(lc[p][0], lc[p][1], ua[s], ug[s],
                           fq + (p * KS + s) * 32, lane);
          }
          T gq[DIM];
#pragma unroll
          for (int d = 0; d < DIM; ++d) gq[d] = lc[d / 2][d % 2];
          // the residual kinds, in the plain version's order
          T ar[1 + DIM];
          T sl = T(0);
          if constexpr (TRANSIENT) {
#pragma unroll
            for (int d = 0; d < DIM; ++d) gq[d] = a.alpha_u * gq[d];
            sl = cur.m * (a.alpha_t * lc[DIM / 2][DIM % 2]);
          }
#pragma unroll
          for (int d = 0; d < DIM; ++d) ar[1 + d] = cur.k * gq[d];
          if constexpr (ADVECT) {
            T adv = cur.b[0] * gq[0];
#pragma unroll
            for (int d = 1; d < DIM; ++d) adv += cur.b[d] * gq[d];
            sl = TRANSIENT ? sl + adv : adv;
          }
          ar[0] = sl;
          cur = nxt;
          // contract with the weighted products of these 4 qps
#pragma unroll
          for (int k = K0; k < 1 + DIM; ++k) {
            T ag[4];
            group_values<T>(ar[k], ag, lane);
#pragma unroll
            for (int n = 0; n < NTR; ++n)
              frag_step<T>(cr[n][0], cr[n][1], ar[k], ag,
                           fq + (NLF + k * NTR + n) * 32, lane);
          }
        }
      }
      // rows 8 n + 2 t + i of element g, to the warp's stage
#pragma unroll
      for (int n = 0; n < NTR; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          st[(8 * n + 2 * t + i) * 33 + 8 * m + g] = cr[n][i];
    }
    // the warp's 32 elements, a row at a time: 256 bytes per store
    __syncwarp();
    const long long ew = e0 - g + lane;
    if (ew < geo.E) {
#pragma unroll
      for (int c = 0; c < NC; ++c) a.rows[c * geo.E + ew] = st[c * 33 + lane];
    }
    __syncwarp();
  }
}

// "full" f64 steps the fragments on DMMA; f32 takes a thread per half of
// an element's entries, whose FMAs read the products as broadcasts
template <typename T>
struct RowsPath {
  static constexpr bool value = std::is_same<T, float>::value;
};

// "state": octets on DMMA where the type has it and one row fragment
// holds all nc rows (hex f64), else a thread per element; and the blocks
// per SM its registers must allow (octets: a lane's few fragment values;
// f32 one element a thread; f64 two)
template <typename T, int NC>
struct StateRole {
  static constexpr bool kOctets = std::is_same<T, double>::value && NC == 8;
  static constexpr int kMinBlocks = kOctets || sizeof(T) == 4 ? 4 : 2;
};

// "full": blocks per SM the registers must allow, 2 (128 registers: its
// 16-22 sums per lane)
constexpr int kFullMinBlocks = 2;

template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT, bool JAC>
__global__ void __launch_bounds__(kThreads,
                                  JAC ? kFullMinBlocks
                                      : StateRole<T, NC>::kMinBlocks)
    elem_tile_kernel(const FullArgs<T> a, const T* __restrict__ phi_g,
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
  if constexpr (!JAC && !StateRole<T, NC>::kOctets)
    state_rows<T, DIM, NC, TRANSIENT, ADVECT>(a, phi, grad, wts, products);
  else if constexpr (!JAC)
    state_fragments<T, DIM, NC, TRANSIENT, ADVECT>(
        a, phi, grad, wts, products,
        products + (long long)a.qc * StateFrags<DIM, NC, TRANSIENT>::NF * 32);
  else if constexpr (RowsPath<T>::value)
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
  for (int c = 0; c < nc; ++c)
    lat.coff[c] = (lat.off[c][0] * geo.G1 + lat.off[c][1]) * geo.G2 +
                  lat.off[c][2];
  return true;
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

// what a launch returns where one chunk does not fit the card's shared
// memory per block (the wrapper raises on it)
constexpr int kErrSharedMemory = -1;

template <typename T, int DIM, int NC, bool TRANSIENT, bool ADVECT, bool JAC>
int launch_tile(const FullArgs<T>& args, const void* phi, const void* grad,
                const void* wts, void* stream) {
  using F = FullLayout<DIM, NC, ADVECT>;
  using R = RowLayout<DIM, NC, ADVECT>;
  using S = StateLayout<T, DIM, NC, TRANSIENT, ADVECT>;
  using SF = StateFrags<DIM, NC, TRANSIENT>;
  // fragments of qp groups of 4 ("full" f64, "state" octets), else per-qp
  // blocks of qps
  constexpr bool kFrag =
      JAC ? !RowsPath<T>::value : StateRole<T, NC>::kOctets;
  constexpr int kPer = kFrag ? (JAC ? F::NF : SF::NF) * 32
                             : (JAC ? R::PQ : S::PQ);
  constexpr long long kTile =
      kFrag ? (JAC ? F::kTile : SF::kTile) : (JAC ? R::kTile : S::kTile);
  auto kernel = elem_tile_kernel<T, DIM, NC, TRANSIENT, ADVECT, JAC>;
  const int Q = args.Q;
  // the chunk, the shared memory and the resident blocks of the last Q
  // this kernel took, reused while it repeats
  static int last_q = 0, qc = 0, per_sm = 0, sms = 0;
  static size_t smem = 0;
  if (Q != last_q) {
    const int units = kFrag ? (Q + 3) / 4 : Q;
    const long long fit = kFragBytes / (long long)(sizeof(T) * kPer);
    qc = fit < 1 ? 1 : (fit < units ? (int)fit : units);
    smem = sizeof(T) * (size_t)(F::fragments(Q) + (long long)qc * kPer +
                                (kFrag && !JAC ? (kThreads / 32) * SF::kStage
                                               : 0));
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
  FullArgs<T> a = args;
  a.qc = qc;
  // a persistent grid: each block builds the products once and walks
  // tiles blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long tiles = (a.geo.E + kTile - 1) / kTile;
  const long long fill = (long long)sms * (per_sm < 1 ? 1 : per_sm);
  const unsigned blocks = (unsigned)(tiles < fill ? tiles : fill);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      a, (const T*)phi, (const T*)grad, (const T*)wts);
  return (int)cudaGetLastError();
}

// the instance of (dim, nc) and the flags: the hex p1 (3, 8) and p2
// quad (2, 9) kernels
template <typename T, bool JAC>
int launch_case(const FullArgs<T>& a, int transient, int advect, int nc,
                int dim, const void* phi, const void* grad, const void* wts,
                void* stream) {
  using L = int (*)(const FullArgs<T>&, const void*, const void*,
                    const void*, void*);
  L launch = nullptr;
  if (dim == 3 && nc == 8)
    launch = advect ? (transient ? launch_tile<T, 3, 8, true, true, JAC>
                                 : launch_tile<T, 3, 8, false, true, JAC>)
                    : (transient ? launch_tile<T, 3, 8, true, false, JAC>
                                 : launch_tile<T, 3, 8, false, false, JAC>);
  if (dim == 2 && nc == 9)
    launch = advect ? (transient ? launch_tile<T, 2, 9, true, true, JAC>
                                 : launch_tile<T, 2, 9, false, true, JAC>)
                    : (transient ? launch_tile<T, 2, 9, true, false, JAC>
                                 : launch_tile<T, 2, 9, false, false, JAC>);
  if (!launch) return (int)cudaErrorInvalidValue;
  return launch(a, phi, grad, wts, stream);
}

// the arguments both modes share: the stage, the velocity, the geometry
template <typename T>
bool common_args(const void* grid, const void* mass, double mass0,
                 int mass_is_scalar, double alpha_u, double alpha_t,
                 const void* const v[3], const double vs[3], int Q, int nc,
                 int dim, const int* lattice, int stride, int N0, int N1,
                 int N2, void* rows, FullArgs<T>& a) {
  if (!make_geometry(lattice, nc, dim, stride, N0, N1, N2, a.lat, a.geo))
    return false;
  a.grid = (const T*)grid;
  a.S = a.dS = a.K = a.dK = nullptr;
  a.mass = (const T*)mass;
  a.mass0 = (T)mass0;
  a.mass_is_scalar = mass_is_scalar;
  a.kappa0 = T(0);
  a.alpha_u = (T)alpha_u;
  a.alpha_t = (T)alpha_t;
  a.vel = make_velocity<T>(v, vs);
  a.Q = Q;
  a.qc = 0;
  a.rows = (T*)rows;
  a.jac = nullptr;
  return true;
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
  FullArgs<T> a;
  if (!common_args<T>(grid, mass, mass0, mass_is_scalar, alpha_u, alpha_t, v,
                      vs, Q, nc, dim, lattice, stride, N0, N1, N2, rows, a))
    return (int)cudaErrorInvalidValue;
  // a scalar kappa is a null pointer from here on
  a.K = kappa_is_scalar ? nullptr : (const T*)kappa;
  a.kappa0 = (T)kappa0;
  return launch_case<T, false>(a, transient, advect, nc, dim, phi, grad, wts,
                               stream);
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
  FullArgs<T> a;
  if (!common_args<T>(grid, mass, mass0, mass_is_scalar, alpha_u, alpha_t, v,
                      vs, Q, nc, dim, lattice, stride, N0, N1, N2, rows, a))
    return (int)cudaErrorInvalidValue;
  a.S = (const T*)S;
  a.dS = (const T*)dS;
  a.K = (const T*)K;
  a.dK = (const T*)dK;
  a.jac = (T*)jac;
  return launch_case<T, true>(a, transient, advect, nc, dim, phi, grad, wts,
                              stream);
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
