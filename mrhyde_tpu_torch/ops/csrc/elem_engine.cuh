// The element-tile engine for Hopper (sm_90a): assembly of a weak form's
// residual rows and element-varying Jacobian rows on uniform 3D hex (p1,
// nc = 8) and 2D p2 quads (nc = 9), steady or a transient stage, for any
// qp density. Three files instantiate it: fused_elem_ns.cu (Navier-Stokes,
// whose coefficients are scalars or (E, Q) tensors: ns_elem_full),
// set_elem.cuh (the module sets that functions/codegen.py generates per
// deck: set_elem_full) and, at nc = 4 on 2D p1 quads, set_node.cuh (the
// Jacobian role of set_node_full, whose residual is node-scattered by a
// role of its own). Mode "state" of the sets (set_elem_state) is a kernel
// of its own in set_elem.cuh: it writes rows only, and the engine's
// layout serves the Jacobian. The density is the template parameter
// `Dens`, a struct with a static
//   template <bool TR, typename S, typename P>
//   at(S (&u)[NV], S (&ud)[NV], S (&g)[NV][DIM], const QpAt<P, DIM>& pt,
//      const ElemArgs& a, S (&out)[NV * (1 + DIM)])
// that writes [S_v for v] + [F_v,d for v for d] at a qp, over any scalar
// type S (T, or a Dual of dual.cuh).
//
// Replaces: the TPU element-tile kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_call` (:1283-1318, pallas_call at
// :1303; body `FusedP1Assembly._kernel(node=False)`, whose `_accumulate`
// (:316-495) linearizes the density once per qp with `sparse_jacfwd` and
// builds every column from that linearization and the basis tables): in
// mode "full" (:1417) the nd residual rows and the element-varying
// Jacobian rows of every element. The caller scatters the residual rows
// to the grids (pad+sum on the p1 node grid, strided adds on the p2 fine
// lattice), as the JAX package does after its kernel.
//
// Weak form, per element e and qp q, at u_eval = alpha_u u + beta_u and
// u_dot = alpha_t u + beta_t (steady: alpha_u = 1, no u_dot), with D_q
// the density's derivatives along the qp inputs b of each variable w (b:
// u_w, the DIM components of grad u_w, and in a stage u_dot_w):
//   r_(v,c) = sum_q w_q (phi_c S_v + grad phi_c . F_v);
//   J[(v,c),(w,c')] = sum_q sum_a Bout_q[a,c]
//                       sum_b w_q D_q[(v,a),(w,b)] Bin_q[b,c'],
//   Bout = (phi, grad phi), Bin = (alpha_u phi, alpha_u grad phi,
//   alpha_t phi): JAX's `Tcol` (the inner sum) and its row sums.
// Row k = row*nd + col, row = v*nc + c, col = w*nc + c', nd = nc NV.
// Local dof c of element (I, J[, K]) is grid point stride*(I, J[, K]) +
// off[c] of each variable's grid (stride 1: the p1 node grid; 2: the p2
// fine lattice); element e is C-order over the element grid, and the
// qp's coordinates are origin + (I, J[, K]) h + q_off[q], as the JAX
// kernel synthesizes them. Residual row r is stored as res[r*E + e]; only
// the Jacobian rows the host probe classified element-varying are
// stored, as jac[pos*E + e] with pos = row_pos[k] >= 0 (the constant rows
// are the probe's values).
//
// What bounds it on the H100: the bytes of the Jacobian rows (about 860
// f64 per hex NS element, up to nd^2 = 2,304 for NS + thermal + cdr),
// against the operations of the scheme above, which chip_smoke.py counts
// on the plain version (its sparse forward AD). The previous design
// evaluated the density on a dual once per Jacobian column (nd times per
// qp). This one runs, for a block of `elems` elements, in phases through
// shared memory:
//   1. the reference tables, the elements' corner values (u_eval and, in
//      a stage, u_dot) and corner coordinates;
//   2. one thread per (element, qp): the values, gradients (and u_dot) of
//      all variables at the qp, and the primal density there;
//   3. the residual rows, each thread (element, slot) summing rows slot,
//      slot + slots, ... over the qps;
//   4. per chunk of qps (all of them up to kQc, else
//      balanced chunks of at most kQcMulti): LINEARIZE, one task per
//      (element, qp, kTan qp inputs), each a forward pass on Dual<T,
//      kTan> seeded with unit tangents on its inputs, which stores its
//      columns of w_q D_q (alpha folded in): NQ / kTan passes per qp
//      (hex NS: 8 of 2 tangents steady, 10 in a stage), where the
//      previous design took nd = 32; then CONTRACT, one thread per
//      (element, tile), a tile being a block (v, w) of the Jacobian and S
//      of its columns c': its nc x S sums stay in registers over the
//      chunk's qps, as T[a][j] = sum_b D[(v,a),(w,b)] Bin[b][c'_j] and
//      J[c][j] += Bout[a][c] T[a][j] (about 6 K FMA per hex NS qp and
//      element). Only the tiles that hold an element-varying row run (the
//      host's list `tiles`); between chunks (Q > kQc) the sums wait in
//      shared memory.
// The contraction sums each (v, w) block over w's own inputs alone, so an
// infinite derivative (sqrt or log at 0 of a state value) reaches only
// the columns of the variable that moves it, and a structural zero of D
// never meets an infinity: JAX's sparse AD skips the same entries. As
// many elements share a block as its tiles fill kThreads threads (hex
// NS: 26 varying tiles, 4 elements; at most kElems) and the card's
// shared memory keeps the most elements resident on an SM (any
// quadrature whose one element fits the opt-in limit per block works),
// so the Jacobian rows are stored `elems` elements at a time. The
// sums are deterministic (no atomics); any element grid works (the last
// block masks its missing elements); element and row offsets are 64-bit.
// The contraction runs on FMA in both precisions: f64 DMMA (m8n8k4) was
// measured slower on this layout (PERF.md).

#pragma once

#include <cuda_runtime.h>

#include "dual.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;  // mode "full": blocks per SM the registers
                               // allow
constexpr int kElems = 16;     // elements per block, at most
constexpr int kMaxNc = 9;
constexpr int kMaxScalars = 32;
constexpr int kCoefs = 5;  // NS: density, viscosity, source ux, uy, uz
constexpr int kQc = 9;       // qps linearized in one chunk, at most
constexpr int kQcMulti = 5;  // qps per chunk where they take several
constexpr int kTan = 2;    // qp inputs per linearization pass
// nc = 4 (set_node.cuh's Jacobian role): the qp inputs per pass, 0 for
// all inputs of one variable (NB: one pass per variable and qp, faster
// there than 2, 3 or 4, PERF.md)
constexpr int kTanNode = 0;

// The C interface's arguments of every element-tile entry point, filled
// by ctypes (ops/_launch.py ElemArgs): one struct for both densities, each
// reading the fields it needs (NS: coef, coef0; a set: origin, hax, qoff,
// sc).
struct ElemArgs {
  const void* ue;            // (NV, G0, G1[, G2]) u_eval grids
  const void* ud;            // the u_dot grids, or null (steady)
  const void* coef[kCoefs];  // NS: (E, Q) per coefficient ...
  double coef0[kCoefs];      // ... or these scalars where it is null
  const void* phi;           // (nc, Q)
  const void* grad;          // (nc, Q, dim)
  const void* wts;           // (Q,)
  const int* row_pos;        // (nd*nd,) position of row k in jac, or -1
  const int* tiles;          // (n_tiles,) tiles holding a varying row
  void* res;                 // (nd, E) residual rows
  void* jac;                 // (rows, E) Jacobian rows
  double alpha_u, alpha_t, h, tau_dt2;  // tau_dt2 = (C3 / dt)^2
  double origin[3], hax[3];             // the box's origin and spacing
  const double* qoff;                   // (Q, dim) the qps' offsets in an
                                        // element, on the device
  double sc[kMaxScalars];  // t, beta, T_ambient, the deck's parameters
  int Q, nc, dim, stride, N0, N1, N2, n_tiles, pspg, supg, transient;
  int off[kMaxNc][3];  // lattice offset of local dof c (axis 2: 0 in 2D)
};

struct ElemGeometry {
  int N1, N2;      // element grid axes 1, 2 (N2 = 1 in 2D)
  int G1, G2;      // grid axes 1 and 2 (G2 = 1 in 2D)
  long long G;     // points of one variable's grid
  long long E;
};

// what a density reads at a qp besides the state
template <typename P, int DIM>
struct QpAt {
  P x[DIM];     // the qp's coordinates
  long long e;  // the element
  int q;        // the qp
};

// element e's index on each axis (K = 0 in 2D); e < 2^31 (the launch
// checks it)
__device__ __forceinline__ void elem_index(const ElemGeometry& g,
                                           long long e, int idx[3]) {
  const unsigned n2 = (unsigned)g.N2, n1 = (unsigned)g.N1;
  const unsigned r = (unsigned)e / n2;
  idx[2] = (int)((unsigned)e - r * n2);
  idx[1] = (int)(r % n1);
  idx[0] = (int)(r / n1);
}

// shared memory of a block of `elems` elements, in T: tables phi (NC*Q),
// grad (NC*Q*DIM), wts (Q); the qp state u, g[, ud] (elems x Q x NQ); the
// elements' corner coordinates (elems x DIM); then, through the residual
// rows (phases 1-3), the corner values (elems x NS0 x ND) and the primal
// densities (elems x Q x NO), and over them (phase 4) a chunk of the
// linearization (elems x (qc (NO NQ + 1) + 1), the 1s pads that spread
// the qps and the elements over the banks) and, where the qps take
// several chunks, the tiles' sums between them (elems x ND x ND).
// ops/_launch.py `elem_smem_words` is `total`.
template <int DIM, int NC, int NV, bool TR>
struct ElemLayout {
  static constexpr int ND = NV * NC, NO = NV * (1 + DIM);
  static constexpr int NB = 1 + DIM + (TR ? 1 : 0);  // inputs per variable
  static constexpr int NQ = NV * NB;
  static constexpr int NS0 = TR ? 2 : 1;  // u_eval [, u_dot]
  static constexpr int DQ = NO * NQ + 1;  // a qp's linearization, padded
  // columns c' per tile, and tiles per (v, w) block (nc = 4: the 2D p1
  // quads of set_node.cuh, one tile of all 4 columns)
  static constexpr int S = NC == 4 ? 4 : (NV == 1 ? 1 : (NC == 8 ? 4 : 3));
  static constexpr int NG = NC / S;
  static constexpr int NT = NV * NV * NG;
  static_assert(NC % S == 0, "a tile's columns divide nc");
  __host__ __device__ static long long tables(int Q) {
    return (long long)NC * Q * (1 + DIM) + Q;
  }
  __host__ __device__ static long long corners(int elems) {
    return (long long)elems * NS0 * ND;
  }
  // where phases 1-3's memory and phase 4's over it start
  __host__ __device__ static long long region(int Q, int elems) {
    return tables(Q) + (long long)elems * (Q * NQ + DIM);
  }
  __host__ __device__ static long long residual(int Q, int elems) {
    return corners(elems) + (long long)elems * Q * NO;
  }
  // the chunks of the qps (balanced, kQcMulti at most where Q > kQc, so
  // that two blocks fit an SM) and the qps of the largest
  __host__ __device__ static int chunks(int Q) {
    return Q <= kQc ? 1 : (Q + kQcMulti - 1) / kQcMulti;
  }
  __host__ __device__ static int qc(int Q) {
    return (Q + chunks(Q) - 1) / chunks(Q);
  }
  __host__ __device__ static long long dstride(int Q) {
    return (long long)qc(Q) * DQ + 1;
  }
  __host__ __device__ static long long jacobian(int Q, int elems) {
    return elems * dstride(Q) + (Q > kQc ? (long long)elems * ND * ND : 0);
  }
  __host__ __device__ static long long total(int Q, int elems) {
    const long long r = residual(Q, elems), j = jacobian(Q, elems);
    return region(Q, elems) + (r > j ? r : j);
  }
};

// phase 4a: linearize the chunk of qps q0 .. q0 + nq - 1: task (element,
// qp, pass) writes columns k0 .. k0 + kTan - 1 of w_q D_q (input k = w NB
// + b, alpha folded in) to dm
template <typename T, bool TR, int DIM, int NC, int NV, class Dens>
__device__ __forceinline__ void elem_linearize(
    const ElemArgs& a, const ElemGeometry& geo, const int elems,
    const T* wts, const T* qst, const T* ecoord, T* dm, const int q0,
    const int nq) {
  using L = ElemLayout<DIM, NC, NV, TR>;
  constexpr int NO = L::NO, NQ = L::NQ, NB = L::NB;
  constexpr int KT = NC != 4 ? kTan : (kTanNode > 0 ? kTanNode : NB);
  using DK = Dual<T, KT>;
  constexpr int NK = (NQ + KT - 1) / KT;  // passes per qp
  const int Q = a.Q;
  const long long e0 = (long long)blockIdx.x * elems, dstr = L::dstride(Q);
  const T au = T(a.alpha_u), at = T(a.alpha_t);
#pragma unroll 1
  for (int i = threadIdx.x; i < elems * nq * NK; i += kThreads) {
    const int pass = i % NK, r = i / NK, qq = r % nq, le = r / nq;
    const long long e = e0 + le;
    if (e >= geo.E) continue;
    const int q = q0 + qq, k0 = pass * KT;
    const T* st = qst + (le * Q + q) * NQ;
    DK u[NV], ud[NV], g[NV][DIM], out[NO];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      u[v].v = st[v];
      ud[v].v = TR ? st[NV * (1 + DIM) + v] : T(0);
#pragma unroll
      for (int d = 0; d < DIM; ++d) g[v][d].v = st[NV + v * DIM + d];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int k = k0 + j - v * NB;  // the input's slot in v, if any
        u[v].d[j] = k == 0 ? T(1) : T(0);
#pragma unroll
        for (int d = 0; d < DIM; ++d) g[v][d].d[j] = k == 1 + d ? T(1) : T(0);
        ud[v].d[j] = TR && k == 1 + DIM ? T(1) : T(0);
      }
    }
    QpAt<T, DIM> pt;
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      pt.x[d] = ecoord[le * DIM + d] + T(a.qoff[DIM * q + d]);
    pt.e = e;
    pt.q = q;
    Dens::template at<TR>(u, ud, g, pt, a, out);
    T* dq = dm + le * dstr + (long long)qq * L::DQ;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int k = k0 + j;
      if (k >= NQ) break;
      const T sc = wts[q] * (TR && k % NB == NB - 1 ? at : au);
#pragma unroll
      for (int o = 0; o < NO; ++o) dq[o * NQ + k] = sc * out[o].d[j];
    }
  }
}

// phase 4 of elem_body, per chunk of qps:
// linearize, then contract the chunk into the tiles' sums; store the
// varying rows after the last chunk. Its shared memory `dm` is that of
// phases 1-3's corner values and densities.
template <typename T, bool TR, int DIM, int NC, int NV, class Dens>
__device__ __forceinline__ void elem_jacobian(const ElemArgs& a,
                                              const ElemGeometry& geo,
                                              const int elems, const T* phi,
                                              const T* grad, const T* wts,
                                              const T* qst, const T* ecoord,
                                              T* dm) {
  using L = ElemLayout<DIM, NC, NV, TR>;
  constexpr int ND = L::ND, NO = L::NO, NQ = L::NQ, NB = L::NB, S = L::S;
  const int Q = a.Q, tid = threadIdx.x, nch = L::chunks(Q);
  const long long e0 = (long long)blockIdx.x * elems, dstr = L::dstride(Q);
  T* jsv = dm + elems * dstr;  // the tiles' sums between chunks
  T* jac = static_cast<T*>(a.jac);
  // thread (element tid % elems, tile tid / elems) sums its tile's nc x S
  // entries: T[a][j] = sum_b D[(tv,a),(tw,b)] Bin[b][c'_j], J[c][j] +=
  // Bout[a][c] T[a][j], c'_j = tg S + j
  const int units = elems * a.n_tiles, cle = tid % elems;
  const long long ce = e0 + cle;
  const bool busy = tid < units && ce < geo.E;
  int tv = 0, tw = 0, tg = 0;
  if (busy) {
    const int code = __ldg(a.tiles + tid / elems);
    tg = code % L::NG;
    tw = (code / L::NG) % NV;
    tv = code / (L::NG * NV);
  }
  __syncthreads();  // phase 3 has read the densities
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    const int q0 = ch * Q / nch, nq = (ch + 1) * Q / nch - q0;
    elem_linearize<T, TR, DIM, NC, NV, Dens>(a, geo, elems, wts, qst,
                                             ecoord, dm, q0, nq);
    __syncthreads();
    if (busy) {
      T J[NC][S];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < S; ++j)
          J[c][j] = ch == 0 ? T(0) : jsv[(c * S + j) * units + tid];
      const T* dl = dm + cle * dstr;
#pragma unroll 1
      for (int qq = 0; qq < nq; ++qq) {
        const int q = q0 + qq;
        // this qp's Bin of the tile's columns
        T bin[1 + DIM][S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int cp = tg * S + j;
          bin[0][j] = phi[cp * Q + q];
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            bin[1 + d][j] = grad[(cp * Q + q) * DIM + d];
        }
        const T* dq = dl + (long long)qq * L::DQ + tw * NB;
#pragma unroll
        for (int ao = 0; ao <= DIM; ++ao) {
          const T* drow = dq + (ao == 0 ? tv : NV + tv * DIM + ao - 1) * NQ;
          T din[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) din[b] = drow[b];
          T t[S];
#pragma unroll
          for (int j = 0; j < S; ++j) {
            T x = din[0] * bin[0][j];
#pragma unroll
            for (int d = 0; d < DIM; ++d) x += din[1 + d] * bin[1 + d][j];
            if constexpr (TR) x += din[1 + DIM] * bin[0][j];
            t[j] = x;
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const T bo =
                ao == 0 ? phi[c * Q + q] : grad[(c * Q + q) * DIM + ao - 1];
#pragma unroll
            for (int j = 0; j < S; ++j) J[c][j] += bo * t[j];
          }
        }
      }
      if (ch + 1 < nch) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < S; ++j)
            jsv[(c * S + j) * units + tid] = J[c][j];
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < S; ++j) {
            const int k = (tv * NC + c) * ND + tw * NC + tg * S + j;
            const int pos = __ldg(a.row_pos + k);
            if (pos >= 0) jac[(long long)pos * geo.E + ce] = J[c][j];
          }
      }
    }
    __syncthreads();
  }
}

// the kernel's body (elem_full_kernel; set_node.cuh's Jacobian role)
template <typename T, bool TR, int DIM, int NC, int NV, class Dens>
__device__ __forceinline__ void elem_body(const ElemArgs& a,
                                          const ElemGeometry& geo,
                                          const int elems) {
  using L = ElemLayout<DIM, NC, NV, TR>;
  constexpr int ND = L::ND, NO = L::NO, NQ = L::NQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int Q = a.Q;
  T* phi = s;
  T* grad = phi + NC * Q;
  T* wts = grad + NC * Q * DIM;
  T* qst = s + L::tables(Q);
  T* ecoord = qst + (long long)elems * Q * NQ;
  T* corner = s + L::region(Q, elems);
  T* qout = corner + L::corners(elems);
  const int tid = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * elems;

  // phase 1: tables, corner values and corner coordinates
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
  for (int i = tid; i < elems * DIM; i += kThreads) {
    const long long e = e0 + i / DIM;
    int idx[3];
    elem_index(geo, e < geo.E ? e : 0, idx);
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      if (d == i % DIM) ecoord[i] = T(a.origin[d]) + T(idx[d]) * T(a.hax[d]);
  }
  __syncthreads();

  // phase 2: the qp state and the primal density per (element, qp)
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
    // nc = 4 (set_node.cuh): the residual is its node role's, so the
    // Jacobian role needs no primal density and no residual rows
    if constexpr (NC == 4) continue;
    int idx[3];
    elem_index(geo, e, idx);
    QpAt<T, DIM> pt;
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      pt.x[d] = (T(a.origin[d]) + T(idx[d]) * T(a.hax[d])) +
                T(a.qoff[DIM * q + d]);
    pt.e = e;
    pt.q = q;
    Dens::template at<TR>(u, ud, g, pt, a, out);
    T* o = qout + (le * Q + q) * NO;
#pragma unroll
    for (int k = 0; k < NO; ++k) o[k] = out[k];
  }
  __syncthreads();

  // phase 3: residual rows slot, slot + slots, ... of element tid % elems
  if constexpr (NC != 4) {
    const int le = tid % elems, slots = kThreads / elems;
    const int slot = tid / elems;
    const long long e = e0 + le;
    T* res = static_cast<T*>(a.res);
    if (e < geo.E && slot < slots) {
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
    }
  }
  if (a.n_tiles > 0)  // the same in every thread of the grid
    elem_jacobian<T, TR, DIM, NC, NV, Dens>(a, geo, elems, phi, grad, wts,
                                            qst, ecoord, corner);
}

// At most 168 registers, so that 3 blocks fit an SM.
template <typename T, bool TR, int DIM, int NC, int NV, class Dens>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    elem_full_kernel(const ElemArgs a, const ElemGeometry geo,
                     const int elems) {
  elem_body<T, TR, DIM, NC, NV, Dens>(a, geo, elems);
}

// The elements per block and their layout's bytes (0 where one element
// does not fit the card's opt-in shared memory per block): of `want` and
// the counts below it that fit, the one that keeps the most elements
// resident on an SM (the larger at a tie). Leaves the kernel's dynamic
// shared memory limit at the layout's bytes.
template <typename T, int DIM, int NC, int NV, bool TR, class K>
int elem_block_elems(K kernel, int Q, int want, int optin, size_t* smem) {
  using L = ElemLayout<DIM, NC, NV, TR>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       optin);
  int best = 0, resident = 0;
  for (int elems = want; elems >= 1; --elems) {
    const long long bytes = (long long)sizeof(T) * L::total(Q, elems);
    if (bytes > optin) continue;
    int blocks = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                  (size_t)bytes);
    if (best == 0 || blocks * elems > resident) {
      best = elems;
      resident = blocks * elems;
      *smem = (size_t)bytes;
    }
  }
  if (best > 0)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)*smem);
  return best;
}

template <typename T, bool TR, int DIM, int NC, int NV, class Dens>
int elem_launch_case(const ElemArgs& a, const ElemGeometry& geo,
                     void* stream) {
  using L = ElemLayout<DIM, NC, NV, TR>;
  void (*kernel)(const ElemArgs, const ElemGeometry, const int) =
      elem_full_kernel<T, TR, DIM, NC, NV, Dens>;
  if (a.n_tiles < 0 || a.n_tiles > L::NT ||
      (a.n_tiles > 0 && a.tiles == nullptr))
    return (int)cudaErrorInvalidValue;
  // at most as many elements as the tiles fill the block's threads
  int want = a.n_tiles == 0 ? kElems : kThreads / a.n_tiles;
  want = want < 1 ? 1 : (want > kElems ? kElems : want);
  // the last choice of this kernel, reused while Q and want repeat
  static int last_q = 0, last_want = 0, last_elems = 0;
  static size_t last_smem = 0;
  if (a.Q != last_q || want != last_want) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    last_elems = elem_block_elems<T, DIM, NC, NV, TR>(kernel, a.Q, want,
                                                      optin, &last_smem);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    last_q = a.Q;
    last_want = want;
  }
  const int elems = last_elems;
  const size_t smem = last_smem;
  if (elems == 0) return kErrSharedMemory;
  const long long blocks = (geo.E + elems - 1) / elems;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a, geo,
                                                                    elems);
  return (int)cudaGetLastError();
}

// the element grid's geometry of a call's arguments; false where they
// are out of range (Q, the axes, the stride, E < 2^31)
template <int DIM>
bool elem_geometry(const ElemArgs& a, ElemGeometry& geo) {
  if (a.Q < 1 || a.N0 < 1 || a.N1 < 1 || a.N2 < 1 ||
      (DIM == 2 && a.N2 != 1) || a.stride < 1 ||
      (long long)a.N0 * a.N1 * a.N2 >= (1LL << 31))
    return false;
  geo.N1 = a.N1;
  geo.N2 = DIM == 3 ? a.N2 : 1;
  geo.G1 = a.stride * a.N1 + 1;
  geo.G2 = DIM == 3 ? a.stride * a.N2 + 1 : 1;
  geo.G = (long long)(a.stride * a.N0 + 1) * geo.G1 * geo.G2;
  geo.E = (long long)a.N0 * a.N1 * geo.N2;
  return true;
}

template <typename T, int DIM, int NC, int NV, class Dens>
int elem_launch(const ElemArgs* a, void* stream) {
  ElemGeometry geo;
  if (!elem_geometry<DIM>(*a, geo)) return (int)cudaErrorInvalidValue;
  return a->transient
             ? elem_launch_case<T, true, DIM, NC, NV, Dens>(*a, geo, stream)
             : elem_launch_case<T, false, DIM, NC, NV, Dens>(*a, geo, stream);
}

}  // namespace
