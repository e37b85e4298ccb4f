// Node-scatter assembly of a module set (navier stokes, thermal, cdr in
// any combination, with coefficients that may read the state) on uniform
// 2D p1 quads, steady or a transient stage, for Hopper (sm_90a): the
// kernel templates `set_node_full` and `set_node_state`, which
// functions/codegen.py completes per deck with the deck's density (a
// struct with a static `eval`) and instantiates through
// SET_NODE_ENTRY_POINTS. The generated source defines SET_NV, the number
// of variables, before including this header.
//
// Replaces: the TPU node-scatter kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_node_call` (:1320-1379, pallas_call at
// :1350; body `FusedP1Assembly._kernel(node=True)`) for module sets
// (`_density`, :293-314, sums the set's qp densities) and for
// coefficients that read the state (`QpCtx.resolve`, :94-106): in mode
// "full" (:1414, set_node_full) the node-scattered residual and the
// element-varying Jacobian rows; in mode "state" (:1400, set_node_state)
// the state part of an AFFINE set's residual (JAX's split path), node-
// scattered, and no Jacobian.
//
// Weak form, per element e and quadrature point q, at u_eval = alpha_u u
// + beta_u and u_dot = alpha_t u + beta_t (steady: alpha_u = 1, no
// u_dot): the generated density gives (S_v, F_v) for every variable v;
//   r_(v,c)  = sum_q w_q (phi_c S_v + grad phi_c . F_v), summed to the
//              node of corner c over its (up to) four elements;
//   J[(v,c),(w,c')] = sum_q w_q (phi_c T[S_v] + grad phi_c . T[F_v]),
//   T[o] = the derivative of density output o along u_w += alpha_u
//          phi_c', grad u_w += alpha_u grad phi_c', u_dot_w += alpha_t
//          phi_c' (the JAX kernel's column tangents).
// Row k = row*nd + col, row = v*4 + c, col = w*4 + c', nd = 4 SET_NV,
// corners (0,0),(1,0),(1,1),(0,1) on (axis 0, axis 1); the qp's
// coordinates are origin + (I, J) h + q_off[q], as the JAX kernel
// synthesizes them. Only the rows the host probe classified
// element-varying are stored, as jac[pos*E + e] with pos = row_pos[k] >=
// 0; the constant rows are the probe's values.
//
// Mode "state" (JAX's `_accumulate` mode "lin", :330-345): the kernel
// reads the u grid alone, u_eval = alpha_u u and u_dot = alpha_t u (no
// betas; steady: u, no u_dot), and replaces each density output o by its
// directional derivative along the state, sum_k (d o / d z_k) z_k over
// the qp state z = (u, u_dot, grad u): one Dual<T, 1> pass whose value
// and tangent are both z. For an affine density that is the state part;
// the state-independent rest (the density at the betas and the Jacobian)
// is the provider's plain-torch coord part.
//
// Design. Mode "full" is one launch of two roles, split by block index:
//   Jacobian blocks (the first ones): the element-tile engine
//     (elem_engine.cuh) at nc = 4, DIM = 2, stride 1, its lattice the
//     corners (0,0), (1,0), (1,1), (0,1) of the node grid: per block of
//     `elems` elements (as many as the varying (v, w) tiles of 4 columns
//     fill 128 threads, or fewer where the card's shared memory keeps
//     more resident) the tables, corner values and qp state go to shared
//     memory; each (element, qp) is LINEARIZED once per variable w, on
//     Dual<T, NB> seeded along w's NB qp inputs (u_w, grad u_w[, u_dot_w]:
//     NV passes per qp, where the previous design took one Dual<T, 1> pass
//     per column, nd = 4 NV), then CONTRACTED with the basis tables per
//     (element, tile) in registers, varying tiles only (the host's list
//     `tiles`, ops/_launch.py elem_tiles). The generated density reaches
//     the engine through SetNodeDensity. The engine skips its primal
//     densities and residual rows at nc = 4. For one variable, and past
//     kQc qps (where the chunked linearization would leave 2 blocks per
//     SM), the engine's phases do not pay for themselves, and the role
//     is the previous per-column design (set_jacobian_tile, node_columns).
//   residual blocks: one thread per node, as fused_p1_ns.cu's: it gathers
//     the corner values of its (up to) four elements, evaluates the
//     primal density at their quadrature points and sums their
//     contributions to itself in a fixed order: no atomics.
// Both roles of the engine's kernel take its register bound (3 blocks of
// 128 threads per SM; 4 at a stage, whose longer linearization gains
// more from them than it loses to spills); the per-column kernel takes
// the plain launch bound.
// Mode "state" is the tile walk of the thermal node kernels
// (node_walk.cuh) over the NV u grids: a persistent grid whose blocks
// hold the tables and the qps' offsets in shared memory once, walking
// tiles of 16 x 32 elements (two per thread) while the next tile's node
// patches of all NV grids are in flight; each element's qp state and
// tangent-only density pass run once per qp, into its 4 NV corner rows in
// shared memory (double-buffered: one barrier per tile), and each node
// sums its four rows per variable, corner 0..3 in order. Mesh edges are
// masked by index; any N0, N1 >= 1 works (N0 N1 < 2^31); offsets are
// 64-bit.
//
// What bounds it on the H100: the writes of the Jacobian rows (up to nd^2
// = 400 per element) against the operations of the engine's scheme, which
// chip_smoke.py counts on the plain version (its sparse forward AD) and
// reports as the bound; mode "state" reads the u grids and writes the node
// residual (2 NV values per node), and its operations, each element's
// tangent-only quadrature once, take within 15% of those bytes' time
// (less when steady, more at a stage).

#pragma once

#include <cuda_runtime.h>

#include "elem_engine.cuh"
#include "launch.cuh"
#include "node_walk.cuh"
#include "ns_density.cuh"
#include "scalar_density.cuh"

namespace {

// The C interface's arguments, filled by ctypes (ops/fused_set.py
// _SetArgs). kThreads, kElems and kMaxScalars are the engine's
// (elem_engine.cuh).
struct SetArgs {
  const void* ue;       // (SET_NV, N0+1, N1+1) u_eval grids
  const void* ud;       // the u_dot grids, or null (steady)
  const void* phi;      // (4, Q)
  const void* grad;     // (4, Q, 2)
  const void* wts;      // (Q,)
  const int* row_pos;   // (nd*nd,) position of row k in jac, or -1
  void* res;            // (SET_NV, N0+1, N1+1) node residual
  void* jac;            // (n_rows, E) Jacobian rows
  double alpha_u, alpha_t, h, tau_dt2;  // tau_dt2 = (C3 / dt)^2
  double origin[2], hax[2];             // the box's origin and spacing
  const double* qoff;                   // (Q, 2) the qps' offsets in an
                                        // element, on the device
  double sc[kMaxScalars];  // t, beta, T_ambient, the deck's parameters
  int Q, N0, N1, n_rows, pspg, supg, transient;
  const int* tiles;  // (n_tiles,) the engine's tiles holding a varying row
  int n_tiles;
};

// mode "full"'s residual role: node n = (i, j) sums the rows of its
// corners
template <typename T, bool TR, int NV, class Dens>
__device__ __forceinline__ void set_residual_node(const SetArgs& a,
                                                  long long n) {
  const int N0 = a.N0, N1 = a.N1, Q = a.Q;
  const long long nodes = (long long)(N0 + 1) * (N1 + 1);
  if (n >= nodes) return;
  const T* __restrict__ ue = static_cast<const T*>(a.ue);
  const T* __restrict__ udg = static_cast<const T*>(a.ud);
  const T* __restrict__ phi = static_cast<const T*>(a.phi);
  const T* __restrict__ grad = static_cast<const T*>(a.grad);
  const T* __restrict__ wts = static_cast<const T*>(a.wts);
  const int i = (int)(n / (N1 + 1)), j = (int)(n % (N1 + 1));
  T acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = T(0);
#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    // node (i, j) is corner c of element (ea, eb)
    const int ea = i - corner_i(c), eb = j - corner_j(c);
    if (ea < 0 || ea >= N0 || eb < 0 || eb >= N1) continue;
    T uc[NV][4], udc[NV][4];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long p = v * nodes +
                            (long long)(ea + corner_i(k)) * (N1 + 1) + eb +
                            corner_j(k);
        uc[v][k] = ue[p];
        udc[v][k] = TR ? udg[p] : T(0);
      }
    T r[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) r[v] = T(0);
    for (int q = 0; q < Q; ++q) {
      T u[NV], ud[NV], g[NV][2], out[3 * NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        T s = T(0), s_t = T(0), g0 = T(0), g1 = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s += phi[k * Q + q] * uc[v][k];
          s_t += phi[k * Q + q] * udc[v][k];
          g0 += grad[(k * Q + q) * 2 + 0] * uc[v][k];
          g1 += grad[(k * Q + q) * 2 + 1] * uc[v][k];
        }
        u[v] = s;
        ud[v] = s_t;
        g[v][0] = g0;
        g[v][1] = g1;
      }
      const T x =
          (T(a.origin[0]) + T(ea) * T(a.hax[0])) + T(a.qoff[2 * q + 0]);
      const T y =
          (T(a.origin[1]) + T(eb) * T(a.hax[1])) + T(a.qoff[2 * q + 1]);
      Dens::template eval<TR, T>(u, ud, g, x, y, a, out);
      const T pc = phi[c * Q + q];
      const T g0 = grad[(c * Q + q) * 2 + 0], g1 = grad[(c * Q + q) * 2 + 1];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        r[v] += wts[q] * (pc * out[v] + g0 * out[NV + 2 * v] +
                          g1 * out[NV + 2 * v + 1]);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] += r[v];
  }
  T* __restrict__ res = static_cast<T*>(a.res);
#pragma unroll
  for (int v = 0; v < NV; ++v) res[v * nodes + n] = acc[v];
}

// the Jacobian role's elements per block, at most (as many as its tiles
// fill kThreads), and the blocks per SM its registers allow (both roles)
constexpr int kNodeElems = 32;
constexpr int node_min_blocks(bool transient) {
  return transient ? 4 : kMinBlocks;
}

// the engine's density of a generated set on 2D p1 quads: Gen::eval at
// the qp's coordinates, reading the deck's scalars from the engine's
// argument struct
template <class Gen, int NV>
struct SetNodeDensity {
  template <bool TR, typename S, typename P>
  __device__ __forceinline__ static void at(S (&u)[NV], S (&ud)[NV],
                                            S (&g)[NV][2],
                                            const QpAt<P, 2>& pt,
                                            const ElemArgs& a,
                                            S (&out)[3 * NV]) {
    Gen::template eval<TR, S>(u, ud, g, pt.x[0], pt.x[1], a, out);
  }
};

// The per-column Jacobian role (node_columns: one variable, or past kQc
// qps, where the engine's linearization chunks would hold fewer elements
// per SM): a block owns `elems` elements (16, or fewer where the layout
// of 16 would not fit the card's shared memory); the tables, the corner
// values and the qp state of all variables go to shared memory; then
// each thread (element, slot) walks the columns slot, slot + slots, ...:
// a column is one forward pass of the density on Dual<T, 1> at every qp,
// its nd sums kept in registers and written where the probe says the row
// varies. Its shared memory, in T: tables phi (4Q), grad (8Q), wts (Q);
// the corner values (elems x NS0 x ND); the qp state u, g[, ud] (elems x
// Q x NQ).
template <int NV, bool TR>
struct ColumnLayout {
  static constexpr int ND = 4 * NV;
  static constexpr int NS0 = TR ? 2 : 1;             // u_eval [, u_dot]
  static constexpr int NQ = 3 * NV + (TR ? NV : 0);
  __host__ __device__ static long long tables(int Q) { return 13LL * Q; }
  __host__ __device__ static long long corners(int elems) {
    return (long long)elems * NS0 * ND;
  }
  __host__ __device__ static long long total(int Q, int elems) {
    return tables(Q) + corners(elems) + (long long)elems * Q * NQ;
  }
};

template <typename T, bool TR, int NV, class Dens>
__device__ __forceinline__ void set_jacobian_tile(const SetArgs& a,
                                                  long long tile, T* s,
                                                  const int elems) {
  using L = ColumnLayout<NV, TR>;
  constexpr int ND = L::ND, NQ = L::NQ;
  using D = Dual<T, 1>;
  const int Q = a.Q, N1 = a.N1, slots = kThreads / elems;
  const long long E = (long long)a.N0 * N1;
  const long long nodes = (long long)(a.N0 + 1) * (N1 + 1);
  T* phi = s;
  T* grad = phi + 4 * Q;
  T* wts = grad + 8 * Q;
  T* corner = s + L::tables(Q);
  T* qst = corner + L::corners(elems);
  const int tid = threadIdx.x;
  const long long e0 = tile * elems;

  // phase 1: tables and corner values
  {
    const T* phi_g = static_cast<const T*>(a.phi);
    const T* grad_g = static_cast<const T*>(a.grad);
    const T* wts_g = static_cast<const T*>(a.wts);
    for (int i = tid; i < 13 * Q; i += kThreads)
      s[i] = i < 4 * Q ? phi_g[i]
                       : (i < 12 * Q ? grad_g[i - 4 * Q] : wts_g[i - 12 * Q]);
  }
  for (int i = tid; i < L::corners(elems); i += kThreads) {
    const int le = i / (L::NS0 * ND), rest = i % (L::NS0 * ND);
    const int which = rest / ND, k = rest % ND;
    const long long e = e0 + le;
    T val = T(0);
    if (e < E) {
      const T* grid = static_cast<const T*>(which ? a.ud : a.ue);
      const int ea = (int)(e / N1), eb = (int)(e % N1), c = k % 4;
      val = grid[(k / 4) * nodes + (long long)(ea + corner_i(c)) * (N1 + 1) +
                 eb + corner_j(c)];
    }
    corner[i] = val;
  }
  __syncthreads();

  // phase 2: the qp state per (element, qp)
  for (int i = tid; i < elems * Q; i += kThreads) {
    const int le = i / Q, q = i % Q;
    const T* uc = corner + le * L::NS0 * ND;
    T* st = qst + (le * Q + q) * NQ;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      T val = T(0), dot = T(0), g0 = T(0), g1 = T(0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T x = uc[v * 4 + c];
        val += phi[c * Q + q] * x;
        g0 += grad[(c * Q + q) * 2 + 0] * x;
        g1 += grad[(c * Q + q) * 2 + 1] * x;
        if constexpr (TR) dot += phi[c * Q + q] * uc[ND + v * 4 + c];
      }
      st[v] = val;
      st[NV + 2 * v] = g0;
      st[NV + 2 * v + 1] = g1;
      if constexpr (TR) st[3 * NV + v] = dot;
    }
  }
  __syncthreads();

  const int le = tid % elems, slot = tid / elems;
  const long long e = e0 + le;
  if (e >= E) return;
  const int ea = (int)(e / N1), eb = (int)(e % N1);
  T* jac = static_cast<T*>(a.jac);
  const T au = T(a.alpha_u), at = T(a.alpha_t);
#pragma unroll 1
  for (int col = slot; col < ND; col += slots) {
    const int w = col / 4, cp = col % 4;
    T J[ND];
#pragma unroll
    for (int r = 0; r < ND; ++r) J[r] = T(0);
    for (int q = 0; q < Q; ++q) {
      const T* st = qst + (le * Q + q) * NQ;
      const T pcp = phi[cp * Q + q];
      D u[NV], ud[NV], g[NV][2], out[3 * NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const bool on = v == w;
        u[v].v = st[v];
        u[v].d[0] = on ? au * pcp : T(0);
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          g[v][d].v = st[NV + 2 * v + d];
          g[v][d].d[0] = on ? au * grad[(cp * Q + q) * 2 + d] : T(0);
        }
        ud[v].v = TR ? st[3 * NV + v] : T(0);
        ud[v].d[0] = (TR && on) ? at * pcp : T(0);
      }
      const T x =
          (T(a.origin[0]) + T(ea) * T(a.hax[0])) + T(a.qoff[2 * q + 0]);
      const T y =
          (T(a.origin[1]) + T(eb) * T(a.hax[1])) + T(a.qoff[2 * q + 1]);
      Dens::template eval<TR, D>(u, ud, g, x, y, a, out);
      const T wq = wts[q];
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const T t = phi[c * Q + q] * out[v].d[0] +
                      grad[(c * Q + q) * 2 + 0] * out[NV + 2 * v].d[0] +
                      grad[(c * Q + q) * 2 + 1] * out[NV + 2 * v + 1].d[0];
          J[v * 4 + c] += wq * t;
        }
    }
#pragma unroll
    for (int r = 0; r < ND; ++r) {
      const int pos = __ldg(a.row_pos + r * ND + col);
      if (pos >= 0) jac[(long long)pos * E + e] = J[r];
    }
  }
}

// whether the Jacobian role takes the per-column design: past kQc qps,
// and for one variable, whose 4 columns the engine's phases do not pay
// for (PERF.md)
template <int NV>
__host__ __device__ inline bool node_columns(int Q) {
  return NV == 1 || Q > kQc;
}

// shared memory of a Jacobian block of `elems` elements, in T: the
// engine's layout at nc = 4, or the per-column one (node_columns)
// (ops/_launch.py `node_smem_words`)
template <int NV, bool TR>
struct SetLayout {
  __host__ __device__ static long long total(int Q, int elems) {
    return node_columns<NV>(Q) ? ColumnLayout<NV, TR>::total(Q, elems)
                               : ElemLayout<2, 4, NV, TR>::total(Q, elems);
  }
};

// mode "full": the Jacobian role on blocks 0 .. jac_blocks - 1 (the
// engine's phases 1, 2 and 4 on `elems` elements each), then the
// residual role; the engine's register bound for both
template <typename T, bool TR, int NV, class Dens>
__global__ void __launch_bounds__(kThreads, node_min_blocks(TR))
    set_node_full_kernel(const SetArgs a, const ElemArgs ea,
                         const ElemGeometry geo, const long long jac_blocks,
                         const int elems) {
  if (blockIdx.x >= jac_blocks) {
    set_residual_node<T, TR, NV, Dens>(
        a, (long long)(blockIdx.x - jac_blocks) * kThreads + threadIdx.x);
    return;
  }
  elem_body<T, TR, 2, 4, NV, SetNodeDensity<Dens, NV>>(ea, geo, elems);
}

// the same with the Jacobian role per column (node_columns)
template <typename T, bool TR, int NV, class Dens>
__global__ void __launch_bounds__(kThreads)
    set_node_column_kernel(const SetArgs a, const ElemArgs ea,
                           const ElemGeometry geo,
                           const long long jac_blocks, const int elems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x >= jac_blocks) {
    set_residual_node<T, TR, NV, Dens>(
        a, (long long)(blockIdx.x - jac_blocks) * kThreads + threadIdx.x);
    return;
  }
  set_jacobian_tile<T, TR, NV, Dens>(a, blockIdx.x,
                                     reinterpret_cast<T*>(smem_raw), elems);
}

// the engine's arguments of the Jacobian role: the corners (0,0), (1,0),
// (1,1), (0,1) of a p1 node grid
inline ElemArgs node_elem_args(const SetArgs& a) {
  ElemArgs e = {};
  e.ue = a.ue;
  e.ud = a.ud;
  e.phi = a.phi;
  e.grad = a.grad;
  e.wts = a.wts;
  e.row_pos = a.row_pos;
  e.tiles = a.tiles;
  e.jac = a.jac;
  e.alpha_u = a.alpha_u;
  e.alpha_t = a.alpha_t;
  e.h = a.h;
  e.tau_dt2 = a.tau_dt2;
  for (int d = 0; d < 2; ++d) {
    e.origin[d] = a.origin[d];
    e.hax[d] = a.hax[d];
  }
  e.qoff = a.qoff;
  for (int i = 0; i < kMaxScalars; ++i) e.sc[i] = a.sc[i];
  e.Q = a.Q;
  e.nc = 4;
  e.dim = 2;
  e.stride = 1;
  e.N0 = a.N0;
  e.N1 = a.N1;
  e.N2 = 1;
  e.n_tiles = a.n_tiles;
  e.pspg = a.pspg;
  e.supg = a.supg;
  e.transient = a.transient;
  const int corners[4][2] = {{0, 0}, {1, 0}, {1, 1}, {0, 1}};
  for (int c = 0; c < 4; ++c) {
    e.off[c][0] = corners[c][0];
    e.off[c][1] = corners[c][1];
  }
  return e;
}

// the per-column role's elements per block: the most (16, 8, ..., 1)
// whose layout fits the card's opt-in shared memory per block, and that
// layout's bytes; 0 where one element does not fit
template <typename T, int NV, bool TR>
int column_elems(int Q, long long optin, size_t* smem) {
  for (int elems = kElems; elems >= 1; elems /= 2) {
    const long long bytes =
        (long long)sizeof(T) * ColumnLayout<NV, TR>::total(Q, elems);
    if (bytes <= optin) {
      *smem = (size_t)bytes;
      return elems;
    }
  }
  return 0;
}

template <typename T, bool TR, int NV, class Dens>
int set_full_launch(const SetArgs& a, void* stream) {
  using L = ElemLayout<2, 4, NV, TR>;
  const bool columns = node_columns<NV>(a.Q);
  auto kernel = columns ? set_node_column_kernel<T, TR, NV, Dens>
                        : set_node_full_kernel<T, TR, NV, Dens>;
  if (a.n_tiles < 0 || a.n_tiles > L::NT ||
      (a.n_tiles > 0 && a.tiles == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long nodes = (long long)(a.N0 + 1) * (a.N1 + 1);
  const long long E = (long long)a.N0 * a.N1;
  const long long res_blocks = (nodes + kThreads - 1) / kThreads;
  const ElemArgs ea = node_elem_args(a);
  ElemGeometry geo;
  geo.N1 = a.N1;
  geo.N2 = 1;
  geo.G1 = a.N1 + 1;
  geo.G2 = 1;
  geo.G = nodes;
  geo.E = E;
  size_t smem = 0;
  int elems = 1;
  long long jac_blocks = 0;
  if (a.n_tiles > 0) {
    // at most as many elements as the tiles fill the block's threads; the
    // last choice of this kernel, reused while Q and want repeat
    int want = kThreads / a.n_tiles;
    want = want < 1 ? 1 : (want > kNodeElems ? kNodeElems : want);
    static int last_q = 0, last_want = 0, last_elems = 0;
    static size_t last_smem = 0;
    if (a.Q != last_q || want != last_want) {
      int dev = 0, optin = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
      if (columns) {
        last_elems = column_elems<T, NV, TR>(a.Q, optin, &last_smem);
        if (last_smem > 48 * 1024)
          cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)last_smem);
      } else {
        last_elems = elem_block_elems<T, 2, 4, NV, TR>(kernel, a.Q, want,
                                                       optin, &last_smem);
      }
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      last_q = a.Q;
      last_want = want;
    }
    if (last_elems == 0) return kErrSharedMemory;
    elems = last_elems;
    smem = last_smem;
    jac_blocks = (E + elems - 1) / elems;
  }
  kernel<<<(unsigned)(jac_blocks + res_blocks), kThreads, smem,
           (cudaStream_t)stream>>>(a, ea, geo, jac_blocks, elems);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// mode "state": the tile walk (node_walk.cuh) over the NV u grids
// ---------------------------------------------------------------------

// its tile: 16 x 32 elements, two per thread, computed one at a time;
// the blocks per SM its registers must allow (its shared memory holds two
// in f64; PERF.md has the measurements behind these choices)
using StateTile = WalkTile<16, 32, 256>;
constexpr int kStateMinBlocks = 2;
constexpr int kStateUnroll = 1;

// one qp's table values in shared memory, read in 16-byte loads: the four
// corners' phi and grad, the weight and the qp's offsets in an element
template <typename T>
struct alignas(16) StateQp {
  T phi[4], g0[4], g1[4], w, off[2], pad;
};

// shared memory of a set_node_state block, in T: a StateQp per qp (16 Q),
// then the walk's patches and rows of the NV grids (ops/_launch.py
// `set_state_smem_words`)
__host__ __device__ inline long long set_state_words(int nv, int Q) {
  return 16LL * Q + StateTile::words(nv);
}

// The state part of an affine set's residual, node-scattered: each
// element of the walk's tiles, at each qp, forms u_eval = alpha_u u_h,
// grad u_eval and (a stage) u_dot = alpha_t u_h of every variable from
// its corner values, runs the generated density once on Dual<T, 1>
// seeded along the state itself (value and tangent both the qp state:
// its tangent is the density's derivative along the state) and adds w_q
// (phi_c S'_v + grad phi_c . F'_v) to its row (v, c), corner c of
// variable v's grid, as the plain version orders these operations; each
// node sums its four elements' rows, corner 0..3 in order, as the plain
// pad+sum version sums them. QF > 0: Q = QF at compile time (the decks'
// Q = 4, its qp loop unrolled).
template <typename T, bool TR, int NV, class Dens, int QF>
__global__ void __launch_bounds__(StateTile::kThreads, kStateMinBlocks)
    set_node_state_kernel(const SetArgs a, const int tiles_j,
                          const int tiles) {
  using D = Dual<T, 1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = QF > 0 ? QF : a.Q;
  StateQp<T>* tb = reinterpret_cast<StateQp<T>*>(smem_raw);
  T* patches = reinterpret_cast<T*>(tb + Q);
  T* rows = patches + 2 * NV * StateTile::kPatch;
  {
    const T* phi_g = static_cast<const T*>(a.phi);
    const T* grad_g = static_cast<const T*>(a.grad);
    const T* wts_g = static_cast<const T*>(a.wts);
    for (int q = threadIdx.x; q < Q; q += StateTile::kThreads) {
      StateQp<T> t;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        t.phi[c] = phi_g[c * Q + q];
        t.g0[c] = grad_g[(c * Q + q) * 2 + 0];
        t.g1[c] = grad_g[(c * Q + q) * 2 + 1];
      }
      t.w = wts_g[q];
      t.off[0] = T(a.qoff[2 * q + 0]);
      t.off[1] = T(a.qoff[2 * q + 1]);
      t.pad = T(0);
      tb[q] = t;
    }
  }
  const T au = T(a.alpha_u), at = T(a.alpha_t);
  auto element = [&](int, int, int ea, int eb, const T (&pu)[4 * NV],
                     T (&r)[4 * NV]) {
    T uc[NV][4], udc[NV][4];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uc[v][k] = au * pu[4 * v + k];
        udc[v][k] = TR ? at * pu[4 * v + k] : T(0);
      }
    const T x0 = T(a.origin[0]) + T(ea) * T(a.hax[0]);
    const T y0 = T(a.origin[1]) + T(eb) * T(a.hax[1]);
#pragma unroll(QF > 0 ? QF : 1)
    for (int q = 0; q < Q; ++q) {
      const StateQp<T> t = tb[q];
      D zu[NV], zud[NV], zg[NV][2], zo[3 * NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        T s = T(0), s_t = T(0), g0 = T(0), g1 = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s += t.phi[k] * uc[v][k];
          if constexpr (TR) s_t += t.phi[k] * udc[v][k];
          g0 += t.g0[k] * uc[v][k];
          g1 += t.g1[k] * uc[v][k];
        }
        zu[v].v = zu[v].d[0] = s;
        zud[v].v = zud[v].d[0] = s_t;
        zg[v][0].v = zg[v][0].d[0] = g0;
        zg[v][1].v = zg[v][1].d[0] = g1;
      }
      Dens::template eval<TR, D>(zu, zud, zg, x0 + t.off[0], y0 + t.off[1],
                                 a, zo);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int v = 0; v < NV; ++v)
          r[4 * v + c] +=
              t.w * (t.phi[c] * zo[v].d[0] + t.g0[c] * zo[NV + 2 * v].d[0] +
                     t.g1[c] * zo[NV + 2 * v + 1].d[0]);
    }
  };
  node_walk<T, StateTile, NV, kStateUnroll>(
      static_cast<const T*>(a.ue), (long long)(a.N0 + 1) * (a.N1 + 1), a.N0,
      a.N1, tiles_j, tiles, patches, rows, static_cast<T*>(a.res), element);
}

template <typename T, bool TR, int NV, class Dens, int QF>
int set_state_case(const SetArgs& a, void* stream) {
  auto kernel = set_node_state_kernel<T, TR, NV, Dens, QF>;
  const size_t smem = sizeof(T) * set_state_words(NV, a.Q);
  thread_local Resident resident;
  const int err = query_resident(kernel, StateTile::kThreads, smem, resident);
  if (err != 0) return err;
  int tiles_j, tiles, blocks;
  if (!walk_grid<StateTile>(a.N0, a.N1, resident.blocks, tiles_j, tiles,
                            blocks))
    return (int)cudaErrorInvalidValue;
  kernel<<<blocks, StateTile::kThreads, smem, (cudaStream_t)stream>>>(
      a, tiles_j, tiles);
  return (int)cudaGetLastError();
}

template <typename T, bool TR, int NV, class Dens>
int set_state_launch(const SetArgs& a, void* stream) {
  return a.Q == 4 ? set_state_case<T, TR, NV, Dens, 4>(a, stream)
                  : set_state_case<T, TR, NV, Dens, 0>(a, stream);
}

template <typename T, int NV, class Dens, bool STATE>
int set_launch(const SetArgs* a, void* stream) {
  if (a->Q < 1 || a->N0 < 1 || a->N1 < 1 ||
      (long long)a->N0 * a->N1 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if constexpr (STATE)
    return a->transient ? set_state_launch<T, true, NV, Dens>(*a, stream)
                        : set_state_launch<T, false, NV, Dens>(*a, stream);
  else
    return a->transient ? set_full_launch<T, true, NV, Dens>(*a, stream)
                        : set_full_launch<T, false, NV, Dens>(*a, stream);
}

}  // namespace

// Plain C entry points of a generated library, bound with ctypes (see
// ops/_build.py load_generated): each takes the host address of a SetArgs
// and the stream, and returns the cudaGetLastError() of its launch, or
// kErrSharedMemory. set_node_state reads a.ue (the u grid) and writes
// a.res only.
#define SET_NODE_ENTRY_POINTS(DENS)                                     \
  extern "C" int set_node_full_f64(const void* args, void* stream) {    \
    return set_launch<double, SET_NV, DENS, false>(                     \
        static_cast<const SetArgs*>(args), stream);                     \
  }                                                                     \
  extern "C" int set_node_full_f32(const void* args, void* stream) {    \
    return set_launch<float, SET_NV, DENS, false>(                      \
        static_cast<const SetArgs*>(args), stream);                     \
  }                                                                     \
  extern "C" int set_node_state_f64(const void* args, void* stream) {   \
    return set_launch<double, SET_NV, DENS, true>(                      \
        static_cast<const SetArgs*>(args), stream);                     \
  }                                                                     \
  extern "C" int set_node_state_f32(const void* args, void* stream) {   \
    return set_launch<float, SET_NV, DENS, true>(                       \
        static_cast<const SetArgs*>(args), stream);                     \
  }
