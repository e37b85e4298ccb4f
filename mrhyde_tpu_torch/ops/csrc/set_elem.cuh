// Element-tile assembly of a module set (navier stokes, thermal, cdr in
// any combination, with coefficients that may read the state) on uniform
// 3D hex (p1, nc = 8) and 2D p2 quads (nc = 9), steady or a transient
// stage, for Hopper (sm_90a): the entry points set_elem_full, an instance
// of the element-tile engine (elem_engine.cuh), and set_elem_state, a
// kernel of its own below, each with the deck's density, which
// functions/codegen.py generates (a struct with a static `eval`) and
// instantiates through SET_ELEM_ENTRY_POINTS. The generated source
// defines SET_NV (the number of variables), SET_DIM and SET_NC before
// including this header.
//
// Replaces: the TPU element-tile kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_call` (:1283-1318, pallas_call at
// :1303; body `FusedP1Assembly._kernel(node=False)`) for module sets
// (`_density`, :293-314, sums the set's qp densities) and for
// coefficients that read the state (`QpCtx.resolve`, :94-106): in mode
// "full" (:1417, set_elem_full) the nd residual rows and the
// element-varying Jacobian rows of every element; in mode "state"
// (:1402, set_elem_state) the nd residual rows of an AFFINE set's state
// part (JAX's split path; as set_node.cuh's set_node_state) and no
// Jacobian.
//
// What bounds it on the H100, and the design that answers it: the bytes
// of the Jacobian rows (up to nd^2 = 2,304 per element for NS + thermal +
// cdr on hex); the engine linearizes the generated density once per
// (element, qp), on duals seeded along the qp inputs, and contracts that
// linearization with the basis tables in registers (elem_engine.cuh's
// note), where the previous design re-evaluated the density once per
// Jacobian column. The generated density reads the deck's scalars from
// the engine's one argument struct, under its old name SetArgs.
//
// Mode "state" writes the nd residual rows of the densities' derivative
// along the state, u_eval = alpha_u u, u_dot = alpha_t u, from the u grids
// alone (JAX's `_accumulate` mode "lin", :330-345), and no Jacobian:
//   r_(v,c) = sum_q w_q (phi_c S'_v + grad phi_c . F'_v),
// (S'_v, F'_v) the tangent of one Dual<T, 1> pass of the density whose
// value and tangent are both the qp state (its derivative along the
// state). Its bound is the larger of its bytes (the grids once, nd rows
// written) and its operations (that pass and about 2 nc (1 + DIM) NV FMA
// per qp for the qp state and the rows): operations on hex (1.1 times
// the bytes' time steady, 1.4 at a stage), bytes on p2 (chip_smoke.py
// state_work). Design: a persistent grid of kThreads-thread blocks, which
// hold each qp's table values, weight and offsets in one block of shared
// memory, built once per block and read as broadcasts; a thread per
// element, consecutive threads at consecutive elements, each gathering
// its NV nc corner values (a coalesced read per corner) and summing its
// nd rows in registers over its qps, then storing them SoA, res[r E + e],
// coalesced.

#pragma once

#include "elem_engine.cuh"
#include "launch.cuh"
#include "ns_density.cuh"
#include "scalar_density.cuh"

namespace {

using SetArgs = ElemArgs;

// the engine's density of a generated set: Gen::eval at the qp's
// coordinates
template <class Gen, int DIM, int NV>
struct SetDensity {
  template <bool TR, typename S, typename P>
  __device__ __forceinline__ static void at(S (&u)[NV], S (&ud)[NV],
                                            S (&g)[NV][DIM],
                                            const QpAt<P, DIM>& pt,
                                            const ElemArgs& a,
                                            S (&out)[NV * (1 + DIM)]) {
    if constexpr (DIM == 3)
      Gen::template eval<TR, S>(u, ud, g, pt.x[0], pt.x[1], pt.x[2], a, out);
    else
      Gen::template eval<TR, S>(u, ud, g, pt.x[0], pt.x[1], a, out);
  }
};

// mode "state": the blocks per SM its registers must allow, 2 (up to 255
// registers: an element's corner values and rows, 2 nd values, live over
// its qps; at 4 blocks, 128 registers, f64 spilled and took twice the
// time, PERF.md)
constexpr int kElemStateMinBlocks = 2;

// one qp's block of shared memory, in T: phi (nc), grad (nc x DIM,
// c-major), the weight, the qp's offsets in an element (DIM), padded to a
// multiple of 4 values
template <int DIM, int NC>
struct ElemStateQp {
  static constexpr int kGrad = NC, kW = NC * (1 + DIM), kOff = kW + 1;
  static constexpr int PQ = (kOff + DIM + 3) / 4 * 4;
  __host__ __device__ static long long words(int Q) {
    return (long long)Q * PQ;
  }
};

template <typename T, bool TR, int DIM, int NC, int NV, class Dens>
__global__ void __launch_bounds__(kThreads, kElemStateMinBlocks)
    set_elem_state_kernel(const ElemArgs a, const ElemGeometry geo) {
  using L = ElemStateQp<DIM, NC>;
  using D = Dual<T, 1>;
  constexpr int NO = NV * (1 + DIM);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tb = reinterpret_cast<T*>(smem_raw);
  const int Q = a.Q;
  {
    const T* phi = static_cast<const T*>(a.phi);
    const T* grad = static_cast<const T*>(a.grad);
    const T* wts = static_cast<const T*>(a.wts);
    for (int i = threadIdx.x; i < Q * L::PQ; i += kThreads) {
      const int q = i / L::PQ, r = i - q * L::PQ;
      T v = T(0);
      if (r < L::kGrad)
        v = phi[r * Q + q];
      else if (r < L::kW)
        v = grad[((r - L::kGrad) / DIM * Q + q) * DIM + (r - L::kGrad) % DIM];
      else if (r == L::kW)
        v = wts[q];
      else if (r < L::kOff + DIM)
        v = T(a.qoff[DIM * q + r - L::kOff]);
      tb[i] = v;
    }
  }
  __syncthreads();
  const T* __restrict__ ue = static_cast<const T*>(a.ue);
  T* __restrict__ res = static_cast<T*>(a.res);
  const T au = T(a.alpha_u), at = T(a.alpha_t);
  const int p = a.stride;
  int coff[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    coff[c] = (a.off[c][0] * geo.G1 + a.off[c][1]) * geo.G2 + a.off[c][2];
  const long long step = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < geo.E; e += step) {
    int idx[3];
    elem_index(geo, e, idx);
    const long long base =
        ((long long)(p * idx[0]) * geo.G1 + p * idx[1]) * geo.G2 +
        p * idx[2];
    T uc[NV][NC];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        uc[v][c] = __ldg(ue + v * geo.G + base + coff[c]);
    T x0[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      x0[d] = T(a.origin[d]) + T(idx[d]) * T(a.hax[d]);
    T r[NV][NC];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int c = 0; c < NC; ++c) r[v][c] = T(0);
#pragma unroll 1
    for (int q = 0; q < Q; ++q) {
      const T* t = tb + q * L::PQ;
      // the qp state: u_eval = alpha_u u_h, its gradient, u_dot = alpha_t
      // u_h, each seeded along itself
      D zu[NV], zud[NV], zg[NV][DIM], zo[NO];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        T val = T(0), gd[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) gd[d] = T(0);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          val += t[c] * uc[v][c];
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            gd[d] += t[L::kGrad + c * DIM + d] * uc[v][c];
        }
        zu[v].v = zu[v].d[0] = au * val;
        zud[v].v = zud[v].d[0] = TR ? at * val : T(0);
#pragma unroll
        for (int d = 0; d < DIM; ++d) zg[v][d].v = zg[v][d].d[0] = au * gd[d];
      }
      QpAt<T, DIM> pt;
#pragma unroll
      for (int d = 0; d < DIM; ++d) pt.x[d] = x0[d] + t[L::kOff + d];
      pt.e = e;
      pt.q = q;
      Dens::template at<TR>(zu, zud, zg, pt, a, zo);
      // the rows, in the plain version's order
      const T w = t[L::kW];
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          T x = t[c] * zo[v].d[0];
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            x += t[L::kGrad + c * DIM + d] * zo[NV + v * DIM + d].d[0];
          r[v][c] += w * x;
        }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int c = 0; c < NC; ++c) res[(long long)(v * NC + c) * geo.E + e] =
          r[v][c];
  }
}

template <typename T, bool TR, int DIM, int NC, int NV, class Dens>
int set_elem_state_case(const ElemArgs& a, const ElemGeometry& geo,
                        void* stream) {
  auto kernel = set_elem_state_kernel<T, TR, DIM, NC, NV, Dens>;
  const size_t smem = sizeof(T) * ElemStateQp<DIM, NC>::words(a.Q);
  thread_local Resident resident;
  const int err = query_resident(kernel, kThreads, smem, resident);
  if (err != 0) return err;
  const long long need = (geo.E + kThreads - 1) / kThreads;
  const unsigned blocks =
      (unsigned)(need < resident.blocks ? need : resident.blocks);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a, geo);
  return (int)cudaGetLastError();
}

template <typename T, int DIM, int NC, int NV, class Dens>
int set_elem_state_launch(const ElemArgs* a, void* stream) {
  ElemGeometry geo;
  if (!elem_geometry<DIM>(*a, geo)) return (int)cudaErrorInvalidValue;
  return a->transient
             ? set_elem_state_case<T, true, DIM, NC, NV, Dens>(*a, geo,
                                                               stream)
             : set_elem_state_case<T, false, DIM, NC, NV, Dens>(*a, geo,
                                                                stream);
}

}  // namespace

// Plain C entry points of a generated library, bound with ctypes (see
// ops/_build.py load_generated): each takes the host address of an
// ElemArgs and the stream, and returns the cudaGetLastError() of its
// launch, or kErrSharedMemory. set_elem_state reads a.ue (the u grid) and
// writes a.res only.
#define SET_ELEM_ENTRY_POINTS(GEN)                                          \
  extern "C" int set_elem_full_f64(const void* args, void* stream) {        \
    return elem_launch<double, SET_DIM, SET_NC, SET_NV,                     \
                       SetDensity<GEN, SET_DIM, SET_NV>>(                   \
        static_cast<const ElemArgs*>(args), stream);                        \
  }                                                                         \
  extern "C" int set_elem_full_f32(const void* args, void* stream) {        \
    return elem_launch<float, SET_DIM, SET_NC, SET_NV,                      \
                       SetDensity<GEN, SET_DIM, SET_NV>>(                   \
        static_cast<const ElemArgs*>(args), stream);                        \
  }                                                                         \
  extern "C" int set_elem_state_f64(const void* args, void* stream) {       \
    return set_elem_state_launch<double, SET_DIM, SET_NC, SET_NV,           \
                                 SetDensity<GEN, SET_DIM, SET_NV>>(         \
        static_cast<const ElemArgs*>(args), stream);                        \
  }                                                                         \
  extern "C" int set_elem_state_f32(const void* args, void* stream) {       \
    return set_elem_state_launch<float, SET_DIM, SET_NC, SET_NV,            \
                                 SetDensity<GEN, SET_DIM, SET_NV>>(         \
        static_cast<const ElemArgs*>(args), stream);                        \
  }
