// Element-tile assembly of a module set (navier stokes, thermal, cdr in
// any combination, with coefficients that may read the state) on uniform
// 3D hex (p1, nc = 8) and 2D p2 quads (nc = 9), steady or a transient
// stage, for Hopper (sm_90a): the entry points set_elem_full and
// set_elem_state, instances of the element-tile engine (elem_engine.cuh)
// with the deck's density, which functions/codegen.py generates (a struct
// with a static `eval`) and instantiates through SET_ELEM_ENTRY_POINTS.
// The generated source defines SET_NV (the number of variables), SET_DIM
// and SET_NC before including this header.
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

#pragma once

#include "elem_engine.cuh"
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

}  // namespace

// Plain C entry points of a generated library, bound with ctypes (see
// ops/_build.py load_generated): each takes the host address of an
// ElemArgs and the stream, and returns the cudaGetLastError() of its
// launch, or kErrSharedMemory. set_elem_state reads a.ue (the u grid) and
// writes a.res only.
#define SET_ELEM_ENTRY_POINTS(GEN)                                          \
  extern "C" int set_elem_full_f64(const void* args, void* stream) {        \
    return elem_launch<double, SET_DIM, SET_NC, SET_NV,                     \
                       SetDensity<GEN, SET_DIM, SET_NV>, false>(            \
        static_cast<const ElemArgs*>(args), stream);                        \
  }                                                                         \
  extern "C" int set_elem_full_f32(const void* args, void* stream) {        \
    return elem_launch<float, SET_DIM, SET_NC, SET_NV,                      \
                       SetDensity<GEN, SET_DIM, SET_NV>, false>(            \
        static_cast<const ElemArgs*>(args), stream);                        \
  }                                                                         \
  extern "C" int set_elem_state_f64(const void* args, void* stream) {       \
    return elem_launch<double, SET_DIM, SET_NC, SET_NV,                     \
                       SetDensity<GEN, SET_DIM, SET_NV>, true>(             \
        static_cast<const ElemArgs*>(args), stream);                        \
  }                                                                         \
  extern "C" int set_elem_state_f32(const void* args, void* stream) {       \
    return elem_launch<float, SET_DIM, SET_NC, SET_NV,                      \
                       SetDensity<GEN, SET_DIM, SET_NV>, true>(             \
        static_cast<const ElemArgs*>(args), stream);                        \
  }
