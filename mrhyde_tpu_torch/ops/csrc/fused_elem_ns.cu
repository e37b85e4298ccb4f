// Element-tile assembly of incompressible Navier-Stokes (equal-order,
// PSPG/SUPG) on uniform 3D hex (p1: ux, uy, uz, pr x 8 corners, nd = 32)
// and 2D p2 quads (ux, uy, pr x 9 lattice dofs, nd = 27), steady or a
// transient stage, for Hopper (sm_90a): the entry points ns_elem_full,
// an instance of the element-tile engine (elem_engine.cuh) with the
// Navier-Stokes density.
//
// Replaces: the TPU element-tile kernel of the JAX package,
// mrhyde_tpu/ops/fused_p1.py `run_call` (:1283-1318, pallas_call at
// :1303; body `FusedP1Assembly._kernel(node=False)`), in mode "full"
// (:1417) for the Navier-Stokes weak form: the nd residual rows and the
// element-varying Jacobian rows of every element. The caller scatters the
// residual rows to the nodes (pad+sum on the p1 node grid, strided adds
// on the p2 fine lattice), as the JAX package does after its kernel.
//
// The weak form is written once, `ns_density` over its scalar type
// (ns_density.cuh, shared with fused_p1_ns.cu and the module sets), and
// differentiated by the dual numbers of dual.cuh; nothing is
// differentiated by hand. Its coefficients (density, viscosity, the
// sources) are scalars or (E, Q) tensors, read at the qp's element and
// index (ElemArgs.coef, coef0).
//
// What bounds it on the H100, and the design that answers it: the bytes
// of the Jacobian rows (about 860 f64 of nd^2 = 1,024 per hex element
// vary); the engine linearizes the density once per (element, qp), on
// duals seeded along the 16 (steady) or 20 (stage) qp inputs, and
// contracts that linearization with the basis tables in registers
// (elem_engine.cuh's note), where the previous design re-evaluated the
// density on a dual once per Jacobian column, 32 times per qp.

#include "elem_engine.cuh"
#include "ns_density.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T coef_at(const ElemArgs& a, int k, long long e,
                                     int q) {
  return a.coef[k] ? static_cast<const T*>(a.coef[k])[e * a.Q + q]
                   : T(a.coef0[k]);
}

// the engine's density: ns_density at the qp's coefficients
template <int DIM>
struct NsDensity {
  static constexpr int NV = DIM + 1;
  template <bool TR, typename S, typename P>
  __device__ __forceinline__ static void at(S (&u)[NV], S (&ud)[NV],
                                            S (&g)[NV][DIM],
                                            const QpAt<P, DIM>& pt,
                                            const ElemArgs& a,
                                            S (&out)[NV * (1 + DIM)]) {
    P src[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) src[d] = coef_at<P>(a, 2 + d, pt.e, pt.q);
    ns_density<TR, DIM, S>(u, ud, g, coef_at<P>(a, 0, pt.e, pt.q),
                           coef_at<P>(a, 1, pt.e, pt.q), src, P(a.h),
                           P(a.tau_dt2), a.pspg, a.supg, out);
  }
};

template <typename T>
int launch(const ElemArgs* a, void* stream) {
  if (a->dim == 3 && a->nc == 8)
    return elem_launch<T, 3, 8, 4, NsDensity<3>>(a, stream);
  if (a->dim == 2 && a->nc == 9)
    return elem_launch<T, 2, 9, 3, NsDensity<2>>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes (see ops/_build.py). Each takes
// the host address of an ElemArgs and the stream, and returns the
// cudaGetLastError() of its launch (cudaErrorInvalidValue for a (dim, nc)
// with no instantiation, kErrSharedMemory where one element's layout
// does not fit the card's shared memory).
extern "C" {

int ns_elem_full_f64(const void* args, void* stream) {
  return launch<double>(static_cast<const ElemArgs*>(args), stream);
}

int ns_elem_full_f32(const void* args, void* stream) {
  return launch<float>(static_cast<const ElemArgs*>(args), stream);
}

}  // extern "C"
