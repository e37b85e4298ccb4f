// The Navier-Stokes qp weak form of the port's kernels (fused_p1_ns.cu in
// 2D, fused_elem_ns.cu on hex and p2): ns_density of
// mrhyde_tpu_torch/physics/navierstokes.py, written once over its scalar
// type S, a plain T or a Dual<T, N> of dual.cuh.

#pragma once

#include "dual.cuh"

namespace {

// Per-qp densities out = [S_v for v] + [F_v,d for v for d] at the point:
// u, g (g[v][d] = d u_v / d x_d) and, in a stage, ud for the DIM+1
// variables (ux, uy[, uz], pr: pressure last); rho, visc, src the
// coefficients there. Steady: no u_dot terms (the JAX kernel's steady
// specialization, u_dot = 0).
template <bool TR, int DIM, typename S>
__device__ __forceinline__ void ns_density(
    S u[DIM + 1], S ud[DIM + 1], S g[DIM + 1][DIM],
    typename Passive<S>::type rho, typename Passive<S>::type visc,
    const typename Passive<S>::type src[DIM], typename Passive<S>::type h,
    typename Passive<S>::type tau_dt2, bool pspg, bool supg,
    S out[(DIM + 1) * (DIM + 1)]) {
  using T = typename Passive<S>::type;
  constexpr int NV = DIM + 1;
  S conv[DIM], F[DIM][DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i) {
    conv[i] = u[0] * g[i][0];
#pragma unroll
    for (int d = 1; d < DIM; ++d) conv[i] = conv[i] + u[d] * g[i][d];
    S m = conv[i] - src[i];
    if constexpr (TR) m = (ud[i] + conv[i]) - src[i];
    out[i] = rho * m;
#pragma unroll
    for (int k = 0; k < DIM; ++k) F[i][k] = visc * g[i][k];
    F[i][i] = F[i][i] - u[DIM];
  }
  S divu = g[0][0];
#pragma unroll
  for (int i = 1; i < DIM; ++i) divu = divu + g[i][i];
  out[DIM] = divu;
  S fpr[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) fpr[d] = u[DIM] * T(0);
  if (pspg || supg) {
    S u2 = u[0] * u[0];
#pragma unroll
    for (int d = 1; d < DIM; ++d) u2 = u2 + u[d] * u[d];
    // |u| takes the u2 branch at rest: sqrt is never differentiated at 0
    const S nvel = value(u2) > T(1e-12) ? dsqrt(u2) : u2;
    const T a = T(4) * visc / (h * h);
    const S b = T(2) * nvel / h;
    const S tau = T(1) / dsqrt((b * b + a * a) + tau_dt2);
    S stab[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      S s = rho * conv[i] + g[DIM][i];
      if constexpr (TR) s = (rho * ud[i] + rho * conv[i]) + g[DIM][i];
      stab[i] = s - rho * src[i];
    }
    if (supg) {
#pragma unroll
      for (int i = 0; i < DIM; ++i) {
        const S ts = tau * stab[i];
#pragma unroll
        for (int d = 0; d < DIM; ++d) F[i][d] = F[i][d] + ts * u[d];
      }
    }
    if (pspg) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) fpr[d] = tau * stab[d] / rho;
    }
  }
#pragma unroll
  for (int i = 0; i < DIM; ++i)
#pragma unroll
    for (int d = 0; d < DIM; ++d) out[NV + i * DIM + d] = F[i][d];
#pragma unroll
  for (int d = 0; d < DIM; ++d) out[NV + DIM * DIM + d] = fpr[d];
}

}  // namespace
