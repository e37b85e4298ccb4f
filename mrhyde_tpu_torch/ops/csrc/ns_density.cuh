// The Navier-Stokes qp weak form of the port's kernels (fused_p1_ns.cu in
// 2D, fused_elem_ns.cu on hex and p2, set_node.cuh for module sets):
// ns_density of mrhyde_tpu_torch/physics/navierstokes.py, written once
// over its scalar type S, a plain T or a Dual<T, N> of dual.cuh. The
// coefficients are of type C: T (the default) where they read no state,
// S where one does (a module set's kernel, whose coefficients are
// generated). BUOY adds the Boussinesq term buoy source_d of an NS +
// thermal set to the momentum equations and their strong residuals
// (buoy = rho beta (e - T_ambient)); the defaults compile to the code of
// the NS kernels. RECIP takes the quotients by h and rho through their
// reciprocals and tau through drsqrt: 3 divisions per dual pass where the
// quotients as written take 17, each result within a few ulps of theirs
// (ns_node_full instances it; the other kernels keep the default).

#pragma once

#include "dual.cuh"

namespace {

// Per-qp densities out = [S_v for v] + [F_v,d for v for d] at the point:
// u, g (g[v][d] = d u_v / d x_d) and, in a stage, ud for the DIM+1
// variables (ux, uy[, uz], pr: pressure last); rho, visc, src the
// coefficients there. Steady: no u_dot terms (the JAX kernel's steady
// specialization, u_dot = 0).
template <bool TR, int DIM, typename S,
          typename C = typename Passive<S>::type, bool BUOY = false,
          bool RECIP = false>
__device__ __forceinline__ void ns_density(
    S u[DIM + 1], S ud[DIM + 1], S g[DIM + 1][DIM], C rho, C visc,
    const C src[DIM], typename Passive<S>::type h,
    typename Passive<S>::type tau_dt2, bool pspg, bool supg,
    S out[(DIM + 1) * (DIM + 1)], S buoy = S()) {
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
    if constexpr (BUOY) out[i] = out[i] + buoy * src[i];
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
    C a;
    S b, tau;
    if constexpr (RECIP) {
      a = visc * (T(4) / (h * h));
      b = nvel * (T(2) / h);
      tau = drsqrt((b * b + a * a) + tau_dt2);
    } else {
      a = T(4) * visc / (h * h);
      b = T(2) * nvel / h;
      tau = T(1) / dsqrt((b * b + a * a) + tau_dt2);
    }
    S stab[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      S s = rho * conv[i] + g[DIM][i];
      if constexpr (TR) s = (rho * ud[i] + rho * conv[i]) + g[DIM][i];
      stab[i] = s - rho * src[i];
      if constexpr (BUOY) stab[i] = stab[i] + buoy * src[i];
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
      if constexpr (RECIP) {
        const C ir = T(1) / rho;
#pragma unroll
        for (int d = 0; d < DIM; ++d) fpr[d] = tau * stab[d] * ir;
      } else {
#pragma unroll
        for (int d = 0; d < DIM; ++d) fpr[d] = tau * stab[d] / rho;
      }
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
