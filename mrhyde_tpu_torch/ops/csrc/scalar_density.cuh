// The qp weak forms of thermal and cdr for the module-set kernels
// (set_node.cuh on 2D p1 quads, set_elem.cuh on hex and p2 quads): the
// JAX package's `qp_density` of mrhyde_tpu/physics/thermal.py and cdr.py,
// in their order of operations, written once over the state's type S (a
// plain T or a Dual<T, N> of dual.cuh), in 2D (thermal_density,
// cdr_density) and 3D (thermal_density_3d, cdr_density_3d). Each
// coefficient has its own type (T where its expression reads no state, S
// where it does), so a velocity that reads the state differentiates with
// the rest:
//   thermal: S_e = rho cp e_t - f [+ b . grad e],  F_e = kappa grad e;
//   cdr:     S_c = c_t + b . grad c + reaction - source,
//            F_c = diffusion / (rho cp) grad c.
// out = {S, F_0, F_1[, F_2]}. A steady call passes u_dot = 0.
// The 2D functions are kept apart from the 3D ones, not merged into one
// template on the dimension: ptxas may fuse a multiply and an add into
// one fma, and its choices follow the code around them, so a merged
// template changed the last bits of set_node_full's 2D kernels.

#pragma once

#include "dual.cuh"

namespace {

template <bool ADV, typename S, typename R, typename P, typename F,
          typename K, typename B0, typename B1>
__device__ __forceinline__ void thermal_density(
    const S& u, const S& ud, const S g[2], const R& rho, const P& cp,
    const F& f, const K& kappa, const B0& b0, const B1& b1, S out[3]) {
  (void)u;
  S s = lift<S>((rho * cp) * ud - f);
  if constexpr (ADV) {
    s = s + b0 * g[0];
    s = s + b1 * g[1];
  }
  out[0] = s;
  out[1] = lift<S>(kappa * g[0]);
  out[2] = lift<S>(kappa * g[1]);
}

template <typename S, typename D, typename R, typename P, typename X,
          typename F, typename B0, typename B1>
__device__ __forceinline__ void cdr_density(
    const S& u, const S& ud, const S g[2], const D& diff, const R& rho,
    const P& cp, const X& reaction, const F& f, const B0& b0, const B1& b1,
    S out[3]) {
  (void)u;
  const S adv = lift<S>(b0 * g[0] + b1 * g[1]);
  out[0] = lift<S>(((ud + adv) + reaction) - f);
  const auto dcoef = diff / (rho * cp);
  out[1] = lift<S>(dcoef * g[0]);
  out[2] = lift<S>(dcoef * g[1]);
}

template <bool ADV, typename S, typename R, typename P, typename F,
          typename K, typename B0, typename B1, typename B2>
__device__ __forceinline__ void thermal_density_3d(
    const S& u, const S& ud, const S g[3], const R& rho, const P& cp,
    const F& f, const K& kappa, const B0& b0, const B1& b1, const B2& b2,
    S out[4]) {
  (void)u;
  S s = lift<S>((rho * cp) * ud - f);
  if constexpr (ADV) {
    s = s + b0 * g[0];
    s = s + b1 * g[1];
    s = s + b2 * g[2];
  }
  out[0] = s;
  out[1] = lift<S>(kappa * g[0]);
  out[2] = lift<S>(kappa * g[1]);
  out[3] = lift<S>(kappa * g[2]);
}

template <typename S, typename D, typename R, typename P, typename X,
          typename F, typename B0, typename B1, typename B2>
__device__ __forceinline__ void cdr_density_3d(
    const S& u, const S& ud, const S g[3], const D& diff, const R& rho,
    const P& cp, const X& reaction, const F& f, const B0& b0, const B1& b1,
    const B2& b2, S out[4]) {
  (void)u;
  const S adv = lift<S>(b0 * g[0] + b1 * g[1] + b2 * g[2]);
  out[0] = lift<S>(((ud + adv) + reaction) - f);
  const auto dcoef = diff / (rho * cp);
  out[1] = lift<S>(dcoef * g[0]);
  out[2] = lift<S>(dcoef * g[1]);
  out[3] = lift<S>(dcoef * g[2]);
}

}  // namespace
