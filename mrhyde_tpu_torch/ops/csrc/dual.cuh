// Forward-mode dual numbers for the weak forms of the port's kernels
// (fused_p1_ns.cu, fused_elem_ns.cu, set_node.cuh): Dual<T, N> carries a
// value and N tangents, and each operator is the chain rule of its
// operation, so a weak form written once over its scalar type gives on T
// the residual's densities and on Dual<T, N> their directional
// derivatives (the Sacado SFad analog the reference MrHyDE uses).
// Passive<S>::type is the plain type under S; value(), dsqrt() and
// drsqrt() take either, and lift<S>() makes a plain value an S (no
// tangent).
//
// The ad_* functions are the function DSL's (mrhyde_tpu_torch/functions/
// parser.py) on T and on duals, for the coefficient expressions that
// functions/codegen.py generates: sin cos tan exp log sqrt abs sinh cosh
// tanh, pow (the DSL's ^), min max atan2, and the comparisons < > (1 or
// 0, no tangent). Their rules are the JAX package's sparse forward AD's
// (mrhyde_tpu/ops/sparse_fwd.py), its conventions at kinks included: abs
// takes sign(x), 0 at 0; max and min take the first argument at a tie.
// A kernel differentiates along one column direction, so a tangent that
// is exactly 0 stands for an input that does not depend on the column:
// the nonlinear rules pass it on as 0 (tan_mul) where sparse AD has no
// entry at all, and an infinite derivative (sqrt or log at 0) reaches
// only the columns that move its argument, as in JAX.

#pragma once

namespace {

template <typename T, int N>
struct Dual {
  using scalar = T;
  T v;
  T d[N];
};

template <typename T>
struct Passive {
  using type = T;
};
template <typename T, int N>
struct Passive<Dual<T, N>> {
  using type = T;
};

template <typename T>
__device__ __forceinline__ T value(T x) {
  return x;
}
template <typename T, int N>
__device__ __forceinline__ T value(const Dual<T, N>& x) {
  return x.v;
}

template <typename T>
__device__ __forceinline__ T dsqrt(T x) {
  return sqrt(x);
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> dsqrt(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = sqrt(a.v);
  const T c = T(0.5) / r.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = c * a.d[i];
  return r;
}

// 1 / sqrt(x): a square root and one division, where 1 / dsqrt(x) takes a
// square root and three divisions on a dual (the dual form is below,
// after tan_mul). Its derivative -r^3 / 2 is infinite at 0; as in the JAX
// package's sparse forward AD it reaches only the tangents that move x (a
// zero tangent stays 0).
template <typename T>
__device__ __forceinline__ T drsqrt(T x) {
  return T(1) / sqrt(x);
}

#define SCAL(T, N) typename Dual<T, N>::scalar

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a,
                                                SCAL(T, N) b) {
  Dual<T, N> r = a;
  r.v = a.v + b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(SCAL(T, N) a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r = b;
  r.v = a + b.v;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a,
                                                SCAL(T, N) b) {
  Dual<T, N> r = a;
  r.v = a.v - b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a,
                                                SCAL(T, N) b) {
  Dual<T, N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(SCAL(T, N) a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a * b.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a,
                                                SCAL(T, N) b) {
  Dual<T, N> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(SCAL(T, N) a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a / b.v;
  const T c = -a / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = c * b.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(SCAL(T, N) a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -b.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
  const T bb = b.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / b.v + (-a.v * b.d[i]) / bb;
  return r;
}

// ---------------------------------------------------------------------
// lift, and the function DSL on T and on duals
// ---------------------------------------------------------------------

template <typename S>
struct Lift {
  __device__ __forceinline__ static S of(S x) { return x; }
};
template <typename T, int N>
struct Lift<Dual<T, N>> {
  __device__ __forceinline__ static Dual<T, N> of(const Dual<T, N>& x) {
    return x;
  }
  __device__ __forceinline__ static Dual<T, N> of(T x) {
    Dual<T, N> r;
    r.v = x;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = T(0);
    return r;
  }
};
template <typename S, typename X>
__device__ __forceinline__ S lift(const X& x) {
  return Lift<S>::of(x);
}

// c * t, 0 where the tangent t is 0 (no dependence on the column)
template <typename T>
__device__ __forceinline__ T tan_mul(T c, T t) {
  return t == T(0) ? T(0) : c * t;
}

// drsqrt on a dual
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> drsqrt(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = T(1) / sqrt(a.v);
  const T c = T(-0.5) * (r.v * r.v) * r.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = tan_mul(c, a.d[i]);
  return r;
}

template <typename T>
__device__ __forceinline__ T sign_of(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// unary functions: value fn(x) and derivative D(x, o) of o = fn(x)
#define AD_UNARY(NAME, FN, DERIV)                                       \
  __device__ __forceinline__ double NAME(double x) { return FN(x); }   \
  __device__ __forceinline__ float NAME(float x) { return FN(x); }     \
  template <typename T, int N>                                          \
  __device__ __forceinline__ Dual<T, N> NAME(const Dual<T, N>& a) {     \
    Dual<T, N> r;                                                       \
    const T x = a.v;                                                    \
    r.v = FN(x);                                                        \
    const T o = r.v;                                                    \
    const T c = (DERIV);                                                \
    (void)o;                                                            \
    for (int i = 0; i < N; ++i) r.d[i] = tan_mul(c, a.d[i]);            \
    return r;                                                           \
  }

AD_UNARY(ad_sin, sin, cos(x))
AD_UNARY(ad_cos, cos, -sin(x))
AD_UNARY(ad_tan, tan, T(1) + o * o)
AD_UNARY(ad_exp, exp, o)
AD_UNARY(ad_log, log, T(1) / x)
AD_UNARY(ad_sqrt, sqrt, T(0.5) / sqrt(x))
AD_UNARY(ad_abs, fabs, sign_of(x))
AD_UNARY(ad_sinh, sinh, cosh(x))
AD_UNARY(ad_cosh, cosh, sinh(x))
AD_UNARY(ad_tanh, tanh, T(1) - o * o)
#undef AD_UNARY

// x ^ y: y x^(y-1) on x's tangent, o log(x) on y's
__device__ __forceinline__ double ad_pow(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float ad_pow(float x, float y) { return pow(x, y); }
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> ad_pow(const Dual<T, N>& a,
                                             SCAL(T, N) y) {
  Dual<T, N> r;
  r.v = pow(a.v, y);
  const T c = y * pow(a.v, y - T(1));
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = tan_mul(c, a.d[i]);
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> ad_pow(SCAL(T, N) x,
                                             const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = pow(x, b.v);
  const T c = r.v * log(x);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = tan_mul(c, b.d[i]);
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> ad_pow(const Dual<T, N>& a,
                                             const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = pow(a.v, b.v);
  const T cx = b.v * pow(a.v, b.v - T(1)), cy = r.v * log(a.v);
#pragma unroll
  for (int i = 0; i < N; ++i)
    r.d[i] = tan_mul(cx, a.d[i]) + tan_mul(cy, b.d[i]);
  return r;
}

// atan2(x, y): y tx / r2 - x ty / r2, r2 = x^2 + y^2
__device__ __forceinline__ double ad_atan2(double x, double y) {
  return atan2(x, y);
}
__device__ __forceinline__ float ad_atan2(float x, float y) {
  return atan2(x, y);
}
template <typename A, typename B>
__device__ __forceinline__ auto ad_atan2(const A& a, const B& b) {
  using T = decltype(value(a));
  using D = decltype(a + b);
  const T x = value(a), y = value(b), r2 = x * x + y * y;
  const D da = lift<D>(a), db = lift<D>(b);
  D r;
  r.v = atan2(x, y);
  for (int i = 0; i < (int)(sizeof(r.d) / sizeof(T)); ++i)
    r.d[i] = y * da.d[i] / r2 + (-x * db.d[i]) / r2;
  return r;
}

// max / min: the picked argument's value and tangent (the first at a tie)
template <typename A, typename B>
__device__ __forceinline__ auto ad_max(const A& a, const B& b) {
  using D = decltype(a + b);
  return value(a) >= value(b) ? lift<D>(a) : lift<D>(b);
}
template <typename A, typename B>
__device__ __forceinline__ auto ad_min(const A& a, const B& b) {
  using D = decltype(a + b);
  return value(a) <= value(b) ? lift<D>(a) : lift<D>(b);
}

// the comparisons: 1 where they hold, else 0, without a tangent
template <typename A, typename B>
__device__ __forceinline__ auto ad_lt(const A& a, const B& b) {
  using T = decltype(value(a));
  return value(a) < value(b) ? T(1) : T(0);
}
template <typename A, typename B>
__device__ __forceinline__ auto ad_gt(const A& a, const B& b) {
  using T = decltype(value(a));
  return value(a) > value(b) ? T(1) : T(0);
}

}  // namespace
