// Forward-mode dual numbers for the weak forms of the port's kernels
// (fused_p1_ns.cu, fused_elem_ns.cu): Dual<T, N> carries a value and N
// tangents, and each operator is the chain rule of its operation, so a
// weak form written once over its scalar type gives on T the residual's
// densities and on Dual<T, N> their directional derivatives (the Sacado
// SFad analog the reference MrHyDE uses). Passive<S>::type is the plain
// type under S; value() and dsqrt() take either.

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

}  // namespace
