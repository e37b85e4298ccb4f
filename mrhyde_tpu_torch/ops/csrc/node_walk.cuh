// The tile walk of the B2 node kernels on uniform 2D p1 quads, for Hopper
// (sm_90a): a persistent grid of blocks walks tiles of elements of an
// N0 x N1 element grid; each element's quadrature runs once, into its four
// corner rows, and each node sums the rows of its (up to) four elements,
// corner 0..3 in order, as the plain pad+sum version sums them. Two files
// include it: fused_p1_thermal.cu (thermal_node_state, and the residual
// phase of thermal_node_full: one grid) and set_node.cuh (set_node_state:
// the NV grids of a module set).
//
// A tile is EI x EJ elements (axis 0 x axis 1, axis 1 contiguous), EI EJ /
// THREADS per thread, and the (EI - 1) x (EJ - 1) nodes whose four
// elements it holds; the elements read the tile's (EI + 1) x (EJ + 1) node
// patch of each grid: the tile's nodes and a halo of one node on each
// side. Block b walks tiles b, b + gridDim.x, ... (a 1D index, 32-bit tile
// math). Per tile: the next tile's patches load into registers while the
// tile's elements compute their rows from the staged patches (zeros for
// an element outside the mesh); the next patches go to the other buffer;
// one barrier; each node thread sums its elements' rows. Patches and rows
// are double-buffered, so a tile takes one barrier. An element on a
// tile's border is computed by both tiles that touch it.

#pragma once

#include <cuda_runtime.h>

namespace {

// local corner c -> offset on axis 0 / axis 1: corners (0,0), (1,0),
// (1,1), (0,1)
__device__ __forceinline__ int corner_i(int c) { return (c == 1 || c == 2); }
__device__ __forceinline__ int corner_j(int c) { return (c >= 2); }

template <int EI, int EJ, int THREADS>
struct WalkTile {
  static constexpr int kThreads = THREADS;
  static constexpr int kEi = EI, kEj = EJ;
  static constexpr int kTileElems = EI * EJ;
  static constexpr int kElemsPerThread = kTileElems / THREADS;
  static constexpr int kTi = EI - 1, kTj = EJ - 1;
  static constexpr int kPi = EI + 1, kPj = EJ + 1;
  static constexpr int kPatch = kPi * kPj;
  static constexpr int kPre = (kPatch + THREADS - 1) / THREADS;
  static_assert(kElemsPerThread * THREADS == kTileElems &&
                    EI % kElemsPerThread == 0,
                "whole rows of elements per thread");
  // the walk's shared memory for NV grids, in T: two patches of each grid
  // and two sets of the tile's elements' four corner rows of each grid
  __host__ __device__ static constexpr long long words(int nv) {
    return 2LL * nv * kPatch + 2LL * nv * 4 * kTileElems;
  }
};

// patch entry k of the tile whose node (0, 0) is (i0, j0): node (i0 - 1 +
// k / kPj, j0 - 1 + k % kPj), 0 outside the grid
template <class W, typename T>
__device__ __forceinline__ T patch_node(const T* __restrict__ u, int i0,
                                        int j0, int N0, int N1, int k) {
  const int pi = k / W::kPj, pj = k - pi * W::kPj;
  const int i = i0 - 1 + pi, j = j0 - 1 + pj;
  return (i >= 0 && i <= N0 && j >= 0 && j <= N1)
             ? __ldg(u + (long long)i * (N1 + 1) + j)
             : T(0);
}

// The walk over NV grids, `nodes` values apart (grid v at u + v nodes, its
// sums at out + v nodes). Each thread hands each of its kElemsPerThread
// elements inside the mesh to `element(la, lb, a, b, uc, r)` (its tile
// position, its mesh position, its corner values from the patches: uc[v 4
// + c], corner c of grid v; r its rows, r[v 4 + c] zero on entry), UNROLL
// at once; the rows of an element outside the mesh are zeros. Row c of
// grid v of element (i0 - 1 + la, j0 - 1 + lb) lies at rows[((buf NV + v)
// 4 + c) kTileElems + la kEj + lb], buf the tile's buffer (patches
// likewise). The block's tables are in shared memory before the walk's
// first barrier.
template <typename T, class W, int NV, int UNROLL, class Element>
__device__ __forceinline__ void node_walk(const T* __restrict__ u,
                                          const long long nodes,
                                          const int N0, const int N1,
                                          const int tiles_j, const int tiles,
                                          T* patches, T* rows,
                                          T* __restrict__ out,
                                          Element&& element) {
  constexpr int kEi = W::kEi, kEj = W::kEj, kTileElems = W::kTileElems;
  constexpr int kPatch = W::kPatch, kPj = W::kPj, kPre = W::kPre;
  constexpr int kThreads = W::kThreads, kEl = W::kElemsPerThread;
  const int tid = threadIdx.x, G1 = N1 + 1;
  // this thread's elements (i0 - 1 + la, j0 - 1 + lb), la = la0 + r kEi /
  // kElemsPerThread
  const int la0 = tid / kEj, lb = tid - la0 * kEj;
  int t = blockIdx.x, ti = t / tiles_j;
  int i0 = ti * W::kTi, j0 = (t - ti * tiles_j) * W::kTj;
#pragma unroll
  for (int v = 0; v < NV; ++v)
    for (int k = tid; k < kPatch; k += kThreads)
      patches[v * kPatch + k] =
          patch_node<W>(u + v * nodes, i0, j0, N0, N1, k);
  __syncthreads();
  for (int cur = 0; t < tiles; cur ^= 1) {
    // the next tile's patches, in flight while this tile's elements compute
    const int tn = t + gridDim.x, tin = tn / tiles_j;
    const int i0n = tin * W::kTi, j0n = (tn - tin * tiles_j) * W::kTj;
    T pre[NV][kPre];
    if (tn < tiles)
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int p = 0; p < kPre; ++p)
          if (tid + p * kThreads < kPatch)
            pre[v][p] = patch_node<W>(u + v * nodes, i0n, j0n, N0, N1,
                                      tid + p * kThreads);
    const T* patch = patches + cur * NV * kPatch;
    T* rw = rows + cur * NV * 4 * kTileElems;
#pragma unroll(UNROLL)
    for (int rr = 0; rr < kEl; ++rr) {
      const int la = la0 + rr * (kEi / kEl);
      const int a = i0 - 1 + la, b = j0 - 1 + lb;
      T r[4 * NV];
#pragma unroll
      for (int k = 0; k < 4 * NV; ++k) r[k] = T(0);
      if (a >= 0 && a < N0 && b >= 0 && b < N1) {
        T uc[4 * NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const T* pe = patch + v * kPatch + la * kPj + lb;
          uc[4 * v + 0] = pe[0];
          uc[4 * v + 1] = pe[kPj];
          uc[4 * v + 2] = pe[kPj + 1];
          uc[4 * v + 3] = pe[1];
        }
        element(la, lb, a, b, uc, r);
      }
      // an element outside the mesh adds zeros
#pragma unroll
      for (int k = 0; k < 4 * NV; ++k)
        rw[k * kTileElems + la * kEj + lb] = r[k];
    }
    // the other buffer's patches were last read before the last barrier
    if (tn < tiles)
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int p = 0; p < kPre; ++p)
          if (tid + p * kThreads < kPatch)
            patches[((cur ^ 1) * NV + v) * kPatch + tid + p * kThreads] =
                pre[v][p];
    __syncthreads();
    // node (i, j) is corner c of element (i - ci, j - cj), local (li + 1 -
    // ci, lj + 1 - cj): the sum corner 0..3, as the plain pad+sum sums
    for (int k = tid; k < W::kTi * W::kTj; k += kThreads) {
      const int li = k / W::kTj, lj = k - li * W::kTj;
      const int i = i0 + li, j = j0 + lj;
      if (i > N0 || j > N1) continue;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const T* pr = rw + 4 * v * kTileElems + (li + 1) * kEj + lj + 1;
        T acc = pr[0];
        acc += pr[kTileElems - kEj];
        acc += pr[2 * kTileElems - kEj - 1];
        acc += pr[3 * kTileElems - 1];
        out[v * nodes + (long long)i * G1 + j] = acc;
      }
    }
    t = tn;
    i0 = i0n;
    j0 = j0n;
  }
}

// the walk's tiles of an N0 x N1 element grid (tiles_j per tile row), and
// its persistent grid: as many blocks as the card holds, at most one per
// tile; false where the tile count passes 32-bit tile math
template <class W>
inline bool walk_grid(int N0, int N1, int resident, int& tiles_j,
                      int& tiles, int& blocks) {
  tiles_j = (N1 + W::kTj) / W::kTj;  // ceil((N1 + 1) / kTj)
  const long long n = (long long)((N0 + W::kTi) / W::kTi) * tiles_j;
  if (n >= (1LL << 31)) return false;
  tiles = (int)n;
  blocks = tiles < resident ? tiles : resident;
  return true;
}

}  // namespace
