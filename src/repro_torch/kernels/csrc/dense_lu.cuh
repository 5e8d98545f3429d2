// Unpivoted blocked right-looking dense LU for Hopper (sm_90a), shared by
// K2 (dense_lu.cu: real tiles) and K3 (dense_lu_planar.cu: complex tiles
// held as re/im planes).  The kernels are written once over a value-ops
// type: RealOps<T> keeps K2's arithmetic, PlanarOps<T> reads an element as
// the pair (re plane, im plane) and does the complex arithmetic on reals.
//
// Computes the in-place LU of a dense (N, N) row-major tile, with L
// strictly below the diagonal (unit diagonal implied) and U on and above
// it.  No pivoting: the GLU flow makes the pivots safe with MC64 scaling.
//
// The TPU holds the whole tile in VMEM.  On Hopper a 256 x 256 float64 tile
// is already 512 KB, more than a CTA's 227 KB of shared memory, so the tile
// stays in global memory (it fits in the 50 MB L2) and every block step of
// width kB is three launches on the caller's stream:
//
//   1. diag_kernel   one CTA factors the kB x kB diagonal block A11 in
//                    shared memory (unblocked right-looking);
//   2. solve_kernel  both off-diagonal panels at once: each thread of the
//                    first CTAs solves one row of L21 = A21 U11^-1, each
//                    thread of the others one column of U12 = L11^-1 A12;
//   3. update_kernel the trailing update A22 -= L21 @ U12 with TILE x TILE
//                    output tiles, operands staged in shared memory, plain
//                    FMA in the value type (no tensor cores, so float32
//                    never drops to TF32).
//
// A complex element is two values, so the planar update stages half the
// real tile's side (32 instead of 64) to keep both operand tiles in the
// 48 KB of static shared memory and its accumulators in registers.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kB = 32;             // block width
constexpr int kSolveThreads = 128;
constexpr int kTileThreads = 16;   // update CTA is kTileThreads^2 threads

__device__ inline float fmadd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ inline double fmadd(double a, double b, double c) { return fma(a, b, c); }

// Real values: the element at flat offset i is a[i].
template <typename T>
struct RealOps {
  using Scalar = T;
  using V = T;
  __device__ static V load(const T* a, long long i, long long) { return a[i]; }
  __device__ static void store(T* a, long long i, long long, V v) { a[i] = v; }
  __device__ static V zero() { return T(0); }
  __device__ static V div(V c, V p) { return c / p; }
  // m - l * u
  __device__ static V sub_mul(V m, V l, V u) { return m - l * u; }
  // acc + l * u
  __device__ static V mac(V acc, V l, V u) { return acc + l * u; }
  __device__ static V sub(V a, V b) { return a - b; }
};

// Complex values held as two planes: the element at flat offset i is
// (a[i], a[plane + i]), plane = N * N.  The pivot reciprocal is
// conj(p) / (re^2 + im^2) and the complex MAC four real FMAs and a sign,
// as in the JAX package's planar kernel.
template <typename T>
struct PlanarOps {
  using Scalar = T;
  struct V {
    T re, im;
  };
  __device__ static V load(const T* a, long long i, long long plane) {
    return V{a[i], a[plane + i]};
  }
  __device__ static void store(T* a, long long i, long long plane, V v) {
    a[i] = v.re;
    a[plane + i] = v.im;
  }
  __device__ static V zero() { return V{T(0), T(0)}; }
  __device__ static V div(V c, V p) {
    const T inv = T(1) / (p.re * p.re + p.im * p.im);
    return V{(c.re * p.re + c.im * p.im) * inv, (c.im * p.re - c.re * p.im) * inv};
  }
  __device__ static V sub_mul(V m, V l, V u) {
    return V{m.re - (l.re * u.re - l.im * u.im), m.im - (l.re * u.im + l.im * u.re)};
  }
  __device__ static V mac(V acc, V l, V u) {
    T re = fmadd(l.re, u.re, acc.re);
    re = fmadd(-l.im, u.im, re);
    T im = fmadd(l.re, u.im, acc.im);
    im = fmadd(l.im, u.re, im);
    return V{re, im};
  }
  __device__ static V sub(V a, V b) { return V{a.re - b.re, a.im - b.im}; }
};

template <typename Ops>
__global__ void __launch_bounds__(256)
diag_kernel(typename Ops::Scalar* __restrict__ a, int N, int k0) {
  using V = typename Ops::V;
  __shared__ V s[kB][kB + 1];
  const long long plane = static_cast<long long>(N) * N;
  const long long base = static_cast<long long>(k0) * N + k0;
  for (int e = threadIdx.x; e < kB * kB; e += blockDim.x) {
    s[e / kB][e % kB] = Ops::load(a, base + static_cast<long long>(e / kB) * N + e % kB, plane);
  }
  __syncthreads();
  for (int j = 0; j < kB - 1; ++j) {
    const V piv = s[j][j];
    for (int i = j + 1 + threadIdx.x; i < kB; i += blockDim.x) s[i][j] = Ops::div(s[i][j], piv);
    __syncthreads();
    const int w = kB - 1 - j;  // rows and columns left of the rank-1 update
    for (int e = threadIdx.x; e < w * w; e += blockDim.x) {
      const int i = j + 1 + e / w;
      const int c = j + 1 + e % w;
      s[i][c] = Ops::sub_mul(s[i][c], s[i][j], s[j][c]);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kB * kB; e += blockDim.x) {
    Ops::store(a, base + static_cast<long long>(e / kB) * N + e % kB, plane, s[e / kB][e % kB]);
  }
}

// Blocks [0, row_blocks) solve rows of L21, the rest columns of U12; both
// panels start at index k1 = k0 + kB and run to N.
template <typename Ops>
__global__ void __launch_bounds__(kSolveThreads)
solve_kernel(typename Ops::Scalar* __restrict__ a, int N, int k0, int row_blocks) {
  using V = typename Ops::V;
  __shared__ V s[kB][kB + 1];  // factored A11: L11 below, U11 on and above
  const long long plane = static_cast<long long>(N) * N;
  const long long base = static_cast<long long>(k0) * N + k0;
  for (int e = threadIdx.x; e < kB * kB; e += blockDim.x) {
    s[e / kB][e % kB] = Ops::load(a, base + static_cast<long long>(e / kB) * N + e % kB, plane);
  }
  __syncthreads();
  const int k1 = k0 + kB;
  V x[kB];
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int g = k1 + blockIdx.x * kSolveThreads + threadIdx.x;
    if (g >= N) return;
    const long long row = static_cast<long long>(g) * N + k0;
    // x U11 = a_row: the panel's right-looking steps in the same order
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      V v = Ops::load(a, row + c, plane);
#pragma unroll
      for (int t = 0; t < c; ++t) v = Ops::sub_mul(v, x[t], s[t][c]);
      x[c] = Ops::div(v, s[c][c]);
    }
#pragma unroll
    for (int c = 0; c < kB; ++c) Ops::store(a, row + c, plane, x[c]);
  } else {
    const int c = k1 + (blockIdx.x - row_blocks) * kSolveThreads + threadIdx.x;
    if (c >= N) return;
    const long long col = static_cast<long long>(k0) * N + c;
    // L11 x = a_col (unit lower): forward substitution down the block rows
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      V acc = Ops::zero();
#pragma unroll
      for (int t = 0; t < i; ++t) acc = Ops::mac(acc, s[i][t], x[t]);
      x[i] = Ops::sub(Ops::load(a, col + static_cast<long long>(i) * N, plane), acc);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) Ops::store(a, col + static_cast<long long>(i) * N, plane, x[i]);
  }
}

template <typename Ops, int TILE>
__global__ void __launch_bounds__(kTileThreads * kTileThreads)
update_kernel(typename Ops::Scalar* __restrict__ a, int N, int k0) {
  using V = typename Ops::V;
  constexpr int kPer = TILE / kTileThreads;  // outputs per thread and axis
  __shared__ V s_l[TILE][kB + 1];  // L21 rows of this tile
  __shared__ V s_u[kB][TILE + 1];  // U12 columns of this tile
  const long long plane = static_cast<long long>(N) * N;
  const int k1 = k0 + kB;
  const int row0 = k1 + blockIdx.y * TILE;
  const int col0 = k1 + blockIdx.x * TILE;
  const int tid = threadIdx.y * kTileThreads + threadIdx.x;
  constexpr int kThreads = kTileThreads * kTileThreads;
  for (int e = tid; e < TILE * kB; e += kThreads) {
    const int r = e / kB, t = e % kB;
    const int g = row0 + r;
    s_l[r][t] = g < N ? Ops::load(a, static_cast<long long>(g) * N + k0 + t, plane) : Ops::zero();
  }
  for (int e = tid; e < kB * TILE; e += kThreads) {
    const int t = e / TILE, c = e % TILE;
    const int g = col0 + c;
    s_u[t][c] = g < N ? Ops::load(a, static_cast<long long>(k0 + t) * N + g, plane) : Ops::zero();
  }
  __syncthreads();
  V acc[kPer][kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p)
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc[p][q] = Ops::zero();
#pragma unroll 8
  for (int t = 0; t < kB; ++t) {
    V l[kPer], u[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) l[p] = s_l[threadIdx.y + kTileThreads * p][t];
#pragma unroll
    for (int q = 0; q < kPer; ++q) u[q] = s_u[t][threadIdx.x + kTileThreads * q];
#pragma unroll
    for (int p = 0; p < kPer; ++p)
#pragma unroll
      for (int q = 0; q < kPer; ++q) acc[p][q] = Ops::mac(acc[p][q], l[p], u[q]);
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int g = row0 + threadIdx.y + kTileThreads * p;
    if (g >= N) continue;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int c = col0 + threadIdx.x + kTileThreads * q;
      if (c < N) {
        const long long i = static_cast<long long>(g) * N + c;
        Ops::store(a, i, plane, Ops::sub(Ops::load(a, i, plane), acc[p][q]));
      }
    }
  }
}

// All launches of one LU on `stream`; returns the first launch error.
template <typename Ops, int TILE>
int dense_lu(void* a_ptr, int N, void* stream_ptr) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (N % kB != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* a = static_cast<typename Ops::Scalar*>(a_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (int k0 = 0; k0 < N; k0 += kB) {
    diag_kernel<Ops><<<1, 256, 0, stream>>>(a, N, k0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rest = N - (k0 + kB);
    if (rest <= 0) break;
    const int blocks = (rest + kSolveThreads - 1) / kSolveThreads;
    solve_kernel<Ops><<<2 * blocks, kSolveThreads, 0, stream>>>(a, N, k0, blocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (rest + TILE - 1) / TILE;
    update_kernel<Ops, TILE><<<dim3(tiles, tiles), dim3(kTileThreads, kTileThreads), 0, stream>>>(
        a, N, k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace
