// K2: unpivoted blocked right-looking dense LU for Hopper (sm_90a).
//
// Replaces the TPU kernel dense_lu of the JAX package (kernels/dense_lu.py,
// body _lu_kernel with _panel_factor and _trsm_rows, pallas_call at
// dense_lu.py:98): the in-place LU of a dense (N, N) row-major tile, with L
// strictly below the diagonal (unit diagonal implied) and U on and above it.
// No pivoting: the GLU flow makes the pivots safe with MC64 scaling.
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
//   3. update_kernel the trailing update A22 -= L21 @ U12 with 64 x 64
//                    output tiles, operands staged in shared memory, plain
//                    FMA in the value type (no tensor cores, so float32
//                    never drops to TF32).
//
// Bound: 2N^3/3 operations against the card's float64 rate, or 2 N^2 values
// moved, whichever is larger; at the slice's N (256 to 1024) both are a few
// microseconds at most, and the 3 N / kB launches dominate.  A persistent
// single-launch version with DMMA for the update is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kB = 32;        // block width
constexpr int kSolveThreads = 128;
constexpr int kTile = 64;     // update output tile (kTile x kTile)
constexpr int kTileThreads = 16;  // update CTA is kTileThreads^2 threads, 4x4 outputs each

template <typename T>
__global__ void __launch_bounds__(256) diag_kernel(T* __restrict__ a, int N, int k0) {
  __shared__ T s[kB][kB + 1];
  T* blk = a + static_cast<long long>(k0) * N + k0;
  for (int e = threadIdx.x; e < kB * kB; e += blockDim.x) {
    s[e / kB][e % kB] = blk[static_cast<long long>(e / kB) * N + e % kB];
  }
  __syncthreads();
  for (int j = 0; j < kB - 1; ++j) {
    const T piv = s[j][j];
    for (int i = j + 1 + threadIdx.x; i < kB; i += blockDim.x) s[i][j] = s[i][j] / piv;
    __syncthreads();
    const int w = kB - 1 - j;  // rows and columns left of the rank-1 update
    for (int e = threadIdx.x; e < w * w; e += blockDim.x) {
      const int i = j + 1 + e / w;
      const int c = j + 1 + e % w;
      s[i][c] = s[i][c] - s[i][j] * s[j][c];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kB * kB; e += blockDim.x) {
    blk[static_cast<long long>(e / kB) * N + e % kB] = s[e / kB][e % kB];
  }
}

// Blocks [0, row_blocks) solve rows of L21, the rest columns of U12; both
// panels start at index k1 = k0 + kB and run to N.
template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
solve_kernel(T* __restrict__ a, int N, int k0, int row_blocks) {
  __shared__ T s[kB][kB + 1];  // factored A11: L11 below, U11 on and above
  const T* blk = a + static_cast<long long>(k0) * N + k0;
  for (int e = threadIdx.x; e < kB * kB; e += blockDim.x) {
    s[e / kB][e % kB] = blk[static_cast<long long>(e / kB) * N + e % kB];
  }
  __syncthreads();
  const int k1 = k0 + kB;
  T x[kB];
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int g = k1 + blockIdx.x * kSolveThreads + threadIdx.x;
    if (g >= N) return;
    T* row = a + static_cast<long long>(g) * N + k0;
    // x U11 = a_row: the panel's right-looking steps in the same order
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      T v = row[c];
#pragma unroll
      for (int t = 0; t < c; ++t) v = v - x[t] * s[t][c];
      x[c] = v / s[c][c];
    }
#pragma unroll
    for (int c = 0; c < kB; ++c) row[c] = x[c];
  } else {
    const int c = k1 + (blockIdx.x - row_blocks) * kSolveThreads + threadIdx.x;
    if (c >= N) return;
    T* col = a + static_cast<long long>(k0) * N + c;
    // L11 x = a_col (unit lower): forward substitution down the block rows
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      T acc = T(0);
#pragma unroll
      for (int t = 0; t < i; ++t) acc = acc + s[i][t] * x[t];
      x[i] = col[static_cast<long long>(i) * N] - acc;
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) col[static_cast<long long>(i) * N] = x[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads * kTileThreads)
update_kernel(T* __restrict__ a, int N, int k0) {
  __shared__ T s_l[kTile][kB + 1];  // L21 rows of this tile
  __shared__ T s_u[kB][kTile + 1];  // U12 columns of this tile
  const int k1 = k0 + kB;
  const int row0 = k1 + blockIdx.y * kTile;
  const int col0 = k1 + blockIdx.x * kTile;
  const int tid = threadIdx.y * kTileThreads + threadIdx.x;
  constexpr int kThreads = kTileThreads * kTileThreads;
  for (int e = tid; e < kTile * kB; e += kThreads) {
    const int r = e / kB, t = e % kB;
    const int g = row0 + r;
    s_l[r][t] = g < N ? a[static_cast<long long>(g) * N + k0 + t] : T(0);
  }
  for (int e = tid; e < kB * kTile; e += kThreads) {
    const int t = e / kTile, c = e % kTile;
    const int g = col0 + c;
    s_u[t][c] = g < N ? a[static_cast<long long>(k0 + t) * N + g] : T(0);
  }
  __syncthreads();
  T acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = T(0);
#pragma unroll 8
  for (int t = 0; t < kB; ++t) {
    T l[4], u[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) l[p] = s_l[threadIdx.y + kTileThreads * p][t];
#pragma unroll
    for (int q = 0; q < 4; ++q) u[q] = s_u[t][threadIdx.x + kTileThreads * q];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = acc[p][q] + l[p] * u[q];
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int g = row0 + threadIdx.y + kTileThreads * p;
    if (g >= N) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = col0 + threadIdx.x + kTileThreads * q;
      if (c < N) {
        T* dst = a + static_cast<long long>(g) * N + c;
        *dst = *dst - acc[p][q];
      }
    }
  }
}

template <typename T>
int dense_lu(void* a_ptr, int N, void* stream_ptr) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (N % kB != 0) return static_cast<int>(cudaErrorInvalidValue);
  T* a = static_cast<T*>(a_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (int k0 = 0; k0 < N; k0 += kB) {
    diag_kernel<T><<<1, 256, 0, stream>>>(a, N, k0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rest = N - (k0 + kB);
    if (rest <= 0) break;
    const int blocks = (rest + kSolveThreads - 1) / kSolveThreads;
    solve_kernel<T><<<2 * blocks, kSolveThreads, 0, stream>>>(a, N, k0, blocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (rest + kTile - 1) / kTile;
    update_kernel<T><<<dim3(tiles, tiles), dim3(kTileThreads, kTileThreads), 0, stream>>>(
        a, N, k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" int glu_dense_lu_f32(void* a, int N, void* stream) {
  return dense_lu<float>(a, N, stream);
}

extern "C" int glu_dense_lu_f64(void* a, int N, void* stream) {
  return dense_lu<double>(a, N, stream);
}
