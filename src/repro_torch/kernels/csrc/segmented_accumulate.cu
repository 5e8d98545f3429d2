// K1: segmented level update for Hopper (sm_90a).
//
// Replaces the TPU kernel segmented_accumulate of the JAX package
// (kernels/level_update.py, body _kernel, pallas_call at level_update.py:60):
//
//   out (D, C) = col_vals (D, C) + scatter(contribs (D, R) at didx_local (D, R))
//
// Row d is one destination column segment of a level.  Positions outside
// [0, C) are padding and are dropped; duplicate positions sum.
//
// On the TPU each (row, 512-block) grid cell multiplies a one-hot matrix on
// the MXU.  Here one CTA owns up to kSlots slots of one row and walks the
// row's contributions in tiles of kTile through shared memory.  Per tile it
// counting-sorts the tile's positions into per-slot buckets (counts, an
// exclusive scan, placement), then each thread sorts the few entries of its
// own slots' buckets by tile index and adds them in that order to running
// sums kept in registers.  So every slot sums its contributions in
// ascending r, starting from col_vals, whatever order the threads ran in:
// the result is bit-for-bit the same on every run (the shared-memory
// atomics only count and place integers; no value is ever summed by an
// atomic) and equals a sequential scatter-add.  The cost per row is
// O(R + C) plus the sort of duplicate positions, which are few.
//
// Bound: memory.  The function must read D*C values, D*R values and D*R
// int32 positions and write D*C values; at the slice's shapes a launch is
// a few microseconds, so the host's launch cost dominates until the whole
// schedule is captured in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kSlots = kThreads * kSlotsPerThread;  // slots per CTA
constexpr int kTile = 1024;                         // contributions per pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
segmented_accumulate_kernel(const T* __restrict__ col_vals,
                            const T* __restrict__ contribs,
                            const int* __restrict__ didx_local,
                            T* __restrict__ out, int C, int R) {
  __shared__ int s_idx[kTile];     // tile positions relative to c0, -1 = dropped
  __shared__ T s_val[kTile];
  __shared__ int s_cnt[kSlots];    // entries per slot in this tile
  __shared__ int s_off[kSlots];    // bucket start, then bucket end after placement
  __shared__ int s_bucket[kTile];  // tile indices grouped by slot
  __shared__ int s_warp[kThreads / 32];

  const long long d = blockIdx.x;
  const int c0 = blockIdx.y * kSlots;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int my0 = tid * kSlotsPerThread;  // this thread's first slot (relative)
  const T* cv = col_vals + d * C;
  const T* cb = contribs + d * R;
  const int* dl = didx_local + d * R;

  T acc[kSlotsPerThread];
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int c = c0 + my0 + k;
    acc[k] = c < C ? cv[c] : T(0);
  }

  for (int r0 = 0; r0 < R; r0 += kTile) {
    const int n = min(kTile, R - r0);
    // 1. stage the tile and count the entries of each slot
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) s_cnt[my0 + k] = 0;
    __syncthreads();
    for (int t = tid; t < n; t += kThreads) {
      int idx = dl[r0 + t];
      idx = (idx >= c0 && idx < C && idx - c0 < kSlots) ? idx - c0 : -1;
      s_idx[t] = idx;
      if (idx >= 0) {
        s_val[t] = cb[r0 + t];
        atomicAdd(&s_cnt[idx], 1);
      }
    }
    __syncthreads();

    // 2. exclusive scan of the counts: per thread over its slots, then
    //    across the block with warp shuffles
    int local[kSlotsPerThread];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) {
      local[k] = sum;
      sum += s_cnt[my0 + k];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[tid >> 5] = incl;
    __syncthreads();
    int base = incl - sum;
    for (int w = 0; w < (tid >> 5); ++w) base += s_warp[w];
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) s_off[my0 + k] = base + local[k];
    __syncthreads();

    // 3. place each entry into its slot's bucket (any order inside a bucket)
    for (int t = tid; t < n; t += kThreads) {
      const int idx = s_idx[t];
      if (idx >= 0) s_bucket[atomicAdd(&s_off[idx], 1)] = t;
    }
    __syncthreads();

    // 4. each thread orders its buckets by tile index and adds in that order
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) {
      const int end = s_off[my0 + k];
      const int beg = end - s_cnt[my0 + k];
      for (int i = beg + 1; i < end; ++i) {
        const int v = s_bucket[i];
        int j = i - 1;
        while (j >= beg && s_bucket[j] > v) {
          s_bucket[j + 1] = s_bucket[j];
          --j;
        }
        s_bucket[j + 1] = v;
      }
      T a = acc[k];
      for (int i = beg; i < end; ++i) a += s_val[s_bucket[i]];
      acc[k] = a;
    }
    __syncthreads();  // the next tile reuses shared memory
  }

#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int c = c0 + my0 + k;
    if (c < C) out[d * C + c] = acc[k];
  }
}

template <typename T>
int launch(const void* col_vals, const void* contribs, const void* didx_local,
           void* out, int D, int C, int R, void* stream) {
  if (D <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid(static_cast<unsigned>(D), static_cast<unsigned>((C + kSlots - 1) / kSlots));
  segmented_accumulate_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(col_vals), static_cast<const T*>(contribs),
      static_cast<const int*>(didx_local), static_cast<T*>(out), C, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int glu_segmented_accumulate_f32(const void* col_vals, const void* contribs,
                                            const void* didx_local, void* out, int D,
                                            int C, int R, void* stream) {
  return launch<float>(col_vals, contribs, didx_local, out, D, C, R, stream);
}

extern "C" int glu_segmented_accumulate_f64(const void* col_vals, const void* contribs,
                                            const void* didx_local, void* out, int D,
                                            int C, int R, void* stream) {
  return launch<double>(col_vals, contribs, didx_local, out, D, C, R, stream);
}
