// Cycles of the dense-LU kernel's parts in one CTA of 256 threads, from
// clock64 around each: the three kinds of panel factor, one 32 x 32 x 32
// block product into shared memory, and 32 named (128 threads) and 32
// full-CTA barriers, for float64, float32 and complex128 values.  Built and
// run by timeline.py beside it; the header comes from
// src/repro_torch/kernels/csrc (pass it with -I).

#include <cstdio>

#include "dense_lu.cuh"

template <typename Ops, int kWhat>
__global__ void __launch_bounds__(kThreads, 2)
pieces_kernel(const typename Ops::Scalar* a, long long* cycles, int reps) {
  using S = Smem<Ops>;
  using T = typename Ops::Scalar;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* sd = sm + S::kD;
  T* st = sm + S::kT;
  long long total = 0;
  for (int r = 0; r < reps; ++r) {
    for (int e = threadIdx.x; e < Ops::kPlanes * kB * kB; e += blockDim.x) {
      const int pl = e / (kB * kB), i = e % (kB * kB);
      sd[pl * S::kPlaneT + (i / kB) * kLdT + i % kB] = a[e];
      st[pl * S::kPlaneT + (i / kB) * kLdT + i % kB] = a[e] * T(0.5);
    }
    for (int e = threadIdx.x; e < S::kStage; e += blockDim.x) sm[e] = T(0.001) * (e % 7);
    __syncthreads();
    const long long t0 = clock64();
    if constexpr (kWhat == 0) panel_factor<Ops, 0>(sd, st, sm + S::kMul);
    if constexpr (kWhat == 1) panel_factor<Ops, 1>(sd, st, sm + S::kMul);
    if constexpr (kWhat == 2) panel_factor<Ops, 2>(sd, st, sm + S::kMul);
    if constexpr (kWhat == 3) block_to_shared<Ops>(sm, 1, st);
    if constexpr (kWhat == 4) {
      if (threadIdx.x < 128)
        for (int i = 0; i < 32; ++i) asm volatile("bar.sync 1, 128;\n" ::: "memory");
    }
    if constexpr (kWhat == 5) {
      for (int i = 0; i < 32; ++i) __syncthreads();
    }
    __syncthreads();
    total += clock64() - t0;
  }
  if (threadIdx.x == 0) cycles[0] = total / reps;
}

template <typename Ops, int kWhat>
void run(const char* name) {
  using T = typename Ops::Scalar;
  constexpr int n = Ops::kPlanes * kB * kB;
  T h[n];
  for (int i = 0; i < n; ++i) {   // diagonally dominant real part
    const int j = i % (kB * kB);
    h[i] = T(((i * 37) % 17) * 0.01) + (j / kB == j % kB && i < kB * kB ? T(32) : T(0));
  }
  T* a = nullptr;
  long long* c = nullptr;
  cudaMalloc(&a, sizeof(h));
  cudaMalloc(&c, sizeof(long long));
  cudaMemcpy(a, h, sizeof(h), cudaMemcpyHostToDevice);
  const size_t smem = Smem<Ops>::kBytes;
  cudaFuncSetAttribute(pieces_kernel<Ops, kWhat>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  pieces_kernel<Ops, kWhat><<<1, kThreads, smem>>>(a, c, 20);
  long long cycles = 0;
  const cudaError_t err = cudaMemcpy(&cycles, c, sizeof(cycles), cudaMemcpyDeviceToHost);
  printf("%-36s %8lld cycles (%s)\n", name, cycles, cudaGetErrorString(err));
  cudaFree(a);
  cudaFree(c);
}

int main() {
  run<RealOps<double>, 0>("float64 panel factor, diagonal only");
  run<RealOps<double>, 1>("float64 panel factor + column block");
  run<RealOps<double>, 2>("float64 panel factor + row block");
  run<RealOps<double>, 3>("float64 block product (DMMA)");
  run<RealOps<float>, 0>("float32 panel factor, diagonal only");
  run<RealOps<float>, 1>("float32 panel factor + column block");
  run<RealOps<float>, 2>("float32 panel factor + row block");
  run<RealOps<float>, 3>("float32 block product (FMA)");
  run<PlanarOps<double>, 0>("complex128 panel factor, diagonal");
  run<PlanarOps<double>, 1>("complex128 panel factor + column");
  run<PlanarOps<double>, 2>("complex128 panel factor + row");
  run<PlanarOps<double>, 3>("complex128 block product (DMMA)");
  run<RealOps<double>, 4>("32 named barriers, 4 warps");
  run<RealOps<double>, 5>("32 __syncthreads, 8 warps");
  return 0;
}
