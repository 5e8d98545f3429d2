// K2: unpivoted blocked right-looking dense LU of a real tile, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dense_lu of the JAX package (kernels/dense_lu.py,
// body _lu_kernel with _panel_factor and _trsm_rows, pallas_call at
// dense_lu.py:98).  The kernel is in dense_lu.cuh, shared with K3; here it
// runs on RealOps.
//
// One cooperative launch per tile, N / 32 - 1 grid barriers (N = 160: 4,
// N = 736: 22), no copy launch: the kernel reads `a` and writes `out`.
// float64 block products on FP64 tensor cores (mma.sync m8n8k4 .f64),
// float32 on plain FMA (no TF32).  A panel factor runs on 4 warps of 8
// diagonal columns each.
//
// Bound: operations, 2N^3/3 multiply-adds against the FP64 tensor-core rate
// (about 4 us at N = 736), or 2 N^2 values moved (2.6 us).  The chain of N
// dependent pivot steps and N / 32 grid barriers sets the time on this
// card, not the arithmetic.

#include "dense_lu.cuh"

extern "C" int glu_dense_lu_f32(const void* a, void* out, int N, void* stream) {
  return dense_lu<RealOps<float>>(a, out, N, stream);
}

extern "C" int glu_dense_lu_f64(const void* a, void* out, int N, void* stream) {
  return dense_lu<RealOps<double>>(a, out, N, stream);
}
