// K3: unpivoted blocked right-looking dense LU of a complex tile held as
// (2, N, N) re/im planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel dense_lu_planar of the JAX package
// (kernels/dense_lu.py, body _lu_kernel_planar with _panel_factor_planar
// and _trsm_rows_planar, pallas_call at dense_lu.py:207).  The kernel is
// K2's, in dense_lu.cuh, on PlanarOps: an element is read from both planes,
// the pivot reciprocal is conj(p) / (re^2 + im^2), and a complex block
// product is four real FP64 tensor-core products (mma.sync m8n8k4 .f64)
// into re and im accumulators, the Li Ui term with a plus sign; float32
// planes use plain FMA.  The planes stay separate in global and shared
// memory, so a warp's loads of one plane are as coalesced as K2's.
//
// One cooperative launch per tile, N / 32 - 1 grid barriers.  A CTA's
// shared memory is 146,432 bytes for float64 planes (two stages of staged
// operands, the diagonal and panel blocks, both planes), above the 48 KB
// static limit, so it is dynamic shared memory raised with
// cudaFuncSetAttribute, and one CTA a multiprocessor is resident.  A panel
// factor runs on 8 warps of 4 diagonal columns each: a complex
// multiply-add is four real ones, so the update, not the barrier, is the
// larger part of a pivot step.
//
// Bound: operations, about 8N^3/3 real operations against the FP64
// tensor-core rate (15 us at N = 736), or 2 * 2 N^2 values moved.

#include "dense_lu.cuh"

extern "C" int glu_dense_lu_planar_f32(const void* a, void* out, int N, void* stream) {
  return dense_lu<PlanarOps<float>>(a, out, N, stream);
}

extern "C" int glu_dense_lu_planar_f64(const void* a, void* out, int N, void* stream) {
  return dense_lu<PlanarOps<double>>(a, out, N, stream);
}
