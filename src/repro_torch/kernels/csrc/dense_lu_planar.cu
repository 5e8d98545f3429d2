// K3: unpivoted blocked right-looking dense LU of a complex tile held as
// (2, N, N) re/im planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel dense_lu_planar of the JAX package
// (kernels/dense_lu.py, body _lu_kernel_planar with _panel_factor_planar
// and _trsm_rows_planar, pallas_call at dense_lu.py:207).  The kernels are
// K2's, in dense_lu.cuh, on PlanarOps: an element is read from both planes,
// the pivot reciprocal is conj(p) / (re^2 + im^2) and the complex MAC four
// real FMAs and a sign, written in the kernel body (no complex matmul).
// The planes stay separate in global memory, so a warp's loads of one
// plane are as coalesced as K2's.
//
// Bound: about 8N^3/3 real operations (a complex MAC is 4 real FMAs) against
// the card's float64 rate, or 2 * 2 N^2 values moved; operations bound it at
// the slice's N = 736 (0.015 ms at 67 TFLOP/s), and the 3 N / kB - 2 launches
// and the plain FMA update (no DMMA) are what this first version costs.
// The update stages 32 x 32 complex tiles (2 x 2 outputs a thread): two
// 32 x 33 complex float64 operand tiles are 34 KB of static shared memory.

#include "dense_lu.cuh"

extern "C" int glu_dense_lu_planar_f32(void* a, int N, void* stream) {
  return dense_lu<PlanarOps<float>, 32>(a, N, stream);
}

extern "C" int glu_dense_lu_planar_f64(void* a, int N, void* stream) {
  return dense_lu<PlanarOps<double>, 32>(a, N, stream);
}
