// K2: unpivoted blocked right-looking dense LU of a real tile, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dense_lu of the JAX package (kernels/dense_lu.py,
// body _lu_kernel with _panel_factor and _trsm_rows, pallas_call at
// dense_lu.py:98).  The kernels are in dense_lu.cuh, shared with K3; here
// they run on RealOps with 64 x 64 update tiles (4 x 4 outputs a thread).
//
// Bound: 2N^3/3 operations against the card's float64 rate, or 2 N^2 values
// moved, whichever is larger; at the slice's N (160 to 1024) both are a few
// microseconds at most, and the 3 N / kB - 2 launches dominate.  A
// persistent single-launch version with DMMA for the update is later work.

#include "dense_lu.cuh"

extern "C" int glu_dense_lu_f32(void* a, int N, void* stream) {
  return dense_lu<RealOps<float>, 64>(a, N, stream);
}

extern "C" int glu_dense_lu_f64(void* a, int N, void* stream) {
  return dense_lu<RealOps<double>, 64>(a, N, stream);
}
