// Unpivoted blocked right-looking dense LU for Hopper (sm_90a), shared by
// K2 (dense_lu.cu: real tiles) and K3 (dense_lu_planar.cu: complex tiles
// held as re/im planes).  The kernel is written once over a value-ops type:
// RealOps<T> keeps real arithmetic, PlanarOps<T> reads an element as the
// pair (re plane, im plane) and does the complex arithmetic on reals.
//
// Replaces the TPU kernels dense_lu and dense_lu_planar of the JAX package
// (kernels/dense_lu.py, pallas_call at dense_lu.py:98 and :207).
//
// Computes the LU of a dense (N, N) row-major tile `a` into `out`, with L
// strictly below the diagonal (unit diagonal implied) and U on and above
// it.  No pivoting: the GLU flow makes the pivots safe with MC64 scaling.
// N is a multiple of the block width kB = 32; nb = N / kB block steps.
//
// One cooperative launch per tile, or per batch of B tiles of one N (the
// batched engine: B matrices on one plan).  The TPU holds the whole tile in VMEM; a
// 736 x 736 float64 tile is 4.3 MB, far more than a CTA's 227 KB of shared
// memory but a small part of the 50 MB L2, so the tile stays in global
// memory and a persistent grid, sized to what the card keeps resident at
// once, walks the block steps with grid-wide barriers (cooperative_groups).
// Phase s (s = 0 .. nb-1) applies step s-1's update to every block it still
// touches and factors step s's panel in the same pass (look-ahead):
//
//   * each CTA that owns a panel block of step s, and CTA 0, forms the
//     diagonal block A(s,s) - L(s,s-1) U(s-1,s) and its panel block in
//     shared memory and factors the two together in registers
//     (panel_factor): the diagonal block is factored redundantly in every
//     such CTA, bit-identically, which is cheaper than another barrier,
//     and the panel block's triangular solve rides along with the factor's
//     pivot steps instead of following it;
//   * the other CTAs update the trailing blocks A(i,j), i, j > s, with
//     step s-1's L(i,s-1) U(s-1,j), the next block's operands in flight
//     (cp.async, L2 only) while one is multiplied;
//   * the CTA of each tile's first panel block writes the diagonal block
//     factored in phase s-1, kept since in a carry slot in global memory.
//
// Phase s only reads blocks that phase s-1 finished, so one grid barrier
// separates two phases: nb - 1 per launch (N = 32: 0, N = 160: 4, N = 736:
// 22, N = 2048: 63) whatever B, no other launch, no atomics on values; a
// phase's work items are (tile, block) over the batch; inside a CTA,
// a panel factor takes one named barrier per pivot (32).  Every block's
// sums run in an order fixed by the block alone, whichever CTA computes
// it, so the result is bit-identical from run to run.  Phase 0 reads `a`,
// and every block of `out` is written from a value derived from `a`, so
// the input copy is folded into the kernel and `a` is never written.
//
// The 32 x 32 x 32 block products run on FP64 tensor cores for float64
// (mma.sync m8n8k4 .f64; a complex product is four real products into re
// and im accumulators, the Li Ui term with a plus sign) and on plain FMA
// for float32, so float32 never drops to TF32.  The pivot reciprocal is
// 1/p for real values and conj(p)/|p|^2 for complex ones.
//
// Bound: operations.  2N^3/3 multiply-adds (8N^3/3 real operations for a
// complex tile) against the FP64 tensor-core rate, or each value read and
// written once: at N = 736 about 4 us (real) and 15 us (complex).  What the
// card spends is the chain of N dependent pivot steps, nb grid barriers and
// nb rounds of L2 latency; the multiply-adds are a small part of it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kB = 32;          // block width
constexpr int kThreads = 256;   // 8 warps a CTA
constexpr int kLdT = kB + 1;    // shared blocks read a row or column per lane
constexpr int kLdM = kB + 4;    // staged operands: conflict-free mma fragments

__device__ inline float fmadd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ inline double fmadd(double a, double b, double c) { return fma(a, b, c); }

// 1/x from the hardware approximation and Newton steps (two for float64,
// one for float32), within an ulp or two of the rounded quotient.  The
// reciprocal is on the chain of every pivot step, and the IEEE division,
// with its checks for the slow path, made that chain several times longer.
__device__ inline double recip(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  double e = fma(-x, r, 1.0);
  r = fma(r, e, r);
  e = fma(-x, r, 1.0);
  return fma(r, e, r);
}
__device__ inline float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// Real values: the element at flat offset i is p[i].
template <typename T>
struct RealOps {
  using Scalar = T;
  using V = T;
  static constexpr int kPlanes = 1;
  __device__ static V ld(const T* p, long long i, long long) { return p[i]; }
  __device__ static void st(T* p, long long i, long long, V v) { p[i] = v; }
  __device__ static V shfl(V v, int lane) { return __shfl_sync(0xffffffffu, v, lane); }
  // reciprocal of a pivot, and c / p through it
  __device__ static T inv_norm(V p) { return recip(p); }
  __device__ static V div_inv(V c, V, T inv) { return c * inv; }
  // m - l * u
  __device__ static V fms(V m, V l, V u) { return fmadd(-l, u, m); }
};

// Complex values held as two planes: the element at flat offset i is
// (p[i], p[plane + i]).  c / p = c conj(p) / |p|^2, as in the JAX package's
// planar kernel.
template <typename T>
struct PlanarOps {
  using Scalar = T;
  struct V {
    T re, im;
  };
  static constexpr int kPlanes = 2;
  __device__ static V ld(const T* p, long long i, long long plane) {
    return V{p[i], p[plane + i]};
  }
  __device__ static void st(T* p, long long i, long long plane, V v) {
    p[i] = v.re;
    p[plane + i] = v.im;
  }
  __device__ static V shfl(V v, int lane) {
    return V{__shfl_sync(0xffffffffu, v.re, lane), __shfl_sync(0xffffffffu, v.im, lane)};
  }
  __device__ static T inv_norm(V p) { return recip(p.re * p.re + p.im * p.im); }
  __device__ static V div_inv(V c, V p, T inv) {
    return V{(c.re * p.re + c.im * p.im) * inv, (c.im * p.re - c.re * p.im) * inv};
  }
  __device__ static V fms(V m, V l, V u) {
    return V{fmadd(l.im, u.im, fmadd(-l.re, u.re, m.re)),
             fmadd(-l.im, u.re, fmadd(-l.re, u.im, m.im))};
  }
};

// Shared memory of one CTA, in Scalars: two stages of staged operands
// (L, U and the block S itself, each with its planes), the diagonal block,
// the panel block and the multipliers of two pivot steps.
template <typename Ops>
struct Smem {
  static constexpr int kPlaneM = kB * kLdM;
  static constexpr int kPlaneT = kB * kLdT;
  static constexpr int kL = 0;                          // offsets in a stage
  static constexpr int kU = Ops::kPlanes * kPlaneM;
  static constexpr int kS = 2 * Ops::kPlanes * kPlaneM;
  static constexpr int kStage = 3 * Ops::kPlanes * kPlaneM;
  static constexpr int kD = 2 * kStage;
  static constexpr int kT = kD + Ops::kPlanes * kPlaneT;
  static constexpr int kMul = kT + Ops::kPlanes * kPlaneT;   // see panel_factor
  static constexpr int kSize = kMul + Ops::kPlanes * 4 * kB;
  static constexpr size_t kBytes = sizeof(typename Ops::Scalar) * kSize;
};

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ inline void mma_f64(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// Start copying block `off` of a global tile (ld N, planes `plane` apart)
// into shared memory at `dst` (ld kLdM), 16 bytes a copy, bypassing L1.
template <typename Ops>
__device__ void issue_block(const typename Ops::Scalar* g, long long off, int N, long long plane,
                            typename Ops::Scalar* dst) {
  using S = Smem<Ops>;
  constexpr int kVec = 16 / sizeof(typename Ops::Scalar);
  constexpr int kRowChunks = kB / kVec;
  for (int e = threadIdx.x; e < kB * kRowChunks; e += kThreads) {
    const int r = e / kRowChunks, c = (e % kRowChunks) * kVec;
#pragma unroll
    for (int pl = 0; pl < Ops::kPlanes; ++pl)
      cp_async16(dst + pl * S::kPlaneM + r * kLdM + c,
                 g + off + pl * plane + static_cast<long long>(r) * N + c);
  }
}

__device__ inline long long block_off(int N, int bi, int bj) {
  return static_cast<long long>(bi) * kB * N + static_cast<long long>(bj) * kB;
}

// Start staging what block (bi, bj) needs in phase s: the block of `src`,
// and from phase 1 on L(bi, s-1) and U(s-1, bj) of `out`.  One commit group.
template <typename Ops>
__device__ void issue_operands(const typename Ops::Scalar* src, const typename Ops::Scalar* out,
                               int N, int bi, int bj, int s, typename Ops::Scalar* stage) {
  using S = Smem<Ops>;
  const long long plane = static_cast<long long>(N) * N;
  issue_block<Ops>(src, block_off(N, bi, bj), N, plane, stage + S::kS);
  if (s >= 1) {
    issue_block<Ops>(out, block_off(N, bi, s - 1), N, plane, stage + S::kL);
    issue_block<Ops>(out, block_off(N, s - 1, bj), N, plane, stage + S::kU);
  }
  cp_async_commit();
}

// dst = S - L U of a staged block, into global memory (ld N, planes N^2
// apart, from `off`) if `to_global`, else shared memory (ld kLdT).  Each
// output sums its products in ascending k, as the plain version's rank-1
// updates do.  float64: FP64 tensor cores, each warp two 8 x 8 output
// fragments.
template <typename Ops>
__device__ void block_update_mma(const double* stage, double* dst, long long off, int N,
                                 bool to_global) {
  using S = Smem<Ops>;
  constexpr int kP = Ops::kPlanes;
  const long long plane = static_cast<long long>(N) * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, q = lane & 3;
  const int r = (warp >> 1) * 8 + g;        // fragment row (A and C)
  const int cb = (warp & 1) * 16;           // first of the warp's 16 columns
  const double* sl = stage + S::kL;
  const double* su = stage + S::kU;
  double acc[kP][2][2];                     // [plane][fragment][2]
#pragma unroll
  for (int pl = 0; pl < kP; ++pl)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        acc[pl][f][h] = stage[S::kS + pl * S::kPlaneM + r * kLdM + cb + f * 8 + 2 * q + h];
#pragma unroll
  for (int kk = 0; kk < kB; kk += 4) {
    const double lr = sl[r * kLdM + kk + q];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const double ur = su[(kk + q) * kLdM + cb + f * 8 + g];
      mma_f64(acc[0][f], -lr, ur);
      if constexpr (kP == 2) {
        // re -= Lr Ur - Li Ui;  im -= Lr Ui + Li Ur
        const double li = sl[S::kPlaneM + r * kLdM + kk + q];
        const double ui = su[S::kPlaneM + (kk + q) * kLdM + cb + f * 8 + g];
        mma_f64(acc[0][f], li, ui);
        mma_f64(acc[1][f], -lr, ui);
        mma_f64(acc[1][f], -li, ur);
      }
    }
  }
#pragma unroll
  for (int pl = 0; pl < kP; ++pl)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = cb + f * 8 + 2 * q + h;
        if (to_global)
          dst[off + pl * plane + static_cast<long long>(r) * N + c] = acc[pl][f][h];
        else
          dst[pl * S::kPlaneT + r * kLdT + c] = acc[pl][f][h];
      }
}

// The same with plain FMA in the value type (float32: no TF32): thread
// (r, c0) owns row r, columns c0 + 8f.
template <typename Ops>
__device__ void block_update_fma(const typename Ops::Scalar* stage, typename Ops::Scalar* dst,
                                 long long off, int N, bool to_global) {
  using S = Smem<Ops>;
  using V = typename Ops::V;
  const long long plane = static_cast<long long>(N) * N;
  const int r = threadIdx.x / 8, c0 = threadIdx.x % 8;
  V acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) acc[f] = Ops::ld(stage + S::kS, r * kLdM + c0 + 8 * f, S::kPlaneM);
#pragma unroll 8
  for (int t = 0; t < kB; ++t) {
    const V l = Ops::ld(stage + S::kL, r * kLdM + t, S::kPlaneM);
#pragma unroll
    for (int f = 0; f < 4; ++f)
      acc[f] = Ops::fms(acc[f], l, Ops::ld(stage + S::kU, t * kLdM + c0 + 8 * f, S::kPlaneM));
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int c = c0 + 8 * f;
    if (to_global)
      Ops::st(dst, off + static_cast<long long>(r) * N + c, plane, acc[f]);
    else
      Ops::st(dst, r * kLdT + c, S::kPlaneT, acc[f]);
  }
}

// A staged block as of phase s (S - L U, or S itself in phase 0) into
// shared memory at `dst` (ld kLdT).  The caller syncs before and after.
template <typename Ops>
__device__ void block_to_shared(const typename Ops::Scalar* stage, int s,
                                typename Ops::Scalar* dst) {
  using S = Smem<Ops>;
  if (s == 0) {
    for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
      const int r = e / kB, c = e % kB;
#pragma unroll
      for (int pl = 0; pl < Ops::kPlanes; ++pl)
        dst[pl * S::kPlaneT + r * kLdT + c] = stage[S::kS + pl * S::kPlaneM + r * kLdM + c];
    }
  } else if constexpr (std::is_same<typename Ops::Scalar, double>::value) {
    block_update_mma<Ops>(stage, dst, 0, 0, false);
  } else {
    block_update_fma<Ops>(stage, dst, 0, 0, false);
  }
}

// Shared block (ld kLdT) to block (bi, bj) of the global tile, coalesced.
template <typename Ops>
__device__ void block_store(const typename Ops::Scalar* blk, typename Ops::Scalar* out, int N,
                            int bi, int bj) {
  using S = Smem<Ops>;
  const long long plane = static_cast<long long>(N) * N;
  const long long off = block_off(N, bi, bj);
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
    const int r = e / kB, c = e % kB;
#pragma unroll
    for (int pl = 0; pl < Ops::kPlanes; ++pl)
      out[off + pl * plane + static_cast<long long>(r) * N + c] = blk[pl * S::kPlaneT + r * kLdT + c];
  }
}

// Unblocked LU of the panel of one block step in registers: the diagonal
// block d alone (kKind 0), with the column panel block t below it (kKind
// 1: t becomes L(i,s), from X U11 = T), or with the row panel block t
// beside it (kKind 2: t becomes U(s,j), from L11 X = T).  Lane r holds row
// r; warp g holds kCols diagonal columns from kCols g in w: 8 columns in 4
// warps for real values, 4 in 8 warps for complex ones, whose four
// multiply-adds a value make the update the larger part of a step (each
// type measured faster with its own split on the H100).  The same columns
// of block row r (kKind 1) go to x; the block columns of kKind 2 go to
// warps 4-7 for real values and to x for complex ones.  At pivot p the
// warp owning column p forms the multipliers, updates its own later
// columns and publishes the multipliers in shared memory; after one named
// barrier the other warps apply the rank-1 update, each reading row p of
// its columns by shuffle from lane p.  So a pivot step costs one
// reciprocal, a barrier and a few multiply-adds a lane, and the panel
// block's solve rides along with no pass of its own.  A single warp
// holding whole rows, with a separate solve, was more than twice as slow on
// the H100: all of a step's work and latency then sat on one warp.  The
// loop over groups of kCols pivots stays rolled, so that the code stays in
// the instruction cache.
template <typename Ops, int kKind>
__device__ void panel_factor(typename Ops::Scalar* d, typename Ops::Scalar* t,
                             typename Ops::Scalar* mul) {
  using S = Smem<Ops>;
  using V = typename Ops::V;
  using T = typename Ops::Scalar;
  constexpr int kCols = Ops::kPlanes == 2 ? 4 : 8;   // diagonal columns a warp
  constexpr int kWarps = kB / kCols;
  constexpr bool kSplit = kKind == 2 && kWarps == 4;  // block columns on warps 4-7
  constexpr bool kX = kKind == 1 || (kKind == 2 && !kSplit);
  constexpr int kActive = kSplit ? 8 : kWarps;
  constexpr int kMulPlane = 4 * kB;   // mul: [parity][diagonal, block rows][lane]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (warp >= kActive) return;
  const bool block_cols = kSplit && warp >= 4;
  const int g = kSplit ? (warp & 3) : warp;
  const int c0 = kCols * g;
  T* own = block_cols ? t : d;
  V w[kCols], x[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    w[j] = Ops::ld(own, lane * kLdT + c0 + j, S::kPlaneT);
    if constexpr (kX) x[j] = Ops::ld(t, lane * kLdT + c0 + j, S::kPlaneT);
  }
#pragma unroll 1
  for (int q = 0; q < kWarps; ++q) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int p = kCols * q + j;
      T* m = mul + (p & 1) * 2 * kB;
      V l{}, lx{};
      if (!block_cols && g == q) {   // this warp owns column p
        const V piv = Ops::shfl(w[j], p);
        const T rp = Ops::inv_norm(piv);
        const bool below = lane > p;
        l = below ? Ops::div_inv(w[j], piv, rp) : V{};
        w[j] = below ? l : w[j];
        Ops::st(m, lane, kMulPlane, l);
        if constexpr (kKind == 1) {
          lx = Ops::div_inv(x[j], piv, rp);
          x[j] = lx;
          Ops::st(m, kB + lane, kMulPlane, lx);
        }
#pragma unroll
        for (int j2 = j + 1; j2 < kCols; ++j2) {
          const V u = Ops::shfl(w[j2], p);
          w[j2] = Ops::fms(w[j2], l, u);
          if constexpr (kKind == 1) x[j2] = Ops::fms(x[j2], lx, u);
        }
      }
      // named barrier 1: the warps of the factor only
      asm volatile("bar.sync 1, %0;\n" ::"n"(kActive * 32) : "memory");
      if (block_cols || g != q) {
        l = Ops::ld(m, lane, kMulPlane);
        if constexpr (kKind == 1) lx = Ops::ld(m, kB + lane, kMulPlane);
      }
      if (block_cols || g > q) {     // every column of w lies right of p
#pragma unroll
        for (int j2 = 0; j2 < kCols; ++j2) {
          const V u = Ops::shfl(w[j2], p);
          w[j2] = Ops::fms(w[j2], l, u);
          if constexpr (kKind == 1) x[j2] = Ops::fms(x[j2], lx, u);
        }
      }
      if constexpr (kKind == 2 && !kSplit) {   // every block column lies right of p
#pragma unroll
        for (int j2 = 0; j2 < kCols; ++j2) x[j2] = Ops::fms(x[j2], l, Ops::shfl(x[j2], p));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    Ops::st(own, lane * kLdT + c0 + j, S::kPlaneT, w[j]);
    if constexpr (kX) Ops::st(t, lane * kLdT + c0 + j, S::kPlaneT, x[j]);
  }
}

// Whether phase s keeps the trailing blocks off the panel CTAs: when the
// other CTAs can take them in about the time a panel block costs (about
// four block updates: two block products and the panel factor).
__device__ inline bool panel_ctas_apart(int G, int P, int Tn) {
  if (G <= P) return false;
  return (Tn + G - P - 1) / (G - P) <= 4 + (Tn + G - 1) / G;
}

// The factored diagonal block of a tile, from shared memory (ld kLdT) to
// its carry slot in global memory (kB x kB, planes kB^2 apart).
template <typename Ops>
__device__ void carry_store(const typename Ops::Scalar* sd, typename Ops::Scalar* c) {
  using S = Smem<Ops>;
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
#pragma unroll
    for (int pl = 0; pl < Ops::kPlanes; ++pl)
      c[pl * kB * kB + e] = sd[pl * S::kPlaneT + (e / kB) * kLdT + e % kB];
  }
}

// A carry slot, written by another CTA before the last grid barrier (read
// past L1), to block (bi, bi) of the tile.
template <typename Ops>
__device__ void carry_to_out(const typename Ops::Scalar* c, typename Ops::Scalar* out, int N,
                             int bi) {
  const long long plane = static_cast<long long>(N) * N;
  const long long off = block_off(N, bi, bi);
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
#pragma unroll
    for (int pl = 0; pl < Ops::kPlanes; ++pl)
      out[off + pl * plane + static_cast<long long>(e / kB) * N + e % kB] =
          __ldcg(c + pl * kB * kB + e);
  }
}

// Whether the lead CTA of tile tb in phase s (s < nb - 1) still holds the
// tile's factored diagonal block in shared memory when it leads the tile
// again in phase s + 1: the same CTA leads both phases (the later lead item
// is its first item), and its later panel items of phase s are the tile's
// own.  Then the block stays in shared memory and skips the carry slot;
// with one tile (B = 1) it always does.
__device__ inline bool diag_stays(int tb, int s, int nb, int batch, int G) {
  const int per = 2 * (nb - s - 1);
  const int per_next = s + 1 < nb - 1 ? per - 2 : 1;
  const int lead = tb * per, lead_next = tb * per_next;
  return lead_next < G && lead_next == lead % G &&
         lead + G * ((per + G - 1) / G) >= batch * per;
}

// `batch` tiles of one N, `tile` values apart, in one launch: every tile
// walks the same block steps, so one grid barrier a phase serves all of
// them, and a phase's work items are (tile, block).  Each tile's diagonal
// block is factored in phase s by every CTA that holds one of its panel
// blocks, and written to `out` only in phase s + 1, when no CTA reads it
// any more: the CTA of the tile's first panel block (the lead item) keeps
// it, in shared memory when that CTA leads the tile's next phase too
// (diag_stays), else in the tile's carry slot (global memory), and the
// next phase's lead item writes it out; the last phase factors the last
// diagonal block alone (one item a tile) and writes it at once.
//
// kBatched false: one tile (B = 1 known at compile time).
template <typename Ops, bool kBatched>
__global__ void __launch_bounds__(kThreads, 2)
dense_lu_kernel(const typename Ops::Scalar* a, typename Ops::Scalar* out,
                typename Ops::Scalar* carry, int N, int batch_arg) {
  using S = Smem<Ops>;
  using T = typename Ops::Scalar;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* stage0 = sm;                 // stage k at sm + k * S::kStage
  T* stage1 = sm + S::kStage;
  T* sd = sm + S::kD;
  T* st = sm + S::kT;
  T* smul = sm + S::kMul;
  cg::grid_group grid = cg::this_grid();
  const int batch = kBatched ? batch_arg : 1;
  const int nb = N / kB;
  const long long tile = static_cast<long long>(Ops::kPlanes) * N * N;
  const int G = gridDim.x, b = blockIdx.x;
  for (int s = 0; s < nb; ++s) {
    const T* src = s <= 1 ? a : out;   // phase 0 and 1 read blocks never written
    const int m = nb - s - 1;          // panel blocks on each side of the diagonal
    const int P = 2 * m;               // column panel (i, s) first, then row panel (s, j)
    const int Tn = s >= 1 ? m * m : 0; // trailing blocks (i, j), i, j > s
    const int per = m > 0 ? P : 1;     // items a tile: its panel, or its last diagonal
    const int n_panel = batch * per;
    int staged = -1;                   // the tile whose diagonal operands are in stage 0
    for (int w = b; w < n_panel; w += G) {
      const int tb = kBatched ? w / per : 0, it = w - tb * per;
      const T* src_t = src + tb * tile;
      T* out_t = out + tb * tile;
      T* carry_t = carry + tb * Ops::kPlanes * kB * kB;
      if (it == 0 && s >= 1) {
        if (!kBatched || diag_stays(tb, s - 1, nb, batch, G))
          block_store<Ops>(sd, out_t, N, s - 1, s - 1);
        else
          carry_to_out<Ops>(carry_t, out_t, N, s - 1);
      }
      if (tb != staged) {
        // the diagonal block into stage 0 and this panel block into stage
        // 1, in flight together
        issue_operands<Ops>(src_t, out_t, N, s, s, s, stage0);
        staged = tb;
      }
      if (m == 0) {   // the last diagonal block alone
        cp_async_wait<0>();
        __syncthreads();
        block_to_shared<Ops>(stage0, s, sd);
        __syncthreads();
        panel_factor<Ops, 0>(sd, st, smul);
        __syncthreads();
        block_store<Ops>(sd, out_t, N, s, s);
        __syncthreads();
        continue;
      }
      const bool lower = it < m;
      const int k = s + 1 + (lower ? it : it - m);
      const int bi = lower ? k : s, bj = lower ? s : k;
      issue_operands<Ops>(src_t, out_t, N, bi, bj, s, stage1);
      cp_async_wait<0>();
      __syncthreads();
      block_to_shared<Ops>(stage0, s, sd);
      block_to_shared<Ops>(stage1, s, st);
      __syncthreads();
      if (lower)
        panel_factor<Ops, 1>(sd, st, smul);
      else
        panel_factor<Ops, 2>(sd, st, smul);
      __syncthreads();
      block_store<Ops>(st, out_t, N, bi, bj);
      if (it == 0 && kBatched && !diag_stays(tb, s, nb, batch, G))
        carry_store<Ops>(sd, carry_t);
      __syncthreads();
    }
    // trailing blocks, the next one's operands in flight while one updates
    const int n_trail = batch * Tn;
    const int t0 = panel_ctas_apart(G, n_panel, n_trail) ? n_panel : 0;
    const int stride = G - t0;
    int t = b - t0;
    if (t >= 0 && t < n_trail) {
      auto issue = [&](int u, T* stage) {
        const int tb = kBatched ? u / Tn : 0, r = u - tb * Tn;
        issue_operands<Ops>(src + tb * tile, out + tb * tile, N, s + 1 + r / m,
                            s + 1 + r % m, s, stage);
      };
      issue(t, stage0);
      for (int k = 0; t < n_trail; ++k, t += stride) {
        const int tn = t + stride;
        if (tn < n_trail) {
          issue(tn, sm + ((k + 1) & 1) * S::kStage);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int tb = kBatched ? t / Tn : 0, r = t - tb * Tn;
        const long long off = block_off(N, s + 1 + r / m, s + 1 + r % m);
        const T* stage = sm + (k & 1) * S::kStage;
        if constexpr (std::is_same<T, double>::value)
          block_update_mma<Ops>(stage, out + tb * tile, off, N, true);
        else
          block_update_fma<Ops>(stage, out + tb * tile, off, N, true);
        __syncthreads();
      }
    }
    if (s < nb - 1) grid.sync();
  }
}

// CTAs that have work in the busiest phase of one tile: phase 0's panel
// blocks, or phase 1's panel and trailing blocks.
inline int max_work(int nb) {
  const int w0 = 2 * (nb - 1);
  const int w1 = nb >= 2 ? (nb - 2) * (nb - 2) + 2 * (nb - 2) : 0;
  const int w = w0 > w1 ? w0 : w1;
  return w > 1 ? w : 1;
}

// One cooperative launch on `stream` for `batch` tiles (each kPlanes N^2
// values, one after the other in `a` and `out`); `carry` holds kPlanes
// kB^2 values a tile.  Returns the launch's error (the launch is refused,
// not run, if the grid could not be resident at once).  The grid is what
// the card keeps resident (occupancy x multiprocessors), capped by the
// busiest phase's work over the batch.
template <typename Ops>
int dense_lu(const void* a, void* out, void* carry, int N, int batch, void* stream_ptr) {
  using T = typename Ops::Scalar;
  if (N <= 0 || batch <= 0) return static_cast<int>(cudaSuccess);
  if (N % kB != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = batch == 1 ? dense_lu_kernel<Ops, false> : dense_lu_kernel<Ops, true>;
  const size_t smem = Smem<Ops>::kBytes;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long work = static_cast<long long>(max_work(N / kB)) * batch;
  const int grid = per_sm * sms < work ? per_sm * sms : static_cast<int>(work);
  const T* a_t = static_cast<const T*>(a);
  T* out_t = static_cast<T*>(out);
  T* carry_t = static_cast<T*>(carry);
  void* args[] = {&a_t, &out_t, &carry_t, &N, &batch};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream_ptr));
  return static_cast<int>(err);
}

}  // namespace
