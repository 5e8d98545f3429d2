// K1 for Hopper (sm_90a): a whole run of consecutive SEGMENTED/PANEL levels
// of the GLU factorization in one persistent cooperative launch.
//
// Replaces the TPU kernel segmented_accumulate of the JAX package
// (kernels/level_update.py, body _kernel, pallas_call at level_update.py:60)
// together with the level step around it (kernels/ops.py:48,
// level_update_body, and :139, level_update_planar_body): normalize the
// level's L entries, gather each update's operands, form -l*u, accumulate
// into each destination column segment and write it back.  The JAX package
// runs those levels as a lax.scan; here the loop over levels is inside the
// kernel, with one grid barrier (cooperative_groups) a level.
//
// Layout (built once per plan on the host, int32, no padding):
//   levels (L, 6)  norm_start, norm_end, row_start, row_end, item_start,
//                  item_end of each level (the kernel reads the norm and item
//                  ranges)
//   items  (I, 2)  row, first slot: one work item is one destination row and
//                  a block of up to kSlots of its slots
//   rows   (D, 4)  col_start, col_len, upd_start, upd_end: the row's segment
//                  is vals[col_start : col_start + col_len]
//   upd    (U, 4)  lidx, uidx, ldiag, dpos: each update in the plan's order
//                  within its row; ldiag is the diagonal that normalizes the
//                  L operand, dpos the position inside the segment
//   norm   (P, 2)  norm_idx, norm_diag
//
// Each contribution is -((v[lidx] / v[ldiag]) * v[uidx]), normalized on
// the fly: the same IEEE operations in the same order as the plain
// version's normalize-then-multiply, with the _rn intrinsics so nvcc cannot
// contract them into an FMA.  The L entries are written normalized once,
// for every level of the run, after its last level: no level waits for a
// normalization.  The host checks the facts that make this and one barrier
// a level safe (kernels/level_update.py, check_run_invariants): rows of a
// level have disjoint segments (I1), no slot a level writes is an operand
// of that level (I2), and the entries a level normalizes are neither read
// nor written by a later level of the run (I3).
//
// Accumulation as in the per-level kernel it replaces: a CTA stages a tile
// of its row's contributions in shared memory, counting-sorts their
// positions into per-slot buckets, and each thread adds its slots' entries
// in ascending update order, starting from the slot's current value.  No
// value is summed by an atomic, so a factorization gives the same bits on
// every run, and they equal the plain version's sequential sums.  Only
// slots that received a contribution are written back.  Values another CTA
// wrote before a barrier are read past L1 (ld.global.cg), and the value
// array is not declared const __restrict__, so nvcc never reads it through
// the non-coherent path.
//
// Static pivoting (the robust instantiation): the counterpart of the
// reference's per-level guard (core/factorize.py:567-571, kernels/ops.py:220
// _perturb_diags_body, and for complex values :244
// _perturb_diags_planar_body before each planar level,
// core/factorize.py:257-263).  Each level's column diagonals are final once
// the earlier levels of the run are done, so at the start of each level,
// right after the grid barrier, the grid bumps them: any |d| < tau becomes
// tau * d / |d| (+tau for an exact zero).  For complex values |d| is
// hypot(re, im) (what PyTorch's complex abs computes on the card), the
// phase re / |d|, im / |d| is taken per plane and each times tau, and an
// exact zero becomes (tau, 0).  A second grid barrier follows, so no
// normalize or product of the level reads a diagonal before its bump.  tau
// is real (the values' real type) and read from device memory, one value a
// matrix (eps * max|A|, computed on the card before the launch), and each
// bump is
// added into its matrix's device int32 counter with an integer atomic,
// whose sum does not depend on the order.  Layout: diag_ptr (L + 1) and
// diag (P) list each level's diagonal positions; the plain instantiation
// never reads them.
//
// Batch axis: B value arrays that share one plan, matrix b's at vals +
// b * stride (64-bit offsets), run in the same launch.  A level's work
// items become (matrix, row, slot block), its diagonals and normalizations
// (matrix, entry); their indices stay 32-bit (the host keeps B times a
// level's items, its diagonals and the run's normalizations below 2^31),
// and a single matrix (B = 1) runs an instantiation with B fixed at 1.  One grid barrier a
// level serves the whole batch, and I1-I3 hold per matrix because the
// matrices share nothing.  Each matrix's arithmetic and sum order are the
// single matrix's, so matrix b comes out bit for bit as alone.  The robust
// instantiation reads tau[b] and adds matrix b's bumps into count[b].
//
// Bound: the latency of the run's dependent levels (154 on grid64, 10 on
// rajat12_like), each a round trip for the packed indices, one for the
// operand values and a grid barrier; in bytes, the updates' int32 indices
// (about 1.9 M x 16 B on grid64) and each touched value once.  The design
// packs an update's four indices into one 16-byte load, needs no index
// array for the segments (a row's segment is one contiguous slice), and
// pays one barrier a level instead of about eleven host-issued kernels.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kSlots = kThreads * kSlotsPerThread;  // slots per work item
constexpr int kTile = 1024;                         // contributions per pass
constexpr int kLevelFields = 6;

__device__ inline float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ inline double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ inline float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ inline double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ inline float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ inline float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ inline double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ inline float hypot_of(float a, float b) { return hypotf(a, b); }
__device__ inline double hypot_of(double a, double b) { return hypot(a, b); }

// Real values: v = l / d, contribution -(v * u), sums a + c.
template <typename T>
struct RealOps {
  using V = T;
  using R = T;  // the type of tau
  __device__ static V load(const V* p, int i) { return __ldcg(p + i); }
  __device__ static void store(V* p, int i, V v) { __stcg(p + i, v); }
  __device__ static V zero() { return T(0); }
  __device__ static V div(V a, V b) { return div_rn(a, b); }
  __device__ static V contrib(V l, V d, V u) { return -mul_rn(div(l, d), u); }
  __device__ static V add(V a, V b) { return add_rn(a, b); }
  // the static-pivot rule of the reference: |d| < tau -> tau * d / |d|,
  // where d / |d| is exactly +-1, and an exact zero (either sign) -> +tau
  __device__ static bool bump(V& d, R tau) {
    if (!(fabs(d) < tau)) return false;
    d = d < T(0) ? -tau : tau;
    return true;
  }
};

// Complex values, read as interleaved (re, im) pairs (the memory that
// view_as_real shows).  The arithmetic is the plain version's planar one
// (sparse/layout.py pdiv and pmul): a / b = (a conj(b)) * (1 / |b|^2).
template <typename T, typename T2>
struct ComplexOps {
  using V = T2;
  using R = T;  // the type of tau
  __device__ static V load(const V* p, int i) { return __ldcg(p + i); }
  __device__ static void store(V* p, int i, V v) { __stcg(p + i, v); }
  __device__ static V zero() { return V{T(0), T(0)}; }
  __device__ static V div(V a, V b) {
    const T inv = div_rn(T(1), add_rn(mul_rn(b.x, b.x), mul_rn(b.y, b.y)));
    return V{mul_rn(add_rn(mul_rn(a.x, b.x), mul_rn(a.y, b.y)), inv),
             mul_rn(sub_rn(mul_rn(a.y, b.x), mul_rn(a.x, b.y)), inv)};
  }
  __device__ static V contrib(V l, V d, V u) {
    const V n = div(l, d);
    return V{-sub_rn(mul_rn(n.x, u.x), mul_rn(n.y, u.y)),
             -add_rn(mul_rn(n.x, u.y), mul_rn(n.y, u.x))};
  }
  __device__ static V add(V a, V b) { return V{add_rn(a.x, b.x), add_rn(a.y, b.y)}; }
  // the reference's planar static-pivot rule: |d| = hypot(re, im) < tau ->
  // (re / |d| * tau, im / |d| * tau), an exact zero -> (tau, 0)
  __device__ static bool bump(V& d, R tau) {
    const T mag = hypot_of(d.x, d.y);
    if (!(mag < tau)) return false;
    d = mag > T(0) ? V{mul_rn(div_rn(d.x, mag), tau), mul_rn(div_rn(d.y, mag), tau)}
                   : V{tau, T(0)};
    return true;
  }
};

template <typename V>
struct Smem {
  int idx[kTile];     // tile positions relative to the item's first slot, -1 = other block
  V val[kTile];       // the tile's contributions
  int cnt[kSlots];    // entries per slot in this tile
  int off[kSlots];    // bucket start, then bucket end after placement
  int bucket[kTile];  // tile indices grouped by slot
  int warp[kThreads / 32];
};

// vals[norm_idx] = vals[norm_idx] / vals[norm_diag] for entries [0, n) of
// every matrix, spread over every thread of the grid.
template <typename Ops>
__device__ void normalize(typename Ops::V* vals, const int2* __restrict__ norm, int n,
                          int batch, int stride) {
  const int total = batch * n;   // the host keeps batch * n below 2^31
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    const int b = batch == 1 ? 0 : i / n;
    const int2 e = __ldg(norm + (i - b * n));
    typename Ops::V* v = vals + static_cast<long long>(b) * stride;
    Ops::store(v, e.x, Ops::div(Ops::load(v, e.x), Ops::load(v, e.y)));
  }
}

// One work item: slots [c0, c0 + kSlots) of one row.
template <typename Ops>
__device__ void row_block(typename Ops::V* vals, int4 row, int c0,
                          const int4* __restrict__ upd, Smem<typename Ops::V>& sm) {
  using V = typename Ops::V;
  const int col_start = row.x, C = row.y, u0 = row.z, R = row.w - row.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int my0 = tid * kSlotsPerThread;  // this thread's first slot (relative)

  V acc[kSlotsPerThread];
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int c = c0 + my0 + k;
    acc[k] = c < C ? Ops::load(vals, col_start + c) : Ops::zero();
  }
  int touched = 0;  // bit k: slot my0 + k received a contribution

  for (int r0 = 0; r0 < R; r0 += kTile) {
    const int n = min(kTile, R - r0);
    // 1. stage the tile's contributions of this block and count each slot's
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) sm.cnt[my0 + k] = 0;
    __syncthreads();
    for (int t = tid; t < n; t += kThreads) {
      const int4 e = __ldg(upd + u0 + r0 + t);
      const int p = e.w - c0;
      if (p >= 0 && p < kSlots) {
        sm.idx[t] = p;
        sm.val[t] = Ops::contrib(Ops::load(vals, e.x), Ops::load(vals, e.z),
                                 Ops::load(vals, e.y));
        atomicAdd(&sm.cnt[p], 1);
      } else {
        sm.idx[t] = -1;
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
      sum += sm.cnt[my0 + k];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sm.warp[tid >> 5] = incl;
    __syncthreads();
    int base = incl - sum;
    for (int w = 0; w < (tid >> 5); ++w) base += sm.warp[w];
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) sm.off[my0 + k] = base + local[k];
    __syncthreads();

    // 3. place each entry into its slot's bucket (any order inside a bucket)
    for (int t = tid; t < n; t += kThreads) {
      const int p = sm.idx[t];
      if (p >= 0) sm.bucket[atomicAdd(&sm.off[p], 1)] = t;
    }
    __syncthreads();

    // 4. each thread orders its buckets by tile index and adds in that order
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) {
      const int end = sm.off[my0 + k];
      const int beg = end - sm.cnt[my0 + k];
      for (int i = beg + 1; i < end; ++i) {
        const int v = sm.bucket[i];
        int j = i - 1;
        while (j >= beg && sm.bucket[j] > v) {
          sm.bucket[j + 1] = sm.bucket[j];
          --j;
        }
        sm.bucket[j + 1] = v;
      }
      V a = acc[k];
      for (int i = beg; i < end; ++i) a = Ops::add(a, sm.val[sm.bucket[i]]);
      acc[k] = a;
      if (end > beg) touched |= 1 << k;
    }
    __syncthreads();  // the next tile (or item) reuses shared memory
  }

#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k)
    if (touched & (1 << k)) Ops::store(vals, col_start + c0 + my0 + k, acc[k]);
}

// The grid's bumps of one level's diagonals diag[d0 : d1] in every matrix,
// matrix b's against tau[b] and counted into count[b].
template <typename Ops>
__device__ void bump_diagonals(typename Ops::V* vals, const int* __restrict__ diag,
                               int d0, int d1, const typename Ops::R* __restrict__ tau,
                               int* count, int batch, int stride) {
  const int n = d1 - d0;
  const int total = batch * n;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    const int b = batch == 1 ? 0 : i / n;
    const int p = __ldg(diag + d0 + (i - b * n));
    typename Ops::V* v = vals + static_cast<long long>(b) * stride;
    typename Ops::V d = Ops::load(v, p);
    if (Ops::bump(d, __ldg(tau + b))) {
      Ops::store(v, p, d);
      atomicAdd(count + b, 1);
    }
  }
}

// kBatched false: a single matrix (B = 1 known at compile time, so its
// work indices need no division).
template <typename Ops, bool kRobust, bool kBatched>
__global__ void __launch_bounds__(kThreads)
level_run_kernel(typename Ops::V* vals, const int* __restrict__ levels,
                 const int2* __restrict__ items, const int4* __restrict__ rows,
                 const int4* __restrict__ upd, const int2* __restrict__ norm,
                 int n_levels, const int* __restrict__ diag_ptr,
                 const int* __restrict__ diag, const typename Ops::R* __restrict__ tau,
                 int* count, int batch_arg, int stride) {
  __shared__ Smem<typename Ops::V> sm;
  cg::grid_group grid = cg::this_grid();
  const int batch = kBatched ? batch_arg : 1;
  for (int lev = 0; lev < n_levels; ++lev) {
    if constexpr (kRobust) {
      bump_diagonals<Ops>(vals, diag, __ldg(diag_ptr + lev), __ldg(diag_ptr + lev + 1), tau,
                          count, batch, stride);
      grid.sync();
    }
    const int* meta = levels + lev * kLevelFields;
    const int i0 = __ldg(meta + 4), n_items = __ldg(meta + 5) - i0;
    const int total = batch * n_items;
    // work item w: matrix w / n_items, item i0 + w % n_items
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      const int b = batch == 1 ? 0 : w / n_items;
      const int2 item = __ldg(items + i0 + (w - b * n_items));
      row_block<Ops>(vals + static_cast<long long>(b) * stride, __ldg(rows + item.x), item.y,
                     upd, sm);
    }
    grid.sync();
  }
  // every level's L entries: no level of the run writes them or their
  // diagonals after it normalizes them, nor reads them after its own (I3)
  if (n_levels > 0)
    normalize<Ops>(vals, norm, __ldg(levels + (n_levels - 1) * kLevelFields + 1), batch,
                   stride);
}

// One cooperative launch on `stream` for `batch` value arrays `stride`
// values apart; returns its error (the launch is refused, not run, if the
// grid could not be resident at once).  The grid is what the card keeps
// resident (occupancy x multiprocessors), capped by the largest level's
// work items over the batch.  The launch may be recorded into a CUDA
// graph (stream capture takes cooperative launches as cooperative kernel
// nodes); the occupancy queries run on the host at capture time.
template <typename Ops, bool kRobust>
int level_run(void* vals, const void* levels, const void* items, const void* rows,
              const void* upd, const void* norm, const void* diag_ptr, const void* diag,
              const void* tau, void* count, int n_levels, int max_items, int batch, int stride,
              void* stream) {
  if (n_levels <= 0 || batch <= 0) return static_cast<int>(cudaSuccess);
  auto kernel = batch == 1 ? level_run_kernel<Ops, kRobust, false>
                            : level_run_kernel<Ops, kRobust, true>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long work = static_cast<long long>(max_items > 1 ? max_items : 1) * batch;
  const int grid = per_sm * sms < work ? per_sm * sms : static_cast<int>(work);
  using V = typename Ops::V;
  using R = typename Ops::R;
  V* v = static_cast<V*>(vals);
  const int* lv = static_cast<const int*>(levels);
  const int2* it = static_cast<const int2*>(items);
  const int4* rw = static_cast<const int4*>(rows);
  const int4* up = static_cast<const int4*>(upd);
  const int2* nm = static_cast<const int2*>(norm);
  const int* dp = static_cast<const int*>(diag_ptr);
  const int* dg = static_cast<const int*>(diag);
  const R* ta = static_cast<const R*>(tau);
  int* ct = static_cast<int*>(count);
  void* args[] = {&v, &lv, &it, &rw, &up, &nm, &n_levels, &dp, &dg, &ta, &ct, &batch, &stride};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // namespace

// One value array (B = 1).
extern "C" int glu_level_run_f32(void* vals, const void* levels, const void* items,
                                 const void* rows, const void* upd, const void* norm,
                                 int n_levels, int max_items, void* stream) {
  return level_run<RealOps<float>, false>(vals, levels, items, rows, upd, norm, nullptr,
                                          nullptr, nullptr, nullptr, n_levels, max_items, 1, 0,
                                          stream);
}

extern "C" int glu_level_run_f64(void* vals, const void* levels, const void* items,
                                 const void* rows, const void* upd, const void* norm,
                                 int n_levels, int max_items, void* stream) {
  return level_run<RealOps<double>, false>(vals, levels, items, rows, upd, norm, nullptr,
                                           nullptr, nullptr, nullptr, n_levels, max_items, 1, 0,
                                           stream);
}

extern "C" int glu_level_run_c64(void* vals, const void* levels, const void* items,
                                 const void* rows, const void* upd, const void* norm,
                                 int n_levels, int max_items, void* stream) {
  return level_run<ComplexOps<float, float2>, false>(vals, levels, items, rows, upd, norm,
                                                     nullptr, nullptr, nullptr, nullptr,
                                                     n_levels, max_items, 1, 0, stream);
}

extern "C" int glu_level_run_c128(void* vals, const void* levels, const void* items,
                                  const void* rows, const void* upd, const void* norm,
                                  int n_levels, int max_items, void* stream) {
  return level_run<ComplexOps<double, double2>, false>(vals, levels, items, rows, upd, norm,
                                                       nullptr, nullptr, nullptr, nullptr,
                                                       n_levels, max_items, 1, 0, stream);
}

// The robust (static-pivot) instantiations: tau is a device scalar of the
// values' real type, count a device int32 the bumps are added into.
extern "C" int glu_level_run_robust_f32(void* vals, const void* levels, const void* items,
                                        const void* rows, const void* upd, const void* norm,
                                        const void* diag_ptr, const void* diag,
                                        const void* tau, void* count, int n_levels,
                                        int max_items, void* stream) {
  return level_run<RealOps<float>, true>(vals, levels, items, rows, upd, norm, diag_ptr,
                                         diag, tau, count, n_levels, max_items, 1, 0, stream);
}

extern "C" int glu_level_run_robust_f64(void* vals, const void* levels, const void* items,
                                        const void* rows, const void* upd, const void* norm,
                                        const void* diag_ptr, const void* diag,
                                        const void* tau, void* count, int n_levels,
                                        int max_items, void* stream) {
  return level_run<RealOps<double>, true>(vals, levels, items, rows, upd, norm, diag_ptr,
                                          diag, tau, count, n_levels, max_items, 1, 0, stream);
}

// Complex values: tau is real (float for c64, double for c128), the bump
// keeps the phase (the reference's _perturb_diags_planar_body).
extern "C" int glu_level_run_robust_c64(void* vals, const void* levels, const void* items,
                                        const void* rows, const void* upd, const void* norm,
                                        const void* diag_ptr, const void* diag,
                                        const void* tau, void* count, int n_levels,
                                        int max_items, void* stream) {
  return level_run<ComplexOps<float, float2>, true>(vals, levels, items, rows, upd, norm,
                                                    diag_ptr, diag, tau, count, n_levels,
                                                    max_items, 1, 0, stream);
}

extern "C" int glu_level_run_robust_c128(void* vals, const void* levels, const void* items,
                                         const void* rows, const void* upd, const void* norm,
                                         const void* diag_ptr, const void* diag,
                                         const void* tau, void* count, int n_levels,
                                         int max_items, void* stream) {
  return level_run<ComplexOps<double, double2>, true>(vals, levels, items, rows, upd, norm,
                                                      diag_ptr, diag, tau, count, n_levels,
                                                      max_items, 1, 0, stream);
}

// A batch of `batch` value arrays that share the run, `stride` values apart
// (the rows of a contiguous (B, stride) tensor): the counterparts of the
// JAX package's level_update_batched_body (kernels/ops.py:86, real values)
// and level_update_planar_batched_body (:173, complex values).
extern "C" int glu_level_run_batched_f32(void* vals, const void* levels, const void* items,
                                         const void* rows, const void* upd, const void* norm,
                                         int n_levels, int max_items, int batch, int stride,
                                         void* stream) {
  return level_run<RealOps<float>, false>(vals, levels, items, rows, upd, norm, nullptr,
                                          nullptr, nullptr, nullptr, n_levels, max_items, batch,
                                          stride, stream);
}

extern "C" int glu_level_run_batched_f64(void* vals, const void* levels, const void* items,
                                         const void* rows, const void* upd, const void* norm,
                                         int n_levels, int max_items, int batch, int stride,
                                         void* stream) {
  return level_run<RealOps<double>, false>(vals, levels, items, rows, upd, norm, nullptr,
                                           nullptr, nullptr, nullptr, n_levels, max_items,
                                           batch, stride, stream);
}

extern "C" int glu_level_run_batched_c64(void* vals, const void* levels, const void* items,
                                         const void* rows, const void* upd, const void* norm,
                                         int n_levels, int max_items, int batch, int stride,
                                         void* stream) {
  return level_run<ComplexOps<float, float2>, false>(vals, levels, items, rows, upd, norm,
                                                     nullptr, nullptr, nullptr, nullptr,
                                                     n_levels, max_items, batch, stride, stream);
}

extern "C" int glu_level_run_batched_c128(void* vals, const void* levels, const void* items,
                                          const void* rows, const void* upd, const void* norm,
                                          int n_levels, int max_items, int batch, int stride,
                                          void* stream) {
  return level_run<ComplexOps<double, double2>, false>(vals, levels, items, rows, upd, norm,
                                                       nullptr, nullptr, nullptr, nullptr,
                                                       n_levels, max_items, batch, stride,
                                                       stream);
}

// Robust and batched: tau holds one threshold a matrix, count one int32 a
// matrix.
extern "C" int glu_level_run_robust_batched_f32(void* vals, const void* levels,
                                                const void* items, const void* rows,
                                                const void* upd, const void* norm,
                                                const void* diag_ptr, const void* diag,
                                                const void* tau, void* count, int n_levels,
                                                int max_items, int batch, int stride,
                                                void* stream) {
  return level_run<RealOps<float>, true>(vals, levels, items, rows, upd, norm, diag_ptr,
                                         diag, tau, count, n_levels, max_items, batch, stride,
                                         stream);
}

extern "C" int glu_level_run_robust_batched_f64(void* vals, const void* levels,
                                                const void* items, const void* rows,
                                                const void* upd, const void* norm,
                                                const void* diag_ptr, const void* diag,
                                                const void* tau, void* count, int n_levels,
                                                int max_items, int batch, int stride,
                                                void* stream) {
  return level_run<RealOps<double>, true>(vals, levels, items, rows, upd, norm, diag_ptr,
                                          diag, tau, count, n_levels, max_items, batch, stride,
                                          stream);
}

extern "C" int glu_level_run_robust_batched_c64(void* vals, const void* levels,
                                                const void* items, const void* rows,
                                                const void* upd, const void* norm,
                                                const void* diag_ptr, const void* diag,
                                                const void* tau, void* count, int n_levels,
                                                int max_items, int batch, int stride,
                                                void* stream) {
  return level_run<ComplexOps<float, float2>, true>(vals, levels, items, rows, upd, norm,
                                                    diag_ptr, diag, tau, count, n_levels,
                                                    max_items, batch, stride, stream);
}

extern "C" int glu_level_run_robust_batched_c128(void* vals, const void* levels,
                                                 const void* items, const void* rows,
                                                 const void* upd, const void* norm,
                                                 const void* diag_ptr, const void* diag,
                                                 const void* tau, void* count, int n_levels,
                                                 int max_items, int batch, int stride,
                                                 void* stream) {
  return level_run<ComplexOps<double, double2>, true>(vals, levels, items, rows, upd, norm,
                                                      diag_ptr, diag, tau, count, n_levels,
                                                      max_items, batch, stride, stream);
}
