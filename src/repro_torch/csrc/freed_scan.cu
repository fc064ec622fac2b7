// freed_scan — the EASY-reservation scan of the fleet simulator, for Hopper.
//
// Replaces the TPU kernel `_freed_sorted_kernel` behind
// `repro.xsim.backfill.freed_matrix` (src/repro/xsim/backfill.py:98-154).
// For each scenario row b and each job slot i it computes
//     freed[b, i] = sum of cores of running jobs ending at or before end[b, i]
// on rows that the caller has already masked (non-running slots carry
// end = +inf, cores = 0) and sorted by end time (stable), as the reference
// leaves its sort to XLA outside the Pallas body:
//   1. inclusive cores cumsum over the sorted row;
//   2. is_last[k] = (end_s[k] != end_s[k+1]), the last slot of a tie run;
//   3. freed_s[k] = min over is_last positions j >= k of cumsum[j]
//      (a suffix-min: cumsum is nondecreasing, so this is the cumsum at the
//      last slot of k's tie run);
//   4. freed[b, order[b, k]] = freed_s[k]: the scatter back through the
//      sort permutation is fused into the store, which removes the
//      reference's second argsort (backfill.py:153).
// Core counts are integers below 2**24, so every sum is exact and the
// result is bitwise equal to the plain version whatever the order of the
// additions.
//
// Design. One block per row, so no carry crosses blocks. The row's sorted
// ends and the cumsum live in shared memory (8 bytes a slot, dynamic). Each
// thread owns a run of ceil(N / blockDim) consecutive slots; the block scan
// over the threads' partial results is written by hand with warp shuffles
// and one shared array of warp totals (no CUB). The suffix-min is the same
// scan run in reverse thread order with min. N may be any size from 1 up
// to what shared memory holds (29,056 slots at 227 KB; the launcher raises
// the dynamic shared-memory limit above 48 KB).
//
// Bound on the H100. The work is O(N) adds and mins per row; the function
// is bound by bytes: it reads end_s and cores_s (4 + 4 B) and the int64
// sort order (8 B) and writes freed (4 B), 20 B a slot, so a (1026, 53)
// table moves about 1.1 MB, about 0.3 us at 3.35 TB/s. At the shapes the
// simulator uses the launch itself (a few microseconds) costs more than
// that work; the kernel does not hide it, and PERF.md records its time
// beside the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;

struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

// Inclusive scan within a warp, in lane order (kReverse = false) or in
// reverse lane order (kReverse = true).
template <bool kReverse, class Op>
__device__ float warp_inclusive(float x, Op op, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float y = kReverse ? __shfl_down_sync(kFull, x, off)
                       : __shfl_up_sync(kFull, x, off);
    bool take = kReverse ? (lane + off < 32) : (lane >= off);
    if (take) x = op(y, x);
  }
  return x;
}

// Exclusive scan of one value per thread over the block, in thread order
// or in reverse thread order. blockDim.x is a multiple of 32. `warp_buf`
// holds 32 floats of shared memory; the call ends with a barrier so the
// buffer may be reused.
template <bool kReverse, class Op>
__device__ float block_exclusive(float v, Op op, float identity,
                                 float* warp_buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float incl = warp_inclusive<kReverse>(v, op, lane);
  if (lane == (kReverse ? 0 : 31)) warp_buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? warp_buf[lane] : identity;
    float wi = warp_inclusive<kReverse>(w, op, lane);
    float wx = kReverse ? __shfl_down_sync(kFull, wi, 1)
                        : __shfl_up_sync(kFull, wi, 1);
    if (lane == (kReverse ? 31 : 0)) wx = identity;
    if (lane < n_warps) warp_buf[lane] = wx;   // exclusive over warps
  }
  __syncthreads();
  float warp_prefix = warp_buf[warp];
  float lx = kReverse ? __shfl_down_sync(kFull, incl, 1)
                      : __shfl_up_sync(kFull, incl, 1);
  if (lane == (kReverse ? 31 : 0)) lx = identity;
  __syncthreads();
  return op(warp_prefix, lx);
}

__global__ void freed_scan_kernel(const float* __restrict__ ends_sorted,
                                  const float* __restrict__ cores_sorted,
                                  const int64_t* __restrict__ order,
                                  float* __restrict__ freed, int n) {
  extern __shared__ float smem[];
  __shared__ float warp_buf[32];
  float* e = smem;        // sorted ends
  float* cs = smem + n;   // cores, then their inclusive cumsum
  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    e[i] = ends_sorted[base + i];
    cs[i] = cores_sorted[base + i];
  }
  __syncthreads();

  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n);
  const int hi = min(lo + per, n);

  // 1. inclusive cumsum of cores
  float part = 0.0f;
  for (int i = lo; i < hi; ++i) part += cs[i];
  float run = block_exclusive<false>(part, SumOp(), 0.0f, warp_buf);
  for (int i = lo; i < hi; ++i) {
    run += cs[i];
    cs[i] = run;
  }
  __syncthreads();

  // 2-3. suffix-min of the cumsum over the last slot of each tie run
  auto is_last = [&](int i) {
    return i + 1 < n ? e[i] != e[i + 1] : e[i] != -INFINITY;
  };
  float m = INFINITY;
  for (int i = lo; i < hi; ++i)
    if (is_last(i)) m = fminf(m, cs[i]);
  float acc = block_exclusive<true>(m, MinOp(), INFINITY, warp_buf);

  // 4. store through the sort permutation
  for (int i = hi - 1; i >= lo; --i) {
    if (is_last(i)) acc = fminf(acc, cs[i]);
    freed[base + order[base + i]] = acc;
  }
}

}  // namespace

// C interface, loaded with ctypes. All pointers are device pointers of
// contiguous (rows, n) tensors; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int freed_scan_launch(const float* ends_sorted,
                                 const float* cores_sorted,
                                 const int64_t* order, float* freed, int rows,
                                 int n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        freed_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  freed_scan_kernel<<<rows, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      ends_sorted, cores_sorted, order, freed, n);
  return static_cast<int>(cudaGetLastError());
}
