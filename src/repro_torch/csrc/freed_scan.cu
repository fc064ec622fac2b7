// freed_scan — the EASY-reservation scan of the fleet simulator, for Hopper.
//
// Replaces the TPU kernel `_freed_sorted_kernel` behind
// `repro.xsim.backfill.freed_matrix` (src/repro/xsim/backfill.py:98-154).
// For each scenario row b and each job slot i it computes
//     freed[b, i] = Σ_j [running_j ∧ end_j ≤ end_i] cores_j,
// where a slot that is not running counts as end = +inf, cores = 0 (so it
// gets the row's whole running total). Core counts are integers below
// 2**24, so every partial sum is exact and the result is bitwise equal to
// the plain versions whatever the order of the additions. Ends are never
// NaN (+inf until a job starts, start + duration after).
//
// Two designs; which one runs is a pure function of the row length n
// (`freed_design`, mirrored by `backfill.freed_design` in Python):
//
// * "fused", n <= 16384: the whole function in one launch on the raw
//   tables (ends and cores float32, the running mask bool), one row in
//   shared memory:
//   1. load and compact: the row is read once, coalesced, a few rounds of
//      blockDim slots each issued before the first is used; each warp
//      takes a `__ballot_sync` of its running slots, and a prefix of the
//      warps' `__popc` counts gives each running slot its compacted index
//      k in slot order. Entry k holds the 64-bit word
//      (order-preserving uint32 key of the end) << 32 | k, and the cores
//      in a float array at k. The key maps -0.0 to +0.0 first: the two
//      compare equal and must fall in one tie run. R, the number of
//      running slots, is known after this step;
//   2. sort only the R words, padded with ~0 to a power of two (at least
//      64), with a bitonic network. The words are distinct (k is in the
//      low bits), so the order is total; stability is not needed, since
//      the value a tie run takes is the cumsum at its last position
//      whatever the order inside it. The stages whose partners lie within
//      a 64-word segment run in registers, a warp a segment (two words a
//      lane, partners by `__shfl_xor_sync`); only the stages with partners
//      64 or more apart go through shared memory between barriers;
//   3. the inclusive cumsum of the cores in sorted order and, for every
//      position, the cumsum at the last position of its tie run (ends
//      decoded from the keys and compared as floats): each thread owns a
//      run of consecutive positions, an exclusive scan over the threads
//      gives its prefix, a reverse scan (min) over the threads gives the
//      cumsum at the first run end after its positions, and the thread
//      walks its positions backwards (subtracting cores is exact), writing
//      each value over the cores at the entry's k;
//   4. write freed in slot order, coalesced: a running slot reads its
//      entry's value at k (the same ballot prefix, kept from step 1), any
//      other slot the row's running total (0 when R = 0).
//   Shared memory: 8 bytes a word for the padded power of two and 4 a
//   slot for cores, then values: at most 8·16384 + 4·16384 = 196608 bytes
//   of the 227 KB a block may hold, which sets the limit. Rows of up to
//   128 slots take one warp each, four rows a block, with `__syncwarp`
//   alone; longer rows take a block of ceil(n / 4) threads (rounded to
//   warps, at most 1024). Both layouts and 2 or 8 slots a thread were
//   timed on the H100 (scripts/freed_time.py; PERF.md): these were the
//   fastest at the grids' shapes.
// * "presorted", any n up to 29056: the first design, the TPU kernel's own
//   contract. The caller masks (non-running: end +inf, cores 0) and
//   stable-sorts each row by end outside the kernel, as the reference
//   leaves its sort to XLA; one block a row takes the inclusive cumsum, the
//   last slot of each tie run (end_s[k] != end_s[k+1]) and a suffix-min of
//   the cumsum over those slots, and stores through the int64 sort
//   permutation, which fuses the reference's second argsort
//   (backfill.py:153) into the store. Sorted ends and cumsum in shared
//   memory, 8 bytes a slot.
//
// Block scans are written by hand with warp shuffles and a shared array of
// warp totals (no CUB).
//
// Bound on the H100. The work is O(n log n) compares and O(n) adds a row;
// the function is bound by bytes. "fused" reads ends, cores and the mask
// (4 + 4 + 1 B) and writes freed (4 B), 13 B a slot: about 3.2 MB at the
// main path's (108, 2313), 0.00097 ms at 3.35 TB/s. "presorted" moves 20 B
// a slot (sorted ends and cores, the int64 order, freed) besides the
// sort's own traffic. At these sizes a launch costs more than the bytes:
// PERF.md records each design's time beside the bound.

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
// or in reverse thread order; `*total` (if given) receives the scan of all
// threads. blockDim.x is a multiple of 32. `warp_buf` holds 33 floats of
// shared memory; the call ends with a barrier so the buffer may be reused.
template <bool kReverse, class Op>
__device__ float block_exclusive(float v, Op op, float identity,
                                 float* warp_buf, float* total = nullptr) {
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
    if (lane == (kReverse ? 0 : 31)) warp_buf[32] = wi;   // all warps
  }
  __syncthreads();
  float warp_prefix = warp_buf[warp];
  if (total != nullptr) *total = warp_buf[32];
  float lx = kReverse ? __shfl_down_sync(kFull, incl, 1)
                      : __shfl_up_sync(kFull, incl, 1);
  if (lane == (kReverse ? 31 : 0)) lx = identity;
  __syncthreads();
  return op(warp_prefix, lx);
}

// ------------------------------------------------------------ "presorted"
__global__ void freed_scan_kernel(const float* __restrict__ ends_sorted,
                                  const float* __restrict__ cores_sorted,
                                  const int64_t* __restrict__ order,
                                  float* __restrict__ freed, int n) {
  extern __shared__ float smem[];
  __shared__ float warp_buf[33];
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

// ---------------------------------------------------------------- "fused"
constexpr int kFusedMaxN = 16384;     // shared memory: 12 bytes a slot
constexpr int kWarpRowMaxN = 128;     // rows this short take one warp
constexpr int kWarpRowsPerBlock = 4;
constexpr int kMaxRounds = 16;        // slot rounds of a row: n <= 16·1024
constexpr int kAhead = 4;             // rounds loaded before the first use

// Order-preserving map of a float onto uint32 (a < b ⇔ key(a) < key(b)
// for non-NaN floats), with -0.0 sent to +0.0's key, and its inverse.
__device__ __forceinline__ uint32_t end_key(float x) {
  const uint32_t u = x == 0.0f ? 0u : __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_end(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Stages (k, j) for j = min(k / 2, 32) down to 1 of the bitonic network on
// one 64-word segment held by a warp: x0 is word p0 = 64s + lane, x1 word
// p0 + 32. The pair of j = 32 lies within a thread; for j <= 16 a lane
// takes its partner's word by shuffle and keeps the lesser where it holds
// the lower index of an ascending pair or the higher of a descending one.
__device__ __forceinline__ void segment_stages(uint64_t& x0, uint64_t& x1,
                                               int p0, int k, int lane) {
  if (k >= 64) {
    const uint64_t a = x0, b = x1;
    const bool swap = (a > b) == ((p0 & k) == 0);
    x0 = swap ? b : a;
    x1 = swap ? a : b;
  }
  for (int j = (k >= 64 ? 32 : k) >> 1; j > 0; j >>= 1) {
    const bool lower = (lane & j) == 0;
    const uint64_t y0 = __shfl_xor_sync(kFull, x0, j);
    const uint64_t y1 = __shfl_xor_sync(kFull, x1, j);
    const bool min0 = lower == ((p0 & k) == 0);
    const bool min1 = lower == (((p0 + 32) & k) == 0);
    x0 = min0 == (y0 < x0) ? y0 : x0;
    x1 = min1 == (y1 < x1) ? y1 : x1;
  }
}

// The threads that own one row: one warp (kWarpRow) or the whole block.
template <bool kWarpRow>
struct Group {
  int t;      // rank in the group
  int size;   // threads in the group
  __device__ void sync() const {
    if (kWarpRow) __syncwarp(); else __syncthreads();
  }
  // exclusive scan over the group in rank order (kReverse: reverse rank
  // order); `*total` (if given) receives the scan of the whole group
  template <bool kReverse, class Op>
  __device__ float exclusive(float v, Op op, float identity, float* buf,
                             float* total = nullptr) const {
    if (!kWarpRow)
      return block_exclusive<kReverse>(v, op, identity, buf, total);
    const int lane = threadIdx.x & 31;
    float incl = warp_inclusive<kReverse>(v, op, lane);
    if (total != nullptr)
      *total = __shfl_sync(kFull, incl, kReverse ? 0 : 31);
    float x = kReverse ? __shfl_down_sync(kFull, incl, 1)
                       : __shfl_up_sync(kFull, incl, 1);
    return lane == (kReverse ? 31 : 0) ? identity : x;
  }
};

template <bool kWarpRow>
__global__ void __launch_bounds__(kMaxThreads)
freed_scan_fused_kernel(const float* __restrict__ ends,
                        const float* __restrict__ cores,
                        const unsigned char* __restrict__ running,
                        float* __restrict__ freed, int rows, int n,
                        int p_max) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float scan_buf[33];
  __shared__ int warp_cnt[2][32];
  __shared__ int round_base[kMaxRounds][32];   // [round][warp]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = kWarpRow ? blockIdx.x * (blockDim.x >> 5) + warp
                           : blockIdx.x;
  if (row >= rows) return;   // whole warps, and only where rows are warps
  const Group<kWarpRow> g{kWarpRow ? lane : static_cast<int>(threadIdx.x),
                          kWarpRow ? 32 : static_cast<int>(blockDim.x)};
  const unsigned lanes_below = (1u << lane) - 1u;

  const size_t slice = 8 * static_cast<size_t>(p_max) + 4 * ((n + 1) & ~1);
  unsigned char* mine = smem_raw + (kWarpRow ? warp * slice : 0);
  uint64_t* words = reinterpret_cast<uint64_t*>(mine);
  float* cv = reinterpret_cast<float*>(mine + 8 * static_cast<size_t>(p_max));
  const size_t off = static_cast<size_t>(row) * n;
  const float* e_row = ends + off;
  const float* c_row = cores + off;
  const unsigned char* r_row = running + off;

  // 1. load and compact, in slot order
  const int rounds = (n + g.size - 1) / g.size;
  uint32_t run_bits = 0;   // bit q: this thread's slot of round q runs
  int total_r = 0;         // running slots of the rounds so far
  for (int q0 = 0; q0 < rounds; q0 += kAhead) {
    float e_v[kAhead], c_v[kAhead];
    bool r_v[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int i = (q0 + a) * g.size + g.t;
      const bool in = i < n;
      r_v[a] = in && r_row[in ? i : 0] != 0;
      e_v[a] = in ? e_row[i] : 0.0f;
      c_v[a] = in ? c_row[i] : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int q = q0 + a;
      if (q >= rounds) break;   // the same for the whole group
      const unsigned ballot = __ballot_sync(kFull, r_v[a]);
      int base;   // this warp's first compacted index in round q
      if (kWarpRow) {
        base = total_r;
        total_r += __popc(ballot);
      } else {
        const int n_warps = blockDim.x >> 5;
        if (lane == 0) warp_cnt[q & 1][warp] = __popc(ballot);
        __syncthreads();   // warp_cnt[q & 1] is rewritten two rounds on
        const int v = lane < n_warps ? warp_cnt[q & 1][lane] : 0;
        int incl = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        base = total_r + __shfl_sync(kFull, incl - v, warp);
        total_r += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) round_base[q][warp] = base;
      if (r_v[a]) {
        const int k = base + __popc(ballot & lanes_below);
        words[k] = (static_cast<uint64_t>(end_key(e_v[a])) << 32) |
                   static_cast<uint32_t>(k);
        cv[k] = c_v[a];
      }
      run_bits |= static_cast<uint32_t>(r_v[a]) << q;
    }
  }
  const int R = total_r;
  // the sort's length: R padded with ~0 to a power of two of at least one
  // segment of 64 words, or nothing when there is nothing to sort
  int P = R > 1 ? 64 : R;
  while (P < R) P <<= 1;
  for (int k = R + g.t; k < P; k += g.size) words[k] = ~0ull;
  g.sync();

  // 2. bitonic sort of words[0, P), ascending: stage (k, j) compares words
  // i and i + j for every i with i & j == 0, ascending where i & k == 0.
  // Stages with j <= 32 stay within 64-word segments: a warp takes a
  // segment into registers (lane l holds words 64s + l and 64s + 32 + l),
  // runs them (j = 32 within a thread, j <= 16 by shuffles) and stores it
  // back; the first pass (k = 64) sorts each segment whole. Stages with
  // j >= 64 run in shared memory between group barriers.
  const int seg_warp = kWarpRow ? 0 : warp;
  const int seg_warps = kWarpRow ? 1 : blockDim.x >> 5;
  for (int k = 64; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int p = g.t; p < P / 2; p += g.size) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const uint64_t a = words[i];
        const uint64_t b = words[i + j];
        if ((a > b) == ((i & k) == 0)) {
          words[i] = b;
          words[i + j] = a;
        }
      }
      g.sync();
    }
    for (int s = seg_warp; s < P / 64; s += seg_warps) {
      uint64_t* seg = words + 64 * s;
      uint64_t x0 = seg[lane], x1 = seg[32 + lane];
      for (int kk = k == 64 ? 2 : k; kk <= k; kk <<= 1)
        segment_stages(x0, x1, 64 * s + lane, kk, lane);
      seg[lane] = x0;
      seg[32 + lane] = x1;
    }
    g.sync();
  }

  // 3. cumsum in sorted order, and the cumsum at the end of each tie run
  const int per = (R + g.size - 1) / g.size;
  const int lo = min(g.t * per, R);
  const int hi = min(lo + per, R);
  auto entry = [&](int i) { return static_cast<uint32_t>(words[i]); };
  auto is_last = [&](int i) {
    return i + 1 == R || key_end(static_cast<uint32_t>(words[i] >> 32)) !=
                             key_end(static_cast<uint32_t>(words[i + 1] >> 32));
  };
  float part = 0.0f;
  for (int i = lo; i < hi; ++i) part += cv[entry(i)];
  float total_c;   // the row's running cores
  const float pre = g.template exclusive<false>(part, SumOp(), 0.0f,
                                                scan_buf, &total_c);
  float first_end = INFINITY;   // the cumsum at my first run end
  float csum = pre;
  for (int i = lo; i < hi; ++i) {
    csum += cv[entry(i)];
    if (is_last(i)) {
      first_end = csum;
      break;
    }
  }
  // the cumsum at the first run end after my positions (it is the least,
  // the cumsum being nondecreasing)
  float acc = g.template exclusive<true>(first_end, MinOp(), INFINITY,
                                         scan_buf);
  g.sync();   // every thread has read the cores it scans
  csum = pre + part;
  for (int i = hi - 1; i >= lo; --i) {
    if (is_last(i)) acc = csum;
    const uint32_t k = entry(i);
    csum -= cv[k];
    cv[k] = acc;
  }
  g.sync();

  // 4. freed in slot order
  for (int q = 0; q < rounds; ++q) {
    const bool run = (run_bits >> q) & 1u;
    const unsigned ballot = __ballot_sync(kFull, run);
    const int i = q * g.size + g.t;
    if (i < n)
      freed[off + i] =
          run ? cv[round_base[q][warp] + __popc(ballot & lanes_below)]
              : total_c;
  }
}

// Dynamic shared memory of a "fused" block over rows of n slots.
size_t fused_smem(int n, int p_max, int rows_per_block) {
  return (8 * static_cast<size_t>(p_max) + 4 * ((n + 1) & ~1)) *
         rows_per_block;
}

// Launch "fused" with a warp a row (kWarpRow, `rows_per_block` rows a
// block) or a block a row (of about n / slots_per_thread threads).
template <bool kWarpRow>
int fused_launch(const float* ends, const float* cores,
                 const unsigned char* running, float* freed, int rows, int n,
                 cudaStream_t stream, int rows_per_block = kWarpRowsPerBlock,
                 int slots_per_thread = 4) {
  int p_max = 64;   // the sort's longest padded length
  while (p_max < n) p_max <<= 1;
  if (!kWarpRow) rows_per_block = 1;
  int threads = 32 * rows_per_block;
  if (!kWarpRow) {
    threads = ((n + slots_per_thread - 1) / slots_per_thread + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
  }
  const size_t smem = fused_smem(n, p_max, rows_per_block);
  if ((kWarpRow && (n > kWarpRowMaxN || threads > kMaxThreads)) ||
      n > kFusedMaxN || (n + threads - 1) / threads > kMaxRounds)
    return static_cast<int>(cudaErrorInvalidValue);
  // once per device: opt in to the most shared memory a block may hold
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, freed_scan_fused_kernel<kWarpRow>);
    int optin = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(freed_scan_fused_kernel<kWarpRow>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  freed_scan_fused_kernel<kWarpRow><<<blocks, threads, smem, stream>>>(
      ends, cores, running, freed, rows, n, p_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. All pointers are device pointers of
// contiguous (rows, n) tensors; `stream` is a cudaStream_t. The launchers
// return the cudaError_t of the launch (0 on success).

// 1 if the "fused" design takes rows of n slots, else 0 ("presorted").
extern "C" int freed_design(int n) { return n >= 1 && n <= kFusedMaxN; }

// "fused": the raw tables (ends, cores float32; running bool) -> freed.
extern "C" int freed_fused_launch(const float* ends, const float* cores,
                                  const unsigned char* running, float* freed,
                                  int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (!freed_design(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kWarpRowMaxN)
    return fused_launch<true>(ends, cores, running, freed, rows, n, st);
  return fused_launch<false>(ends, cores, running, freed, rows, n, st);
}

// "presorted": masked rows sorted by end and their int64 sort order ->
// freed in slot order.
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
