// moe_gmm — the grouped expert matmul of the MoE layer, for Hopper.
//
// Replaces the TPU kernel `_gmm_kernel` behind
// `repro.kernels.moe_gmm.kernel.grouped_matmul`
// (src/repro/kernels/moe_gmm/kernel.py:21-66, pallas_call at :52):
// expert-wise
//     out[e] = x[e] @ w[e],   x (E, C, D), w (E, D, F) -> out (E, C, F),
// with a float32 accumulator over D and the output stored in the input
// type, as the TPU kernel does. Unlike the TPU kernel, which asserts
// C % 128 == 0, D % 512 == 0 and F % 512 == 0, it takes ragged C, D and F
// (moonshot's F = 1408 and a capacity of 480).
//
// Bound on the H100 at moonshot-v1-16b-a3b's serve shapes (bf16). Prefill,
// (64, 480, 2048, 1408) and (64, 480, 1408, 2048), is operations: 177 GFLOP,
// 0.179 ms at the tensor cores' 989 TFLOP/s, with the bytes (580 MB,
// 0.173 ms) close behind. Decode, (64, 8, ...), is bytes: the 369 MB of one
// projection's expert weights, 0.111 ms at 3.35 TB/s.
//
// Two designs; which one runs is a pure function of type and shape
// (`grouped_matmul_design`, mirrored by `ops.gmm_design` in Python):
//
// * "wgmma", bfloat16 with D % 8 == 0 and F % 8 == 0 (TMA wants 16-byte
//   global strides), every moonshot shape. A block computes BM x 128 tiles
//   of out[e] on the tensor cores: BM / 64 consumer warpgroups each run
//   `wgmma.m64n128k16` (bf16 x bf16 -> f32 in registers, 64 floats a
//   thread) on tiles that one producer warp brings into shared memory with
//   TMA, through a ring of 4 stages of (BM x 64 of x, 64 x 128 of w) and a
//   full and an empty `mbarrier` a stage, so the copies of the next three
//   stages run under the products of this one. x is read K-major through
//   a 3-D tensor map (D, C, E), box (64, BM, 1); w is read as it lies,
//   N-major (F contiguous), through a map (F, D, E) in two (64, 64, 1)
//   boxes, and `wgmma` takes it with the transpose-B flag: nothing is
//   copied or transposed per call. Both use the 128-byte swizzle. TMA
//   zero-fills what falls outside the maps, so rows past C (no rows of the
//   next expert), depth past D and columns past F contribute nothing; the
//   epilogue converts the f32 sums to bf16 and stores them from registers
//   with a row and column mask. The grid is persistent (as many blocks as
//   fit on the card, each walking tiles with the C tile fastest, so the
//   blocks that share a w tile run together and w comes from device
//   memory about once, through the 50 MB L2), and the ring runs on from
//   one tile to the next: the producer fills the next tile's stages while
//   the consumers finish and store this one. Prefill (C > 64) takes BM =
//   256, four consumer warpgroups: on the H100 it beat 128 x 128, 128 x
//   256 (m64n256), a ring of 7 stages and a cluster of two blocks sharing
//   x by TMA multicast (PERF.md §6). Decode (C <= 64) takes BM = 64:
//   rows past C are zero-filled by TMA and cost no bytes; the blocks,
//   two an SM, each keep up to 4 stages of w (64 KB) in flight.
// * "simt", float32 and the bf16 shapes TMA cannot take: the CUDA-core
//   kernel. One block of 256 threads per (expert, BM x BN tile); a loop
//   over D in steps of 32 stages x (transposed) and w in shared memory as
//   float32, and each thread sums a (BM/16) x (BN/16) sub-tile in float32
//   fused multiply-adds: exact float32 (no TF32), which phase 7 of
//   chip_smoke.py needs. 64 x 64 tiles for C > 16, 16 x 128 for C <= 16.
//   It runs at the float32 CUDA-core rate (67 TFLOP/s peak) at best.

#include <cuda.h>  // CUtensorMap and its enums; nothing is linked from libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// "simt": the CUDA-core kernel (float32 and TMA-unaligned bfloat16)

namespace simt {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 32;        // depth of one staged tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int C, int D, int F) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int kLdA = BM + 4;  // pad: k-major stores spread over banks
  __shared__ float As[kBK * kLdA];  // As[kk][m] = x[e, c0 + m, d0 + kk]
  __shared__ float Bs[kBK * BN];    // Bs[kk][n] = w[e, d0 + kk, f0 + n]

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* xe = x + static_cast<int64_t>(e) * C * D;
  const T* we = w + static_cast<int64_t>(e) * D * F;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += kBK) {
    // consecutive threads take consecutive d of one x row ...
    for (int idx = threadIdx.x; idx < BM * kBK; idx += kThreads) {
      const int mm = idx / kBK, kk = idx - mm * kBK;
      const int c = c0 + mm, d = d0 + kk;
      As[kk * kLdA + mm] =
          (c < C && d < D) ? to_f32(xe[static_cast<int64_t>(c) * D + d])
                           : 0.0f;
    }
    // ... and consecutive f of one w row
    for (int idx = threadIdx.x; idx < kBK * BN; idx += kThreads) {
      const int kk = idx / BN, nn = idx - kk * BN;
      const int d = d0 + kk, f = f0 + nn;
      Bs[kk * BN + nn] =
          (d < D && f < F) ? to_f32(we[static_cast<int64_t>(d) * F + f])
                           : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk * kLdA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* oe = out + static_cast<int64_t>(e) * C * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx + 16 * j;
      if (f < F) store(&oe[static_cast<int64_t>(c) * F + f], acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN>
int launch_tile(const void* x, const void* w, void* out, int E, int C, int D,
                int F, cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  gmm_kernel<T, BM, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  if (C <= 16) return launch_tile<T, 16, 128>(x, w, out, E, C, D, F, stream);
  return launch_tile<T, 64, 64>(x, w, out, E, C, D, F, stream);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// "wgmma": bfloat16 on the tensor cores, TMA-fed tiles in an mbarrier ring

namespace tc {

constexpr int kBK = 64;  // depth of a stage: 64 bf16 = 128 bytes, the swizzle
constexpr int kBN = 128;  // output columns of a tile: two 64-wide w boxes
constexpr int kStages = 4;
constexpr int kBoxBytes = 64 * 64 * 2;  // one (64 x 64) bf16 box of w

// A tile of BM rows of C: one consumer warpgroup per 64 rows.
template <int BM>
struct Tile {
  static constexpr int kConsumers = BM / 64;  // warpgroups running wgmma
  static constexpr int kThreads = kConsumers * 128 + 32;  // + producer warp
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kStageBytes = kABytes + 2 * kBoxBytes;
  // 1024 bytes of slack to align the ring to the swizzle's 1024-byte atom,
  // then the ring, then a full and an empty barrier a stage
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes
                                    + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
// A wait of some 10 s is a fault of the kernel: it traps (the launch fails
// with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One TMA copy of the box at coordinates (c0, c1, c2) (innermost first) of
// the 3-D tensor map into shared memory at `dst`; its bytes complete on
// `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile at `addr`
// (1024-byte aligned, or a 32-byte step into such a tile along K-major
// rows). K-major (x): the leading offset is unused, the stride offset is
// the 1024 bytes from one group of 8 rows to the next. N-major (w): the
// leading offset is the distance between two 64-column boxes, the stride
// offset the 1024 bytes from one group of 8 depth rows to the next.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         1ull << 62;  // layout type 1: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32, the warpgroup's fragment) += A (64 x 16, K-major) @
// B (16 x 128, N-major: transpose-B flag 1).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Persistent: each block walks the output tiles blockIdx.x, + gridDim.x,
// ... (the C tile fastest, then the F tile, then the expert); the ring and
// its phases run on across tiles, so the producer fills the next tile's
// stages while the consumers finish and store the last one.
template <int BM>
__global__ void __launch_bounds__(Tile<BM>::kThreads, 1)
    gmm_wgmma_kernel(__grid_constant__ const CUtensorMap map_x,
                     __grid_constant__ const CUtensorMap map_w,
                     __nv_bfloat16* __restrict__ out, int C, int D, int F,
                     int E) {
  using T = Tile<BM>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t ring = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t bars = ring + kStages * T::kStageBytes;
  const int tiles_c = (C + BM - 1) / BM, tiles_f = (F + kBN - 1) / kBN;
  const int n_tiles = tiles_c * tiles_f * E;
  const int n_k = (D + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // full[s] at bars + 8 s: the producer's arrival and the stage's bytes;
  // empty[s] at bars + 8 (kStages + s): one arrival per consumer warp
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), T::kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == T::kConsumers * 4) {  // the producer warp: one lane issues TMA
    if (lane == 0) {
      int it = 0;  // stage uses so far, over all of this block's tiles
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int c0 = t % tiles_c * BM;
        const int n0 = t / tiles_c % tiles_f * kBN, e = t / tiles_c / tiles_f;
        for (int k = 0; k < n_k; ++k, ++it) {
          const int s = it % kStages;
          const uint32_t full = bars + 8 * s;
          if (it >= kStages)  // wait until the consumers released use - 1
            mbar_wait(bars + 8 * (kStages + s), (it / kStages - 1) & 1);
          const uint32_t a = ring + s * T::kStageBytes, b = a + T::kABytes;
          mbar_expect_tx(full, T::kStageBytes);
          tma_load(a, &map_x, full, k * kBK, c0, e);
          tma_load(b, &map_w, full, n0, k * kBK, e);
          tma_load(b + kBoxBytes, &map_w, full, n0 + 64, k * kBK, e);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // this warpgroup's 64 rows of a tile
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    fence_operands(d);
    for (int k = 0; k < n_k; ++k, ++it) {
      const int s = it % kStages;
      mbar_wait(bars + 8 * s, (it / kStages) & 1);
      const uint32_t a = ring + s * T::kStageBytes + wg * 64 * kBK * 2;
      const uint32_t b = ring + s * T::kStageBytes + T::kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // 16 deep: 32 bytes, 16 rows
        wgmma_m64n128k16(d, sw128_desc(a + 32 * kk, 16, 1024),
                         sw128_desc(b + 2048 * kk, kBoxBytes, 1024));
      wgmma_commit();
      // the products of the previous use are done: release its stage
      wgmma_wait<1>();
      if (k > 0 && lane == 0)
        mbar_arrive(bars + 8 * (kStages + (it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_operands(d);
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + (it - 1) % kStages));

    // the m64n128 fragment: d[4j + 2h + i] is row 16 (warp % 4) + lane / 4
    // + 8 h, column 8 j + 2 (lane % 4) + i of the warpgroup's 64 x 128
    const int e = t / tiles_c / tiles_f;
    __nv_bfloat16* oe = out + static_cast<int64_t>(e) * C * F;
    const int r0 = t % tiles_c * BM + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int f0 = t / tiles_c % tiles_f * kBN + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int f = f0 + 8 * j;  // F is even, so f < F means f + 1 < F too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < C && f < F)
          *reinterpret_cast<__nv_bfloat162*>(
              oe + static_cast<int64_t>(r) * F + f) =
              __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
}

// Return codes beyond cudaError_t: the encoder could not be found, or
// kEncodeFailed + the CUresult of cuTensorMapEncodeTiled.
constexpr int kNoEncoder = 99999;
constexpr int kEncodeFailed = 100000;

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links nothing but the CUDA runtime.
EncodeFn encoder() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// The 3-D map of a contiguous (E, rows, inner) bf16 array, read in boxes
// of (64, box_rows, 1) with the 128-byte swizzle; outside it reads zeros.
int encode(CUtensorMap* map, const void* base, int inner, int rows, int E,
           int box_rows) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * rows * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int BM>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  using T = Tile<BM>;
  CUtensorMap map_x, map_w;
  int rc = encode(&map_x, x, D, C, E, BM);
  if (rc == 0) rc = encode(&map_w, w, F, D, E, 64);
  if (rc != 0) return rc;
  // once per device: opt in to the shared memory, and find how many
  // blocks fit on the card at once
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(gmm_wgmma_kernel<BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gmm_wgmma_kernel<BM>, T::kThreads, T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms * per_sm <= 0) return static_cast<int>(cudaErrorInvalidValue);
    resident[dev] = sms * per_sm;
  }
  const int64_t n_tiles = static_cast<int64_t>((C + BM - 1) / BM) *
                          ((F + kBN - 1) / kBN) * E;
  if (n_tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(
      n_tiles < resident[dev] ? n_tiles : resident[dev]);
  gmm_wgmma_kernel<BM><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      map_x, map_w, static_cast<__nv_bfloat16*>(out), C, D, F, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

bool bad_grid(int E, int C, int F) {
  return E > 65535 || (C + 15) / 16 > 65535 ||
         (F + tc::kBN - 1) / tc::kBN > 65535;
}

}  // namespace

// C interface, loaded with ctypes. x is contiguous (E, C, D), w contiguous
// (E, D, F), out contiguous (E, C, F), all of one type: float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1), each 16-byte aligned. E,
// ceil(C / 16) and ceil(F / 128) are at most 65535 (the wrapper checks).
// `stream` is a cudaStream_t.

// 1 where `grouped_matmul_launch` runs the "wgmma" design, 0 for "simt".
extern "C" int grouped_matmul_design(int is_bf16, int D, int F) {
  return is_bf16 && D > 0 && D % 8 == 0 && F % 8 == 0;
}

// Runs the design `grouped_matmul_design` names. Returns the cudaError_t
// of the launch (0 on success), 99999 if cuTensorMapEncodeTiled cannot be
// found, or 100000 + its CUresult if it fails.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out,
                                     int E, int C, int D, int F, int is_bf16,
                                     void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (bad_grid(E, C, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grouped_matmul_design(is_bf16, D, F))
    return C <= 64 ? tc::launch<64>(x, w, out, E, C, D, F, st)
                   : tc::launch<256>(x, w, out, E, C, D, F, st);
  return is_bf16 ? simt::launch<__nv_bfloat16>(x, w, out, E, C, D, F, st)
                 : simt::launch<float>(x, w, out, E, C, D, F, st);
}

// The CUDA-core design at any shape: the yardstick chip_smoke.py times
// beside the tensor-core one.
extern "C" int grouped_matmul_simt_launch(const void* x, const void* w,
                                          void* out, int E, int C, int D,
                                          int F, int is_bf16, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (bad_grid(E, C, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? simt::launch<__nv_bfloat16>(x, w, out, E, C, D, F, st)
                 : simt::launch<float>(x, w, out, E, C, D, F, st);
}
