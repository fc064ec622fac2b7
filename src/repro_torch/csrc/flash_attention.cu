// flash_attention — blocked online-softmax attention for Hopper.
//
// Replaces the TPU kernel `_attn_kernel` behind
// `repro.kernels.flash_attention.kernel.flash_attention`
// (src/repro/kernels/flash_attention/kernel.py:26-125, pallas_call at
// :106). For q, k, v of shape (B, S, H, hd), heads already GQA-expanded by
// the caller, it computes softmax(q k^T / sqrt(hd) + mask) v per (b, h),
// with a causal mask (kpos <= qpos) and an optional sliding window
// (kpos > qpos - window), as the TPU kernel does:
//   - the running max, the running sum and the accumulator are float32,
//     whatever the input type; masked scores are -1e30 (not -inf), so a
//     row that meets a wholly masked tile first carries a finite running
//     max that the first unmasked tile wipes out (alpha = 0);
//   - kv tiles wholly above the diagonal, or wholly before the window of
//     every row of the q tile, are skipped: the loop runs over
//     [kt_begin, kt_end) only;
//   - the output is acc / max(l, 1e-20), stored in the input type.
// Unlike the TPU kernel it takes any S (the last q and kv tiles are masked;
// the TPU kernel asserts S % 128 == 0) and it keeps p at (near) float32
// precision for the p·v product (the TPU kernel rounds p to the input type
// first; one bfloat16 rounding of p misses the port's rel_rms limit of
// 4e-4 by about five times).
//
// Bound on the H100. At the serving shapes the work is compute: a causal
// (8, 2048, 14, 64) call needs 60 GFLOP against 117 MB of inputs and
// output, 0.061 ms at the bf16 tensor-core peak (989 TFLOP/s) and 0.035 ms
// at 3.35 TB/s; (4, 1024, 16, 128) lies past the line (0.017 ms of
// products, 0.020 ms of bytes).
//
// Two designs; which one runs is a pure function of type and head dim
// (`flash_attention_design`, mirrored by `ops.flash_design` in Python):
//
// * "wgmma", bfloat16 with hd 64 or 128 (qwen2-0.5b and moonshot's serve
//   paths). One block per (b·h, tile of 128 query rows): two consumer
//   warpgroups of 64 rows each and one producer warp. The producer brings
//   the q tile in once and the k and v tiles of 64 rows through a ring of
//   stages (4 at hd = 64, with two blocks an SM; 2 at hd = 128, one block
//   an SM), a full and an empty `mbarrier` a stage, by TMA through 4-D
//   tensor maps over (hd, H, S, B): the block reads (B, S, H, hd) in place,
//   no transpose copy is made, and rows past S come back as zeros (no rows
//   of the next batch element). The 128-byte swizzle; hd = 128 takes two
//   64-column boxes. Each consumer warpgroup, for each kv tile:
//     - S = q·kᵀ with `wgmma.m64n64k16`, A = q and B = k both K-major in
//       shared memory, as they lie; float32 in registers;
//     - the online softmax on that fragment in registers, in the base-2
//       domain (scores times log2(e)/sqrt(hd), `ex2.approx`): the row max
//       over the 4 threads that share a row by shuffles, the masks (causal,
//       window, kpos < Sk) from each thread's fragment coordinates and only
//       on the tiles that need them, the row sums from float32 p, kept per
//       thread and summed across the 4 threads once, at the end;
//     - o += p·v with A = p from registers: the score fragment of a
//       16-column step is, register for register, the A fragment of
//       `wgmma` (d[8kk + 2r], d[8kk + 2r + 1] -> a[r]), so p is converted
//       in place, as p_hi = bf16(p) and p_lo = bf16(p - p_hi), and two
//       `wgmma.m64n{hd}k16` accumulate p_hi·v and p_lo·v into the float32
//       o fragment: p keeps about 16 bits. B = v, N-major as it lies (the
//       transpose-B flag; the leading offset is the distance between
//       64-column boxes).
//   Tiles wholly masked for one warpgroup (the diagonal's last tile for
//   the upper rows, the window's first tiles for the lower ones) are
//   skipped by it. Causal q tiles are launched longest first, so the last
//   wave holds short ones. The epilogue divides by the row sum and stores
//   bfloat16 pairs from registers, masked on S. A failed tensor-map encode
//   or launch returns an error the wrapper raises; a barrier wait of some
//   10 s traps rather than hang the card. Not overlapped yet: the softmax
//   of one warpgroup with its own products, and the epilogue with the next
//   tile's loads; the p·v products run twice (hi and lo), so the tensor
//   cores do 1.5 times the work of one bf16 attention.
// * "simt", float32 (which phase 7 of chip_smoke.py holds in exact
//   float32) and the other head dims (8, 72, 256, ...): the CUDA-core
//   kernel. One block of 256 threads per (b·h, tile of 64 query rows); the
//   q tile and one kv tile at a time staged in shared memory as float32
//   rows of hd + 1 floats; thread (ty, tx) of the 16 × 16 grid owns query
//   rows ty + 16i (i < 4), scores them against kv rows tx + 16j and
//   accumulates output columns tx + 16j; p goes through a 64 × 65 shared
//   tile to the p·v product. Float32 fused multiply-adds on the CUDA cores
//   (67 TFLOP/s peak): about 20 times slower than the "wgmma" design at
//   the bf16 serve shapes.

#include <cuda.h>  // CUtensorMap and its enums; nothing is linked from libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

// ---------------------------------------------------------------------------
// "simt": the CUDA-core kernel (float32, and bfloat16 at other head dims)

namespace simt {


constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdp = kBK + 1;  // padded row of the p tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// max / sum over the 16 threads of one row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

size_t smem_bytes(int hd) {
  return (static_cast<size_t>(kBQ + 2 * kBK) * (hd + 1) + kBQ * kLdp) *
         sizeof(float);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Sq,
                 int Sk, int hd, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;              // kBQ x ld
  float* Ks = Qs + kBQ * ld;     // kBK x ld
  float* Vs = Ks + kBK * ld;     // kBK x ld
  float* Ps = Vs + kBK * ld;     // kBQ x kLdp

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t row = static_cast<int64_t>(H) * hd;  // stride of s
  const T* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * Sk * H + h) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * Sk * H + h) * hd;
  T* ob = o + (static_cast<int64_t>(b) * Sq * H + h) * hd;

  for (int idx = threadIdx.x; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd, s = q0 + r;
    Qs[r * ld + d] = s < Sq ? to_f32(qb[s * row + d]) : 0.0f;
  }

  // kv tiles that hold a visible position for some row of this q tile
  int kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / kBK;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    for (int idx = threadIdx.x; idx < kBK * hd; idx += kThreads) {
      const int r = idx / hd, d = idx - r * hd, s = k0 + r;
      const bool in = s < Sk;
      Ks[r * ld + d] = in ? to_f32(kb[s * row + d]) : 0.0f;
      Vs[r * ld + d] = in ? to_f32(vb[s * row + d]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * kLdp + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the p tile is complete

    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = Vs[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(&ob[s * row + d], acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Sq, int Sk, int hd, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Sk, hd, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Sq, int Sk, int hd, int causal, int window,
              cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 4>(q, k, v, o, B, H, Sq, Sk, hd, causal, window, stream);
  if (hd <= 128)
    return launch<T, 8>(q, k, v, o, B, H, Sq, Sk, hd, causal, window, stream);
  return launch<T, 16>(q, k, v, o, B, H, Sq, Sk, hd, causal, window, stream);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// "wgmma": bfloat16 at hd 64 and 128 on the tensor cores, TMA-fed kv tiles
// in an mbarrier ring

namespace tc {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// A block: NC consumer warpgroups of 64 query rows each and one producer
// warp; kv tiles of BK rows through a ring of STAGES stages. The design's
// own tiles are in `launch_design`; scripts/flash_tile_variants.py times
// others.
template <int HD, int BK, int NC, int STAGES>
struct Tile {
  static constexpr int kBQ = 64 * NC;              // query rows of a block
  static constexpr int kThreads = NC * 128 + 32;
  static constexpr int kBoxes = HD / 64;           // 64-column boxes a row
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = BK * HD * 2;     // the k (or v) of a stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  // 1024 bytes of slack to align q and the ring to the swizzle's 1024-byte
  // atom, then q, the ring, a full and an empty barrier a stage and q's
  static constexpr int kSmemBytes =
      1024 + kQBytes + STAGES * kStageBytes + (2 * STAGES + 1) * 8;
};

// The mbarrier, TMA, descriptor and wgmma helpers below are those of
// csrc/moe_gmm.cu (namespace tc there), with the TMA copy taken to 4-D.

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

// One TMA copy of the box at coordinates (c0, c1, c2, c3) (innermost
// first) of the 4-D tensor map into shared memory at `dst`; its bytes
// complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile at `addr`
// (1024-byte aligned, or a 32-byte step into such a tile along K-major
// rows). K-major (q, k): the leading offset is unused, the stride offset is
// the 1024 bytes from one group of 8 rows to the next. N-major (v): the
// leading offset is the distance between two 64-column boxes, the stride
// offset the 1024 bytes from one group of 8 kv rows to the next.
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

// Keeps the compiler from moving reads or writes of registers across the
// asynchronous products that read or write them.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// The accumulator operands of a warpgroup's m64nN fragment: N / 2 floats
// a thread.
#define F8(d, i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FRAG32(d) F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
#define FRAG64(d) FRAG32(d), F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)

// d (64 x 2F, f32; F floats a thread) = (acc ? d : 0) + A (64 x 16,
// K-major, shared) @ B (16 x 2F, K-major, shared: transpose-B flag 0).
// Templates, so that a shape no tile uses is not compiled.
template <int F>
__device__ __forceinline__ void wgmma_ss(float (&d)[F], uint64_t a,
                                         uint64_t b, int acc) {
  static_assert(F == 32 || F == 64, "m64n64k16 or m64n128k16");
  if constexpr (F == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}"
        : FRAG32(d)
        : "l"(a), "l"(b), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}"
        : FRAG64(d)
        : "l"(a), "l"(b), "r"(acc));
  }
}

// d (64 x 2F, f32) += A (64 x 16, bf16 in registers) @ B (16 x 2F,
// N-major, shared: transpose-B flag 1).
template <int F>
__device__ __forceinline__ void wgmma_rs(float (&d)[F],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(F == 32 || F == 64, "m64n64k16 or m64n128k16");
  if constexpr (F == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
        : FRAG32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
        : FRAG64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

#undef FRAG64
#undef FRAG32
#undef F8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p0, p1 as two bfloat16 pairs whose sum is p to about 16 bits: hi =
// bf16(p), lo = bf16(p - hi) (p - hi is exact in float32). Low halves hold
// p0's parts, high halves p1's.
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const __nv_bfloat162 rest = __floats2bfloat162_rn(p0 - __low2float(h),
                                                    p1 - __high2float(h));
  memcpy(&hi, &h, sizeof(hi));
  memcpy(&lo, &rest, sizeof(lo));
}

// One block per (b·h = blockIdx.x, q tile); the q tile of blockIdx.y runs
// longest first when causal. Warps 0 to 4 NC - 1 are the consumer
// warpgroups, warp 4 NC the producer.
template <int HD, int BK, int NC, int STAGES, int MINB>
__global__ void __launch_bounds__(NC * 128 + 32, MINB)
    flash_wgmma_kernel(__grid_constant__ const CUtensorMap map_q,
                       __grid_constant__ const CUtensorMap map_k,
                       __grid_constant__ const CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o, int H, int Sq, int Sk,
                       float scale_log2, int causal, int window) {
  using T = Tile<HD, BK, NC, STAGES>;
  constexpr int kBQ = T::kBQ, kConsumers = NC, kStages = STAGES;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t ring = q_s + T::kQBytes;
  // full[s] at bars + 8 s: the producer's arrival and the stage's bytes;
  // empty[s] at bars + 8 (kStages + s): one arrival per consumer warp;
  // then q's barrier
  const uint32_t bars = ring + kStages * T::kStageBytes;
  const uint32_t q_bar = bars + 16 * kStages;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;

  // kv tiles that hold a visible position for some row of this q tile
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (min(q0 + kBQ, Sq) - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers * 4);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: one lane issues TMA
    if (lane == 0) {
      mbar_expect_tx(q_bar, T::kQBytes);
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load(q_s + c * kBQ * 128, &map_q, q_bar, 64 * c, h, q0, b);
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int s = it % kStages;
        const uint32_t full = bars + 8 * s;
        if (it >= kStages)  // wait until the consumers released use - 1
          mbar_wait(bars + 8 * (kStages + s), (it / kStages - 1) & 1);
        const uint32_t ks = ring + s * T::kStageBytes, vs = ks + T::kKVBytes;
        mbar_expect_tx(full, T::kStageBytes);
        for (int c = 0; c < T::kBoxes; ++c) {
          tma_load(ks + c * BK * 128, &map_k, full, 64 * c, h, kt * BK, b);
          tma_load(vs + c * BK * 128, &map_v, full, 64 * c, h, kt * BK, b);
        }
      }
    }
    return;
  }

  // the m64nN fragment: d[4j + 2r + i] is row 16 (warp % 4) + lane / 4 +
  // 8 r, column 8 j + 2 (lane % 4) + i of the warpgroup's 64 x N
  const int wg = warp >> 2;
  const int qa = q0 + 64 * wg;  // the first query row of this warpgroup
  const int row0 = qa + 16 * (warp & 3) + (lane >> 2);  // and row0 + 8
  const int col0 = 2 * (lane & 3);
  const uint32_t q_wg = q_s + wg * 64 * 128;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  mbar_wait(q_bar, 0);

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int s = it % kStages;
    mbar_wait(bars + 8 * s, (it / kStages) & 1);
    const int k0 = kt * BK;
    // wholly masked for every row of this warpgroup: nothing to add
    const bool skip = (causal && k0 > qa + 63) ||
                      (window > 0 && k0 + BK - 1 <= qa - window);
    if (!skip) {
      const uint32_t ks = ring + s * T::kStageBytes, vs = ks + T::kKVBytes;
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // 16 deep: 32 bytes of a row
        wgmma_ss(sc,
                 sw128_desc(q_wg + kk / 4 * kBQ * 128 + 32 * (kk % 4), 16,
                            1024),
                 sw128_desc(ks + kk / 4 * BK * 128 + 32 * (kk % 4), 16, 1024),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);

      // scores in the base-2 domain, masked where this tile needs it
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > qa) ||
                          (window > 0 && k0 <= qa + 63 - window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float x = sc[4 * j + 2 * r + i] * scale_log2;
            if (masked) {
              const int kpos = k0 + 8 * j + col0 + i, qpos = row0 + 8 * r;
              bool ok = kpos < Sk;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && kpos > qpos - window;
              x = ok ? x : kNegInf;
            }
            sc[4 * j + 2 * r + i] = x;
            mx[r] = fmaxf(mx[r], x);
          }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 threads of a row: lanes 4g + t
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }

      // p in place of the scores, as the A fragments of the p·v steps:
      // a[r] of step kk packs columns 16 kk + 8 (r / 2) + col0 + {0, 1} of
      // row row0 + 8 (r % 2), which are d[8 kk + 2 r] and d[8 kk + 2 r + 1]
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p0 = ex2(sc[8 * kk + 2 * r] - m[r & 1]);
          const float p1 = ex2(sc[8 * kk + 2 * r + 1] - m[r & 1]);
          l[r & 1] += p0 + p1;
          split_p(p0, p1, p_hi[kk][r], p_lo[kk][r]);
        }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * j + 2 * r] *= alpha[r];
          acc[4 * j + 2 * r + 1] *= alpha[r];
        }

      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // 16 kv rows: 2048 bytes
        const uint64_t vd = sw128_desc(vs + 2048 * kk, BK * 128, 1024);
        wgmma_rs(acc, p_hi[kk], vd);
        wgmma_rs(acc, p_lo[kk], vd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(p_hi);
      fence_operands(p_lo);
    }
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
  }

  const int64_t ld = static_cast<int64_t>(H) * HD;  // stride of s
  __nv_bfloat16* ob =
      o + (static_cast<int64_t>(b) * Sq * H + h) * HD + col0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const float denom = fmaxf(l[r], 1e-20f);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * ld + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom,
                                acc[4 * j + 2 * r + 1] / denom);
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
// library links nothing but the CUDA runtime (as in csrc/moe_gmm.cu).
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

// The 4-D map (hd, H, S, B) of a contiguous (B, S, H, hd) bf16 array, read
// in boxes of (64, 1, rows, 1) with the 128-byte swizzle; outside it reads
// zeros.
int encode(CUtensorMap* map, const void* base, int hd, int H, int S, int B,
           int rows) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(H),
      static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(hd) * H * 2,
                                 static_cast<cuuint64_t>(hd) * H * S * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int HD, int BK, int NC, int STAGES, int MINB>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Sq, int Sk, int causal, int window,
           cudaStream_t stream) {
  using T = Tile<HD, BK, NC, STAGES>;
  const auto kernel = flash_wgmma_kernel<HD, BK, NC, STAGES, MINB>;
  CUtensorMap map_q, map_k, map_v;
  int rc = encode(&map_q, q, HD, H, Sq, B, T::kBQ);
  if (rc == 0) rc = encode(&map_k, k, HD, H, Sk, B, BK);
  if (rc == 0) rc = encode(&map_v, v, HD, H, Sk, B, BK);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(HD)));
  const dim3 grid(B * H, (Sq + T::kBQ - 1) / T::kBQ);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), H, Sq, Sk,
      scale_log2, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// The design's tiles: 64 kv rows a stage and two consumer warpgroups
// (128 query rows) a block at both head dims. At hd 64 the fragments
// (scores, output, p: 96 registers a thread) leave room for two blocks an
// SM, with a ring of 4 stages each; at hd 128 (156 registers) one block,
// 2 stages. Chosen by timing on the H100 (PERF.md §6): BK = 128 at hd 64,
// a third consumer warpgroup, one warpgroup a block, other ring depths
// and BK = 128 at hd 128 (which spills) were no faster.
int launch_design(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int Sq, int Sk, int hd, int causal,
                  int window, cudaStream_t stream) {
  return hd == 64 ? launch<64, 64, 2, 4, 2>(q, k, v, o, B, H, Sq, Sk,
                                             causal, window, stream)
                  : launch<128, 64, 2, 2, 1>(q, k, v, o, B, H, Sq, Sk,
                                              causal, window, stream);
}

}  // namespace tc

}  // namespace

// C interface, loaded with ctypes. q and o are contiguous (B, Sq, H, hd),
// k and v contiguous (B, Sk, H, hd), all of one type: float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1), each 16-byte aligned. hd is a multiple of 8
// from 8 to 256 and B·H at most 65535 (the wrapper checks both). `stream`
// is a cudaStream_t.

// 1 where `flash_attention_launch` runs the "wgmma" design, 0 for "simt".
extern "C" int flash_attention_design(int is_bf16, int hd) {
  return is_bf16 && (hd == 64 || hd == 128);
}

static int bad_shape(int B, int H, int hd) {
  return hd <= 0 || hd > 256 || hd % 8 != 0 || B * H > 65535;
}

static int simt_launch(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Sq, int Sk, int hd, int causal,
                       int window, int is_bf16, cudaStream_t st) {
  return is_bf16 ? simt::launch_hd<__nv_bfloat16>(q, k, v, o, B, H, Sq, Sk,
                                                  hd, causal, window, st)
                 : simt::launch_hd<float>(q, k, v, o, B, H, Sq, Sk, hd,
                                          causal, window, st);
}

// Runs the design `flash_attention_design` names. Returns the cudaError_t
// of the launch (0 on success), 99999 if cuTensorMapEncodeTiled cannot be
// found, or 100000 + its CUresult if it fails.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Sq, int Sk, int hd, int causal,
                                      int window, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (bad_shape(B, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flash_attention_design(is_bf16, hd))
    return tc::launch_design(q, k, v, o, B, H, Sq, Sk, hd, causal, window,
                             st);
  return simt_launch(q, k, v, o, B, H, Sq, Sk, hd, causal, window, is_bf16,
                     st);
}

// The CUDA-core design at any shape: the yardstick chip_smoke.py times
// beside the tensor-core one.
extern "C" int flash_attention_simt_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int H, int Sq, int Sk, int hd,
                                           int causal, int window,
                                           int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (bad_shape(B, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  return simt_launch(q, k, v, o, B, H, Sq, Sk, hd, causal, window, is_bf16,
                     static_cast<cudaStream_t>(stream));
}
