// wkv6 — the chunked WKV6 linear recurrence of RWKV-6 for Hopper.
//
// Replaces the TPU kernel `_wkv_kernel` behind
// `repro.kernels.rwkv6_scan.kernel.wkv6`
// (src/repro/kernels/rwkv6_scan/kernel.py:24-110). For r, k, v, w of shape
// (B, S, H, K) (the value dim equals K) and u (H, K) it computes, per (b, h),
//   o_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t),  S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
// in chunks of c steps, as the TPU kernel does. Per chunk, with
// lw = log(clip(w, 1e-12, 1)), cum its inclusive sum over the chunk and
// cum_excl = cum - lw:
//   - the pair term att[t][s] = Σ_k r_tk k_sk exp(cum_excl_tk − cum_sk) for
//     s < t (the exponent is ≤ 0 under the mask, so strong decays cannot
//     overflow it);
//   - o = att @ v + (r ⊙ exp(cum_excl)) @ S + (Σ_k r u k) v, stored in r's
//     type, with S the state BEFORE this chunk;
//   - then S' = exp(cum_end) ⊙ S + (k ⊙ exp(cum_end − cum))ᵀ v.
// The state is float32 throughout. Unlike the TPU kernel, which starts from
// a zero state (its wrapper folds a carried state in by linearity), this
// kernel starts from `state0` itself (zeros when it is null); the two are
// equal in exact arithmetic. It takes any chunk length from 1 to 128 that
// divides S (a ragged prompt's tail block has its own).
//
// Bound on the H100. At the serving shape (8, 2048, 40, 64) in bf16 the
// call must move r, k, v and out (bf16), w (f32) and the state, about
// 509 MB: 0.15 ms at 3.35 TB/s, above its operations at the bf16 tensor-
// core rate.
//
// Two designs; which one runs is a pure function of type, head dim and
// chunk length (`wkv6_design`, mirrored by `ops.wkv6_design` in Python):
//
// * "mma", bfloat16 r, k, v at K = 64 with any chunk of 1 to 128 steps
//   (rwkv6-3b's prefill, chunk 128, and a ragged prompt's tail block).
//   Two kernels, each one block per (chunk, b·h): 5120 blocks at the
//   serving shape.
//   - the state pass: the chunk's own contribution to the state, U =
//     Σ_s (k_s ⊙ exp(cum_end − cum_s)) ⊗ v_s, and its decay E =
//     exp(cum_end), with the "simt" design's arithmetic operation for
//     operation (log w, the cumulative sum in time order, expf, the
//     sequential FMA over the chunk's steps from zero); then S' = E·S + U
//     from the state the block of the chunk before hands over (a flag in
//     global memory; blocks take chunk-major tickets from a counter, so
//     the block waited for started earlier), written as "simt" writes
//     it. It leaves the state before each chunk in a float32 scratch
//     (B·H, chunks, K, K) and the final state, bitwise that of "simt";
//   - the output pass, 8 warps a block, two blocks an SM (115712 bytes
//     of shared memory each), the blocks independent of each other. r, k,
//     v (bf16) and w (f32) arrive by TMA through 4-D tensor maps over
//     (K, H, S, B), read in place with the 128-byte swizzle (no
//     transpose copy; rows past S read zeros, rows past the chunk are
//     masked); the state the chunk reads is prefetched into L2. The
//     block recomputes cum in time order, as the state pass does, and
//     cum_excl = cum − log w, then warp i takes the sub-chunk of L = 16
//     steps [16i, 16i + 16):
//       . the pair term against each earlier sub-chunk j < i, factored
//         around the sub-chunk's boundary B_i = cum_excl at its first step:
//         exp(cum_excl_t − cum_s) = exp(cum_excl_t − B_i) · exp(B_i − cum_s),
//         both factors ≤ 1 because cum does not increase, so no decay,
//         however strong, overflows; r ⊙ exp(cum_excl − B_i) times
//         (k ⊙ exp(B_i − cum))ᵀ is a 16 × 16 product of depth K. Warps
//         5-7 keep the pairs with j < 4 and warp 7 − i takes the rest
//         after its own sub-chunk (a named barrier hands its sum over,
//         through its own cum_excl rows), so no warp has more than 4;
//       . its own 16 × 16 diagonal block: rows 8-15 against columns 0-7
//         factored the same way at step 16i + 8, on the tensor cores; the
//         two 8 × 8 blocks on the diagonal in the pairwise form on the
//         CUDA cores (56 pairs, two a lane, gathered by shuffles); the
//         bonus Σ_k r u k on the diagonal;
//       . att · v for every sub-chunk j ≤ i; the pair term's fragment is
//         the A fragment of att · v register for register (columns 2q and
//         2q + 1 of the quad stand for k-slots q and q + 4; v's rows are
//         taken in the same order), so att never leaves registers;
//       . the readout (r ⊙ exp(cum_excl)) · S_in.
//     The products run on the tensor cores as `mma.sync` m16n8k8 TF32 with
//     float32 accumulators, each float32 operand split as big = tf32(x),
//     small = tf32(x − big) and three products (small·big + big·small +
//     big·big: 3xTF32, about 2^-22 relative); v is exact in TF32, so
//     att · v takes two. One bf16 or TF32 rounding of an operand (2^-9,
//     2^-11) would miss the output's rel_rms limit. Exponentials of the
//     output pass are __expf of an exponent ≤ 0, taken as a difference
//     first. The output is stored once, in bf16.
//   A barrier wait of some 10 s, and a wait as long for the state of the
//   chunk before, traps rather than hang the card; a failed tensor-map
//   encode or launch returns an error the wrapper raises. What
//   bounds it (PERF.md §6): the CUDA-core work the state's bits fix (log w
//   and the cumulative sum in both passes, the FMA update), the three
//   products of each split on `mma.sync`, and an output block's serial
//   start (load, log w, cumulative sum) that only the other block on its
//   SM overlaps.
// * "simt", float32 (held in exact float32) and the other bf16 shapes: the
//   CUDA-core kernel. One block of 256 threads per (b, h) walks the chunks
//   in order; the K×K state stays in shared memory across chunks. The
//   block reads (B, S, H, K) in place and writes out the same way. Per
//   chunk it stages r, k, v, cum and cum_excl as float32 rows of K + 1
//   floats (the odd stride puts the 16 rows a half-warp reads in 16
//   banks); one thread per channel takes the cumulative sum in time order.
//   The pair term is built 32 rows at a time in the pairwise form: thread
//   (ty, tx) of a 16 × 16 grid computes rows ty + 16i (i < 2) against
//   columns tx + 16j (j < 8), skipping column blocks past the last row;
//   then the same grid computes those rows' outputs, columns tx + 16j. A
//   barrier separates the last readout of S from its update, which the
//   grid computes as a register-tiled K × K product over the chunk's
//   steps. Everything runs on the CUDA cores in float32; exp is the
//   accurate expf. At c = 128 and K = 64 the tiles take 208 KB of shared
//   memory, so one block runs on an SM at a time, 320 blocks in three
//   waves at the serving shape.

#include <cuda.h>  // CUtensorMap and its enums; nothing is linked from libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// "simt": the CUDA-core kernel (float32, and bfloat16 at other shapes)

namespace simt {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxChunk = 128;
constexpr int kTT = 32;        // rows of the pair term per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// floats of shared memory for chunk length c and head dim K
size_t smem_floats(int c, int K) {
  const size_t ld = K + 1;
  return 5 * static_cast<size_t>(c) * ld   // r, k, v, cum, cum_excl
         + K * ld                          // state
         + kTT * static_cast<size_t>(c + 1)  // pair-term rows
         + kTT * ld                        // r ⊙ exp(cum_excl) rows
         + kTT + 2 * static_cast<size_t>(K);  // bonus; u; exp(cum_end)
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u,
                const float* __restrict__ state0, T* __restrict__ out,
                float* __restrict__ state_out, int S, int H, int c) {
  extern __shared__ float smem[];
  constexpr int ld = K + 1;
  constexpr int NK = (K + 15) / 16;  // state / output columns a thread owns
  const int lda = c + 1;
  float* Rs = smem;             // r                       c x ld
  float* Ks = Rs + c * ld;      // k, then k ⊙ exp(cum_end − cum)
  float* Vs = Ks + c * ld;      // v
  float* Cs = Vs + c * ld;      // cum (inclusive)
  float* Xs = Cs + c * ld;      // log w, then cum_excl
  float* Ss = Xs + c * ld;      // state                   K x ld
  float* As = Ss + K * ld;      // pair term               kTT x lda
  float* Ds = As + kTT * lda;   // r ⊙ exp(cum_excl)       kTT x ld
  float* Bs = Ds + kTT * ld;    // Σ_k r u k               kTT
  float* Us = Bs + kTT;         // u                       K
  float* Es = Us + K;           // exp(cum_end)            K

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t row = static_cast<int64_t>(H) * K;  // stride of a step
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * K;
  const int64_t sbase = static_cast<int64_t>(bh) * K * K;

  for (int i = tid; i < K; i += kThreads) Us[i] = u[h * K + i];
  for (int i = tid; i < K * K; i += kThreads) {
    const int a = i / K, j = i - a * K;
    Ss[a * ld + j] = state0 ? state0[sbase + i] : 0.0f;
  }

  for (int c0 = 0; c0 < S; c0 += c) {
    __syncthreads();  // the previous chunk's state update is complete
#pragma unroll 4
    for (int i = tid; i < c * K; i += kThreads) {
      const int t = i / K, j = i - t * K;
      const int64_t g = base + static_cast<int64_t>(c0 + t) * row + j;
      Rs[t * ld + j] = to_f32(r[g]);
      Ks[t * ld + j] = to_f32(k[g]);
      Vs[t * ld + j] = to_f32(v[g]);
      Xs[t * ld + j] = logf(fminf(fmaxf(w[g], 1e-12f), 1.0f));
    }
    __syncthreads();
    for (int j = tid; j < K; j += kThreads) {  // cumulative sums, in order
      float acc = 0.0f;
      for (int t = 0; t < c; ++t) {
        const float lw = Xs[t * ld + j];
        acc += lw;
        Cs[t * ld + j] = acc;
        Xs[t * ld + j] = acc - lw;
      }
    }
    __syncthreads();

    for (int t0 = 0; t0 < c; t0 += kTT) {
      const int t_hi = min(t0 + kTT, c);
      const int nj = (t_hi + 15) / 16;  // column blocks holding some s < t
      int tr[2], sc[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) tr[i] = min(t0 + ty + 16 * i, c - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[j] = min(tx + 16 * j, c - 1);
      float acc[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < K; ++kk) {
        float rv[2], xv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          rv[i] = Rs[tr[i] * ld + kk];
          xv[i] = Xs[tr[i] * ld + kk];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nj) {
            const float kv = Ks[sc[j] * ld + kk], cv = Cs[sc[j] * ld + kk];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              acc[i][j] = fmaf(rv[i] * kv, expf(xv[i] - cv), acc[i][j]);
          }
        }
      }
      // masked entries may hold inf or nan (exponents > 0): select, not
      // multiply
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = t0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          if (j < nj && t < t_hi && s < t_hi)
            As[(ty + 16 * i) * lda + s] = s < t ? acc[i][j] : 0.0f;
        }
      }
      for (int i = tid; i < kTT * K; i += kThreads) {
        const int tt = i / K, j = i - tt * K, t = t0 + tt;
        if (t < t_hi) Ds[tt * ld + j] = Rs[t * ld + j] * expf(Xs[t * ld + j]);
      }
      if (tid < kTT && t0 + tid < t_hi) {
        const int t = t0 + tid;
        float bonus = 0.0f;
        for (int j = 0; j < K; ++j)
          bonus = fmaf(Rs[t * ld + j] * Us[j], Ks[t * ld + j], bonus);
        Bs[tid] = bonus;
      }
      __syncthreads();

      float inter[2][NK], intra[2][NK];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < NK; ++jj) inter[i][jj] = intra[i][jj] = 0.0f;
      int col[NK];
#pragma unroll
      for (int jj = 0; jj < NK; ++jj) col[jj] = min(tx + 16 * jj, K - 1);
      for (int s = 0; s < t_hi; ++s) {
        float a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = As[(ty + 16 * i) * lda + s];
#pragma unroll
        for (int jj = 0; jj < NK; ++jj) {
          const float vv = Vs[s * ld + col[jj]];
#pragma unroll
          for (int i = 0; i < 2; ++i) intra[i][jj] = fmaf(a[i], vv, intra[i][jj]);
        }
      }
#pragma unroll 8
      for (int kk = 0; kk < K; ++kk) {
        float d[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) d[i] = Ds[(ty + 16 * i) * ld + kk];
#pragma unroll
        for (int jj = 0; jj < NK; ++jj) {
          const float sv = Ss[kk * ld + col[jj]];
#pragma unroll
          for (int i = 0; i < 2; ++i) inter[i][jj] = fmaf(d[i], sv, inter[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tt = ty + 16 * i, t = t0 + tt;
        if (t >= t_hi) continue;
        T* orow = out + base + static_cast<int64_t>(c0 + t) * row;
#pragma unroll
        for (int jj = 0; jj < NK; ++jj) {
          const int cj = tx + 16 * jj;
          if (cj < K)
            store(&orow[cj], inter[i][jj] + intra[i][jj]
                                 + Bs[tt] * Vs[t * ld + cj]);
        }
      }
      __syncthreads();  // As, Ds and Bs are consumed; S's readout is done
    }

    // S' = exp(cum_end) ⊙ S + (k ⊙ exp(cum_end − cum))ᵀ v
    const float* cend = Cs + (c - 1) * ld;
    for (int i = tid; i < c * K; i += kThreads) {
      const int t = i / K, j = i - t * K;
      Ks[t * ld + j] *= expf(cend[j] - Cs[t * ld + j]);
    }
    for (int j = tid; j < K; j += kThreads) Es[j] = expf(cend[j]);
    __syncthreads();
    int ra[NK], cb[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      ra[i] = min(ty + 16 * i, K - 1);
      cb[i] = min(tx + 16 * i, K - 1);
    }
    float upd[NK][NK];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int jj = 0; jj < NK; ++jj) upd[i][jj] = 0.0f;
    for (int s = 0; s < c; ++s) {
      float kd[NK], vv[NK];
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        kd[i] = Ks[s * ld + ra[i]];
        vv[i] = Vs[s * ld + cb[i]];
      }
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int jj = 0; jj < NK; ++jj)
          upd[i][jj] = fmaf(kd[i], vv[jj], upd[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int a = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < NK; ++jj) {
        const int cj = tx + 16 * jj;
        if (a < K && cj < K)
          Ss[a * ld + cj] = Es[a] * Ss[a * ld + cj] + upd[i][jj];
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < K * K; i += kThreads) {
    const int a = i / K, j = i - a * K;
    state_out[sbase + i] = Ss[a * ld + j];
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* state0, void* out, float* state_out,
           int B, int S, int H, int c, cudaStream_t stream) {
  const size_t smem = smem_floats(c, K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<T, K><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, state0, static_cast<T*>(out),
      state_out, S, H, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* state0, void* out,
             float* state_out, int B, int S, int H, int K, int c,
             cudaStream_t st) {
#define WKV6_CASE(KK)                                                      \
  case KK:                                                                 \
    return launch<T, KK>(r, k, v, w, u, state0, out, state_out, B, S, H, c, \
                         st);
  switch (K) {
    WKV6_CASE(8)
    WKV6_CASE(16)
    WKV6_CASE(24)
    WKV6_CASE(32)
    WKV6_CASE(40)
    WKV6_CASE(48)
    WKV6_CASE(56)
    WKV6_CASE(64)
  }
#undef WKV6_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// "mma": bfloat16 at K = 64, a state pass and an output pass, both in
// parallel over chunks

namespace tc {

constexpr int K = 64;
constexpr int kMaxRows = 128;    // steps of a chunk, at most
constexpr int kL = 16;           // steps of a sub-chunk: one warp's rows

// The state pass: log w, then cum, then k ⊙ exp(cum_end − cum), and v
// (f32), exp(cum_end) and cum_end; a thread owns a 4 × 4 tile of the
// chunk's K × K update and of the state.
constexpr int kStateThreads = 256;
constexpr int kStateSmem = 2 * kMaxRows * K * 4 + 2 * K * 4;

// The output pass: r, k, v (bf16) and w (f32, as two boxes of 32
// columns) in 128-byte-swizzled tiles of kMaxRows rows, then cum (f32, the
// same layout as w). The dynamic shared memory holds the tiles, 1024-byte
// aligned, and one mbarrier: in the gap before the aligned start when
// there is one, else after the tiles. 115712 bytes a block lets two blocks
// share an SM's 228 KB (1 KB of each is reserved).
constexpr int kOutThreads = 256;
constexpr int kTileBf16 = kMaxRows * K * 2;
constexpr int kTileF32 = kMaxRows * K * 4;
constexpr int kTiles = 3 * kTileBf16 + 2 * kTileF32;
constexpr int kOutSmem = kTiles + 1024;
static_assert(kOutSmem == 115712, "two output blocks an SM");

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
// complete on `bar`. (As in csrc/flash_attention.cu.)
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

// Byte offsets in the 128-byte-swizzled tiles: the 16-byte chunk j of row
// t lies at chunk j ^ (t % 8). A bf16 tile has one 128-byte row a step; an
// f32 tile two boxes of kMaxRows rows, columns 0-31 and 32-63.
__device__ __forceinline__ uint32_t sw_bf16(int t, int col) {
  return t * 128 + ((((col >> 3) ^ t) & 7) << 4) + ((col & 7) << 1);
}
__device__ __forceinline__ uint32_t sw_f32(int t, int col) {
  return ((col >> 5) * kMaxRows + t) * 128 + (((((col >> 2) ^ t) & 7)) << 4) +
         ((col & 3) << 2);
}

__device__ __forceinline__ float ld_bf16(const uint8_t* tile, int t, int col) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(tile + sw_bf16(t, col)));
}
__device__ __forceinline__ float& at_f32(uint8_t* tile, int t, int col) {
  return *reinterpret_cast<float*>(tile + sw_f32(t, col));
}

// x as a TF32 value (round to nearest, ties away; the low 13 bits zero),
// and x split as big + small, each TF32: big + small holds x to about 2^-22
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], big[e], small[e]);
}

// d (16 x 8, f32) += A (16 x 8, TF32) @ B (8 x 8, TF32). Fragments, with
// g = lane / 4 and q = lane % 4: a = {A[g][q], A[g+8][q], A[g][q+4],
// A[g+8][q+4]}, b = {B[q][g], B[q+4][g]}, d = {D[g][2q], D[g][2q+1],
// D[g+8][2q], D[g+8][2q+1]}. Not volatile: the compiler may interleave
// independent products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 (16 bytes) as floats: the bf16 bits are a float's top 16
__device__ __forceinline__ void unpack8(uint4 raw, float* dst) {
  const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    dst[2 * p] = __uint_as_float(wd[p] << 16);
    dst[2 * p + 1] = __uint_as_float(wd[p] & 0xffff0000u);
  }
}

// The state pass, one block per (chunk, b·h) in a single pass. The block
// computes the chunk's own contribution to the state, U = Σ_s (k_s ⊙
// exp(cum_end − cum_s)) ⊗ v_s, as a sequential FMA over the chunk's steps
// from zero, and E = exp(cum_end), with the "simt" design's arithmetic
// operation for operation (log w, the cumulative sum in time order,
// expf); thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and columns 4 tx ..
// 4 tx + 3. Then it takes the state before the chunk from the block of
// the chunk before, S' = E·S + U (written as "simt" writes it), and hands
// S' on: to states[b·h][n + 1] and a flag, or to state_out after the last
// chunk. Blocks take their (chunk, b·h) from a ticket counter, chunk-major:
// the block a chunk waits for took an earlier ticket, so it is running or
// done (no deadlock), and it started about B·H tickets earlier, so the
// wait is short. k and v are bf16, w float32, all (B, S, H, K) in place;
// k waits in registers (8 values a thread) while the cumulative sum runs.
// sync holds the ticket counter, then a flag per (b·h, chunk), all zero
// at the launch; states[b·h][n] is the state before chunk n.
__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t x;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(x) : "l"(p)
               : "memory");
  return x;
}

__global__ void __launch_bounds__(kStateThreads)
    wkv6_state_kernel(const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ w,
                      const float* __restrict__ state0,
                      float* __restrict__ states,
                      float* __restrict__ state_out,
                      uint32_t* __restrict__ sync, int S, int H, int c) {
  extern __shared__ float sm[];
  __shared__ int ticket;
  constexpr int kKr = kMaxRows * K / 8 / kStateThreads;  // 8 bf16 of k
  float* Lw = sm;                     // log w, cum, then kd    c x K
  float* Vs = Lw + kMaxRows * K;      // v                     c x K
  float* Es = Vs + kMaxRows * K;      // exp(cum_end)           K
  float* Ce = Es + K;                 // cum_end                K
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  if (tid == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int n_chunks = S / c, BH = gridDim.x / n_chunks;
  const int n = ticket / BH, bh = ticket % BH;
  const int b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * K;  // stride of a step
  const int64_t cb =
      (static_cast<int64_t>(b) * S + static_cast<int64_t>(n) * c) * row +
      h * K;

  uint4 pk[kKr];
#pragma unroll
  for (int m = 0; m < kKr; ++m) {
    const int e = (tid + m * kStateThreads) * 8, t = e / K;
    if (t < c)
      pk[m] = __ldg(reinterpret_cast<const uint4*>(k + cb + t * row + e % K));
  }
  for (int e = tid; e < c * (K / 4); e += kStateThreads) {
    const int t = e / (K / 4), j = (e % (K / 4)) * 4;
    const float4 x =
        __ldg(reinterpret_cast<const float4*>(w + cb + t * row + j));
    *reinterpret_cast<float4*>(Lw + t * K + j) =
        make_float4(logf(fminf(fmaxf(x.x, 1e-12f), 1.0f)),
                    logf(fminf(fmaxf(x.y, 1e-12f), 1.0f)),
                    logf(fminf(fmaxf(x.z, 1e-12f), 1.0f)),
                    logf(fminf(fmaxf(x.w, 1e-12f), 1.0f)));
  }
  for (int e = tid; e < c * (K / 8); e += kStateThreads) {
    const int t = e / (K / 8), j = (e % (K / 8)) * 8;
    unpack8(__ldg(reinterpret_cast<const uint4*>(v + cb + t * row + j)),
            Vs + t * K + j);
  }
  __syncthreads();
  if (tid < K) {  // cumulative sums, in order, in place
    float acc = 0.0f;
    for (int t0 = 0; t0 < c; t0 += 8) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = t0 + e < c ? Lw[(t0 + e) * K + tid] : 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (t0 + e < c) {
          acc += x[e];
          Lw[(t0 + e) * K + tid] = acc;
        }
    }
    Ce[tid] = acc;
    Es[tid] = expf(acc);
  }
  __syncthreads();
  // k ⊙ exp(cum_end − cum), in place of cum
#pragma unroll
  for (int m = 0; m < kKr; ++m) {
    const int e = (tid + m * kStateThreads) * 8;
    if (e / K < c) {
      float kf[8];
      unpack8(pk[m], kf);
#pragma unroll
      for (int x = 0; x < 8; ++x)
        Lw[e + x] = kf[x] * expf(Ce[(e + x) % K] - Lw[e + x]);
    }
  }
  __syncthreads();
  float upd[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) upd[i][j] = 0.0f;
#pragma unroll 4
  for (int s = 0; s < c; ++s) {
    const float4 kd4 = *reinterpret_cast<const float4*>(Lw + s * K + 4 * ty);
    const float4 v4 = *reinterpret_cast<const float4*>(Vs + s * K + 4 * tx);
    const float kd[4] = {kd4.x, kd4.y, kd4.z, kd4.w};
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) upd[i][j] = fmaf(kd[i], vv[j], upd[i][j]);
  }

  // the state before this chunk: state0 (or zeros) for the first, else
  // from the block of the chunk before, once its flag is up
  uint32_t* ready = sync + 1 + static_cast<int64_t>(bh) * n_chunks;
  float* sb = states + static_cast<int64_t>(bh) * n_chunks * K * K;
  const int64_t mine = (4 * ty) * K + 4 * tx;
  float st[4][4];
  if (n == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x =
          state0 ? *reinterpret_cast<const float4*>(
                       state0 + static_cast<int64_t>(bh) * K * K + mine +
                       i * K)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(sb + mine + i * K) = x;
      st[i][0] = x.x, st[i][1] = x.y, st[i][2] = x.z, st[i][3] = x.w;
    }
  } else {
    if (tid == 0) {
      const long long t0 = clock64();
      while (ld_acquire(ready + n) == 0) {
        if (clock64() - t0 > (1ll << 34)) __trap();  // some 10 s
        __nanosleep(64);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          sb + static_cast<int64_t>(n) * K * K + mine + i * K));
      st[i][0] = x.x, st[i][1] = x.y, st[i][2] = x.z, st[i][3] = x.w;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st[i][j] = Es[4 * ty + i] * st[i][j] + upd[i][j];
  float* dst = n + 1 < n_chunks
                   ? sb + static_cast<int64_t>(n + 1) * K * K
                   : state_out + static_cast<int64_t>(bh) * K * K;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + mine + i * K) =
        make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
  if (n + 1 < n_chunks) {
    __threadfence();
    __syncthreads();
    if (tid == 0)
      asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(ready + n + 1),
                   "r"(1u)
                   : "memory");
  }
}

// att · v for the 16 steps s0 .. s0 + 15 into o: att holds the pair term
// of this lane's rows against those steps as two m16n8 fragments (steps
// s0 .. s0 + 7, s0 + 8 .. s0 + 15). Fragment d of one serves as the A
// fragment with k-slot q for step 2q and k-slot q + 4 for step 2q + 1, so
// B takes v's rows in that order. v is exact in TF32: two products.
__device__ __forceinline__ void att_v(const float (&att)[2][4], int s0,
                                      const uint8_t* Vt, int g, int q,
                                      float (&o)[8][4]) {
#pragma unroll
  for (int h8 = 0; h8 < 2; ++h8) {
    const float a[4] = {att[h8][0], att[h8][2], att[h8][1], att[h8][3]};
    uint32_t ab[4], as[4];
    split4(a, ab, as);
    const int s = s0 + 8 * h8 + 2 * q;
    uint32_t vb[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      vb[n][0] = __float_as_uint(ld_bf16(Vt, s, 8 * n + g));
      vb[n][1] = __float_as_uint(ld_bf16(Vt, s + 1, 8 * n + g));
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) mma(o[n], as, vb[n][0], vb[n][1]);
#pragma unroll
    for (int n = 0; n < 8; ++n) mma(o[n], ab, vb[n][0], vb[n][1]);
  }
}

// the two bf16 of a 32-bit word as floats (the lower address first)
__device__ __forceinline__ float2 bf16x2(uint32_t x) {
  return make_float2(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xffff0000u));
}

// two neighbouring columns (col even) of a tile's row
__device__ __forceinline__ float2 ld_bf16x2(const uint8_t* tile, int t,
                                            int col) {
  return bf16x2(*reinterpret_cast<const uint32_t*>(tile + sw_bf16(t, col)));
}
__device__ __forceinline__ float2 ld_f32x2(const uint8_t* tile, int t,
                                           int col) {
  return *reinterpret_cast<const float2*>(tile + sw_f32(t, col));
}

// The output pass's tiles, and the lane's place in its warp's fragments.
// The products' k-slots q and q + 4 stand for the neighbouring channels
// 8 kk + 2q and 8 kk + 2q + 1 (any order of the depth serves, as long as
// A and B agree), so each operand pair is one load.
struct Tiles {
  uint8_t* r;  // r (bf16)
  uint8_t* k;  // k (bf16)
  uint8_t* v;  // v (bf16)
  uint8_t* x;  // cum_excl (f32)
  uint8_t* c;  // cum (f32)
  int g, q;    // lane / 4, lane % 4
};

// o += Σ_{j_lo ≤ j < j_hi} att_ij · v_j: the pair term of sub-chunk i
// against the earlier sub-chunks j, two at a time, factored at B_i =
// cum_excl at step 16 i: r ⊙ exp(cum_excl − B_i) times
// (k ⊙ exp(B_i − cum))ᵀ.
__device__ __forceinline__ void pair_terms(const Tiles& T, int i, int j_lo,
                                           int j_hi, float (&o)[8][4]) {
  const int g = T.g, q = T.q, ti = kL * i, ra = ti + g, rb = ra + 8;
#pragma unroll 1
  for (int j0 = j_lo; j0 < j_hi; j0 += 2) {
    const bool two = j0 + 1 < j_hi;
    float att[2][2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8)
#pragma unroll
        for (int e = 0; e < 4; ++e) att[jj][h8][e] = 0.0f;
#pragma unroll 1
    for (int kk = 0; kk < K / 8; ++kk) {
      const int c0 = 8 * kk + 2 * q;  // and c0 + 1
      const float2 bi = ld_f32x2(T.x, ti, c0);
      const float2 xa = ld_f32x2(T.x, ra, c0), xb = ld_f32x2(T.x, rb, c0);
      const float2 r_a = ld_bf16x2(T.r, ra, c0), r_b = ld_bf16x2(T.r, rb, c0);
      const float a[4] = {r_a.x * __expf(xa.x - bi.x),
                          r_b.x * __expf(xb.x - bi.x),
                          r_a.y * __expf(xa.y - bi.y),
                          r_b.y * __expf(xb.y - bi.y)};
      uint32_t ab[4], as[4];
      split4(a, ab, as);
      uint32_t kb[2][2][2], ks[2][2][2];  // [j][h8][c0, c0 + 1]
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          // past the last pair: a valid row, its product unused
          const int s = kL * (two ? j0 + jj : j0) + 8 * h8 + g;
          const float2 kv = ld_bf16x2(T.k, s, c0), cs = ld_f32x2(T.c, s, c0);
          split(kv.x * __expf(bi.x - cs.x), kb[jj][h8][0], ks[jj][h8][0]);
          split(kv.y * __expf(bi.y - cs.y), kb[jj][h8][1], ks[jj][h8][1]);
        }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8)
          mma(att[jj][h8], as, kb[jj][h8][0], kb[jj][h8][1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8)
          mma(att[jj][h8], ab, ks[jj][h8][0], ks[jj][h8][1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8)
          mma(att[jj][h8], ab, kb[jj][h8][0], kb[jj][h8][1]);
    }
    att_v(att[0], kL * j0, T.v, g, q, o);
    if (two) att_v(att[1], kL * (j0 + 1), T.v, g, q, o);
  }
}

// The output pass. Block (chunk, b·h); warp i owns steps 16 i .. 16 i + 15
// of the chunk. states holds the state before each chunk (the state
// pass's output); out is bf16 (B, S, H, K). Warp i > 4 computes its pair
// terms against sub-chunks 0-3 and warp 7 − i the rest, after its own
// sub-chunk, into the shared memory of its own cum_excl rows (which
// nothing reads any more); a named barrier hands the sum over.
__global__ void __launch_bounds__(kOutThreads, 2)
    wkv6_out_kernel(__grid_constant__ const CUtensorMap map_r,
                    __grid_constant__ const CUtensorMap map_k,
                    __grid_constant__ const CUtensorMap map_v,
                    __grid_constant__ const CUtensorMap map_w,
                    const float* __restrict__ u,
                    const float* __restrict__ states,
                    __nv_bfloat16* __restrict__ out, int S, int H, int c) {
  constexpr int kKeep = 4;  // pairs a warp keeps; warps past it hand over
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t gap = (1024u - (base & 1023u)) & 1023u;
  uint8_t* Rt = smem + gap;              // r
  uint8_t* Kt = Rt + kTileBf16;          // k
  uint8_t* Vt = Kt + kTileBf16;          // v
  uint8_t* Xt = Vt + kTileBf16;          // w, then log w, then cum_excl
  uint8_t* Ct = Xt + kTileF32;           // cum
  const uint32_t bar = gap >= 8 ? base + gap - 8 : base + kTiles;
  const int n = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int t0 = n * c, rows = (c + kL - 1) / kL * kL;
  const int tid = threadIdx.x;
  const float* sn =
      states + (static_cast<int64_t>(bh) * gridDim.x + n) * K * K;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t dst = base + gap;
    mbar_expect_tx(bar, 5 * rows * 128);
    tma_load(dst, &map_r, bar, 0, h, t0, b);
    tma_load(dst + kTileBf16, &map_k, bar, 0, h, t0, b);
    tma_load(dst + 2 * kTileBf16, &map_v, bar, 0, h, t0, b);
    tma_load(dst + 3 * kTileBf16, &map_w, bar, 0, h, t0, b);
    tma_load(dst + 3 * kTileBf16 + kMaxRows * 128, &map_w, bar, 32, h, t0, b);
  }
  if (tid < K * K / 32)  // the state this chunk reads out, into L2
    asm volatile("prefetch.global.L2 [%0];" ::"l"(sn + 32 * tid));
  mbar_wait(bar, 0);

  // log w in place, 0 past the chunk's last step (cum stays flat there);
  // r, k and v past it zeroed (those rows hold the next chunk's steps)
  for (int e = tid; e < rows * (K / 4); e += kOutThreads) {
    const int t = e / (K / 4), j = (e % (K / 4)) * 4;  // 4 channels
    float4& x = *reinterpret_cast<float4*>(Xt + sw_f32(t, j));
    if (t < c) {
      float4 y = x;
      y.x = logf(fminf(fmaxf(y.x, 1e-12f), 1.0f));
      y.y = logf(fminf(fmaxf(y.y, 1e-12f), 1.0f));
      y.z = logf(fminf(fmaxf(y.z, 1e-12f), 1.0f));
      y.w = logf(fminf(fmaxf(y.w, 1e-12f), 1.0f));
      x = y;
    } else {
      x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const uint32_t o = sw_bf16(t, j);
      *reinterpret_cast<uint2*>(Rt + o) = make_uint2(0u, 0u);
      *reinterpret_cast<uint2*>(Kt + o) = make_uint2(0u, 0u);
      *reinterpret_cast<uint2*>(Vt + o) = make_uint2(0u, 0u);
    }
  }
  __syncthreads();
  if (tid < K) {  // cum and cum_excl = cum − log w, in time order
    float acc = 0.0f;
    for (int ta = 0; ta < rows; ta += 8) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = at_f32(Xt, ta + e, tid);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc += x[e];
        at_f32(Ct, ta + e, tid) = acc;
        at_f32(Xt, ta + e, tid) = acc - x[e];
      }
    }
  }
  __syncthreads();

  const int i = tid >> 5, lane = tid & 31, n_sub = rows / kL;
  if (i >= n_sub) return;
  const Tiles T{Rt, Kt, Vt, Xt, Ct, lane >> 2, lane & 3};
  const int g = T.g, q = T.q;
  const int ti = kL * i, ra = ti + g, rb = ra + 8;  // this lane's two rows
  float o[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nn][e] = 0.0f;

  pair_terms(T, i, 0, min(i, kKeep), o);

  // The diagonal block, steps ti .. ti + 15 against themselves:
  // - rows 8-15 against columns 0-7 on the tensor cores, factored at
  //   B' = cum_excl at step ti + 8 (rows 0-7 of the A operand are zero);
  // - the two 8 × 8 blocks on the diagonal pairwise: their 56 pairs s < t
  //   are slots 0-55, lane l computes slots l and l + 32 over all channels,
  //   and the lanes that hold each entry's fragment fetch it by shuffles;
  // - the bonus Σ_k r u k of row (l % 16) from lanes l and l ^ 16.
  float lo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int kk = 0; kk < K / 8; ++kk) {
    const int c0 = 8 * kk + 2 * q, s = ti + g;  // and c0 + 1
    const float2 bp = ld_f32x2(Xt, ti + 8, c0), xb = ld_f32x2(Xt, rb, c0);
    const float2 r_b = ld_bf16x2(Rt, rb, c0);
    const float a[4] = {0.0f, r_b.x * __expf(xb.x - bp.x), 0.0f,
                        r_b.y * __expf(xb.y - bp.y)};
    uint32_t ab[4], as[4], kb0, ks0, kb1, ks1;
    split4(a, ab, as);
    const float2 kv = ld_bf16x2(Kt, s, c0), cs = ld_f32x2(Ct, s, c0);
    split(kv.x * __expf(bp.x - cs.x), kb0, ks0);
    split(kv.y * __expf(bp.y - cs.y), kb1, ks1);
    mma(lo, as, kb0, kb1);
    mma(lo, ab, ks0, ks1);
    mma(lo, ab, kb0, kb1);
  }
  float pr[2];
  {
    int pt[2], ps[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = lane + 32 * e, blk = p >= 28 ? 1 : 0;
      int m = p < 56 ? p - 28 * blk : 0, t = 1;
      while (m >= t) {
        m -= t;
        ++t;
      }
      pt[e] = ti + 8 * blk + t;
      ps[e] = ti + 8 * blk + m;
      pr[e] = 0.0f;
    }
#pragma unroll 2
    for (int ch = 0; ch < K; ch += 8) {  // a 16-byte chunk of r and k
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint4 rr =
            *reinterpret_cast<const uint4*>(Rt + sw_bf16(pt[e], ch));
        const uint4 kv =
            *reinterpret_cast<const uint4*>(Kt + sw_bf16(ps[e], ch));
        const uint32_t rw[4] = {rr.x, rr.y, rr.z, rr.w};
        const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // channels ch + 4 hf .. + 3
          const float4 x =
              *reinterpret_cast<const float4*>(Xt + sw_f32(pt[e], ch + 4 * hf));
          const float4 cs =
              *reinterpret_cast<const float4*>(Ct + sw_f32(ps[e], ch + 4 * hf));
          const float2 r0 = bf16x2(rw[2 * hf]), r1 = bf16x2(rw[2 * hf + 1]);
          const float2 k0 = bf16x2(kw[2 * hf]), k1 = bf16x2(kw[2 * hf + 1]);
          pr[e] = fmaf(r0.x * k0.x, __expf(fminf(x.x - cs.x, 0.0f)), pr[e]);
          pr[e] = fmaf(r0.y * k0.y, __expf(fminf(x.y - cs.y, 0.0f)), pr[e]);
          pr[e] = fmaf(r1.x * k1.x, __expf(fminf(x.z - cs.z, 0.0f)), pr[e]);
          pr[e] = fmaf(r1.y * k1.y, __expf(fminf(x.w - cs.w, 0.0f)), pr[e]);
        }
      }
    }
  }
  float bonus = 0.0f;
  {
    const int t = ti + (lane & 15), ch0 = (lane >> 4) * (K / 2);
    const float* uh = u + h * K;
#pragma unroll
    for (int ch = ch0; ch < ch0 + K / 2; ch += 8) {
      const uint4 rr = *reinterpret_cast<const uint4*>(Rt + sw_bf16(t, ch));
      const uint4 kv = *reinterpret_cast<const uint4*>(Kt + sw_bf16(t, ch));
      const uint32_t rw[4] = {rr.x, rr.y, rr.z, rr.w};
      const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 r2 = bf16x2(rw[p]), k2 = bf16x2(kw[p]);
        bonus = fmaf(r2.x * __ldg(uh + ch + 2 * p), k2.x, bonus);
        bonus = fmaf(r2.y * __ldg(uh + ch + 2 * p + 1), k2.y, bonus);
      }
    }
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 16);
  }
  const float bon_a = __shfl_sync(0xffffffffu, bonus, g);
  const float bon_b = __shfl_sync(0xffffffffu, bonus, g + 8);
  // entry (t, s) of diagonal block blk, s < t, from the lane that holds
  // its slot (every lane shuffles; a pair with s ≥ t is not used)
  auto pair = [&](int blk, int t, int s) {
    const int slot = 28 * blk + t * (t - 1) / 2 + s;
    const float v0 = __shfl_sync(0xffffffffu, pr[0], slot & 31);
    const float v1 = __shfl_sync(0xffffffffu, pr[1], slot & 31);
    return slot < 32 ? v0 : v1;
  };
  const float p00 = pair(0, g, 2 * q), p01 = pair(0, g, 2 * q + 1);
  const float p10 = pair(1, g, 2 * q), p11 = pair(1, g, 2 * q + 1);
  auto entry = [&](int s, float p, float bon) {  // column s of row g
    return s < g ? p : s == g ? bon : 0.0f;
  };
  {
    const float att[2][4] = {
        {entry(2 * q, p00, bon_a), entry(2 * q + 1, p01, bon_a), lo[2],
         lo[3]},
        {0.0f, 0.0f, entry(2 * q, p10, bon_b), entry(2 * q + 1, p11, bon_b)}};
    att_v(att, ti, Vt, g, q, o);
  }

  // the readout (r ⊙ exp(cum_excl)) · S_in; S from global (L2, where it
  // was prefetched, and L1), split
#pragma unroll 1
  for (int kk = 0; kk < K / 8; ++kk) {
    const int c0 = 8 * kk + 2 * q;  // and c0 + 1
    float sv[8][2];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      sv[nn][0] = __ldg(sn + c0 * K + 8 * nn + g);
      sv[nn][1] = __ldg(sn + (c0 + 1) * K + 8 * nn + g);
    }
    const float2 xa = ld_f32x2(Xt, ra, c0), xb = ld_f32x2(Xt, rb, c0);
    const float2 r_a = ld_bf16x2(Rt, ra, c0), r_b = ld_bf16x2(Rt, rb, c0);
    const float a[4] = {r_a.x * __expf(xa.x), r_b.x * __expf(xb.x),
                        r_a.y * __expf(xa.y), r_b.y * __expf(xb.y)};
    uint32_t ab[4], as[4];
    split4(a, ab, as);
    uint32_t bb[8][2], bs[8][2];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      split(sv[nn][0], bb[nn][0], bs[nn][0]);
      split(sv[nn][1], bb[nn][1], bs[nn][1]);
    }
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) mma(o[nn], as, bb[nn][0], bb[nn][1]);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) mma(o[nn], ab, bs[nn][0], bs[nn][1]);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) mma(o[nn], ab, bb[nn][0], bb[nn][1]);
  }

  // the sum of this warp's pairs that warp 7 − i computed, in the rows of
  // cum_excl that warp owns: 32 floats a lane, lane-major, in its two
  // 2 KB pieces (columns 0-31 and 32-63)
  auto part = [&](int w, int f) -> float& {
    return *reinterpret_cast<float*>(
        Xt + ((f >> 4) * kMaxRows + kL * w) * 128 + ((f & 15) * 32 + lane) * 4);
  };
  if (i > kKeep) {
    asm volatile("bar.sync %0, 64;" ::"r"(1 + (7 - i)) : "memory");
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] += part(7 - i, 4 * nn + e);
  }

  const int64_t row = static_cast<int64_t>(H) * K;  // stride of a step
  __nv_bfloat16* ob =
      out + (static_cast<int64_t>(b) * S + t0) * row + h * K + 2 * q;
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) {
    if (ra < c)
      *reinterpret_cast<__nv_bfloat162*>(ob + ra * row + 8 * nn) =
          __floats2bfloat162_rn(o[nn][0], o[nn][1]);
    if (rb < c)
      *reinterpret_cast<__nv_bfloat162*>(ob + rb * row + 8 * nn) =
          __floats2bfloat162_rn(o[nn][2], o[nn][3]);
  }

  const int hv = 7 - i;  // the warp this one computes pairs for
  if (hv > kKeep && hv < n_sub) {
    __syncwarp();  // this warp's own reads of its cum_excl rows are done
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] = 0.0f;
    pair_terms(T, hv, kKeep, hv, o);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) part(i, 4 * nn + e) = o[nn][e];
    __threadfence_block();
    asm volatile("bar.arrive %0, 64;" ::"r"(1 + i) : "memory");
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
// library links nothing but the CUDA runtime (as in csrc/flash_attention.cu).
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

// The 4-D map (K, H, S, B) of a contiguous (B, S, H, K) array of
// `elem`-byte values, read in boxes of (128 bytes, 1, rows, 1) with the
// 128-byte swizzle; outside it reads zeros.
int encode(CUtensorMap* map, const void* base, CUtensorMapDataType type,
           int elem, int H, int S, int B, int rows) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(H),
      static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(K) * elem,
                                 static_cast<cuuint64_t>(K) * H * elem,
                                 static_cast<cuuint64_t>(K) * H * S * elem};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / elem), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides,
                        box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* state0, void* out, float* state_out,
           float* scratch, int B, int S, int H, int c, cudaStream_t stream) {
  const int rows = (c + kL - 1) / kL * kL, n_chunks = S / c;
  CUtensorMap map_r, map_k, map_v, map_w;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = encode(&map_r, r, bf16, 2, H, S, B, rows);
  if (rc == 0) rc = encode(&map_k, k, bf16, 2, H, S, B, rows);
  if (rc == 0) rc = encode(&map_v, v, bf16, 2, H, S, B, rows);
  if (rc == 0)
    rc = encode(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, H, S, B, rows);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStateSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_out_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kOutSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_state_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_out_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  // scratch: the state before each chunk (B·H, chunks, K, K), then the
  // ticket counter and a flag per (b·h, chunk), zeroed here
  const int64_t n_blocks = static_cast<int64_t>(B) * H * n_chunks;
  float* states = scratch;
  uint32_t* sync = reinterpret_cast<uint32_t*>(scratch + n_blocks * K * K);
  err = cudaMemsetAsync(sync, 0, (1 + n_blocks) * sizeof(uint32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_state_kernel<<<static_cast<unsigned>(n_blocks), kStateThreads, kStateSmem,
                      stream>>>(static_cast<const __nv_bfloat16*>(k),
                                static_cast<const __nv_bfloat16*>(v), w,
                                state0, states, state_out, sync, S, H, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_out_kernel<<<dim3(n_chunks, B * H), kOutThreads, kOutSmem, stream>>>(
      map_r, map_k, map_v, map_w, u, states,
      static_cast<__nv_bfloat16*>(out), S, H, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// C interface, loaded with ctypes. r, k, v and out are contiguous
// (B, S, H, K) of one type: float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// w is contiguous (B, S, H, K) float32, u (H, K) float32, state0 (B, H, K, K)
// float32 or null (a zero state), state_out (B, H, K, K) float32. K is a
// multiple of 8 up to 64, chunk divides S and is at most 128, B·H is at
// most 65535 (the wrapper checks all of it). `stream` is a cudaStream_t.

// 1 where `wkv6_launch` runs the "mma" design, 0 for "simt".
extern "C" int wkv6_design(int is_bf16, int K, int chunk) {
  return is_bf16 && K == tc::K && chunk >= 1 && chunk <= tc::kMaxRows;
}

static int bad_shape(int B, int S, int H, int chunk) {
  return chunk <= 0 || chunk > simt::kMaxChunk || S % chunk != 0 ||
         B * H > 65535;
}

static int simt_launch(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* state0,
                       void* out, void* state_out, int B, int S, int H, int K,
                       int chunk, int is_bf16, cudaStream_t st) {
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  return is_bf16 ? simt::launch_k<__nv_bfloat16>(r, k, v, wf, uf, s0, out, so,
                                                 B, S, H, K, chunk, st)
                 : simt::launch_k<float>(r, k, v, wf, uf, s0, out, so, B, S,
                                         H, K, chunk, st);
}

// Runs the design `wkv6_design` names. `scratch` is 4-byte words of
// B·H·(S / chunk)·(K·K + 1) + 1 for the "mma" design (the state before
// each chunk, a ticket counter and a flag per chunk), unused by "simt"; r, k, v and w are 16-byte aligned for "mma"
// (TMA). Returns the cudaError_t of the launch (0 on success), 99999 if
// cuTensorMapEncodeTiled cannot be found, or 100000 + its CUresult if it
// fails.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* state0,
                           void* out, void* state_out, void* scratch, int B,
                           int S, int H, int K, int chunk, int is_bf16,
                           void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (bad_shape(B, S, H, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wkv6_design(is_bf16, K, chunk)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return tc::launch(r, k, v, static_cast<const float*>(w),
                      static_cast<const float*>(u),
                      static_cast<const float*>(state0), out,
                      static_cast<float*>(state_out),
                      static_cast<float*>(scratch), B, S, H, chunk, st);
  }
  return simt_launch(r, k, v, w, u, state0, out, state_out, B, S, H, K, chunk,
                     is_bf16, st);
}

// The CUDA-core design at any shape and type: the yardstick chip_smoke.py
// times beside the tensor-core one.
extern "C" int wkv6_simt_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u,
                                const void* state0, void* out,
                                void* state_out, int B, int S, int H, int K,
                                int chunk, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (bad_shape(B, S, H, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  return simt_launch(r, k, v, w, u, state0, out, state_out, B, S, H, K, chunk,
                     is_bf16, static_cast<cudaStream_t>(stream));
}
