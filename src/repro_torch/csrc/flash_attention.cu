// flash_attention — blocked online-softmax attention for Hopper.
//
// Replaces the TPU kernel `_attn_kernel` behind
// `repro.kernels.flash_attention.kernel.flash_attention`
// (src/repro/kernels/flash_attention/kernel.py:26-125). For q, k, v of
// shape (B, S, H, hd), heads already GQA-expanded by the caller, it
// computes softmax(q k^T / sqrt(hd) + mask) v per (b, h), with a causal
// mask (kpos <= qpos) and an optional sliding window (kpos > qpos - window),
// as the TPU kernel does:
//   - the running max, the running sum and the accumulator are float32,
//     whatever the input type; masked scores are -1e30 (not -inf), so a
//     row that meets a wholly masked tile first carries a finite running
//     max that the first unmasked tile wipes out (alpha = 0);
//   - kv tiles wholly above the diagonal, or wholly before the window of
//     every row of the q tile, are skipped: the loop runs over
//     [kt_begin, kt_end) only;
//   - the output is acc / max(l, 1e-20), stored in the input type.
// Unlike the TPU kernel it takes any S (the last q and kv tiles are masked;
// the TPU kernel asserts S % 128 == 0) and it keeps p in float32 for the
// p·v product (the TPU kernel rounds p to the input type first).
//
// Design. One block of 256 threads per (b·h, tile of 64 query rows). The
// q tile and one kv tile at a time are staged in shared memory as float32
// rows of hd + 1 floats (the pad puts the 16 rows a half-warp reads in 16
// banks). The block reads (B, S, H, hd) in place: row s of head h starts at
// ((b·S + s)·H + h)·hd, so no transpose copy is made. Thread (ty, tx) of the
// 16 × 16 grid owns query rows ty + 16i (i < 4): it computes the scores of
// those rows against kv rows tx + 16j (j < 4), and accumulates output
// columns tx + 16j (j < NJ = ceil(hd / 16)). Row max and row sum are
// reduced across the 16 threads of a row with shuffles; p goes through a
// 64 × 65 shared tile to the p·v product. Everything runs on the CUDA cores
// in float32 fused multiply-adds: no tensor cores, no asynchronous copies.
//
// Bound on the H100. At the serving shapes the work is compute: a causal
// (8, 2048, 14, 64) call needs 60 GFLOP against 29 MB of inputs and output,
// 0.061 ms at the bf16 tensor-core peak (989 TFLOP/s) and 0.009 ms at
// 3.35 TB/s. This kernel runs at the float32 CUDA-core rate (67 TFLOP/s
// peak) at best and does not reach it; `wgmma` with the q tile in registers
// and TMA-fed kv tiles is the later work that closes the gap. PERF.md
// records the kernel's time beside its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

}  // namespace

// C interface, loaded with ctypes. q and o are contiguous (B, Sq, H, hd),
// k and v contiguous (B, Sk, H, hd), all of one type: float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1). hd is a multiple of 8 from 8 to 256 and
// B·H at most 65535 (the wrapper checks both). `stream` is a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Sq, int Sk, int hd, int causal,
                                      int window, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<__nv_bfloat16>(q, k, v, o, B, H, Sq, Sk, hd,
                                            causal, window, st)
                 : launch_hd<float>(q, k, v, o, B, H, Sq, Sk, hd, causal,
                                    window, st);
}
