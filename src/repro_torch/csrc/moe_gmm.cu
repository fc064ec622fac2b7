// moe_gmm — the grouped expert matmul of the MoE layer, for Hopper.
//
// Replaces the TPU kernel `_gmm_kernel` behind
// `repro.kernels.moe_gmm.kernel.grouped_matmul`
// (src/repro/kernels/moe_gmm/kernel.py:21-56): expert-wise
//     out[e] = x[e] @ w[e],   x (E, C, D), w (E, D, F) -> out (E, C, F),
// with a float32 accumulator over D and the output stored in the input
// type, as the TPU kernel does. Unlike the TPU kernel, which asserts
// C % 128 == 0, D % 512 == 0 and F % 512 == 0, it masks the ragged edges of
// C, D and F, so any shape runs (moonshot's F = 1408 and a capacity of 480).
//
// Design. One block of 256 threads per (expert, tile of BM rows of C, tile
// of BN columns of F); a loop over D in steps of 32 stages one x tile
// (stored transposed, k-major, so a row of the product reads contiguous
// floats) and one w tile in shared memory as float32. Thread (ty, tx) of
// the 16 × 16 grid owns rows ty + 16i (i < BM/16) and columns tx + 16j
// (j < BN/16): neighbouring threads read neighbouring w columns and store
// neighbouring output columns. Two tile shapes, chosen from C: 64 × 64 for
// prefill (C = capacity of the prompt tokens), 16 × 128 for decode (C = 8),
// where a 64-row tile would spend 7/8 of its work on masked rows. The
// product runs on the CUDA cores in float32 fused multiply-adds: no tensor
// cores and no asynchronous copies.
//
// Bound on the H100. Prefill (E=64, C=480, D=2048, F=1408, bf16) is
// compute: 177 GFLOP, 0.18 ms at the bf16 tensor-core peak (989 TFLOP/s);
// this kernel runs at the float32 CUDA-core rate (67 TFLOP/s peak) at best.
// Decode (C = 8) is bytes: the 369 MB of one projection's expert weights,
// 0.11 ms at 3.35 TB/s; each w element is read once per C tile, and the
// decode tile spans all of C, so w is read once. `mma.sync`/`wgmma` on bf16
// tiles fed by TMA is the later work. PERF.md records the kernel's time
// beside its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  gmm_kernel<T, BM, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_c(const void* x, const void* w, void* out, int E, int C, int D,
             int F, cudaStream_t stream) {
  if (C <= 16) return launch<T, 16, 128>(x, w, out, E, C, D, F, stream);
  return launch<T, 64, 64>(x, w, out, E, C, D, F, stream);
}

}  // namespace

// C interface, loaded with ctypes. x is contiguous (E, C, D), w contiguous
// (E, D, F), out contiguous (E, C, F), all of one type: float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1). E and ceil(C / 16) are at most
// 65535 (the wrapper checks). `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out,
                                     int E, int C, int D, int F, int is_bf16,
                                     void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (E > 65535 || (C + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_c<__nv_bfloat16>(x, w, out, E, C, D, F, st)
                 : launch_c<float>(x, w, out, E, C, D, F, st);
}
