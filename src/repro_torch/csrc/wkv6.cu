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
//     s < t, in the PAIRWISE form (the exponent is ≤ 0 under the mask, so
//     strong decays cannot overflow it);
//   - o = att @ v + (r ⊙ exp(cum_excl)) @ S + (Σ_k r u k) v, stored in r's
//     type, with S the state BEFORE this chunk;
//   - then S' = exp(cum_end) ⊙ S + (k ⊙ exp(cum_end − cum))ᵀ v.
// The state is float32 throughout. Unlike the TPU kernel, which starts from
// a zero state (its wrapper folds a carried state in by linearity), this
// kernel starts from `state0` itself (zeros when it is null); the two are
// equal in exact arithmetic. It takes any chunk length from 1 to 128 that
// divides S (a ragged prompt's tail block has its own).
//
// Design. One block of 256 threads per (b, h) walks the chunks in order;
// the K×K state stays in shared memory across chunks. The block reads
// (B, S, H, K) in place (stride H·K between time steps; the TPU wrapper
// makes a transposed copy) and writes out the same way. Per chunk it
// stages r, k, v, cum and cum_excl as float32 rows of K + 1 floats (the
// odd stride puts the 16 rows a half-warp reads in 16 banks); one thread
// per channel takes the cumulative sum in time order. The pair term is
// built 32 rows at a time: thread (ty, tx) of a 16 × 16 grid computes rows
// ty + 16i (i < 2) against columns tx + 16j (j < 8), skipping column
// blocks past the last row; then the same grid computes those rows'
// outputs, columns tx + 16j. A barrier separates the last readout of S
// from its update, which the grid computes as a register-tiled K × K
// product over the chunk's steps. Everything runs on the CUDA cores in
// float32; exp is the accurate expf. At c = 128 and K = 64 the tiles take
// 208 KB of shared memory (dynamic, above the 48 KB default), so one block
// runs on an SM at a time.
//
// Bound on the H100. At the serving shape (8, 2048, 40, 64) in bf16 the
// call must move r, k, v and out (bf16), w (f32) and the state, about
// 509 MB: 0.15 ms at 3.35 TB/s, above its operations at the bf16 tensor-
// core rate. This kernel instead pays c(c−1)/2·K exps per chunk in the
// pair term (2.7 G at that shape) on the CUDA cores, and 320 blocks fill
// 132 SMs in three uneven waves. Sub-chunked factored decays (fewer exps),
// `wgmma` on the chunk's products and TMA-fed tiles are the later work;
// PERF.md records the kernel's time beside its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

}  // namespace

// C interface, loaded with ctypes. r, k, v and out are contiguous
// (B, S, H, K) of one type: float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// w is contiguous (B, S, H, K) float32, u (H, K) float32, state0 (B, H, K, K)
// float32 or null (a zero state), state_out (B, H, K, K) float32. K is a
// multiple of 8 up to 64, chunk divides S and is at most 128, B·H is at
// most 65535 (the wrapper checks all of it). `stream` is a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* state0,
                           void* out, void* state_out, int B, int S, int H,
                           int K, int chunk, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || S % chunk != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  return is_bf16 ? launch_k<__nv_bfloat16>(r, k, v, wf, uf, s0, out, so, B,
                                           S, H, K, chunk, st)
                 : launch_k<float>(r, k, v, wf, uf, s0, out, so, B, S, H, K,
                                   chunk, st);
}
