// FlashAttention-2 backward for Hopper (sm_90a), on the CUDA cores in float.
//
// Replaces repro/kernels/ops.py:_flash_bwd (XLA under the custom_vjp of
// flash_attention_xla; repro has no Pallas backward).  For q (B, Sq, H, D),
// k, v (B, Sk, KV, D), the forward's out and its row log-sum-exp lse
// (float32 (B, Sq, H), from flash_attention.cu) and the output gradient
// dout, bfloat16 or float32, it computes
//
//   P  = exp(scale q k^T - lse)            (masked entries 0)
//   dP = dout v^T,   delta = rowsum(dout * out)
//   dS = P * (dP - delta) * scale
//   dq = dS k,   dk = sum over the G = H / KV heads of a group of dS^T q,
//   dv = sum over the group of P^T dout
//
// with the masks of the forward (causal: key j <= i + Sk - Sq; window > 0:
// j > i + Sk - Sq - window).  Every product, P and dS are float; dq, dk and
// dv are rounded to the input type once.
//
// Deterministic by construction: no atomics.  Two kernels, each output
// element summed by one thread in a fixed order:
//   - dq_kernel, one block per (b * H + h, 64-query tile): loads the query
//     and dout tiles, computes delta for its rows (written to a float32
//     (B, Sq, H) scratch for the second kernel), then streams the 64-key
//     tiles the masks leave, recomputing S, P, dP and dS, and sums dS k;
//   - dkdv_kernel, one block per (b * KV + kv head, 64-key tile): keeps its
//     K and V tiles, loops over the G heads of the group and over the query
//     tiles that can see its keys, recomputes S^T, P^T, dP^T and dS^T, and
//     sums P^T dout and dS^T q for the whole group.
// So P and dP are computed twice (once per kernel): 14 D operations per
// visible (query, key) pair against the 10 D of a single pass with
// atomics, the price of bit-identical reruns (a restarted training run
// replays a clean one to the bit).
//
// What bounds it on the card: operations.  At smollm-135m's training
// shape (B = 8, S = 2048, H = 9, KV = 3, D = 64, causal) a call has
// 1.51e8 visible (query, key) pairs: the five products need 10 D = 640
// operations a pair, 9.7e10 in all, 0.098 ms at the 989 TFLOP/s bf16
// tensor-core peak of an H100 SXM; this kernel does 14 D a pair, 1.35e11,
// on the CUDA cores, whose float32 peak there (67 TFLOP/s) puts it at
// 2.0 ms or more.  It
// stays on the CUDA cores for both types: the simple kernel first, with
// tensor cores (P and dS as bf16 hi + lo halves, as the forward passes P)
// the next step.  Layout as in flash_attention.cu's float32
// kernel: 256 threads as a 16 x 16 grid, thread (ty, tx) owning rows
// ty + 16 i and columns tx + 16 j of a 64 x 64 score tile and columns
// 4 tx + 64 g of its accumulator rows; tiles in shared memory as float
// rows padded by 4, so the 16-byte loads of 8 threads hit 32 banks.
//
// Host side: flash_attention_bwd_launch checks the head dimension (64 or
// 128), launches both kernels on the caller's stream (dq_kernel first: it
// writes delta) and returns the first cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;               // query and key tile
constexpr int kPad = 4;
constexpr int kLP = kB + kPad;       // row stride of the score tiles

// 16 bytes of T as float
__device__ __forceinline__ void load16(const float* p, float* out) {
  kern::Vec<float>::load(p, out);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

// rows [r0, r0 + kB) of a (n, row_stride) matrix of T into a float tile
// with row stride D + kPad; rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long row_stride, int r0, int n) {
  constexpr int N = 16 / sizeof(T);
  constexpr int per_row = D / N;
  for (int idx = threadIdx.x; idx < kB * per_row; idx += kThreads) {
    const int r = idx / per_row, c = (idx % per_row) * N;
    float vals[N];
    if (r0 + r < n) {
      load16(src + (long)(r0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4)
      kern::store4(dst + r * (D + kPad) + c + e, vals[e], vals[e + 1],
                   vals[e + 2], vals[e + 3]);
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int causal, int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// s[i][j] = A[ra_i] . B[rb_j] and t[i][j] = C[ra_i] . E[rb_j] over D, for
// rows ra_i = ty + 16 i of A and C and rb_j = tx + 16 j of B and E
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* Bm,
                                             const float* C, const float* E,
                                             float (&s)[4][4],
                                             float (&t)[4][4]) {
  constexpr int LD = D + kPad;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], c[4], b[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
      c[i] = *reinterpret_cast<const float4*>(C + (ty + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LD + d);
      e[j] = *reinterpret_cast<const float4*>(E + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                   a[i].w * b[j].w;
        t[i][j] += c[i].x * e[j].x + c[i].y * e[j].y + c[i].z * e[j].z +
                   c[i].w * e[j].w;
      }
  }
}

// acc[i][4 g + e] += sum_kk W[ty + 16 i][kk] * X[kk][4 tx + 64 g + e]:
// rows of a 64 x 64 score tile W times a 64 x D tile X
template <int D>
__device__ __forceinline__ void tile_product(const float* W, const float* X,
                                             float (&acc)[4][D / 16]) {
  constexpr int LD = D + kPad;
  constexpr int CG = D / 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int kk = 0; kk < kB; ++kk) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(ty + 16 * i) * kLP + kk];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float4 x =
          *reinterpret_cast<const float4*>(X + kk * LD + 4 * tx + 64 * g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * g + 0] += w[i] * x.x;
        acc[i][4 * g + 1] += w[i] * x.y;
        acc[i][4 * g + 2] += w[i] * x.z;
        acc[i][4 * g + 3] += w[i] * x.w;
      }
    }
  }
}

template <int D>
constexpr int smem_bytes() {
  // four 64 x D tiles, two 64 x 64 score tiles, lse and delta
  return (4 * kB * (D + kPad) + 2 * kB * kLP + 2 * kB) * 4;
}

// ---- dq (and delta) ----------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const float* __restrict__ lse, const T* __restrict__ dout,
          float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
          int H, int KV, float scale, int causal, int window) {
  constexpr int LD = D + kPad;
  constexpr int CG = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* dSs = Vs + kB * LD;
  float* lse_s = dSs + 2 * kB * kLP;
  float* delta_s = lse_s + kB;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;   // heaviest tiles first
  const int off = Sk - Sq;
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  const long q_base = (long)b * Sq * q_stride + (long)h * D;
  const T* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const T* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  load_tile<T, D>(Qs, q + q_base, q_stride, q0, Sq);
  load_tile<T, D>(dOs, dout + q_base, q_stride, q0, Sq);
  __syncthreads();

  // delta = rowsum(dout * out): warp w takes rows w, w + 8, ...
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kB; r += kThreads / 32) {
    float sum = 0.f;
    if (q0 + r < Sq) {
      const T* orow = o + q_base + (long)(q0 + r) * q_stride;
      for (int d = lane; d < D; d += 32)
        sum += dOs[r * LD + d] * kern::to_f32(orow[d]);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, s);
    if (lane == 0) {
      delta_s[r] = sum;
      lse_s[r] = q0 + r < Sq ? lse[((long)b * Sq + q0 + r) * H + h] : 0.f;
      if (q0 + r < Sq) delta[((long)b * Sq + q0 + r) * H + h] = sum;
    }
  }

  // the key range some row of this tile may see
  const int q_lo = q0 + off, q_hi = min(q0 + kB, Sq) - 1 + off;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_hi + 1);
  if (window > 0) k_begin = max(0, q_lo - window + 1) / kB * kB;

  float acc[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kB) {
    __syncthreads();                   // the previous tile's readers are done
    load_tile<T, D>(Ks, kb, kv_stride, k0, Sk);
    load_tile<T, D>(Vs, vb, kv_stride, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = q0 + r < Sq && visible(qpos, k0 + c, Sk, causal,
                                               window);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * kLP + c] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();
    tile_product<D>(dSs, Ks, acc);
  }

  T* dqb = dq + q_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int g = 0; g < CG; ++g)
      kern::store4(dqb + (long)r * q_stride + 4 * tx + 64 * g,
                   acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                   acc[i][4 * g + 3]);
  }
}

// ---- dk, dv --------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ lse,
            const T* __restrict__ dout, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
            int KV, float scale, int causal, int window) {
  constexpr int LD = D + kPad;
  constexpr int CG = D / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* dOs = Qs + kB * LD;
  float* Ps = dOs + kB * LD;           // P^T: keys x queries
  float* dSs = Ps + kB * kLP;          // dS^T
  float* lse_s = dSs + kB * kLP;
  float* delta_s = lse_s + kB;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * kB;      // early key tiles see the most queries
  const int off = Sk - Sq;
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  const long kv_base = (long)b * Sk * kv_stride + (long)kvh * D;

  load_tile<T, D>(Ks, k + kv_base, kv_stride, k0, Sk);
  load_tile<T, D>(Vs, v + kv_base, kv_stride, k0, Sk);

  // the query range that may see some key of this tile
  int qi_begin = 0, qi_end = Sq;
  if (causal) qi_begin = max(0, k0 - off) / kB * kB;
  if (window > 0) qi_end = max(0, min(Sq, k0 + kB - 1 + window - off));

  float adk[4][4 * CG], adv[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long q_base = (long)b * Sq * q_stride + (long)h * D;
    for (int q0 = qi_begin; q0 < qi_end; q0 += kB) {
      __syncthreads();                 // the previous tile's readers are done
      load_tile<T, D>(Qs, q + q_base, q_stride, q0, Sq);
      load_tile<T, D>(dOs, dout + q_base, q_stride, q0, Sq);
      if (threadIdx.x < kB) {
        const int r = q0 + threadIdx.x;
        const long at = ((long)b * Sq + r) * H + h;
        lse_s[threadIdx.x] = r < Sq ? lse[at] : 0.f;
        delta_s[threadIdx.x] = r < Sq ? delta[at] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];         // transposed: rows are keys
      two_products<D>(Ks, Qs, Vs, dOs, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = q0 + c < Sq && visible(q0 + c + off, k0 + kr, Sk,
                                                 causal, window);
          const float p = ok ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
          Ps[kr * kLP + c] = p;
          dSs[kr * kLP + c] = p * (dp[i][j] - delta_s[c]) * scale;
        }
      }
      __syncthreads();
      tile_product<D>(Ps, dOs, adv);
      tile_product<D>(dSs, Qs, adk);
    }
  }

  T* dkb = dk + kv_base;
  T* dvb = dv + kv_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= Sk) continue;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int c = 4 * tx + 64 * g;
      kern::store4(dkb + (long)r * kv_stride + c, adk[i][4 * g],
                   adk[i][4 * g + 1], adk[i][4 * g + 2], adk[i][4 * g + 3]);
      kern::store4(dvb + (long)r * kv_stride + c, adv[i][4 * g],
                   adv[i][4 * g + 1], adv[i][4 * g + 2], adv[i][4 * g + 3]);
    }
  }
}

// ---- host side -------------------------------------------------------------

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, float* delta, void* dq,
                   void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kq = dq_kernel<T, D>;
  auto kkv = dkdv_kernel<T, D>;
  // Set on every launch: the opt-in is per device, and the call is cheap
  // and allowed while a stream is captured.
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kq<<<dim3(B * H, (Sq + kB - 1) / kB), kThreads, bytes, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), lse, dot, delta,
      static_cast<T*>(dq), Sq, Sk, H, KV, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3(B * KV, (Sk + kB - 1) / kB), kThreads, bytes, stream>>>(
      qt, kt, vt, lse, dot, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, KV, scale, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_typed(int dtype, const void* q, const void* k,
                         const void* v, const void* o, const float* lse,
                         const void* dout, float* delta, void* dq, void* dk,
                         void* dv, int B, int Sq, int Sk, int H, int KV,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq,
                            Sk, H, KV, scale, causal, window, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, lse, dout, delta, dq, dk,
                                    dv, B, Sq, Sk, H, KV, scale, causal,
                                    window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  lse and delta: float32 (B, Sq, H);
// delta is scratch the call fills.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int KV, int D,
    float scale, int causal, int window, void* stream) {
  if (B * H == 0 || Sk == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {
    case 64:
      return launch_typed<64>(dtype, q, k, v, o, l, dout, dl, dq, dk, dv, B,
                              Sq, Sk, H, KV, scale, causal, window, s);
    case 128:
      return launch_typed<128>(dtype, q, k, v, o, l, dout, dl, dq, dk, dv, B,
                               Sq, Sk, H, KV, scale, causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
