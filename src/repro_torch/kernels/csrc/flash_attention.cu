// FlashAttention-2 forward for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _fa_kernel).  For q (B, Sq, H, D) and k, v
// (B, Sk, KV, D), float32 or bfloat16, it computes
//
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / G]) v[b, j, h / G]
//
// over the keys j that query i may see: j <= i + (Sk - Sq) when causal and
// j > i + (Sk - Sq) - window when window > 0 (G = H / KV query heads share
// one key/value head).  Softmax statistics and the accumulator are float;
// the output is rounded to the input type once.
//
// What bounds it on the card: operations.  At the serving path's prefill
// (B = 8, S = 2048, H = 10, KV = 1, D = 256, causal) one call does 1.72e11
// FLOP and moves 185 MB (q, k, v in, out back): 0.17 ms at the bf16 peak
// of the tensor cores and 2.6 ms at the float32 peak of the CUDA cores.
// This first kernel computes in float32 on the CUDA cores (tensor cores
// through mma.sync / wgmma are later work), so the float32 peak is what it
// can approach.
//
// Layout: one block of 256 threads per (64-query tile, b * H + h); the
// late (heaviest, under the causal mask) query tiles are scheduled first.
// The block holds its query tile, one 64-key tile of K and of V, and the
// 64 x 64 probability tile in shared memory as float (rows padded by 4
// floats so 16-byte reads of neighbouring rows fall in different banks;
// 212 KB at D = 256).  It streams key tiles over the range the causal and
// window masks leave (fully masked tiles are never loaded) with a running
// max and sum per query row (online softmax).  Thread (ty, tx) of the
// 16 x 16 grid owns rows ty + 16 i (i < 4): for S = Q K^T it owns columns
// tx + 16 j (j < 4) and reads Q and K as float4 along D; for O += P V it
// owns the float4 column groups 4 tx + 64 g.  Rows of a tile are reduced
// across the 16 lanes that share ty with warp shuffles.  Ragged edges
// (Sq or Sk not a multiple of 64) are masked, so any length works.
//
// Host side: flash_attention_launch picks the instance for (type, D),
// launches on the caller's stream and returns the launch's cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kPad = 4;
constexpr float kNegInf = -1e30f;   // the masked logit of the reference

template <int D>
constexpr int smem_bytes() {
  return ((kBQ + 2 * kBK) * (D + kPad) + kBQ * (kBK + kPad)) * 4;
}

// rows [r0, r0 + rows) of a (n, row_stride) matrix into a float tile with
// row stride D + kPad; rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long row_stride, int r0, int n,
                                          int rows) {
  constexpr int N = kern::Vec<T>::N;
  constexpr int per_row = D / N;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row, c = (idx % per_row) * N;
    float vals[N];
    if (r0 + r < n) {
      kern::Vec<T>::load(src + (long)(r0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      kern::store4(dst + r * (D + kPad) + c + e, vals[e], vals[e + 1],
                   vals[e + 2], vals[e + 3]);
    }
  }
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, float scale, int causal, int window) {
  constexpr int LD = D + kPad;
  constexpr int LP = kBK + kPad;
  constexpr int RI = kBQ / 16;        // rows per thread
  constexpr int CJ = kBK / 16;        // score columns per thread
  constexpr int CG = D / 64;          // float4 output column groups
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int off = Sk - Sq;
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  const T* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const T* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const T* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  load_tile<T, D>(Qs, qb, q_stride, q0, Sq, kBQ);

  // the key range some row of this tile may see
  const int q_lo = q0 + off, q_hi = min(q0 + kBQ, Sq) - 1 + off;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_hi + 1);
  if (window > 0) k_begin = max(0, q_lo - window + 1) / kBK * kBK;

  float m[RI], l[RI], acc[RI][4 * CG];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                  // the previous tile's readers are done
    load_tile<T, D>(Ks, kb, kv_stride, k0, Sk, kBK);
    load_tile<T, D>(Vs, vb, kv_stride, k0, Sk, kBK);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i + off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CG; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = Ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + kk * LD + 4 * tx + 64 * g);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          acc[i][4 * g + 0] += p[i] * vv.x;
          acc[i][4 * g + 1] += p[i] * vv.y;
          acc[i][4 * g + 2] += p[i] * vv.z;
          acc[i][4 * g + 3] += p[i] * vv.w;
        }
      }
    }
  }

  T* ob = o + (long)b * Sq * q_stride + (long)h * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      kern::store4(ob + (long)r * q_stride + 4 * tx + 64 * g,
                   acc[i][4 * g] / den, acc[i][4 * g + 1] / den,
                   acc[i][4 * g + 2] / den, acc[i][4 * g + 3] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KV, float scale,
                   int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;   // once per instance, outside any capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int Sq, int Sk, int H, int KV,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                            window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int D, float scale, int causal,
                                      int window, void* stream) {
  if (Sq == 0 || B * H == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                           window, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, KV, scale,
                                   causal, window, s);
  return cudaErrorInvalidValue;
}
