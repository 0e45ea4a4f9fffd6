// Single-token GQA flash-decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel).  For q (B, H, D), caches k, v
// (B, S, KV, D), float32 or bfloat16, and lengths (B,) int32 it computes
//
//   out[b, h] = softmax_{j < lengths[b]}(scale * q[b, h] . k[b, j, h / G])
//               v[b, j, h / G]
//
// (G = H / KV query heads per key/value head), in float, rounded to the
// input type once.
//
// What bounds it on the card: bytes.  The caches are read once: 16.8 MB at
// the serving path's decode (B = 8, S = 2048, KV = 1, D = 256, bf16), 5 us
// at 3.35 TB/s, while the products are ~4 flop per cache byte.
//
// Layout: B * KV blocks alone would fill 8 of 132 SMs, so the cache is
// split along the sequence, with a second pass to combine (the TPU kernel
// streams the whole sequence through one program instead).
//   1. decode_partial_kernel, grid (ceil(S / 64), B * KV), one warp per
//      query head of the group (G * 32 threads).  The block copies its
//      64-key chunk of K and V into shared memory in the storage type with
//      16-byte loads, each warp scores the chunk's keys against its head
//      (lane l holds elements l * D/32 .. of q and of each key, a
//      shuffle reduction finishes each dot product), and writes the chunk's
//      max m, sum l = sum exp(s - m) and accumulator sum exp(s - m) v as
//      float.  Chunks at or past lengths[b] exit at once.
//   2. decode_combine_kernel, grid (B * H), D threads, rescales the
//      chunks' partial sums to their common max and divides.
// The partial sums add 2 * 4 * D * H bytes per chunk of 64 keys
// (2.6 MB each way at the serving shape) to the cache's 16.8 MB.
//
// Host side: decode_attention_launch runs both passes on the caller's
// stream into caller-provided scratch and returns the first cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 64;
constexpr float kNegInf = -1e30f;   // the masked logit of the reference

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int clamp_len(const int* lengths, int b, int S) {
  return min(max(lengths[b], 0), S);
}

template <typename T, int D>
__global__ void decode_partial_kernel(const T* __restrict__ q,
                                      const T* __restrict__ kc,
                                      const T* __restrict__ vc,
                                      const int* __restrict__ lengths,
                                      float* __restrict__ pm,
                                      float* __restrict__ pl,
                                      float* __restrict__ pacc, int B, int S,
                                      int H, int KV, float scale) {
  constexpr int E = D / 32;           // elements per lane
  constexpr int N = kern::Vec<T>::N;  // elements per 16-byte copy
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);
  T* Vs = Ks + kChunk * D;

  const int split = blockIdx.x;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int len = clamp_len(lengths, b, S);
  const int s0 = split * kChunk;
  if (s0 >= len) return;              // uniform across the block
  const int n = min(kChunk, len - s0);

  const long row = (long)KV * D;
  const T* kb = kc + ((long)b * S + s0) * row + (long)kvh * D;
  const T* vb = vc + ((long)b * S + s0) * row + (long)kvh * D;
  for (int idx = threadIdx.x; idx < n * (D / N); idx += blockDim.x) {
    const int r = idx / (D / N), c = (idx % (D / N)) * N;
    *reinterpret_cast<uint4*>(Ks + r * D + c) =
        *reinterpret_cast<const uint4*>(kb + r * row + c);
    *reinterpret_cast<uint4*>(Vs + r * D + c) =
        *reinterpret_cast<const uint4*>(vb + r * row + c);
  }

  const int lane = threadIdx.x & 31;
  const int h = kvh * (H / KV) + (threadIdx.x >> 5);
  float qv[E];
  kern::load_f32<T, E>(q + ((long)b * H + h) * D + lane * E, qv);
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] *= scale;
  __syncthreads();

  float s[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    float kv[E];
    kern::load_f32<T, E>(Ks + j * D + lane * E, kv);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) part += qv[e] * kv[e];
    s[j] = warp_sum(part);
  }
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    if (j < n) mx = fmaxf(mx, s[j]);
  float l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j < n) {
      const float p = expf(s[j] - mx);
      float vv[E];
      kern::load_f32<T, E>(Vs + j * D + lane * E, vv);
      l += p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += p * vv[e];
    }
  }
  const long idx = ((long)split * B + b) * H + h;
  if (lane == 0) {
    pm[idx] = mx;
    pl[idx] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) pacc[idx * D + lane * E + e] = acc[e];
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ pm,
                                      const float* __restrict__ pl,
                                      const float* __restrict__ pacc,
                                      const int* __restrict__ lengths,
                                      T* __restrict__ out, int B, int S,
                                      int H, int D) {
  const int b = blockIdx.x / H, h = blockIdx.x % H, d = threadIdx.x;
  const int n = (clamp_len(lengths, b, S) + kChunk - 1) / kChunk;
  float M = kNegInf;
  for (int i = 0; i < n; ++i) M = fmaxf(M, pm[((long)i * B + b) * H + h]);
  float L = 0.f, A = 0.f;
  for (int i = 0; i < n; ++i) {
    const long idx = ((long)i * B + b) * H + h;
    const float w = expf(pm[idx] - M);
    L += pl[idx] * w;
    A += pacc[idx * D + d] * w;
  }
  out[((long)b * H + h) * D + d] = kern::from_f32<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, float* pm, float* pl, float* pacc,
                   void* out, int B, int S, int H, int KV, float scale,
                   cudaStream_t stream) {
  auto partial = decode_partial_kernel<T, D>;
  const int bytes = 2 * kChunk * D * sizeof(T);
  static bool configured = false;   // once per instance, outside any capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        partial, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((S + kChunk - 1) / kChunk, B * KV);
  partial<<<grid, 32 * (H / KV), bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, pm, pl, pacc, B, S, H, KV, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * H, D, 0, stream>>>(
      pm, pl, pacc, lengths, static_cast<T*>(out), B, S, H, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const int* lengths, float* pm, float* pl, float* pacc,
                     void* out, int B, int S, int H, int KV, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, pm, pl, pacc, out, B, S, H, KV,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, pm, pl, pacc, out, B, S, H,
                            KV, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, pm, pl, pacc, out, B, S, H,
                            KV, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_chunk() { return kChunk; }

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  pm, pl: (ceil(S / chunk), B, H) and
// pacc: (ceil(S / chunk), B, H, D) float scratch.  Returns a cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       float* pm, float* pl, float* pacc,
                                       void* out, int dtype, int B, int S,
                                       int H, int KV, int D, float scale,
                                       void* stream) {
  if (B * H == 0 || S == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, lengths, pm, pl, pacc, out, B, S, H,
                           KV, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, lengths, pm, pl, pacc, out, B,
                                   S, H, KV, scale, s);
  return cudaErrorInvalidValue;
}
