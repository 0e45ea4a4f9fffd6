// Gated linear recurrence (the RG-LRU core) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py
// (linear_recurrence / _rglru_kernel).  For a, b (B, S, W) and h0 (B, W),
// float32 or bfloat16, it computes
//
//   h_t = a_t * h_{t-1} + b_t   (h_{-1} = h0, or 0 without one)
//
// with the state carried in float, writes every h_t rounded to the input
// type, and h_last = h_{S-1} rounded the same way.
//
// What bounds it on the card: bytes.  Two operations per element against
// 6 bytes moved in bf16: at the serving path's prefill (B = 8, S = 2048,
// W = 2560) a, b in and h out are 252 MB, 75 us at 3.35 TB/s; a decode
// step (S = 1) moves 123 KB and is bound by the launch itself.
//
// Layout: one thread per (b, w) channel, 64 threads a block (B * W =
// 20,480 threads in 320 blocks at the serving shape), looping over S.
// Neighbouring threads take neighbouring w, so every load and store of a
// time step is coalesced along W.  The loop is unrolled by 16 with the 32
// loads of a step group issued before the dependent chain, so that each
// thread keeps loads in flight; the sequence is not split across threads
// (a chunked two-pass scan is later work).
//
// Rounding: built with -fmad=false (kernels/_build.py), so a * h + b
// rounds twice, as linear_recurrence_plain's separate multiply and add do.
//
// Host side: linear_recurrence_launch launches on the caller's stream and
// returns the launch's cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
linrec_kernel(const T* __restrict__ a, const T* __restrict__ bv,
              const T* __restrict__ h0, T* __restrict__ out,
              T* __restrict__ h_last, int B, int S, int W) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * W) return;
  const long base = (long)(idx / W) * S * W + idx % W;
  const T* pa = a + base;
  const T* pb = bv + base;
  T* po = out + base;
  float h = h0 ? kern::to_f32(h0[idx]) : 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    // offsets from this step group's row, so the 32 loads share one base
    float at[kUnroll], bt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        at[u] = kern::to_f32(pa[u * W]);
        bt[u] = kern::to_f32(pb[u * W]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        h = at[u] * h + bt[u];
        po[u * W] = kern::from_f32<T>(h);
      }
    }
    pa += (long)kUnroll * W;
    pb += (long)kUnroll * W;
    po += (long)kUnroll * W;
  }
  h_last[idx] = kern::from_f32<T>(h);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* out,
                   void* h_last, int B, int S, int W, cudaStream_t stream) {
  const int blocks = (B * W + kThreads - 1) / kThreads;
  linrec_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(h0), static_cast<T*>(out),
      static_cast<T*>(h_last), B, S, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* linear_recurrence_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16; h0 may be null (a zero state).
// Returns a cudaError_t (0 on success).
extern "C" int linear_recurrence_launch(const void* a, const void* b,
                                        const void* h0, void* out,
                                        void* h_last, int dtype, int B,
                                        int S, int W, void* stream) {
  if (B * W == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, out, h_last, B, S, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, out, h_last, B, S, W, s);
  return cudaErrorInvalidValue;
}
