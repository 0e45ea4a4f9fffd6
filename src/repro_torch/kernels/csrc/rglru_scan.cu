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
// Reaching the byte rate takes ~25 KB in flight per SM (3.35 TB/s at ~1 us
// of latency).  A thread per channel that loads its own steps keeps only
// ~10 KB in flight per SM (2-byte loads, 64 bytes a warp), ~43 % of the
// rate.  So each channel's chain stays sequential in one thread (the
// result is bit-identical to linear_recurrence_plain), and the loads move
// to the TMA unit:
//   - A block owns 128 channels of one batch row (B * W / 128 = 160
//     blocks at the serving shape, all resident) and walks S in chunks of
//     32 steps (bf16; 16 in float32), so a chunk of a or b is one 8 KB box
//     of a 3-d tensor map over (W, S, B) whose rows are 256 contiguous
//     bytes (64-channel slices of 128 bytes measured 20 % slower).
//   - Thread 0 keeps a 3-stage ring of (a, b) chunks in flight, 48 KB per
//     block, each stage completing on its mbarrier.
//   - The 128 threads (one per channel) run the chain from shared memory
//     and write h into one of two output tiles; after a barrier thread 0
//     stores the tile with one TMA store and refills the stage just read.
//     Before that barrier it waits until the previous store has read its
//     tile, the one the next chunk writes.
//   - Ragged edges need no masks in the loop: TMA reads zeros past S and W
//     and stores nothing there; the chain stops at S for h_last, and only
//     channels < W read h0 or write h_last.
// The tensor maps need rows of a multiple of 16 bytes and 16-byte aligned
// tensors.  Where those fail, and for S < kMinChunkedSteps (a decode step,
// where the launch is all the cost), the loop kernel below runs instead:
// one thread per channel, 16 steps of loads issued before their chain.
// The choice depends on the shape and alignment alone; a call that the
// chunked kernel should take but whose maps cannot be made fails.
//
// Rounding: built with -fmad=false (kernels/_build.py), so a * h + b
// rounds twice, as linear_recurrence_plain's separate multiply and add do.
//
// Host side: linear_recurrence_launch picks the kernel, builds the three
// TMA maps (cuTensorMapEncodeTiled through hop::encode_tiled), launches on
// the caller's stream, says which kernel it launched, and returns the
// launch's cudaError_t.  One launch a call either way.
//
// The backward (linear_recurrence_bwd_launch, linrec_bwd_kernel) replaces
// XLA's autodiff of repro/kernels/ops.py:252-274 linear_recurrence(impl=
// "assoc"), which repro/models/rglru.py trains through.  Given g_t = dL/dh_t
// and g_last = dL/dh_last (either may be absent) it runs the forward's
// chain in reverse:
//
//   dh_{S-1} = g_{S-1} + g_last,   dh_t = g_t + a_{t+1} dh_{t+1}
//   da_t = dh_t h_{t-1},   db_t = dh_t,   dh0 = a_0 dh_0
//
// with dh carried in float and each output rounded to the input type once,
// the arithmetic (and, under -fmad=false, the rounding) of torch.autograd
// through linear_recurrence_plain.  h_{t-1} is the float32 STATE, not the
// output rounded from it: when autograd records, the forward is launched
// with a float32 ``states`` output (the kernels' kStates instances write
// every h_t before rounding it), which costs 4 more bytes an element in
// the forward (6 -> 10 in bf16) and a float32 (B, S, W) tensor kept for the
// backward (42 MB a layer at B = 2, S = 2048, W = 2560; under remat only
// the layer being recomputed holds one).  One thread a channel walks t
// from S - 1 down to 0, kBwdUnroll steps of loads issued before their
// chain, so the result is deterministic and bit-identical to the plain
// version.
//
// What bounds the backward: bytes.  a, g (T) and the states (float) in,
// da and db (T) out: 12 bytes an element in bf16 (20 in float32), plus h0,
// g_last and dh0 (B, W).  At a recurrentgemma-2b microbatch (B = 2,
// S = 2048, W = 2560) that is 125.8 MB, 0.0376 ms at 3.35 TB/s.  The loop
// keeps ~kBwdUnroll x 8 bytes a thread in flight, far from the ~25 KB an
// SM the byte rate needs (the forward's chunked kernel moves its loads to
// TMA for this reason); a reverse TMA ring is the design to reach for if
// the backward shows in a train step.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---- the loop kernel: S < kMinChunkedSteps, or rows TMA cannot address ----

constexpr int kLoopThreads = 64;
constexpr int kUnroll = 16;

// kStates: also write every float32 state h_t to ``states`` (B, S, W), for
// the backward.
template <typename T, bool kStates>
__global__ void __launch_bounds__(kLoopThreads)
linrec_loop_kernel(const T* __restrict__ a, const T* __restrict__ bv,
                   const T* __restrict__ h0, T* __restrict__ out,
                   T* __restrict__ h_last, float* __restrict__ states, int B,
                   int S, int W) {
  const int idx = blockIdx.x * kLoopThreads + threadIdx.x;
  if (idx >= B * W) return;
  const long base = (long)(idx / W) * S * W + idx % W;
  const T* pa = a + base;
  const T* pb = bv + base;
  T* po = out + base;
  float* ps = kStates ? states + base : nullptr;
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
        if constexpr (kStates) ps[u * W] = h;
      }
    }
    pa += (long)kUnroll * W;
    pb += (long)kUnroll * W;
    po += (long)kUnroll * W;
    if constexpr (kStates) ps += (long)kUnroll * W;
  }
  h_last[idx] = kern::from_f32<T>(h);
}

// ---- the chunked kernel: TMA ring in, TMA stores out ------------------------

constexpr int kChannels = 128;         // channels a block, one thread each
constexpr int kStages = 3;             // (a, b) chunks in flight
constexpr int kMinChunkedSteps = 16;

template <typename T>
struct Chunk {
  static constexpr int kTileBytes = 8192;            // one (steps x slice) box
  static constexpr int kSteps = kTileBytes / (kChannels * sizeof(T));
  // a ring of kStages (a, b) tile pairs, two output tiles, the mbarriers
  static constexpr int kSmemBytes =
      (2 * kStages + 2) * kTileBytes + kStages * 8;
};

// Thread 0: chunk n of a and b (steps n * kSteps ..) into stage n % kStages,
// completing on that stage's mbarrier.
template <typename T>
__device__ __forceinline__ void load_chunk(unsigned char* ring,
                                           uint64_t* full,
                                           const CUtensorMap* map_a,
                                           const CUtensorMap* map_b, int n,
                                           int c0, int bi) {
  using C = Chunk<T>;
  const int st = n % kStages;
  unsigned char* dst = ring + 2 * st * C::kTileBytes;
  hop::mbar_expect_tx(&full[st], 2 * C::kTileBytes);
  hop::tma_load_3d(dst, map_a, &full[st], c0, n * C::kSteps, bi);
  hop::tma_load_3d(dst + C::kTileBytes, map_b, &full[st], c0, n * C::kSteps,
                   bi);
}

template <typename T, bool kStates>
__global__ void __launch_bounds__(kChannels)
linrec_chunked_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const __grid_constant__ CUtensorMap map_out,
                      const T* __restrict__ h0, T* __restrict__ h_last,
                      float* __restrict__ states, int S, int W) {
  using C = Chunk<T>;
  constexpr int TS = C::kSteps;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  T* tiles_out = reinterpret_cast<T*>(smem + 2 * kStages * C::kTileBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + (2 * kStages + 2) * C::kTileBytes);
  const int c = threadIdx.x;
  const int c0 = blockIdx.x * kChannels;
  const int bi = blockIdx.y;
  const int chunks = (S + TS - 1) / TS;

  if (c == 0) {
    for (int st = 0; st < kStages; ++st) hop::mbar_init(&full[st], 1);
    hop::fence_mbar_init();
  }
  __syncthreads();
  if (c == 0)
    for (int n = 0; n < kStages && n < chunks; ++n)
      load_chunk<T>(ring, full, &map_a, &map_b, n, c0, bi);

  const bool valid = c0 + c < W;
  const size_t row = (size_t)bi * W + c0 + c;
  float h = (h0 != nullptr && valid) ? kern::to_f32(h0[row]) : 0.f;
  // this channel's float32 states, row t at ps[t * W] (kStates)
  float* ps = kStates ? states + (size_t)bi * S * W + c0 + c : nullptr;
  for (int n = 0; n < chunks; ++n) {
    const int st = n % kStages;
    hop::mbar_wait(&full[st], (n / kStages) & 1);
    const T* ta = reinterpret_cast<const T*>(ring + 2 * st * C::kTileBytes);
    const T* tb = ta + TS * kChannels;
    T* to = tiles_out + (n & 1) * TS * kChannels;
    const int steps = min(TS, S - n * TS);
    float* pst = kStates ? ps + (size_t)n * TS * W : nullptr;
    if (steps == TS) {
#pragma unroll 16
      for (int u = 0; u < TS; ++u) {
        h = kern::to_f32(ta[u * kChannels + c]) * h +
            kern::to_f32(tb[u * kChannels + c]);
        to[u * kChannels + c] = kern::from_f32<T>(h);
        if constexpr (kStates)
          if (valid) pst[(size_t)u * W] = h;
      }
    } else {
      for (int u = 0; u < steps; ++u) {
        h = kern::to_f32(ta[u * kChannels + c]) * h +
            kern::to_f32(tb[u * kChannels + c]);
        to[u * kChannels + c] = kern::from_f32<T>(h);
        if constexpr (kStates)
          if (valid) pst[(size_t)u * W] = h;
      }
    }
    hop::fence_proxy_async();   // this thread's tile writes, before the store
    if (c == 0) hop::bulk_wait_read<0>();  // store n-1 has read tile (n+1)&1
    __syncthreads();            // stage st read, tile n&1 written
    if (c == 0) {
      hop::tma_store_3d(&map_out, to, c0, n * TS, bi);
      hop::bulk_commit();
      if (n + kStages < chunks)
        load_chunk<T>(ring, full, &map_a, &map_b, n + kStages, c0, bi);
    }
  }
  if (valid) h_last[row] = kern::from_f32<T>(h);
  if (c == 0) hop::bulk_wait_all();
}

// The map of a (B, S, W) tensor of T in boxes of kChannels x Chunk<T>::kSteps
// x 1; false where cuTensorMapEncodeTiled is missing or refuses it.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int W) {
  hop::EncodeTiledFn encode = hop::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * sizeof(T),
                                 (cuuint64_t)S * W * sizeof(T)};
  const cuuint32_t box[3] = {kChannels, Chunk<T>::kSteps, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The kernel a call runs, from its shape and alignment alone: the chunked
// kernel where S >= kMinChunkedSteps and TMA can address the rows (a
// multiple of 16 bytes, 16-byte aligned tensors), else the loop kernel.
template <typename T>
bool use_chunked(const void* a, const void* b, const void* out, int S,
                 int W) {
  return S >= kMinChunkedSteps && ((long)W * sizeof(T)) % 16 == 0 &&
         aligned16(a) && aligned16(b) && aligned16(out);
}

template <typename T, bool kStates>
cudaError_t launch(const void* a, const void* b, const void* h0, void* out,
                   void* h_last, float* states, int B, int S, int W,
                   int* kernel_run, cudaStream_t stream) {
  if (!use_chunked<T>(a, b, out, S, W)) {
    const int blocks = (B * W + kLoopThreads - 1) / kLoopThreads;
    linrec_loop_kernel<T, kStates><<<blocks, kLoopThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<const T*>(h0), static_cast<T*>(out),
        static_cast<T*>(h_last), states, B, S, W);
    *kernel_run = 0;
    return cudaGetLastError();
  }
  // An eligible shape whose maps cannot be made is an error, as in
  // flash_attention.cu, not a quiet fall back to the loop kernel.
  CUtensorMap ma, mb, mo;
  if (!tensor_map<T>(&ma, a, B, S, W) || !tensor_map<T>(&mb, b, B, S, W) ||
      !tensor_map<T>(&mo, out, B, S, W))
    return cudaErrorInvalidValue;
  auto kernel = linrec_chunked_kernel<T, kStates>;
  // Set on every launch: the opt-in is per device, and the call is cheap
  // and allowed while a stream is captured.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Chunk<T>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kChannels - 1) / kChannels, B);
  kernel<<<grid, kChannels, Chunk<T>::kSmemBytes, stream>>>(
      ma, mb, mo, static_cast<const T*>(h0), static_cast<T*>(h_last), states,
      S, W);
  *kernel_run = 1;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* a, const void* b, const void* h0,
                       void* out, void* h_last, float* states, int B, int S,
                       int W, int* kernel_run, cudaStream_t stream) {
  if (states != nullptr)
    return launch<T, true>(a, b, h0, out, h_last, states, B, S, W,
                            kernel_run, stream);
  return launch<T, false>(a, b, h0, out, h_last, nullptr, B, S, W,
                          kernel_run, stream);
}

// ---- the backward: the chain in reverse, one thread a channel ------------

constexpr int kBwdThreads = 32;        // 160 blocks at B = 2, W = 2560
constexpr int kBwdUnroll = 32;

// states: the forward's float32 h_t (B, S, W).  g_last, h0 and dh0 may be
// null (no gradient of h_last, a zero initial state, no gradient of h0
// wanted); g is read only by the kHasG instance.  Each group of kBwdUnroll
// steps first loads its a, g and states, unconverted and unconditionally
// (rows past 0 clamped to row 0, their values unused), then runs the
// chain: a conversion next to its load, or a load under its own branch,
// would wait for each load in turn.
template <typename T, bool kHasG>
__global__ void __launch_bounds__(kBwdThreads)
linrec_bwd_kernel(const T* __restrict__ a, const float* __restrict__ states,
                  const T* __restrict__ g, const T* __restrict__ g_last,
                  const T* __restrict__ h0, T* __restrict__ da,
                  T* __restrict__ db, T* __restrict__ dh0, int B, int S,
                  int W) {
  const int idx = blockIdx.x * kBwdThreads + threadIdx.x;
  if (idx >= B * W) return;
  const long base = (long)(idx / W) * S * W + idx % W;
  const float h_init = h0 ? kern::to_f32(h0[idx]) : 0.f;
  // carry = a_{t+1} dh_{t+1}, or g_last before the last step
  float carry = g_last ? kern::to_f32(g_last[idx]) : 0.f;
  for (int t0 = S - 1; t0 >= 0; t0 -= kBwdUnroll) {
    T ra[kBwdUnroll], rg[kBwdUnroll];
    float rh[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int t = max(t0 - u, 0);
      const long at_t = base + (long)t * W;
      ra[u] = a[at_t];
      if constexpr (kHasG) rg[u] = g[at_t];
      rh[u] = states[base + (long)max(t - 1, 0) * W];
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const long at_t = base + (long)t * W;
        float dh = carry;
        if constexpr (kHasG) dh = kern::to_f32(rg[u]) + carry;
        da[at_t] = kern::from_f32<T>(dh * (t > 0 ? rh[u] : h_init));
        db[at_t] = kern::from_f32<T>(dh);
        carry = dh * kern::to_f32(ra[u]);
      }
    }
  }
  if (dh0) dh0[idx] = kern::from_f32<T>(carry);
}

template <typename T>
cudaError_t launch_bwd(const void* a, const float* states, const void* g,
                       const void* g_last, const void* h0, void* da,
                       void* db, void* dh0, int B, int S, int W,
                       cudaStream_t stream) {
  const int blocks = (B * W + kBwdThreads - 1) / kBwdThreads;
  auto kernel = g != nullptr ? linrec_bwd_kernel<T, true>
                             : linrec_bwd_kernel<T, false>;
  kernel<<<blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(a), states, static_cast<const T*>(g),
      static_cast<const T*>(g_last), static_cast<const T*>(h0),
      static_cast<T*>(da), static_cast<T*>(db), static_cast<T*>(dh0), B, S,
      W);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* linear_recurrence_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16; h0 may be null (a zero state);
// states, float32 (B, S, W), may be null, else every h_t is written there
// too.  *kernel_run is set to the kernel launched: 0 = loop, 1 = chunked
// (left as it was when nothing is launched).  Returns a cudaError_t (0 on
// success).
extern "C" int linear_recurrence_launch(const void* a, const void* b,
                                        const void* h0, void* out,
                                        void* h_last, void* states,
                                        int dtype, int B, int S, int W,
                                        int* kernel_run, void* stream) {
  if (B * W == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(states);
  if (dtype == 0)
    return launch_fwd<float>(a, b, h0, out, h_last, st, B, S, W, kernel_run,
                             s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(a, b, h0, out, h_last, st, B, S, W,
                                     kernel_run, s);
  return cudaErrorInvalidValue;
}

// The backward: a (B, S, W) and the forward's float32 states; g (B, S, W),
// g_last, h0 and dh0 (B, W) may each be null.  Writes da, db (B, S, W) and,
// where dh0 is given, dh0, all in the input type.  One launch; returns a
// cudaError_t (0 on success, also when B * W == 0 and nothing launches).
extern "C" int linear_recurrence_bwd_launch(const void* a,
                                            const void* states,
                                            const void* g, const void* g_last,
                                            const void* h0, void* da,
                                            void* db, void* dh0, int dtype,
                                            int B, int S, int W,
                                            void* stream) {
  if (B * W == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(states);
  if (dtype == 0)
    return launch_bwd<float>(a, st, g, g_last, h0, da, db, dh0, B, S, W, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, st, g, g_last, h0, da, db, dh0, B,
                                     S, W, s);
  return cudaErrorInvalidValue;
}
