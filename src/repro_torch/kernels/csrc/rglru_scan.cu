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
// The backward (linear_recurrence_bwd_launch) replaces XLA's autodiff of
// repro/kernels/ops.py:252-274 linear_recurrence(impl="assoc"), which
// repro/models/rglru.py trains through.  Given g_t = dL/dh_t and g_last =
// dL/dh_last (either may be absent) it runs the forward's chain in reverse:
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
// the layer being recomputed holds one).  Each channel's chain runs in one
// thread, t from S - 1 down to 0, in this order: dh = g + carry, da = dh h,
// carry = dh a.  So the result is deterministic and bit-identical to the
// plain version; a segmented or associative scan would round otherwise.
//
// What bounds the backward: bytes.  a, g (T) and the states (float) in,
// da and db (T) out: 12 bytes an element in bf16 (20 in float32), plus h0,
// g_last and dh0 (B, W).  At a recurrentgemma-2b training microbatch
// (B = 2, S = 2048, W = 2560) that is 125.8 MB, 0.0376 ms at 3.35 TB/s.
// The chain is ~12 instructions a step on a dependent add and multiply,
// ~2048 x 12 cycles ~ 14 us a thread, under that bound if the loads
// overlap it.  Reaching the byte rate takes 3.35 TB/s x ~1 us of latency
// ~ 3.4 MB in flight on the card, ~21 KB a block at 160 blocks.  A thread
// per channel loading its own steps (the loop kernel below, 5,120 threads
// at that shape) keeps ~8 bytes x 32 steps a thread, ~10 KB an SM, in
// flight.  So the chunked backward moves the loads to the TMA unit, as
// the forward does:
//   - A block owns kBwdChannels = 32 channels of one batch row, one
//     thread each: B * W / 32 = 160 blocks at the training microbatch
//     (80 at B = 1), every one resident.  The forward's 128-channel slice
//     would give 40.  Rows are 64 bytes in bf16, 128 for the states.
//   - It walks S from the top chunk down, a chunk being 64 steps in bf16
//     (32 in float32).  Thread 0 keeps a ring of kBwdStages = 3 stages of
//     (a, g, states) chunks in flight, each completing on its mbarrier:
//     a stage is 16 KB in bf16 (a 4, g 4, states 8; 12 KB in float32),
//     so while one is read two, 32 KB (24), are in flight, above the
//     ~21 KB a block needs.  With the two double-buffered output tile
//     pairs (16 KB) a block takes 64 KB of shared memory (52 in float32).
//     More in flight did not help: at the training microbatch in bf16 a
//     fourth stage made the call slower (PERF.md keeps the timings of the
//     shapes tried).
//   - Each thread reads kBwdGroup = 16 rows of a, g and the states from
//     the stage into registers before it runs their chain: a load cannot
//     pass the previous step's stores into the output tiles (the compiler
//     cannot tell that they do not alias), so a step that loads its own
//     rows waits a shared-memory latency for them, and the chain, not
//     the bytes, then sets the time.
//   - The states tile of the chunk covering steps [t0, t0 + TS) is the
//     box starting at row t0 - 1, so row u holds h_{t0+u-1}, the state
//     da_{t0+u} needs.  At t0 = 0 that row lies outside the tensor and
//     TMA fills it with zeros; the chain takes h0 (or 0) at t = 0
//     instead, as the loop kernel does.
//   - da and db go into one of two pairs of output tiles; after a barrier
//     thread 0 stores the pair with two TMA stores and refills the stage
//     just read.  Before that barrier it waits until the previous chunk's
//     stores have read their tiles, the ones the next chunk writes.
//   - Ragged edges need no masks in the loop: TMA reads zeros past S and
//     W and stores nothing there, the partial top chunk walks only its
//     own steps, and only channels < W read h0 or g_last or write dh0.
//   - Without g (no gradient of h) the kHasG = false instance builds no g
//     map and loads no g tile.
// The choice rule: the chunked backward wherever TMA can address the rows
// (W elements of T a multiple of 16 bytes; a, g, the states, da and db
// 16-byte aligned) and S >= 1, at any S, since a partial chunk is walked
// as the top one is; else the loop kernel (W = 1001, misaligned views):
// one thread a channel, kBwdUnroll steps of loads issued before their
// chain.  Unlike the forward's rule there is no minimum S: a decode step
// has no backward.  A call that the chunked kernel should take but whose
// maps cannot be made fails; it never falls back.
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

// The map of a (B, S, W) tensor of T in boxes of box_w channels x box_s
// steps x 1; false where cuTensorMapEncodeTiled is missing or refuses it.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int W,
                int box_w, int box_s) {
  hop::EncodeTiledFn encode = hop::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * sizeof(T),
                                 (cuuint64_t)S * W * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)box_w, (cuuint32_t)box_s, 1};
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
  cudaError_t err = hop::bind_context();   // the maps need a current context
  if (err != cudaSuccess) return err;
  CUtensorMap ma, mb, mo;
  constexpr int TS = Chunk<T>::kSteps;
  if (!tensor_map<T>(&ma, a, B, S, W, kChannels, TS) ||
      !tensor_map<T>(&mb, b, B, S, W, kChannels, TS) ||
      !tensor_map<T>(&mo, out, B, S, W, kChannels, TS))
    return cudaErrorInvalidValue;
  auto kernel = linrec_chunked_kernel<T, kStates>;
  // Set on every launch: the opt-in is per device, and the call is cheap
  // and allowed while a stream is captured.
  err = cudaFuncSetAttribute(
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

// ---- the backward's loop kernel: the chain in reverse, a thread a channel -

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

// ---- the chunked backward: a reverse TMA ring in, TMA stores out ---------

constexpr int kBwdChannels = 32;   // a block's, one thread each
constexpr int kBwdStages = 3;      // (a, g, states) chunks in flight
constexpr int kBwdGroup = 16;      // rows loaded before their chain

template <typename T>
struct BwdChunk {
  // steps a chunk: 64 in bf16, 32 in float32
  static constexpr int kSteps = 64 / (sizeof(T) / 2);
  static_assert(kSteps % kBwdGroup == 0, "a chunk is whole groups");
  static constexpr int kTile = kSteps * kBwdChannels * sizeof(T);  // a, g
  static constexpr int kTileF = kSteps * kBwdChannels * 4;         // states
  // a stage is (a, g, states) tiles; then two (da, db) output tile pairs
  // and the stages' mbarriers
  static constexpr int kStage = 2 * kTile + kTileF;
  static constexpr int kSmemBytes =
      kBwdStages * kStage + 4 * kTile + kBwdStages * 8;
};

// Thread 0: the n-th chunk from the top, k = chunks - 1 - n (steps
// k * TS ..), into stage n % kBwdStages, completing on that stage's
// mbarrier: a and g at row k * TS, the states one row earlier.
template <typename T, bool kHasG>
__device__ __forceinline__ void load_bwd_chunk(
    unsigned char* ring, uint64_t* full, const CUtensorMap* map_a,
    const CUtensorMap* map_g, const CUtensorMap* map_s, int n, int chunks,
    int c0, int bi) {
  using C = BwdChunk<T>;
  const int st = n % kBwdStages;
  const int t0 = (chunks - 1 - n) * C::kSteps;
  unsigned char* dst = ring + st * C::kStage;
  hop::mbar_expect_tx(&full[st], (kHasG ? 2 : 1) * C::kTile + C::kTileF);
  hop::tma_load_3d(dst, map_a, &full[st], c0, t0, bi);
  if constexpr (kHasG)
    hop::tma_load_3d(dst + C::kTile, map_g, &full[st], c0, t0, bi);
  hop::tma_load_3d(dst + 2 * C::kTile, map_s, &full[st], c0, t0 - 1, bi);
}

// Rows u0 + kBwdGroup - 1 down to u0 of a chunk's tiles (this thread's
// column; only rows < steps unless kFull): dh = g + carry, da = dh h (h
// the state before the step; h_init at t = 0, where at_t0 is set and u0
// is 0), db = dh, carry = dh a.
template <typename T, bool kHasG, bool kFull>
__device__ __forceinline__ void bwd_group(const T* ta, const T* tg,
                                          const float* ts, T* tda, T* tdb,
                                          int u0, int steps, bool at_t0,
                                          float h_init, float& carry) {
  constexpr int CH = kBwdChannels;
  T ra[kBwdGroup], rg[kBwdGroup];
  float rh[kBwdGroup];
#pragma unroll
  for (int j = 0; j < kBwdGroup; ++j) {
    ra[j] = ta[(u0 + j) * CH];
    if constexpr (kHasG) rg[j] = tg[(u0 + j) * CH];
    rh[j] = ts[(u0 + j) * CH];
  }
  if (at_t0 && u0 == 0) rh[0] = h_init;
#pragma unroll
  for (int j = kBwdGroup - 1; j >= 0; --j) {
    if (kFull || u0 + j < steps) {
      float dh = carry;
      if constexpr (kHasG) dh = kern::to_f32(rg[j]) + carry;
      tda[(u0 + j) * CH] = kern::from_f32<T>(dh * rh[j]);
      tdb[(u0 + j) * CH] = kern::from_f32<T>(dh);
      carry = dh * kern::to_f32(ra[j]);
    }
  }
}

template <typename T, bool kHasG>
__global__ void __launch_bounds__(kBwdChannels)
linrec_bwd_chunked_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_g,
                          const __grid_constant__ CUtensorMap map_s,
                          const __grid_constant__ CUtensorMap map_da,
                          const __grid_constant__ CUtensorMap map_db,
                          const T* __restrict__ g_last,
                          const T* __restrict__ h0, T* __restrict__ dh0,
                          int S, int W) {
  using C = BwdChunk<T>;
  constexpr int TS = C::kSteps;
  constexpr int CH = kBwdChannels;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  T* tiles_out = reinterpret_cast<T*>(smem + kBwdStages * C::kStage);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kBwdStages * C::kStage + 4 * C::kTile);
  const int c = threadIdx.x;
  const int c0 = blockIdx.x * CH;
  const int bi = blockIdx.y;
  const int chunks = (S + TS - 1) / TS;

  if (c == 0) {
    for (int st = 0; st < kBwdStages; ++st) hop::mbar_init(&full[st], 1);
    hop::fence_mbar_init();
  }
  __syncthreads();
  if (c == 0)
    for (int n = 0; n < kBwdStages && n < chunks; ++n)
      load_bwd_chunk<T, kHasG>(ring, full, &map_a, &map_g, &map_s, n, chunks,
                               c0, bi);

  const bool valid = c0 + c < W;
  const size_t row = (size_t)bi * W + c0 + c;
  const float h_init = (h0 != nullptr && valid) ? kern::to_f32(h0[row]) : 0.f;
  // carry = a_{t+1} dh_{t+1}, or g_last before the last step
  float carry =
      (g_last != nullptr && valid) ? kern::to_f32(g_last[row]) : 0.f;
  for (int n = 0; n < chunks; ++n) {
    const int st = n % kBwdStages;
    const int k = chunks - 1 - n;
    hop::mbar_wait(&full[st], (n / kBwdStages) & 1);
    const unsigned char* stage = ring + st * C::kStage;
    const T* ta = reinterpret_cast<const T*>(stage) + c;
    const T* tg = reinterpret_cast<const T*>(stage + C::kTile) + c;
    const float* ts = reinterpret_cast<const float*>(stage + 2 * C::kTile) + c;
    T* pair = tiles_out + (n & 1) * 2 * TS * CH;   // (da, db) tiles
    T* tda = pair + c;
    T* tdb = pair + TS * CH + c;
    const int steps = min(TS, S - k * TS);
    // row 0 of chunk 0 is t = 0, which takes h0 (or 0), not the tile
    if (steps == TS) {
#pragma unroll 1
      for (int u0 = TS - kBwdGroup; u0 >= 0; u0 -= kBwdGroup)
        bwd_group<T, kHasG, true>(ta, tg, ts, tda, tdb, u0, TS, k == 0,
                                  h_init, carry);
    } else {            // the partial top chunk; its rows past S are zeros
      for (int u0 = (steps - 1) / kBwdGroup * kBwdGroup; u0 >= 0;
           u0 -= kBwdGroup)
        bwd_group<T, kHasG, false>(ta, tg, ts, tda, tdb, u0, steps, k == 0,
                                   h_init, carry);
    }
    hop::fence_proxy_async();   // this thread's tile writes, before the store
    if (c == 0) hop::bulk_wait_read<0>();  // stores n-1 have read pair n+1
    __syncthreads();            // stage st read, tile pair n & 1 written
    if (c == 0) {
      hop::tma_store_3d(&map_da, pair, c0, k * TS, bi);
      hop::tma_store_3d(&map_db, pair + TS * CH, c0, k * TS, bi);
      hop::bulk_commit();
      if (n + kBwdStages < chunks)
        load_bwd_chunk<T, kHasG>(ring, full, &map_a, &map_g, &map_s,
                                 n + kBwdStages, chunks, c0, bi);
    }
  }
  if (dh0 != nullptr && valid) dh0[row] = kern::from_f32<T>(carry);
  if (c == 0) hop::bulk_wait_all();
}

// The backward's kernel, from shape and alignment alone: the chunked one
// where TMA can address the rows of a, g (where given), the states, da and
// db (a map needs S >= 1).
template <typename T>
bool use_chunked_bwd(const void* a, const void* states, const void* g,
                     const void* da, const void* db, int S, int W) {
  return S >= 1 && ((long)W * sizeof(T)) % 16 == 0 &&
         aligned16(a) && aligned16(states) &&
         (g == nullptr || aligned16(g)) && aligned16(da) && aligned16(db);
}

template <typename T, bool kHasG>
cudaError_t launch_bwd_chunked(const void* a, const float* states,
                               const void* g, const void* g_last,
                               const void* h0, void* da, void* db,
                               void* dh0, int B, int S, int W,
                               cudaStream_t stream) {
  constexpr int TS = BwdChunk<T>::kSteps;
  // An eligible shape whose maps cannot be made is an error, not a quiet
  // fall back to the loop kernel.  Without g no g map is built: the kernel
  // gets a's in its place and never reads it.
  cudaError_t err = hop::bind_context();   // the maps need a current context
  if (err != cudaSuccess) return err;
  CUtensorMap ma, mg, ms, mda, mdb;
  if (!tensor_map<T>(&ma, a, B, S, W, kBwdChannels, TS) ||
      !tensor_map<float>(&ms, states, B, S, W, kBwdChannels, TS) ||
      !tensor_map<T>(&mda, da, B, S, W, kBwdChannels, TS) ||
      !tensor_map<T>(&mdb, db, B, S, W, kBwdChannels, TS))
    return cudaErrorInvalidValue;
  if constexpr (kHasG) {
    if (!tensor_map<T>(&mg, g, B, S, W, kBwdChannels, TS))
      return cudaErrorInvalidValue;
  } else {
    mg = ma;
  }
  auto kernel = linrec_bwd_chunked_kernel<T, kHasG>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BwdChunk<T>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kBwdChannels - 1) / kBwdChannels, B);
  kernel<<<grid, kBwdChannels, BwdChunk<T>::kSmemBytes, stream>>>(
      ma, mg, ms, mda, mdb, static_cast<const T*>(g_last),
      static_cast<const T*>(h0), static_cast<T*>(dh0), S, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* a, const float* states, const void* g,
                       const void* g_last, const void* h0, void* da,
                       void* db, void* dh0, int B, int S, int W,
                       int* kernel_run, cudaStream_t stream) {
  if (use_chunked_bwd<T>(a, states, g, da, db, S, W)) {
    *kernel_run = 1;
    return g != nullptr
               ? launch_bwd_chunked<T, true>(a, states, g, g_last, h0, da,
                                             db, dh0, B, S, W, stream)
               : launch_bwd_chunked<T, false>(a, states, g, g_last, h0, da,
                                              db, dh0, B, S, W, stream);
  }
  const int blocks = (B * W + kBwdThreads - 1) / kBwdThreads;
  auto kernel = g != nullptr ? linrec_bwd_kernel<T, true>
                             : linrec_bwd_kernel<T, false>;
  kernel<<<blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(a), states, static_cast<const T*>(g),
      static_cast<const T*>(g_last), static_cast<const T*>(h0),
      static_cast<T*>(da), static_cast<T*>(db), static_cast<T*>(dh0), B, S,
      W);
  *kernel_run = 0;
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
// where dh0 is given, dh0, all in the input type.  One launch; *kernel_run
// is set to the kernel launched, 0 = loop, 1 = chunked (left as it was
// when nothing is launched).  Returns a cudaError_t (0 on success, also
// when B * W == 0 and nothing launches).
extern "C" int linear_recurrence_bwd_launch(const void* a,
                                            const void* states,
                                            const void* g, const void* g_last,
                                            const void* h0, void* da,
                                            void* db, void* dh0, int dtype,
                                            int B, int S, int W,
                                            int* kernel_run, void* stream) {
  if (B * W == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(states);
  if (dtype == 0)
    return launch_bwd<float>(a, st, g, g_last, h0, da, db, dh0, B, S, W,
                             kernel_run, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, st, g, g_last, h0, da, db, dh0, B,
                                     S, W, kernel_run, s);
  return cudaErrorInvalidValue;
}
