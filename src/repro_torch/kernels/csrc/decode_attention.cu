// Single-token GQA flash-decode for Hopper (sm_90a): one launch, split
// along the cache, combined by the last block of each (b, kv head).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel).  For q (B, H, D), caches k, v
// (B, S, KV, D), bfloat16 or float32, and lengths (B,) int32 it computes
//
//   out[b, h] = softmax_{j < lengths[b]}(scale * q[b, h] . k[b, j, h / G])
//               v[b, j, h / G]
//
// (G = H / KV query heads per key/value head, at most 16), in float,
// rounded to the input type once.
//
// What bounds it on the card: bytes.  The caches are read once: 16.8 MB at
// the serving path's decode (B = 8, S = 2048, KV = 1, D = 256, bf16), 5.0 us
// at the 3.35 TB/s of an H100 SXM, while the products are ~4 flop per cache
// byte.
//
// Layout: B * KV blocks alone would fill 8 of 132 SMs, so the cache is
// split into 128-key chunks: grid (ceil(S / 128), B * KV), 8 warps a block.
//   - Streaming: the block's chunk arrives in 64-key tiles through a ring
//     in shared memory (2 stages in bf16: the next tile is in flight while
//     one is scored; 1 stage in float32, where a 64-key tile of K and V
//     takes 128 KB at D = 256), a bulk copy (cp.async.bulk, the TMA unit)
//     per cache row, completion counted on an mbarrier per stage.  V rows
//     past the valid length are zeroed; chunks at or past lengths[b] exit
//     at once.
//   - Scoring the whole group at once: the G query heads, padded to 16
//     rows, are the A operand of mma.sync m16n8k16 (bf16), so each K and V
//     element is read from shared memory once for all heads.  Warp
//     (kw, hf) takes keys 16 kw .. 16 kw + 15 of a tile and half hf of D:
//     the two warps of a pair swap their partial scores through shared
//     memory, run the same online softmax, and each keeps the running
//     max, sum and a 16 x D / 2 accumulator in the mma fragment layout.  P goes
//     through the second product (O += P V, V by ldmatrix.trans) as bf16
//     hi + lo halves, which keeps it to ~2^-17 (rounding P once to bf16
//     moves outputs by tens of ulps; see tests/test_torch_attention_
//     kernels.py).  float32 runs the same fragments on the CUDA cores.
//   - Combining in the same launch: the key warps merge through shared
//     memory (staged in the idle ring), the block writes its chunk's max,
//     sum and accumulator, and the last block of its (b, kv head) to
//     finish (a __threadfence and an atomic counter, which it resets to 0
//     so CUDA-graph replays start clean) combines the chunks, 32 at a
//     time with a running max per head: one round of loads brings their
//     maxima and sums to shared memory, and each thread rescales and sums
//     the chunks' accumulators for its float4 column groups, the loads of
//     8 chunks in flight together.  The combine is a chain of dependent
//     L2 round trips in one block, so it is kept to a few.
// The partial sums add 2 * 4 * D * H bytes per chunk (1.3 MB each way at
// the serving shape) to the cache's 16.8 MB, mostly in L2.
//
// Host side: decode_attention_launch runs on the caller's stream with
// caller-provided scratch (partials and the zeroed counters) and returns
// the launch's cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kChunk = 128;          // keys per block
constexpr int kKeyWarps = 4;         // warps along a tile's keys, 16 each
constexpr int kWarps = 2 * kKeyWarps;  // and two along D, half each
constexpr int kTile = 16 * kKeyWarps;  // keys per ring stage
constexpr int kRows = 16;            // query heads of a group, padded
constexpr int kGroup = 32;           // chunks the combine takes at once
constexpr float kNegInf = -1e30f;    // the masked logit of the reference

template <typename T, int D>
struct DecLayout {
  static constexpr int kStages = sizeof(T) == 2 ? 2 : 1;
  static constexpr int kPer16 = 16 / sizeof(T);        // elements per copy
  static constexpr int LD = D + kPer16;                // padded row
  static constexpr int kQ = kRows * LD;                // elements
  static constexpr int kStage = kTile * LD;
  static constexpr int SD = D + 8;     // row of the float staging area
  // Q, the K and V rings, a barrier per stage and one for Q, then floats:
  // the warps' partial scores, per-key-warp (m, l), per-head (M, L,
  // rescale), a group of chunks' (max or weight, sum), the last-block flag
  static constexpr int kBytes =
      (kQ + 2 * kStages * kStage) * sizeof(T) + 8 * (kStages + 1) +
      4 * (kWarps * 32 * 8 + kKeyWarps * kRows * 2 + 3 * kRows +
           2 * kGroup * kRows + 4);
  // the key warps' accumulators are staged in the idle K and V rings
  static_assert(kKeyWarps * kRows * SD * 4 <=
                    2 * kStages * kStage * sizeof(T),
                "staging area larger than the ring");
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Row r (one thread's share) of a (rows, D) slice with row stride
// ``stride`` into a padded shared tile: a bulk copy counted on ``bar``
// while r < valid, zeros after that where ``zero`` asks for them.
template <typename T, int D>
__device__ __forceinline__ void load_row(T* dst, const T* src, long stride,
                                         int r, int valid, bool zero,
                                         uint64_t* bar) {
  constexpr int LD = DecLayout<T, D>::LD;
  if (r < valid) {
    hop::bulk_load(dst + r * LD, src + r * stride, D * sizeof(T), bar);
  } else if (zero) {
    for (int c = 0; c < D; c += DecLayout<T, D>::kPer16)
      *reinterpret_cast<uint4*>(dst + r * LD + c) = make_uint4(0, 0, 0, 0);
  }
}

// The warp's share of S (16 heads x its 16 keys) = Q K^T over the D / 2
// columns at Qs and Kw (already offset to the warp's half): s[nb][e] holds
// row g + 8 (e / 2), key 8 nb + 2 c + e % 2 of the warp's keys.
template <int D>
__device__ __forceinline__ void scores(float (&s)[2][4],
                                       const __nv_bfloat16* Qs,
                                       const __nv_bfloat16* Kw, int lane) {
  constexpr int LD = DecLayout<__nv_bfloat16, D>::LD;
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    uint32_t a[4], bk[4];
    hop::ldmatrix_x4(a, Qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
    hop::ldmatrix_x4(bk, Kw + ((lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                             ((lane >> 3) & 1) * 8);
    hop::mma_16816(s[0], a, bk[0], bk[1]);
    hop::mma_16816(s[1], a, bk[2], bk[3]);
  }
}

template <int D>
__device__ __forceinline__ void scores(float (&s)[2][4], const float* Qs,
                                       const float* Kw, int lane) {
  constexpr int LD = DecLayout<float, D>::LD;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* qr = Qs + (g + 8 * (e >> 1)) * LD;
      const float* kr = Kw + (8 * nb + 2 * c + (e & 1)) * LD;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D / 2; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(qr + d);
        const float4 y = *reinterpret_cast<const float4*>(kr + d);
        dot += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      s[nb][e] = dot;
    }
}

// acc (16 x D / 2, acc[j] the 16 x 8 block of columns 8 j of the warp's
// half, which Vw points to) += P V over the warp's 16 keys, P as held by
// scores().
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 16][4],
                                           const float (&p)[2][4],
                                           const __nv_bfloat16* Vw,
                                           int lane) {
  constexpr int LD = DecLayout<__nv_bfloat16, D>::LD;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    hop::split_bf16(p[q >> 1][2 * (q & 1)], p[q >> 1][2 * (q & 1) + 1], hi[q],
                    lo[q]);
#pragma unroll
  for (int j2 = 0; j2 < D / 32; ++j2) {
    uint32_t bv[4];
    hop::ldmatrix_x4_trans(bv, Vw + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                   j2 * 16 + (lane >> 4) * 8);
    hop::mma_16816(acc[2 * j2], hi, bv[0], bv[1]);
    hop::mma_16816(acc[2 * j2 + 1], hi, bv[2], bv[3]);
    hop::mma_16816(acc[2 * j2], lo, bv[0], bv[1]);
    hop::mma_16816(acc[2 * j2 + 1], lo, bv[2], bv[3]);
  }
}

template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 16][4],
                                           const float (&p)[2][4],
                                           const float* Vw, int lane) {
  constexpr int LD = DecLayout<float, D>::LD;
  const int c = lane & 3;
#pragma unroll
  for (int key = 0; key < 16; ++key) {
    const int src = (lane & ~3) | ((key & 7) >> 1);
    const float p0 = __shfl_sync(0xffffffffu, p[key >> 3][key & 1], src);
    const float p1 = __shfl_sync(0xffffffffu, p[key >> 3][2 + (key & 1)], src);
    const float* vr = Vw + key * LD + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(vr + 8 * j);
      acc[j][0] += p0 * v.x;
      acc[j][1] += p0 * v.y;
      acc[j][2] += p1 * v.x;
      acc[j][3] += p1 * v.y;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              float* __restrict__ pm, float* __restrict__ pl,
              float* __restrict__ pacc, int* __restrict__ counters,
              T* __restrict__ out, int B, int S, int H, int KV,
              float scale_log2) {
  using L = DecLayout<T, D>;
  constexpr int NS = L::kStages;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Ks = Qs + L::kQ;                  // NS stages of kTile rows
  T* Vs = Ks + NS * L::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + NS * L::kStage);
  uint64_t* qbar = full + NS;          // one barrier per stage, one for Q
  float* xs = reinterpret_cast<float*>(qbar + 1);     // [w][lane][8]
  float* ml = xs + kWarps * 32 * 8;                   // [key warp][row][2]
  float* fin = ml + kKeyWarps * kRows * 2;             // [row][M, L, corr]
  float* cw = fin + 3 * kRows;                        // [kGroup][kRows]
  float* cl = cw + kGroup * kRows;                    // [kGroup][kRows]
  int* is_last = reinterpret_cast<int*>(cl + kGroup * kRows);

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int len = min(max(lengths[b], 0), S);
  const int n_act = max(1, (len + kChunk - 1) / kChunk);
  const int split = blockIdx.x;
  if (split >= n_act) return;          // uniform across the block
  const int s0 = split * kChunk;
  const int n = max(0, min(kChunk, len - s0));
  const int n_sub = (n + kTile - 1) / kTile;

  const long row = (long)KV * D;
  const T* kb = kc + ((long)b * S + s0) * row + (long)kvh * D;
  const T* vb = vc + ((long)b * S + s0) * row + (long)kvh * D;
  if (threadIdx.x == 0) {
    for (int st = 0; st <= NS; ++st) hop::mbar_init(&full[st], 1);
    hop::fence_mbar_init();
  }
  __syncthreads();
  // tile t of the chunk into ring stage t % NS by the TMA unit, a row per
  // thread (K rows, then V rows); V rows past the valid keys are zeroed,
  // as P V would turn stale NaN bits into NaN
  auto issue = [&](int t) {
    if (t >= n_sub) return;
    const int st = t % NS, nv = min(kTile, n - t * kTile);
    if (threadIdx.x == 0)
      hop::mbar_expect_tx(&full[st], 2 * nv * D * sizeof(T));
    hop::fence_proxy_async();
    for (int i = threadIdx.x; i < 2 * kTile; i += kWarps * 32) {
      const bool is_v = i >= kTile;
      load_row<T, D>((is_v ? Vs : Ks) + st * L::kStage,
                     (is_v ? vb : kb) + t * kTile * row, row, i % kTile, nv,
                     is_v, &full[st]);
    }
  };
  if (threadIdx.x == 0) hop::mbar_expect_tx(qbar, G * D * sizeof(T));
  if (threadIdx.x < kRows)
    load_row<T, D>(Qs, q + ((long)b * H + (long)kvh * G) * D, D,
                   threadIdx.x, G, true, qbar);
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) issue(t);
  hop::mbar_wait(qbar, 0);

  // warp (kw, hf): keys 16 kw .. 16 kw + 15 of each tile, columns
  // hf D / 2 .. hf D / 2 + D / 2 - 1 of both products
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = warp % kKeyWarps, hf = warp / kKeyWarps;
  const int g = lane >> 2, c = lane & 3;
  float acc[D / 16][4];
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_sub; ++t) {
    // the next tile goes in flight before this one is scored: the stage it
    // fills was scored in the previous iteration, before its last barrier
    issue(t + NS - 1);
    const int st = t % NS;
    hop::mbar_wait(&full[st], (t / NS) & 1);
    __syncthreads();                   // and the zeroed rows are visible
    const T* Kw = Ks + st * L::kStage + 16 * kw * L::LD + hf * (D / 2);
    const T* Vw = Vs + st * L::kStage + 16 * kw * L::LD + hf * (D / 2);
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    scores<D>(s, Qs + hf * (D / 2), Kw, lane);
    // the two halves' partial scores, summed in the same order by both
    // warps of a pair, so that both run the same softmax
    float* mine = xs + (warp * 32 + lane) * 8;
    const float* other = xs + ((warp ^ kKeyWarps) * 32 + lane) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) mine[i] = s[i >> 2][i & 3];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s[i >> 2][i & 3] = hf == 0 ? s[i >> 2][i & 3] + other[i]
                                 : other[i] + s[i >> 2][i & 3];
    const int kbase = t * kTile + 16 * kw;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kbase + 8 * nb + 2 * c + (e & 1) < n;
        s[nb][e] = ok ? s[nb][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[nb][e] = s[nb][e] == kNegInf ? 0.f : exp2f(s[nb][e] - m[r]);
        l[r] += s[nb][e];
      }
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    accumulate<D>(acc, s, Vw, lane);
    __syncthreads();                   // stage st is free again
  }

  // merge the key warps (the two warps of a pair hold the same m and l):
  // each rescales its accumulator to the block's max and stages its half
  // as float [key warp][row][SD]
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  if (c == 0 && hf == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ml[(kw * kRows + g + 8 * r) * 2] = m[r];
      ml[(kw * kRows + g + 8 * r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(Ks);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = g + 8 * r;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kKeyWarps; ++w)
      M = fmaxf(M, ml[(w * kRows + rr) * 2]);
    const float wself = exp2f(m[r] - M);
    float* dst = stage + (kw * kRows + rr) * L::SD + hf * (D / 2) + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[j][2 * r] * wself, acc[j][2 * r + 1] * wself);
  }
  __syncthreads();
  const long base = ((long)split * B + b) * H + (long)kvh * G;
  constexpr int D4 = D / 4;
  for (int i = threadIdx.x; i < G * D4; i += kWarps * 32) {
    const int rr = i / D4, d = 4 * (i % D4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kKeyWarps; ++w) {
      const float4 x =
          *reinterpret_cast<const float4*>(stage + (w * kRows + rr) * L::SD + d);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    *reinterpret_cast<float4*>(pacc + (base + rr) * D + d) = a;
  }
  if (threadIdx.x < G) {
    const int rr = threadIdx.x;
    float M = kNegInf, Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kKeyWarps; ++w)
      M = fmaxf(M, ml[(w * kRows + rr) * 2]);
#pragma unroll
    for (int w = 0; w < kKeyWarps; ++w)
      Lsum += ml[(w * kRows + rr) * 2 + 1] *
              exp2f(ml[(w * kRows + rr) * 2] - M);
    pm[base + rr] = M;
    pl[base + rr] = Lsum;
  }

  // the last block of this (b, kv head) to get here combines the chunks
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *is_last = atomicAdd(&counters[blockIdx.y], 1) == n_act - 1;
  __syncthreads();
  if (!*is_last) return;
  if (threadIdx.x == 0) counters[blockIdx.y] = 0;
  __threadfence();
  const long hb = (long)b * H + (long)kvh * G;    // first head of the group
  const long cs = (long)B * H;                    // chunk stride of pm, pl
  // out = sum_k exp2(m_k - M) acc_k / sum_k exp2(m_k - M) l_k over the
  // chunks k, kGroup chunks at a time with a running max M per head: one
  // round of loads brings the group's (m_k, l_k) into shared memory, the
  // heads' threads turn them into weights, and each thread rescales its
  // float4 column groups (t, t + 256, ... of the group's G x D outputs)
  // with the loads of 8 chunks in flight together
  constexpr int kOut = (kRows * D4 + kWarps * 32 - 1) / (kWarps * 32);
  if (threadIdx.x < kRows) {
    fin[3 * threadIdx.x] = kNegInf;
    fin[3 * threadIdx.x + 1] = 0.f;
  }
  float4 a[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) a[o] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* pa = reinterpret_cast<const float4*>(pacc + hb * D);
  for (int k0 = 0; k0 < n_act; k0 += kGroup) {
    const int nk = min(kGroup, n_act - k0);
    __syncthreads();                   // the previous group is consumed
    for (int i = threadIdx.x; i < nk * G; i += kWarps * 32) {
      const long at = (k0 + i / G) * cs + hb + i % G;
      cw[(i / G) * kRows + i % G] = __ldcg(pm + at);
      cl[(i / G) * kRows + i % G] = __ldcg(pl + at);
    }
    __syncthreads();
    if (threadIdx.x < G) {
      const int rr = threadIdx.x;
      float M = fin[3 * rr];
      for (int k = 0; k < nk; ++k) M = fmaxf(M, cw[k * kRows + rr]);
      const float corr = exp2f(fin[3 * rr] - M);
      float Lsum = fin[3 * rr + 1] * corr;
      for (int k = 0; k < nk; ++k) {
        const float w = exp2f(cw[k * kRows + rr] - M);
        cw[k * kRows + rr] = w;
        Lsum += cl[k * kRows + rr] * w;
      }
      fin[3 * rr] = M;
      fin[3 * rr + 1] = Lsum;
      fin[3 * rr + 2] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int i = threadIdx.x + o * kWarps * 32;
      if (i < G * D4) {
        const float corr = fin[3 * (i / D4) + 2];
        a[o].x *= corr;
        a[o].y *= corr;
        a[o].z *= corr;
        a[o].w *= corr;
      }
    }
#pragma unroll 8
    for (int k = 0; k < nk; ++k) {
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const int i = threadIdx.x + o * kWarps * 32;
        if (i < G * D4) {
          const float w = cw[k * kRows + i / D4];
          const float4 x = __ldcg(pa + (k0 + k) * cs * D4 + i);
          a[o].x += x.x * w;
          a[o].y += x.y * w;
          a[o].z += x.z * w;
          a[o].w += x.w * w;
        }
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int i = threadIdx.x + o * kWarps * 32;
    if (i < G * D4) {
      const float inv = 1.f / fmaxf(fin[3 * (i / D4) + 1], 1e-30f);
      kern::store4(out + hb * D + 4 * i, a[o].x * inv, a[o].y * inv,
                   a[o].z * inv, a[o].w * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, float* pm, float* pl, float* pacc,
                   int* counters, void* out, int B, int S, int H, int KV,
                   float scale, cudaStream_t stream) {
  auto kernel = decode_kernel<T, D>;
  constexpr int bytes = DecLayout<T, D>::kBytes;
  // Set on every launch: the opt-in is per device, and the call is cheap
  // and allowed while a stream is captured.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kChunk - 1) / kChunk, B * KV);
  kernel<<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, pm, pl, pacc, counters,
      static_cast<T*>(out), B, S, H, KV, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const int* lengths, float* pm, float* pl, float* pacc,
                     int* counters, void* out, int B, int S, int H, int KV,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, pm, pl, pacc, counters, out, B,
                           S, H, KV, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, pm, pl, pacc, counters, out, B,
                            S, H, KV, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, pm, pl, pacc, counters, out, B,
                            S, H, KV, scale, stream);
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
// pacc: (ceil(S / chunk), B, H, D) float scratch; counters: (B * KV) int32,
// zero on entry and left zero.  Returns a cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       float* pm, float* pl, float* pacc,
                                       int* counters, void* out, int dtype,
                                       int B, int S, int H, int KV, int D,
                                       float scale, void* stream) {
  if (B * H == 0 || S == 0) return cudaSuccess;
  if (H / KV > kRows) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, lengths, pm, pl, pacc, counters, out,
                           B, S, H, KV, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, lengths, pm, pl, pacc,
                                   counters, out, B, S, H, KV, scale, s);
  return cudaErrorInvalidValue;
}
