// FlashAttention forward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma fed by TMA), float32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _fa_kernel).  For q (B, Sq, H, D) and k, v
// (B, Sk, KV, D), bfloat16 or float32, it computes
//
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / G]) v[b, j, h / G]
//
// over the keys j that query i may see: j <= i + (Sk - Sq) when causal and
// j > i + (Sk - Sq) - window when window > 0 (G = H / KV query heads share
// one key/value head).  Softmax statistics and the accumulator are float;
// the output is rounded to the input type once.
//
// What bounds it on the card: operations.  At the serving path's prefill
// (B = 8, S = 2048, H = 10, KV = 1, D = 256, causal, window 2048) one call
// does 1.72e11 FLOP (4 D per visible query-key pair) and moves 185 MB:
// 0.174 ms at the 989 TFLOP/s bf16 peak of the tensor cores of an H100 SXM,
// 0.055 ms at 3.35 TB/s.
//
// bf16 (flash_wgmma_kernel).  One block of 160 threads per (b * H + h,
// 64-query tile); the heaviest tiles under the causal mask are scheduled
// first (the tile index runs on the slow grid axis, reversed).  Warps 0-3
// are one consumer warpgroup, warp 4 the producer:
//   - the producer's lane 0 loads the query tile once and then streams the
//     64-key tiles of K and V that the causal and window masks leave (fully
//     masked tiles are never loaded) into a 2-stage ring in shared memory
//     with TMA (cp.async.bulk.tensor, 4-d maps over (D, heads, S, B), so
//     rows past S arrive as zeros), each stage guarded by a full and an
//     empty mbarrier;
//   - the consumers compute S = Q K^T with wgmma m64n64k16 from shared
//     memory (Q and K both K-major, 128-byte swizzle), mask it, run the
//     online softmax in float on the accumulator fragment (exp2 of
//     log2-scaled logits), and compute O += P V with wgmma m64nDk16, P from
//     registers and V read MN-major (transposed) from shared memory; O is
//     a float fragment of D / 2 registers a thread.
// P goes through the tensor cores as bf16 hi + lo halves (two products):
// rounding P once to bf16, as FA2/FA3 do, moves outputs of magnitude
// ~2^-8 by tens of bf16 ulps (rehearsed on the CPU in
// tests/test_torch_attention_kernels.py), while hi + lo keeps P to ~2^-17
// and the output within an ulp of the float32 reference.  The products are
// then 1.5x the 1.72e11 FLOP.  Shared memory: Q 32 KB + 2 x (K + V) 128 KB
// at D = 256; one block per SM.
//
// float32 (flash_f32_kernel) stays on the CUDA cores in full float32: the
// float32 contract (rtol = atol = 1e-5 against the plain version, on which
// the decode-vs-full-forward and card-vs-CPU checks rest) would not hold
// through TF32.  One block of 256 threads per (64-query tile, b * H + h)
// holds its query tile, one 64-key tile of K and of V and the 64 x 64
// probability tile in shared memory as float and streams key tiles with an
// online softmax; thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i.
// Ragged edges (Sq or Sk not a multiple of 64) are masked in both kernels,
// so any Sq <= Sk works.
//
// Segments (bf16, D 80): with offsets seg[0] = 0 < ... <= seg[n]
// = Sq = Sk, a query attends only to the keys of its own segment [seg[i],
// seg[i + 1]), under the causal mask or not: the packed images of a
// vision tower, each attending within itself (B = 1).  A query tile
// streams only the key tiles between its first row's segment start and
// its last row's segment end, so tiles that no segment pair touches are
// never loaded; each row masks the keys outside its segment.  Without
// segments the instances are the unsegmented kernels as they were (the
// flag is a template parameter).
//
// D = 80 (Qwen2-VL's vision tower, 16 heads of 80): the tiles hold two
// 64-column panels, the TMA box past column 80 arriving as zeros.  S = Q
// K^T contracts the 80 columns in five k16 steps; O += P V runs at n = 80,
// V read MN-major from its first panel and 16 columns of the second (at
// the cell's shape 3.59 ms against 3.98 ms with n = 128 over the
// zero-padded panels; two blocks an SM gained nothing).
//
// Both kernels also write the row log-sum-exp when given an lse pointer:
// float32 (B, Sq, H), lse = max + log(sum) of the scaled, masked logits in
// the natural log, as repro's _flash_fwd_shaped returns it; the training
// path's backward (flash_attention_bwd.cu) recomputes P = exp(s - lse)
// from it.  A null pointer leaves the serving launch as it was.
//
// Host side: flash_attention_launch picks the kernel for (type, D), builds
// the TMA maps (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so nothing links libcuda), launches on the
// caller's stream and returns the launch's cudaError_t.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---- float32: the CUDA-core kernel ----------------------------------------

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
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long row_stride, int r0, int n,
                                          int rows) {
  constexpr int N = kern::Vec<float>::N;
  constexpr int per_row = D / N;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row, c = (idx % per_row) * N;
    float vals[N];
    if (r0 + r < n) {
      kern::Vec<float>::load(src + (long)(r0 + r) * row_stride + c, vals);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 float scale, int causal, int window) {
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
  const float* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const float* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const float* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  load_tile<D>(Qs, qb, q_stride, q0, Sq, kBQ);

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
    load_tile<D>(Ks, kb, kv_stride, k0, Sk, kBK);
    load_tile<D>(Vs, vb, kv_stride, k0, Sk, kBK);
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

  float* ob = o + (long)b * Sq * q_stride + (long)h * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((long)b * Sq + r) * H + h] = m[i] + logf(den);
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      kern::store4(ob + (long)r * q_stride + 4 * tx + 64 * g,
                   acc[i][4 * g] / den, acc[i][4 * g + 1] / den,
                   acc[i][4 * g + 2] / den, acc[i][4 * g + 3] / den);
    }
  }
}

// ---- bf16: the tensor-core kernel ------------------------------------------

constexpr int kWgBQ = 64;            // query rows: one consumer warpgroup
constexpr int kWgBK = 64;            // keys per K/V tile
constexpr int kStages = 2;           // K/V tiles in flight
constexpr int kPanel = 64 * 128;     // 64 rows x 64 bf16 columns, swizzled
constexpr int kWgThreads = 160;      // the warpgroup + the producer warp

// Columns of a tile in shared memory: D rounded up to whole 64-column
// panels (D = 80: two panels, the second zero past column 80).
template <int D>
constexpr int kPadded = (D + 63) / 64 * 64;

template <int D>
struct WgLayout {
  static constexpr int kTile = (kPadded<D> / 64) * kPanel;  // 64 x D tile
  // Q, kStages x (K, V), the barriers, and slack to align to 1024 bytes
  static constexpr int kBytes = 1024 + kTile * (1 + 2 * kStages) +
                                8 * (2 * kStages + 1);
};

template <int D, bool kSeg>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int Sq, int Sk, int H, int KV, float scale_log2,
                   int causal, int window, const int* __restrict__ seg,
                   int n_seg) {
  constexpr int kTile = WgLayout<D>::kTile;
  constexpr int NP = kPadded<D> / 64;  // panels of a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + kTile;         // stage s: K at 2 s kTile, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + 2 * kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;
  const int off = Sk - Sq;
  // the key range some row of this tile may see
  const int q_lo = q0 + off, q_hi = min(q0 + kWgBQ, Sq) - 1 + off;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_hi + 1);
  if (window > 0) k_begin = max(0, q_lo - window + 1) / kWgBK * kWgBK;
  // with segments (Sq = Sk, off = 0): where every row of the tile lies in
  // one segment [tile_lo, tile_hi) (interior), its key tiles inside it
  // need no per-element test but the band's
  int tile_lo = 0, tile_hi = 0;
  bool interior = false;
  if constexpr (kSeg) {
    int lo2, hi2;
    kern::seg_bounds(seg, n_seg, q0, tile_lo, tile_hi);
    kern::seg_bounds(seg, n_seg, min(q0 + kWgBQ, Sq) - 1, lo2, hi2);
    k_begin = max(k_begin, tile_lo / kWgBK * kWgBK);
    k_end = min(k_end, hi2);
    interior = lo2 == tile_lo && q0 + kWgBQ <= Sq;
  }
  const int n_tiles = max(0, (k_end - k_begin + kWgBK - 1) / kWgBK);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 128);
    }
    hop::mbar_init(qbar, 1);
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128) {                    // the producer warp
    if (tid == 128) {
      hop::mbar_expect_tx(qbar, kTile);
      for (int p = 0; p < NP; ++p)
        hop::tma_load_4d(Qs + p * kPanel, &tq, qbar, 64 * p, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, use = t / kStages;
        if (use > 0) hop::mbar_wait(&empty[s], (use - 1) & 1);
        hop::mbar_expect_tx(&full[s], 2 * kTile);
        uint8_t* Kt = KVs + 2 * s * kTile;
        const int k0 = k_begin + t * kWgBK;
        for (int p = 0; p < NP; ++p) {
          hop::tma_load_4d(Kt + p * kPanel, &tk, &full[s], 64 * p, kvh, k0, b);
          hop::tma_load_4d(Kt + kTile + p * kPanel, &tv, &full[s], 64 * p,
                           kvh, k0, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: thread (warp w, lane 4 g + c) holds rows
  // 16 w + g and 16 w + g + 8 of every accumulator, at columns 8 j + 2 c
  // and 8 j + 2 c + 1 (registers 4 j .. 4 j + 3)
  const int lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int row0 = (tid >> 5) * 16 + g;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // the segment of each of the thread's two rows (rows past Sq see none)
  int seg_lo[2] = {0, 0}, seg_hi[2] = {Sk, Sk};
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 8 * r;
      if (row < Sq)
        kern::seg_bounds(seg, n_seg, row, seg_lo[r], seg_hi[r]);
      else
        seg_lo[r] = seg_hi[r] = 0;
    }
  }

  hop::mbar_wait(qbar, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hop::mbar_wait(&full[s], (t / kStages) & 1);
    __syncwarp();
    const uint8_t* Kt = KVs + 2 * s * kTile;
    const uint8_t* Vt = Kt + kTile;

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) hop::fence_reg(sc[i]);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {   // D = 80: five k16 steps
      const int at = (kk / 4) * kPanel + (kk % 4) * 32;
      hop::wgmma_m64n64k16_ss(sc, hop::desc_sw128(Qs + at, 16, 1024),
                              hop::desc_sw128(Kt + at, 16, 1024), 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) hop::fence_reg(sc[i]);

    // mask, then the online softmax in the log2 domain
    const int k0 = k_begin + t * kWgBK;
    float mx[2] = {m[0], m[1]};
    // a segmented tile inside the segment of every row, with no causal or
    // window edge in it, skips the per-element test
    bool whole = false;
    if constexpr (kSeg)
      whole = interior && k0 >= tile_lo && k0 + kWgBK <= tile_hi &&
              (!causal || k0 + kWgBK - 1 <= q0) &&
              (window <= 0 || q0 + kWgBQ - 1 - k0 < window);
    if (whole) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] *= scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qpos = q0 + row0 + 8 * ((i >> 1) & 1) + off;
        const int kpos = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
        bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
        if constexpr (kSeg) {
          const int r = (i >> 1) & 1;
          ok = ok && kpos >= seg_lo[r] && kpos < seg_hi[r];
        }
        sc[i] = ok ? sc[i] * scale_log2 : kNegInf;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = sc[i] == kNegInf ? 0.f : exp2f(sc[i] - m[r]);
      l[r] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // P as the A fragments of four k16 steps, in bf16 hi and lo halves:
    // step kk takes the accumulator's column blocks 2 kk and 2 kk + 1
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 4 * (q >> 1) + 2 * (q & 1);
        hop::split_bf16(sc[i], sc[i + 1], phi[kk][q], plo[kk][q]);
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) hop::fence_reg(acc[i]);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_m64k16_rs<D>(acc, phi[kk],
                               hop::desc_sw128(Vt + kk * 2048, kPanel, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_m64k16_rs<D>(acc, plo[kk],
                               hop::desc_sw128(Vt + kk * 2048, kPanel, 1024));
    hop::wgmma_commit();
    hop::wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) hop::fence_reg(acc[i]);
    hop::mbar_arrive(&empty[s]);       // this stage may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const long q_stride = (long)H * D;
  __nv_bfloat16* ob = o + ((long)b * Sq + q0) * q_stride + (long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (q0 + row >= Sq) continue;
    // m is in the log2 domain: lse = ln 2 (m + log2 l)
    if (lse != nullptr && c == 0)
      lse[((long)b * Sq + q0 + row) * H + h] =
          (m[r] + log2f(l[r])) * 0.6931471805599453f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {   // D = 80: the first 80 columns
      *reinterpret_cast<uint32_t*>(ob + row * q_stride + 8 * j + 2 * c) =
          hop::pack_bf16(acc[4 * j + 2 * r] / l[r],
                         acc[4 * j + 2 * r + 1] / l[r]);
    }
  }
}

// ---- host side -------------------------------------------------------------

template <int D, bool kSeg>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Sk, int H, int KV,
                        float scale, int causal, int window, const int* seg,
                        int n_seg, cudaStream_t stream) {
  auto kernel = flash_wgmma_kernel<D, kSeg>;
  constexpr int bytes = WgLayout<D>::kBytes;
  // Set on every launch: the opt-in is per device, and the call is cheap
  // and allowed while a stream is captured.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = hop::bind_context();           // the maps need a current context
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!hop::tensor_map_bshd(&tq, q, B, Sq, H, D) ||
      !hop::tensor_map_bshd(&tk, k, B, Sk, KV, D) ||
      !hop::tensor_map_bshd(&tv, v, B, Sk, KV, D))
    return cudaErrorInvalidValue;
  dim3 grid(B * H, (Sq + kWgBQ - 1) / kWgBQ);
  kernel<<<grid, kWgThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, KV,
      scale * 1.4426950408889634f, causal, window, seg, n_seg);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Sq, int Sk, int H, int KV,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  auto kernel = flash_f32_kernel<D>;
  constexpr int bytes = smem_bytes<D>();
  // Set on every launch: the opt-in is per device, and the call is cheap
  // and allowed while a stream is captured.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H,
      KV, scale, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int Sq, int Sk, int H, int KV,
                   float scale, int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale, causal,
                         window, stream);
  if (dtype == 1)
    return launch_bf16<D, false>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale,
                                 causal, window, nullptr, 0, stream);
  return cudaErrorInvalidValue;
}



}  // namespace

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  lse: float32 (B, Sq, H) or null.
// seg: null, or n_seg + 1 int32 segment offsets on the device (bfloat16,
// D 80, B = 1, Sq = Sk = seg[n_seg]); D 80 runs with segments only.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int D, float scale, int causal,
                                      int window, void* stream, void* lse,
                                      const void* seg, int n_seg) {
  if (Sq == 0 || B * H == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (seg != nullptr) {
    if (D != 80 || dtype != 1 || B != 1 || Sq != Sk || n_seg < 1)
      return cudaErrorInvalidValue;
    return launch_bf16<80, true>(q, k, v, o, l, 1, Sq, Sq, H, KV, scale,
                                 causal, window, static_cast<const int*>(seg),
                                 n_seg, s);
  }
  switch (D) {
    case 64:
      return launch<64>(dtype, q, k, v, o, l, B, Sq, Sk, H, KV, scale,
                        causal, window, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, l, B, Sq, Sk, H, KV, scale,
                         causal, window, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, l, B, Sq, Sk, H, KV, scale,
                         causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
