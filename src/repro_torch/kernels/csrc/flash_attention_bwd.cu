// FlashAttention-2 backward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma fed by TMA), float32 on the CUDA cores.
//
// Replaces repro/kernels/ops.py:108 _flash_bwd (XLA under the custom_vjp of
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
// j > i + Sk - Sq - window).  Sums are float; dq, dk and dv are rounded to
// the input type once.
//
// What bounds it on the card: operations.  At smollm-135m's training
// shape (B = 8, S = 2048, H = 9, KV = 3, D = 64, causal) a call has
// 1.51e8 visible (query, key) pairs: the five products need 10 D = 640
// operations a pair, 9.7e10 in all, 0.098 ms at the 989 TFLOP/s bf16
// tensor-core peak of an H100 SXM (its bytes, 101 MB, take 0.030 ms).  At
// recurrentgemma-2b's training microbatch (B = 2, S = 2048, H = 10,
// KV = 1, D = 256, window 2048, which at S = 2048 masks nothing the causal
// mask keeps) a call has 4.20e7 visible pairs: 10 D = 2560 operations a
// pair, 1.07e11 in all, 0.109 ms (its bytes, 92 MB, take 0.028 ms).
//
// Deterministic by construction: no atomics.  Two kernels, each output
// element summed by one thread in a fixed order, so reruns are
// bit-identical and a restarted training run replays a clean one to the
// bit.  The price is that S and dP are computed in both kernels.
//
// bf16 (dq_wgmma_kernel, dkdv_wgmma_kernel).  One block is one warpgroup
// of 128 threads with no producer warp: thread 0 loads the resident tiles
// once and streams the others through a 2-stage ring in shared memory with
// TMA (4-d maps over (D, heads, S, B), 128-byte swizzle, rows past S
// arriving as zeros; a full mbarrier a stage), issuing tile t + 1 into the
// stage tile t - 1 used once a __syncthreads shows every thread done with
// it, so each load has a whole tile's products to land in.  Four warps a
// block may use 255 registers a thread at two blocks an SM (168 at three);
// a fifth, producer warp, as in flash_attention.cu's forward, puts three
// warps on some of the SM's four partitions and caps two blocks at 168,
// where the dk/dv kernel's two accumulators and P and dS spilled.
//   - dq_wgmma_kernel, one block per (b * H + h, 64-query tile), heaviest
//     tiles first: Q and dout resident, the 64-key tiles of K and V that
//     the masks leave streamed.  First each thread quad computes lse and
//     delta for its two rows (delta from out and dout in global memory)
//     and writes them, lse log2-scaled, to a float32 scratch laid out
//     (B, H, Sq padded to 64) for the second kernel.  Per key tile:
//     S = Q K^T and dP = dout V^T (wgmma m64n64k16, both operands K-major
//     in shared memory), then in registers the masks,
//     P = exp2(log2e scale S - log2e lse) and dS, then dQ += dS K (wgmma
//     m64nDk16 with dS from registers and K read MN-major);
//   - dkdv_wgmma_kernel, one block per (b * KV + kv head, 64-key tile),
//     early (heaviest) key tiles first: K and V resident; for each of the
//     G heads of the group, the 64-query tiles that can see its keys
//     stream Q, dout and the tile's 64 lse and delta values (bulk copies
//     from the scratch).  S^T = K Q^T and dP^T = V dout^T (ss), P^T and
//     dS^T in registers (lse and delta are per column of the fragment),
//     then dV += P^T dout and dK += dS^T Q (register A, Q and dout read
//     MN-major).  Summing the whole group inside one block is what keeps
//     dk and dv free of atomics.
// The masks are a band on d = query position - key position; tiles whose
// every pair is visible and inside (Sq, Sk), most of them under a causal
// mask, skip the per-element test.
// Rounding: P and dS enter the three gradient products as bf16 hi + lo
// halves (hi = x rounded, lo = x - hi rounded; ~2^-17 relative), as the
// forward passes P.  Rounding either once would still keep every gradient
// element within 2 ulps of the plain value or within 2^-8 of its tensor's
// largest element, but moves the elements above 2^-8 of the largest by
// 18-63 bf16 ulps, against 1 ulp with both halves (rehearsed on the CPU
// with these tiles in tests/test_torch_flash_bwd.py); chip_smoke.py holds
// those elements to 2 ulps.  FLASH_BWD_LO below drops either half, for
// chip_smoke.py --bwd-rounding, which measures what the halves cost.
// With both halves the issued tensor work is 20 D a pair (the dq kernel S
// and dP at 2 D each and dQ at 2 x 2 D; the dk/dv kernel S and dP at 4 D,
// dV and dK at 2 x 2 x 2 D), twice the bound's 10 D.  Shared memory: six
// 64 x D tiles a block (48 KB at D = 64, 96 KB at D = 128); three dq blocks
// an SM at D = 64, two otherwise.
// D = 256 (recurrentgemma's local attention): one warpgroup cannot hold
// the accumulators of a 64-row tile (dK and dV alone are 2 x 64 x 256
// floats, 256 registers a thread).  So each kernel's OUTPUT columns are cut
// into two 128-wide halves, each half a block of its own (side by side in
// blockIdx.x, so that the two stream the same tiles through L2): a block
// still contracts all 256 of D in S and dP from shared memory, but
// accumulates only its half of dQ (64 registers) or of dK and dV (128),
// the D = 128 instance's registers, reading its half of K, Q or dO as the
// B operand (two of the tile's four 64-column panels).  The price is S and
// dP issued twice: 28 D a pair (the dq kernel 2 x 4 D + 4 D, the dk/dv
// kernel 2 x 4 D + 8 D) against the bound's 10 D.  Shared memory: six
// 64 x 256 tiles (each four 128-byte-swizzled panels), 192 KB plus the
// stats and slack, 198,680 bytes: one block an SM (min_blocks 1).
//
// Segments (bf16, D 80), as in flash_attention.cu: with offsets
// seg[0] = 0 < ... <= seg[n] = Sq = Sk (B = 1), a query sees only the keys
// of its own segment, under the causal mask or not.  The dq kernel streams
// only the key tiles between its first row's segment start and its last
// row's segment end, the dk/dv kernel only the query tiles between its
// first key's segment start and its last key's segment end; each row masks
// the columns outside its segment, and a tile inside one segment whose
// every pair the band keeps skips the per-element test.  The unsegmented
// instances are the kernels as they were (the flag is a template
// parameter).
// D = 80 (Qwen2-VL's vision tower): tiles of two 64-column panels, the TMA
// box past column 80 arriving as zeros; S and dP contract the 80 columns
// in five k16 steps, the three gradient products run at n = 80 (their B
// operand read MN-major from the first panel and 16 columns of the
// second; at the cell's shape 6.42 ms a call against 7.27 ms at n = 128
// over the zero-padded panels).
//
// float32 (dq_kernel, dkdv_kernel) stays on the CUDA cores in full
// float32: its contract (1e-5 x max|plain|, on which the card-vs-CPU
// training check rests) would not hold through TF32.  The same two
// passes, 256 threads as a 16 x 16 grid, thread (ty, tx) owning rows
// ty + 16 i and columns tx + 16 j of a 64 x 64 score tile and columns
// 4 tx + 64 g of its accumulator rows; tiles in shared memory as float
// rows padded by 4, so the 16-byte loads of 8 threads hit 32 banks; delta
// in the scratch as (B, Sq, H).  14 D float operations a pair (S and dP
// twice): 2.0 ms or more at the 67 TFLOP/s CUDA-core peak at the shape
// above.  At D = 256 four padded 64 x 256 float tiles would take 266 KB,
// so the tiles hold 128 columns (170,496 bytes with the score tiles, one
// block an SM) and the output columns are halved as in bf16: a block sums
// S and dP over the two column halves in turn (the order of one pass, so
// both halves see the same P and dS), then reloads its own half of the
// gradient product's operand if the other is in shared memory; the
// resident tiles are streamed again for each half.  22 D a pair.
//
// Host side: flash_attention_bwd_launch checks the head dimension (64, 128
// or 256; 80 with segments, in bf16), launches both kernels of the type on the caller's stream (the
// dq kernel first: it writes delta) and returns the first cudaError_t.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---- float32: the CUDA-core kernels ------------------------------------

constexpr int kThreads = 256;
constexpr int kB = 64;               // query and key tile
constexpr int kPad = 4;
constexpr int kLP = kB + kPad;       // row stride of the score tiles

// 16 bytes of float
__device__ __forceinline__ void load16(const float* p, float* out) {
  kern::Vec<float>::load(p, out);
}

// rows [r0, r0 + kB) of a (n, row_stride) float matrix into a tile with
// row stride D + kPad; rows past n are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long row_stride, int r0, int n) {
  constexpr int per_row = D / 4;
  for (int idx = threadIdx.x; idx < kB * per_row; idx += kThreads) {
    const int r = idx / per_row, c = (idx % per_row) * 4;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) load16(src + (long)(r0 + r) * row_stride + c, vals);
    kern::store4(dst + r * (D + kPad) + c, vals[0], vals[1], vals[2],
                 vals[3]);
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int causal, int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// Columns of D a float32 tile holds, and the output columns a block owns:
// all of D up to 128; at D = 256, half (four padded 64 x 256 float tiles
// would need 266 KB), each half a block of its own.
template <int D>
__host__ __device__ constexpr int f32_cols() {
  return D > 128 ? 128 : D;
}

template <int N>
__device__ __forceinline__ void zero_tile(float (&s)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) s[i][j] = 0.f;
}

// s[i][j] += A[ra_i] . B[rb_j] and t[i][j] += C[ra_i] . E[rb_j] over the D
// columns of the tiles, for rows ra_i = ty + 16 i of A and C and
// rb_j = tx + 16 j of B and E
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* Bm,
                                             const float* C, const float* E,
                                             float (&s)[4][4],
                                             float (&t)[4][4]) {
  constexpr int LD = D + kPad;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
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
  // four 64 x f32_cols<D>() tiles, two 64 x 64 score tiles, lse and delta
  return (4 * kB * (f32_cols<D>() + kPad) + 2 * kB * kLP + 2 * kB) * 4;
}

// ---- dq (and delta) ----------------------------------------------------------

// One block per (b * H + h, column block, 64-query tile).  At D = 256 the
// tiles hold 128 columns: S and dP sum over both halves of D in turn (the
// order of a single pass), then the block's own half of K is reloaded if
// it is not the one left in shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ lse, const float* __restrict__ dout,
          float* __restrict__ delta, float* __restrict__ dq, int Sq, int Sk,
          int H, int KV, float scale, int causal, int window) {
  constexpr int DC = f32_cols<D>();
  constexpr int NC = D / DC;
  constexpr int LD = DC + kPad;
  constexpr int CG = DC / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* dSs = Vs + kB * LD;
  float* lse_s = dSs + 2 * kB * kLP;
  float* delta_s = lse_s + kB;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int half = blockIdx.x % NC;
  const int b = blockIdx.x / NC / H, h = blockIdx.x / NC % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;   // heaviest tiles first
  const int off = Sk - Sq;
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  const long q_base = (long)b * Sq * q_stride + (long)h * D;
  const float* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const float* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  if (NC == 1) {
    load_tile<DC>(Qs, q + q_base, q_stride, q0, Sq);
    load_tile<DC>(dOs, dout + q_base, q_stride, q0, Sq);
  }

  // delta = rowsum(dout * out): warp w takes rows w, w + 8, ...
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kB; r += kThreads / 32) {
    float sum = 0.f;
    if (q0 + r < Sq) {
      const long row = q_base + (long)(q0 + r) * q_stride;
      for (int d = lane; d < D; d += 32) sum += dout[row + d] * o[row + d];
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, s);
    if (lane == 0) {
      delta_s[r] = sum;
      lse_s[r] = q0 + r < Sq ? lse[((long)b * Sq + q0 + r) * H + h] : 0.f;
      if (q0 + r < Sq && half == 0)
        delta[((long)b * Sq + q0 + r) * H + h] = sum;
    }
  }

  // the key range some row of this tile may see
  const int q_lo = q0 + off, q_hi = min(q0 + kB, Sq) - 1 + off;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_hi + 1);
  if (window > 0) k_begin = max(0, q_lo - window + 1) / kB * kB;

  float acc[4][4 * CG];
  zero_tile(acc);

  for (int k0 = k_begin; k0 < k_end; k0 += kB) {
    float s[4][4], dp[4][4];
    zero_tile(s);
    zero_tile(dp);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      __syncthreads();                 // the previous tile's readers are done
      if (NC > 1) {
        load_tile<DC>(Qs, q + q_base + c * DC, q_stride, q0, Sq);
        load_tile<DC>(dOs, dout + q_base + c * DC, q_stride, q0, Sq);
      }
      load_tile<DC>(Ks, kb + c * DC, kv_stride, k0, Sk);
      load_tile<DC>(Vs, vb + c * DC, kv_stride, k0, Sk);
      __syncthreads();
      two_products<DC>(Qs, Ks, dOs, Vs, s, dp);
    }
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
    if (NC > 1 && half != NC - 1) {   // this block's half of K
      __syncthreads();
      load_tile<DC>(Ks, kb + half * DC, kv_stride, k0, Sk);
    }
    __syncthreads();
    tile_product<DC>(dSs, Ks, acc);
  }

  float* dqb = dq + q_base + half * DC;
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

// One block per (b * KV + kv head, column block, 64-key tile); at D = 256
// the column halves as in dq_kernel, with K and V streamed beside Q and dO.
template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lse,
            const float* __restrict__ dout, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
            int H, int KV, float scale, int causal, int window) {
  constexpr int DC = f32_cols<D>();
  constexpr int NC = D / DC;
  constexpr int LD = DC + kPad;
  constexpr int CG = DC / 64;
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
  const int half = blockIdx.x % NC;
  const int b = blockIdx.x / NC / KV, kvh = blockIdx.x / NC % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * kB;      // early key tiles see the most queries
  const int off = Sk - Sq;
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  const long kv_base = (long)b * Sk * kv_stride + (long)kvh * D;

  if (NC == 1) {
    load_tile<DC>(Ks, k + kv_base, kv_stride, k0, Sk);
    load_tile<DC>(Vs, v + kv_base, kv_stride, k0, Sk);
  }

  // the query range that may see some key of this tile
  int qi_begin = 0, qi_end = Sq;
  if (causal) qi_begin = max(0, k0 - off) / kB * kB;
  if (window > 0) qi_end = max(0, min(Sq, k0 + kB - 1 + window - off));

  float adk[4][4 * CG], adv[4][4 * CG];
  zero_tile(adk);
  zero_tile(adv);

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long q_base = (long)b * Sq * q_stride + (long)h * D;
    for (int q0 = qi_begin; q0 < qi_end; q0 += kB) {
      float s[4][4], dp[4][4];         // transposed: rows are keys
      zero_tile(s);
      zero_tile(dp);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        __syncthreads();               // the previous tile's readers are done
        if (NC > 1) {
          load_tile<DC>(Ks, k + kv_base + c * DC, kv_stride, k0, Sk);
          load_tile<DC>(Vs, v + kv_base + c * DC, kv_stride, k0, Sk);
        }
        load_tile<DC>(Qs, q + q_base + c * DC, q_stride, q0, Sq);
        load_tile<DC>(dOs, dout + q_base + c * DC, q_stride, q0, Sq);
        if (c == 0 && threadIdx.x < kB) {
          const int r = q0 + threadIdx.x;
          const long at = ((long)b * Sq + r) * H + h;
          lse_s[threadIdx.x] = r < Sq ? lse[at] : 0.f;
          delta_s[threadIdx.x] = r < Sq ? delta[at] : 0.f;
        }
        __syncthreads();
        two_products<DC>(Ks, Qs, Vs, dOs, s, dp);
      }
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
      if (NC > 1 && half != NC - 1) {  // this block's half of Q and dO
        __syncthreads();
        load_tile<DC>(Qs, q + q_base + half * DC, q_stride, q0, Sq);
        load_tile<DC>(dOs, dout + q_base + half * DC, q_stride, q0, Sq);
      }
      __syncthreads();
      tile_product<DC>(Ps, dOs, adv);
      tile_product<DC>(dSs, Qs, adk);
    }
  }

  float* dkb = dk + kv_base + half * DC;
  float* dvb = dv + kv_base + half * DC;
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

// ---- bf16: the tensor-core kernels ------------------------------------------

constexpr int kWgB = 64;             // query and key tile rows
constexpr int kStages = 2;           // streamed tiles in flight
constexpr int kPanel = 64 * 128;     // 64 rows x 64 bf16 columns, swizzled
constexpr int kWgThreads = 128;      // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Which operands of the gradient products keep their lo halves: bit 0 P
// (dV += P^T dO), bit 1 dS (dQ += dS K, dK += dS^T Q).  Both by default;
// chip_smoke.py --bwd-rounding builds the other three settings to measure
// what the halves cost and how far the gradients move without them.
#ifndef FLASH_BWD_LO
#define FLASH_BWD_LO 3
#endif
constexpr bool kLoP = (FLASH_BWD_LO & 1) != 0;
constexpr bool kLoDS = (FLASH_BWD_LO & 2) != 0;

// Blocks an SM: a block of 4 warps may use 255 registers a thread at two
// blocks an SM and 168 at three; the dq kernel at D = 64 fits three.  At
// D = 256 six 64 x 256 tiles take 194 KB: one block an SM.
// Columns of a tile in shared memory: D rounded up to whole 64-column
// panels (D = 80: two panels, the second zero past column 80).
template <int D>
constexpr int kPadded = (D + 63) / 64 * 64;

template <int D>
constexpr int min_blocks(bool dq) {
  return D == 256 ? 1 : D == 64 && dq ? 3 : 2;
}

// Output columns a block owns: all of D up to 128; at D = 256, a 128-column
// half, each half a block of its own.  A block's S and dP still contract
// all of D; only its gradient accumulators (64 x DO floats each) and the
// B operand of its gradient products are cut, so the registers are those
// of the D = 128 instance.
template <int D>
__host__ __device__ constexpr int out_cols() {
  return D > 128 ? 128 : D;
}


template <int D>
struct BwdLayout {
  static constexpr int kTile = (kPadded<D> / 64) * kPanel;  // 64 x D tile
  // two resident tiles, kStages x two streamed tiles, per stage 64 lse and
  // 64 delta values (the dk/dv kernel), barriers, and slack to align the
  // tiles to 1024 bytes
  static constexpr int kBytes = 1024 + kTile * (2 + 2 * kStages) +
                                kStages * 2 * kWgB * 4 + 8 * (kStages + 1);
};

// the accumulator register pairs of every 64 x N fragment: thread (warp
// w, lane 4 g + c) holds rows 16 w + g (regs 4 j, 4 j + 1) and
// 16 w + g + 8 (4 j + 2, 4 j + 3) at columns 8 j + 2 c and 8 j + 2 c + 1
__device__ __forceinline__ int frag_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(int i, int c) {
  return 8 * (i >> 2) + 2 * c + (i & 1);
}

template <int N>
__device__ __forceinline__ void fence_regs(float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) hop::fence_reg(x[i]);
}

template <int N>
__device__ __forceinline__ void zero(float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// d (64 x 64) = A B^T over D, with A and B 64 x D tiles in shared memory,
// both K-major (the first k-step overwrites d); issued, not waited for
template <int D>
__device__ __forceinline__ void product_ss(float* d, const uint8_t* A,
                                           const uint8_t* B) {
  // a descriptor's low field is the address / 16: the k-steps add to it
  const uint64_t da = hop::desc_sw128(A, 16, 1024);
  const uint64_t db = hop::desc_sw128(B, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int at = ((kk / 4) * kPanel + (kk % 4) * 32) >> 4;
    hop::wgmma_m64n64k16_ss(d, da + at, db + at, kk > 0);
  }
}

// The masks as a band on d = query position - key position: visible iff
// lo <= d <= hi (causal: lo = 0; window > 0: hi = window - 1).
struct Band {
  int lo, hi;
  __device__ __forceinline__ Band(int causal, int window)
      : lo(causal ? 0 : INT_MIN), hi(window > 0 ? window - 1 : INT_MAX) {}
  __device__ __forceinline__ bool has(int d) const {
    return d >= lo && d <= hi;
  }
  // whether every pair of the 64 x 64 tile at (q0 + off, k0) is visible
  // and inside (Sq, Sk): such tiles skip the per-element masks
  __device__ __forceinline__ bool covers(int q0, int k0, int off, int Sq,
                                         int Sk) const {
    return q0 + kWgB <= Sq && k0 + kWgB <= Sk &&
           q0 + off - (k0 + kWgB - 1) >= lo && q0 + kWgB - 1 + off - k0 <= hi;
  }
};

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// A 64 x 64 accumulator fragment as the bf16 A fragments of four k16
// steps (step kk takes column blocks 2 kk and 2 kk + 1), split into
// hi = x rounded and lo = x - hi rounded
__device__ __forceinline__ void a_frags(const float* x, uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 8 * kk + 4 * (q >> 1) + 2 * (q & 1);
      hop::split_bf16(x[i], x[i + 1], hi[kk][q], lo[kk][q]);
    }
  }
}

// acc (64 x D) += A B over 64 rows of k, A as the fragments' hi then (kLo)
// lo halves, B the 64 x D tile at ``B`` read MN-major; issued, not waited
// for
template <int D, bool kLo>
__device__ __forceinline__ void product_rs(float* acc,
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4],
                                           const uint8_t* B) {
  const uint64_t db = hop::desc_sw128(B, kPanel, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_m64k16_rs<D>(acc, hi[kk], db + kk * (2048 >> 4));
  if constexpr (kLo) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_m64k16_rs<D>(acc, lo[kk], db + kk * (2048 >> 4));
  }
}

// a 64 x D float fragment rounded to bf16 into rows [r0, r0 + 64) of a
// (n, stride) matrix; rows past n are not written
template <int D>
__device__ __forceinline__ void store_frag(__nv_bfloat16* base, long stride,
                                           const float* acc, int r0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(base + row * stride + 8 * j + 2 * c) =
          hop::pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ---- dq (and lse, delta for the dk/dv kernel) ---------------------------

template <int D, bool kSeg>
__global__ void __launch_bounds__(kWgThreads, min_blocks<D>(true))
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2_out,
                float* __restrict__ delta_out, __nv_bfloat16* __restrict__ dq,
                int Sq, int Sk, int H, int KV, int Sqp, float scale,
                int causal, int window, const int* __restrict__ seg,
                int n_seg) {
  constexpr int kTile = BwdLayout<D>::kTile;
  constexpr int NP = kPadded<D> / 64;  // panels of a tile
  constexpr int DO = out_cols<D>();
  constexpr int NH = (D + DO - 1) / DO;  // column blocks
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* dOs = smem + kTile;
  uint8_t* KVs = smem + 2 * kTile;     // stage s: K at 2 s kTile, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + 2 * kStages * kTile);
  uint64_t* qbar = full + kStages;

  // the column blocks of one (b, h) side by side, so they share the tiles
  // they stream in L2
  const int half = blockIdx.x % NH;
  const int b = blockIdx.x / NH / H, h = blockIdx.x / NH % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgB;   // heaviest first
  const int off = Sk - Sq;
  // the key range some row of this tile may see
  const int q_lo = q0 + off, q_hi = min(q0 + kWgB, Sq) - 1 + off;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_hi + 1);
  if (window > 0) k_begin = max(0, q_lo - window + 1) / kWgB * kWgB;
  // with segments (Sq = Sk): the tile's rows lie in [seg_first, seg_last)
  // and, where they share one segment (one_seg), every key of a tile
  // inside it is visible to every row of it, up to the band
  int seg_first = 0, seg_last = Sk;
  bool one_seg = false;
  if constexpr (kSeg) {
    int lo, hi, lo2, hi2;
    kern::seg_bounds(seg, n_seg, q0, lo, hi);
    kern::seg_bounds(seg, n_seg, min(q0 + kWgB, Sq) - 1, lo2, hi2);
    k_begin = max(k_begin, lo / kWgB * kWgB);
    k_end = min(k_end, hi2);
    seg_first = lo;
    seg_last = hi2;
    one_seg = lo == lo2;
  }
  const int n_tiles = max(0, (k_end - k_begin + kWgB - 1) / kWgB);

  // thread 0 loads: Q and dO once, key tile t + 1 while tile t is used
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    uint8_t* Kt = KVs + 2 * s * kTile;
    const int k0 = k_begin + t * kWgB;
    hop::mbar_expect_tx(&full[s], 2 * kTile);
    for (int p = 0; p < NP; ++p) {
      hop::tma_load_4d(Kt + p * kPanel, &tk, &full[s], 64 * p, kvh, k0, b);
      hop::tma_load_4d(Kt + kTile + p * kPanel, &tv, &full[s], 64 * p, kvh,
                       k0, b);
    }
  };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hop::mbar_init(&full[s], 1);
    hop::mbar_init(qbar, 1);
    hop::fence_mbar_init();
    hop::mbar_expect_tx(qbar, 2 * kTile);
    for (int p = 0; p < NP; ++p) {
      hop::tma_load_4d(Qs + p * kPanel, &tq, qbar, 64 * p, h, q0, b);
      hop::tma_load_4d(dOs + p * kPanel, &tdo, qbar, 64 * p, h, q0, b);
    }
    if (n_tiles > 0) load_kv(0);
  }
  __syncthreads();

  // lse and delta = rowsum(dout * out) for this thread's two rows (the
  // fragment layout above), each quad (c = 0..3) summing a quarter of D
  // and combining by shuffles
  const int lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int row0 = (tid >> 5) * 16 + g;
  const long q_stride = (long)H * D;
  const long stat = (long)(b * H + h) * Sqp + q0;
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    float sum = 0.f;
    lse2[r] = 0.f;
    if (row < Sq) {
      const long at = ((long)b * Sq + row) * q_stride + (long)h * D;
      // 8 columns from ``e`` on
      auto add8 = [&](long e) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + e);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + e);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 of = __bfloat1622float2(o2[u]);
          const float2 df = __bfloat1622float2(d2[u]);
          sum += df.x * of.x;
          sum += df.y * of.y;
        }
      };
      if constexpr (D % 32 == 0) {     // a quarter of D each
#pragma unroll
        for (int e = 0; e < D / 4; e += 8) add8(at + c * (D / 4) + e);
      } else {                         // D = 80: every fourth 8 columns
#pragma unroll
        for (int j = c; j < D / 8; j += 4) add8(at + 8 * j);
      }
      lse2[r] = lse[((long)b * Sq + row) * H + h] * kLog2e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[r] = sum;
    if (c == 0 && half == 0) {         // rows past Sq too: the pad is zero
      lse2_out[stat + row0 + 8 * r] = lse2[r];
      delta_out[stat + row0 + 8 * r] = sum;
    }
  }
  const float scale_log2 = scale * kLog2e;
  const Band band(causal, window);
  const bool q_in[2] = {q0 + row0 < Sq, q0 + row0 + 8 < Sq};
  // each row's segment (rows past Sq see none)
  int seg_lo[2] = {0, 0}, seg_hi[2] = {Sk, Sk};
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (q_in[r])
        kern::seg_bounds(seg, n_seg, q0 + row0 + 8 * r, seg_lo[r], seg_hi[r]);
      else
        seg_lo[r] = seg_hi[r] = 0;
    }
  }

  float acc[DO / 2];
  zero<DO / 2>(acc);
  hop::mbar_wait(qbar, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    if (t + 1 < n_tiles) {
      __syncthreads();                 // every thread is done with tile t - 1
      if (tid == 0) load_kv(t + 1);    // into the stage tile t - 1 used
    }
    hop::mbar_wait(&full[s], (t / kStages) & 1);
    __syncwarp();
    const uint8_t* Kt = KVs + 2 * s * kTile;
    const uint8_t* Vt = Kt + kTile;

    // S = Q K^T and dP = dO V^T
    float sc[32], dp[32];
    fence_regs<32>(sc);
    fence_regs<32>(dp);
    hop::wgmma_fence();
    product_ss<D>(sc, Qs, Kt);
    product_ss<D>(dp, dOs, Vt);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    fence_regs<32>(sc);
    fence_regs<32>(dp);

    // P = exp2(log2e scale S - log2e lse) where visible, dS = P (dP - delta)
    // scale; at register i, d = qpos - kpos is d0 + 8 r - 8 j - (i & 1)
    const int k0 = k_begin + t * kWgB;
    const int d0 = q0 + row0 + off - k0 - 2 * c;
    auto tile = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = frag_half(i);
        float p = exp2f(fmaf(sc[i], scale_log2, -lse2[r]));
        if constexpr (decltype(masked)::value) {
          const int kpos = k0 + frag_col(i, c);
          bool ok = q_in[r] && kpos < Sk &&
                    band.has(d0 + 8 * r - 8 * (i >> 2) - (i & 1));
          if constexpr (kSeg) ok = ok && kpos >= seg_lo[r] && kpos < seg_hi[r];
          p = ok ? p : 0.f;
        }
        dp[i] = p * (dp[i] - delta[r]) * scale;
      }
    };
    if (band.covers(q0, k0, off, Sq, Sk) &&
        (!kSeg || (one_seg && k0 >= seg_first && k0 + kWgB <= seg_last)))
      tile(Flag<false>());
    else
      tile(Flag<true>());

    // dQ += dS K, over this block's columns of K
    uint32_t hi[4][4], lo[4][4];
    a_frags(dp, hi, lo);
    fence_regs<DO / 2>(acc);
    hop::wgmma_fence();
    product_rs<DO, kLoDS>(acc, hi, lo, Kt + half * (DO / 64) * kPanel);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    fence_regs<DO / 2>(acc);
  }
  store_frag<DO>(
      dq + (long)b * Sq * q_stride + (long)h * D + half * DO, q_stride, acc,
      q0, Sq);
}

// ---- dk, dv ---------------------------------------------------------------

template <int D, bool kSeg>
__global__ void __launch_bounds__(kWgThreads, min_blocks<D>(false))
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse2_in,
                  const float* __restrict__ delta_in,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                  int KV, int Sqp, float scale, int causal, int window,
                  const int* __restrict__ seg, int n_seg) {
  constexpr int kTile = BwdLayout<D>::kTile;
  constexpr int NP = kPadded<D> / 64;
  constexpr int DO = out_cols<D>();
  constexpr int NH = (D + DO - 1) / DO;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + kTile;
  uint8_t* QDs = smem + 2 * kTile;     // stage s: Q at 2 s kTile, dO after it
  float* stats = reinterpret_cast<float*>(QDs + 2 * kStages * kTile);
  // stage s: lse2 at stats + 2 s kWgB, delta after it
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * kStages * kWgB);
  uint64_t* kvbar = full + kStages;

  const int half = blockIdx.x % NH;
  const int b = blockIdx.x / NH / KV, kvh = blockIdx.x / NH % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * kWgB;    // early key tiles see the most queries
  const int off = Sk - Sq;
  // the query range that may see some key of this tile
  int qi_begin = 0, qi_end = Sq;
  if (causal) qi_begin = max(0, k0 - off) / kWgB * kWgB;
  if (window > 0) qi_end = max(0, min(Sq, k0 + kWgB - 1 + window - off));
  // with segments (Sq = Sk): the tile's keys lie in [seg_first, seg_last),
  // in one segment where one_seg
  int seg_first = 0, seg_last = Sq;
  bool one_seg = false;
  if constexpr (kSeg) {
    int lo, hi, lo2, hi2;
    kern::seg_bounds(seg, n_seg, k0, lo, hi);
    kern::seg_bounds(seg, n_seg, min(k0 + kWgB, Sk) - 1, lo2, hi2);
    qi_begin = max(qi_begin, lo / kWgB * kWgB);
    qi_end = min(qi_end, hi2);
    seg_first = lo;
    seg_last = hi2;
    one_seg = lo == lo2;
  }
  const int n_q = max(0, (qi_end - qi_begin + kWgB - 1) / kWgB);
  const int n_tiles = G * n_q;         // (head of the group, query tile)

  // thread 0 loads: K and V once, query tile t + 1 (Q, dO and its 64 lse
  // and delta values) while tile t is used
  auto load_q = [&](int t) {
    const int s = t % kStages;
    const int h = kvh * G + t / n_q;
    const int q0 = qi_begin + (t % n_q) * kWgB;
    uint8_t* Qt = QDs + 2 * s * kTile;
    hop::mbar_expect_tx(&full[s], 2 * kTile + 2 * kWgB * 4);
    for (int p = 0; p < NP; ++p) {
      hop::tma_load_4d(Qt + p * kPanel, &tq, &full[s], 64 * p, h, q0, b);
      hop::tma_load_4d(Qt + kTile + p * kPanel, &tdo, &full[s], 64 * p, h,
                       q0, b);
    }
    const long stat = (long)(b * H + h) * Sqp + q0;
    hop::bulk_load(stats + 2 * s * kWgB, lse2_in + stat, kWgB * 4, &full[s]);
    hop::bulk_load(stats + (2 * s + 1) * kWgB, delta_in + stat, kWgB * 4,
                   &full[s]);
  };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hop::mbar_init(&full[s], 1);
    hop::mbar_init(kvbar, 1);
    hop::fence_mbar_init();
    if (n_tiles > 0) {
      hop::mbar_expect_tx(kvbar, 2 * kTile);
      for (int p = 0; p < NP; ++p) {
        hop::tma_load_4d(Ks + p * kPanel, &tk, kvbar, 64 * p, kvh, k0, b);
        hop::tma_load_4d(Vs + p * kPanel, &tv, kvbar, 64 * p, kvh, k0, b);
      }
      load_q(0);
    }
  }
  __syncthreads();

  // rows of S^T are keys, columns queries
  const int lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int row0 = (tid >> 5) * 16 + g;
  const float scale_log2 = scale * kLog2e;
  const Band band(causal, window);
  const bool k_in[2] = {k0 + row0 < Sk, k0 + row0 + 8 < Sk};
  // each key row's segment (rows past Sk see none)
  int seg_lo[2] = {0, 0}, seg_hi[2] = {Sq, Sq};
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (k_in[r])
        kern::seg_bounds(seg, n_seg, k0 + row0 + 8 * r, seg_lo[r], seg_hi[r]);
      else
        seg_lo[r] = seg_hi[r] = 0;
    }
  }
  float adk[DO / 2], adv[DO / 2];
  zero<DO / 2>(adk);
  zero<DO / 2>(adv);
  if (n_tiles > 0) hop::mbar_wait(kvbar, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    if (t + 1 < n_tiles) {
      __syncthreads();                 // every thread is done with tile t - 1
      if (tid == 0) load_q(t + 1);     // into the stage tile t - 1 used
    }
    hop::mbar_wait(&full[s], (t / kStages) & 1);
    __syncwarp();
    const uint8_t* Qt = QDs + 2 * s * kTile;
    const uint8_t* dOt = Qt + kTile;
    const float* lse2 = stats + 2 * s * kWgB;
    const float* delta = lse2 + kWgB;

    // S^T = K Q^T and dP^T = V dO^T
    float st[32], dpt[32];
    fence_regs<32>(st);
    fence_regs<32>(dpt);
    hop::wgmma_fence();
    product_ss<D>(st, Ks, Qt);
    product_ss<D>(dpt, Vs, dOt);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    fence_regs<32>(st);
    fence_regs<32>(dpt);

    // P^T and dS^T; lse and delta belong to the query columns; at register
    // i, d = qpos - kpos is d0 + 8 j + (i & 1) - 8 r
    const int q0 = qi_begin + (t % n_q) * kWgB;
    const int d0 = q0 + off - k0 - row0 + 2 * c;
    auto tile = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = frag_col(i, c), r = frag_half(i);
        float p = exp2f(fmaf(st[i], scale_log2, -lse2[col]));
        if constexpr (decltype(masked)::value) {
          bool ok = k_in[r] && q0 + col < Sq &&
                    band.has(d0 + 8 * (i >> 2) + (i & 1) - 8 * r);
          if constexpr (kSeg)
            ok = ok && q0 + col >= seg_lo[r] && q0 + col < seg_hi[r];
          p = ok ? p : 0.f;
        }
        st[i] = p;
        dpt[i] = p * (dpt[i] - delta[col]) * scale;
      }
    };
    if (band.covers(q0, k0, off, Sq, Sk) &&
        (!kSeg || (one_seg && q0 >= seg_first && q0 + kWgB <= seg_last)))
      tile(Flag<false>());
    else
      tile(Flag<true>());

    // dV += P^T dO and dK += dS^T Q, over this block's columns
    uint32_t phi[4][4], plo[4][4], shi[4][4], slo[4][4];
    a_frags(st, phi, plo);
    a_frags(dpt, shi, slo);
    fence_regs<DO / 2>(adv);
    fence_regs<DO / 2>(adk);
    hop::wgmma_fence();
    product_rs<DO, kLoP>(adv, phi, plo, dOt + half * (DO / 64) * kPanel);
    product_rs<DO, kLoDS>(adk, shi, slo, Qt + half * (DO / 64) * kPanel);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    fence_regs<DO / 2>(adv);
    fence_regs<DO / 2>(adk);
  }
  const long kv_stride = (long)KV * D;
  const long kv_base = (long)b * Sk * kv_stride + (long)kvh * D + half * DO;
  store_frag<DO>(dk + kv_base, kv_stride, adk, k0, Sk);
  store_frag<DO>(dv + kv_base, kv_stride, adv, k0, Sk);
}

// ---- host side -------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int Sq, int Sk, int H, int KV, float scale, int causal,
                       int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kq = dq_kernel<D>;
  auto kkv = dkdv_kernel<D>;
  // Set on every launch: the opt-in is per device, and the call is cheap
  // and allowed while a stream is captured.
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  constexpr int NC = D / f32_cols<D>();
  kq<<<dim3(B * H * NC, (Sq + kB - 1) / kB), kThreads, bytes, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), lse, dot, delta,
      static_cast<float*>(dq), Sq, Sk, H, KV, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3(B * KV * NC, (Sk + kB - 1) / kB), kThreads, bytes, stream>>>(
      qt, kt, vt, lse, dot, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Sk, H, KV, scale, causal, window);
  return cudaGetLastError();
}

template <int D, bool kSeg>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dout,
                        float* scratch, void* dq, void* dk, void* dv, int B,
                        int Sq, int Sk, int H, int KV, float scale,
                        int causal, int window, const int* seg, int n_seg,
                        cudaStream_t stream) {
  constexpr int bytes = BwdLayout<D>::kBytes;
  auto kq = dq_wgmma_kernel<D, kSeg>;
  auto kkv = dkdv_wgmma_kernel<D, kSeg>;
  // Set on every launch: the opt-in is per device, and the call is cheap
  // and allowed while a stream is captured.
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = hop::bind_context();           // the maps need a current context
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (!hop::tensor_map_bshd(&tq, q, B, Sq, H, D) ||
      !hop::tensor_map_bshd(&tk, k, B, Sk, KV, D) ||
      !hop::tensor_map_bshd(&tv, v, B, Sk, KV, D) ||
      !hop::tensor_map_bshd(&tdo, dout, B, Sq, H, D))
    return cudaErrorInvalidValue;
  // scratch: lse log2-scaled, then delta, each (B, H, Sqp) with the query
  // axis padded to whole tiles, so the dk/dv kernel bulk-loads a tile's
  const int Sqp = (Sq + kWgB - 1) / kWgB * kWgB;
  float* lse2 = scratch;
  float* delta = scratch + (long)B * H * Sqp;
  constexpr int NH = (D + out_cols<D>() - 1) / out_cols<D>();
  kq<<<dim3(B * H * NH, Sqp / kWgB), kWgThreads, bytes, stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lse2, delta,
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, KV, Sqp, scale, causal,
      window, seg, n_seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3(B * KV * NH, (Sk + kWgB - 1) / kWgB), kWgThreads, bytes,
                stream>>>(
      tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, KV, Sqp, scale, causal,
      window, seg, n_seg);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_typed(int dtype, const void* q, const void* k,
                         const void* v, const void* o, const float* lse,
                         const void* dout, float* scratch, void* dq, void* dk,
                         void* dv, int B, int Sq, int Sk, int H, int KV,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, dout, scratch, dq, dk, dv, B, Sq,
                         Sk, H, KV, scale, causal, window, stream);
  if (dtype == 1)
    return launch_bf16<D, false>(q, k, v, o, lse, dout, scratch, dq, dk, dv,
                                 B, Sq, Sk, H, KV, scale, causal, window,
                                 nullptr, 0, stream);
  return cudaErrorInvalidValue;
}



}  // namespace

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  lse: float32 (B, Sq, H).  scratch:
// float32, 2 B H (Sq rounded up to 64) elements, filled by the call.  seg:
// null, or n_seg + 1 int32 segment offsets on the device (bfloat16, D 80,
// B = 1, Sq = Sk = seg[n_seg]); D 80 runs with segments only.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* scratch, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int KV, int D,
    float scale, int causal, int window, void* stream, const void* seg,
    int n_seg) {
  if (B * H == 0 || Sk == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (seg != nullptr) {
    if (D != 80 || dtype != 1 || B != 1 || Sq != Sk || n_seg < 1)
      return cudaErrorInvalidValue;
    return launch_bf16<80, true>(q, k, v, o, l, dout, sc, dq, dk, dv, 1, Sq,
                                 Sq, H, KV, scale, causal, window,
                                 static_cast<const int*>(seg), n_seg, s);
  }
  switch (D) {
    case 64:
      return launch_typed<64>(dtype, q, k, v, o, l, dout, sc, dq, dk, dv, B,
                              Sq, Sk, H, KV, scale, causal, window, s);
    case 128:
      return launch_typed<128>(dtype, q, k, v, o, l, dout, sc, dq, dk, dv, B,
                               Sq, Sk, H, KV, scale, causal, window, s);
    case 256:
      return launch_typed<256>(dtype, q, k, v, o, l, dout, sc, dq, dk, dv, B,
                               Sq, Sk, H, KV, scale, causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
