// Checkpointing-DP recurrence (Eqs. 11-15) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dp_recurrence.py
// (dp_recurrence / _dp_kernel).  For each scenario s, restart-cost sweep
// and row j = 1..j_max it computes, for every VM age t,
//
//   V[j,t] = min_{i=1..j} (1-p) * (w*dt + V[j-i, min(t+w, t_max)])
//                         + p * (e_lost + R_j)
//   K[j,t] = the first i reaching that minimum (ascending scan, strict <)
//
// with w = i on the final segment (i == j) and i + delta otherwise,
// p = clip((F[e]-F[t]) / max(1-F[t], eps), 0, 1), e = min(t+w, t_max),
// e_lost = clip((H[e]-H[t]) / max(F[e]-F[t], eps) - t*dt, 0, w*dt), and
// R_j = overhead + (the restart column snapshotted at sweep start)[j].
// The dollar form bills segments at dP = Pc[t+w] - Pc[t] (Pc gathered
// unclipped on its extended axis) and lost work at e_lost * dP / (w*dt).
// Lanes with 1 - F[t] < 1e-6 are dead VMs: V = R_j, K = j.
//
// What bounds it on the card: operations.  A main-path solve (S = 8,
// j_max = 300, t_max = 1440, 3 sweeps) evaluates ~1.56e9 candidate lanes of
// ~20 f32 operations (two of them IEEE divisions, ~10 instructions each),
// while its tables are only 27.8 MB.  Rows are serial: row j reads rows
// 0..j-1 of the same sweep at later ages.
//
// Design.  The work item is (sweep k, row j, scenario s, tile of 32
// consecutive ages).  A block of 4 warps takes one item: each warp holds
// the tile's 32 ages in its lanes (so its loads of F[e], H[e] and
// V[j-i, e] are coalesced) and scans the candidates i = g+1, g+5, ... of
// its index g with a running min and argmin; the warps then combine their
// (min, argmin) in shared memory, the smaller i first on equal costs.  The
// scenario's F, H (and Pc) window that the tile can reach is staged in
// shared memory once per item; earlier rows stream from the L2 (a
// scenario's value table is 1.7 MB, far more than a block's shared memory).
// At the main path a row is 8 x 46 items of 128 threads (~47k threads,
// ~38 candidates a thread on average) instead of one thread per age.
//
// Schedule: ONE persistent launch per solve, sized to the blocks the card
// holds at once.  Blocks claim items from an atomic ticket in dependency
// order (sweep, row ascending, tiles descending, scenarios), so an item
// waits only on items with smaller tickets, which resident blocks have
// claimed: no deadlock at any occupancy and no cooperative launch.  A
// per-(s, row, tile) flag holds the last sweep + 1 that finished the tile:
// a release store after the tile's writes, an acquire spin (thread 0)
// before the reads.  Every live lane reads earlier rows only at ages
// e > t, so a row's tile needs the row before only from its own tile up to
// the one holding age t_end + 1 + delta (and that row waited in turn for
// the one before it, one step further, so all earlier rows are covered).
// Only the late candidates i = 1..8 (two per warp) read the newest rows
// j-1..j-8, so an item scans its early candidates i >= 9 as soon as row
// j-9 is final and waits for row j-1 only before its late ones.  The
// critical path through the rows is then two candidates and a combine per
// row, and the bulk of row j runs while rows j-8..j-1 finish.  Rows 1..9 of
// a sweep k > 0 first wait for the whole of sweep k-1 (its row j_max),
// which the restart column and the rows they overwrite need.
// The late candidates are scanned after the early ones, in descending
// order, so each takes a tie with those before it (it is the smaller i):
// the argmin stays the first match.  4 warps and a lag of 9 measured
// fastest on an H100 (8 or 16 warps, 2 warps, lags 13 and 17, one launch
// per row, and register caps of 32 or 40 were slower; PERF.md).
//
// tests/test_torch_dp.py replays this ticket order and the waits above under
// adversarial interleavings and checks that every read sees the final
// value of its sweep; it reads kTile, kGroups and kLag from this file.

// Traps the wavefront must avoid:
//   - Stale L1: the L1 is not coherent across SMs, and later sweeps
//     overwrite rows an SM has already read, so every read of V and of the
//     restart column (written by other blocks in this launch) goes through
//     ld.global.cg to the L2.
//   - The restart column: row j's tile 0 can finish before its other tiles
//     read R_j, so R_j never comes from V[:, :, 0] in flight.  The item
//     holding age 0 also writes its V into a per-sweep snapshot buffer,
//     double-buffered by sweep parity: sweep k reads buffer k % 2 (the
//     seed col0 for k = 0) and writes buffer (k + 1) % 2.
//   - Dead lanes still write V = R_j, K = j; a tile whose lanes are all
//     dead skips the candidate loop.
//
// Rounding: built with -fmad=false (kernels/_build.py) and IEEE division,
// each candidate's cost in the order of dp_recurrence_plain, so the tables
// match the plain version to the bit; with FMA contraction the J = 300
// tables flipped 0.11 % of their near-tied argmins.
//
// Host side: dp_recurrence_launch zeroes row 0 of the tables and the
// workspace (ticket, flags), copies col0 into snapshot buffer 0, and
// launches on the caller's stream: 1 launch per solve, all sweeps
// included.  It returns the first cudaError_t it meets.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;                  // ages per item: one warp's lanes
constexpr int kGroups = 4;                 // warps splitting the candidates
constexpr int kThreads = kTile * kGroups;
constexpr int kUnroll = 4;                 // V loads issued ahead per warp
// Candidates i < kLag read the newest rows j-1 .. j-kLag+1; kLag - 1 is a
// multiple of kGroups, so each warp has the same number of them.
constexpr int kLag = 2 * kGroups + 1;
constexpr float kEps = 1e-9f;

struct Params {
  const float* Fc;      // (S, T)
  const float* Hc;      // (S, T)
  const float* Pc;      // (S, tx), dollar mode only
  const float* Ro;      // (S,), dollar mode only
  float* V;             // (S, J1, T)
  int* K;               // (S, J1, T)
  float* rcol;          // (2, S, J1): restart-column snapshots by parity
  int* ticket;          // next item to claim
  int* flags;           // (S, J1, tiles) last sweep + 1 done
  int S, j_max, t_max, delta, n_sweeps, tx, tiles;
  float dt, restart_overhead;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Spins until *p >= want.  Every wait is on an item with a smaller ticket,
// so it ends; one that outlasts ~2^28 polls (tens of seconds) means a broken
// schedule, and the kernel traps (a launch failure) instead of hanging.
__device__ __forceinline__ void wait_flag(const int* p, int want) {
  for (unsigned polls = 0; ld_acquire(p) < want; ++polls) {
    if (polls > (1u << 28)) __trap();
    __nanosleep(64);
  }
}

// Shared memory of a block: the staged F, H (and Pc) window of an item and
// the warps' partial (min, argmin).
struct Smem {
  float* F;
  float* H;
  float* P;
  float* m;    // [kGroups][kTile]
  int* k;      // [kGroups][kTile]
};

__device__ __forceinline__ Smem carve(float* base, int window) {
  Smem sm;
  sm.F = base;
  sm.H = base + window;
  sm.P = base + 2 * window;
  sm.m = base + 3 * window;
  sm.k = reinterpret_cast<int*>(sm.m + kGroups * kTile);
  return sm;
}

// The scenario's F, H (and Pc) entries that item (row j, ages t0..) can
// reach: ages t0 .. t0 + kTile - 1 + j + delta, clipped to the arrays.
template <bool kPrice>
__device__ __forceinline__ void stage(const Params& p, const Smem& sm, int s,
                                      int j, int t0) {
  const int T = p.t_max + 1;
  const int reach = t0 + kTile - 1 + j + p.delta;
  const int nF = min(reach, p.t_max) - t0 + 1;
  const float* fc = p.Fc + (size_t)s * T + t0;
  const float* hc = p.Hc + (size_t)s * T + t0;
  for (int x = threadIdx.x; x < nF; x += kThreads) {
    sm.F[x] = __ldg(fc + x);
    sm.H[x] = __ldg(hc + x);
  }
  if (kPrice) {
    const int nP = min(reach, p.tx - 1) - t0 + 1;
    const float* pc = p.Pc + (size_t)s * p.tx + t0;
    for (int x = threadIdx.x; x < nP; x += kThreads) sm.P[x] = __ldg(pc + x);
  }
}

// One candidate's cost, in dp_recurrence_plain's order of operations.
template <bool kPrice>
__device__ __forceinline__ float candidate_cost(const Params& p,
                                                const Smem& sm, int i, int j,
                                                int t, int t0, float Ft,
                                                float Ht, float St, float tdt,
                                                float Pt, float Rj,
                                                float vrow) {
  const int w = (i == j) ? i : i + p.delta;
  const int e = min(t + w, p.t_max);
  const float dFe = sm.F[e - t0] - Ft;
  const float pf = fminf(fmaxf(dFe / St, 0.0f), 1.0f);
  const float dF = fmaxf(dFe, kEps);
  const float wdt = (float)w * p.dt;
  const float el = fminf(fmaxf((sm.H[e - t0] - Ht) / dF - tdt, 0.0f), wdt);
  if (kPrice) {
    const float dP = sm.P[t + w - t0] - Pt;
    const float pb = dP / wdt;
    return (1.0f - pf) * (dP + vrow) + pf * (el * pb + Rj);
  }
  return (1.0f - pf) * (wdt + vrow) + pf * (el + Rj);
}

// V[j-i, min(t+w, t_max)] of scenario table vs, through the L2.
__device__ __forceinline__ float earlier_value(const Params& p,
                                               const float* vs, int i, int j,
                                               int t) {
  const int w = (i == j) ? i : i + p.delta;
  return __ldcg(vs + (size_t)(j - i) * (p.t_max + 1) + min(t + w, p.t_max));
}

// Thread 0: waits until row r's tiles tile .. (the one holding age
// tile * kTile + kTile - 1 + reach) are final for sweep k.
__device__ __forceinline__ void wait_row(const Params& p, int s, int r, int k,
                                         int tile, int reach) {
  const int* f = p.flags + ((size_t)s * (p.j_max + 1) + r) * p.tiles;
  const int last = min(tile * kTile + kTile - 1 + reach, p.t_max) / kTile;
  for (int x = tile; x <= last; ++x) wait_flag(f + x, k + 1);
}

// One item, F/H/Pc staged and visible, and rows j-kLag and below final.
// Warp g scans its early candidates i = g+kLag, g+kLag+kGroups, ... (rows
// j-kLag and below) ascending with a strict <; then, once thread 0 has
// seen rows j-1 .. j-kLag+1 final, its late candidates i < kLag,
// descending, each taking a tie.  Warp 0 then combines the warps and
// writes V, K (and, at age 0, the next sweep's restart-column entry).
template <bool kPrice>
__device__ __forceinline__ void run_item(const Params& p, const Smem& sm,
                                         int k, int j, int s, int tile) {
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int T = p.t_max + 1;
  const int J1 = p.j_max + 1;
  const int t0 = tile * kTile;
  const int t = t0 + lane;
  const float* vs = p.V + (size_t)s * J1 * T;
  const float ro = kPrice ? __ldg(p.Ro + s) : p.restart_overhead;
  const float Rj =
      ro + __ldcg(p.rcol + ((size_t)(k & 1) * p.S + s) * J1 + j);
  const bool valid = t <= p.t_max;
  const float Ft = valid ? sm.F[lane] : 1.0f;
  const bool live = valid && !((1.0f - Ft) < 1e-6f);
  const float Ht = live ? sm.H[lane] : 0.0f;
  const float St = fmaxf(1.0f - Ft, kEps);
  const float tdt = (float)t * p.dt;
  const float Pt = (kPrice && live) ? sm.P[lane] : 0.0f;
  float m = INFINITY;
  int kk = 0;
  if (live) {
    for (int i0 = g + kLag; i0 <= j; i0 += kUnroll * kGroups) {
      float vrow[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kGroups;
        if (i <= j) vrow[u] = earlier_value(p, vs, i, j, t);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kGroups;
        if (i <= j) {
          const float cost = candidate_cost<kPrice>(p, sm, i, j, t, t0, Ft,
                                                    Ht, St, tdt, Pt, Rj,
                                                    vrow[u]);
          if (cost < m) {
            m = cost;
            kk = i;
          }
        }
      }
    }
  }
  // Late candidates read rows j-1 .. j-kLag+1: row j-1's tiles out to age
  // t_end + 1 + delta cover them (row j-1 waited in turn for row j-2 one
  // step further, and so on).
  if (threadIdx.x == 0 && j >= 2) {
    wait_row(p, s, j - 1, k, tile, 1 + p.delta);
    __threadfence();
  }
  __syncthreads();
  // Late candidates in descending order: each is below every candidate
  // scanned before it, so on an equal finite cost it is the first match;
  // an infinite or NaN cost never wins.
#pragma unroll
  for (int i = g + kLag - kGroups; i > 0; i -= kGroups) {
    if (live && i <= j) {
      const float cost =
          candidate_cost<kPrice>(p, sm, i, j, t, t0, Ft, Ht, St, tdt, Pt, Rj,
                                 earlier_value(p, vs, i, j, t));
      if (cost < m || (cost == m && m < INFINITY)) {
        m = cost;
        kk = i;
      }
    }
  }
  sm.m[g * kTile + lane] = m;
  sm.k[g * kTile + lane] = kk;
  __syncthreads();
  if (g == 0 && valid) {
    // Warp h's (min, argmin) is the first match among its candidates;
    // across warps the smaller cost wins and an equal finite cost goes to
    // the smaller i.  A lane with no cost below inf keeps k = 0.
    float vj = Rj;
    int kj = j;
    if (live) {
      vj = sm.m[lane];
      kj = sm.k[lane];
#pragma unroll
      for (int h = 1; h < kGroups; ++h) {
        const float mh = sm.m[h * kTile + lane];
        const int kh = sm.k[h * kTile + lane];
        if (mh < vj || (mh == vj && kh != 0 && kh < kj)) {
          vj = mh;
          kj = kh;
        }
      }
    }
    const size_t out = ((size_t)s * J1 + j) * T + t;
    p.V[out] = vj;
    p.K[out] = kj;
    if (t == 0)
      p.rcol[((size_t)((k + 1) & 1) * p.S + s) * J1 + j] = vj;
  }
}

// ---- one persistent launch per solve ---------------------------------------

template <bool kPrice>
__global__ void __launch_bounds__(kThreads)
dp_wavefront_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ int item;
  const int window = kTile + p.j_max + p.delta + 1;
  const Smem sm = carve(smem, window);
  const int per_row = p.S * p.tiles;
  const long total = (long)p.n_sweeps * p.j_max * per_row;
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(p.ticket, 1);
    __syncthreads();
    const int n = item;
    if (n >= total) break;
    const int r = n / per_row;
    const int within = n - r * per_row;
    const int k = r / p.j_max;
    const int j = r - k * p.j_max + 1;
    const int tile = p.tiles - 1 - within / p.S;
    const int s = within % p.S;
    stage<kPrice>(p, sm, s, j, tile * kTile);   // inputs only: no wait needed
    if (threadIdx.x == 0) {
      // Early candidates read rows j-kLag and below.  Rows 1..kLag of a
      // sweep k > 0 first wait for the whole previous sweep (its row
      // j_max), which the restart column and the rows they overwrite need.
      if (j - kLag >= 1) {
        wait_row(p, s, j - kLag, k, tile, kLag + p.delta);
      } else if (k > 0) {
        const int* f = p.flags + (size_t)s * (p.j_max + 1) * p.tiles +
                       (size_t)p.j_max * p.tiles;
        for (int x = 0; x < p.tiles; ++x) wait_flag(f + x, k);
      }
      __threadfence();
    }
    __syncthreads();
    run_item<kPrice>(p, sm, k, j, s, tile);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      st_release(p.flags + ((size_t)s * (p.j_max + 1) + j) * p.tiles + tile,
                 k + 1);
    }
  }
}

// Dynamic shared memory beyond the default 48 KB needs an opt-in (j_max
// above ~4000).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" const char* dp_recurrence_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of the workspace dp_recurrence_launch needs: the two restart-column
// snapshots, the ticket and the per-tile flags.
extern "C" long long dp_recurrence_workspace_bytes(int S, int j_max,
                                                   int t_max) {
  const long long tiles = (t_max + kTile) / kTile;
  const long long J1 = j_max + 1;
  return 4 * (2 * S * J1 + 1 + S * J1 * tiles);
}

// Fc, Hc: (S, t_max+1) f32; col0: (S, j_max+1) f32 restart-column seed;
// Pc: (S, tx) f32 and Ro: (S,) f32 in dollar mode, both null otherwise;
// V: (S, j_max+1, t_max+1) f32 and K: same shape i32 (outputs); work:
// dp_recurrence_workspace_bytes of scratch.  All pointers are device
// pointers.
extern "C" int dp_recurrence_launch(const float* Fc, const float* Hc,
                                    const float* col0, const float* Pc,
                                    const float* Ro, float* V, int* K,
                                    void* work, int S, int j_max, int t_max,
                                    int delta_steps, int n_sweeps, int tx,
                                    float dt, float restart_overhead,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int T = t_max + 1;
  const int J1 = j_max + 1;
  Params p;
  p.Fc = Fc;
  p.Hc = Hc;
  p.Pc = Pc;
  p.Ro = Ro;
  p.V = V;
  p.K = K;
  p.rcol = static_cast<float*>(work);
  p.ticket = reinterpret_cast<int*>(p.rcol + 2 * (size_t)S * J1);
  p.flags = p.ticket + 1;
  p.S = S;
  p.j_max = j_max;
  p.t_max = t_max;
  p.delta = delta_steps;
  p.n_sweeps = n_sweeps;
  p.tx = tx;
  p.tiles = (T + kTile - 1) / kTile;
  p.dt = dt;
  p.restart_overhead = restart_overhead;
  // Row 0 is the zero row every later row reads; the others are written.
  cudaError_t err = cudaMemset2DAsync(V, (size_t)J1 * T * sizeof(float), 0,
                                      (size_t)T * sizeof(float), S, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemset2DAsync(K, (size_t)J1 * T * sizeof(int), 0,
                          (size_t)T * sizeof(int), S, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(p.ticket, 0,
                        (1 + (size_t)S * J1 * p.tiles) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(p.rcol, col0, (size_t)S * J1 * sizeof(float),
                        cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  const bool price = Pc != nullptr;
  const size_t smem =
      (3 * (size_t)(kTile + j_max + delta_steps + 1) + 2 * kGroups * kTile) *
      sizeof(float);
  auto kernel = price ? dp_wavefront_kernel<true> : dp_wavefront_kernel<false>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = (long long)n_sweeps * j_max * S * p.tiles;
  long long blocks = (long long)sms * per_sm;   // all resident at once
  if (items < blocks) blocks = items > 0 ? items : 1;
  kernel<<<(int)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}
