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
// ~20 f32 operations each, while its tables are only 27.8 MB.  Rows are
// serial (row j reads rows 0..j-1 of the same sweep at shifted ages), so
// the design is one launch per (sweep, row) on grid (ceil(T/128), S), one
// thread per (s, t) lane holding a running min and argmin in registers;
// the launch boundary is the device-wide ordering between rows.  The value
// table (1.7 MB per scenario) does not fit a block's shared memory but sits
// in the 50 MB L2, so candidate reads of earlier rows go through the cache.
// One row gives only S * T = 11.5k threads, far fewer than the card holds,
// so the kernel is latency-bound and far from its operation bound; a
// persistent cooperative kernel or CUDA graphs are the next step.
//
// Rounding: built with -fmad=false (kernels/_build.py) and IEEE division,
// so each operation rounds as in dp_recurrence_plain; with FMA contraction
// the J = 300 tables flipped 0.11 % of their near-tied argmins.
//
// Host side: dp_recurrence_launch runs the whole solve on the caller's
// stream (zero the tables, snapshot the restart column at each sweep start,
// one launch per row) and returns the first cudaError_t it meets.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1e-9f;

template <bool kPrice>
__global__ void dp_row_kernel(const float* __restrict__ Fc,
                              const float* __restrict__ Hc,
                              const float* __restrict__ Pc,
                              const float* __restrict__ Ro,
                              const float* __restrict__ rcol,
                              float* V, int* K, int j, int j_max, int t_max,
                              int delta_steps, int tx, float dt,
                              float restart_overhead) {
  const int s = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > t_max) return;
  const int T = t_max + 1;
  const int J1 = j_max + 1;
  const float* fc = Fc + (size_t)s * T;
  const float* hc = Hc + (size_t)s * T;
  const float* vs = V + (size_t)s * J1 * T;
  const float ro = kPrice ? Ro[s] : restart_overhead;
  const float Rj = ro + rcol[(size_t)s * J1 + j];
  const float Ft = fc[t];
  float vj = Rj;
  int kj = j;
  if (!((1.0f - Ft) < 1e-6f)) {
    const float Ht = hc[t];
    const float St = fmaxf(1.0f - Ft, kEps);
    const float tdt = (float)t * dt;
    const float* pc = kPrice ? Pc + (size_t)s * tx : nullptr;
    const float Pt = kPrice ? pc[t] : 0.0f;
    float m = INFINITY;
    int k = 0;
    for (int i = 1; i <= j; ++i) {
      const int w = (i == j) ? i : i + delta_steps;
      const int e = min(t + w, t_max);
      const float dFe = fc[e] - Ft;
      const float p = fminf(fmaxf(dFe / St, 0.0f), 1.0f);
      const float dF = fmaxf(dFe, kEps);
      const float wdt = (float)w * dt;
      const float el = fminf(fmaxf((hc[e] - Ht) / dF - tdt, 0.0f), wdt);
      const float vrow = vs[(size_t)(j - i) * T + e];
      float cost;
      if (kPrice) {
        const float dP = pc[t + w] - Pt;
        const float pb = dP / wdt;
        cost = (1.0f - p) * (dP + vrow) + p * (el * pb + Rj);
      } else {
        cost = (1.0f - p) * (wdt + vrow) + p * (el + Rj);
      }
      if (cost < m) {
        m = cost;
        k = i;
      }
    }
    vj = m;
    kj = k;
  }
  const size_t out = ((size_t)s * J1 + j) * T + t;
  V[out] = vj;
  K[out] = kj;
}

}  // namespace

extern "C" const char* dp_recurrence_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Fc, Hc: (S, t_max+1) f32; col0: (S, j_max+1) f32 restart-column seed;
// Pc: (S, tx) f32 and Ro: (S,) f32 in dollar mode, both null otherwise;
// V: (S, j_max+1, t_max+1) f32 and K: same shape i32 (outputs); rcol:
// (S, j_max+1) f32 scratch.  All pointers are device pointers.
extern "C" int dp_recurrence_launch(const float* Fc, const float* Hc,
                                    const float* col0, const float* Pc,
                                    const float* Ro, float* V, int* K,
                                    float* rcol, int S, int j_max, int t_max,
                                    int delta_steps, int n_sweeps, int tx,
                                    float dt, float restart_overhead,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int T = t_max + 1;
  const int J1 = j_max + 1;
  const size_t cells = (size_t)S * J1 * T;
  cudaError_t err = cudaMemsetAsync(V, 0, cells * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(K, 0, cells * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kThreads - 1) / kThreads, S);
  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    // restart-column snapshot: the seed, then the previous sweep's V[:, :, 0]
    if (sweep == 0) {
      err = cudaMemcpyAsync(rcol, col0, (size_t)S * J1 * sizeof(float),
                            cudaMemcpyDeviceToDevice, stream);
    } else {
      err = cudaMemcpy2DAsync(rcol, sizeof(float), V,
                              (size_t)T * sizeof(float), sizeof(float),
                              (size_t)S * J1, cudaMemcpyDeviceToDevice,
                              stream);
    }
    if (err != cudaSuccess) return err;
    for (int j = 1; j <= j_max; ++j) {
      if (Pc != nullptr) {
        dp_row_kernel<true><<<grid, kThreads, 0, stream>>>(
            Fc, Hc, Pc, Ro, rcol, V, K, j, j_max, t_max, delta_steps, tx, dt,
            restart_overhead);
      } else {
        dp_row_kernel<false><<<grid, kThreads, 0, stream>>>(
            Fc, Hc, Pc, Ro, rcol, V, K, j, j_max, t_max, delta_steps, tx, dt,
            restart_overhead);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}
