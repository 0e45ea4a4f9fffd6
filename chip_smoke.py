#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: compiles ``kernels/csrc/dp_recurrence.cu`` with nvcc (first use).
3. Kernel vs plain: ``dp_recurrence`` against ``dp_recurrence_plain`` on the
   same CUDA inputs - 8 default-grid scenarios at J = 60, dt = 1/12 (both
   objectives) and at the main-path size J = 300, dt = 1/60 (makespan).
   Tolerance: V within rtol = atol = 1e-5; K agreement >= 0.999 (makespan)
   or >= 0.995 (dollars), the contract the Pallas kernel is held to.
4. Main path: ``scenarios.sweep_checkpointing`` over the 8-scenario default
   grid x 3 policies x seeds (0, 1), J = 300 at dt = 1/60 (T = 1441 ages),
   4000 trials, max_restarts 64, with the kernel launch counter reset just
   before and read just after.  Checks: the kernel ran, the DP tables
   validate, all 48 rows finite with no unfinished trials, each dp row's
   Monte-Carlo mean within 5 % of the DP's expected makespan, and the
   executor's float64 makespans bit-identical between the card and the CPU
   on one shared pool.
5. Timing: medians of 5 runs after a warm-up (CUDA events for the DP solves,
   host clock plus synchronize for the rest).

Prints the kernel table as one JSON line and, last, the device line.
Needs nothing but this checkout, PyTorch with CUDA, nvcc and numpy.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

J_SMALL, DT_SMALL = 60, 1.0 / 12.0
J_MAIN, DT_MAIN = 300, 1.0 / 60.0
N_TRIALS, SEEDS, MAX_RESTARTS, DELTA, N_SWEEPS = 4000, (0, 1), 64, 1, 3
RO_HOURS = 0.3                 # restart overhead for the dollar check
OPS_PER_CANDIDATE = 20         # f32 operations per (candidate, lane), a
                               # division counted as one
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_LANES_PER_SM = 128        # FP32 units per Hopper SM, 2 ops per FMA


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=5):
    """Median device time of ``fn`` (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(torch, fn, reps=5):
    """Median wall time of ``fn`` ending in a synchronize, after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dp_inputs(torch, grids, dists, job_steps, grid_dt, price=None):
    """Keyword arguments of one ``dp_recurrence`` call, as
    ``solve_batch`` builds them."""
    dev = torch.device("cuda")
    fh = [grids.cdf_grids(d, grid_dt, dev) for d in dists]
    t_max = fh[0][2]
    Fc = torch.stack([g[0] for g in fh])
    Hc = torch.stack([g[1] for g in fh])
    kw = dict(Fc=Fc, Hc=Hc, grid_dt=grid_dt, restart_overhead=0.0,
              j_max=job_steps, t_max=t_max, delta_steps=DELTA,
              n_sweeps=N_SWEEPS)
    if price is None:
        kw["col0"] = grids.seed_column(Fc, job_steps, grid_dt)
        return kw
    prices, pdt = price
    cum = np.concatenate([np.zeros((len(prices), 1)),
                          np.cumsum(prices * pdt, axis=1)], axis=1)
    Pc, P0 = grids.price_cum_grids(prices, cum, pdt, grid_dt, t_max,
                                   job_steps + DELTA)
    kw["Pc"] = torch.as_tensor(Pc, device=dev)
    kw["Ro"] = torch.as_tensor((RO_HOURS * P0).astype(np.float32),
                               device=dev)
    kw["col0"] = grids.seed_column(Fc, job_steps, grid_dt, kw["Pc"])
    return kw


def compare(torch, dp_recurrence, dp_recurrence_plain, kw, k_min, label):
    Vk, Kk = dp_recurrence(**kw)
    Vp, Kp = dp_recurrence_plain(**kw)
    torch.cuda.synchronize()
    max_dv = float((Vk - Vp).abs().max())
    k_agree = float((Kk == Kp).double().mean())
    close = bool(torch.allclose(Vk, Vp, rtol=1e-5, atol=1e-5))
    print(f"[kernel] {label}: max|dV| = {max_dv:.3e}, K agreement = "
          f"{k_agree:.6f} (need V allclose 1e-5 and K >= {k_min})")
    check(close, f"{label}: V differs beyond rtol = atol = 1e-5")
    check(k_agree >= k_min, f"{label}: K agreement {k_agree} < {k_min}")
    return max_dv, k_agree


def fp32_peak_ops(torch):
    """FP32 operations per second of the card: SMs x 128 lanes x 2 (FMA) x
    the SM clock's maximum."""
    props = torch.cuda.get_device_properties(0)
    clock_khz = getattr(props, "clock_rate", 0)
    if clock_khz:
        clock_hz = clock_khz * 1e3
    else:
        clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return props.multi_processor_count * FP32_LANES_PER_SM * 2 * clock_hz, \
        clock_hz


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.core import engine, scenarios
    from repro_torch.core.policies import checkpointing
    from repro_torch.core.policies.solver_backends import grids
    from repro_torch.kernels import _build
    from repro_torch.kernels.dp_recurrence import (dp_recurrence,
                                                   dp_recurrence_plain)

    # -- 1. device ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(f"[device] torch: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    path, log = _build.build("dp_recurrence")
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        print(f"[build] {line}")

    # -- 3. kernel against its plain version ------------------------------
    grid = scenarios.default_grid()
    dists = [sc.dist() for sc in grid]
    rng = np.random.default_rng(0)
    price = (rng.uniform(0.05, 0.6, size=(len(dists), 96)), 0.25)
    compare(torch, dp_recurrence, dp_recurrence_plain,
            dp_inputs(torch, grids, dists, J_SMALL, DT_SMALL), 0.999,
            f"makespan J={J_SMALL}")
    compare(torch, dp_recurrence, dp_recurrence_plain,
            dp_inputs(torch, grids, dists, J_SMALL, DT_SMALL, price), 0.995,
            f"dollars J={J_SMALL}")
    main_kw = dp_inputs(torch, grids, dists, J_MAIN, DT_MAIN)
    max_dv, k_agree = compare(torch, dp_recurrence, dp_recurrence_plain,
                              main_kw, 0.999, f"makespan J={J_MAIN}")

    # -- 4. the main path ---------------------------------------------------
    sweep_kw = dict(seeds=SEEDS, job_steps=J_MAIN, n_trials=N_TRIALS,
                    grid_dt=DT_MAIN, delta_steps=DELTA,
                    max_restarts=MAX_RESTARTS, n_sweeps=N_SWEEPS,
                    device="cuda")
    dp_recurrence.launches = 0
    t0 = time.perf_counter()
    rows = scenarios.sweep_checkpointing(grid, **sweep_kw)
    torch.cuda.synchronize()
    first_sweep_s = time.perf_counter() - t0
    launches = dp_recurrence.launches
    print(f"[main] sweep: {len(rows)} rows in {first_sweep_s:.2f} s; "
          f"dp_recurrence launches {launches}")
    check(launches > 0, "the main path did not launch dp_recurrence")
    check(len(rows) == len(grid) * 3 * len(SEEDS), f"{len(rows)} rows")
    tables = checkpointing.solve_batch(dists, J_MAIN, grid_dt=DT_MAIN,
                                       delta_steps=DELTA, n_sweeps=N_SWEEPS,
                                       device="cuda").validate()
    check(tables.backend == "cuda", f"solve_batch used {tables.backend}")
    for r in rows:
        check(np.isfinite(r["makespan_mean"]) and r["unfinished_frac"] == 0.0,
              f"row {r['scenario']}/{r['policy']}/{r['seed']}: {r}")
    worst = 0.0
    for r in rows:
        if r["policy"] == "dp":
            rel = abs(r["makespan_mean"] - r["expected_makespan_dp"]) \
                / r["expected_makespan_dp"]
            worst = max(worst, rel)
            check(rel < 0.05, f"dp row {r['scenario']}/{r['seed']}: Monte-"
                              f"Carlo mean {r['makespan_mean']} vs DP "
                              f"{r['expected_makespan_dp']}")
    print(f"[main] worst |MC mean - DP expectation| / DP = {worst:.4%}")
    for r in rows[:6]:
        print(f"[main] {r['scenario']} {r['policy']} seed {r['seed']}: "
              f"mean {r['makespan_mean']:.4f} h, p95 {r['makespan_p95']:.4f}"
              f" h, DP {r['expected_makespan_dp']:.4f} h")
    first, pool = engine.draw_lifetime_pool_batch(
        dists[:1], N_TRIALS, max_restarts=MAX_RESTARTS, seed=[0],
        device="cuda")
    ex_kw = dict(first=first[0], pool=pool[0], grid_dt=DT_MAIN,
                 delta_steps=DELTA, max_restarts=MAX_RESTARTS)
    mk_gpu = engine.simulate_makespan_batch(tables.K[0], J_MAIN, **ex_kw,
                                            device="cuda")
    mk_cpu = engine.simulate_makespan_batch(
        tables.K[0].cpu(), J_MAIN, first=first[0].cpu(), pool=pool[0].cpu(),
        grid_dt=DT_MAIN, delta_steps=DELTA, max_restarts=MAX_RESTARTS,
        device="cpu")
    check(np.array_equal(mk_gpu, mk_cpu, equal_nan=True),
          "executor makespans differ between cuda and cpu on one pool")
    print(f"[main] executor float64 makespans bit-identical cuda vs cpu "
          f"({mk_gpu.size} trials)")

    # -- 5. timing ----------------------------------------------------------
    ms_kernel = cuda_ms(torch, lambda: dp_recurrence(**main_kw))
    ms_plain = cuda_ms(torch, lambda: dp_recurrence_plain(**main_kw))
    cells = [d for d in dists for _ in SEEDS]
    cell_seeds = [s for _ in dists for s in SEEDS]
    ms_pool = host_ms(torch, lambda: engine.draw_lifetime_pool_batch(
        cells, N_TRIALS, max_restarts=MAX_RESTARTS, seed=cell_seeds,
        device="cuda"))
    first_sr, pool_sr = engine.draw_lifetime_pool_batch(
        cells, N_TRIALS, max_restarts=MAX_RESTARTS, seed=cell_seeds,
        device="cuda")
    table_u, table_ix, pool_ix = scenarios.cell_tables(
        tables, dists, ("dp", "young_daly", "none"), SEEDS, job_steps=J_MAIN,
        grid_dt=DT_MAIN, delta_steps=DELTA, device="cuda")
    first_b = first_sr[torch.as_tensor(pool_ix, device="cuda")]
    ms_exec = host_ms(torch, lambda: engine.simulate_makespan_batch(
        table_u, J_MAIN, first=first_b, pool=pool_sr, grid_dt=DT_MAIN,
        delta_steps=DELTA, max_restarts=MAX_RESTARTS, return_finished=True,
        table_index=table_ix, pool_index=pool_ix, device="cuda"))
    ms_sweep = host_ms(torch, lambda: scenarios.sweep_checkpointing(
        grid, **sweep_kw))

    # bound: live lanes only (dead lanes skip the candidate loop)
    S, T = main_kw["Fc"].shape
    live = int(((1.0 - main_kw["Fc"]) >= 1e-6).sum())
    cand_lanes = N_SWEEPS * live * J_MAIN * (J_MAIN + 1) // 2
    ops = cand_lanes * OPS_PER_CANDIDATE
    nbytes = 4 * (2 * S * T + S * (J_MAIN + 1) + 2 * S * (J_MAIN + 1) * T)
    peak, clock_hz = fp32_peak_ops(torch)
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[timing] card {smi}; FP32 peak {peak / 1e12:.2f} TFLOP/s "
          f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs"
          f" at {clock_hz / 1e9:.3f} GHz)")
    print(f"[timing] candidate-lane evaluations per solve: {cand_lanes}; "
          f"f32 ops {ops:.4g}; table bytes {nbytes}")
    timings = {"dp_solve_kernel_ms": ms_kernel, "dp_solve_plain_ms": ms_plain,
               "pool_draw_ms": ms_pool, "executor_ms": ms_exec,
               "sweep_ms": ms_sweep, "first_sweep_s": first_sweep_s,
               "launches_per_solve": N_SWEEPS * J_MAIN, "card": smi}
    print("[timing] " + json.dumps(timings))
    kernel = {
        "name": "dp_recurrence", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dp_recurrence.cu",
        "replaces": "src/repro/kernels/dp_recurrence.py:131",
        "launches": launches, "max_abs_err": max_dv, "max_abs_dV": max_dv,
        "k_agree": k_agree, "ms": ms_kernel, "plain_ms": ms_plain,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
