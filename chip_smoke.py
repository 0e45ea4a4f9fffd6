#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --bwd-rounding
    python3 chip_smoke.py --vision-attention

With ``--bwd-rounding`` it runs phase 1 and then only the study of the
flash backward's rounding: ``flash_attention_bwd.cu`` built four times,
with ``-DFLASH_BWD_LO`` = 3 (P and dS enter the gradient products as bf16
hi + lo halves, the kernel's setting), 2 (P rounded once), 1 (dS rounded
once) and 0 (both rounded once), one nvcc each, all started together; for
each setting the largest bf16 ulps (where |plain| >= 2^-8 max) and the
elements outside both bounds of phase 16's rule in its bf16 cases, and at
the training shape the call's time (CUDA-graph replays), its two kernels'
device times under torch.profiler and SDPA's backward, as one JSON line
last.  It checks only that every setting builds and runs.  With
``--vision-attention`` it runs phases 1-2, then only phase 24, and prints
its kernel entries as one JSON line last.

Phases of the run without arguments, each of which exits nonzero on
failure:

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: compiles the five kernel sources of ``kernels/csrc/``
   (dp_recurrence, flash_attention, decode_attention, rglru_scan with
   its backward, flash_attention_bwd with its D = 256 instances)
   with nvcc, one process per source, all started together, and prints what ``-Xptxas -v`` says
   (no function of flash_attention_bwd may spill registers) and, where the
   toolkit has ``cuobjdump``, the tensor-core instructions in each
   attention library's SASS (HGMMA for wgmma, HMMA for mma.sync):
   flash_attention and flash_attention_bwd (its bf16 kernels) must hold
   HGMMA and decode_attention HMMA.
3. Kernel vs plain: ``dp_recurrence`` against ``dp_recurrence_plain`` on the
   same CUDA inputs - 8 default-grid scenarios at J = 60, dt = 1/12 (both
   objectives) and at the main-path size J = 300, dt = 1/60 (both
   objectives; the makespan case solved 16 times and the dollar case 4
   times, each solve held to the plain tables on its own, since a race in
   the kernel's wavefront would show in some runs and not in others).
   Tolerance: V within rtol = atol = 1e-5; K agreement >= 0.999 (makespan)
   or >= 0.995 (dollars), the contract the Pallas kernel is held to; each
   case also prints in how many runs V and K are bit-identical.  Exact
   ties: with F = H = 0 at dt = 0.25 and no checkpoint delay every
   candidate of row j costs j * 0.25, so V and K must equal the plain
   version's exactly, with K == 1 on every row j >= 1 (the first-match
   argmin).  Delay: both objectives again at J = 300 with a checkpoint
   delay of 2 steps (two solves each), at the same contract.
4. Main path: ``scenarios.sweep_checkpointing`` over the 8-scenario default
   grid x 3 policies x seeds (0, 1), J = 300 at dt = 1/60 (T = 1441 ages),
   4000 trials, max_restarts 64, with the kernel launch counter reset just
   before and read just after.  Checks: the kernel ran, the DP tables
   validate, all 48 rows finite with no unfinished trials, each dp row's
   Monte-Carlo mean within 5 % of the DP's expected makespan, the
   executor's float64 makespans bit-identical between the card and the CPU
   on one shared pool, and that pool (the first scenario's, 4000 trials,
   seed 0) drawn on the card within rtol POOL_RTOL = 1e-8 of the same pool
   drawn on the CPU (exp rounds differently there; the largest relative
   difference is printed).
5. Timing: medians of 5 runs after a warm-up (CUDA events for the DP solves,
   host clock plus synchronize for the rest), the kernel launches a solve
   makes, and one sweep under torch.profiler for its wall time, the
   device's busy share and the device events that take the time.
6. Serving kernels vs plain: flash_attention, decode_attention and
   linear_recurrence against their plain versions on the same CUDA inputs,
   at the serving path's shapes in bf16 and at further cases (float32, a
   ragged length, llama3.2-1b's full-causal GQA shape and its bf16 decode
   at D = 64, yi-34b's full-causal bf16 shape at D = 128 (H = 56, KV = 8,
   S = 2048), musicgen-medium's (8 x 2048, MHA H = KV = 24, D = 64) and
   qwen2-vl-2b's (H = 12, KV = 2, D = 128) prefill and decode shapes (a
   cache of 2080 slots, mixed lengths), Sq < Sk, mixed decode lengths,
   the recurrence with and
   without h0, at S = 1, at S not a
   multiple of its time chunk (2047, 37), at B = 1, at W not a multiple of
   its channel slice (1000), and at a W whose rows TMA cannot address
   (1001)); each recurrence case checks which kernel its launch chose (the
   chunked one for S >= 16 with rows of a multiple of 16 bytes, the loop
   kernel at S = 1 and W = 1001) and prints whether h and h_last are
   bit-identical to the plain version's.  The recurrence's backward
   (``rglru_scan_bwd``) against ``linear_recurrence_bwd_plain`` on the same
   CUDA inputs and the forward kernel's float32 states (themselves held
   bit for bit to the plain loop's): recurrentgemma-2b's training
   microbatch (2 x 2048 x 2560) in bf16 and float32, with and without h0
   and a gradient of h_last, and S = 1, 15, 37, 65 and 2047 (bf16), 33
   (float32: a chunk and one step), W = 1001, B = 1 and a g one element
   off a 16-byte boundary, each bit-identical to the plain version and
   each checking which kernel its launch chose (the chunked one, a
   reverse TMA ring, at any S with rows TMA can address; the loop
   kernel at W = 1001 and the misaligned g); a call on an input
   that requires
   grad launches the forward once and records ``LinearRecurrence``'s
   grad_fn, its backward launches ``rglru_scan_bwd`` once, and its
   gradients are held to torch.autograd through the plain forward on the
   card (float32 and bf16); under ``torch.no_grad()`` nothing records.
   Tolerances: float32 within rtol = atol = 1e-5 (summation order only);
   bf16 within 2 bf16 ulps of the plain result (the plain versions compute
   in float32 and round once; the attention kernels sum bf16 products in
   float on the tensor cores and pass P through them as bf16 hi + lo
   halves, ~2^-17 relative, so they differ only where sums in another
   order fall on either side of a rounding boundary); h_last equal to
   h[:, -1].
7. Serving path: recurrentgemma-2b at full width and depth, weights from a
   seeded torch.Generator on the card, through ``launch/serve.py``: 4
   batches, each admitted by ``PreemptionSource.reuse_decision``, of 8
   prompts x 2048 tokens, 32 greedy tokens each, with the three kernels'
   launch counters reset just before and read just after (8, 248 and 576
   a batch; of the recurrence's, the 18 prefill launches a batch must take
   the chunked kernel and the 558 decode launches the loop kernel).
   Checks: every logit of a prefill and its 31 decode steps is
   finite; decode step 1's logits match a full forward over prompt + 1
   tokens (S = 2049) within LOGIT_TOL_BF16 in bf16, and within
   LOGIT_TOL_F32 with the same weights in float32 (B = 2), the greedy
   tokens agreeing wherever the top-2 margin exceeds the tolerance; at 3
   layers (one period), full width, float32, B = 2, prompt 64, 8 tokens,
   the card's logits match the port on the CPU within LOGIT_TOL_F32, and
   the greedy tokens agree wherever the top-2 margin exceeds it.  Then one
   more batch (2 x 256 tokens, 4 greedy tokens) on a pod that has run
   ROTATE_AGE = 23.5 h: the reuse policy denies it, so the pod rotates
   (``PreemptionSource.replace_pod`` on the card; its age restarts at 0),
   with that batch's launches counted.
8. Serving timing: prefill ms (time to first token), decode ms per step and
   tokens/s, peak device memory, and each kernel's, its plain version's and
   a PyTorch call's time at the serving shapes (CUDA-graph replays, medians
   of 5 after a warm-up) beside its bound, and the decode call's device
   events under torch.profiler (one launch a call); a torch.profiler
   window over one prefill and over one batch's decode steps for the
   device's busy share and the kernels that take the time.
9. Batch service: the paper's Fig. 8 sweep, ``scenarios.sweep_service``
   (batched) over the 8-scenario default grid x 4 policies (model,
   memoryless, each with and without "+deflate") x 10 seeds = 320 lanes,
   bags of 100 jobs of ~2 h on 32-VM clusters, on the card, with the
   kernels' launch counters reset before and read after (the path runs no
   hand-written kernel).  Checks: every lane finished with no pool
   exhaustion, truncation or deadlock; the rows equal the lanes rerun on
   the same inputs; card and CPU bit-identical on one pool and table
   (every field); the serial heap loop bit-identical, per job, for model
   and memoryless x 10 seeds in two scenarios; a 6 h deadline rejects
   jobs in some lanes and stays bit-identical card vs CPU; a seeded priced
   run's dollars bit-identical card vs CPU; the reuse-denial lanes of
   tests/test_torch_service.py (bags of 30 jobs of ~6 h on 4-6 VMs, model
   and memoryless, with and without deflation) bit-identical card vs CPU,
   each model lane's makespan differing from its memoryless twin's; every
   row's cost reduction finite and above 1 (printed per policy).
10. Service timing: the sweep's ms (median of 5 after a warm-up, final
   synchronize), the loop's ms, steps, ms per step and events/s, the
   reuse table's and the pools' ms; the scale point (50 memoryless lanes
   on 2,000-job bags, cluster 32, pools of 8,000) timed once after a
   warm-up on a tenth of each bag; one sweep under torch.profiler for
   the device's busy share and top device events.
11. Market path: ``benchmarks/market_bench.py``'s full mode on the card -
   the 8-scenario default grid under ``MarketModel.for_scenarios`` (a
   crunch on us-central1-a over hours 8-16, horizon 48 h, price dt 0.1 h,
   seed 0), regimes calm and crunch, ``solve_market_tables`` in both
   objectives (J = 300, dt = 1/60), then ``sweep_market(tables=...)`` with
   policies fixed / cheapest / migrate x seeds (0, 1) x 400 trials, with
   the DP launch counter reset just before and read just after (4
   launches).  Checks: each of the 4 solves validates and matches the
   plain version on the same grids (the phase 3 contract); all 96 rows
   finite with no unfinished trials; the kernel-path dollars bit-identical
   to ``cost_path="reference"``; card and CPU rows bit-identical on one
   pool and table set; market_bench's two acceptance flags (``cheapest``
   pays less than ``fixed`` on every crunch-scheduled leaf, and on every
   crunch leaf the dollar DP's ``evaluate_policy_dollars`` cost is at most
   the makespan DP's x (1 + 1e-6)).
12. Market timing: medians of 5 after a warm-up, each ending in a
   synchronize, of ``solve_market_tables`` per objective, ``sweep_market``
   with ``tables=``, ``evaluate_policy_dollars`` and
   ``accumulate_price_cost``; one ``sweep_market`` under torch.profiler for
   the device's busy share and top device events.
13. Fit (Fig. 1): ``fitting.fit_samples`` for the four families on the
   card over 1,516 lifetimes (the Fig. 1 trace size) drawn by
   ``constrained_for("n1-highcpu-16").icdf`` from ``default_rng(42)``
   uniforms, each timed after a warm-up.  Checks: Eq. 1 converged with the
   lowest LSE of the four; constrained, exponential and Weibull equal the
   port's CPU fits (same iterations, theta rtol 1e-7, LSE rtol 1e-9);
   Gompertz-Makeham converged at its exponential limit (LSE within rtol
   1e-8 of the exponential fit's), as ``tests/test_torch_fitting.py``
   states.  Prints each family's LSE, KS, iterations and ms.
14. Refinement: ``solve_batch(refine=True)`` at the main path's size (the
   8-scenario default grid, J = 300, dt = 1/60, T = 1441, 3 sweeps), cold
   and warm, in both objectives (dollars on phase 11's crunch regime and
   price grid), with the DP launch counter reset before each solve.
   Checks: the column-0 check verified, V and K bit-identical to the
   plain kernel solve, 2 launches a refined solve (the coarse hint and the
   final sweep); ``sweep_checkpointing(solver_refine=True)`` rows equal
   the plain sweep's; ``solve_market_tables(solver_refine=True)`` equal to
   phase 11's tables in both objectives; with every candidate cap forced
   to 1 the check fails, the plain tables are served and the solve makes
   3 launches.  Times the refined and the plain solve.
15. The closed loop: ``runtime.FleetRuntime`` with the 8 default-grid
   scenarios beside the live model (DP (9, 301, 1441)), J = 300 at
   dt = 1/60, 3 cold and 2 warm sweeps, window 256, refit every 64, 256
   regret trials, an n1-highcpu-2 stream in blocks of 256 under
   ``FaultInjector(default_schedule(1200), seed=0)``, 1,200 observations
   (benchmarks/runtime_bench.py's cadence-64 row at the sweep's
   resolution), recorded, then replayed with ``solver_refine=True`` and on
   the CPU.  Checks: retries {fit: 2, solve: 1}; a change-point swap
   answers the drift (adaptation lag set); every regret finite; one DP
   launch per swap plus the cold solve; the refined run's events and swaps
   equal and each swap's tables bit-identical; the CPU replay's events and
   swaps equal and its live tables at the DP contract (V rtol = atol =
   1e-5, K agreement >= 0.999); one warm sweep from a 3-sweep V equals the
   4-sweep cold solve bit for bit.  Times the cold, warm and refined
   solves, ``run()`` per observation, ``measure_regret``, a refit, and one
   swap under torch.profiler for the device's busy share.
16. Flash backward vs plain: ``flash_attention_bwd`` against
   ``flash_attention_bwd_plain`` on the same CUDA inputs (q, k, v, dout
   drawn on the card; out and lse from the forward kernel) at smollm-135m's
   training shape (B 8, S 2048, H 9, KV 3, D 64, causal) in bf16 and
   float32, window 512, D 128 (H 56, KV 8, S 1024), S 1000 (causal, and
   in bf16 with no mask), B 1, and musicgen-medium's (8 x 2048, H = KV =
   24, D 64) and qwen2-vl-2b's (H 12, KV 2, D 128) training shapes in
   bf16, and at D = 256: recurrentgemma-2b's training microbatch (B 2, S
   2048, H 10, KV 1, window 2048), window 512 and S 1000, each in bf16
   and float32; each case runs twice and must be
   bit-identical; the forward's LSE against the
   plain LSE (float32 within 1e-5; bf16 at D = 256 within 1e-5 of the
   largest |LSE|); the autograd Function against
   torch.autograd through ``flash_attention_plain`` in float32.  bf16 runs
   the tensor-core kernels (five products on wgmma, P and dS as bf16 hi +
   lo halves), float32 the CUDA-core ones.
   Tolerances: float32 dq/dk/dv within 1e-5 x max|plain|; bf16 each
   element within 2 bf16 ulps of the plain value or within 2^-8 x
   max|plain| (the plain version computes in float32 and rounds once, the
   kernel too; near zero the ulp is finer than the sums' rounding), and
   within 2 bf16 ulps wherever |plain| >= 2^-8 x max|plain| (which P or dS
   rounded once to bf16 breaks by tens of ulps).
17. Training path: (a) smollm-135m at full width and depth (30 layers,
   d_model 576, 9 / 3 heads of 64, vocab 49,152, bf16 compute, float32
   master weights, remat) through ``launch.train.train`` on the card:
   global batch 8 x 2048, 30 steps, warmup 10, sim_hours_per_step 0.05,
   preemption_seed 2 (DP checkpoints at 6, 13, 22, 30, a preemption at 16
   with its emergency checkpoint and a restart), with every launch counter
   reset just before and read just after.  Checks: every loss finite, the
   mean of the last 10 below the first 10's, one restart, >= 2 DP
   checkpoints, dp_recurrence launched, flash_attention_bwd 30 a step, the
   flash forward 60 a step (the forward and remat's recompute), no serving
   kernel; the checkpoint bytes printed; ``restarts``, ``checkpoints``,
   ``emergency_checkpoints``, ``wasted_steps`` and ``steps_run`` equal to
   a CPU replay of the schedule with no model.  (b) At 3 layers, full
   width, 40 steps of 8 x 512: a clean and a preempted run end with
   bit-identical parameters.  (c) At 3 layers, full width, float32, B 2,
   S 256: first-step grads within 1e-4 relative (per tensor, to its
   largest element) of the port on the CPU, and 3 steps' losses within
   rtol 1e-5.  (d) Timing: train step ms (median of 5 after a warm-up),
   tokens/s, peak device memory, model FLOPs (6 N tokens + attention) and
   their share of the bf16 tensor peak; the flash forward (with LSE) and
   backward at the training shape (CUDA-graph replays) beside their plain
   versions, bounds (the backward's at 10 D operations a visible pair,
   beside the 20 D its bf16 kernels issue) and SDPA's forward and
   backward, and the float32 kernels' CUDA-core bounds; the manager's DP
   solve, one plan's host read of K, a blocking save and a restore of the
   1.6 GB state (medians of 5); one step under torch.profiler.
18. Sweep modes and Fig. 7: (a) phase 4's sweep in ``mode="serial"``,
   ``"grouped"`` and ``"batched"``, every DP launch recorded, the launch
   counter reset before each mode and read after.  Checks: 8, 1 and 1
   launches; each serial (1, 301, 1441) table (V and K) bit-identical to
   the batched (8, 301, 1441) solve's scenario, the grouped solve equal to
   it; the 48 rows of the three modes equal in every field; the host
   reference loop ``checkpointing.simulate_makespan`` bit-identical to the
   card's executor on the serial mode's pool (scenario 0, seed 0, each
   policy, the first 500 trials).  (b) ``benchmarks/fig7_checkpointing.py``
   through the port's API: ``checkpointing.solve`` of
   ``constrained_for("n1-highcpu-16")`` at J = 720, dt = 1/60 (one launch
   of (1, 721, 1441), held to ``dp_recurrence_plain`` at phase 3's
   contract); the 5 h schedule beside the paper's 15/28/38/59/128 min;
   Fig. 7a (a 4 h job from ages 0, 2, 6, 10, 15 h; DP and Young-Daly at
   MTTF 1 h) and Fig. 7b (1, 2, 4, 6, 8 h jobs from age 0; DP, Young-Daly,
   none) through ``engine.simulate_makespan_engine`` (600 trials, seed
   17).  Checks: every makespan finite; each DP cell's mean within 5 % of
   the table's V at (J, age); each cell bit-identical to
   ``simulate_makespan`` and to the CPU executor on the same pool (printed
   too: in how many cells a pool drawn on the CPU equals the card's), and
   each cell's pool drawn on the card within rtol POOL_RTOL of the CPU's.
   Prints each cell's overhead and Young-Daly's model-predicted overhead
   at MTTF 1 h beside the paper's "> 25 %".  (c) Timing: each mode's wall
   ms (median of 3 after a warm-up, ending in a synchronize), the S = 1
   and S = 8 solves at J = 300 and Fig. 7's solve (CUDA events).
19. Embeddings input and M-RoPE: musicgen-medium (48 layers, d_model 1536,
   MHA 24 x 64, GELU, no positions, untied) and qwen2-vl-2b (28 layers,
   12 / 2 heads of 128, M-RoPE sections (16, 24, 24), tied 151,936 x 1536
   table) at full width and depth, weights from a seeded generator on the
   card.  (a) Serving through ``steps.make_prefill_step`` /
   ``make_decode_step`` (the serve CLI refuses embeds-input archs):
   prefill on seeded bf16 embeddings, 8 x 2048, with three distinct
   M-RoPE streams for qwen2-vl (t = s, h = s // 32, w = s % 32), then 31
   greedy decode steps fed back through the embedding table at default
   positions, every kernel count reset just before and read just after.
   Checks: flash n_layers launches a prefill and decode n_layers a step,
   nothing else; every logit finite; the peak at most 75 GB; decode step
   1 against a full forward over the embeddings plus the token's table
   row, positions extended, within LOGIT_TOL_BF16; at 2 layers, full
   width, float32, B 2, 64 inputs, 8 tokens, the card's logits within
   LOGIT_TOL_F32 of the port on the CPU.  Times prefill, decode per step
   (tokens/s), the decode steps' busy share and one profiled prefill's
   busy share and top device events.  (b) Training through ``steps.make_train_step``
   (bf16 compute, float32 masters, remat) on {embeds, labels, mask[,
   positions]} at 8 x 2048.  Checks: one step launches flash 2 x n_layers
   and the backward n_layers, nothing else; the loss finite; its peak at
   most 75 GB (else its batch must be halved); a ``grad_accum=2`` step
   (positions cut along their batch axis) runs with a finite loss; at 2
   layers, full width, float32, B 2, S 256 the card's loss within rtol
   1e-6 and every gradient element within atol 1e-6 + rtol 1e-4 of the
   CPU's (``tests/test_torch_train.py``'s float32 tolerance).  Times the
   step (median of 5 after a warm-up), tokens/s, peak memory, the model
   FLOPs' share of the bf16 tensor peak (as phase 17) and one profiled
   step's busy share.  (c) The flash forward (with LSE), the flash
   backward and decode attention at each model's shape (CUDA-graph
   replays) beside their plain versions, SDPA and the bound.  (d)
   yi-34b and deepseek-coder-33b at full width cut to 4 layers, serving
   8 x 2048 token prompts with 31 decode steps: launches, finite logits,
   decode step 1 against the full forward.  Prints the phase's seconds.
20. recurrentgemma-2b training: (a) at full width and depth (26 layers:
   18 RG-LRU, 8 local attention at D = 256; 2.66 B parameters), weights
   from a seeded generator on the card, bf16 compute, float32 master
   weights, remat, through ``steps.make_train_step`` on SyntheticLM
   batches of 8 x 2048 in 4 microbatches of 2 x 2048, 12 steps, warmup 4,
   every launch counter reset just before and read just after.  Checks:
   every loss finite; the mean of the last 4 below the first 4's; per
   microbatch the recurrence 36 launches (all chunked), its backward 18
   (all chunked), flash 16 and the flash backward 8, nothing else; the
   peak at most
   75 GB.  (b) At one (R, R, A) period, full width, float32, B 2, S 256:
   first-step gradients within 1e-4 relative (per tensor, to its largest
   element) of the port on the CPU, 3 steps' losses within rtol 1e-5.
   (c) At 3 layers in bf16, 2 x 2048: two runs of a step give
   bit-identical loss and gradients.  (d) Timing: step ms (median of 5
   after a warm-up), tokens/s, the model FLOPs' share of the bf16 tensor
   peak and one profiled step's busy share and top device events;
   ``rglru_scan_bwd`` (the chunked kernel beside the loop kernel on the
   same values with g misaligned, the loop kernel's earlier time, the
   plain version, its bound and the forward with and without its float32
   states) and the flash pair at
   D = 256 (beside the plain versions, SDPA and the bound) at the
   microbatch shape, CUDA-graph replays.  Prints the phase's seconds.
21. The MoE archs: moonshot-v1-16b-a3b (48 layers, d_model 2048, 16 heads
   of 128, 64 experts of d_ff 1408, top 6, vocab 163,840) and
   phi3.5-moe-42b-a6.6b (d_model 4096, 32 / 8 heads of 128, 16 experts of
   d_ff 6400, top 2, vocab 32,064) at full width, bf16, capacity factor
   1.25 (``models/moe.py``: top-k routing from a stable sort, grouped
   capacity slots, dispatch and combine by index).  (a) Serving, as
   phase 19a, 8 x 2048 token prompts and 31 greedy decode steps,
   moonshot at full depth and phi3.5-moe at 24 of its 32 layers (the 32
   layers' bf16 weights overfill the card).  Checks: the launches, every
   logit finite, the peak at most 75 GB; the share of (token, k) pairs
   the prefill dropped at capacity printed, pooled and layer by layer
   beside the mean cosine of two tokens' router inputs in a group (and
   of their embeddings), and what uniform random routing would drop at
   the same capacity; decode step 1 against a full
   forward on a copy of the config with ``capacity_factor = n_experts``
   (capacity Tg * K: nothing drops; with drops the two group the tokens
   differently) at 2 x 256 prompts, within LOGIT_TOL_BF16; at full width,
   float32, 2 layers (moonshot) or 1 (phi3.5), B 2, 64 prompts, 8 tokens,
   the card against the CPU within LOGIT_TOL_F32 with every routing
   (experts, kept slots, capacity) identical.  Times prefill, decode a
   step (tokens/s), busy shares and one profiled prefill's top device
   events, beside the floors: a decode step reads every expert's weights,
   a prefill runs the expert products on every capacity slot.  (b)
   Training at full width, 2 layers, as phase 19b: 8 steps of SyntheticLM
   8 x 2048 (moonshot in 2 microbatches).  Checks: the first step's
   launches (flash 2 x L and the backward L a microbatch), every loss
   finite, the peak at most 75 GB; at 1 layer, float32, B 2, S 256 the
   card's loss (rtol 1e-6) and every gradient, router and experts
   included (atol 1e-6 + rtol 1e-4), against the CPU's with the routing
   identical (a near-tie that flips a route fails the check, and says
   so); at 1 layer in bf16, 2 x 2048, two runs of a step bit-identical.
   Times the step, tokens/s, the peak, the busy share and the model-FLOP
   share of the bf16 peak with N = ``cfg.active_param_count()``.  (c)
   The attention kernels at each model's shape, as phase 19c.  Prints the
   phase's seconds.
22. xlstm-1.3b (48 layers: 42 mLSTM and 6 sLSTM, xLSTM[7:1]; d_model
   2048, 4 heads of 1024, chunk 256, vocab 50,304), bf16, seeded random
   weights, plain PyTorch (``models/xlstm.py``: no kernel of the port on
   the path).  (a) Serving at full width and depth, 8 x 2048 token
   prompts and 31 greedy decode steps, every kernel's count reset just
   before and read just after.  Checks: no kernel launched, every logit
   finite, the tokens, the peak at most 75 GB; prints how far a prefill
   of 2016 tokens and 32 teacher-forced decode steps land from a full
   forward over 2048 (not held: the random-weight model amplifies
   roundings layer by layer).  Times prefill and decode a step (medians
   of 5 after a warm-up; each decode run from the same prefill's
   states), tokens/s, and under torch.profiler (CUDA activity only) one
   prefill's and one request's decode busy share and device events, and
   the six sLSTM scans alone for their share of the prefill's device
   time; prints the floors (the mLSTM's float32 products at the float32
   peak, the bf16 products, the sLSTM's float32 ``w_rec`` read every
   step; a decode step's weights and states).  (b) Training at full
   width on one period (8 layers), 3 steps of SyntheticLM 8 x 2048 at
   the full learning rate.  Checks: no kernel launched, every loss
   finite and the last below the first, the peak.  Times the step
   (median after the first), tokens/s, one profiled step's busy share,
   and the model FLOPs as 6 N tokens over the bf16 peak and the mLSTM's
   float32 products (``train_model_flops``' term with remat's
   recompute) over the float32 peak.  (c) At 2 layers (mlstm, slstm),
   full width, float32, B 2, S 512: the card's logits (rtol 1e-4 of the
   largest), loss (1e-5) and every gradient (relative 1e-4) against the
   CPU's; on the card a prefill of 480 tokens and 32 decode steps against
   the full forward within LOGIT_TOL_F32; in bf16 two runs of a step
   bit-identical.  Prints the phase's seconds by part.
23. The distributed paths (``repro_torch.sharding``,
   ``solver_backends.shard_scenarios``, ``make_train_step`` and ``train``
   with a group).  (a) A 1-rank NCCL group under ``sharding.use``: the
   sweep's solve (8 default-grid scenarios, J = 300, dt = 1/60, both
   objectives) takes the one-process path (``scenario_partition`` gives
   ``(None, None, None)``, ``shard_scenarios`` returns its function
   itself), one ``dp_recurrence`` launch a solve, tables bit-identical to
   the solve without a group.  (b-d) Two gloo ranks on the one card
   (NCCL refuses two ranks on one device), started by
   ``torch.multiprocessing`` with ``spawn``; each loads the kernels the
   parent built and builds nothing.  (b) The same solves and a refined
   makespan solve, sharded: each rank's launches recorded, 3 of shape
   (4, 301, 1441) and the refine path's coarse one, each bit-identical to
   ``dp_recurrence_plain`` on its inputs; each rank's gathered tables
   bit-identical to the parent's one-process solves.  (c) smollm-135m at
   full width, bf16, float32 masters, remat, through ``train(...,
   group=)``: 8 x 2048 rows split 4 + 4, P23_STEPS steps (the flash pair
   and the manager's DP solve on the path); losses and parameters
   bit-identical to the parent's one-process run with ``grad_accum = 2``
   and across the ranks; prints the step ms per rank, the gradient
   all-reduce's ms and the one-process step ms.  (d) The elastic
   pod-loss resume at the same width: the two ranks as (pod 2, data 1)
   train P23_ELASTIC steps and save (rank 0 writes), pod 1 is lost
   (``plan_elastic_remesh(2, [1], pod_shape=(1,), axes=("data",))``), and
   the survivor restores through ``CheckpointManager`` and trains
   P23_ELASTIC more steps at the plan's batch scale (global batch 4);
   its losses and parameters bit-identical to the parent's one-process
   replay from the same checkpoint.  No claim about several cards: the
   machine has one.
24. The vision tower's attention (Qwen2-VL-2B): ``ops.attention`` with
   ``causal=False`` and int32 segment offsets, 16 heads of 80, over the
   packed patches of 8 images of 2,304-5,120 patches (28,788 in all), bf16,
   under autograd with the flash launch counters zeroed just before:
   one forward and one backward launch, the output and gradients
   bit-identical to direct calls of the kernels; the forward (with LSE)
   and the backward held to their plain versions (each segment on its
   own) by phase 16's rule, LSE within 1e-4; the backward twice for
   bit-identity.  Times both kernels (CUDA-graph replays) beside the plain
   versions and SDPA over the images padded to the longest with a key
   mask, against the bound of ``perfbench/harness/yardstick.py``'s
   ``flash_*_segments_bound_s``.

Prints the kernel table as one JSON line and, last, the device line.
Needs nothing but this checkout, PyTorch with CUDA, nvcc and numpy.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

J_SMALL, DT_SMALL = 60, 1.0 / 12.0
J_MAIN, DT_MAIN = 300, 1.0 / 60.0
MAIN_REPEATS = 16              # kernel solves held to the plain J_MAIN one
N_TRIALS, SEEDS, MAX_RESTARTS, DELTA, N_SWEEPS = 4000, (0, 1), 64, 1, 3
DELTA_ALT = 2                  # a second checkpoint delay, phase 3
RO_HOURS = 0.3                 # restart overhead for the dollar check
OPS_PER_CANDIDATE = 20         # f32 operations per (candidate, lane), a
                               # division counted as one
# H100 SXM device memory rate and dense bf16 tensor-core peak, the
# numbers of repro_torch.analytics.H100_SXM (a test holds them equal)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS = 989e12
FP32_LANES_PER_SM = 128        # FP32 units per Hopper SM, 2 ops per FMA
BWD_ISSUED_OPS_PER_PAIR = 20   # x D: the bf16 flash backward's tensor-core
                               # work a visible pair (S and dP in both of its
                               # kernels, dQ, dK, dV with P and dS as hi + lo)
KERNELS = ("dp_recurrence", "flash_attention", "decode_attention",
           "rglru_scan", "flash_attention_bwd")

# the serving cell: recurrentgemma-2b, 4 batches of 8 x 2048-token prompts,
# 32 greedy tokens each
ARCH, BATCHES, BATCH, PROMPT, N_DECODE = "recurrentgemma-2b", 4, 8, 2048, 32
ROTATE_AGE = 23.5              # hours: a pod the reuse policy rotates
# Decode step 1 against a full forward in bf16, logits of spread ~1: the
# decode path rounds the RG-LRU state to bf16 between steps in each of the
# 18 recurrent layers (as repro does), and cuBLAS sums the products of one
# row and of 2049 rows in different orders; with 8 significant bits these
# drift over 26 layers by up to 0.21 (measured on an H100, 8 x 256,000
# logits).  The float32 run of the same check is the strict one.
LOGIT_TOL_BF16 = 0.5
# Float32 (the card against the CPU at 3 layers, and decode against the
# full forward at full depth): sums run in other orders (cuBLAS, the
# kernels' online softmax, the CPU) and move logits of order one by
# ~1e-5.
LOGIT_TOL_F32 = 1e-3


# the service cell: the paper's Fig. 8 setup (benchmarks/service_bench.py,
# fig8_service.py) over the default grid: bags of 100 jobs of ~2 h (jitter
# 0.1) on 32-VM clusters, 10 seeds, 4 policies, 8 scenarios = 320 lanes
SVC_POLICIES = ("model", "memoryless", "model+deflate", "memoryless+deflate")
SVC_SEEDS = tuple(range(10))
SVC_JOBS, SVC_HOURS, SVC_JITTER, SVC_CLUSTER, SVC_POOL = 100, 2.0, 0.1, 32, 4096
SVC_SWEEP = dict(policies=SVC_POLICIES, cluster_sizes=(SVC_CLUSTER,),
                 seeds=SVC_SEEDS, n_jobs=SVC_JOBS, job_hours=SVC_HOURS,
                 jitter=SVC_JITTER, pool_size=SVC_POOL, mode="batched")
SVC_SERIAL_SCENARIOS = (0, 5)  # scenarios replayed by the serial heap loop
SVC_DEADLINE = 6.0             # hours, the admission-control run
SVC_PRICE_SEED, SVC_PRICE_CELLS, SVC_PRICE_DT = 0, 96, 0.25
# reuse denials (tests/test_torch_service.py): bags of 30 jobs of ~6 h,
# pools of 400 lifetimes
DENY_JOBS, DENY_HOURS, DENY_POOL = 30, 6.0, 400
# the scale point (service_bench.py's at its quick size): 50 memoryless
# lanes on 2 bags of 2,000 jobs, pools of 8,000 lifetimes
SCALE_VM, SCALE_LANES, SCALE_JOBS, SCALE_BAGS = "n1-highcpu-32", 50, 2000, 2

# the market cell: benchmarks/market_bench.py's full mode - the default
# grid under MarketModel.for_scenarios (a crunch on us-central1-a over
# hours 8-16, horizon 48 h, price dt 0.1 h, seed 0), regimes calm and
# crunch, policies fixed / cheapest / migrate, seeds (0, 1), J = 300 at
# dt = 1/60, 400 trials
MKT_REGIMES = ("calm", "crunch")
MKT_POLICIES = ("fixed", "cheapest", "migrate")
MKT_TRIALS = 400
MKT_OBJECTIVES = (("makespan", 0.999), ("dollars", 0.995))
# the fit: the Fig. 1 trace size (benchmarks/fig1_fit.py)
FIT_N, FIT_SEED, FIT_VM = 1516, 42, "n1-highcpu-16"
FIT_FAMILIES = ("constrained", "exponential", "weibull", "gompertz_makeham")
# the closed loop: benchmarks/runtime_bench.py's cadence-64 row at the
# sweep's resolution, the 8 default-grid scenarios beside the live model
# (DP (9, 301, 1441)); the solve budget is wide so that the CPU replay of
# the recorded stream never times out a solve the card run kept
RT_OBS = 1200
# the training cell: smollm-135m at full width and depth, global batch 8 x
# 2048 tokens, bf16
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "smollm-135m", 8, 2048
# 30 steps of 0.05 simulated hours under preemption seed 2: the DP plans
# checkpoints at steps 6, 13, 22 and 30 and the pod is preempted at step 16
# (an emergency checkpoint, a restart); five checkpoints of ~1.6 GB
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_SIM_H, TRAIN_PREEMPT_SEED = 30, 10, 0.05, 2
# the replay check (phase 17b): 3 layers at full width, 40 steps of 8 x 512
REPLAY_STEPS, REPLAY_SEQ = 40, 512
# phase 16's cases: label, B, S, H, KV, D, window, causal, dtype
BWD_CASES = (
    ("smollm train", TRAIN_BATCH, TRAIN_SEQ, 9, 3, 64, 0, True, "bf16"),
    ("smollm train float32", TRAIN_BATCH, TRAIN_SEQ, 9, 3, 64, 0, True,
     "f32"),
    ("window 512", 2, TRAIN_SEQ, 9, 3, 64, 512, True, "bf16"),
    ("window 512 float32", 2, TRAIN_SEQ, 9, 3, 64, 512, True, "f32"),
    ("D=128", 2, 1024, 56, 8, 128, 0, True, "bf16"),
    ("D=128 float32", 2, 1024, 56, 8, 128, 0, True, "f32"),
    ("S=1000", 2, 1000, 9, 3, 64, 0, True, "bf16"),
    ("S=1000 float32", 2, 1000, 9, 3, 64, 0, True, "f32"),
    ("B=1", 1, TRAIN_SEQ, 9, 3, 64, 0, True, "bf16"),
    ("S=1000 not causal", 2, 1000, 9, 3, 64, 0, False, "bf16"),
    ("musicgen-medium train", 8, 2048, 24, 24, 64, 0, True, "bf16"),
    ("qwen2-vl-2b train", 8, 2048, 12, 2, 128, 0, True, "bf16"),
    # recurrentgemma-2b's local attention, D = 256 (10 heads on one KV
    # head), at its training microbatch with its window of 2048
    ("recurrentgemma train", 2, 2048, 10, 1, 256, 2048, True, "bf16"),
    ("recurrentgemma train float32", 2, 2048, 10, 1, 256, 2048, True, "f32"),
    ("D=256 window 512", 2, 2048, 10, 1, 256, 512, True, "bf16"),
    ("D=256 window 512 float32", 2, 2048, 10, 1, 256, 512, True, "f32"),
    ("D=256 S=1000", 2, 1000, 10, 1, 256, 2048, True, "bf16"),
    ("D=256 S=1000 float32", 2, 1000, 10, 1, 256, 2048, True, "f32"),
)
# the sweep modes and Fig. 7 (phase 18): the main path's sweep in each
# mode, and benchmarks/fig7_checkpointing.py's setup (n1-highcpu-16, DP
# (1, 721, 1441), 600 trials, seed 17, Young-Daly at MTTF = 1 h)
MODE_LAUNCHES = {"serial": 8, "grouped": 1, "batched": 1}
REF_TRIALS = 500               # trials the host reference loop replays
FIG7_J, FIG7_TRIALS, FIG7_SEED = 720, 600, 17
FIG7_AGES = (0.0, 2.0, 6.0, 10.0, 15.0)   # Fig. 7a: a 4 h job from each age
FIG7_HOURS = (1, 2, 4, 6, 8)              # Fig. 7b: jobs from age 0
FIG7_PAPER_SCHEDULE = (15, 28, 38, 59, 128)
# phase 19: the embeddings-input archs at full width and depth (arch, key
# in the kernel line's launches_by_path), serving 8 x 2048 inputs with 32
# greedy tokens and training on 8 x 2048; the card against the CPU at 2
# layers; a train step's peak may not pass 75 GB (else halve its batch)
P19_ARCHS = (("musicgen-medium", "musicgen"), ("qwen2-vl-2b", "qwen2_vl"))
P19_BATCH, P19_PROMPT, P19_DECODE, P19_CPU_LAYERS = 8, 2048, 32, 2
P19_PEAK_LIMIT = 75e9
# ... and the two 33-34 B dense archs at full width, cut to 4 layers (~68 GB
# of bf16 weights whole), serving only
P19_DEPTH_CUT = (("yi-34b", 4), ("deepseek-coder-33b", 4))
# phase 21: the MoE archs, serving 8 x 2048 token prompts with 32 greedy
# tokens at full width (phi3.5-moe cut to 24 of its 32 layers: the 32
# layers' 83.7 GB of bf16 weights overfill the card) and training at full
# width, 2 layers, 8 steps of 8 x 2048.  Per arch: (arch, key in the
# kernel line's launches_by_path, serving depth (None: full), training
# grad_accum (moonshot's 163,840-wide logits: 2 microbatches), serving
# layers of the card-vs-CPU check (~7 / 6 GB of float32 on the host))
P21_ARCHS = (("moonshot-v1-16b-a3b", "moonshot", None, 2, 2),
             ("phi3.5-moe-42b-a6.6b", "phi3_5_moe", 24, 1, 1))
P21_TRAIN_LAYERS, P21_STEPS = 2, 8
# decode step 1 against a full forward at no drops (capacity_factor =
# n_experts) on 2 x 256 prompts: at 8 x 2048 the buffers would not fit
P21_NODROP_B, P21_NODROP_S = 2, 256
# phase 20: recurrentgemma-2b training at full width and depth (18 RG-LRU
# and 8 local-attention layers), global batch 8 x 2048 in microbatches of
# 2 x 2048 (grad_accum 4: float32 masters, gradients, their accumulators
# and AdamW's moments take ~53 GB, a microbatch's 256,000-wide logits and
# their gradient ~12 GB), 12 steps with a warmup of 4; the card against the
# CPU at one (R, R, A) period
P20_ARCH, P20_BATCH, P20_SEQ, P20_ACCUM = "recurrentgemma-2b", 8, 2048, 4
P20_STEPS, P20_WARMUP, P20_CPU_LAYERS = 12, 4, 3
# phase 22: xlstm-1.3b (42 mLSTM and 6 sLSTM layers, d_model 2048, 4 heads
# of 1024, chunk 256, vocab 50,304) serving 8 x 2048 token prompts with 32
# greedy tokens at full width and depth; training at full width on one
# xLSTM[7:1] period (8 layers), 8 x 2048, 3 steps in grad_accum
# microbatches; the card against the CPU in float32 at 2 layers (mlstm,
# slstm), B 2 x 512
P22_ARCH, P22_BATCH, P22_PROMPT, P22_DECODE = "xlstm-1.3b", 8, 2048, 32
P22_TRAIN_LAYERS, P22_STEPS, P22_ACCUM = 8, 3, 1
P22_CPU_B, P22_CPU_S = 2, 512
# phase 23: two gloo ranks share the one card (NCCL refuses two ranks on one
# device); each solves 4 of the 8 scenarios of the sweep's solve, and each
# trains smollm-135m at full width on 4 of the 8 x 2048 rows: P23_STEPS
# steps through ``train``, P23_TIMED more timed; the elastic resume trains
# P23_ELASTIC steps on both ranks and as many on the survivor
P23_WORLD, P23_STEPS, P23_TIMED, P23_ELASTIC = 2, 3, 2, 2
# the backward's loop kernel (a thread a channel) at the microbatch shape,
# bf16, on aligned inputs, before the chunked kernel took that shape:
# CUDA-graph replays on an H100 80GB HBM3 at 700 W; phase 20d prints it
# beside this run's times of both kernels
LOOP_BWD_EARLIER_MS = 0.1751
# phase 24: the vision tower's attention, Qwen2-VL-2B's 16 heads of 80 over
# 8 images of h x w merged cells (2 x 2 patches each), packed, not causal
P24_CELLS = ((24, 24), (40, 32), (28, 28), (30, 40), (26, 26), (36, 25),
             (25, 25), (34, 34))
P24_HEADS, P24_D = 16, 80
# a pool drawn on the card against one drawn on the CPU (phases 4 and 18):
# the same float64 expressions, but exp rounds differently (each within an
# ulp), and the inverse of Eq. 1 divides an error in F by the density,
# which is ~1e-5-1e-7 in the model's flat middle; tests/
# test_torch_embeds_mrope.py perturbs every exp by an ulp on the CPU and
# holds these pools within POOL_RTOL / 10
POOL_RTOL = 1e-8
RT_CONFIG = dict(job_steps=J_MAIN, grid_dt=DT_MAIN, delta_steps=DELTA,
                 n_sweeps=N_SWEEPS, warm_sweeps=2, window=256,
                 refit_every=64, min_samples=64, regret_trials=256,
                 stream_vm_types=("n1-highcpu-2",), stream_block=256,
                 solve_budget_s=3600.0)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def zero_counts(fns):
    """Set the launch count of each kernel wrapper in ``fns`` to 0."""
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "launches_by_kernel"):
            fn.launches_by_kernel = dict.fromkeys(fn.launches_by_kernel, 0)


def counts(fns):
    """The launch count of each kernel wrapper in ``fns``, by name."""
    return {fn.__name__: fn.launches for fn in fns}


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tensor_core_ops(path):
    """Counts of HGMMA (wgmma) and HMMA (mma.sync) instructions in a built
    library's SASS, or None where the toolkit has no cuobjdump."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return {"HGMMA": sass.count("HGMMA"), "HMMA": sass.count("HMMA")}


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


def graph_ms(torch, calls, reps=5):
    """Median device time per call of ``calls``, captured back to back in
    one CUDA graph and replayed (after an eager warm-up and one replay), so
    the host's launch overhead is not in the number: CUDA events around an
    eager call of a small kernel time its Python wrapper instead."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(calls))
    return statistics.median(times)

def profile_window(torch, fn, top=8, cpu=True):
    """Run ``fn`` once under torch.profiler (CPU and CUDA activity, or
    with ``cpu=False`` CUDA activity only, for windows of hundreds of
    thousands of operators).  Returns the wall ms, the ms in which some
    device activity ran (the union of the device events' intervals; None
    when the profiler saw none) and the ``top`` device events (all with
    ``top=None``) by summed time as (name, ms, count).  Only device-side
    events count: a CPU operator's device time repeats its kernels'."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the profiler's raw events: ``prof.events()`` first builds the tree of
    # every CPU operator, which takes minutes of host time for a window of
    # a few hundred thousand operators; the device events need none of it
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        spans.append((a, b))
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name())[:60]
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    return wall_ms, (busy_us / 1e3 if spans else None), rows[:top]

def dp_inputs(torch, grids, dists, job_steps, grid_dt, price=None,
              delta=DELTA):
    """Keyword arguments of one ``dp_recurrence`` call, as
    ``solve_batch`` builds them."""
    dev = torch.device("cuda")
    fh = [grids.cdf_grids(d, grid_dt, dev) for d in dists]
    t_max = fh[0][2]
    Fc = torch.stack([g[0] for g in fh])
    Hc = torch.stack([g[1] for g in fh])
    kw = dict(Fc=Fc, Hc=Hc, grid_dt=grid_dt, restart_overhead=0.0,
              j_max=job_steps, t_max=t_max, delta_steps=delta,
              n_sweeps=N_SWEEPS)
    if price is None:
        kw["col0"] = grids.seed_column(Fc, job_steps, grid_dt)
        return kw
    prices, pdt = price
    cum = np.concatenate([np.zeros((len(prices), 1)),
                          np.cumsum(prices * pdt, axis=1)], axis=1)
    Pc, P0 = grids.price_cum_grids(prices, cum, pdt, grid_dt, t_max,
                                   job_steps + delta)
    kw["Pc"] = torch.as_tensor(Pc, device=dev)
    kw["Ro"] = torch.as_tensor((RO_HOURS * P0).astype(np.float32),
                               device=dev)
    kw["col0"] = grids.seed_column(Fc, job_steps, grid_dt, kw["Pc"])
    return kw


def compare(torch, dp_recurrence, dp_recurrence_plain, kw, k_min, label,
            repeats=1):
    """Holds ``repeats`` kernel solves on ``kw`` to one plain solve, each
    run on its own: a missing wait in the wavefront would show in some
    runs, by their timing, and not in others.  Returns the worst run's
    max|dV| and K agreement."""
    Vp, Kp = dp_recurrence_plain(**kw)
    worst_dv, worst_k, n_same = 0.0, 1.0, 0
    for _ in range(repeats):
        Vk, Kk = dp_recurrence(**kw)
        torch.cuda.synchronize()
        max_dv = float((Vk - Vp).abs().max())
        k_agree = float((Kk == Kp).double().mean())
        close = bool(torch.allclose(Vk, Vp, rtol=1e-5, atol=1e-5))
        check(close, f"{label}: V differs beyond rtol = atol = 1e-5")
        check(k_agree >= k_min, f"{label}: K agreement {k_agree} < {k_min}")
        worst_dv, worst_k = max(worst_dv, max_dv), min(worst_k, k_agree)
        n_same += bool(torch.equal(Vk, Vp)) and bool(torch.equal(Kk, Kp))
    print(f"[kernel] {label}: {repeats} run(s), worst max|dV| = "
          f"{worst_dv:.3e}, worst K agreement = {worst_k:.6f} (need V "
          f"allclose 1e-5 and K >= {k_min}); V and K bit-identical in "
          f"{n_same} of {repeats}")
    return worst_dv, worst_k


def exact_ties(torch, grids, dp_recurrence, dp_recurrence_plain):
    """Phase 3's tie case: F = H = 0, dt = 0.25, no checkpoint delay."""
    S, j_max, t_max, dt = 3, 60, 199, 0.25
    Fc = torch.zeros((S, t_max + 1), dtype=torch.float32, device="cuda")
    kw = dict(Fc=Fc, Hc=torch.zeros_like(Fc),
              col0=grids.seed_column(Fc, j_max, dt), grid_dt=dt,
              restart_overhead=RO_HOURS, j_max=j_max, t_max=t_max,
              delta_steps=0, n_sweeps=2)
    Vk, Kk = dp_recurrence(**kw)
    Vp, Kp = dp_recurrence_plain(**kw)
    torch.cuda.synchronize()
    same = bool(torch.equal(Vk, Vp)) and bool(torch.equal(Kk, Kp))
    first = bool((Kk[:, 1:] == 1).all())
    print(f"[kernel] exact ties ({S} scenarios, J = {j_max}, T = {t_max + 1}"
          f"): V, K equal to the plain version's {same}; K == 1 on rows "
          f"j >= 1 {first}")
    check(same, "exact ties: the kernel's tables differ from the plain ones")
    check(first, "exact ties: the argmin is not the first candidate")


def pool_rel_err(torch, card, cpu, label):
    """The largest relative difference of a pool (``first``, ``pool``)
    drawn on the card from the same pool drawn on the CPU, held within
    POOL_RTOL; also whether the two are bit-identical."""
    rel, same = 0.0, True
    for a, b in zip(card, cpu):
        d = (a.cpu() - b).abs()
        check(bool((d <= POOL_RTOL * b.abs()).all()),
              f"{label}: the card's pool differs from the CPU's beyond "
              f"rtol {POOL_RTOL}")
        rel = max(rel, float((d / b.abs().clamp_min(1e-300)).max()))
        same = same and bool(torch.equal(a.cpu(), b))
    return rel, same


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


# ---------------------------------------------------------------------------
# the serving slice
# ---------------------------------------------------------------------------

def bf16_ulps(torch, got, want):
    """Largest |got - want| in bf16 ulps of want's magnitude (the ulp taken
    at no less than 2^-8's, so values near zero are not held to tinier
    steps than bf16 has near its typical outputs)."""
    mag = want.float().abs().clamp_min(2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got.float() - want.float()).abs() / ulp).max())


def agree(torch, label, got, want):
    """Hold a kernel's output to its plain version's: float32 within
    rtol = atol = 1e-5, bf16 within 2 ulps.  Returns max |got - want|."""
    err = float((got.float() - want.float()).abs().max())
    if want.dtype == torch.bfloat16:
        ulps = bf16_ulps(torch, got, want)
        print(f"[serve-kernels] {label}: max|d| = {err:.3e}, "
              f"{ulps:.2f} bf16 ulps (need <= 2)")
        check(ulps <= 2.0, f"{label}: {ulps} bf16 ulps from the plain version")
    else:
        print(f"[serve-kernels] {label}: max|d| = {err:.3e} (need "
              f"rtol = atol = 1e-5)")
        check(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5)),
              f"{label}: differs beyond rtol = atol = 1e-5")
    return err


def serving_kernels_vs_plain(torch):
    """Phase 6; returns each kernel's largest error and its main-shape
    inputs."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rglru_scan import (linear_recurrence,
                                                linear_recurrence_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32

    def normal(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    errs = {"flash_attention": 0.0, "decode_attention": 0.0,
            "linear_recurrence": 0.0}
    main = {}
    flash_cases = [
        # label, B, Sq, Sk, H, KV, D, window, dtype
        ("serving prefill", BATCH, PROMPT, PROMPT, 10, 1, 256, 2048, bf16),
        ("ragged S=2049", 2, 2049, 2049, 10, 1, 256, 2048, bf16),
        ("llama3.2-1b full causal", 1, 2048, 2048, 32, 8, 64, 0, bf16),
        ("yi-34b full causal", 1, 2048, 2048, 56, 8, 128, 0, bf16),
        ("musicgen-medium prefill", 8, 2048, 2048, 24, 24, 64, 0, bf16),
        ("qwen2-vl-2b prefill", 8, 2048, 2048, 12, 2, 128, 0, bf16),
        ("float32 window 128", 2, 512, 512, 4, 2, 128, 128, f32),
        ("Sq < Sk float32", 2, 100, 300, 4, 1, 256, 0, f32),
    ]
    for label, B, Sq, Sk, H, KV, D, window, dt in flash_cases:
        q = normal(B, Sq, H, D, dtype=dt)
        k, v = normal(B, Sk, KV, D, dtype=dt), normal(B, Sk, KV, D, dtype=dt)
        got = flash_attention(q, k, v, causal=True, window=window)
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        errs["flash_attention"] = max(errs["flash_attention"], agree(
            torch, f"flash {label} {tuple(q.shape)} {dt}", got, want))
        if label == "serving prefill":
            main["flash_attention"] = (q, k, v, window)
    S = PROMPT
    decode_cases = [
        ("serving decode", BATCH, S, 10, 1, 256, [S] * BATCH, bf16),
        ("mixed lengths", BATCH, S, 10, 1, 256,
         [1, 7, 64, 65, 1000, 2047, 2048, 130], bf16),
        ("float32 GQA", 3, 300, 32, 8, 64, [300, 1, 150], f32),
        ("llama3.2-1b decode", BATCH, S, 32, 8, 64,
         [2048, 1, 513, 2047, 64, 1000, 2048, 7], bf16),
        ("musicgen-medium decode", BATCH, S + 32, 24, 24, 64,
         [2049, 2080, 1, 2050, 2048, 64, 1000, 2079], bf16),
        ("qwen2-vl-2b decode", BATCH, S + 32, 12, 2, 128,
         [2049, 2080, 1, 2050, 2048, 64, 1000, 2079], bf16),
    ]
    for label, B, S_, H, KV, D, lens, dt in decode_cases:
        q = normal(B, H, D, dtype=dt)
        kc, vc = normal(B, S_, KV, D, dtype=dt), normal(B, S_, KV, D, dtype=dt)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = decode_attention(q, kc, vc, lengths)
        want = decode_attention_plain(q, kc, vc, lengths)
        errs["decode_attention"] = max(errs["decode_attention"], agree(
            torch, f"decode {label} {tuple(kc.shape)} {dt}", got, want))
        if label == "serving decode":
            main["decode_attention"] = (q, kc, vc, lengths)
    W = 2560
    rec_cases = [
        # label, B, S, W, with h0, dtype, the kernel the launch must choose
        ("serving prefill", BATCH, S, W, True, bf16, "chunked"),
        ("no h0", BATCH, S, W, False, bf16, "chunked"),
        ("serving decode S=1", BATCH, 1, W, True, bf16, "loop"),
        ("float32", 2, 300, 1000, False, f32, "chunked"),
        ("S=2047", BATCH, S - 1, W, True, bf16, "chunked"),
        ("S=37", 2, 37, W, True, bf16, "chunked"),
        ("B=1", 1, S, W, True, bf16, "chunked"),
        ("W=1000", 2, 300, 1000, True, bf16, "chunked"),
        ("W=1001", 2, 100, 1001, True, bf16, "loop"),
    ]
    for label, B, S_, W_, with_h0, dt, route in rec_cases:
        a = (0.5 + 0.5 * torch.rand((B, S_, W_), generator=gen,
                                    device="cuda")).to(dt)
        b = normal(B, S_, W_, dtype=dt)
        h0 = normal(B, W_, dtype=dt) if with_h0 else None
        before = dict(linear_recurrence.launches_by_kernel)
        h, h_last = linear_recurrence(a, b, h0)
        ran = [k for k, n in linear_recurrence.launches_by_kernel.items()
               if n != before[k]]
        check(ran == [route], f"recurrence {label}: launched {ran}, "
              f"expected the {route} kernel")
        want_h, want_last = linear_recurrence_plain(a, b, h0)
        check(bool(torch.equal(h_last, h[:, -1])),
              f"recurrence {label}: h_last != h[:, -1]")
        err = max(agree(torch, f"recurrence {label} {tuple(a.shape)} {dt}",
                        h, want_h),
                  agree(torch, f"recurrence {label} h_last", h_last,
                        want_last))
        print(f"[serve-kernels] recurrence {label}: {route} kernel; "
              f"bit-identical h {bool(torch.equal(h, want_h))}, h_last "
              f"{bool(torch.equal(h_last, want_last))}")
        errs["linear_recurrence"] = max(errs["linear_recurrence"], err)
        if label == "serving prefill":
            main["linear_recurrence"] = (a, b, h0)
    errs["rglru_scan_bwd"] = rglru_bwd_vs_plain(torch, gen)
    return errs, main


# phase 6's backward cases: label, B, S, W, with h0, with a gradient of h,
# with one of h_last, dtype, the kernel the launch must choose;
# recurrentgemma-2b's training microbatch is 2 x 2048 x 2560 (no h0, no
# gradient of h_last, as the model trains).  The chunked kernel walks S in
# chunks of 64 steps in bf16, 32 in float32: S = 65 and 33 leave a top
# chunk of one step, S = 1 and 15 have only a partial one.
REC_BWD_CASES = (
    ("train", 2, 2048, 2560, False, True, False, "bf16", "chunked"),
    ("train float32", 2, 2048, 2560, False, True, False, "f32", "chunked"),
    ("train h0 g_last", 2, 2048, 2560, True, True, True, "bf16", "chunked"),
    ("train h0 g_last float32", 2, 2048, 2560, True, True, True, "f32",
     "chunked"),
    ("train h0", 2, 2048, 2560, True, True, False, "bf16", "chunked"),
    ("train g_last", 2, 2048, 2560, False, True, True, "bf16", "chunked"),
    ("train g_last only", 2, 2048, 2560, True, False, True, "bf16",
     "chunked"),
    ("S=1", 8, 1, 2560, True, True, True, "bf16", "chunked"),
    ("S=15 h0 g_last", 2, 15, 2560, True, True, True, "bf16", "chunked"),
    ("S=37", 2, 37, 2560, True, True, False, "bf16", "chunked"),
    ("S=65 h0", 2, 65, 2560, True, True, False, "bf16", "chunked"),
    ("S=33 h0 float32", 2, 33, 2560, True, True, False, "f32", "chunked"),
    ("S=2047 h0 g_last", 2, 2047, 2560, True, True, True, "bf16",
     "chunked"),
    ("W=1001", 2, 100, 1001, True, True, True, "bf16", "loop"),
    ("B=1", 1, 2048, 2560, False, True, False, "bf16", "chunked"),
)


def in_new_thread(fn):
    """``fn()``'s result, called on a new thread; its exception, if any,
    raised here."""
    import threading
    out = {}

    def run():
        try:
            out["result"] = fn()
        except BaseException as e:     # re-raised on the calling thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=300)
    check(not t.is_alive(), "a call on a new thread did not end in 300 s")
    if "error" in out:
        raise out["error"]
    return out["result"]


def misaligned(torch, x):
    """A contiguous copy of ``x`` that starts one element past a 16-byte
    boundary, so that TMA cannot address its rows."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def rglru_bwd_vs_plain(torch, gen):
    """Phase 6, the recurrence's backward: ``linear_recurrence_bwd``
    against ``linear_recurrence_bwd_plain`` on the same CUDA inputs (the
    forward kernel's float32 states, themselves held to the plain loop's
    bit for bit); the autograd Function's launches and its gradients
    against torch.autograd through the plain forward on the card.  Returns
    the backward's largest error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rs
    bf16, f32 = torch.bfloat16, torch.float32

    def draw(B, S, W, with_h0, with_g_last, dt, with_g=True):
        a = (0.5 + 0.5 * torch.rand((B, S, W), generator=gen,
                                    device="cuda")).to(dt)
        b, g = (torch.randn((B, S, W), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        g = g if with_g else None
        h0 = (torch.randn((B, W), generator=gen, device="cuda").to(dt)
              if with_h0 else None)
        g_last = (torch.randn((B, W), generator=gen, device="cuda").to(dt)
                  if with_g_last else None)
        return a, b, h0, g, g_last

    def held(label, route, a, states, g, g_last, h0):
        """One backward launch on these inputs: it must choose ``route``
        and equal the plain version bit for bit."""
        fn = rs.linear_recurrence_bwd
        before = dict(fn.launches_by_kernel)
        got = fn(a, states, g, g_last, h0)
        ran = [k for k, n in fn.launches_by_kernel.items()
               if n != before[k]]
        check(ran == [route] and sum(fn.launches_by_kernel.values())
              == sum(before.values()) + 1,
              f"recurrence bwd {label}: launched {ran}, expected one launch "
              f"of the {route} kernel")
        want = rs.linear_recurrence_bwd_plain(a, states, g, g_last, h0)
        torch.cuda.synchronize()
        err = 0.0
        for name, x, y in zip(("da", "db", "dh0"), got, want):
            if y is None:
                check(x is None, f"recurrence bwd {label}: {name} not None")
                continue
            err = max(err, agree(
                torch, f"recurrence bwd {label} {tuple(a.shape)} {a.dtype} "
                       f"{name}", x, y))
            check(bool(torch.equal(x, y)), f"recurrence bwd {label}: {name}"
                                           f" is not bit-identical to the "
                                           f"plain version's")
        return err

    worst = 0.0
    for (label, B, S, W, with_h0, with_g, with_g_last, dt,
         route) in REC_BWD_CASES:
        dt = {"bf16": bf16, "f32": f32}[dt]
        a, b, h0, g, g_last = draw(B, S, W, with_h0, with_g_last, dt,
                                   with_g)
        _, _, states = rs._forward(a, b, h0, keep_states=True)
        same_states = bool(torch.equal(states, rs._states_plain(a, b, h0)))
        check(same_states, f"recurrence bwd {label}: the forward's float32 "
                           f"states differ from the plain loop's")
        worst = max(worst, held(label, route, a, states, g, g_last, h0))
        print(f"[serve-kernels] recurrence bwd {label}: {route} kernel; "
              f"float32 states and da, db"
              f"{', dh0' if with_h0 else ''} bit-identical to the plain "
              f"versions")
        if label == "train h0 g_last":
            # the same inputs, g one element off a 16-byte boundary: the
            # choice rule sends the call to the loop kernel
            worst = max(worst, held("misaligned g", "loop", a, states,
                                    misaligned(torch, g), g_last, h0))
            print("[serve-kernels] recurrence bwd misaligned g: loop "
                  "kernel; bit-identical to the plain version")
        del a, b, h0, g, g_last, states
    # a thread that has made no CUDA call yet, as autograd's backward
    # thread is when this backward is its first work: the TMA maps of both
    # kernels are built there too
    a, b, h0, g, g_last = draw(2, 256, 2560, True, True, bf16)
    _, _, states = rs._forward(a, b, h0, keep_states=True)
    want = rs.linear_recurrence_bwd_plain(a, states, g, g_last, h0)
    got = in_new_thread(lambda: (rs._forward(a, b, h0, keep_states=True)[2],
                                 rs.linear_recurrence_bwd(a, states, g,
                                                          g_last, h0)))
    torch.cuda.synchronize()
    check(bool(torch.equal(got[0], states)) and all(
        bool(torch.equal(x, y)) for x, y in zip(got[1], want)),
          "the recurrence on a new thread differs from the plain version")
    print("[serve-kernels] recurrence forward and backward on a thread that "
          "had made no CUDA call: bit-identical to the plain versions")
    del a, b, h0, g, g_last, states, want, got
    # the Function: a call on an input that requires grad launches the
    # forward and records a grad_fn, and its backward launches the backward
    # kernel once; its gradients against torch.autograd through the plain
    # forward on the card
    for dt in (f32, bf16):
        a, b, h0, g, g_last = draw(2, 256, 2560, True, True, dt)
        ins = [x.clone().requires_grad_() for x in (a, b, h0)]
        fwd0, bwd0 = (rs.linear_recurrence.launches,
                      rs.linear_recurrence_bwd.launches)
        h, h_last = ops.linear_recurrence(*ins)
        check(rs.linear_recurrence.launches == fwd0 + 1
              and type(h.grad_fn).__name__ == "LinearRecurrenceBackward",
              f"the recurrence on inputs that require grad launched "
              f"{rs.linear_recurrence.launches - fwd0} forwards and "
              f"recorded {h.grad_fn}")
        got = torch.autograd.grad((h, h_last), ins, (g, g_last))
        check(rs.linear_recurrence_bwd.launches == bwd0 + 1,
              "the Function's backward did not launch rglru_scan_bwd once")
        ref = [x.clone().requires_grad_() for x in (a, b, h0)]
        want = torch.autograd.grad(rs.linear_recurrence_plain(*ref), ref,
                                   (g, g_last))
        same = []
        for name, x, y in zip(("da", "db", "dh0"), got, want):
            agree(torch, f"recurrence Function vs autograd of the plain "
                         f"forward {dt} {name}", x, y)
            same.append(f"{name} {bool(torch.equal(x, y))}")
        print(f"[serve-kernels] recurrence Function {dt}: 1 forward and 1 "
              f"backward launch, grad_fn {type(h.grad_fn).__name__}; "
              f"bit-identical to autograd of the plain forward "
              f"{', '.join(same)}")
        with torch.no_grad():
            check(ops.linear_recurrence(*ins)[0].grad_fn is None,
                  "the recurrence recorded a grad_fn under no_grad")
    return worst


def greedy_run(torch, model, prompts, n_decode, feed=None):
    """Prefill + (n_decode - 1) greedy decode steps through the port's
    steps; returns every step's last-position logits (float32) and the
    tokens.  ``prompts``: (B, S) tokens, or a prefill batch (``embeds``
    and, under M-RoPE, ``positions``); decode feeds tokens back through the
    embedding table at the default positions.  ``feed`` forces the tokens
    fed back (teacher forcing)."""
    from repro_torch.launch import steps
    cfg = model.cfg
    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    B, S = batch["tokens" if "tokens" in batch else "embeds"].shape[:2]
    cache = model.init_cache(B, S + n_decode)
    logits, cache = steps.make_prefill_step(cfg)(model, cache, batch)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out_logits, out_toks = [logits[:, -1].float()], [tok]
    decode = steps.make_decode_step(cfg)
    for i in range(n_decode - 1):
        fed = tok if feed is None else feed[:, i]
        logits, tok, cache = decode(model, cache, {"tokens": fed[:, None]})
        out_logits.append(logits[:, -1].float())
        out_toks.append(tok)
    return torch.stack(out_logits, 1), torch.stack(out_toks, 1)


def decode_vs_full(torch, model, prompts, tol):
    """Decode step 1's logits (after a prefill of ``prompts``, tokens or a
    batch as ``greedy_run`` takes them, and the greedy token) against a
    full forward over the S + 1 inputs (``extended``): the largest
    difference must stay within ``tol``, and the greedy tokens agree
    wherever the top-2 margin exceeds it.  Returns the largest
    difference."""
    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    logits, toks = greedy_run(torch, model, batch, 2)
    full_in = extended(torch, model, batch, toks[:, :1])
    full, _ = model(**full_in, last_only=True)
    full, dec = full[:, 0].float(), logits[:, 1]
    diff = (full - dec).abs()
    top2 = full.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol
    same = bool((full.argmax(-1) == dec.argmax(-1))[decided].all())
    rel_rms = float(diff.square().mean().sqrt() / full.square().mean().sqrt())
    B, S1 = next(iter(full_in.values())).shape[:2]
    print(f"[serve] {model.cfg.name} {model.cfg.compute_dtype}, B = {B}: "
          f"decode step 1 vs full forward (S = {S1}): "
          f"max|d logit| = {float(diff.max()):.4g}, mean "
          f"{float(diff.mean()):.3g}, rms relative to the logits' "
          f"{rel_rms:.3g} (need max <= {tol});"
          f" argmax equal where the top-2 margin > {tol}: {same} "
          f"({int(decided.sum())} of {decided.numel()} rows)")
    check(float(diff.max()) <= tol, f"decode vs full forward: {diff.max()}")
    check(same, "decode and full forward pick different greedy tokens")
    return float(diff.max())


def extended(torch, model, batch, tok):
    """The prefill batch followed by the (B, 1) token ``tok``, as a full
    forward takes it: the token appended to token prompts, or its table row
    (as decode embeds it) appended to embeddings, with the positions
    extended by the next position in every stream (decode's default)."""
    from repro_torch.models import layers as L
    tok = tok.long()
    if "tokens" in batch:
        return {"tokens": torch.cat([batch["tokens"], tok], 1)}
    x = batch["embeds"]
    out = {"embeds": torch.cat(
        [x, L.embed(model.embed, tok, model.cfg).to(x.dtype)], 1)}
    if "positions" in batch:
        p = batch["positions"]
        out["positions"] = torch.cat(
            [p, torch.full_like(p[..., :1], x.shape[1])], -1)
    return out


def card_vs_cpu(torch, model, prompts, n_decode, label):
    """A float32 ``model`` on the card against its copy on the CPU: greedy
    runs of ``prompts`` (tokens or a batch, as ``greedy_run`` takes them),
    the CPU fed the card's tokens.  The logits must agree within
    LOGIT_TOL_F32 and the tokens wherever the top-2 margin exceeds it.
    Returns the largest difference."""
    import copy
    cpu = copy.deepcopy(model).to("cpu")
    cpu_prompts = ({k: v.cpu() for k, v in prompts.items()}
                   if isinstance(prompts, dict) else prompts.cpu())
    lg_gpu, tk_gpu = greedy_run(torch, model, prompts, n_decode)
    lg_cpu, tk_cpu = greedy_run(torch, cpu, cpu_prompts, n_decode,
                                feed=tk_gpu.cpu())
    d_cpu = float((lg_gpu.cpu() - lg_cpu).abs().max())
    top2 = lg_cpu.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > LOGIT_TOL_F32
    same = bool((tk_gpu.cpu() == tk_cpu)[decided].all())
    print(f"[serve] {label} float32, card vs CPU: max|d logit| = "
          f"{d_cpu:.3e} (need <= {LOGIT_TOL_F32}); tokens equal where the "
          f"top-2 margin > {LOGIT_TOL_F32}: {same} "
          f"({int(decided.sum())} of {decided.numel()} decided)")
    check(d_cpu <= LOGIT_TOL_F32, f"{label}: card vs CPU logits {d_cpu}")
    check(same, f"{label}: greedy tokens differ between the card and the "
                f"CPU")
    return d_cpu


def serving_path(torch):
    """Phase 7; returns the model, the launch counts and the checks'
    numbers."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import linear_recurrence
    counters = (flash_attention, decode_attention, linear_recurrence)

    cfg = configs.get(ARCH)
    t0 = time.perf_counter()
    model = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                   device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] {ARCH}: {cfg.n_layers} layers {model.kinds[:3]}..., "
          f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"drawn in {time.perf_counter() - t0:.3f} s")
    check(n_params == cfg.param_count(), "parameter count")

    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = time.perf_counter()
    records = serve.serve(cfg, model, batches=BATCHES, batch_size=BATCH,
                          prompt_len=PROMPT, n_decode=N_DECODE,
                          device="cuda")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = counts(counters)
    rec_kernels = dict(linear_recurrence.launches_by_kernel)
    peak_bytes = torch.cuda.max_memory_allocated()
    n_attn = model.kinds.count("local_attn")
    n_rec = model.kinds.count("rglru")
    want = {"flash_attention": BATCHES * n_attn,
            "decode_attention": BATCHES * n_attn * (N_DECODE - 1),
            "linear_recurrence": BATCHES * n_rec * N_DECODE}
    print(f"[serve] {BATCHES} batches of {BATCH} x {PROMPT} tokens, "
          f"{N_DECODE} greedy tokens each, in {serve_s:.2f} s "
          f"({[round(r['seconds'], 3) for r in records]} s; rotated "
          f"{[r['rotated'] for r in records]}); launches {launches}, "
          f"expected {want}; peak {peak_bytes / 1e9:.2f} GB")
    check(launches == want, f"launch counts {launches} != {want}")
    # prefill (S = 2048) takes the chunked recurrence, decode (S = 1) the loop
    want_rec = {"loop": BATCHES * n_rec * (N_DECODE - 1),
                "chunked": BATCHES * n_rec}
    print(f"[serve] linear_recurrence launches by kernel {rec_kernels}, "
          f"expected {want_rec}")
    check(rec_kernels == want_rec,
          f"recurrence kernels {rec_kernels} != {want_rec}")
    for r in records:
        toks = r["tokens"]
        check(tuple(toks.shape) == (BATCH, N_DECODE), "token shape")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              "tokens out of the vocabulary")

    # one more batch on a pod that has run ROTATE_AGE hours: the reuse
    # policy denies it, so PreemptionSource.replace_pod draws a fresh
    # lifetime on the card before the batch runs
    zero_counts(counters)
    rot = serve.serve(cfg, model, batches=1, batch_size=2, prompt_len=256,
                      n_decode=4, device="cuda", start_hours=ROTATE_AGE)[0]
    rot_launches = counts(counters)
    rot_want = {"flash_attention": n_attn, "decode_attention": 3 * n_attn,
                "linear_recurrence": 4 * n_rec}
    print(f"[serve] a batch on a pod aged {ROTATE_AGE} h: rotated "
          f"{rot['rotated']}, pod age after it {rot['pod_age']:.4f} h; "
          f"launches {rot_launches}, expected {rot_want}")
    check(rot["rotated"], "the reuse policy kept a pod near its deadline")
    check(abs(rot["pod_age"] - serve.EST_JOB_HOURS) < 1e-9,
          "the rotated pod's age did not restart at 0")
    check(rot_launches == rot_want, f"rotation batch launches {rot_launches}")

    # every logit of one served batch, and decode step 1 against a full
    # forward over the prompt and the first generated token, in bf16 and,
    # with the same weights held in float32, in float32 (B = 2)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)), device="cuda")
    logits, _ = greedy_run(torch, model, prompts, N_DECODE)
    check(bool(torch.isfinite(logits).all()), "non-finite serving logits")
    d_full = decode_vs_full(torch, model, prompts, LOGIT_TOL_BF16)
    model32 = T.init(dataclasses.replace(cfg, compute_dtype="float32"),
                     torch.Generator(device="cuda").manual_seed(0), device="cuda")
    d_full32 = decode_vs_full(torch, model32, prompts[:2], LOGIT_TOL_F32)
    del model32

    # one period at full width in float32: the card against the CPU
    cfg3 = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern),
                               compute_dtype="float32")
    model3 = T.init(cfg3, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    check(bool(torch.equal(model3.layers[0]["in_x"].bfloat16(),
                           model.layers[0]["in_x"])),
          "the 3-layer model does not share the full model's weights")
    p3 = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)), device="cuda")
    d_cpu = card_vs_cpu(torch, model3, p3, 8, "3 layers")
    del model3
    return model, launches, {"serve_s": serve_s, "peak_bytes": peak_bytes,
                             "decode_vs_full_max_abs": d_full,
                             "decode_vs_full_f32_max_abs": d_full32,
                             "card_vs_cpu_max_abs": d_cpu}


def with_bound(r):
    """Add ``bound_ms`` and ``bound_by`` to a kernel's timing ``r``: the
    larger of its operations at the bf16 tensor peak and its bytes at the
    memory rate."""
    t_ops = r["ops"] / BF16_TENSOR_OPS * 1e3
    t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    r["bound_ms"] = max(t_ops, t_bytes)
    r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return r


def train_model_flops(cfg, B, S):
    """Model FLOPs of one train step on B x S tokens and their context
    part: 6 N tokens, N = ``cfg.active_param_count()`` (every parameter
    of a dense model, top_k of n_experts experts a token in an MoE one),
    plus 12 D H a visible query-key pair in each attention layer (causal,
    or within the window of a local one), plus in each mLSTM layer 3 x the
    forward's chunkwise products as ``analytics._attn_ctx_flops`` counts
    them (intra-chunk pairs and the state terms; float32 in the port)."""
    from repro_torch import analytics
    period = cfg.block_pattern
    attn = 0
    for i in range(cfg.n_layers):
        kind = period[i % len(period)]
        if kind in ("attn", "moe"):
            pairs = S * (S + 1) // 2
        elif kind == "local_attn":
            w = min(cfg.window or S, S)
            pairs = sum(min(j + 1, w) for j in range(S))
        elif kind == "mlstm":
            attn += 3 * B * analytics._attn_ctx_flops(cfg, kind, S, S)
            continue
        else:
            continue
        attn += 12 * cfg.head_dim * pairs * B * cfg.n_heads
    return 6 * cfg.active_param_count() * B * S + attn, attn


def flash_pair_times(torch, q, k, v, out, lse, dout, window=0):
    """The flash forward (with LSE) and backward on these bf16 causal
    inputs: CUDA-graph replays beside the plain versions, SDPA's forward
    and backward, the bound (4 D and 10 D operations a visible pair)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    B, S, H, D = q.shape
    pairs = S * (S + 1) // 2
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    elt = q.element_size()
    fwd = with_bound({
        "ms": graph_ms(torch, [lambda: flash_attention(
            q, k, v, window=window, return_lse=True)] * 3),
        "plain_ms": cuda_ms(torch, lambda: flash_attention_plain(
            q, k, v, window=window, return_lse=True)),
        "library_ms": graph_ms(torch, [
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)] * 3),
        "ops": 4 * D * pairs * B * H,
        "bytes": (2 * q.numel() + 2 * k.numel()) * elt + lse.numel() * 4})
    bwd = with_bound({
        "ms": graph_ms(torch, [lambda: flash_attention_bwd(
            q, k, v, out, lse, dout, window=window)] * 3),
        "plain_ms": cuda_ms(torch, lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, dout, window=window)),
        "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dout_t, retain_graph=True)),
        "ops": 10 * D * pairs * B * H,
        "bytes": (4 * q.numel() + 4 * k.numel()) * elt + lse.numel() * 4})
    return fwd, bwd


def serve_times(torch, model, batch, n_decode):
    """Prefill ms (time to first token; median of 5 after a warm-up) and
    decode ms a step (median of 5 runs of ``n_decode - 1`` greedy steps,
    after one) of a prefill ``batch``; also the two calls timed:
    ``first_token()`` returns (token, cache), ``decode_rest(token,
    cache)`` runs the steps."""
    from repro_torch.launch import steps
    cfg = model.cfg
    B, S = batch["tokens" if "tokens" in batch else "embeds"].shape[:2]
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)

    def first_token():
        cache = model.init_cache(B, S + n_decode)
        logits, cache = prefill(model, cache, batch)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

    def decode_rest(tok, cache):
        for _ in range(n_decode - 1):
            _, tok, cache = decode(model, cache, {"tokens": tok[:, None]})

    prefill_ms = host_ms(torch, first_token)
    step_ms = []
    for _ in range(6):                       # the first is the warm-up
        tok, cache = first_token()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_rest(tok, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / (n_decode - 1))
    decode_ms = statistics.median(step_ms[1:])
    return {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "decode_tokens_per_s": B / (decode_ms / 1e3),
            "decode_steps_ms": step_ms[1:]}, first_token, decode_rest


def serving_timing(torch, model, main_inputs):
    """Phase 8: the serving metrics and each kernel's times and bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rglru_scan import (linear_recurrence,
                                                linear_recurrence_plain)
    prompts = torch.as_tensor(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (BATCH, PROMPT)), device="cuda")
    serving, first_token, decode_rest = serve_times(
        torch, model, {"tokens": prompts}, N_DECODE)

    # Device times from CUDA-graph replays (graph_ms), and for the kernels
    # also the eager time of one call, the Python wrapper included.  The
    # decode calls rotate over 4 copies of the cache (67 MB, more than the
    # 50 MB L2), as the serving path finds each layer's cache cold.
    q, k, v, window = main_inputs["flash_attention"]
    B, S, H, D = q.shape
    KV = k.shape[2]
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    pairs = int(mask.sum())
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    flash = {
        "ms": graph_ms(torch, [lambda: flash_attention(q, k, v,
                                                       window=window)] * 3),
        "eager_ms": cuda_ms(torch, lambda: flash_attention(q, k, v,
                                                           window=window)),
        "plain_ms": graph_ms(torch, [lambda: flash_attention_plain(
            q, k, v, window=window)]),
        "library_ms": graph_ms(torch, [
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)] * 3),
        "ops": 4 * D * pairs * B * H,
        "bytes": 2 * q.numel() * q.element_size() + 2 * k.numel()
        * k.element_size()}
    flash["bound_fp32_ms"] = flash["ops"] / fp32_peak_ops(torch)[0] * 1e3

    dec = [tuple(x.clone() for x in main_inputs["decode_attention"])
           for _ in range(4)]
    qd, kc, vc, lengths = dec[0]
    valid = torch.arange(kc.shape[1], device="cuda")[None, :] < lengths[:, None]
    lib = [(x[0][:, :, None], x[1].transpose(1, 2), x[2].transpose(1, 2),
            valid[:, None, None, :]) for x in dec]
    n_valid = int(lengths.sum())
    decode_k = {
        "ms": graph_ms(torch, [lambda x=x: decode_attention(*x)
                               for x in dec]),
        "eager_ms": cuda_ms(torch, lambda: decode_attention(*dec[0])),
        "plain_ms": graph_ms(torch, [lambda x=x: decode_attention_plain(*x)
                                     for x in dec]),
        "library_ms": graph_ms(torch, [
            lambda x=x: F.scaled_dot_product_attention(
                x[0], x[1], x[2], attn_mask=x[3], enable_gqa=True)
            for x in lib]),
        "ops": 4 * qd.shape[2] * n_valid * qd.shape[1],
        "bytes": 2 * qd.numel() * qd.element_size() + 2 * n_valid * KV
        * qd.shape[2] * kc.element_size() + lengths.numel() * 4}

    def decode_rounds():
        for _ in range(25):
            for x in dec:
                decode_attention(*x)

    decode_rounds()
    _, _, rows = profile_window(torch, decode_rounds)
    decode_k["profile"] = [(name, ms * 1e3 / n, n) for name, ms, n in rows]
    print(f"[timing] decode_attention graph replay {decode_k['ms'] * 1e3:.2f}"
          f" us a call; its device events under torch.profiler (100 eager "
          f"calls): " + "; ".join(f"{name} {us:.2f} us x {n}"
                                  for name, us, n in decode_k["profile"]))

    a, b, h0 = main_inputs["linear_recurrence"]
    a1, b1 = a[:, :1].contiguous(), b[:, :1].contiguous()
    rec = {
        "ms": graph_ms(torch, [lambda: linear_recurrence(a, b, h0)] * 3),
        "eager_ms": cuda_ms(torch, lambda: linear_recurrence(a, b, h0)),
        "plain_ms": graph_ms(torch, [lambda: linear_recurrence_plain(a, b,
                                                                     h0)]),
        "library_ms": None,
        "ops": 2 * a.numel(),
        "bytes": 3 * a.numel() * a.element_size()
        + 2 * h0.numel() * h0.element_size(),
        "decode_step_ms": graph_ms(torch, [
            lambda: linear_recurrence(a1, b1, h0)] * 10),
        "decode_step_eager_ms": cuda_ms(torch, lambda: linear_recurrence(
            a1, b1, h0))}
    for name, r in (("flash_attention", flash),
                    ("decode_attention", decode_k),
                    ("linear_recurrence", rec)):
        with_bound(r)
        print(f"[timing] {name}: {r['ms']:.4f} ms (eager call "
              f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['ops']:.4g} ops, {r['bytes']:.4g} B)")
    print(f"[timing] flash_attention float32 CUDA-core bound "
          f"{flash['bound_fp32_ms']:.3f} ms; recurrence at S = 1 "
          f"{rec['decode_step_ms']:.4f} ms (eager call "
          f"{rec['decode_step_eager_ms']:.4f} ms)")
    # where the time goes: one prefill and one batch's decode steps under
    # the profiler (device busy share = summed kernel time / wall time)
    box = {}

    def prefill_once():
        box["tok"], box["cache"] = first_token()

    def decode_all():
        decode_rest(box["tok"], box["cache"])

    for label, fn in (("prefill", prefill_once), ("decode", decode_all)):
        wall, dev_ms, rows = profile_window(torch, fn)
        busy = None if dev_ms is None else dev_ms / wall
        serving[f"{label}_profiled_wall_ms"] = wall
        serving[f"{label}_device_ms"] = dev_ms
        serving[f"{label}_device_busy_share"] = busy
        print(f"[profile] {label}: wall {wall:.2f} ms, device busy "
              f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms (share "
              f"{busy if busy is None else round(busy, 4)}); device events:")
        for name, ms, calls in rows:
            print(f"[profile] {label}   {ms:9.3f} ms  {calls:5d} x  {name}")
    return serving, {"flash_attention": flash, "decode_attention": decode_k,
                     "linear_recurrence": rec}

# ---------------------------------------------------------------------------
# the batch-service slice
# ---------------------------------------------------------------------------

def service_inputs(dev, **over):
    """The Fig. 8 sweep's cells and the batched loop's inputs for them on
    ``dev``, built as ``scenarios.sweep_service(mode="batched")`` builds
    them: (cells, bag lengths by seed, reuse tables, keywords)."""
    from repro_torch.core import engine, scenarios, service, service_kernel
    grid = scenarios.default_grid()
    dists = [sc.dist() for sc in grid]
    tables = engine.ReuseTables(dists, service.grid_reuse_values(
        dists[0], seeds=SVC_SEEDS, n_jobs=SVC_JOBS, job_hours=SVC_HOURS,
        jitter=SVC_JITTER), device=dev)
    lengths = {s: service._bag_lengths(SVC_JOBS, SVC_HOURS, SVC_JITTER, s)
               for s in SVC_SEEDS}
    cells = [dict(dist_index=si, vm_type=sc.vm_type, policy=p,
                  cluster_size=SVC_CLUSTER, seed=seed)
             for si, sc in enumerate(grid) for p in SVC_POLICIES
             for seed in SVC_SEEDS]
    kw = service_kernel.cell_inputs(
        cells=cells, dists=dists, lengths_by_seed=lengths,
        reuse_tables=tables, pool_size=SVC_POOL, device=dev, **over)
    return cells, lengths, tables, kw


def same_lanes(torch, label, a, b):
    """Every field of two ``ServiceBatchResult`` equal to the bit, NaN
    positions included."""
    import dataclasses
    differ = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            same = x.dtype == y.dtype and x.shape == y.shape and \
                np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
        else:
            same = x == y
        if not same:
            differ.append(f.name)
    print(f"[service] {label}: {len(a)} lanes, every field bit-identical "
          f"{not differ}" + (f" (differ: {differ})" if differ else ""))
    check(not differ, f"{label}: fields differ: {differ}")


def lanes_finished(res, label, deadline=False):
    """Every lane ran to its end: no pool exhaustion, truncation or
    deadlock, and every job finished (or, under a deadline, was
    rejected)."""
    done = ~np.isnan(res.finished_time) | res.rejected
    check(not res.pool_exhausted.any(), f"{label}: a pool ran out")
    check(not res.truncated.any(), f"{label}: a lane hit max_steps")
    check(not res.deadlocked.any(), f"{label}: a lane deadlocked")
    check(bool(done.all()), f"{label}: unfinished jobs")
    check(deadline or not res.rejected.any(), f"{label}: rejections")


def service_path(torch, counters):
    """Phase 9; returns the sweep's rows, the batched inputs and result on
    the card, and the launch counts of the sweep's run."""
    from repro_torch.core import scenarios, service, service_kernel as SK
    grid = scenarios.default_grid()
    sweep_kw = dict(SVC_SWEEP, device="cuda")
    zero_counts(counters)
    t0 = time.perf_counter()
    rows = scenarios.sweep_service(grid, **sweep_kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counts(counters)
    print(f"[service] sweep_service: {len(rows)} rows (8 scenarios x "
          f"{len(SVC_POLICIES)} policies x {len(SVC_SEEDS)} seeds, "
          f"{SVC_JOBS} jobs of ~{SVC_HOURS} h, cluster {SVC_CLUSTER}) in "
          f"{first_s:.2f} s; kernel launches in that run {launches} (the "
          f"service path runs no hand-written kernel)")
    check(len(rows) == len(grid) * len(SVC_POLICIES) * len(SVC_SEEDS),
          f"{len(rows)} service rows")

    cells, lengths, tables, kw = service_inputs("cuda")
    res = SK.simulate_service_batch(**kw, on_exhausted="flag", device="cuda")
    lanes_finished(res, "sweep")
    fields = ("makespan", "vm_hours", "cost", "on_demand_cost",
              "n_preemptions", "n_job_failures", "n_deflations",
              "n_rejected")
    for i, (row, cell) in enumerate(zip(rows, cells)):
        lane = SK.lane_result(res, i, lengths[cell["seed"]], cell["vm_type"])
        check(all(row[k] == getattr(lane, k) for k in fields)
              and row["policy"] == cell["policy"]
              and row["seed"] == cell["seed"],
              f"sweep row {i} differs from lane {i}")
    print(f"[service] the sweep's rows equal its lanes rerun on the same "
          f"inputs; loop steps {res.loop_steps}, lane steps "
          f"{int(res.steps.min())}-{int(res.steps.max())}, events "
          f"{int(res.n_events.sum())}")

    def on_cpu(kw):
        return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in kw.items()}

    same_lanes(torch, "Fig. 8 sweep, card vs CPU on one pool and table", res,
               SK.simulate_service_batch(**on_cpu(kw), on_exhausted="flag",
                                         device="cpu"))

    # the serial heap loop on the same pools and tables
    n = 0
    for si in SVC_SERIAL_SCENARIOS:
        view = tables.view(si)
        for i, cell in enumerate(cells):
            base, deflate = SK.split_policy(cell["policy"])
            if cell["dist_index"] != si or deflate:
                continue
            pool = kw["pools"][kw["pool_index"][i]].cpu().numpy()
            got = service.BatchService(
                grid[si].dist(), vm_type=cell["vm_type"],
                cluster_size=SVC_CLUSTER, policy=base, seed=cell["seed"],
                reuse_table=view if base == "model" else None,
                lifetime_pool=pool, pool_size=SVC_POOL,
                device="cuda").run(lengths[cell["seed"]])
            want = SK.lane_result(res, i, lengths[cell["seed"]],
                                  cell["vm_type"], jobs=True)
            same = all(getattr(got, k) == getattr(want, k)
                       for k in fields + ("dollars",)) and all(
                (g.finished, g.attempts, g.failures, g.done_work)
                == (w.finished, w.attempts, w.failures, w.done_work)
                for g, w in zip(got.jobs, want.jobs))
            check(same, f"serial heap loop differs from lane {i} "
                        f"({cell})")
            n += 1
    print(f"[service] serial heap loop: {n} cells (scenarios "
          f"{[grid[si].name for si in SVC_SERIAL_SCENARIOS]} x model, "
          f"memoryless x {len(SVC_SEEDS)} seeds) bit-identical to their "
          f"lanes, per job too")

    # deadline admission control, through the public sweep and on one pool
    d_rows = scenarios.sweep_service(
        grid, **dict(sweep_kw, deadline_hours=SVC_DEADLINE))
    _, _, _, kw_d = service_inputs("cuda", deadline_hours=SVC_DEADLINE)
    res_d = SK.simulate_service_batch(**kw_d, on_exhausted="flag",
                                      device="cuda")
    lanes_finished(res_d, "deadline", deadline=True)
    check([r["n_rejected"] for r in d_rows] == res_d.n_rejected.tolist(),
          "deadline sweep rows differ from their lanes")
    check(int(res_d.n_rejected.sum()) > 0, "the 6 h deadline rejected none")
    print(f"[service] deadline {SVC_DEADLINE} h: {int(res_d.n_rejected.sum())}"
          f" of {res_d.rejected.size} jobs rejected, in "
          f"{int((res_d.n_rejected > 0).sum())} of {len(res_d)} lanes")
    same_lanes(torch, f"deadline {SVC_DEADLINE} h, card vs CPU", res_d,
               SK.simulate_service_batch(**on_cpu(kw_d), on_exhausted="flag",
                                         device="cpu"))

    # market billing on a seeded, strictly positive (B, Tp) price row
    prices = np.random.default_rng(SVC_PRICE_SEED).uniform(
        0.5, 2.0, size=(len(cells), SVC_PRICE_CELLS))
    kw_p = dict(kw, price_rows=prices, price_dt=SVC_PRICE_DT)
    res_p = SK.simulate_service_batch(**kw_p, on_exhausted="flag",
                                      device="cuda")
    lanes_finished(res_p, "priced")
    check(res_p.priced and not np.array_equal(res_p.dollars,
                                              res_p.vm_hours),
          "priced run billed unit prices")
    same_lanes(torch, "priced, card vs CPU", res_p,
               SK.simulate_service_batch(**on_cpu(kw_p), on_exhausted="flag",
                                         device="cpu"))
    print(f"[service] priced: dollars {float(res_p.dollars.min()):.4f}-"
          f"{float(res_p.dollars.max()):.4f} per lane")

    # reuse denials: jobs of ~6 h on 4-6 VMs, where the model policy denies
    # spares whose window would run too late, so its lanes leave their
    # memoryless twins (tests/test_torch_service.py's denial lanes)
    from repro_torch.core import distributions as TD
    from repro_torch.core import engine
    dists = [TD.diurnal_for("n1-highcpu-32", 20.0),
             TD.diurnal_for("n1-highcpu-16", 8.0),
             TD.diurnal_for("n1-highcpu-16", 14.0, A=0.44)]
    tabs = engine.ReuseTables(dists, service.grid_reuse_values(
        dists[0], seeds=(0, 1), n_jobs=DENY_JOBS, job_hours=DENY_HOURS,
        jitter=SVC_JITTER), device="cuda")
    kw_n = dict(
        lengths=np.stack([service._bag_lengths(DENY_JOBS, DENY_HOURS,
                                               SVC_JITTER, s)
                          for s in (0, 1)]),
        pools=SK.draw_service_pool_batch(dists, [0, 1, 2], size=DENY_POOL,
                                         device="cuda"),
        bag_index=[0, 1, 0, 1] * 4, pool_index=[0, 1, 2, 0] * 4,
        policy=["model"] * 8 + ["memoryless"] * 8,
        cluster_size=[6, 4] * 8, tables=tabs.tensor,
        T_values=tabs.T_values, reuse_L=tabs.L,
        table_index=[0, 1, 2, 0] * 4,
        deflate=([False] * 4 + [True] * 4) * 2)
    res_n = SK.simulate_service_batch(**kw_n, on_exhausted="flag",
                                      device="cuda")
    lanes_finished(res_n, "reuse denials")
    differ = bool(np.all(res_n.makespan[:8] != res_n.makespan[8:]))
    print(f"[service] reuse denials ({DENY_JOBS} jobs of ~{DENY_HOURS} h on "
          f"4-6 VMs): model lanes' makespans differ from their memoryless "
          f"twins' in all 8 pairs: {differ}")
    check(differ, "reuse denials: a model lane equals its memoryless twin")
    same_lanes(torch, "reuse denials, card vs CPU", res_n,
               SK.simulate_service_batch(**on_cpu(kw_n), on_exhausted="flag",
                                         device="cpu"))

    for r in rows:
        check(np.isfinite(r["cost_reduction"]) and r["cost_reduction"] > 1.0,
              f"row {r['scenario']}/{r['policy']}/{r['seed']}: cost "
              f"reduction {r['cost_reduction']}")
    for p in SVC_POLICIES:
        cr = [r["cost_reduction"] for r in rows if r["policy"] == p]
        fr = [r["job_failure_rate"] for r in rows if r["policy"] == p]
        print(f"[service] {p:19s} cost reduction {min(cr):.3f}-{max(cr):.3f}"
              f"x (mean {statistics.mean(cr):.3f}), job failure rate mean "
              f"{statistics.mean(fr):.4f}")
    return rows, kw, res, launches


def service_timing(torch, kw, res, smi):
    """Phase 10: the sweep's and the loop's times, steps, events/s, the
    scale point's events/s and the sweep's device busy share."""
    from repro_torch.core import distributions as TD
    from repro_torch.core import engine, scenarios, service
    from repro_torch.core import service_kernel as SK
    grid = scenarios.default_grid()
    sweep_kw = dict(SVC_SWEEP, device="cuda")
    sweep_ms = host_ms(torch, lambda: scenarios.sweep_service(grid,
                                                              **sweep_kw))
    loop_ms = host_ms(torch, lambda: SK.simulate_service_batch(
        **kw, device="cuda"))
    # the sweep's set-up outside the loop: the reuse table and the pools
    dists = [sc.dist() for sc in grid]
    values = service.grid_reuse_values(dists[0], seeds=SVC_SEEDS,
                                       n_jobs=SVC_JOBS, job_hours=SVC_HOURS,
                                       jitter=SVC_JITTER)
    table_ms = host_ms(torch, lambda: engine.ReuseTables(dists, values,
                                                         device="cuda"))
    pool_ms = host_ms(torch, lambda: SK.draw_service_pool_batch(
        [d for d in dists for _ in SVC_SEEDS],
        [s for _ in dists for s in SVC_SEEDS], size=SVC_POOL,
        device="cuda"))
    events = int(res.n_events.sum())
    # the scale point: memoryless lanes on 2,000-job bags
    dist = TD.constrained_for(SCALE_VM)
    seeds = list(range(SCALE_BAGS))
    bags = np.stack([service._bag_lengths(SCALE_JOBS, SVC_HOURS, SVC_JITTER,
                                          s) for s in seeds])
    pools = SK.draw_service_pool_batch([dist] * SCALE_BAGS, seeds,
                                       size=4 * SCALE_JOBS, device="cuda")
    skw = dict(lengths=bags, pools=pools,
               bag_index=[i % SCALE_BAGS for i in range(SCALE_LANES)],
               pool_index=[i % SCALE_BAGS for i in range(SCALE_LANES)],
               policy=["memoryless"] * SCALE_LANES,
               cluster_size=[SVC_CLUSTER] * SCALE_LANES, device="cuda")
    # warm-up on a tenth of each bag: the loop compiles nothing, so the
    # warm-up needs the same operations, not the same length
    SK.simulate_service_batch(**dict(skw, lengths=bags[:, :SCALE_JOBS // 10]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big = SK.simulate_service_batch(**skw)
    torch.cuda.synchronize()
    scale_s = time.perf_counter() - t0
    lanes_finished(big, "scale point")
    big_events = int(big.n_events.sum())
    wall, dev_ms, prof_rows = profile_window(
        torch, lambda: scenarios.sweep_service(grid, **sweep_kw), top=10)
    busy = None if dev_ms is None else dev_ms / wall
    print(f"[profile] service sweep: wall {wall:.2f} ms, device busy "
          f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms (share "
          f"{busy if busy is None else round(busy, 4)}); device events:")
    for name, ms, calls in prof_rows:
        print(f"[profile] service   {ms:9.3f} ms  {calls:7d} x  {name}")
    timing = {
        "service_sweep_ms": sweep_ms, "service_loop_ms": loop_ms,
        "reuse_table_ms": table_ms, "pool_draw_ms": pool_ms,
        "loop_steps": res.loop_steps,
        "lane_steps_max": int(res.steps.max()),
        "ms_per_step": loop_ms / res.loop_steps,
        "sweep_events": events,
        "sweep_events_per_s": events / (sweep_ms / 1e3),
        "scale_lanes": SCALE_LANES, "scale_jobs": SCALE_JOBS,
        "scale_s": scale_s, "scale_loop_steps": big.loop_steps,
        "scale_ms_per_step": scale_s * 1e3 / big.loop_steps,
        "scale_events": big_events,
        "scale_events_per_s": big_events / scale_s,
        "sweep_profiled_wall_ms": wall, "sweep_device_ms": dev_ms,
        "sweep_device_busy_share": busy, "card": smi}
    print("[timing] service " + json.dumps(timing))
    return timing


# ---------------------------------------------------------------------------
# the market slice and the fit
# ---------------------------------------------------------------------------

def same_rows(a, b):
    """Whether two row lists agree in every field (NaN equal to NaN)."""
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[k] == y[k] or (x[k] != x[k] and y[k] != y[k]) for k in x)
        for x, y in zip(a, b))


def shared_pools(engine):
    """Within the block, the market sweep's lifetime pools are drawn on the
    CPU and copied to the requested device, so a card run and a CPU run
    execute the same pool."""
    from unittest import mock
    draw = engine.draw_lifetime_pool_batch

    def on_cpu(*a, device="cuda", **kw):
        first, pool = draw(*a, device="cpu", **kw)
        return first.to(device), pool.to(device)
    return mock.patch.object(engine, "draw_lifetime_pool_batch", on_cpu)


def market_path(torch, dp_recurrence):
    """Phase 11: the market path at market_bench's full size; returns its
    inputs for phase 12 and the DP launches of its run."""
    from repro_torch.core import engine, market, scenarios
    from repro_torch.core.policies import checkpointing
    grid = scenarios.default_grid()
    mkt = market.MarketModel.for_scenarios(grid)
    dp_kw = dict(job_steps=J_MAIN, grid_dt=DT_MAIN, delta_steps=DELTA,
                 n_sweeps=N_SWEEPS)
    sweep_kw = dict(dp_kw, market=mkt, regimes=MKT_REGIMES,
                    policies=MKT_POLICIES, seeds=SEEDS, n_trials=MKT_TRIALS,
                    max_restarts=MAX_RESTARTS)
    dp_recurrence.launches = 0
    t0 = time.perf_counter()
    tabs = {obj: scenarios.solve_market_tables(
        grid, mkt, regimes=MKT_REGIMES, dp_objective=obj, device="cuda",
        **dp_kw) for obj, _ in MKT_OBJECTIVES}
    rows = scenarios.sweep_market(grid, tables=tabs["makespan"],
                                  device="cuda", **sweep_kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dp_recurrence.launches
    print(f"[market] solve_market_tables x 2 objectives + sweep_market: "
          f"{len(rows)} rows in {first_s:.2f} s; dp_recurrence launches "
          f"{launches}")
    check(launches == 2 * len(MKT_REGIMES),
          f"the market path launched dp_recurrence {launches} times, "
          f"expected {2 * len(MKT_REGIMES)}")
    check(len(rows) == len(grid) * len(MKT_REGIMES) * len(MKT_POLICIES)
          * len(SEEDS), f"{len(rows)} market rows")
    grid0 = mkt.grid()
    for obj, k_min in MKT_OBJECTIVES:
        for regime in MKT_REGIMES:
            t = tabs[obj][regime].validate()
            check(t.backend == "cuda", f"market tables used {t.backend}")
            t_launch = mkt.launch_time(regime)
            plain = checkpointing.solve_batch(
                mkt.crunch_dists(grid, t_launch), J_MAIN, grid_dt=DT_MAIN,
                delta_steps=DELTA, n_sweeps=N_SWEEPS, backend="reference",
                objective=obj,
                price=grid0.shift(t_launch) if obj == "dollars" else None,
                device="cuda")
            dv = float((t.V - plain.V).abs().max())
            k_agree = float((t.K == plain.K).double().mean())
            check(bool(torch.allclose(t.V, plain.V, rtol=1e-5, atol=1e-5)),
                  f"market {obj}/{regime}: V differs from the plain "
                  f"version's beyond rtol = atol = 1e-5")
            check(k_agree >= k_min, f"market {obj}/{regime}: K agreement "
                                    f"{k_agree} < {k_min}")
            same = bool(torch.equal(t.V, plain.V)) \
                and bool(torch.equal(t.K, plain.K))
            print(f"[market] {obj} tables, {regime} (launch hour "
                  f"{t_launch}): kernel vs plain max|dV| {dv:.3e}, K "
                  f"agreement {k_agree:.6f} (need {k_min}); bit-identical "
                  f"{same}")
    for r in rows:
        check(np.isfinite(r["expected_dollars"])
              and r["unfinished_frac"] == 0.0,
              f"market row {r['scenario']}/{r['regime']}/{r['policy']}/"
              f"{r['seed']}: {r}")
    ref = scenarios.sweep_market(grid, tables=tabs["makespan"],
                                 cost_path="reference", device="cuda",
                                 **sweep_kw)
    check(same_rows(rows, ref), "market: kernel-path dollars differ from "
                                "the serial reference")
    print(f"[market] kernel-path rows bit-identical to cost_path="
          f"'reference' on the card: {len(rows)} of {len(ref)}")
    with shared_pools(engine):
        card = scenarios.sweep_market(grid, tables=tabs["makespan"],
                                      device="cuda", **sweep_kw)
        cpu = scenarios.sweep_market(grid, tables=tabs["makespan"],
                                     device="cpu", **sweep_kw)
    check(same_rows(card, cpu), "market: card and CPU rows differ on one "
                                "pool and table set")
    print(f"[market] card vs CPU on one pool and table set: {len(card)} "
          f"rows, every field bit-identical")
    # market_bench's acceptance flags
    fixed = {(r["scenario"], r["seed"]): r["expected_dollars"] for r in rows
             if r["regime"] == "crunch" and r["policy"] == "fixed"
             and r["crunch"]}
    cheap = {(r["scenario"], r["seed"]): r["expected_dollars"] for r in rows
             if r["regime"] == "crunch" and r["policy"] == "cheapest"
             and r["crunch"]}
    beats = bool(fixed) and all(cheap[k] < fixed[k] for k in fixed)
    t_launch = mkt.launch_time("crunch")
    dists = mkt.crunch_dists(grid, t_launch)
    g = grid0.shift(t_launch)
    ev_kw = dict(grid_dt=DT_MAIN, delta_steps=DELTA, n_sweeps=N_SWEEPS,
                 device="cuda")
    ev_mk = checkpointing.evaluate_policy_dollars(
        tabs["makespan"]["crunch"].K, dists, g, **ev_kw)
    ev_d = checkpointing.evaluate_policy_dollars(
        tabs["dollars"]["crunch"].K, dists, g, **ev_kw)
    ratios = []
    for s, p in enumerate(mkt.processes):
        if p.crunched:
            mk_d, dl_d = float(ev_mk[s, J_MAIN, 0]), float(ev_d[s, J_MAIN, 0])
            ratios.append((grid[s].name, dl_d / mk_d,
                           dl_d <= mk_d * (1.0 + 1e-6)))
    ddp = bool(ratios) and all(ok for _, _, ok in ratios)
    for pol in MKT_POLICIES:
        for regime in MKT_REGIMES:
            vals = [r["expected_dollars"] for r in rows
                    if r["policy"] == pol and r["regime"] == regime]
            print(f"[market] {regime:6s} {pol:8s}: mean expected dollars "
                  f"{sum(vals) / len(vals):.6f} over {len(vals)} rows")
    print(f"[market] cheapest < fixed on all {len(fixed)} crunch leaves x "
          f"seeds: {beats}; dollar-DP / makespan-DP dollars on crunch "
          f"leaves {[(n, round(x, 6)) for n, x, _ in ratios]}, all <= "
          f"1 + 1e-6: {ddp}")
    check(beats, "market: cheapest does not beat fixed on every crunch leaf")
    check(ddp, "market: the dollar DP pays more than the makespan DP")
    return dict(grid=grid, mkt=mkt, tabs=tabs, sweep_kw=sweep_kw,
                dp_kw=dp_kw, rows=rows, dists=dists, price=g,
                ev_kw=ev_kw), launches


def market_timing(torch, inp, smi):
    """Phase 12: the market path's solve, sweep, evaluation and gather
    times, and one sweep under torch.profiler."""
    from repro_torch.core import engine, scenarios
    from repro_torch.core.policies import checkpointing
    grid, mkt, tabs = inp["grid"], inp["mkt"], inp["tabs"]
    timing = {}
    for obj, _ in MKT_OBJECTIVES:
        timing[f"solve_market_tables_{obj}_ms"] = host_ms(
            torch, lambda: scenarios.solve_market_tables(
                grid, mkt, regimes=MKT_REGIMES, dp_objective=obj,
                device="cuda", **inp["dp_kw"]))
    sweep = lambda: scenarios.sweep_market(  # noqa: E731
        grid, tables=tabs["makespan"], device="cuda", **inp["sweep_kw"])
    timing["sweep_market_ms"] = host_ms(torch, sweep)
    timing["evaluate_policy_dollars_ms"] = host_ms(
        torch, lambda: checkpointing.evaluate_policy_dollars(
            tabs["dollars"]["crunch"].K, inp["dists"], inp["price"],
            **inp["ev_kw"]))
    first, pool = engine.draw_lifetime_pool_batch(
        inp["dists"], MKT_TRIALS, max_restarts=MAX_RESTARTS, seed=0,
        device="cuda")
    mk = engine.simulate_makespan_batch(
        tabs["makespan"]["crunch"].K, J_MAIN, first=first, pool=pool,
        grid_dt=DT_MAIN, delta_steps=DELTA, max_restarts=MAX_RESTARTS,
        device="cuda")
    timing["accumulate_price_cost_ms"] = host_ms(
        torch, lambda: engine.accumulate_price_cost(inp["price"], mk,
                                                    device="cuda"))
    wall, dev_ms, prof_rows = profile_window(torch, sweep, top=10)
    busy = None if dev_ms is None else dev_ms / wall
    print(f"[profile] sweep_market: wall {wall:.2f} ms, device busy "
          f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms (share "
          f"{busy if busy is None else round(busy, 4)}); device events:")
    for name, ms, calls in prof_rows:
        print(f"[profile] market   {ms:9.3f} ms  {calls:6d} x  {name}")
    timing.update(sweep_market_profiled_wall_ms=wall,
                  sweep_market_device_ms=dev_ms,
                  sweep_market_device_busy_share=busy, card=smi)
    print("[timing] market " + json.dumps(timing))
    return timing


def fit_phase(torch, smi):
    """Phase 13: the Eq. 1 fit (Fig. 1) on the card against the port on
    the CPU, at the tolerances of tests/test_torch_fitting.py."""
    from repro_torch.core import distributions as TD
    from repro_torch.core import fitting
    u = np.random.default_rng(FIT_SEED).uniform(size=FIT_N)
    trace = TD.constrained_for(FIT_VM).icdf(torch.from_numpy(u)).numpy()
    card, ms = {}, {}
    for fam in FIT_FAMILIES:
        fitting.fit_samples(fam, trace, device="cuda")   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card[fam] = fitting.fit_samples(fam, trace, device="cuda")
        torch.cuda.synchronize()
        ms[fam] = (time.perf_counter() - t0) * 1e3
    cpu = fitting.fit_all(trace, families=FIT_FAMILIES, device="cpu")
    lses = {f: float(r.lse) for f, r in card.items()}
    out = {}
    for fam in FIT_FAMILIES:
        r = card[fam]
        ks = float(fitting.ks_statistic(r.dist, trace))
        out[fam] = dict(lse=lses[fam], ks=ks, iterations=r.iterations,
                        converged=r.converged, ms=ms[fam])
        print(f"[fit] {fam:16s}: LSE {lses[fam]:.10g}, KS {ks:.6f}, "
              f"{r.iterations} iterations (best start), converged "
              f"{r.converged}, {ms[fam]:.1f} ms on the card; CPU LSE "
              f"{float(cpu[fam].lse):.10g}, {cpu[fam].iterations} "
              f"iterations")
    check(card["constrained"].converged, "fit: Eq. 1 did not converge")
    check(min(lses, key=lses.get) == "constrained",
          f"fit: Eq. 1 has not the lowest LSE: {lses}")
    for fam in ("constrained", "exponential", "weibull"):
        a, b = card[fam], cpu[fam]
        check(a.converged and b.converged
              and a.iterations == b.iterations
              and np.allclose(a.theta.cpu().numpy(), b.theta.numpy(),
                              rtol=1e-7, atol=0)
              and np.isclose(float(a.lse), float(b.lse), rtol=1e-9, atol=0),
              f"fit {fam}: card {a.theta.tolist()} / {float(a.lse)} / "
              f"{a.iterations} vs CPU {b.theta.tolist()} / {float(b.lse)} / "
              f"{b.iterations}")
    gm = card["gompertz_makeham"]
    check(gm.converged and np.isclose(lses["gompertz_makeham"],
                                      lses["exponential"], rtol=1e-8,
                                      atol=0),
          f"fit gompertz_makeham: converged {gm.converged}, LSE "
          f"{lses['gompertz_makeham']} vs the exponential limit "
          f"{lses['exponential']}")
    print("[fit] card vs CPU: constrained, exponential, weibull equal "
          "within theta rtol 1e-7 / LSE rtol 1e-9 with the same iterations;"
          " gompertz_makeham converged at the exponential limit")
    print("[timing] fit " + json.dumps(dict(out, card=smi)))
    return out


# ---------------------------------------------------------------------------
# refinement and the closed loop
# ---------------------------------------------------------------------------

def same_tables(torch, a, b):
    return bool(torch.equal(a.V, b.V)) and bool(torch.equal(a.K, b.K))


class LaunchRecorder:
    """Stands in for the CUDA backend's ``dp_recurrence``: calls the kernel
    (which counts the launch) and records each call's inputs and tables."""

    def __init__(self, kernel):
        self.kernel, self.calls = kernel, []

    def __call__(self, *args, **kw):
        out = self.kernel(*args, **kw)
        self.calls.append((args, kw, out))
        return out


def recorded_launches(dp_recurrence):
    """Records every ``dp_recurrence`` launch the CUDA DP backend makes
    inside the ``with`` block."""
    from unittest import mock

    from repro_torch.core.policies.solver_backends import cuda
    return mock.patch.object(cuda, "dp_recurrence",
                             LaunchRecorder(dp_recurrence))


def hold_to_plain(torch, dp_recurrence_plain, rec, label):
    """Holds every launch ``rec`` recorded to ``dp_recurrence_plain`` on the
    same inputs, on the card: V and K must be bit-identical."""
    for args, kw, (Vk, Kk) in rec.calls:
        Vp, Kp = dp_recurrence_plain(*args, **kw)
        same = bool(torch.equal(Vk, Vp)) and bool(torch.equal(Kk, Kp))
        print(f"[kernel] {label}: launch of shape {tuple(Vk.shape)}, "
              f"{kw['n_sweeps']} sweep(s), V and K bit-identical to "
              f"dp_recurrence_plain on its inputs {same}")
        check(same, f"{label}: a {tuple(Vk.shape)} launch differs from "
                    f"dp_recurrence_plain on the same inputs")
    return len(rec.calls)


def refine_phase(torch, dp_recurrence, dp_recurrence_plain, mkt_inputs,
                 sweep_kw, smi):
    """Phase 14: ``solve_batch(refine=True)`` at the main path's full size
    against the plain kernel solve (each of its launches, the coarse hint
    and the final sweep from the pre-swept column 0, also against
    ``dp_recurrence_plain`` on the same inputs), the refined sweep and
    market tables with their launch counts, a forced fallback, and the
    refined and plain solve times.  Returns the DP launches of the refined
    calls."""
    from unittest import mock

    from repro_torch.core import scenarios
    from repro_torch.core.policies import checkpointing
    from repro_torch.core.policies.solver_backends import refine as R
    grid = scenarios.default_grid()
    kw = dict(grid_dt=DT_MAIN, delta_steps=DELTA, n_sweeps=N_SWEEPS,
              device="cuda")
    cases = (("makespan", [sc.dist() for sc in grid], {}),
             ("dollars", mkt_inputs["dists"],
              dict(objective="dollars", price=mkt_inputs["price"])))
    launches, timing = 0, {}
    for obj, dists, extra in cases:
        plain = checkpointing.solve_batch(dists, J_MAIN, **kw, **extra)
        for start, v_init in (("cold", None), ("warm", plain.V)):
            want = plain if v_init is None else checkpointing.solve_batch(
                dists, J_MAIN, v_init=v_init, **kw, **extra)
            dp_recurrence.launches = 0
            with recorded_launches(dp_recurrence) as rec:
                got = checkpointing.solve_batch(dists, J_MAIN, v_init=v_init,
                                                refine=True, **kw, **extra)
            n = dp_recurrence.launches
            launches += n
            info = got.refine_info
            same = same_tables(torch, got, want)
            print(f"[refine] {obj} {start}: backend {got.backend}, caps "
                  f"{info.get('caps')}, verified_col0 "
                  f"{info.get('verified_col0')}, fallback "
                  f"{info.get('fallback')}; V, K bit-identical to the plain "
                  f"kernel solve {same}; dp_recurrence launches {n}")
            check(info["applied"] and info["verified_col0"]
                  and not info["fallback"],
                  f"refine {obj} {start}: {info}")
            check(same, f"refine {obj} {start}: tables differ from the plain "
                        f"kernel solve")
            check(n == 2, f"refine {obj} {start}: {n} launches, expected 2")
            check(rec.calls[-1][1]["n_sweeps"] == 1,
                  f"refine {obj} {start}: the final sweep is not one sweep")
            hold_to_plain(torch, dp_recurrence_plain, rec,
                          f"refine {obj} {start}")
        timing[f"refined_solve_{obj}_ms"] = host_ms(
            torch, lambda: checkpointing.solve_batch(dists, J_MAIN,
                                                     refine=True, **kw,
                                                     **extra))
        timing[f"plain_solve_{obj}_ms"] = host_ms(
            torch, lambda: checkpointing.solve_batch(dists, J_MAIN, **kw,
                                                     **extra))

    dp_recurrence.launches = 0
    rows_r = scenarios.sweep_checkpointing(grid, solver_refine=True,
                                           **sweep_kw)
    n = dp_recurrence.launches
    launches += n
    rows_p = scenarios.sweep_checkpointing(grid, **sweep_kw)
    check(same_rows(rows_r, rows_p), "refine: sweep rows differ from the "
                                     "plain sweep's")
    print(f"[refine] sweep_checkpointing(solver_refine=True): {len(rows_r)} "
          f"rows equal to the plain sweep's; dp_recurrence launches {n}")
    # 2 launches: a verified solve; a fallback would make 3
    check(n == 2, f"refine: the refined sweep made {n} launches, expected 2")
    n_mkt = 0
    for obj, _ in MKT_OBJECTIVES:
        dp_recurrence.launches = 0
        tabs = scenarios.solve_market_tables(
            grid, mkt_inputs["mkt"], regimes=MKT_REGIMES, dp_objective=obj,
            solver_refine=True, device="cuda", **mkt_inputs["dp_kw"])
        n_mkt += dp_recurrence.launches
        for regime in MKT_REGIMES:
            info = tabs[regime].refine_info
            check(info["verified_col0"] and not info["fallback"]
                  and same_tables(torch, tabs[regime],
                                  mkt_inputs["tabs"][obj][regime]),
                  f"refine: market {obj}/{regime} tables differ ({info})")
    launches += n_mkt
    want_mkt = 2 * len(MKT_OBJECTIVES) * len(MKT_REGIMES)
    print(f"[refine] solve_market_tables(solver_refine=True), both "
          f"objectives x {len(MKT_REGIMES)} regimes: verified, tables "
          f"bit-identical to the plain ones; dp_recurrence launches {n_mkt}")
    check(n_mkt == want_mkt, f"refine: the refined market solves made "
                             f"{n_mkt} launches, expected {want_mkt}")

    # a forced fallback: every candidate cap 1, so the pre-sweeps miss
    # argmins and the column-0 check must catch it
    dists = cases[0][1]
    with mock.patch.object(R, "candidate_caps",
                           lambda Kc, segs, **_: (1,) * len(segs)):
        dp_recurrence.launches = 0
        fb = checkpointing.solve_batch(dists, J_MAIN, refine=True, **kw)
        n = dp_recurrence.launches
    launches += n
    info = fb.refine_info
    same = same_tables(torch, fb,
                       checkpointing.solve_batch(dists, J_MAIN, **kw))
    print(f"[refine] forced fallback (caps 1): verified_col0 "
          f"{info['verified_col0']}, fallback {info['fallback']}, tables "
          f"equal to the plain solve {same}, launches {n}")
    check(info["fallback"] and not info["verified_col0"] and same and n == 3,
          f"refine: forced fallback {info}, equal {same}, launches {n}")
    timing.update(refine_launches=launches, card=smi)
    print("[timing] refine " + json.dumps(timing))
    return launches


class RecordedStream:
    """A lifetime stream that records what ``inner`` draws or, without
    ``inner``, replays recorded ``values`` in order."""

    def __init__(self, inner=None, values=None):
        self.inner, self.values, self.i = inner, list(values or ()), 0

    def next(self) -> float:
        if self.inner is not None:
            self.values.append(self.inner.next())
            return self.values[-1]
        self.i += 1
        return self.values[self.i - 1]

    def set_regime(self, vm_types):
        if self.inner is not None:
            self.inner.set_regime(vm_types)


def runtime_run(torch, refine, stream, device):
    """One closed-loop run of RT_OBS observations: the runtime, its report
    and (obs, V, K, refine_info) of the cold tables (obs None) and of each
    swap."""
    from repro_torch import fault
    from repro_torch.core import runtime, scenarios
    cfg = runtime.RuntimeConfig(
        base_scenarios=tuple(sc.name for sc in scenarios.default_grid()),
        solver_refine=refine, **RT_CONFIG)
    rt = runtime.FleetRuntime(
        cfg, injector=fault.FaultInjector(fault.default_schedule(RT_OBS),
                                          seed=0),
        stream=stream, device=device)
    live = rt.live_tables
    tables = [(None, live.V.clone(), live.K.clone(), live.refine_info)]
    for _ in range(RT_OBS):
        rt.step()
        if rt.live_tables is not live:
            live = rt.live_tables
            tables.append((rt.obs - 1, live.V.clone(), live.K.clone(),
                           live.refine_info))
    return rt, rt.report(), tables


def swap_keys(rep):
    return [(s.obs, s.reason, s.warm) for s in rep.swaps]


def runtime_phase(torch, dp_recurrence, dp_recurrence_plain, smi):
    """Phase 15: the closed loop at full width on the card (refinement off,
    then on, on one recorded stream), replayed on the CPU, the warm-start
    identity on the card, and its timing.  Returns the DP launches of the
    run without refinement."""
    from repro_torch.core import fitting, runtime
    from repro_torch.core.policies import checkpointing
    rec = RecordedStream(runtime.FleetStream(
        seed=0, block=RT_CONFIG["stream_block"],
        vm_types=RT_CONFIG["stream_vm_types"], device="cuda"))
    dp_recurrence.launches = 0
    t0 = time.perf_counter()
    rt, rep, tabs = runtime_run(torch, False, rec, "cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dp_recurrence.launches
    print(f"[runtime] {RT_OBS} observations, {len(rt.scenario_names)} "
          f"scenarios (DP {tuple(rt.live_tables.V.shape)}): {rep.n_refits} "
          f"refits, {rep.change_points} change points, {len(rep.swaps)} "
          f"swaps, retries {rep.retries}, degraded {rep.degraded}, "
          f"adaptation lag {rep.adaptation_lag_obs}, regret "
          f"{rep.regret_hours} h ({rep.regret_frac}); {first_s:.2f} s; "
          f"dp_recurrence launches {launches}")
    for obs, kind, detail in rep.events:
        print(f"[runtime]   obs {obs:5d}: {kind:22s} {detail}")
    check(rep.retries == {"fit": 2, "solve": 1},
          f"runtime: retries {rep.retries}")
    drift = next(o for o, k, _ in rep.events if k == "drift-injected")
    check(rep.adaptation_lag_obs is not None and any(
        s.reason == "change-point" and s.obs > drift for s in rep.swaps),
        "runtime: no change-point swap answered the drift")
    regrets = [s.regret_hours for s in rep.swaps
               if s.regret_hours is not None]
    check(rep.regret_hours is not None
          and all(np.isfinite(r) for r in regrets),
          f"runtime: regrets {regrets}")
    check(launches == len(rep.swaps) + 1,
          f"runtime: {launches} DP launches for {len(rep.swaps)} swaps and "
          f"the cold solve")

    dp_recurrence.launches = 0
    rt_r, rep_r, tabs_r = runtime_run(torch, True,
                                      RecordedStream(values=rec.values),
                                      "cuda")
    launches_r = dp_recurrence.launches
    same = rep_r.events == rep.events and swap_keys(rep_r) == swap_keys(rep)
    bits = len(tabs_r) == len(tabs) and all(
        a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        for a, b in zip(tabs, tabs_r))
    infos = [t[3] for t in tabs_r]
    verified = all(i["verified_col0"] and not i["fallback"] for i in infos)
    print(f"[runtime] solver_refine=True on the recorded stream: events and "
          f"swaps equal {same}; every swap's tables bit-identical {bits}; "
          f"the cold solve and all {len(rep_r.swaps)} swaps verified without "
          f"fallback {verified}; last refine_info {infos[-1]}; "
          f"dp_recurrence launches {launches_r}")
    check(same and bits, "runtime: the refined run differs")
    check(verified, f"runtime: a refined solve was not verified: {infos}")
    check(launches_r == 2 * (len(rep_r.swaps) + 1),
          f"runtime: {launches_r} DP launches for the refined run's "
          f"{len(rep_r.swaps)} swaps and cold solve, expected "
          f"{2 * (len(rep_r.swaps) + 1)}")

    t0 = time.perf_counter()
    rt_c, rep_c, _ = runtime_run(torch, False,
                                 RecordedStream(values=rec.values), "cpu")
    cpu_s = time.perf_counter() - t0
    V, Vc = rt.live_tables.V.cpu(), rt_c.live_tables.V
    k_agree = float((rt.live_tables.K.cpu() == rt_c.live_tables.K)
                    .double().mean())
    close = bool(torch.allclose(V, Vc, rtol=1e-5, atol=1e-5))
    same_c = rep_c.events == rep.events \
        and swap_keys(rep_c) == swap_keys(rep)
    print(f"[runtime] CPU replay of the recorded stream ({cpu_s:.1f} s): "
          f"events and swaps equal {same_c}; live tables max|dV| "
          f"{float((V - Vc).abs().max()):.3e}, K agreement {k_agree:.6f}")
    check(same_c and close and k_agree >= 0.999,
          "runtime: the CPU replay differs")

    dists = rt._dists()
    kw = dict(grid_dt=DT_MAIN, delta_steps=DELTA, device="cuda")
    cold3 = checkpointing.solve_batch(dists, J_MAIN, n_sweeps=3, **kw)
    with recorded_launches(dp_recurrence) as launched:
        warm = checkpointing.solve_batch(dists, J_MAIN, n_sweeps=1,
                                         v_init=cold3.V, **kw)
        rt._solve(warm=True, inject=False)
    cold4 = checkpointing.solve_batch(dists, J_MAIN, n_sweeps=4, **kw)
    ident = same_tables(torch, warm, cold4)
    print(f"[runtime] warm-start identity on the card: one warm sweep from "
          f"a 3-sweep V equals the 4-sweep cold solve {ident}")
    check(ident, "runtime: warm-start identity fails on the card")
    # the warm sweep above and a runtime warm re-solve, each against the
    # plain version on the same inputs
    check(hold_to_plain(torch, dp_recurrence_plain, launched,
                        "runtime warm")
          == 2, "runtime: expected 2 recorded warm launches")

    # timing, after the runs above as warm-up
    window = np.asarray(rt.tracker._obs)
    timing = {
        "cold_solve_ms": host_ms(
            torch, lambda: rt._solve(warm=False, inject=False)),
        "warm_solve_ms": host_ms(
            torch, lambda: rt._solve(warm=True, inject=False)),
        "refined_cold_solve_ms": host_ms(
            torch, lambda: rt_r._solve(warm=False, inject=False)),
        "refined_warm_solve_ms": host_ms(
            torch, lambda: rt_r._solve(warm=True, inject=False)),
        "measure_regret_ms": host_ms(torch, rt.measure_regret),
        "refit_ms": host_ms(torch, lambda: fitting.fit_samples(
            "constrained", window, device="cuda")),
    }
    t0 = time.perf_counter()
    runtime_run(torch, False, RecordedStream(values=rec.values), "cuda")
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    wall, dev_ms, prof_rows = profile_window(
        torch, lambda: rt._try_swap("change-point"), top=8)
    busy = None if dev_ms is None else dev_ms / wall
    print(f"[profile] one swap (warm solve, validation, regret): wall "
          f"{wall:.2f} ms, device busy "
          f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms (share "
          f"{busy if busy is None else round(busy, 4)}); device events:")
    for name, ms, calls in prof_rows:
        print(f"[profile] swap   {ms:9.3f} ms  {calls:6d} x  {name}")
    timing.update(run_ms=run_ms, run_ms_per_obs=run_ms / RT_OBS,
                  first_run_s=first_s, cpu_replay_s=cpu_s,
                  dp_launches_run=launches, dp_launches_refined_run=launches_r,
                  swaps=len(rep.swaps), swap_profiled_wall_ms=wall,
                  swap_device_ms=dev_ms, swap_device_busy_share=busy,
                  card=smi)
    print("[timing] runtime " + json.dumps(timing))
    return launches


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

def bwd_errors(torch, got, want):
    """max|got - want|, max|want|, and for bf16 the number of elements
    beyond both 2 bf16 ulps of the plain value and 2^-8 x max|plain|, and
    the largest error in bf16 ulps where |plain| >= 2^-8 x max|plain|."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err, top = float(diff.max()), float(w.abs().max())
    mag = w.abs().clamp_min(2.0 ** -133)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bad = int(((diff > 2 * ulp) & (diff > 2.0 ** -8 * top)).sum())
    big = w.abs() >= 2.0 ** -8 * top
    return err, top, bad, float((diff / ulp)[big].max())


def bwd_agree(torch, label, got, want):
    """Hold one gradient of the backward kernel to the plain version's:
    float32 within 1e-5 x max|plain|; bf16 each element within 2 bf16 ulps
    of the plain value or within 2^-8 x max|plain| (near zero, where the
    ulp is tinier than the sums' rounding), and within 2 bf16 ulps wherever
    |plain| >= 2^-8 x max|plain| (where P or dS rounded once to bf16, not
    passed as hi + lo halves, moves elements by tens of ulps).  Returns
    max|got - want|."""
    err, top, bad, ulps = bwd_errors(torch, got, want)
    if want.dtype == torch.bfloat16:
        print(f"[flash-bwd] {label}: max|d| = {err:.3e} (max|plain| "
              f"{top:.3e}); {ulps:.2f} bf16 ulps at most where |plain| >= "
              f"2^-8 max (need <= 2); {bad} elements outside both bounds "
              f"(need 0)")
        check(bad == 0, f"{label}: {bad} elements beyond 2 bf16 ulps and "
                        f"2^-8 x max|plain|")
        check(ulps <= 2.0, f"{label}: {ulps} bf16 ulps where |plain| >= "
                           f"2^-8 x max|plain|")
    else:
        print(f"[flash-bwd] {label}: max|d| = {err:.3e} = "
              f"{err / max(top, 1e-30):.3e} x max|plain| (need <= 1e-5)")
        check(err <= 1e-5 * top, f"{label}: max|d| {err} > 1e-5 x {top}")
    return err


def flash_bwd_vs_plain(torch):
    """Phase 16: the backward kernel against its plain version on the same
    CUDA inputs, each case twice for bit-identity; the forward's LSE
    against the plain LSE; the autograd Function against torch.autograd
    through the plain forward.  Returns the largest error and the main
    case's inputs."""
    from repro_torch.kernels.flash_attention import (
        FlashAttention, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(16)
    bf16, f32 = torch.bfloat16, torch.float32

    def normal(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    worst, main = 0.0, None
    for label, B, S, H, KV, D, window, causal, dt in BWD_CASES:
        dt = {"bf16": bf16, "f32": f32}[dt]
        q = normal(B, S, H, D, dtype=dt)
        k, v = normal(B, S, KV, D, dtype=dt), normal(B, S, KV, D, dtype=dt)
        dout = normal(B, S, H, D, dtype=dt)
        opts = dict(causal=causal, window=window)
        out, lse = flash_attention(q, k, v, return_lse=True, **opts)
        _, lse_plain = flash_attention_plain(q, k, v, return_lse=True,
                                             **opts)
        d_lse = float((lse - lse_plain).abs().max())
        # float32: 1e-5; bf16 at D = 256 (the forward's LSE there has no
        # other check): 1e-5 of the largest |LSE|, both being float sums
        # of the same bf16 products in other orders
        lse_tol = 1e-5 if dt == f32 else (
            1e-5 * max(1.0, float(lse_plain.abs().max())) if D == 256
            else None)
        print(f"[flash-bwd] {label} {tuple(q.shape)} KV {KV} window "
              f"{window} causal {causal} {dt}: forward LSE max|d| = "
              f"{d_lse:.3e}"
              + ("" if lse_tol is None else f" (need <= {lse_tol:.3e})"))
        if lse_tol is not None:
            check(d_lse <= lse_tol, f"{label}: LSE differs by {d_lse}")
        args = (q, k, v, out, lse, dout)
        got = flash_attention_bwd(*args, **opts)
        again = flash_attention_bwd(*args, **opts)
        torch.cuda.synchronize()
        want = flash_attention_bwd_plain(*args, **opts)
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        print(f"[flash-bwd] {label}: two runs bit-identical {same}")
        check(same, f"{label}: the backward kernel is not deterministic")
        for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            worst = max(worst, bwd_agree(torch, f"{label} {name}", g_, w_))
        del want
        if label == "smollm train":
            main = (args, window)
    # the autograd Function against torch.autograd through the plain forward
    q = normal(2, 512, 9, 64, dtype=f32).requires_grad_()
    k = normal(2, 512, 3, 64, dtype=f32).requires_grad_()
    v = normal(2, 512, 3, 64, dtype=f32).requires_grad_()
    dout = normal(2, 512, 9, 64, dtype=f32)
    before = flash_attention_bwd.launches
    got = torch.autograd.grad(FlashAttention.apply(q, k, v, True, 0, None),
                              (q, k, v), dout)
    check(flash_attention_bwd.launches == before + 1,
          "the autograd Function did not launch the backward kernel")
    want = torch.autograd.grad(flash_attention_plain(q, k, v), (q, k, v),
                               dout)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        bwd_agree(torch, f"autograd Function vs autograd of the plain "
                         f"forward {name}", g_, w_)
    torch.cuda.empty_cache()
    return worst, main


def vision_attention_phase(torch, smi):
    """Phase 24 (see the module docstring).  Returns the launch counts of
    the autograd run and the forward's and backward's entries for the
    kernel line (errors, times, bound, library)."""
    import torch.nn.functional as F
    from perfbench.harness import yardstick
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    lengths = [4 * h * w for h, w in P24_CELLS]
    T, H, D = sum(lengths), P24_HEADS, P24_D
    seg = torch.tensor(np.cumsum([0, *lengths]), dtype=torch.int32,
                       device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(24)
    q, k, v, dout = (torch.randn((1, T, H, D), generator=gen,
                                 device="cuda").bfloat16()
                     for _ in range(4))
    opts = dict(causal=False, segments=seg)
    fns = (flash_attention, flash_attention_bwd)

    # the tower's call under autograd, its launches counted alone
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    zero_counts(fns)
    out_ag = ops.attention(qg, kg, vg, **opts)
    grads_ag = torch.autograd.grad(out_ag, (qg, kg, vg), dout)
    torch.cuda.synchronize()
    launches = counts(fns)
    print(f"[vision-attn] {len(lengths)} images, {T} patches, H {H}, D {D}: "
          f"autograd launches {launches}")
    check(launches == {"flash_attention": 1, "flash_attention_bwd": 1},
          f"the tower's attention launched {launches}, expected one "
          f"forward and one backward")

    out, lse = flash_attention(q, k, v, return_lse=True, **opts)
    args = (q, k, v, out, lse, dout)
    got = flash_attention_bwd(*args, **opts)
    again = flash_attention_bwd(*args, **opts)
    torch.cuda.synchronize()
    check(torch.equal(out_ag, out) and all(
        torch.equal(a, b) for a, b in zip(grads_ag, got)),
        "the autograd Function's output or gradients differ from the "
        "kernels' direct calls")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "the segmented backward is not deterministic")
    # held to the plain versions; the failures are checked after the
    # timings, so that a failing run still prints them
    out_plain, lse_plain = flash_attention_plain(q, k, v, return_lse=True,
                                                 **opts)
    want = flash_attention_bwd_plain(*args, **opts)
    d_lse = float((lse - lse_plain).abs().max())
    print(f"[vision-attn] LSE max|d| = {d_lse:.3e} (need <= 1e-4)")
    fails = [] if d_lse <= 1e-4 else [f"LSE differs by {d_lse}"]
    errs = {}
    for name, g_, w_ in zip(("out", "dq", "dk", "dv"), (out, *got),
                            (out_plain, *want)):
        err, top, bad, ulps = bwd_errors(torch, g_, w_)
        errs[name] = err
        print(f"[vision-attn] {name}: max|d| = {err:.3e} (max|plain| "
              f"{top:.3e}); {ulps:.2f} bf16 ulps at most where |plain| >= "
              f"2^-8 max (need <= 2); {bad} elements outside both bounds "
              f"(need 0)")
        if bad or ulps > 2.0:
            fails.append(f"{name}: {bad} elements outside both bounds, "
                         f"{ulps} bf16 ulps")
    del out_ag, grads_ag, again, want, out_plain, lse_plain, qg, kg, vg

    # SDPA over the images padded to the longest, keys masked past each
    # image's end
    n, L = len(lengths), max(lengths)

    def padded(x):
        y = x.new_zeros((n, L, H, D))
        for i, (a, b) in enumerate(zip(seg[:-1].tolist(), seg[1:].tolist())):
            y[i, :b - a] = x[0, a:b]
        return y.transpose(1, 2).detach().requires_grad_()

    qp, kp, vp = padded(q), padded(k), padded(v)
    keep = (torch.arange(L, device="cuda")[None, :]
            < torch.tensor(lengths, device="cuda")[:, None])[:, None, None]
    lib_out = F.scaled_dot_product_attention(qp, kp, vp, attn_mask=keep)
    dout_p = padded(dout).detach()
    fwd = {
        "ms": graph_ms(torch, [lambda: flash_attention(
            q, k, v, return_lse=True, **opts)] * 3),
        "plain_ms": cuda_ms(torch, lambda: flash_attention_plain(
            q, k, v, return_lse=True, **opts)),
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qp, kp, vp, attn_mask=keep)),
        "bound_ms": 1e3 * yardstick.flash_fwd_segments_bound_s(
            lengths, H, H, D, causal=False, lse=True),
        "max_abs_err": errs["out"]}
    bwd = {
        "ms": graph_ms(torch, [lambda: flash_attention_bwd(
            *args, **opts)] * 3),
        "plain_ms": cuda_ms(torch, lambda: flash_attention_bwd_plain(
            *args, **opts)),
        "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qp, kp, vp), dout_p, retain_graph=True)),
        "bound_ms": 1e3 * yardstick.flash_bwd_segments_bound_s(
            lengths, H, H, D, causal=False),
        "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"])}
    pairs = yardstick.segment_pairs(lengths, causal=False)
    for label, r, per_pair in (("forward", fwd, 4), ("backward", bwd, 10)):
        ops_ms = 1e3 * (per_pair * D * pairs * H / yardstick.PEAK_FLOPS)
        r["bound_by"] = ("operations" if ops_ms >= r["bound_ms"] * (1 - 1e-9)
                         else "bytes")
        print(f"[vision-attn] {label}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, SDPA padded {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms (share "
              f"{r['bound_ms'] / r['ms']:.1%}); card {smi}")
    del qp, kp, vp, lib_out, dout_p
    torch.cuda.empty_cache()
    check(not fails, f"the segmented D-{D} pair against its plain "
                     f"versions: {fails}")
    return launches, {"flash_attention": fwd, "flash_attention_bwd": bwd}


def bwd_rounding_study(torch, smi):
    """``--bwd-rounding``: phase 16's bf16 cases and the training shape's
    timing for each FLASH_BWD_LO setting of flash_attention_bwd.cu (see
    the module docstring).  Returns the rows it prints as JSON."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    settings = {3: "P and dS as hi + lo", 2: "P rounded once",
                1: "dS rounded once", 0: "P and dS rounded once"}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(settings)) as pool:
        built = dict(zip(settings, pool.map(
            lambda n: _build.build("flash_attention_bwd",
                                   (f"-DFLASH_BWD_LO={n}",)), settings)))
    print(f"[bwd-rounding] built {len(built)} settings in "
          f"{time.perf_counter() - t0:.1f} s")
    for n, (_, log) in built.items():
        spills = [line.strip() for line in log.splitlines()
                  if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
        print(f"[bwd-rounding] FLASH_BWD_LO={n} spills: {spills or 'none'}")
    libs = {n: FA.bind_bwd(ctypes.CDLL(str(path)))
            for n, (path, _) in built.items()}

    gen = torch.Generator(device="cuda").manual_seed(16)
    cases = []
    for label, B, S, H, KV, D, window, causal, dt in BWD_CASES:
        if dt != "bf16":
            continue
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                         .bfloat16() for shape in ((B, S, H, D), (B, S, KV, D),
                                                   (B, S, KV, D), (B, S, H, D)))
        opts = dict(causal=causal, window=window)
        out, lse = FA.flash_attention(q, k, v, return_lse=True, **opts)
        args = (q, k, v, out, lse, dout)
        cases.append((label, args, opts,
                      FA.flash_attention_bwd_plain(*args, **opts)))
    (q, k, v, out, lse, dout), opts = cases[0][1], cases[0][2]
    check(cases[0][0] == "smollm train", "the training shape comes first")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    sdpa_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True))
    del lib_out

    rows, real = [], FA._bwd_library
    try:
        for n, lib in libs.items():
            FA._bwd_library = lambda lib=lib: lib
            row = {"FLASH_BWD_LO": n, "rounding": settings[n], "cases": {}}
            for label, args, copts, want in cases:
                got = FA.flash_attention_bwd(*args, **copts)
                errs = {}
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    _, _, bad, ulps = bwd_errors(torch, g, w)
                    errs[name] = {"ulps": ulps, "outside_both": bad}
                row["cases"][label] = errs
                print(f"[bwd-rounding] FLASH_BWD_LO={n} {label}: " + ", ".join(
                    f"{k_} {e['ulps']:.2f} ulps / {e['outside_both']} outside"
                    for k_, e in errs.items()))

            def call():
                FA.flash_attention_bwd(q, k, v, out, lse, dout, **opts)

            row["ms"] = graph_ms(torch, [call] * 3)
            reps = 5
            _, _, prof = profile_window(
                torch, lambda: [call() for _ in range(reps)])
            for kname in ("dq_wgmma_kernel", "dkdv_wgmma_kernel"):
                row[f"{kname}_ms"] = sum(
                    ms for name, ms, _ in prof if kname in name) / reps
            row["sdpa_bwd_ms"] = sdpa_ms
            print(f"[bwd-rounding] FLASH_BWD_LO={n} ({settings[n]}) at "
                  f"{tuple(q.shape)}: {row['ms']:.4f} ms a call (profiler: "
                  f"dq kernel {row['dq_wgmma_kernel_ms']:.4f} ms, dk/dv "
                  f"kernel {row['dkdv_wgmma_kernel_ms']:.4f} ms); SDPA "
                  f"backward {sdpa_ms:.4f} ms; card {smi}")
            rows.append(row)
    finally:
        FA._bwd_library = real
    return rows


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def schedule_replay(tc, *, total_steps, sim_hours_per_step, preemption_seed,
                    device):
    """The trainer's checkpoint and preemption bookkeeping with no model:
    the same ``CheckpointManager`` and ``PreemptionSource`` at the same
    seeds, fed the same simulated step times, saving a one-element tree.
    Returns the counts ``TrainResult`` reports."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import distributions
    from repro_torch.fault import PreemptionSource
    dist = distributions.constrained_for(tc.vm_type)
    mgr = CheckpointManager(
        directory=tc.ckpt_dir, dist=dist, policy=tc.ckpt_policy,
        delta_hours=tc.ckpt_cost_hours, step_time_hours=sim_hours_per_step,
        total_steps=total_steps, async_write=tc.async_checkpoint,
        device=device)
    src = PreemptionSource(dist, n_pods=1, seed=preemption_seed,
                           device=device)
    tree = {"x": torch.zeros(1)}
    step = restarts = wasted = steps_run = 0
    sim_now = 0.0
    while step < total_steps:
        step += 1
        steps_run += 1
        sim_now += sim_hours_per_step
        mgr.observe_step_time(sim_hours_per_step * 3600.0)
        if mgr.should_checkpoint(step):
            mgr.save(step, tree)
        if src.poll(sim_now):
            mgr.on_preemption_warning(step, tree)
            restarts += 1
            src.replace_pod(0, sim_now)
            _, ckpt_step, _ = mgr.restore(tree)
            wasted += step - ckpt_step
            step = ckpt_step
            mgr.on_restart(pod_age_hours=0.0, resumed_step=step)
    return {"steps_run": steps_run, "restarts": restarts,
            "checkpoints": mgr.n_saved,
            "emergency_checkpoints": mgr.n_emergency, "wasted_steps": wasted}


def training_path(torch, work):
    """Phase 17a: smollm-135m at full width and depth through
    ``launch.train.train`` under simulated preemptions, the launch counts
    of its run, and its schedule against a CPU replay."""
    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dp_recurrence import dp_recurrence
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rglru_scan import linear_recurrence
    from repro_torch.launch.train import train
    cfg = configs.get(TRAIN_ARCH)
    tc = TrainConfig(ckpt_dir=os.path.join(work, "main"),
                     warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    run_kw = dict(total_steps=TRAIN_STEPS, sim_hours_per_step=TRAIN_SIM_H,
                  preemption_seed=TRAIN_PREEMPT_SEED)
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.compute_dtype} compute, remat {cfg.remat}; global batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}; {TRAIN_STEPS} steps at "
          f"sim_hours_per_step {TRAIN_SIM_H}, preemption_seed "
          f"{TRAIN_PREEMPT_SEED}, policy {tc.ckpt_policy}")
    fns = (dp_recurrence, flash_attention, flash_attention_bwd,
           decode_attention, linear_recurrence)
    zero_counts(fns)
    t0 = time.perf_counter()
    res = train(cfg, tc, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                inject_preemptions=True, log_every=10, device="cuda",
                **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(fns)
    written = dir_bytes(tc.ckpt_dir)
    n = res.steps_run
    print(f"[train] {n} steps in {wall:.1f} s; restarts {res.restarts}, "
          f"checkpoints {res.checkpoints} ({res.emergency_checkpoints} "
          f"emergency), wasted steps {res.wasted_steps}; {written} bytes "
          f"of checkpoints written; launches {launches}")
    print(f"[train] losses: {[round(x, 4) for x in res.losses]}")
    check(all(np.isfinite(res.losses)), "a training loss is not finite")
    first, last = np.mean(res.losses[:10]), np.mean(res.losses[-10:])
    print(f"[train] mean of the first 10 losses {first:.4f}, of the last 10 "
          f"{last:.4f}")
    check(n >= 20 and last < first, "the loss did not fall")
    check(res.restarts >= 1, "no preemption fell in the run")
    check(res.checkpoints - res.emergency_checkpoints >= 2,
          "fewer than two DP checkpoints")
    check(launches["dp_recurrence"] >= 1,
          "the CheckpointManager did not launch dp_recurrence")
    per_step_fwd = 2 * cfg.n_layers if cfg.remat else cfg.n_layers
    print(f"[train] flash forward launches {launches['flash_attention']} = "
          f"{n} steps x {per_step_fwd} (forward + remat recompute of "
          f"{cfg.n_layers} layers); backward {launches['flash_attention_bwd']}"
          f" = {n} x {cfg.n_layers}")
    check(launches["flash_attention_bwd"] == n * cfg.n_layers,
          "flash_attention_bwd did not launch once a layer a step")
    check(launches["flash_attention"] == n * per_step_fwd,
          "the flash forward's launches do not match remat")
    check(launches["decode_attention"] == 0
          and launches["linear_recurrence"] == 0,
          "the training path launched a serving kernel")
    replay = schedule_replay(
        dataclasses.replace(tc, ckpt_dir=os.path.join(work, "replay")),
        device="cpu", **run_kw)
    got = {k: getattr(res, k) for k in replay}
    print(f"[train] CPU replay of the schedule (no model): {replay}")
    check(got == replay, f"the run's schedule {got} differs from the CPU "
                         f"replay's {replay}")
    shutil.rmtree(tc.ckpt_dir)
    return launches, {"train_wall_s": wall, "steps_run": n,
                      "restarts": res.restarts,
                      "checkpoints": res.checkpoints,
                      "emergency_checkpoints": res.emergency_checkpoints,
                      "checkpoint_bytes": written,
                      "losses_first10_mean": first,
                      "losses_last10_mean": last}


def replay_and_cpu(torch, work):
    """Phases 17b-c: a clean and a preempted run at 3 layers end with
    bit-identical parameters on the card; the card against the port on the
    CPU in float32."""
    import copy
    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=3)
    kw = dict(total_steps=REPLAY_STEPS, seq_len=REPLAY_SEQ,
              global_batch=TRAIN_BATCH, verbose=False, device="cuda")
    tc = TrainConfig(ckpt_dir=os.path.join(work, "clean"), warmup_steps=5,
                     total_steps=REPLAY_STEPS)
    clean = train(cfg, tc, **kw)
    bumpy = train(cfg, dataclasses.replace(
        tc, ckpt_dir=os.path.join(work, "bumpy")), inject_preemptions=True,
        sim_hours_per_step=TRAIN_SIM_H, preemption_seed=TRAIN_PREEMPT_SEED,
        **kw)
    same = all(bool(torch.equal(a, b)) for a, b in
               zip(clean.model.parameters(), bumpy.model.parameters()))
    print(f"[replay] 3 layers, {REPLAY_STEPS} steps of {TRAIN_BATCH} x "
          f"{REPLAY_SEQ}: preempted run restarts {bumpy.restarts}, "
          f"checkpoints {bumpy.checkpoints}; final parameters bit-identical "
          f"to the clean run's {same}; losses equal "
          f"{bumpy.losses == clean.losses}")
    check(bumpy.restarts >= 1, "the replay run saw no preemption")
    check(same, "a preempted run does not replay a clean one to the bit")
    del clean, bumpy
    shutil.rmtree(os.path.join(work, "clean"))
    shutil.rmtree(os.path.join(work, "bumpy"))

    # 17c: the card against the port on the CPU, float32
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = T.init(cfg32, torch.Generator().manual_seed(0), device="cpu",
                 trainable=True)
    gpu = copy.deepcopy(cpu).to("cuda")
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=256,
                       global_batch=2, seed=0, device="cpu")
    batches = [pipe.batch(i) for i in range(3)]
    worst = 0.0
    grads = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        b = {k: v.to(dev) for k, v in batches[0].items()}
        loss, _ = T.lm_loss(model, b)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for (name, _), gc, gg in zip(cpu.named_parameters(), *grads):
        rel = float((gg.cpu() - gc).abs().max() / gc.abs().max())
        worst = max(worst, rel)
        check(rel <= 1e-4, f"card vs CPU grad {name}: relative error {rel}")
    tc32 = TrainConfig(warmup_steps=1, total_steps=3)
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        step_fn = steps.make_train_step(cfg32, tc32)
        opt = adamw_init(dict(model.named_parameters()))
        out = []
        for b in batches:
            _, opt, m = step_fn(model, opt, {k: v.to(dev)
                                             for k, v in b.items()})
            out.append(float(m["loss"]))
        losses.append(out)
    print(f"[card-vs-cpu] 3 layers, float32, B 2, S 256: losses cpu "
          f"{losses[0]}, card {losses[1]}; first-step grads worst relative "
          f"error {worst:.3e} (need <= 1e-4)")
    check(np.allclose(losses[1], losses[0], rtol=1e-5, atol=0),
          "card vs CPU losses differ beyond rtol 1e-5")


def training_timing(torch, bwd_inputs, smi, work):
    """Phase 17d: the train step's time, throughput and memory, its model
    FLOPs, the flash pair's kernel times beside their plain versions,
    bounds and SDPA, the manager's solve / plan / save / restore, and one
    step under torch.profiler."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import distributions
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = configs.get(TRAIN_ARCH)
    tc = TrainConfig(warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    model = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                   device="cuda", trainable=True)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    step_fn = steps.make_train_step(cfg, tc)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH, seed=0,
                        device="cuda").batch(0)
    box = {"opt": opt}

    def one_step():
        _, box["opt"], box["m"] = step_fn(model, box["opt"], batch)

    step_ms = host_ms(torch, one_step)
    torch.cuda.reset_peak_memory_stats()
    one_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in params.values())
    check(n_params == cfg.active_param_count(), "smollm: parameter count")
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    D, H = cfg.head_dim, cfg.n_heads
    flops, attn_flops = train_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    timing = {"train_step_ms": step_ms,
              "tokens_per_s": tokens / (step_ms / 1e3),
              "peak_device_bytes": peak, "params": n_params,
              "model_flops_per_step": flops,
              "attention_flops_per_step": attn_flops,
              "bf16_tensor_peak_share": flops / (step_ms / 1e3)
              / BF16_TENSOR_OPS}

    # the flash pair at the training shape (phase 16's main inputs)
    (q, k, v, out, lse, dout), window = bwd_inputs
    B, S, _, _ = q.shape
    KV = k.shape[2]
    fwd, bwd = flash_pair_times(torch, q, k, v, out, lse, dout, window)
    # the float32 kernels' arithmetic on the CUDA cores: the forward's 4 D a
    # pair, the backward's 14 D (S and dP in both of its kernels)
    fwd["fp32_bound_ms"] = fwd["ops"] / fp32_peak_ops(torch)[0] * 1e3
    bwd["fp32_bound_ms"] = 14 * D * pairs * B * H \
        / fp32_peak_ops(torch)[0] * 1e3
    issued = BWD_ISSUED_OPS_PER_PAIR * D * pairs * B * H
    for name, r in (("flash_attention (train, with LSE)", fwd),
                    ("flash_attention_bwd", bwd)):
        print(f"[timing] {name} at {tuple(q.shape)} KV {KV}: {r['ms']:.4f} "
              f"ms, plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f}"
              f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{r['ops']:.4g} ops, {r['bytes']:.4g} B); the float32 "
              f"kernel's CUDA-core bound {r['fp32_bound_ms']:.4f} ms")
    print(f"[timing] flash_attention_bwd bf16 issues "
          f"{BWD_ISSUED_OPS_PER_PAIR} D tensor-core operations a "
          f"visible pair ({issued:.4g}, {issued / BF16_TENSOR_OPS * 1e3:.4f}"
          f" ms at the bf16 tensor peak) against the bound's 10 D; share "
          f"of bound {bwd['bound_ms'] / bwd['ms']:.2%}")
    timing["flash_fwd_ms"], timing["flash_bwd_ms"] = fwd["ms"], bwd["ms"]

    # the manager: the DP solve (and its first plan), one plan's host read
    # of K, a blocking save and a restore of the full training state
    dist = distributions.constrained_for(tc.vm_type)
    mgr = CheckpointManager(
        directory=os.path.join(work, "timing"), dist=dist, policy="dp",
        delta_hours=tc.ckpt_cost_hours, step_time_hours=TRAIN_SIM_H,
        total_steps=TRAIN_STEPS, async_write=False, device="cuda")

    def resolve():
        mgr._tables = None
        mgr._recompute()

    state = {"params": params, "opt": box["opt"]}
    timing["dp_solve_and_plan_ms"] = host_ms(torch, resolve)
    timing["plan_ms"] = host_ms(torch, mgr._plan_next)
    timing["checkpoint_save_ms"] = host_ms(torch, lambda: mgr.save(1, state))
    timing["checkpoint_restore_ms"] = host_ms(torch,
                                              lambda: mgr.restore(state))
    timing["checkpoint_bytes"] = dir_bytes(os.path.join(work, "timing"))
    shutil.rmtree(os.path.join(work, "timing"))

    wall, dev_ms, rows = profile_window(torch, one_step)
    timing["step_profiled_wall_ms"] = wall
    timing["step_device_ms"] = dev_ms
    timing["step_device_busy_share"] = None if dev_ms is None \
        else dev_ms / wall
    print(f"[profile] train step: wall {wall:.2f} ms, device busy "
          f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms; device "
          f"events:")
    for name, ms, calls in rows:
        print(f"[profile] train   {ms:9.3f} ms  {calls:5d} x  {name}")
    timing["card"] = smi
    print("[timing] training " + json.dumps(timing))
    return {"flash_attention": fwd, "flash_attention_bwd": bwd}


# ---------------------------------------------------------------------------
# the sweep modes and Fig. 7
# ---------------------------------------------------------------------------

def modes_phase(torch, dp_recurrence, sweep_kw):
    """Phase 18a: the main path's sweep in each mode, every DP launch
    recorded; the serial mode's tables against the batched solve's, the
    rows of the three modes, and the host reference loop against the card's
    executor on the serial mode's pool.  Returns the launches per mode."""
    from repro_torch.core import engine, scenarios
    from repro_torch.core.policies import checkpointing
    from repro_torch.core.policies import young_daly as yd
    grid = scenarios.default_grid()
    rows, launches, recs = {}, {}, {}
    for mode in MODE_LAUNCHES:
        dp_recurrence.launches = 0
        with recorded_launches(dp_recurrence) as rec:
            rows[mode] = scenarios.sweep_checkpointing(grid, mode=mode,
                                                       **sweep_kw)
        torch.cuda.synchronize()
        launches[mode], recs[mode] = dp_recurrence.launches, rec.calls
    print(f"[modes] dp_recurrence launches {launches} (need "
          f"{MODE_LAUNCHES})")
    check(launches == MODE_LAUNCHES, f"sweep modes: launches {launches}")
    V8, K8 = recs["batched"][0][2]
    check(tuple(V8.shape[:2]) == (len(grid), J_MAIN + 1),
          f"batched solve shape {tuple(V8.shape)}")
    same = [bool(torch.equal(V[0], V8[s])) and bool(torch.equal(K[0], K8[s]))
            for s, (_, _, (V, K)) in enumerate(recs["serial"])]
    Vg, Kg = recs["grouped"][0][2]
    print(f"[modes] serial {tuple(recs['serial'][0][2][0].shape)} tables "
          f"bit-identical to the batched {tuple(V8.shape)} solve's "
          f"scenario: {same}; grouped "
          f"solve equal {bool(torch.equal(Vg, V8) and torch.equal(Kg, K8))}")
    check(all(same), "sweep modes: a serial table differs from the batched "
                     "solve's")
    check(bool(torch.equal(Vg, V8)) and bool(torch.equal(Kg, K8)),
          "sweep modes: the grouped solve differs from the batched one")
    for mode in ("serial", "grouped"):
        check(same_rows(rows[mode], rows["batched"]),
              f"sweep modes: {mode} rows differ from the batched rows")
    check(all(np.isfinite(r["makespan_mean"]) and r["unfinished_frac"] == 0
              for r in rows["batched"]), "sweep modes: unfinished rows")
    print(f"[modes] {len(rows['batched'])} rows identical in every field "
          f"across serial, grouped and batched")

    # the host reference loop on the serial mode's own pool (scenario 0,
    # seed 0), its first REF_TRIALS trials
    dist = grid[0].dist()
    V0, K0 = (x[0] for x in recs["serial"][0][2])
    tab0 = checkpointing.DPTables(V=V0, K=K0, grid_dt=DT_MAIN,
                                  delta_steps=DELTA, restart_overhead=0.0,
                                  horizon_idx=V0.shape[1] - 1)
    first, pool = engine.draw_lifetime_pool(
        checkpointing.model_lifetimes_fn(dist, device="cuda"), N_TRIALS,
        max_restarts=MAX_RESTARTS, seed=SEEDS[0])
    tau = float(yd.interval(DELTA * DT_MAIN, yd.mttf_from_initial_rate(dist)))
    tau_steps = max(1, int(round(tau / DT_MAIN)))
    policies = {
        "dp": (engine.dp_policy_table(tab0),
               checkpointing.dp_policy_fn(tab0)),
        "young_daly": (engine.young_daly_policy_table(tau_steps, J_MAIN),
                       checkpointing.young_daly_policy_fn(tau, DT_MAIN)),
        "none": (engine.no_checkpoint_policy_table(J_MAIN),
                 checkpointing.no_checkpoint_policy_fn())}
    kw = dict(grid_dt=DT_MAIN, delta_steps=DELTA, max_restarts=MAX_RESTARTS)
    for name, (table, fn) in policies.items():
        mk = engine.simulate_makespan_batch(table, J_MAIN, first=first,
                                            pool=pool, unfinished="partial",
                                            device="cuda", **kw)
        ref = checkpointing.simulate_makespan(
            fn, None, J_MAIN, pool=pool[:REF_TRIALS], first=first[:REF_TRIALS],
            **kw)
        same = np.array_equal(mk[:REF_TRIALS], ref)
        print(f"[modes] {grid[0].name} seed {SEEDS[0]} {name}: card executor "
              f"bit-identical to checkpointing.simulate_makespan on "
              f"{REF_TRIALS} trials {same} (mean {ref.mean():.6f} h)")
        check(same, f"sweep modes: {name} makespans differ from the host "
                    f"reference loop")
    return launches


def fig7_phase(torch, dp_recurrence, dp_recurrence_plain):
    """Phase 18b: Fig. 7 through the port's API (after
    ``benchmarks/fig7_checkpointing.py``): the J = 720 solve against the
    plain version, the schedule, and every Fig. 7a / 7b cell through
    ``simulate_makespan_engine`` against the host reference loop and the
    CPU executor.  Returns the DP launches of the solve."""
    from repro_torch.core import distributions, engine
    from repro_torch.core.policies import checkpointing
    from repro_torch.core.policies import young_daly as yd
    dist = distributions.constrained_for("n1-highcpu-16")
    solve_kw = dict(grid_dt=DT_MAIN, delta_steps=DELTA, n_sweeps=N_SWEEPS,
                    device="cuda")
    dp_recurrence.launches = 0
    with recorded_launches(dp_recurrence) as rec:
        tables = checkpointing.solve(dist, FIG7_J, **solve_kw)
    torch.cuda.synchronize()
    n = dp_recurrence.launches
    args, kw, (Vk, Kk) = rec.calls[0]
    Vp, Kp = dp_recurrence_plain(*args, **kw)
    torch.cuda.synchronize()
    max_dv = float((Vk - Vp).abs().max())
    k_agree = float((Kk == Kp).double().mean())
    bits = bool(torch.equal(Vk, Vp)) and bool(torch.equal(Kk, Kp))
    print(f"[fig7] solve: {n} launch(es) of shape {tuple(Vk.shape)}; against "
          f"dp_recurrence_plain max|dV| = {max_dv:.3e}, K agreement = "
          f"{k_agree:.6f} (need V allclose 1e-5 and K >= 0.999), "
          f"bit-identical {bits}")
    T = int(round(distributions.DEADLINE_HOURS / DT_MAIN)) + 1
    check(n == 1 and tuple(Vk.shape) == (1, FIG7_J + 1, T),
          f"fig7: {n} launches of shape {tuple(Vk.shape)}")
    check(bool(torch.allclose(Vk, Vp, rtol=1e-5, atol=1e-5)),
          "fig7: V differs from the plain version beyond 1e-5")
    check(k_agree >= 0.999, f"fig7: K agreement {k_agree} < 0.999")
    sched = checkpointing.extract_schedule(tables, round(5 / DT_MAIN), 0)
    print(f"[fig7] DP schedule of a 5 h job from age 0, minutes: "
          f"{'/'.join(str(round(i * DT_MAIN * 60)) for i in sched)} (paper "
          f"{'/'.join(map(str, FIG7_PAPER_SCHEDULE))})")

    lf = checkpointing.model_lifetimes_fn(dist, device="cuda")
    lf_cpu = checkpointing.model_lifetimes_fn(dist, device="cpu")
    tau = float(yd.interval(DT_MAIN, 1.0))
    tau_steps = max(1, int(round(tau / DT_MAIN)))
    pol = {"dp": (engine.dp_policy_table(tables),
                  checkpointing.dp_policy_fn(tables)),
           "young_daly": (engine.young_daly_policy_table(tau_steps, FIG7_J),
                          checkpointing.young_daly_policy_fn(tau, DT_MAIN)),
           "none": (engine.no_checkpoint_policy_table(FIG7_J),
                    checkpointing.no_checkpoint_policy_fn())}
    j4 = round(4 / DT_MAIN)
    cells = ([("7a", age, j4, p) for age in FIG7_AGES
              for p in ("dp", "young_daly")]
             + [("7b", 0.0, round(h / DT_MAIN), p) for h in FIG7_HOURS
                for p in ("dp", "young_daly", "none")])
    ex_kw = dict(grid_dt=DT_MAIN, delta_steps=DELTA,
                 max_restarts=MAX_RESTARTS)
    overhead, worst, pools_equal, pool_worst = {}, 0.0, 0, 0.0
    for fig, age, J, p in cells:
        table, fn = pol[p]
        mk = engine.simulate_makespan_engine(
            table, lf, J, start_age=age, n_trials=FIG7_TRIALS, seed=FIG7_SEED,
            device="cuda", **ex_kw)
        first, pool = engine.draw_lifetime_pool(
            lf, FIG7_TRIALS, max_restarts=MAX_RESTARTS, seed=FIG7_SEED,
            start_age=age)
        ref = checkpointing.simulate_makespan(fn, None, J, start_age=age,
                                              pool=pool, first=first, **ex_kw)
        cpu = engine.simulate_makespan_batch(
            table, J, first=first.cpu(), pool=pool.cpu(), start_age=age,
            device="cpu", **ex_kw)
        label = f"fig{fig} {p} age {age:g} h, {J * DT_MAIN:g} h job"
        check(bool(np.isfinite(mk).all()), f"{label}: unfinished trials")
        check(np.array_equal(mk, ref), f"{label}: card makespans differ from "
                                       f"checkpointing.simulate_makespan")
        check(np.array_equal(mk, cpu), f"{label}: card makespans differ from "
                                       f"the CPU executor on the same pool")
        first_c, pool_c = engine.draw_lifetime_pool(
            lf_cpu, FIG7_TRIALS, max_restarts=MAX_RESTARTS, seed=FIG7_SEED,
            start_age=age)
        rel, same = pool_rel_err(torch, (first, pool), (first_c, pool_c),
                                 label)
        pools_equal += same
        pool_worst = max(pool_worst, rel)
        mean = float(mk.mean())
        overhead[fig, age, J, p] = 100.0 * (mean / (J * DT_MAIN) - 1.0)
        if p == "dp":
            v = tables.expected_makespan(J, int(round(age / DT_MAIN)))
            rel = abs(mean - v) / v
            worst = max(worst, rel)
            check(rel < 0.05, f"{label}: mean {mean} vs DP {v}")
    print(f"[fig7] {len(cells)} cells: every makespan finite, bit-identical "
          f"to simulate_makespan and to the CPU executor on the same pool; "
          f"worst |DP mean - V| / V = {worst:.4%}; pools drawn on the CPU "
          f"bit-identical to the card's in {pools_equal} of {len(cells)} "
          f"cells, within {pool_worst:.3e} relative in all (need <= "
          f"{POOL_RTOL})")
    for age in FIG7_AGES:
        print(f"[fig7] 7a overhead, 4 h job from age {age:g} h: dp "
              f"{overhead['7a', age, j4, 'dp']:.2f} %, young_daly "
              f"{overhead['7a', age, j4, 'young_daly']:.2f} %")
    for h in FIG7_HOURS:
        print(f"[fig7] 7b overhead, {h} h job from age 0: " + ", ".join(
            f"{p} {overhead['7b', 0.0, round(h / DT_MAIN), p]:.2f} %"
            for p in ("dp", "young_daly", "none")))
    pred = yd.expected_overhead(DT_MAIN, 1.0, restart_overhead=2 / 60.0)
    print(f"[fig7] Young-Daly model-predicted overhead at MTTF 1 h: "
          f"{100 * pred:.2f} % (paper > 25 %)")
    return n


def modes_timing(torch, sweep_kw, smi):
    """Phase 18c: each mode's wall ms (median of 3 after a warm-up), the
    serial mode's parts (an S = 1 solve, pool draw and executor call) and
    Fig. 7's solve, and one serial sweep under torch.profiler."""
    from repro_torch.core import distributions, engine, scenarios
    from repro_torch.core.policies import checkpointing
    grid = scenarios.default_grid()
    timing = {f"sweep_{mode}_ms": host_ms(
        torch, lambda mode=mode: scenarios.sweep_checkpointing(
            grid, mode=mode, **sweep_kw), reps=3)
        for mode in MODE_LAUNCHES}
    dist0 = grid[0].dist()
    solve_kw = dict(grid_dt=DT_MAIN, delta_steps=DELTA, n_sweeps=N_SWEEPS,
                    device="cuda")
    timing["solve_s1_ms"] = cuda_ms(torch, lambda: checkpointing.solve(
        dist0, J_MAIN, **solve_kw))
    lf = checkpointing.model_lifetimes_fn(dist0, device="cuda")
    pool_kw = dict(max_restarts=MAX_RESTARTS, seed=SEEDS[0])
    timing["pool_draw_s1_ms"] = host_ms(
        torch, lambda: engine.draw_lifetime_pool(lf, N_TRIALS, **pool_kw),
        reps=3)
    first, pool = engine.draw_lifetime_pool(lf, N_TRIALS, **pool_kw)
    table = engine.dp_policy_table(checkpointing.solve(dist0, J_MAIN,
                                                       **solve_kw))
    timing["executor_s1_ms"] = host_ms(
        torch, lambda: engine.simulate_makespan_batch(
            table, J_MAIN, first=first, pool=pool, grid_dt=DT_MAIN,
            delta_steps=DELTA, max_restarts=MAX_RESTARTS, device="cuda"),
        reps=3)
    wall, dev_ms, prof_rows = profile_window(
        torch, lambda: scenarios.sweep_checkpointing(grid, mode="serial",
                                                     **sweep_kw), top=5)
    timing.update(sweep_serial_profiled_wall_ms=wall,
                  sweep_serial_device_ms=dev_ms,
                  sweep_serial_device_busy_share=None if dev_ms is None
                  else dev_ms / wall)
    for name, ms, calls in prof_rows:
        print(f"[profile] serial sweep {ms:9.3f} ms  {calls:5d} x  {name}")
    timing["solve_s8_ms"] = cuda_ms(torch, lambda: checkpointing.solve_batch(
        [sc.dist() for sc in grid], J_MAIN, **solve_kw))
    fig7_dist = distributions.constrained_for("n1-highcpu-16")
    timing["fig7_solve_ms"] = cuda_ms(torch, lambda: checkpointing.solve(
        fig7_dist, FIG7_J, **solve_kw))
    timing["card"] = smi
    print("[timing] sweep modes and fig7 " + json.dumps(timing))
    return timing


# ---------------------------------------------------------------------------
# embeddings input and M-RoPE: musicgen-medium and qwen2-vl-2b, and the two
# 33-34 B dense archs at reduced depth
# ---------------------------------------------------------------------------

def mrope_streams(torch, B, S):
    """(3, B, S) int32 M-RoPE position ids on the card: t = s, h = s // 32,
    w = s % 32, three distinct streams (with equal ones M-RoPE is RoPE)."""
    s = torch.arange(S, dtype=torch.int32, device="cuda")
    return torch.stack([s, s // 32, s % 32])[:, None].expand(3, B, S) \
        .contiguous()


def embeds_batch(torch, cfg, B, S, gen, dtype):
    """A prefill batch of seeded embeddings (B, S, d_model), of the
    embedding table's scale, and (3, B, S) positions under M-RoPE."""
    x = 0.02 * torch.randn((B, S, cfg.d_model), generator=gen,
                           device="cuda")
    batch = {"embeds": x.to(dtype)}
    if cfg.pos_type == "mrope":
        batch["positions"] = mrope_streams(torch, B, S)
    return batch


def recorded_routes(n_alike=0):
    """A patch of ``moe.route`` and ``moe.router_probs`` that keeps, inside
    its ``with`` block, every call's routing and, for the first
    ``n_alike`` calls, how alike the router's inputs are
    (``mean_cosine``).  Returns the patch and the two lists."""
    from unittest import mock

    from repro_torch.models import moe
    calls, alike, real, real_probs = [], [], moe.route, moe.router_probs

    def spy(cfg, probs):
        calls.append(real(cfg, probs))
        return calls[-1]

    def spy_probs(cfg, router, xt):
        if len(alike) < n_alike:
            alike.append(mean_cosine(xt))
        return real_probs(cfg, router, xt)

    return (mock.patch.multiple(moe, route=spy, router_probs=spy_probs),
            calls, alike)


def mean_cosine(xt):
    """The mean cosine between two distinct rows of a group of ``xt`` (G,
    Tg, d), over the groups: a 0-d float32 tensor."""
    u = xt.float()
    u = u / u.norm(dim=-1, keepdim=True)
    n = u.shape[1]
    return ((u.sum(1).square().sum(-1) - n) / (n * (n - 1))).mean()


def random_routing_dropped(torch, cfg, G, Tg, seed=21):
    """The share of (token, k) pairs that capacity drops when each
    token's K experts are drawn uniformly, in ``G`` groups of ``Tg``
    tokens: what routing with no preference would drop."""
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda").manual_seed(seed)
    probs = torch.softmax(torch.rand((G, Tg, cfg.n_experts), generator=gen,
                                     device="cuda"), -1)
    return float((moe.route(cfg, probs).slot < 0).float().mean())


def same_routes(calls, label):
    """The routes recorded on the card against those on the CPU, call by
    call in order: the experts, the kept slots and the capacity must be
    identical.  Returns the number of (token, k) pairs compared."""
    card = [r for r in calls if r.idx.is_cuda]
    cpu = [r for r in calls if not r.idx.is_cuda]
    check(len(card) == len(cpu) > 0,
          f"{label}: {len(card)} routings on the card, {len(cpu)} on the CPU")
    pairs = 0
    for i, (g, c) in enumerate(zip(card, cpu)):
        flipped = int((g.idx.cpu() != c.idx).sum())
        moved = int((g.slot.cpu() != c.slot).sum())
        check(g.capacity == c.capacity and flipped == 0 and moved == 0,
              f"{label}: routing {i} differs between the card and the CPU: "
              f"{flipped} (token, k) pairs chose another expert and {moved} "
              f"another slot (a near-tie between two experts' "
              f"probabilities flipped a route); capacity {g.capacity} / "
              f"{c.capacity}")
        pairs += c.idx.numel()
    return pairs


def moe_floors(cfg, B, S):
    """What an MoE model's serving cannot beat on the card: a decode step
    reads every expert's weights (the capacity buffers hold every expert),
    and a prefill of B x S tokens runs the experts' three products on
    every slot of the buffers.  Returns (expert bytes, decode floor ms,
    prefill expert FLOPs, prefill floor ms)."""
    from repro_torch.models.moe import _group_size
    E, K, d, f = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    expert_bytes = cfg.n_layers * E * 3 * d * f * 2
    T = B * S
    Tg = _group_size(T)
    C = max(int(cfg.capacity_factor * Tg * K / E), 4)
    flops = cfg.n_layers * 2 * E * (T // Tg) * C * d * f * 3
    return (expert_bytes, expert_bytes / HBM_BYTES_PER_S * 1e3, flops,
            flops / BF16_TENSOR_OPS * 1e3)


def phase19_serving(torch, arch, n_layers=None, detail=True,
                    cpu_layers=P19_CPU_LAYERS):
    """Phases 19a and 21a: ``arch`` at full width (and depth, unless
    ``n_layers``) through the port's prefill and decode steps: 8 x 2048
    inputs (seeded bf16 embeddings, and distinct M-RoPE streams, for an
    embeds-input arch; token prompts otherwise), 31 greedy decode steps fed
    back through the embedding table at default positions, with the
    kernels' counts reset just before and read just after.  Checks the
    launches, every logit finite, the peak and decode step 1 against a
    full forward (for an MoE arch on a copy of the config with
    ``capacity_factor = n_experts``, where no pair can drop, at 2 x 256
    prompts; it prints the share of pairs the prefill dropped).  With
    ``detail`` also the serving times, one profiled prefill and, once the
    model is freed, the card against the CPU at ``cpu_layers`` in float32
    (for an MoE arch at the published capacity, routing identical).
    Returns the config, the launches and the numbers."""
    from repro_torch import configs
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dp_recurrence import dp_recurrence
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rglru_scan import linear_recurrence
    from repro_torch.models import transformer as T
    fns = (flash_attention, decode_attention, flash_attention_bwd,
           linear_recurrence, dp_recurrence)
    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    moe = cfg.family == "moe"
    t0 = time.perf_counter()
    model = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                   device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[p19] {arch}: {cfg.n_layers} layers"
          f"{'' if n_layers is None else ' (depth cut)'}, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.mlp_variant}"
          f"{f', {cfg.n_experts} experts, top {cfg.top_k}, capacity factor {cfg.capacity_factor}' if moe else ''}"
          f"), vocab {cfg.vocab_size}, pos {cfg.pos_type}, tied "
          f"{cfg.tie_embeddings}; {n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, drawn "
          f"in {time.perf_counter() - t0:.3f} s")
    check(n_params == cfg.param_count(), f"{arch}: parameter count")
    gen = torch.Generator(device="cuda").manual_seed(19)
    if cfg.embeds_input:
        batch = embeds_batch(torch, cfg, P19_BATCH, P19_PROMPT, gen,
                             torch.bfloat16)
    else:
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (P19_BATCH, P19_PROMPT), generator=gen,
            device="cuda")}

    patch, routes, alike = recorded_routes(
        n_alike=cfg.n_layers if moe else 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    t0 = time.perf_counter()
    with patch:
        logits, toks = greedy_run(torch, model, batch, P19_DECODE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(fns)
    peak = torch.cuda.max_memory_allocated()
    L_ = cfg.n_layers
    want = {"flash_attention": L_, "decode_attention": L_ * (P19_DECODE - 1),
            "flash_attention_bwd": 0, "linear_recurrence": 0,
            "dp_recurrence": 0}
    print(f"[p19] {arch} serving: prefill of {P19_BATCH} x {P19_PROMPT} "
          f"{'embeddings' if cfg.embeds_input else 'tokens'}"
          f"{' with 3 M-RoPE streams' if 'positions' in batch else ''} and "
          f"{P19_DECODE - 1} greedy decode steps in {wall:.2f} s; launches "
          f"{launches}, expected {want}; peak {peak / 1e9:.2f} GB (need <= "
          f"{P19_PEAK_LIMIT / 1e9:.0f})")
    check(launches == want, f"{arch}: launch counts {launches} != {want}")
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{arch}: tokens out of the vocabulary")
    check(peak <= P19_PEAK_LIMIT, f"{arch}: serving peak {peak} passes "
                                  f"{P19_PEAK_LIMIT}")
    out = {"serve_wall_s": wall, "params": n_params,
           "serve_peak_device_bytes": peak}
    if moe:
        prefill = routes[:L_]
        G, Tg = prefill[0].idx.shape[:2]
        check(len(routes) == L_ * P19_DECODE and G * Tg == P19_BATCH
              * P19_PROMPT, f"{arch}: {len(routes)} routings recorded")
        dropped = sum(int((r.slot < 0).sum()) for r in prefill) \
            / sum(r.slot.numel() for r in prefill)
        by_layer = [float((r.slot < 0).float().mean()) for r in prefill]
        alike = [float(a) for a in alike]
        from repro_torch.models.layers import embed
        emb_alike = float(mean_cosine(embed(model.embed, batch["tokens"],
                                            cfg).view(G, Tg, -1)))
        at_random = random_routing_dropped(torch, cfg, G, Tg)
        out.update(prefill_dropped_share=dropped,
                   capacity=prefill[0].capacity,
                   prefill_dropped_by_layer=by_layer,
                   router_input_cosine_by_layer=alike,
                   embedding_cosine=emb_alike,
                   random_routing_dropped=at_random)
        print(f"[p21] {arch} prefill: groups of {Tg} tokens, "
              f"capacity {prefill[0].capacity} a group and expert; "
              f"{dropped:.4%} of the (token, k) pairs dropped at capacity "
              f"factor {cfg.capacity_factor}; uniform random routing "
              f"would drop {at_random:.4%}")
        print(f"[p21] {arch} prefill by layer (dropped share, mean cosine "
              f"of two tokens' router inputs in a group; their embeddings' "
              f"{emb_alike:.4f}): " + ", ".join(
                  f"{i}: {d:.4%} {a:.4f}"
                  for i, (d, a) in enumerate(zip(by_layer, alike))))
        # no drops: capacity = Tg * K, which no expert can exceed
        model.cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts))
        try:
            out["decode_vs_full_max_abs"] = decode_vs_full(
                torch, model, batch["tokens"][:P21_NODROP_B, :P21_NODROP_S],
                LOGIT_TOL_BF16)
        finally:
            model.cfg = cfg
    else:
        out["decode_vs_full_max_abs"] = decode_vs_full(torch, model, batch,
                                                       LOGIT_TOL_BF16)
    del routes
    if not detail:
        del model
        torch.cuda.empty_cache()
        return cfg, launches, out

    # serving times: prefill (time to first token) and decode per step
    times, first_token, decode_rest = serve_times(torch, model, batch,
                                                  P19_DECODE)
    out.update(times)
    wall_p, dev_p, rows_p = profile_window(torch, first_token, top=10)
    tok, cache = first_token()
    wall_d, dev_d, _ = profile_window(torch, lambda: decode_rest(tok, cache))
    out["decode_device_busy_share"] = None if dev_d is None else dev_d / wall_d
    out["prefill_device_busy_share"] = None if dev_p is None \
        else dev_p / wall_p
    out["prefill_top_device_events"] = [(n, round(ms, 3), c)
                                        for n, ms, c in rows_p]
    floors = ""
    if moe:
        nbytes, dec_floor, flops, pre_floor = moe_floors(cfg, P19_BATCH,
                                                         P19_PROMPT)
        out.update(decode_floor_ms=dec_floor, prefill_floor_ms=pre_floor,
                   expert_bytes=nbytes, prefill_expert_flops=flops)
        floors = (f" (floors: decode {dec_floor:.2f} ms, the experts' "
                  f"{nbytes / 1e9:.2f} GB at the memory rate; prefill "
                  f"{pre_floor:.2f} ms, the experts' {flops / 1e12:.2f} "
                  f"TFLOP at the bf16 peak)")
    print(f"[p19] {arch} serving timing: prefill {out['prefill_ms']:.2f} ms, "
          f"decode {out['decode_ms_per_step']:.3f} ms a step "
          f"({out['decode_tokens_per_s']:.1f} tokens/s){floors}; device "
          f"busy share: decode {out['decode_device_busy_share']}, prefill "
          f"{out['prefill_device_busy_share']}; prefill device events:")
    for name, ms, calls in rows_p:
        print(f"[profile] {arch} prefill {ms:9.3f} ms  {calls:5d} x  {name}")
    del model, tok, cache, first_token, decode_rest
    torch.cuda.empty_cache()

    # full width, float32, few layers: the card against the CPU
    cfg2 = dataclasses.replace(cfg, n_layers=cpu_layers,
                               compute_dtype="float32")
    model2 = T.init(cfg2, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    if cfg.embeds_input:
        b2 = embeds_batch(torch, cfg2, 2, 64, gen, torch.float32)
    else:
        b2 = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device="cuda")
    patch, routes, _ = recorded_routes()
    with patch:
        out["card_vs_cpu_max_abs"] = card_vs_cpu(
            torch, model2, b2, 8, f"{arch} {cpu_layers} layers")
    if moe:
        out["card_vs_cpu_route_pairs"] = same_routes(
            routes, f"{arch} {cpu_layers} layers serving")
        print(f"[p21] {arch} {cpu_layers} layers float32: the routing of "
              f"{len(routes) // 2} calls ({out['card_vs_cpu_route_pairs']} "
              f"(token, k) pairs) identical on the card and the CPU")
    del model2, routes
    torch.cuda.empty_cache()
    return cfg, launches, out


def bf16_rerun(torch, cfg, batch, label):
    """Two runs of a step's loss and gradients (``steps.value_and_grad``)
    on ``batch`` with ``cfg`` (bf16 compute, float32 masters) from seeded
    weights: they must be bit-identical."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    model = T.init(cfg, torch.Generator(device="cuda").manual_seed(1),
                   device="cuda", trainable=True)
    runs = [steps.value_and_grad(model, batch) for _ in range(2)]
    same = (bool(torch.equal(runs[0][0], runs[1][0])) and all(
        bool(torch.equal(x, y)) for x, y in zip(runs[0][2], runs[1][2])))
    B, S = batch["labels"].shape
    print(f"[train] {label}: {cfg.n_layers} layers, {cfg.compute_dtype}, "
          f"{B} x {S}: two runs of a step's loss and gradients "
          f"bit-identical {same}")
    check(same, f"{label}: two runs of a bf16 step differ")
    del model, runs
    torch.cuda.empty_cache()
    return same


def phase19_training(torch, arch, n_layers=None, grad_accum=1, n_steps=1,
                     cpu_layers=P19_CPU_LAYERS):
    """Phases 19b and 21b: ``arch`` at full width (and depth, unless
    ``n_layers``) through ``steps.make_train_step`` (bf16 compute, float32
    master weights, remat, ``grad_accum`` microbatches) on 8 x 2048:
    seeded embeddings, labels, a mask and, under M-RoPE, three distinct
    position streams for an embeds-input arch; SyntheticLM batches (one a
    step, ``n_steps``) otherwise.  Checks the launches of the first step
    (counts reset just before, read just after), every loss finite, the
    peak; for an embeds-input arch a ``grad_accum=2`` step; at
    ``cpu_layers``, full width, float32, B 2, S 256 the card's loss and
    gradients against the CPU's (for an MoE arch with identical routing);
    for an MoE arch two bf16 runs of a step at 1 layer, 2 x 2048,
    bit-identical.  Times the step, its peak memory, model FLOPs and busy
    share."""
    import copy
    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dp_recurrence import dp_recurrence
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rglru_scan import linear_recurrence
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    fns = (flash_attention, decode_attention, flash_attention_bwd,
           linear_recurrence, dp_recurrence)
    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    moe = cfg.family == "moe"
    tc = TrainConfig(warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
                     grad_accum=grad_accum)
    model = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                   device="cuda", trainable=True)
    params = dict(model.named_parameters())
    box = {"opt": adamw_init(params)}
    gen = torch.Generator(device="cuda").manual_seed(191)
    B, S = P19_BATCH, P19_PROMPT
    if cfg.embeds_input:
        batch = embeds_batch(torch, cfg, B, S, gen, torch.bfloat16)
        batch["labels"] = torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen, device="cuda")
        batch["mask"] = (torch.rand((B, S), generator=gen, device="cuda")
                         > 0.1).float()
        batches = [batch] * n_steps
    else:
        pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S,
                           global_batch=B, seed=0, device="cuda")
        batches = [pipe.batch(i) for i in range(n_steps)]
    batch = batches[0]
    step_fn = steps.make_train_step(cfg, tc)

    def one_step(fn=step_fn, b=batch):
        _, box["opt"], box["m"] = fn(model, box["opt"], b)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    one_step()
    torch.cuda.synchronize()
    launches = counts(fns)
    L_ = cfg.n_layers
    want = {"flash_attention": 2 * L_ * grad_accum,
            "flash_attention_bwd": L_ * grad_accum,
            "decode_attention": 0, "linear_recurrence": 0,
            "dp_recurrence": 0}
    losses = [float(box["m"]["loss"])]
    for b in batches[1:]:
        one_step(b=b)
        losses.append(float(box["m"]["loss"]))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[p19] {arch} train, {L_} layers, {B} x {S} "
          f"{'embeddings' if cfg.embeds_input else 'tokens'}"
          f"{' with 3 M-RoPE streams' if 'positions' in batch else ''} in "
          f"{grad_accum} microbatch(es): losses "
          f"{[round(x, 4) for x in losses]}, grad norm "
          f"{float(box['m']['grad_norm']):.4f}; first step's launches "
          f"{launches}, expected {want} (forward + remat's recompute, one "
          f"backward a layer, each microbatch); peak {peak / 1e9:.2f} GB "
          f"(need <= {P19_PEAK_LIMIT / 1e9:.0f})")
    check(launches == want, f"{arch}: train launches {launches} != {want}")
    check(all(np.isfinite(losses)), f"{arch}: a loss is not finite")
    check(peak <= P19_PEAK_LIMIT, f"{arch}: the train peak {peak} passes "
                                  f"{P19_PEAK_LIMIT}: raise grad_accum")
    acc_launches = None
    if cfg.embeds_input:
        accum_fn = steps.make_train_step(
            cfg, dataclasses.replace(tc, grad_accum=2))
        zero_counts(fns)
        one_step(accum_fn)
        torch.cuda.synchronize()
        acc_launches = counts(fns)
        acc_loss = float(box["m"]["loss"])
        print(f"[p19] {arch} grad_accum=2 step (microbatches of {B // 2} "
              f"rows{', positions cut along their batch axis' if 'positions' in batch else ''}"
              f"): loss {acc_loss:.4f}; launches {acc_launches}")
        check(np.isfinite(acc_loss), f"{arch}: grad_accum=2 loss not finite")
        check(acc_launches["flash_attention_bwd"] == 2 * L_,
              f"{arch}: grad_accum=2 backward launches {acc_launches}")

    # timing: the step, its model FLOPs, one profiled step
    step_ms = host_ms(torch, one_step)
    tokens = B * S
    n_params = sum(p.numel() for p in params.values())
    flops, _ = train_model_flops(cfg, B, S)
    timing = {"train_step_ms": step_ms,
              "tokens_per_s": tokens / (step_ms / 1e3),
              "peak_device_bytes": peak, "params": n_params,
              "active_params": cfg.active_param_count(), "losses": losses,
              "grad_accum": grad_accum, "model_flops_per_step": flops,
              "bf16_tensor_peak_share": flops / (step_ms / 1e3)
              / BF16_TENSOR_OPS}
    wall, dev_ms, rows = profile_window(torch, one_step, top=8)
    timing["step_device_busy_share"] = None if dev_ms is None \
        else dev_ms / wall
    print(f"[p19] {arch} train step {step_ms:.2f} ms, "
          f"{timing['tokens_per_s']:.0f} tokens/s, "
          f"{timing['bf16_tensor_peak_share']:.2%} of the bf16 tensor peak "
          f"(N = {cfg.active_param_count() / 1e9:.3f} B active of "
          f"{n_params / 1e9:.3f} B); profiled step wall {wall:.2f} ms, "
          f"device busy {dev_ms} ms; device events:")
    for name, ms, calls in rows:
        print(f"[profile] {arch} train {ms:9.3f} ms  {calls:5d} x  {name}")
    del model, params, box, batch, batches
    torch.cuda.empty_cache()

    # full width, float32, few layers: the card against the CPU
    cfg2 = dataclasses.replace(cfg, n_layers=cpu_layers,
                               compute_dtype="float32")
    cpu = T.init(cfg2, torch.Generator().manual_seed(0), device="cpu",
                 trainable=True)
    gpu = copy.deepcopy(cpu).to("cuda")
    if cfg.embeds_input:
        b2 = embeds_batch(torch, cfg2, 2, 256, gen, torch.float32)
    else:
        b2 = {"tokens": torch.randint(0, cfg.vocab_size, (2, 256),
                                      generator=gen, device="cuda")}
    b2["labels"] = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                                 device="cuda")
    b2["mask"] = torch.ones((2, 256), device="cuda")
    patch, routes, _ = recorded_routes()
    with patch:
        got = steps.value_and_grad(gpu, b2)
        want_ = steps.value_and_grad(cpu, {k: v.cpu() for k, v in b2.items()})
    d_loss = abs(float(got[0]) - float(want_[0])) / abs(float(want_[0]))
    worst = 0.0
    for (name, _), gg, gc in zip(cpu.named_parameters(), got[2], want_[2]):
        excess = float(((gg.cpu() - gc).abs()
                        - (1e-6 + 1e-4 * gc.abs())).max())
        worst = max(worst, float(((gg.cpu() - gc).abs()
                                  / (1e-6 + 1e-4 * gc.abs())).max()))
        check(excess <= 0, f"{arch}: card vs CPU grad {name} beyond atol "
                           f"1e-6 + rtol 1e-4")
    print(f"[p19] {arch} {cpu_layers} layers float32, B 2, S 256, card "
          f"vs CPU: loss {float(got[0]):.7f} / {float(want_[0]):.7f} "
          f"(relative {d_loss:.3e}, need <= 1e-6); gradients at worst "
          f"{worst:.3f} of atol 1e-6 + rtol 1e-4")
    check(d_loss <= 1e-6, f"{arch}: card vs CPU loss differs by {d_loss}")
    timing.update(card_vs_cpu_loss_rel=d_loss, card_vs_cpu_grad_worst=worst)
    if moe:
        timing["card_vs_cpu_route_pairs"] = same_routes(
            routes, f"{arch} {cpu_layers} layer training")
        print(f"[p21] {arch} training, {cpu_layers} layer float32: the "
              f"routing of {len(routes) // 2} calls (forward and remat's "
              f"recompute; {timing['card_vs_cpu_route_pairs']} (token, k) "
              f"pairs) identical on the card and the CPU")
    del cpu, gpu, got, want_, routes
    if moe:
        # determinism: dispatch and combine backwards are gathers
        cfg1 = dataclasses.replace(cfg, n_layers=1)
        b1 = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S,
                         global_batch=2, seed=1, device="cuda").batch(0)
        timing["bf16_step_bit_identical"] = bf16_rerun(torch, cfg1, b1, arch)
    torch.cuda.empty_cache()
    return launches, acc_launches, timing


def phase19_kernels(torch, cfg):
    """Phase 19c: the flash forward (with LSE), the flash backward and
    decode attention at ``cfg``'s attention shape (bf16, causal, 8 x 2048,
    decode over a cache of 2048 + 32 slots at length 2049), by CUDA-graph
    replays beside the plain versions, SDPA and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(192)
    B, S, H, KV, D = P19_BATCH, P19_PROMPT, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, dout = normal(B, S, H, D), normal(B, S, H, D)
    k, v = normal(B, S, KV, D), normal(B, S, KV, D)
    out, lse = flash_attention(q, k, v, return_lse=True)
    r = dict(zip(("flash_attention", "flash_attention_bwd"),
                 flash_pair_times(torch, q, k, v, out, lse, dout)))
    del q, k, v, out, lse, dout
    # decode step 1: every row at length S + 1 over a cache of S + 32
    # slots; 4 copies of the cache rotated, as each layer's cache is cold
    Sc = S + P19_DECODE
    lengths = torch.full((B,), S + 1, dtype=torch.int32, device="cuda")
    dec = [(normal(B, H, D), normal(B, Sc, KV, D), normal(B, Sc, KV, D),
            lengths) for _ in range(4)]
    valid = (torch.arange(Sc, device="cuda")[None, :]
             < lengths[:, None])[:, None, None, :]
    lib = [(x[0][:, :, None], x[1].transpose(1, 2), x[2].transpose(1, 2))
           for x in dec]
    n_valid = int(lengths.sum())
    elt = 2
    r["decode_attention"] = with_bound({
        "ms": graph_ms(torch, [lambda x=x: decode_attention(*x)
                               for x in dec]),
        "plain_ms": graph_ms(torch, [lambda x=x: decode_attention_plain(*x)
                                     for x in dec]),
        "library_ms": graph_ms(torch, [
            lambda x=x: F.scaled_dot_product_attention(
                *x, attn_mask=valid, enable_gqa=True) for x in lib]),
        "ops": 4 * D * n_valid * H,
        "bytes": 2 * B * H * D * elt + 2 * n_valid * KV * D * elt
        + lengths.numel() * 4})
    for name, t in r.items():
        print(f"[timing] {cfg.name} {name} (B {B}, S {S}, H {H}, KV {KV}, "
              f"D {D}): {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}: {t['ops']:.4g} ops, {t['bytes']:.4g} B), "
              f"{t['bound_ms'] / t['ms']:.1%} of it")
    del dec, lib
    torch.cuda.empty_cache()
    return r


def embeds_phase(torch, smi):
    """Phase 19: musicgen-medium and qwen2-vl-2b at full width and depth,
    serving and training, and their attention kernels' times; yi-34b and
    deepseek-coder-33b at full width and reduced depth, serving.  Returns
    the launches by path and the kernel times by model."""
    t19 = time.perf_counter()
    by_path, ktimes = {}, {}
    for arch, key in P19_ARCHS:
        cfg, serve_l, serve_t = phase19_serving(torch, arch)
        train_l, accum_l, train_t = phase19_training(torch, arch)
        ktimes[key] = phase19_kernels(torch, cfg)
        by_path[key] = {"serving": serve_l, "training": train_l,
                        "training_grad_accum_2": accum_l}
        print(f"[timing] {arch} " + json.dumps(
            {"serving": serve_t, "training": train_t, "card": smi}))
    for arch, n_layers in P19_DEPTH_CUT:
        _, serve_l, serve_t = phase19_serving(torch, arch, n_layers,
                                              detail=False)
        by_path[arch] = {"serving": serve_l}
        print(f"[timing] {arch} at {n_layers} layers " + json.dumps(
            {"serving": serve_t, "card": smi}))
    print(f"[p19] phase 19 took {time.perf_counter() - t19:.1f} s")
    return by_path, ktimes


def moe_phase(torch, smi):
    """Phase 21: moonshot-v1-16b-a3b (full depth) and phi3.5-moe-42b-a6.6b
    (24 of 32 layers) serving at full width, both training at full width
    and 2 layers, and their attention kernels' times.  Returns the
    launches by path and the kernel times by model."""
    t21 = time.perf_counter()
    by_path, ktimes = {}, {}
    for arch, key, serve_layers, accum, cpu_layers in P21_ARCHS:
        cfg, serve_l, serve_t = phase19_serving(torch, arch, serve_layers,
                                                cpu_layers=cpu_layers)
        train_l, _, train_t = phase19_training(
            torch, arch, P21_TRAIN_LAYERS, grad_accum=accum,
            n_steps=P21_STEPS, cpu_layers=1)
        ktimes[key] = phase19_kernels(torch, cfg)
        by_path[key] = {"serving": serve_l, "training": train_l}
        print(f"[timing] {arch} " + json.dumps(
            {"serving": serve_t, "training": train_t, "card": smi}))
    print(f"[p21] phase 21 took {time.perf_counter() - t21:.1f} s")
    return by_path, ktimes


# ---------------------------------------------------------------------------
# recurrentgemma-2b training
# ---------------------------------------------------------------------------

def rg_train_run(torch):
    """Phase 20a: recurrentgemma-2b at full width and depth through
    ``steps.make_train_step`` (bf16 compute, float32 master weights,
    remat) on SyntheticLM batches of 8 x 2048 in 4 microbatches, 12 steps,
    every launch counter reset just before and read just after.  Returns
    the launches, the run's numbers, the model, its optimizer state box
    and the step function."""
    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dp_recurrence import dp_recurrence
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rglru_scan import (linear_recurrence,
                                                linear_recurrence_bwd)
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = configs.get(P20_ARCH)
    kinds = T.layer_kinds(cfg)
    n_rec, n_att = kinds.count("rglru"), kinds.count("local_attn")
    tc = TrainConfig(warmup_steps=P20_WARMUP, total_steps=P20_STEPS,
                     grad_accum=P20_ACCUM)
    print(f"[p20] {cfg.name}: {cfg.n_layers} layers ({n_rec} rglru, {n_att}"
          f" local_attn, window {cfg.window}), d_model {cfg.d_model}, lru "
          f"width {cfg.lru_width}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV"
          f" of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.compute_dtype} compute, remat {cfg.remat}; global batch "
          f"{P20_BATCH} x {P20_SEQ} in {P20_ACCUM} microbatches, "
          f"{P20_STEPS} steps, warmup {P20_WARMUP}")
    model = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                   device="cuda", trainable=True)
    box = {"opt": adamw_init(dict(model.named_parameters()))}
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=P20_SEQ,
                       global_batch=P20_BATCH, seed=0, device="cuda")
    batches = [pipe.batch(i) for i in range(P20_STEPS)]
    step_fn = steps.make_train_step(cfg, tc)
    fns = (flash_attention, flash_attention_bwd, linear_recurrence,
           linear_recurrence_bwd, decode_attention, dp_recurrence)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    t0 = time.perf_counter()
    losses = []
    for batch in batches:
        _, box["opt"], box["m"] = step_fn(model, box["opt"], batch)
        losses.append(float(box["m"]["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(fns)
    by_kernel = dict(linear_recurrence.launches_by_kernel)
    bwd_by_kernel = dict(linear_recurrence_bwd.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated()
    n_mb = P20_STEPS * P20_ACCUM
    per_mb = {"flash_attention": 2 * n_att, "flash_attention_bwd": n_att,
              "linear_recurrence": 2 * n_rec,
              "linear_recurrence_bwd": n_rec, "decode_attention": 0,
              "dp_recurrence": 0}
    want = {k: n * n_mb for k, n in per_mb.items()}
    print(f"[p20] {P20_STEPS} steps in {wall:.1f} s; losses "
          f"{[round(x, 4) for x in losses]}; peak {peak / 1e9:.2f} GB (need "
          f"<= {P19_PEAK_LIMIT / 1e9:.0f})")
    print(f"[p20] launches {launches}; expected {want} ({n_mb} microbatches"
          f" x {per_mb}: the forward and remat's recompute of each layer, one"
          f" backward a layer); the recurrence's by kernel {by_kernel}, "
          f"its backward's {bwd_by_kernel}")
    check(all(np.isfinite(losses)), "phase 20: a loss is not finite")
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    print(f"[p20] mean of the first 4 losses {first:.4f}, of the last 4 "
          f"{last:.4f}")
    check(last < first, "phase 20: the loss did not fall")
    check(launches == want, f"phase 20: launches {launches} != {want}")
    check(by_kernel == {"loop": 0, "chunked": want["linear_recurrence"]},
          f"phase 20: the recurrence's launches by kernel {by_kernel}")
    check(bwd_by_kernel == {"loop": 0,
                            "chunked": want["linear_recurrence_bwd"]},
          f"phase 20: the recurrence's backward launches by kernel "
          f"{bwd_by_kernel}")
    check(peak <= P19_PEAK_LIMIT, f"phase 20: the peak {peak} passes "
                                  f"{P19_PEAK_LIMIT}: raise grad_accum")
    run = {"train_wall_s": wall, "losses": losses,
           "losses_first4_mean": first, "losses_last4_mean": last,
           "peak_device_bytes": peak}
    return launches, run, model, box, step_fn, batches[0]


def rg_train_timing(torch, model, box, step_fn, batch, smi):
    """Phase 20d, the step: its ms (median of 5 after a warm-up), tokens/s,
    the model FLOPs' share of the bf16 tensor peak, one profiled step."""
    cfg = model.cfg

    def one_step():
        _, box["opt"], box["m"] = step_fn(model, box["opt"], batch)

    step_ms = host_ms(torch, one_step)
    tokens = P20_BATCH * P20_SEQ
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.active_param_count(),
          "recurrentgemma-2b: parameter count")
    flops, _ = train_model_flops(cfg, P20_BATCH, P20_SEQ)
    timing = {"train_step_ms": step_ms,
              "tokens_per_s": tokens / (step_ms / 1e3), "params": n_params,
              "model_flops_per_step": flops,
              "bf16_tensor_peak_share": flops / (step_ms / 1e3)
              / BF16_TENSOR_OPS}
    wall, dev_ms, rows = profile_window(torch, one_step, top=10)
    timing["step_profiled_wall_ms"] = wall
    timing["step_device_ms"] = dev_ms
    timing["step_device_busy_share"] = None if dev_ms is None \
        else dev_ms / wall
    timing["step_top_device_events"] = [(n, round(ms, 3), c)
                                        for n, ms, c in rows]
    print(f"[p20] train step {step_ms:.2f} ms, {timing['tokens_per_s']:.0f} "
          f"tokens/s, {n_params / 1e9:.3f} B parameters, "
          f"{timing['bf16_tensor_peak_share']:.2%} of the bf16 tensor peak "
          f"({smi}); profiled step wall {wall:.2f} ms, device busy {dev_ms} "
          f"ms; device events:")
    for name, ms, calls in rows:
        print(f"[profile] recurrentgemma train {ms:9.3f} ms  {calls:5d} x  "
              f"{name}")
    return timing


def rg_card_vs_cpu(torch):
    """Phases 20b-c: at one (R, R, A) period and full width, float32, B 2,
    S 256, the card's first-step gradients and 3 steps' losses against the
    port on the CPU; in bf16 at the microbatch shape, two runs of a step's
    gradients bit-identical."""
    import copy
    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(configs.get(P20_ARCH), n_layers=P20_CPU_LAYERS)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = T.init(cfg32, torch.Generator().manual_seed(0), device="cpu",
                 trainable=True)
    gpu = copy.deepcopy(cpu).to("cuda")
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=256,
                       global_batch=2, seed=0, device="cpu")
    batches = [pipe.batch(i) for i in range(3)]
    grads = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        b = {k: v.to(dev) for k, v in batches[0].items()}
        loss, _ = T.lm_loss(model, b)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    worst, worst_name = 0.0, None
    for (name, _), gc, gg in zip(cpu.named_parameters(), *grads):
        rel = float((gg.cpu() - gc).abs().max() / gc.abs().max())
        if rel > worst:
            worst, worst_name = rel, name
        check(rel <= 1e-4, f"phase 20: card vs CPU grad {name}: relative "
                           f"error {rel}")
    del grads
    tc = TrainConfig(warmup_steps=1, total_steps=3)
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        step_fn = steps.make_train_step(cfg32, tc)
        opt = adamw_init(dict(model.named_parameters()))
        out = []
        for b in batches:
            _, opt, m = step_fn(model, opt, {k: v.to(dev)
                                             for k, v in b.items()})
            out.append(float(m["loss"]))
        losses.append(out)
        del opt
    print(f"[p20] {P20_CPU_LAYERS} layers {T.layer_kinds(cfg)}, float32, B "
          f"2, S 256: losses cpu {losses[0]}, card {losses[1]} (need rtol "
          f"1e-5); first-step grads worst relative error {worst:.3e} at "
          f"{worst_name} (need <= 1e-4)")
    check(np.allclose(losses[1], losses[0], rtol=1e-5, atol=0),
          "phase 20: card vs CPU losses differ beyond rtol 1e-5")
    del cpu, gpu
    # 20c: determinism in bf16 at the microbatch shape
    b = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=P20_SEQ,
                    global_batch=P20_BATCH // P20_ACCUM, seed=1,
                    device="cuda").batch(0)
    same = bf16_rerun(torch, cfg, b, "phase 20")
    return {"card_vs_cpu_grad_worst_rel": worst,
            "card_vs_cpu_losses": losses, "bf16_step_bit_identical": same}


def rg_kernel_times(torch):
    """Phase 20d, the kernels at the microbatch shape (CUDA-graph replays):
    rglru_scan_bwd (the chunked kernel, and the loop kernel on the same
    values with g misaligned) beside its plain version and its bound, the
    forward with and without its float32 states, and the flash pair at
    D = 256 beside the plain versions, SDPA and the bound."""
    from repro_torch import configs
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = configs.get(P20_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(20)
    B, S, W = P20_BATCH // P20_ACCUM, P20_SEQ, cfg.lru_width
    a = (0.5 + 0.5 * torch.rand((B, S, W), generator=gen,
                                device="cuda")).bfloat16()
    b, g = (torch.randn((B, S, W), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    _, _, states = rs._forward(a, b, None, keep_states=True)
    g_off = misaligned(torch, g)
    n = a.numel()
    fn = rs.linear_recurrence_bwd
    before = dict(fn.launches_by_kernel)
    rec = with_bound({
        "ms": graph_ms(torch, [lambda: fn(a, states, g)] * 3),
        "plain_ms": cuda_ms(torch, lambda: rs.linear_recurrence_bwd_plain(
            a, states, g)),
        "library_ms": None,
        "ops": 3 * n,
        # a, g and the float32 states in; da, db out
        "bytes": n * (4 * a.element_size() + 4)})
    chunked = fn.launches_by_kernel["chunked"] - before["chunked"]
    # the loop kernel on the same values, g one element off a 16-byte
    # boundary so that the choice rule sends the call there
    rec["loop_ms"] = graph_ms(torch, [lambda: fn(a, states, g_off)] * 3)
    check(chunked > 0 and fn.launches_by_kernel["loop"] > before["loop"],
          "phase 20d: the backward's timings did not run both kernels")
    rec["forward_with_states_ms"] = graph_ms(torch, [
        lambda: rs._forward(a, b, None, keep_states=True)] * 3)
    rec["forward_ms"] = graph_ms(torch, [
        lambda: rs._forward(a, b, None, keep_states=False)] * 3)
    print(f"[timing] rglru_scan_bwd at {tuple(a.shape)} bf16: "
          f"{rec['ms']:.4f} ms (the chunked kernel), plain "
          f"{rec['plain_ms']:.4f} ms, no library call, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
          f"{rec['bytes']:.4g} B), {rec['bound_ms'] / rec['ms']:.1%} of it; "
          f"the loop kernel {rec['loop_ms']:.4f} ms in this run "
          f"({rec['bound_ms'] / rec['loop_ms']:.1%}; it took "
          f"{LOOP_BWD_EARLIER_MS} ms at aligned inputs in an earlier run on "
          f"an H100 80GB HBM3 at 700 W); the forward "
          f"{rec['forward_ms']:.4f} ms, with its float32 states "
          f"{rec['forward_with_states_ms']:.4f} ms")
    del a, b, g, g_off, states

    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    q, dout = normal(B, S, H, D), normal(B, S, H, D)
    k, v = normal(B, S, KV, D), normal(B, S, KV, D)
    out, lse = flash_attention(q, k, v, window=cfg.window, return_lse=True)
    # at S = 2048 the window of 2048 masks nothing the causal mask keeps,
    # so SDPA's causal call computes the same function
    fwd, bwd = flash_pair_times(torch, q, k, v, out, lse, dout,
                                window=cfg.window)
    for name, r in (("flash_attention (train, with LSE)", fwd),
                    ("flash_attention_bwd", bwd)):
        print(f"[timing] {name} at {tuple(q.shape)} KV {KV} window "
              f"{cfg.window}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
              f" SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['ops']:.4g} ops, {r['bytes']:.4g} B), "
              f"{r['bound_ms'] / r['ms']:.1%} of it")
    pairs = S * (S + 1) // 2
    issued = 28 * D * pairs * B * H
    print(f"[timing] flash_attention_bwd bf16 at D = 256 issues 28 D "
          f"tensor-core operations a visible pair (the column split repeats "
          f"S and dP): {issued:.4g}, {issued / BF16_TENSOR_OPS * 1e3:.4f} ms "
          f"at the bf16 tensor peak")
    del q, k, v, out, lse, dout
    torch.cuda.empty_cache()
    return {"rglru_scan_bwd": rec, "flash_attention": fwd,
            "flash_attention_bwd": bwd}


def rg_training_phase(torch, smi):
    """Phase 20: recurrentgemma-2b training.  Returns the main run's
    launches and the kernels' times at its shapes."""
    t20 = time.perf_counter()
    launches, run, model, box, step_fn, batch = rg_train_run(torch)
    run.update(rg_train_timing(torch, model, box, step_fn, batch, smi))
    del model, box, step_fn, batch
    torch.cuda.empty_cache()
    run.update(rg_card_vs_cpu(torch))
    ktimes = rg_kernel_times(torch)
    run["card"] = smi
    print("[timing] recurrentgemma training " + json.dumps(run))
    print(f"[p20] phase 20 took {time.perf_counter() - t20:.1f} s")
    return launches, ktimes


# ---------------------------------------------------------------------------
# xlstm-1.3b
# ---------------------------------------------------------------------------

def kernel_fns():
    """Every hand-written kernel's wrapper, for counts that must stay 0."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dp_recurrence import dp_recurrence
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rglru_scan import (linear_recurrence,
                                                linear_recurrence_bwd)
    return (flash_attention, flash_attention_bwd, decode_attention,
            linear_recurrence, linear_recurrence_bwd, dp_recurrence)


def xlstm_chunk(cfg, S):
    """The chunk the chunkwise mLSTM takes at S: ``cfg.mlstm_chunk``,
    halved until it divides S."""
    c = min(cfg.mlstm_chunk, S)
    while S % c:
        c //= 2
    return c


def xlstm_floors(torch, model, B, S):
    """What xlstm serving cannot beat on the card.  A prefill of B x S
    tokens: (i) the mLSTM's float32 products as the chunkwise form issues
    them (each chunk's q C and k^T (w v), 2 B H c D^2 each, and q k^T and
    (a w) v, 2 B H c^2 D each) at the float32 CUDA-core peak; (ii) the
    layers' bf16 products, 2 x their matrices' parameters a token (the
    float32 ``w_rec`` aside), and the LM head on the B last positions, at
    the bf16 tensor peak; (iii) each sLSTM step reading its float32
    ``w_rec`` at the memory rate.  Layers
    run one after another, so the prefill's floor is the sum.  A decode
    step reads the layers' weights, the LM head and B rows of the
    embedding table, and reads and writes every recurrent state."""
    from repro_torch.models import transformer as T
    cfg = model.cfg
    kinds = T.layer_kinds(cfg)
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    d, H = cfg.d_model, cfg.n_heads
    D, c = 2 * d // H, xlstm_chunk(cfg, S)
    mlstm_flops = n_m * (2 * 2 * B * H * S * D * D + 2 * 2 * B * H * S * c * D)
    layer_params = [(name, p) for layer in model.layers
                    for name, p in layer.named_parameters()]
    mat = sum(p.numel() for name, p in layer_params
              if p.dim() >= 2 and name != "w_rec")
    linear_flops = 2 * mat * B * S + 2 * d * cfg.vocab_size * B
    w_rec = d * 4 * d * 4
    slstm_bytes = n_s * S * w_rec
    fp32_peak, _ = fp32_peak_ops(torch)
    pre = {"mlstm_fp32_ms": mlstm_flops / fp32_peak * 1e3,
           "linear_bf16_ms": linear_flops / BF16_TENSOR_OPS * 1e3,
           "slstm_w_rec_ms": slstm_bytes / HBM_BYTES_PER_S * 1e3}
    weights = sum(p.numel() * p.element_size() for _, p in layer_params) \
        + model.lm_head.numel() * model.lm_head.element_size() \
        + B * d * model.embed.element_size()
    state = 4 * (n_m * B * H * (D * D + D + 1) + n_s * B * 4 * d)
    dec_bytes = weights + 2 * state
    return {"prefill_floor_ms": sum(pre.values()), **pre,
            "mlstm_fp32_flops": mlstm_flops,
            "linear_bf16_flops": linear_flops, "slstm_w_rec_bytes":
            slstm_bytes, "decode_floor_ms": dec_bytes / HBM_BYTES_PER_S * 1e3,
            "decode_weight_bytes": weights, "decode_state_bytes": 2 * state,
            "fp32_peak_ops": fp32_peak}


def xlstm_decode_vs_full(torch, model, tokens, n_dec, tol, label):
    """A prefill of ``tokens[:, :S - n_dec]`` and ``n_dec`` decode steps
    fed the remaining tokens (teacher forcing) against one full forward
    over all S: the prefill's last logits and each decode step's must
    equal the full forward's at their positions within ``tol`` (with
    ``tol`` None the difference is printed, not held).  Returns the
    largest difference."""
    from repro_torch.launch import steps
    cfg = model.cfg
    B, S = tokens.shape
    P = S - n_dec
    with torch.no_grad():
        cache = model.init_cache(B, S)
        logits, cache = steps.make_prefill_step(cfg)(
            model, cache, {"tokens": tokens[:, :P]})
        got = [logits[:, -1].float()]
        decode = steps.make_decode_step(cfg)
        for t in range(P, S):
            logits, _, cache = decode(model, cache,
                                      {"tokens": tokens[:, t:t + 1]})
            got.append(logits[:, -1].float())
        del cache, logits
        full, _ = model(tokens)
        want = full[:, P - 1:].float()
        del full
        got = torch.stack(got, 1)
        diff = (got - want).abs()
        top2 = want.topk(2, dim=-1).values
        margin = 0.0 if tol is None else tol
        decided = (top2[..., 0] - top2[..., 1]) > margin
        same = (got.argmax(-1) == want.argmax(-1))[decided]
    worst = float(diff.max())
    print(f"[p22] {label}: prefill of {P} tokens (chunk "
          f"{xlstm_chunk(cfg, P)}) and {n_dec} teacher-forced decode steps "
          f"against a full forward over {S} (chunk {xlstm_chunk(cfg, S)}), "
          f"B {B}: max|d logit| {worst:.4g}, mean {float(diff.mean()):.3g} "
          f"({'printed, not held' if tol is None else f'need max <= {tol}'});"
          f" largest logit {float(want.abs().max()):.4g}; argmax equal at "
          f"{int(same.sum())} of {int(decided.sum())} positions whose top-2 "
          f"margin > {margin} ({decided.numel()} in all)")
    if tol is not None:
        check(worst <= tol, f"{label}: decode vs full forward {worst}")
        check(bool(same.all()), f"{label}: decode and the full forward pick "
                                f"different tokens")
    return worst


def xlstm_serve_times(torch, model, batch, n_decode):
    """Prefill ms (time to first token; median of 5 after a warm-up) and
    decode ms a step (median of 5 runs of ``n_decode - 1`` greedy steps,
    after one), every decode run from the same prefill's states: an xLSTM
    layer's decode replaces its cache's tensors and writes none in place,
    so a shallow copy of the cache starts a run over.  Also returns the
    two calls timed, ``first_token()``, which returns (token, cache), and
    ``decode_rest(token, cache)``, which runs the steps, and the (token,
    cache) the decode runs started from."""
    from repro_torch.launch import steps
    cfg = model.cfg
    B, S = batch["tokens"].shape
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)

    def first_token():
        cache = model.init_cache(B, S + n_decode)
        logits, cache = prefill(model, cache, batch)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

    def decode_rest(tok, cache):
        cache = {"layers": [dict(c) for c in cache["layers"]],
                 "t": cache["t"]}
        for _ in range(n_decode - 1):
            _, tok, cache = decode(model, cache, {"tokens": tok[:, None]})
        return tok

    prefill_ms = host_ms(torch, first_token)
    tok, cache = first_token()
    step_ms, last = [], None
    for _ in range(6):                       # the first is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode_rest(tok, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / (n_decode - 1))
        check(last is None or bool(torch.equal(out, last)),
              "phase 22: decode runs from one prefill's states differ")
        last = out
    decode_ms = statistics.median(step_ms[1:])
    return {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "decode_tokens_per_s": B / (decode_ms / 1e3),
            "decode_steps_ms": step_ms[1:]}, first_token, decode_rest, \
        (tok, cache)


def xlstm_serving(torch, smi):
    """Phase 22a: xlstm-1.3b at full width and depth (bf16, seeded random
    weights) through the port's prefill and greedy decode steps: 8 x 2048
    token prompts, 31 decode steps, every kernel's count reset just
    before and read just after (the path runs none).  Checks the counts,
    every logit finite, the tokens and the peak; prints how far a prefill
    of 2016 tokens plus 32 teacher-forced decode steps lands from a full
    forward over 2048.  Times prefill and decode (medians of 5 after a
    warm-up), profiles one prefill and one request's decode (device busy
    share, device events), and the six sLSTM scans alone on the
    prefill's shape, for their share of the prefill's device time;
    prints the floors of ``xlstm_floors``."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as X
    fns = kernel_fns()
    cfg = configs.get(P22_ARCH)
    kinds = T.layer_kinds(cfg)
    t0 = time.perf_counter()
    model = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                   device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    B, S, d = P22_BATCH, P22_PROMPT, cfg.d_model
    print(f"[p22] {cfg.name}: {cfg.n_layers} layers ({kinds.count('mlstm')}"
          f" mlstm, {kinds.count('slstm')} slstm, period "
          f"{cfg.block_pattern}), d_model {d}, {cfg.n_heads} heads of "
          f"{2 * d // cfg.n_heads}, mlstm chunk {cfg.mlstm_chunk}, vocab "
          f"{cfg.vocab_size}, tied {cfg.tie_embeddings}; {n_params / 1e9:.4f}"
          f" B parameters, {torch.cuda.memory_allocated() / 1e9:.2f} GB on "
          f"the card (sLSTM w_rec in float32), drawn in "
          f"{time.perf_counter() - t0:.3f} s")
    check(n_params == cfg.param_count(), f"{cfg.name}: parameter count")
    check(all(p["w_rec"].dtype == torch.float32 for k, p in
              zip(kinds, model.layers) if k == "slstm"),
          "phase 22: the sLSTM's w_rec is not stored in float32")
    gen = torch.Generator(device="cuda").manual_seed(22)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    t0 = time.perf_counter()
    logits, toks = greedy_run(torch, model, batch, P22_DECODE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(fns)
    peak = torch.cuda.max_memory_allocated()
    print(f"[p22] serving: prefill of {B} x {S} tokens and "
          f"{P22_DECODE - 1} greedy decode steps in {wall:.2f} s; "
          f"hand-written kernel launches {launches} (expected none); peak "
          f"{peak / 1e9:.2f} GB (need <= {P19_PEAK_LIMIT / 1e9:.0f})")
    check(not any(launches.values()), f"phase 22: kernels ran: {launches}")
    check(bool(torch.isfinite(logits).all()), "phase 22: non-finite logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "phase 22: tokens out of the vocabulary")
    check(peak <= P19_PEAK_LIMIT, f"phase 22: serving peak {peak}")
    out = {"serve_wall_s": wall, "params": n_params,
           "serve_peak_device_bytes": peak}
    del logits, toks
    # printed only: the random-weight model amplifies roundings layer
    # by layer (phase 22c holds the same check at 2 layers in float32)
    out["decode_vs_full_max_abs"] = xlstm_decode_vs_full(
        torch, model, tokens, P22_DECODE, None,
        f"{cfg.name} bf16, {cfg.n_layers} layers")

    times, first_token, decode_rest, (tok, cache) = xlstm_serve_times(
        torch, model, batch, P22_DECODE)
    out.update(times)
    wall_p, dev_p, rows_p = profile_window(torch, first_token, top=None,
                                           cpu=False)
    wall_d, dev_d, rows_d = profile_window(
        torch, lambda: decode_rest(tok, cache), top=None, cpu=False)
    del tok, cache
    # the six sLSTM scans alone, on the prefill's shape and weights
    pre = torch.randn((B, S, 4 * d), generator=gen, device="cuda")
    zeros = torch.zeros((B, d), device="cuda")
    state = (zeros, zeros, zeros, torch.full_like(zeros, -1e30))
    slstm = [p for k, p in zip(kinds, model.layers) if k == "slstm"]

    def scans():
        for p in slstm:
            X.slstm_scan(pre, p["w_rec"], p["bias"], state)

    wall_s, dev_s, rows_s = profile_window(torch, scans, top=None, cpu=False)
    del pre
    floors = xlstm_floors(torch, model, B, S)
    out.update(floors)
    n_pre = sum(c for _, _, c in rows_p)
    n_dec = sum(c for _, _, c in rows_d)
    out.update(
        prefill_profiled_wall_ms=wall_p, prefill_device_ms=dev_p,
        prefill_device_busy_share=None if dev_p is None else dev_p / wall_p,
        prefill_device_events=n_pre,
        decode_profiled_wall_ms=wall_d, decode_device_ms=dev_d,
        decode_device_busy_share=None if dev_d is None else dev_d / wall_d,
        decode_device_events_per_step=n_dec / (P22_DECODE - 1),
        slstm_scans_wall_ms=wall_s, slstm_scans_device_ms=dev_s,
        slstm_share_of_prefill_device=None if not (dev_s and dev_p)
        else dev_s / dev_p,
        prefill_top_device_events=[(n, round(ms, 3), c)
                                   for n, ms, c in rows_p[:10]],
        decode_top_device_events=[(n, round(ms, 3), c)
                                  for n, ms, c in rows_d[:6]])
    print(f"[p22] serving timing ({smi}): prefill {out['prefill_ms']:.2f} "
          f"ms, decode {out['decode_ms_per_step']:.3f} ms a step "
          f"({out['decode_tokens_per_s']:.1f} tokens/s); floors: prefill "
          f"{floors['prefill_floor_ms']:.2f} ms (the mLSTM's "
          f"{floors['mlstm_fp32_flops'] / 1e12:.2f} TFLOP of float32 "
          f"products at {floors['fp32_peak_ops'] / 1e12:.2f} TFLOP/s: "
          f"{floors['mlstm_fp32_ms']:.2f} ms; the bf16 products' "
          f"{floors['linear_bf16_flops'] / 1e12:.2f} TFLOP: "
          f"{floors['linear_bf16_ms']:.2f} ms; the sLSTM steps' "
          f"{floors['slstm_w_rec_bytes'] / 1e9:.1f} GB of w_rec reads: "
          f"{floors['slstm_w_rec_ms']:.2f} ms), decode "
          f"{floors['decode_floor_ms']:.3f} ms ("
          f"{floors['decode_weight_bytes'] / 1e9:.2f} GB of weights, "
          f"{floors['decode_state_bytes'] / 1e9:.2f} GB of states read "
          f"and written)")
    print(f"[p22] profiled prefill: wall {wall_p:.1f} ms, device busy "
          f"{dev_p} ms (share {out['prefill_device_busy_share']}), "
          f"{n_pre} device events; profiled decode of "
          f"{P22_DECODE - 1} steps: wall {wall_d:.1f} ms, device busy "
          f"{dev_d} ms (share {out['decode_device_busy_share']}), "
          f"{out['decode_device_events_per_step']:.1f} device events a "
          f"step; the {len(slstm)} sLSTM scans alone: wall {wall_s:.1f} "
          f"ms, device {dev_s} ms, {out['slstm_share_of_prefill_device']} "
          f"of the prefill's device time, "
          f"{sum(c for _, _, c in rows_s)} device events")
    for name, ms, calls in rows_p[:10]:
        print(f"[profile] xlstm prefill {ms:9.3f} ms  {calls:6d} x  {name}")
    for name, ms, calls in rows_d[:6]:
        print(f"[profile] xlstm decode  {ms:9.3f} ms  {calls:6d} x  {name}")
    del model, first_token, decode_rest, slstm
    torch.cuda.empty_cache()
    return out


def xlstm_training(torch, smi):
    """Phase 22b: one xLSTM[7:1] period (7 mLSTM and 1 sLSTM layers) at
    full width through ``steps.make_train_step`` (bf16 compute, float32
    masters, remat), SyntheticLM batches of 8 x 2048, P22_STEPS steps at
    the full learning rate (warmup 1), every kernel's count reset just
    before and read just after.  Checks: no kernel launched, every loss
    finite, the last below the first, the peak.  Times the step (median
    of the steps after the first, a warm-up; each ends in a loss read),
    tokens/s, the busy share of one more step under the profiler,
    and the model FLOPs in two parts: 6 N tokens over the bf16 tensor
    peak, and the mLSTM's float32 products (``train_model_flops``' term,
    forward and backward, with remat's recomputation: 4 / 3 of it) over
    the float32 peak."""
    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    fns = kernel_fns()
    cfg = dataclasses.replace(configs.get(P22_ARCH),
                              n_layers=P22_TRAIN_LAYERS)
    B, S = P22_BATCH, P22_PROMPT
    tc = TrainConfig(warmup_steps=1, total_steps=P22_STEPS + 1,
                     grad_accum=P22_ACCUM)
    model = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                   device="cuda", trainable=True)
    box = {"opt": adamw_init(dict(model.named_parameters()))}
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S,
                       global_batch=B, seed=0, device="cuda")
    batches = [pipe.batch(i) for i in range(P22_STEPS)]
    step_fn = steps.make_train_step(cfg, tc)

    def one_step(b=batches[0]):
        _, box["opt"], box["m"] = step_fn(model, box["opt"], b)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    losses, walls = [], []
    for b in batches:
        t0 = time.perf_counter()
        one_step(b)
        losses.append(float(box["m"]["loss"]))
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = counts(fns)
    peak = torch.cuda.max_memory_allocated()
    print(f"[p22] train, {cfg.n_layers} layers {T.layer_kinds(cfg)}, "
          f"{B} x {S} tokens, grad_accum {P22_ACCUM}: losses "
          f"{[round(x, 4) for x in losses]} in {[round(w, 2) for w in walls]}"
          f" s; hand-written kernel launches {launches} (expected none); "
          f"peak {peak / 1e9:.2f} GB (need <= {P19_PEAK_LIMIT / 1e9:.0f})")
    check(not any(launches.values()), f"phase 22: kernels ran: {launches}")
    check(all(np.isfinite(losses)), "phase 22: a loss is not finite")
    check(losses[-1] < losses[0], "phase 22: the loss did not fall")
    check(peak <= P19_PEAK_LIMIT, f"phase 22: the train peak {peak}: "
                                  f"raise grad_accum")
    step_ms = statistics.median(walls[1:]) * 1e3
    flops, mlstm = train_model_flops(cfg, B, S)
    fp32_peak, _ = fp32_peak_ops(torch)
    step_s = step_ms / 1e3
    timing = {"train_step_ms": step_ms, "tokens_per_s": B * S / step_s,
              "losses": losses, "peak_device_bytes": peak,
              "params": cfg.param_count(), "grad_accum": P22_ACCUM,
              "model_flops_per_step": flops,
              "mlstm_model_flops_per_step": mlstm,
              "bf16_tensor_peak_share": (flops - mlstm) / step_s
              / BF16_TENSOR_OPS,
              "mlstm_fp32_issued_flops": mlstm * 4 / 3,
              "fp32_peak_share": mlstm * 4 / 3 / step_s / fp32_peak}
    wall, dev_ms, rows = profile_window(torch, one_step, top=None, cpu=False)
    timing.update(step_profiled_wall_ms=wall, step_device_ms=dev_ms,
                  step_device_busy_share=None if dev_ms is None
                  else dev_ms / wall,
                  step_device_events=sum(c for _, _, c in rows),
                  step_top_device_events=[(n, round(ms, 3), c)
                                          for n, ms, c in rows[:8]])
    print(f"[p22] train step {step_ms:.2f} ms ({smi}), "
          f"{timing['tokens_per_s']:.0f} tokens/s; 6 N tokens "
          f"{(flops - mlstm) / 1e12:.2f} TFLOP, "
          f"{timing['bf16_tensor_peak_share']:.2%} of the bf16 tensor peak;"
          f" the mLSTM's float32 products {mlstm * 4 / 3 / 1e12:.2f} TFLOP "
          f"issued (forward, backward, remat's recompute), "
          f"{timing['fp32_peak_share']:.2%} of the float32 peak "
          f"({fp32_peak / 1e12:.2f} TFLOP/s); profiled step wall "
          f"{wall:.1f} ms, device busy {dev_ms} ms, "
          f"{timing['step_device_events']} device events; device events:")
    for name, ms, calls in rows[:8]:
        print(f"[profile] xlstm train {ms:9.3f} ms  {calls:6d} x  {name}")
    del model, box, batches, step_fn, one_step
    torch.cuda.empty_cache()
    return timing


def xlstm_card_vs_cpu(torch):
    """Phase 22c: two layers (mlstm, slstm) at full width in float32, B 2
    x 512: the card's logits (within rtol 1e-4 of their largest
    magnitude), loss (within 1e-5) and every gradient (relative error, the
    largest difference over the largest element, <= 1e-4) against the
    CPU's; on the card, a prefill of 480 tokens and 32 teacher-forced
    decode steps against the full forward within LOGIT_TOL_F32; in bf16
    two runs of a step's loss and gradients bit-identical."""
    import copy
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(configs.get(P22_ARCH), n_layers=2,
                              block_pattern=("mlstm", "slstm"),
                              compute_dtype="float32")
    cpu = T.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                 trainable=True)
    gpu = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(221)
    B, S = P22_CPU_B, P22_CPU_S
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen),
             "mask": torch.ones((B, S))}
    on_card = {k: v.to("cuda") for k, v in batch.items()}
    with torch.no_grad():
        lg = gpu(on_card["tokens"])[0].cpu()
        lc = cpu(batch["tokens"])[0]
    logit_rel = float((lg - lc).abs().max() / lc.abs().max())
    del lg, lc
    got = steps.value_and_grad(gpu, on_card)
    want = steps.value_and_grad(cpu, batch)
    d_loss = abs(float(got[0]) - float(want[0]))
    worst, worst_name = 0.0, None
    for (name, _), gg, gc in zip(cpu.named_parameters(), got[2], want[2]):
        rel = float((gg.cpu() - gc).abs().max() / gc.abs().max())
        if rel > worst:
            worst, worst_name = rel, name
        check(rel <= 1e-4, f"phase 22: card vs CPU grad {name}: relative "
                           f"error {rel}")
    print(f"[p22] {cfg.n_layers} layers {T.layer_kinds(cfg)} float32, B {B},"
          f" S {S}, card vs CPU: logits max difference {logit_rel:.3e} of "
          f"the largest (need <= 1e-4); loss {float(got[0]):.7f} / "
          f"{float(want[0]):.7f} (difference {d_loss:.3e}, need <= 1e-5); "
          f"gradients' worst relative error {worst:.3e} at {worst_name} "
          f"(need <= 1e-4)")
    check(logit_rel <= 1e-4, f"phase 22: card vs CPU logits {logit_rel}")
    check(d_loss <= 1e-5, f"phase 22: card vs CPU loss {d_loss}")
    del got, want
    dec = xlstm_decode_vs_full(torch, gpu, on_card["tokens"], P22_DECODE,
                               LOGIT_TOL_F32,
                               f"{cfg.n_layers} layers float32 on the card")
    del cpu, gpu
    torch.cuda.empty_cache()
    same = bf16_rerun(torch, dataclasses.replace(cfg,
                                                 compute_dtype="bfloat16"),
                      on_card, "phase 22")
    return {"card_vs_cpu_logit_rel": logit_rel, "card_vs_cpu_loss_abs": d_loss,
            "card_vs_cpu_grad_worst_rel": worst,
            "decode_vs_full_f32": dec,
            "bf16_step_bit_identical": same}


def xlstm_phase(torch, smi):
    """Phase 22: xlstm-1.3b serving at full width and depth, training at
    full width on one period, and the card against the CPU."""
    run, seconds = {"card": smi}, {}
    for key, fn in (("serving", lambda: xlstm_serving(torch, smi)),
                    ("training", lambda: xlstm_training(torch, smi)),
                    ("card_vs_cpu", lambda: xlstm_card_vs_cpu(torch))):
        t0 = time.perf_counter()
        run[key] = fn()
        seconds[key] = round(time.perf_counter() - t0, 1)
    print("[timing] xlstm-1.3b " + json.dumps(run))
    print(f"[p22] phase 22 took {sum(seconds.values()):.1f} s: "
          f"{json.dumps(seconds)}")


# ---------------------------------------------------------------------------
# the distributed paths (phase 23)
# ---------------------------------------------------------------------------

def digest(torch, tensors):
    """SHA-256 of the tensors' bytes, in order: equal digests mean
    bit-identical tensors."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def p23_solves(refined=True):
    """The sweep's solve on the card (8 default-grid scenarios at J_MAIN,
    DT_MAIN) in both objectives and, with ``refined``, the refined makespan
    solve; under an active group each is sharded."""
    from repro_torch.core import market, scenarios
    from repro_torch.core.policies import checkpointing
    dists = [sc.dist() for sc in scenarios.default_grid()]
    rng = np.random.default_rng(0)
    price = market.PriceGrid.from_prices(
        rng.uniform(0.05, 0.6, size=(len(dists), 96)), 0.25)
    kw = dict(grid_dt=DT_MAIN, delta_steps=DELTA, n_sweeps=N_SWEEPS,
              device="cuda")
    out = {"makespan": checkpointing.solve_batch(dists, J_MAIN, **kw),
           "dollars": checkpointing.solve_batch(
               dists, J_MAIN, objective="dollars", price=price, **kw)}
    if refined:
        out["refined"] = checkpointing.solve_batch(dists, J_MAIN, refine=True,
                                                   **kw)
    return out


def p23_steps(torch, cfg, tc, group, model, opt, pipe, start, end, mgr=None):
    """Train steps ``start..end`` on this rank's rows of ``pipe``'s global
    batches (all of them with no group); with ``mgr``, save on its
    schedule.  Returns the optimizer state and the losses."""
    from repro_torch.launch import steps
    step_fn = steps.make_train_step(cfg, tc, group)
    rank, world = (0, 1) if group is None else (
        torch.distributed.get_rank(group),
        torch.distributed.get_world_size(group))
    losses = []
    for step in range(start, end):
        batch = pipe.batch(step)
        rows = pipe.global_batch // world
        _, opt, m = step_fn(model, opt, {k: v[rank * rows:(rank + 1) * rows]
                                         for k, v in batch.items()})
        losses.append(float(m["loss"]))
        if mgr is not None and mgr.should_checkpoint(step + 1):
            mgr.save(step + 1, {"params": dict(model.named_parameters()),
                                "opt": opt})
    return opt, losses


def p23_step_ms(torch, step_fn, model, opt, batch):
    """The median wall time of P23_TIMED more train steps, each ending in
    a synchronize (the model has run, so no warm-up)."""
    times = []
    box = {"opt": opt}
    for _ in range(P23_TIMED):
        t0 = time.perf_counter()
        _, box["opt"], _ = step_fn(model, box["opt"], batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def p23_rank(rank, world, work):
    """One rank of phases 23b-d, started by ``torch.multiprocessing`` with
    ``spawn``: loads the kernels the parent built, joins a gloo group over
    a ``file://`` rendezvous in ``work``, and writes its results to
    ``work/rank<r>.json``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import configs, sharding
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import distributions
    from repro_torch.core.policies import solver_backends as SB
    from repro_torch.data import SyntheticLM
    from repro_torch.fault import plan_elastic_remesh
    from repro_torch.kernels import _build
    from repro_torch.kernels.dp_recurrence import (dp_recurrence,
                                                   dp_recurrence_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch import steps
    from repro_torch.launch.train import _load, train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    missing = [k for k in KERNELS if not _build.library_path(k).exists()]
    check(not missing, f"rank {rank}: kernels not built by the parent: "
                       f"{missing}")
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    everyone = dist.group.WORLD
    res = {"rank": rank}
    try:
        # -- 23b: the sharded solve --------------------------------------
        t0 = time.perf_counter()
        with sharding.use(everyone), recorded_launches(dp_recurrence) as rec:
            res["partition"] = list(SB.scenario_partition(8)[1:])
            zero_counts([dp_recurrence])
            tables = p23_solves()
            torch.cuda.synchronize()
            res["dp_launches"] = dp_recurrence.launches
        res["launch_shapes"] = [list(out[0].shape) for _, _, out in rec.calls]
        hold_to_plain(torch, dp_recurrence_plain, rec, f"23b rank {rank}")
        res["tables"] = {k: digest(torch, [t.V, t.K])
                         for k, t in tables.items()}
        res["refine_info"] = {k: v for k, v in
                              tables["refined"].refine_info.items()
                              if k in ("applied", "verified_col0",
                                       "fallback")}
        res["seconds_b"] = time.perf_counter() - t0
        del tables, rec

        # -- 23c: data-parallel training ---------------------------------
        t0 = time.perf_counter()
        cfg = configs.get(TRAIN_ARCH)
        tc = TrainConfig(ckpt_dir=os.path.join(work, "c"),
                         warmup_steps=TRAIN_WARMUP, total_steps=P23_STEPS)
        fns = (dp_recurrence, flash_attention, flash_attention_bwd)
        zero_counts(fns)
        run = train(cfg, tc, total_steps=P23_STEPS, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, verbose=False, device="cuda",
                    group=everyone)
        torch.cuda.synchronize()
        res["train_launches"] = counts(fns)
        res["train_losses"] = run.losses
        params = list(run.model.parameters())
        res["train_params"] = digest(torch, params)
        want = torch.load(os.path.join(work, "c_params.pt"))
        res["train_params_max_abs_diff"] = max(
            float((p.detach() - w.to(p.device)).abs().max())
            for p, w in zip(params, want))
        del want
        pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=tc.seed,
                           device="cuda")
        rows = TRAIN_BATCH // world
        batch = {k: v[rank * rows:(rank + 1) * rows]
                 for k, v in pipe.batch(P23_STEPS).items()}
        res["step_ms"] = p23_step_ms(
            torch, steps.make_train_step(cfg, tc, everyone), run.model,
            adamw_init(dict(run.model.named_parameters())), batch)
        flat = torch.zeros(sum(p.numel() for p in params) + 3,
                           device="cuda")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sharding.all_reduce_sum_(flat, everyone)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        res["all_reduce_ms"] = statistics.median(times)
        res["all_reduce_bytes"] = flat.numel() * 4
        del run, params, flat, batch
        torch.cuda.empty_cache()
        res["seconds_c"] = time.perf_counter() - t0

        # -- 23d: the elastic resume -------------------------------------
        t0 = time.perf_counter()
        tc = TrainConfig(warmup_steps=1, total_steps=2 * P23_ELASTIC)
        mgr = CheckpointManager(
            directory=os.path.join(work, "d"),
            dist=distributions.constrained_for(), policy="fixed",
            fixed_interval_steps=100, async_write=False, device="cuda",
            write=rank == 0)
        model = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda", trainable=True)
        opt = adamw_init(dict(model.named_parameters()))
        pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=0, device="cuda")
        with sharding.use(everyone):
            opt, res["elastic_l1"] = p23_steps(torch, cfg, tc, everyone,
                                               model, opt, pipe, 0,
                                               P23_ELASTIC, mgr)
        mgr.save(P23_ELASTIC, {"params": dict(model.named_parameters()),
                               "opt": opt})
        plan = plan_elastic_remesh(world, [1], pod_shape=(1,),
                                   axes=("data",))
        survivors = list(plan.surviving_pods)
        group = dist.new_group(survivors)
        mgr.wait()
        dist.barrier()
        res["survivor"] = rank in survivors
        if res["survivor"]:
            restored = mgr.restore({"params": dict(model.named_parameters()),
                                    "opt": opt})
            check(restored is not None, "23d: no checkpoint to restore")
            state, step0, _ = restored
            opt = _load(model, state)
            pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=int(TRAIN_BATCH
                                                * plan.batch_scale),
                               seed=0, device="cuda")
            with sharding.use(group):
                _, res["elastic_l2"] = p23_steps(
                    torch, cfg, tc, group, model, opt, pipe, step0,
                    step0 + P23_ELASTIC)
            res["elastic_resumed"] = step0
            res["elastic_batch"] = pipe.global_batch
            res["elastic_params"] = digest(torch, model.parameters())
        res["seconds_d"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def distributed_phase(torch, smi):
    """Phase 23: (a) a 1-rank NCCL group takes the one-process path;
    (b-d) two gloo ranks on the card: the sharded solve, data-parallel
    training of smollm-135m at full width and the elastic pod-loss
    resume, each held to the one-process run.  Returns the per-rank launch
    counts of the sharded solve and of the training run."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch import configs, sharding
    from repro_torch.checkpoint.manager import restore_latest
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.policies import solver_backends as SB
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.dp_recurrence import dp_recurrence
    from repro_torch.launch import steps
    from repro_torch.launch.train import _load, train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    seconds = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        # -- 23a: a 1-rank group ------------------------------------------
        t0 = time.perf_counter()
        one = p23_solves()
        digests = {k: digest(torch, [t.V, t.K]) for k, t in one.items()}
        dist.init_process_group("nccl", init_method=f"file://{work}/solo",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            with sharding.use(dist.group.WORLD):
                part = SB.scenario_partition(8)
                fn_back = SB.shard_scenarios(p23_solves, 8, 2, 2)[0] \
                    is p23_solves
                dp_recurrence.launches = 0
                got = p23_solves(refined=False)
                check(dp_recurrence.launches == 2,
                      f"23a: {dp_recurrence.launches} launches for the "
                      f"two solves")
        finally:
            dist.destroy_process_group()
        same = {k: digest(torch, [t.V, t.K]) == digests[k]
                for k, t in got.items()}
        print(f"[p23a] 1-rank nccl group: scenario_partition(8) {part}; "
              f"shard_scenarios returns fn itself {fn_back}; tables "
              f"bit-identical to the solve without a group {same}; one "
              f"dp_recurrence launch a solve")
        check(part == (None, None, None) and fn_back and all(same.values()),
              "23a: a 1-rank group did not take the one-process path")
        del got
        seconds["a"] = time.perf_counter() - t0

        # -- the one-process references of 23c --------------------------
        t0 = time.perf_counter()
        cfg = configs.get(TRAIN_ARCH)
        tc = TrainConfig(ckpt_dir=os.path.join(work, "c_one"),
                         warmup_steps=TRAIN_WARMUP, total_steps=P23_STEPS,
                         grad_accum=P23_WORLD)
        ref = train(cfg, tc, total_steps=P23_STEPS, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, verbose=False, device="cuda")
        torch.save([p.detach().cpu() for p in ref.model.parameters()],
                   os.path.join(work, "c_params.pt"))
        ref_digest = digest(torch, ref.model.parameters())
        pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=tc.seed,
                           device="cuda")
        one_step_ms = p23_step_ms(
            torch, steps.make_train_step(cfg, tc), ref.model,
            adamw_init(dict(ref.model.named_parameters())),
            pipe.batch(P23_STEPS))
        ref_losses = ref.losses
        del ref
        torch.cuda.empty_cache()
        seconds["references"] = time.perf_counter() - t0

        # -- 23b-d: two gloo ranks on the card ---------------------------
        t0 = time.perf_counter()
        mp.start_processes(p23_rank, args=(P23_WORLD, work),
                           nprocs=P23_WORLD, start_method="spawn")
        ranks = []
        for r in range(P23_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        seconds["ranks"] = time.perf_counter() - t0
        for r in ranks:
            print(f"[p23b] rank {r['rank']}: partition {r['partition']}; "
                  f"dp_recurrence launches {r['dp_launches']} of shapes "
                  f"{r['launch_shapes']}; refine {r['refine_info']}; "
                  f"gathered tables bit-identical to the one-process solve "
                  f"{ {k: v == digests[k] for k, v in r['tables'].items()} }"
                  f"; {r['seconds_b']:.1f} s")
            check(r["partition"] == [r["rank"], P23_WORLD],
                  f"23b rank {r['rank']}: partition {r['partition']}")
            block = [8 // P23_WORLD, J_MAIN + 1,
                     int(round(24.0 / DT_MAIN)) + 1]
            check(r["launch_shapes"].count(block) == 3
                  and len(r["launch_shapes"]) == 4
                  and all(s[0] == block[0] for s in r["launch_shapes"]),
                  f"23b rank {r['rank']}: launches {r['launch_shapes']}")
            check(r["dp_launches"] == len(r["launch_shapes"]),
                  "23b: recorded launches differ from the count")
            check(r["tables"] == digests, f"23b rank {r['rank']}: gathered "
                                          f"tables differ from one process's")
        for r in ranks:
            print(f"[p23c] rank {r['rank']}: losses {r['train_losses']} "
                  f"(one process, grad_accum {P23_WORLD}: {ref_losses}); "
                  f"parameters bit-identical to one process's "
                  f"{r['train_params'] == ref_digest} (max |diff| "
                  f"{r['train_params_max_abs_diff']:.3e}); launches "
                  f"{r['train_launches']}; {r['seconds_c']:.1f} s")
            check(r["train_losses"] == ref_losses,
                  f"23c rank {r['rank']}: losses differ from one process's")
            check(r["train_params"] == ref_digest,
                  f"23c rank {r['rank']}: parameters differ from one "
                  f"process's")
            check(r["train_launches"]["flash_attention_bwd"]
                  == P23_STEPS * cfg.n_layers
                  and r["train_launches"]["dp_recurrence"] >= 1,
                  f"23c rank {r['rank']}: launches {r['train_launches']}")
        check(len({r["train_params"] for r in ranks}) == 1,
              "23c: the ranks hold different parameters")
        timing = {"step_ms_by_rank": [r["step_ms"] for r in ranks],
                  "all_reduce_ms_by_rank": [r["all_reduce_ms"]
                                            for r in ranks],
                  "all_reduce_bytes": ranks[0]["all_reduce_bytes"],
                  "one_process_step_ms": one_step_ms,
                  "rows_per_rank": TRAIN_BATCH // P23_WORLD,
                  "seq": TRAIN_SEQ, "card": smi}
        print("[timing] data-parallel smollm-135m " + json.dumps(timing))

        # -- 23d: the survivor against one process's replay --------------
        t0 = time.perf_counter()
        survivor = [r for r in ranks if r["survivor"]]
        check(len(survivor) == 1 and survivor[0]["rank"] == 0,
              f"23d: survivors {[r['rank'] for r in survivor]}")
        s = survivor[0]
        tc = TrainConfig(warmup_steps=1, total_steps=2 * P23_ELASTIC)
        model = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda", trainable=True)
        opt = adamw_init(dict(model.named_parameters()))
        state, step0, _ = restore_latest(
            os.path.join(work, "d"),
            {"params": dict(model.named_parameters()), "opt": opt})
        opt = _load(model, state)
        pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=s["elastic_batch"], seed=0,
                           device="cuda")
        _, want = p23_steps(torch, cfg, tc, None, model, opt, pipe, step0,
                            step0 + P23_ELASTIC)
        same = s["elastic_params"] == digest(torch, model.parameters())
        print(f"[p23d] pods 2 x data 1, pod 1 lost: survivor resumed at "
              f"step {s['elastic_resumed']} on a global batch of "
              f"{s['elastic_batch']}; losses before {s['elastic_l1']}, "
              f"after {s['elastic_l2']} (one-process replay {want}); "
              f"parameters bit-identical to the replay's {same}")
        check(s["elastic_resumed"] == P23_ELASTIC
              and s["elastic_batch"] == TRAIN_BATCH // 2,
              "23d: resumed at the wrong step or batch")
        check(all(np.isfinite(s["elastic_l1"] + s["elastic_l2"])),
              "23d: a loss is not finite")
        check(s["elastic_l2"] == want and same,
              "23d: the survivor differs from one process's replay")
        del model, opt, state
        torch.cuda.empty_cache()
        seconds["replay"] = time.perf_counter() - t0
        seconds.update({f"rank0_{k}": ranks[0][f"seconds_{k}"]
                        for k in "bcd"})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[p23] phase 23 seconds: "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    return {"sharded": ranks[0]["dp_launches"],
            "training": ranks[0]["train_launches"]}



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
    # float32 products in full float32 on the card, as on the CPU
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import engine, scenarios
    from repro_torch.core.policies import checkpointing
    from repro_torch.core.policies.solver_backends import grids
    from repro_torch.kernels import _build
    from repro_torch.kernels.dp_recurrence import (dp_recurrence,
                                                   dp_recurrence_plain)

    phase_s, t_mark = {}, [time.perf_counter()]

    def mark(name):
        """Record the seconds since the last mark as phase ``name``'s."""
        now = time.perf_counter()
        phase_s[name] = round(now - t_mark[0], 1)
        t_mark[0] = now

    # -- 1. device ----------------------------------------------------------
    device_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(f"[device] torch: {device_name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    if sys.argv[1:] == ["--bwd-rounding"]:
        rows = bwd_rounding_study(torch, smi)
        print(json.dumps({"bwd_rounding": rows, "card": smi}))
        return 0
    vision_only = sys.argv[1:] == ["--vision-attention"]
    check(vision_only or not sys.argv[1:],
          f"unknown arguments {sys.argv[1:]}: the options are "
          f"--bwd-rounding and --vision-attention")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_many(KERNELS)
    print(f"[build] {', '.join(p.name for p, _ in built.values())} in "
          f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for kname, (_, log) in built.items():
        for line in log.splitlines():
            print(f"[build] {kname}: {line}")
    spills = [line.strip() for line in
              built["flash_attention_bwd"][1].splitlines()
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
    check(not spills, f"flash_attention_bwd spills registers: {spills}")
    for kname, op in (("flash_attention", "HGMMA"), ("decode_attention",
                                                     "HMMA"),
                      ("flash_attention_bwd", "HGMMA")):
        counts = tensor_core_ops(built[kname][0])
        print(f"[build] {kname} SASS tensor-core instructions: "
              f"{counts if counts is not None else 'no cuobjdump'}")
        if counts is not None:
            check(counts[op] > 0, f"{kname}: no {op} in its SASS")

    mark("1-2")

    if vision_only:
        p24_launches, p24_times = vision_attention_phase(torch, smi)
        print(json.dumps({"vision_attention": {
            "launches": p24_launches, **p24_times, "card": smi}}))
        return 0

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
                              main_kw, 0.999, f"makespan J={J_MAIN}",
                              repeats=MAIN_REPEATS)
    compare(torch, dp_recurrence, dp_recurrence_plain,
            dp_inputs(torch, grids, dists, J_MAIN, DT_MAIN, price), 0.995,
            f"dollars J={J_MAIN}", repeats=4)
    for objective, p, k_min in (("makespan", None, 0.999),
                                ("dollars", price, 0.995)):
        compare(torch, dp_recurrence, dp_recurrence_plain,
                dp_inputs(torch, grids, dists, J_MAIN, DT_MAIN, p,
                          delta=DELTA_ALT), k_min,
                f"{objective} J={J_MAIN} delta={DELTA_ALT}", repeats=2)
    exact_ties(torch, grids, dp_recurrence, dp_recurrence_plain)

    mark("3")

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
    pool_rel, pool_same = pool_rel_err(
        torch, (first, pool), engine.draw_lifetime_pool_batch(
            dists[:1], N_TRIALS, max_restarts=MAX_RESTARTS, seed=[0],
            device="cpu"), "main path")
    print(f"[main] the pool drawn on the card against the one drawn on the "
          f"CPU ({pool.numel() + first.numel()} lifetimes): max relative "
          f"difference {pool_rel:.3e} (need <= {POOL_RTOL}); bit-identical "
          f"{pool_same}")

    mark("4")

    # -- 5. timing ----------------------------------------------------------
    before = dp_recurrence.launches
    dp_recurrence(**main_kw)
    per_solve = dp_recurrence.launches - before
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
    wall, dev_ms, prof_rows = profile_window(
        torch, lambda: scenarios.sweep_checkpointing(grid, **sweep_kw))
    busy = None if dev_ms is None else dev_ms / wall
    print(f"[profile] sweep: wall {wall:.2f} ms, device busy "
          f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms (share "
          f"{busy if busy is None else round(busy, 4)}); device events:")
    for name, ms, calls in prof_rows:
        print(f"[profile] sweep   {ms:9.3f} ms  {calls:5d} x  {name}")

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
    timings = {"dp_solve_kernel_ms": ms_kernel,
               "dp_solve_plain_ms": ms_plain,
               "pool_draw_ms": ms_pool, "executor_ms": ms_exec,
               "sweep_ms": ms_sweep, "first_sweep_s": first_sweep_s,
               "sweep_profiled_wall_ms": wall, "sweep_device_ms": dev_ms,
               "sweep_device_busy_share": busy,
               "launches_per_solve": per_solve, "card": smi}
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

    mark("5")

    # -- 6. serving kernels against their plain versions ---------------------
    errs, main_inputs = serving_kernels_vs_plain(torch)

    mark("6")

    # -- 7. the serving path -------------------------------------------------
    model, serve_launches, serve_checks = serving_path(torch)

    mark("7")

    # -- 8. serving timing ---------------------------------------------------
    serving, ktimes = serving_timing(torch, model, main_inputs)
    serving.update(serve_checks)
    serving["card"] = smi
    print("[timing] serving " + json.dumps(serving))
    del model
    torch.cuda.empty_cache()

    mark("8")

    # -- 9. the batch service (Fig. 8) ---------------------------------------
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import linear_recurrence
    _, svc_kw, svc_res, _ = service_path(
        torch, (dp_recurrence, flash_attention, decode_attention,
                linear_recurrence))

    mark("9")

    # -- 10. service timing -------------------------------------------------
    service_timing(torch, svc_kw, svc_res, smi)

    mark("10")

    # -- 11. the market path ------------------------------------------------
    mkt_inputs, mkt_launches = market_path(torch, dp_recurrence)
    kernel["launches_by_path"] = {"checkpointing": launches,
                                  "market": mkt_launches}

    mark("11")

    # -- 12. market timing --------------------------------------------------
    market_timing(torch, mkt_inputs, smi)

    mark("12")

    # -- 13. the Eq. 1 fit --------------------------------------------------
    fit_phase(torch, smi)

    mark("13")

    # -- 14. refinement -----------------------------------------------------
    kernel["launches_by_path"]["refine"] = refine_phase(
        torch, dp_recurrence, dp_recurrence_plain, mkt_inputs, sweep_kw, smi)

    mark("14")

    # -- 15. the closed loop ------------------------------------------------
    kernel["launches_by_path"]["runtime"] = runtime_phase(
        torch, dp_recurrence, dp_recurrence_plain, smi)

    mark("15")

    # -- 16. the flash backward against its plain version ------------------
    bwd_err, bwd_inputs = flash_bwd_vs_plain(torch)

    mark("16")
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # -- 17a. the training path --------------------------------------
        train_launches, _ = training_path(torch, work)
        kernel["launches_by_path"]["training"] = \
            train_launches["dp_recurrence"]
        # -- 17b-c. replay and the card against the CPU ------------------
        replay_and_cpu(torch, work)
        # -- 17d. training timing ----------------------------------------
        train_times = training_timing(torch, bwd_inputs, smi, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    mark("17")

    # -- 18. the sweep modes and Fig. 7 ------------------------------------
    t18 = time.perf_counter()
    kernel["launches_by_path"].update(
        sweep_modes=modes_phase(torch, dp_recurrence, sweep_kw),
        fig7=fig7_phase(torch, dp_recurrence, dp_recurrence_plain))
    modes_timing(torch, sweep_kw, smi)
    print(f"[modes] phase 18 took {time.perf_counter() - t18:.1f} s")

    mark("18")

    # -- 19. embeddings input and M-RoPE; the 33-34 B archs cut in depth --
    p19_launches, p19_times = embeds_phase(torch, smi)
    mark("19")

    # -- 20. recurrentgemma-2b training -----------------------------------
    p20_launches, p20_times = rg_training_phase(torch, smi)
    mark("20")

    # -- 21. the MoE archs ------------------------------------------------
    p21_launches, p21_times = moe_phase(torch, smi)
    mark("21")

    # -- 22. xlstm-1.3b -----------------------------------------------------
    xlstm_phase(torch, smi)
    mark("22")

    # -- 23. the distributed paths ---------------------------------------
    p23_launches = distributed_phase(torch, smi)
    kernel["launches_by_path"]["sharded"] = p23_launches["sharded"]
    mark("23")

    # -- 24. the vision tower's attention ----------------------------------
    p24_launches, p24_times = vision_attention_phase(torch, smi)
    mark("24")
    sources = {
        "flash_attention": ("flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:89"),
        "decode_attention": ("decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:73"),
        "linear_recurrence": ("rglru_scan.cu",
                              "src/repro/kernels/rglru_scan.py:52")}
    kernels = [kernel]
    for kname, (cu, replaces) in sources.items():
        t = ktimes[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{cu}",
            "replaces": replaces, "launches": serve_launches[kname],
            "max_abs_err": errs[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    fwd = train_times["flash_attention"]
    kernels[1]["launches_by_path"] = {
        "serving": serve_launches["flash_attention"],
        "training": train_launches["flash_attention"]}
    kernels[1]["training_shape"] = {
        k: fwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")}
    kernels[2]["launches_by_path"] = {
        "serving": serve_launches["decode_attention"]}
    t = train_times["flash_attention_bwd"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/ops.py:108",
        "launches": train_launches["flash_attention_bwd"],
        "max_abs_err": bwd_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "launches_by_path": {
            "training": train_launches["flash_attention_bwd"]}})
    # phases 19 and 21: each model's launches (serving and one train step)
    # and the three attention kernels' times at its shape
    for entry in (kernels[1], kernels[2], kernels[4]):
        name = entry["name"]
        for key, paths in {**p19_launches, **p21_launches}.items():
            entry["launches_by_path"][key.replace("-", "_")] = sum(
                launches.get(name, 0) for launches in paths.values())
        for key, times in {**p19_times, **p21_times}.items():
            entry[f"{key}_shape"] = {
                k: times[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}
    # phase 23: one rank's launches in the data-parallel training run
    for entry in (kernels[1], kernels[4]):
        entry["launches_by_path"]["data_parallel_training"] = \
            p23_launches["training"][entry["name"]]
    # phase 20: recurrentgemma-2b's training launches and the kernels'
    # times at its microbatch shape; the recurrence's backward
    kernels[3]["launches_by_path"] = {
        "serving": serve_launches["linear_recurrence"],
        "recurrentgemma_training": p20_launches["linear_recurrence"]}
    for entry in (kernels[1], kernels[4]):
        name = entry["name"]
        entry["launches_by_path"]["recurrentgemma_training"] = \
            p20_launches[name]
        entry["recurrentgemma_shape"] = {
            k: p20_times[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}
    t = p20_times["rglru_scan_bwd"]
    kernels.append({
        "name": "rglru_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/ops.py:252",
        "launches": p20_launches["linear_recurrence_bwd"],
        "max_abs_err": errs["rglru_scan_bwd"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "loop_kernel_ms": t["loop_ms"],
        "launches_by_path": {
            "recurrentgemma_training": p20_launches["linear_recurrence_bwd"]}})
    # phase 24: the segmented D-80 instances, the vision tower's call
    for entry in (kernels[1], kernels[4]):
        name = entry["name"]
        entry["launches_by_path"]["qwen2_vl_tower"] = p24_launches[name]
        entry["qwen2_vl_tower_shape"] = p24_times[name]
    print(f"[phases] seconds by phase: {json.dumps(phase_s)}; total "
          f"{sum(phase_s.values()):.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
