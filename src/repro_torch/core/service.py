"""Batch-computing-service simulation (the paper's prototype, Figs. 4 & 8),
port of ``repro.core.service``.

Event-driven discrete simulator of the paper's service: a centralized
controller manages a cluster of preemptible VMs, schedules a *bag of jobs*
onto them using the model-driven policies, keeps stable VMs as hot spares
(<= 1 h), and accounts cost at preemptible vs on-demand prices.

The heap event loop is host numpy and is the ground truth; the device work
is done up front: lifetimes come from pooled inverse-CDF draws on
``device`` (:func:`draw_service_pool`, or one
``service_kernel.draw_service_pool_batch`` call for a whole grid) and the
model policy's reuse decisions are looked up in an
:class:`engine.ReuseTable` evaluated on ``device``.  :func:`run_bag_grid`
sweeps (policy x vm_type x cluster_size x seed) in one call, serially or
as one batched device loop (``service_kernel``) whose lanes are
bit-identical to this loop on shared pools and tables.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import distributions as dists
from . import engine
from .policies import scheduling as sched_policy

# Google Cloud n1-highcpu pricing (2019, us-central1, USD/hour) - the ~4.9x
# preemptible discount behind the paper's Fig. 8 "5x cheaper" result.
PRICES_ON_DEMAND = {
    "n1-highcpu-2": 0.0709 * 1.0, "n1-highcpu-4": 0.1418, "n1-highcpu-8": 0.2836,
    "n1-highcpu-16": 0.5672, "n1-highcpu-32": 1.1344, "tpu-v5e-pod": 307.2,
}
PRICES_PREEMPTIBLE = {
    "n1-highcpu-2": 0.0145, "n1-highcpu-4": 0.0289, "n1-highcpu-8": 0.0578,
    "n1-highcpu-16": 0.1156, "n1-highcpu-32": 0.2312, "tpu-v5e-pod": 62.0,
}
HOT_SPARE_HOURS = 1.0         # paper: keep stable VMs for one hour
RELAUNCH_OVERHEAD = 2.0 / 60.0  # VM provisioning time


def _normalize_dist(dist, device):
    """``dist`` with every field a float64 tensor on ``device``, so the
    serial and the batched pool draws run the same float64 arithmetic on
    the same device."""
    return dataclasses.replace(dist, **{
        f.name: torch.as_tensor(getattr(dist, f.name), dtype=torch.float64,
                                device=device)
        for f in dataclasses.fields(dist)})


def draw_service_pool(dist, *, seed: Optional[int] = None, rng=None,
                      size: int = 4096, device="cuda") -> np.ndarray:
    """One pooled lifetime draw for a service grid cell, as host float64.

    Consumes ``size`` uniforms from ``default_rng(seed)`` (or a caller's
    ``rng``, advancing it) and inverts them on ``device`` through
    ``engine.capped_icdf_draw``: the stream ``BatchService._model_sampler``
    consumes, so a pool drawn here and passed as ``lifetime_pool=`` leaves
    the serial results unchanged."""
    dev = resolve_device(device)
    if rng is None:
        rng = np.random.default_rng(seed)
    dist = _normalize_dist(dist, dev)
    u = torch.as_tensor(rng.uniform(size=size), device=dev)
    fl = torch.as_tensor(float(dist.cdf(dist.L)), dtype=torch.float64,
                         device=dev)
    return engine.capped_icdf_draw(dist, u, fl, float(dist.L)).cpu().numpy()


@dataclasses.dataclass
class Job:
    job_id: int
    length: float               # uninterrupted running time (hours)
    submitted: float = 0.0
    started: Optional[float] = None
    attempt_started: Optional[float] = None
    finished: Optional[float] = None
    attempts: int = 0
    failures: int = 0
    done_work: float = 0.0      # checkpointed progress (hours)


@dataclasses.dataclass
class VM:
    vm_id: int
    vm_type: str
    launched: float
    lifetime: float             # sampled preemption age (hours)
    job: Optional[int] = None   # running job id
    idle_since: Optional[float] = None
    terminated: Optional[float] = None

    def age(self, now: float) -> float:
        return now - self.launched

    @property
    def preempt_at(self) -> float:
        return self.launched + self.lifetime


@dataclasses.dataclass
class ServiceResult:
    makespan: float             # bag completion wall-time (hours)
    vm_hours: float
    cost: float
    on_demand_cost: float       # same bag on non-preemptible VMs, no failures
    n_preemptions: int          # preemptions that hit a running job
    n_job_failures: int
    jobs: list = dataclasses.field(default_factory=list)
    n_deflations: int = 0       # preemptions absorbed as capacity degradation
    n_rejected: int = 0         # jobs denied admission (deadline misses)
    dollars: float = 0.0        # market-priced cost (== ``cost`` when the
    #                             service was run without a price trace)

    @property
    def cost_reduction(self) -> float:
        return self.on_demand_cost / max(self.cost, 1e-9)


def _candidate_rem_values(lengths, checkpointing: bool = False,
                          ckpt_interval: float = 0.5) -> np.ndarray:
    """Every remaining-work value a job can present to the reuse policy:
    its full length, minus whole checkpoint intervals when checkpointing
    is on (progress is only banked at checkpoint boundaries)."""
    vals = list(map(float, lengths))
    if checkpointing:
        for l in map(float, lengths):
            k = 1
            while l - k * ckpt_interval > 0:
                vals.append(l - k * ckpt_interval)
                k += 1
    return np.asarray(vals)


class BatchService:
    """The controller: launches VMs, schedules jobs, reacts to preemptions.

    policy = "model"      : paper's reuse policy (Eq. 9 vs Eq. 10) + hot spares
    policy = "memoryless" : always reuse any idle VM; never relinquish early

    ``device`` is where lifetime pools are drawn and reuse tables (or, with
    ``vectorized_reuse=False``, each reuse decision) are evaluated; the
    event loop itself runs on the host.
    """

    def __init__(self, dist, *, vm_type: str = "n1-highcpu-32",
                 cluster_size: int = 32, policy: str = "model",
                 lifetimes_fn=None, seed: int = 0,
                 checkpointing: bool = False, ckpt_interval: float = 0.5,
                 ckpt_cost: float = 1.0 / 60.0,
                 reuse_table: Optional[engine.ReuseTable] = None,
                 vectorized_reuse: bool = True,
                 lifetime_pool: Optional[np.ndarray] = None,
                 pool_size: int = 4096,
                 price_trace: Optional[np.ndarray] = None,
                 price_dt: float = 1.0, device="cuda"):
        self.device = resolve_device(device)
        self.dist = dist
        self.vm_type = vm_type
        self.cluster_size = cluster_size
        self.policy = policy
        self.rng = np.random.default_rng(seed)
        self.lifetimes_fn = lifetimes_fn or self._model_sampler
        self.checkpointing = checkpointing
        self.ckpt_interval = ckpt_interval
        self.ckpt_cost = ckpt_cost
        self.reuse_table = reuse_table
        self.vectorized_reuse = vectorized_reuse
        self._run_reuse_table: Optional[engine.ReuseTable] = None
        # an externally drawn pool (from draw_service_pool[_batch] with THIS
        # seed) is consumed first; later refills skip the uniforms it used,
        # so the stream matches lazy draws of size 1
        self.pool_size = int(pool_size)
        if self.pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        # market billing: each VM is billed for all its vm-hours at the spot
        # price of its launch cell, ``price_trace[floor(launched /
        # price_dt)]`` (tail-clamped), at the four ``vm_hours`` increments
        if price_trace is not None:
            self._price_row = np.asarray(price_trace, np.float64)
            if self._price_row.ndim != 1 or self._price_row.size == 0:
                raise ValueError("price_trace must be a 1-D row of prices")
            if not np.all(self._price_row > 0):
                raise ValueError("price_trace must be strictly positive")
            self.price_dt = float(price_dt)
            if not self.price_dt > 0:
                raise ValueError("price_dt must be > 0")
        else:
            self._price_row = None
            self.price_dt = float(price_dt)
        if lifetime_pool is not None:
            self._pool = np.asarray(lifetime_pool, np.float64)
            self._pool_pos = 0
            self._pool_skip = len(self._pool)

    def _candidate_rem_values(self, lengths):
        return _candidate_rem_values(lengths, self.checkpointing,
                                     self.ckpt_interval)

    _dist_dev = None      # the model on ``device``, for per-call decisions
    _pool: Optional[np.ndarray] = None
    _pool_pos: int = 0
    _pool_skip: int = 0   # uniforms an externally drawn pool consumed

    def _model_sampler(self, rng, n):
        if n > self.pool_size:
            raise ValueError(f"sampler asked for {n} lifetimes at once; "
                             f"pool_size is {self.pool_size}")
        if self._pool is None or self._pool_pos + n > len(self._pool):
            if self._pool_skip:
                # realign the rng past the uniforms the external pool used
                rng.uniform(size=self._pool_skip)
                self._pool_skip = 0
            self._pool = draw_service_pool(self.dist, rng=rng,
                                           size=self.pool_size,
                                           device=self.device)
            self._pool_pos = 0
        out = self._pool[self._pool_pos:self._pool_pos + n]
        self._pool_pos += n
        return out

    # -- policy hooks -------------------------------------------------------
    def _approve_reuse(self, vm: VM, job: Job, now: float) -> bool:
        if self.policy == "memoryless":
            return True
        rem = job.length - job.done_work
        if self._run_reuse_table is not None:
            return self._run_reuse_table.decide(rem, vm.age(now))
        if self._dist_dev is None:
            self._dist_dev = _normalize_dist(self.dist, self.device)
        return bool(sched_policy.reuse_decision(self._dist_dev, rem,
                                                vm.age(now)))

    # -- simulation ---------------------------------------------------------
    def run(self, job_lengths) -> ServiceResult:
        # per-run table: a user-supplied reuse_table is trusted to cover the
        # bag; otherwise build one from THIS bag's lengths
        if self.policy != "model":
            self._run_reuse_table = None
        elif self.reuse_table is not None:
            self._run_reuse_table = self.reuse_table
        elif self.vectorized_reuse:
            self._run_reuse_table = engine.ReuseTable(
                self.dist, self._candidate_rem_values(job_lengths),
                device=self.device)
        else:
            self._run_reuse_table = None
        jobs = [Job(i, float(l)) for i, l in enumerate(job_lengths)]
        queue = list(range(len(jobs)))
        vms: dict[int, VM] = {}
        events: list = []   # (time, seq, kind, vm_id)
        seq = 0
        now = 0.0
        vm_hours = 0.0
        dollars = 0.0
        n_preempt = 0
        n_fail = 0
        next_vm_id = 0

        def launch_price(vm: VM) -> float:
            # the VM's locked-in spot price: its launch cell on the trace
            row = self._price_row
            k = min(int(vm.launched / self.price_dt), len(row) - 1)
            return float(row[max(k, 0)])

        def bill(vm: VM, inc: float) -> float:
            """Dollar increment for ``inc`` vm-hours on ``vm``: one product
            per vm_hours increment, in the same order."""
            if self._price_row is None:
                return 0.0
            return inc * launch_price(vm)

        def launch_vm(t):
            nonlocal next_vm_id, seq
            life = float(self.lifetimes_fn(self.rng, 1)[0])
            vm = VM(next_vm_id, self.vm_type, t, life)
            vms[vm.vm_id] = vm
            next_vm_id += 1
            heapq.heappush(events, (vm.preempt_at, seq, "preempt", vm.vm_id))
            seq += 1
            return vm

        def segment_time(job: Job) -> float:
            """Wall time for the job's next run-to-completion attempt,
            including checkpoint writes if enabled."""
            rem = job.length - job.done_work
            if not self.checkpointing:
                return rem
            n_ck = int(rem / self.ckpt_interval)
            return rem + n_ck * self.ckpt_cost

        def start_job(vm: VM, job: Job, t):
            nonlocal seq
            vm.job = job.job_id
            vm.idle_since = None
            job.attempts += 1
            job.attempt_started = t
            if job.started is None:
                job.started = t
            # fresh VMs are launched (and billed) RELAUNCH_OVERHEAD later in
            # assign(); reused hot spares are already provisioned
            finish_at = t + segment_time(job)
            heapq.heappush(events, (finish_at, seq, "finish", vm.vm_id))
            seq += 1

        def assign(t):
            """Greedy scheduling loop at time t."""
            nonlocal seq, vm_hours, dollars
            if not queue:
                # bag of jobs: no further work is coming, so idle spares
                # are released immediately
                for vm in vms.values():
                    if vm.job is None and vm.terminated is None:
                        vm.terminated = t
                        vm_hours += t - vm.launched
                        dollars += bill(vm, t - vm.launched)
                return
            while queue:
                job = jobs[queue[0]]
                # prefer an idle (hot-spare) VM the policy approves of
                cand = None
                for vm in vms.values():
                    if vm.job is None and vm.terminated is None:
                        if self._approve_reuse(vm, job, t):
                            cand = vm
                            break
                if cand is None:
                    active = sum(1 for v in vms.values()
                                 if v.terminated is None)
                    if active < self.cluster_size:
                        cand = launch_vm(t + RELAUNCH_OVERHEAD)
                        queue.pop(0)
                        start_job(cand, job, t + RELAUNCH_OVERHEAD)
                        continue
                    break  # cluster full; wait for a finish/preempt event
                queue.pop(0)
                start_job(cand, job, t)

        assign(0.0)
        while events:
            now, _, kind, vm_id = heapq.heappop(events)
            vm = vms[vm_id]
            if vm.terminated is not None:
                continue
            if kind == "finish":
                if vm.job is None:
                    continue
                job = jobs[vm.job]
                # stale finish event (job was preempted and restarted)?
                if job.finished is not None or now > vm.preempt_at:
                    continue
                job.finished = now
                job.done_work = job.length
                vm.job = None
                vm.idle_since = now
                # the global seq keeps heap keys unique
                heapq.heappush(events, (now + HOT_SPARE_HOURS, seq,
                                        "expire", vm_id))
                seq += 1
                assign(now)
            elif kind == "preempt":
                vm.terminated = now
                vm_hours += min(now - vm.launched, vm.lifetime)
                dollars += bill(vm, min(now - vm.launched, vm.lifetime))
                if vm.job is not None:
                    job = jobs[vm.job]
                    if job.finished is None:
                        n_preempt += 1
                        job.failures += 1
                        n_fail += 1
                        if self.checkpointing:
                            # progress up to the last completed checkpoint
                            # of THIS attempt
                            ran = max(now - (job.attempt_started or now), 0.0)
                            k = int(ran / (self.ckpt_interval
                                           + self.ckpt_cost))
                            job.done_work = min(job.done_work
                                                + k * self.ckpt_interval,
                                                job.length)
                        queue.insert(0, job.job_id)
                    vm.job = None
                assign(now)
            elif kind == "expire":
                if vm.job is None and vm.terminated is None and \
                        vm.idle_since is not None and \
                        now - vm.idle_since >= HOT_SPARE_HOURS - 1e-9:
                    vm.terminated = now
                    vm_hours += now - vm.launched
                    dollars += bill(vm, now - vm.launched)
                    # the expired spare freed capacity: jobs denied reuse
                    # while the cluster was full can now get a fresh VM
                    assign(now)
            if all(j.finished is not None for j in jobs):
                break

        # account still-running VMs
        for vm in vms.values():
            if vm.terminated is None:
                vm_hours += now - vm.launched
                dollars += bill(vm, now - vm.launched)
        makespan = max((j.finished or now) for j in jobs)
        price = PRICES_PREEMPTIBLE[self.vm_type]
        od_price = PRICES_ON_DEMAND[self.vm_type]
        # on-demand reference: same bag, no preemptions, perfect packing
        total_work = float(np.sum([j.length for j in jobs]))
        on_demand_cost = total_work * od_price
        cost = vm_hours * price
        return ServiceResult(makespan=makespan, vm_hours=vm_hours,
                             cost=cost,
                             on_demand_cost=on_demand_cost,
                             n_preemptions=n_preempt, n_job_failures=n_fail,
                             jobs=jobs,
                             dollars=dollars if self._price_row is not None
                             else cost)


def _bag_lengths(n_jobs: int, job_hours: float, jitter: float, seed: int):
    rng = np.random.default_rng(seed + 1)
    return job_hours * (1.0 + jitter * (rng.uniform(size=n_jobs) - 0.5))


def grid_reuse_values(dist, *, seeds, n_jobs: int, job_hours: float,
                      jitter: float, checkpointing: bool = False,
                      ckpt_interval: float = 0.5, **_kw) -> np.ndarray:
    """Every remaining-work value a ``run_bag_grid`` call with these
    parameters can present to the reuse policy (the union of all seeds'
    bag lengths, expanded for checkpoint banking).  ``dist`` and the other
    ``BatchService`` keywords do not change the values; they are accepted
    so a caller can pass its grid's keywords through."""
    lengths = np.concatenate([_bag_lengths(n_jobs, job_hours, jitter, s)
                              for s in seeds])
    return _candidate_rem_values(lengths, checkpointing, ckpt_interval)


def run_bag(dist, *, n_jobs: int = 100, job_hours: float = 2.0,
            jitter: float = 0.1, cluster_size: int = 32,
            vm_type: str = "n1-highcpu-32", policy: str = "model",
            seed: int = 0, lifetimes_fn=None, device="cuda",
            **kw) -> ServiceResult:
    """Paper Fig. 8 setup: a bag of ~uniform-length jobs on a 32-VM
    cluster."""
    lengths = _bag_lengths(n_jobs, job_hours, jitter, seed)
    svc = BatchService(dist, vm_type=vm_type, cluster_size=cluster_size,
                       policy=policy, seed=seed, lifetimes_fn=lifetimes_fn,
                       device=device, **kw)
    return svc.run(lengths)


def run_bag_grid(*, vm_types=("n1-highcpu-32",), policies=("model",),
                 cluster_sizes=(32,), seeds=(0,), n_jobs: int = 100,
                 job_hours: float = 2.0, jitter: float = 0.1, dist_for=None,
                 reuse_table: Optional[engine.ReuseTable] = None,
                 mode: str = "serial", pool_size: int = 4096,
                 deadline_hours: Optional[float] = None,
                 deflate_factor: float = 0.5, device="cuda", **kw) -> list:
    """Sweep ``run_bag`` over the (policy x vm_type x cluster_size x seed)
    grid in one call, sharing the device work.

    The model policy's reuse decisions for the whole grid come from ONE
    :class:`engine.ReuseTables` evaluation over the union of every seed's
    job lengths (the VM types' distributions share the deadline ``L``).
    Lifetime pools are drawn once per unique ``(vm_type, seed)`` pair
    (``service_kernel.draw_service_pool_batch``) and handed to each cell,
    so the serial event loops run entirely on the host and both modes
    consume identical streams.  A caller that already holds a table (e.g.
    ``scenarios.sweep_service``) can pass it as ``reuse_table``
    (single-vm_type grids only).

    ``mode="batched"`` runs every cell as one lane of ONE
    ``service_kernel`` loop on ``device`` (bit-identical rows); it also
    allows ``deadline_hours`` admission control and ``"+deflate"``
    policies (VM deflation at ``deflate_factor``).  Returns a list of dict
    rows with the grid coordinates and the :class:`ServiceResult`.
    """
    from . import service_kernel  # deferred: service_kernel imports us
    dev = resolve_device(device)
    dist_for = dist_for or dists.constrained_for
    vm_types = tuple(vm_types)
    policies, cluster_sizes = tuple(policies), tuple(cluster_sizes)
    seeds = tuple(seeds)
    if mode not in ("serial", "batched"):
        raise ValueError(f"unknown mode {mode!r}")
    bases = [service_kernel.split_policy(p)[0] for p in policies]
    if mode == "serial":
        if deadline_hours is not None:
            raise ValueError("deadline admission control needs "
                             "mode='batched'")
        if any(service_kernel.split_policy(p)[1] for p in policies):
            raise ValueError("'+deflate' policies need mode='batched'")
    if reuse_table is not None and len(vm_types) != 1:
        raise ValueError("a shared reuse_table implies a single-distribution "
                         "grid; pass one vm_type")
    lengths = {s: _bag_lengths(n_jobs, job_hours, jitter, s) for s in seeds}
    dist_list = [dist_for(vt) for vt in vm_types]

    tables = None
    table_views = None
    if reuse_table is not None:
        tables = _tables_from_view(reuse_table)
        table_views = [reuse_table]
    elif "model" in bases and kw.get("vectorized_reuse", True):
        values = grid_reuse_values(
            dist_list[0], seeds=seeds, n_jobs=n_jobs, job_hours=job_hours,
            jitter=jitter, **kw)
        Ls = [float(d.L) for d in dist_list]
        if max(Ls) - min(Ls) <= 1e-12:
            tables = engine.ReuseTables(dist_list, values, device=dev)
            table_views = [tables.view(ti) for ti in range(len(vm_types))]
        elif mode == "batched":
            raise ValueError("mode='batched' folds all vm_types into one "
                             "reuse tensor and needs a shared deadline L")
        else:
            table_views = [engine.ReuseTable(d, values, device=dev)
                           for d in dist_list]

    if mode == "batched":
        unsupported = set(kw) - {"checkpointing", "ckpt_interval",
                                 "ckpt_cost", "vectorized_reuse"}
        if unsupported:
            raise ValueError(f"mode='batched' does not support "
                             f"{sorted(unsupported)}")
        if tables is None and "model" in bases:
            raise ValueError("mode='batched' model cells need vectorized "
                             "reuse tables (vectorized_reuse=True)")
        cells = [dict(dist_index=di, vm_type=vt, policy=policy,
                      cluster_size=cs, seed=seed)
                 for di, vt in enumerate(vm_types)
                 for policy, cs, seed in itertools.product(
                     policies, cluster_sizes, seeds)]
        return service_kernel.run_cells_batched(
            cells=cells, dists=dist_list, lengths_by_seed=lengths,
            reuse_tables=tables, pool_size=pool_size,
            deadline_hours=deadline_hours, deflate_factor=deflate_factor,
            checkpointing=kw.get("checkpointing", False),
            ckpt_interval=kw.get("ckpt_interval", 0.5),
            ckpt_cost=kw.get("ckpt_cost", 1.0 / 60.0),
            return_jobs=n_jobs <= 2048, device=dev)

    pools = None
    if "lifetimes_fn" not in kw:
        pairs = [(ti, s) for ti in range(len(vm_types)) for s in seeds]
        pool_mat = service_kernel.draw_service_pool_batch(
            [dist_list[ti] for ti, _ in pairs], [s for _, s in pairs],
            size=pool_size, device=dev).cpu().numpy()
        pools = {(vm_types[ti], s): pool_mat[i]
                 for i, (ti, s) in enumerate(pairs)}
    rows = []
    for ti, vm_type in enumerate(vm_types):
        dist = dist_list[ti]
        table = table_views[ti] if table_views is not None else None
        for policy, cs, seed in itertools.product(policies, cluster_sizes,
                                                  seeds):
            svc = BatchService(
                dist, vm_type=vm_type, cluster_size=cs, policy=policy,
                seed=seed, reuse_table=table if policy == "model" else None,
                pool_size=pool_size,
                lifetime_pool=(None if pools is None
                               else pools[(vm_type, seed)]),
                device=dev, **kw)
            rows.append(dict(vm_type=vm_type, policy=policy, cluster_size=cs,
                             seed=seed, result=svc.run(lengths[seed])))
    return rows


def _tables_from_view(table: engine.ReuseTable) -> engine.ReuseTables:
    """Lift a single :class:`engine.ReuseTable` view into a one-entry
    :class:`engine.ReuseTables`-shaped batch over the same tensor."""
    out = engine.ReuseTables.__new__(engine.ReuseTables)
    out._dists = [None]
    out.T_values = table.T_values
    out.L = table.L
    out.n_age = table.n_age
    out.tensor = table.tensor[None]
    out.tables = table.table[None]
    return out
