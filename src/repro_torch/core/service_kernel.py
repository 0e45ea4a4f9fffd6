"""The batch service's event loop over ``(B,)`` lanes on the device, port of
``repro.core.service_kernel``.

``service.BatchService`` replays the paper's batch-computing service one
heap event at a time on the host.  Here the same loop runs for B lanes at
once over fixed-shape tensors:

  * ``(B, J)`` job state - done work, finish time, failure/attempt counts,
    admission verdicts;
  * ``(B, V)`` VM-slot state - launch time, sampled lifetime, running job,
    hot-spare expiry, per-event sequence numbers, fractional capacity;
  * ``(B,)`` scalars - clock, counters, the preempted-job stack.

Each step advances every lane by ONE logical step: a *scheduling step*
(one iteration of the serial loop's greedy ``assign``: reuse an approved
hot spare / launch a fresh VM / reject on a missed deadline / release an
idle spare / block) or an *event step* (the next finish / preempt / expire,
the lexicographic ``(time, seq)`` minimum over the slots' candidates, the
serial heap's order).  Both branches are computed for every lane and merged
by ``where(active, where(pending, assign, event), old)``; array writes are
masked scatters gated the same way.  A lane freezes once it is done,
halted or out of steps, so the host tests ``any(active)`` only once per
block of ``_CHECK_EVERY`` steps and never syncs inside a block: the extra
steps of a frozen lane change nothing.

Bit-exactness contract: in float64 on a shared lifetime pool and reuse
table, a lane is bit-identical to ``service.BatchService.run`` and to
``repro``'s kernel under x64 - per-job completion times, failure/attempt
counts, ``vm_hours``/``dollars`` accumulation order and the event order
all match.  Every divisor is a float64 tensor on the device (CUDA divides
by a host scalar as a multiplication by its reciprocal), floats become
integers by truncation, the age index rounds half to even, and the
epilogue bills still-alive VMs one at a time in launch order.

Kernel-only policy branches, as in ``repro``: deadline admission control
(a job whose estimated completion misses its deadline is rejected before a
VM is launched) and VM deflation (``"+deflate"``: the first preemption of
a running VM degrades it to ``deflate_factor`` capacity with a fresh
lifetime instead of killing it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import distributions as dists_mod
from . import engine
from .service import (HOT_SPARE_HOURS, PRICES_ON_DEMAND, PRICES_PREEMPTIBLE,
                      RELAUNCH_OVERHEAD, Job, ServiceResult, _normalize_dist)

POLICY_MODEL = 0
POLICY_MEMORYLESS = 1
POLICY_CODES = {"model": POLICY_MODEL, "memoryless": POLICY_MEMORYLESS}

_BIG = 2 ** 30  # int sentinel > any seq/ord the loop can allocate
_F64, _I64 = torch.float64, torch.int64

# steps run between two host checks of "is any lane still active"
_CHECK_EVERY = 8

_SCALARS = ("now", "seq", "cursor", "n_launch", "n_active", "n_done",
            "n_preempt", "n_fail", "n_defl", "n_rej", "n_events", "steps",
            "vm_hours", "dollars", "pending", "halt", "exhausted",
            "rel_mode", "stack_len", "next_fresh")


def split_policy(name: str) -> tuple[str, bool]:
    """``"model+deflate"`` -> ``("model", True)``; validates the base."""
    base, _, mod = name.partition("+")
    if base not in POLICY_CODES or mod not in ("", "deflate"):
        raise ValueError(f"unknown service policy {name!r}; expected "
                         f"{sorted(POLICY_CODES)} with optional '+deflate'")
    return base, mod == "deflate"


# ---------------------------------------------------------------------------
# pooled lifetime streams
# ---------------------------------------------------------------------------

def draw_service_pool_batch(dists, seeds, *, size: int = 4096,
                            device="cuda") -> torch.Tensor:
    """One ``(Q, size)`` float64 tensor of service lifetime pools on
    ``device``, from one inverse-CDF evaluation.

    Entry ``q`` inverts the uniforms ``default_rng(seeds[q]).uniform(size)``
    (drawn once per unique seed) under ``dists[q]``, through
    ``engine.capped_icdf_draw``: the stream ``service.draw_service_pool``
    draws for that (dist, seed)."""
    dev = resolve_device(device)
    dists = list(dists)
    seeds = [int(s) for s in seeds]
    if len(dists) != len(seeds):
        raise ValueError(f"dists ({len(dists)}) and seeds ({len(seeds)}) "
                         "must align")
    norm = [_normalize_dist(d, dev) for d in dists]
    eff = [d.effective() if hasattr(d, "effective") else d for d in norm]
    uniq: dict[int, int] = {}
    blocks = []
    for s in seeds:
        if s not in uniq:
            uniq[s] = len(blocks)
            blocks.append(np.random.default_rng(s).uniform(size=size))
    u = torch.as_tensor(np.stack(blocks), device=dev)[
        torch.as_tensor([uniq[s] for s in seeds], device=dev)]
    stacked = dists_mod.stack(eff, device=dev)
    d_b = dataclasses.replace(stacked, **{
        f.name: getattr(stacked, f.name)[:, None]
        for f in dataclasses.fields(stacked)})
    fl = torch.tensor([[float(d.cdf(d.L))] for d in eff], dtype=_F64,
                      device=dev)
    L = torch.tensor([[float(d.L)] for d in eff], dtype=_F64, device=dev)
    return engine.capped_icdf_draw(d_b, u, fl, L)


# ---------------------------------------------------------------------------
# the step over (B,) lanes
# ---------------------------------------------------------------------------

def _g(arr, idx):
    """``arr[b, idx[b]]`` for every lane b."""
    return arr.gather(1, idx[:, None])[:, 0]


def _init_state(B, J, V, dev):
    def sc(v, dt):
        return torch.full((B,), v, dtype=dt, device=dev)

    def ar(n, v, dt):
        return torch.full((B, n), v, dtype=dt, device=dev)

    inf = float("inf")
    s = {k: sc(0, _I64) for k in _SCALARS}
    s.update(now=sc(0.0, _F64), vm_hours=sc(0.0, _F64),
             dollars=sc(0.0, _F64), pending=sc(True, torch.bool),
             halt=sc(False, torch.bool), exhausted=sc(False, torch.bool),
             rel_mode=sc(False, torch.bool))
    s.update(
        stack=ar(V, 0, _I64), alive=ar(V, False, torch.bool),
        launched=ar(V, 0.0, _F64), life=ar(V, 0.0, _F64),
        pre_at=ar(V, inf, _F64), seq_p=ar(V, 0, _I64), job=ar(V, -1, _I64),
        fin_at=ar(V, inf, _F64), seq_f=ar(V, 0, _I64),
        has_exp=ar(V, False, torch.bool), exp_at=ar(V, inf, _F64),
        seq_e=ar(V, 0, _I64), ordv=ar(V, 0, _I64), cap=ar(V, 1.0, _F64),
        defl=ar(V, False, torch.bool), att_start=ar(V, 0.0, _F64),
        att_w0=ar(V, 0.0, _F64), att_done=ar(V, 0.0, _F64),
        stack_done=ar(V, 0.0, _F64),
        done=ar(J, 0.0, _F64), fin_t=ar(J, float("nan"), _F64),
        failures=ar(J, 0, _I64), attempts=ar(J, 0, _I64),
        rejected=ar(J, False, torch.bool))
    return s


def _active(s, J, max_steps):
    return (s["n_done"] < J) & ~s["halt"] & (s["steps"] < max_steps)


def _launch_price(c, launched):
    """The VM's locked-in spot price: its launch cell on the lane's price
    row (``floor`` then truncation to an integer, tail-clamped)."""
    Tp = c["price"].shape[1]
    k = torch.clamp(torch.floor(launched / c["price_dt"]).to(_I64), 0, Tp - 1)
    return _g(c["price"], k)


def _assign_step(s, c):
    """ONE iteration of the serial loop's greedy ``assign(t)`` for every
    lane: (scalar updates, per-array writes ``(index, value, flag)``)."""
    J = c["lengths"].shape[1]
    P = c["pools"].shape[1]
    Tn = c["T_values"].shape[0]
    A = c["tables"].shape[2]
    V = s["alive"].shape[1]
    now, seqv = s["now"], s["seq"]
    q_empty = (s["stack_len"] == 0) & (s["next_fresh"] >= J)
    idle = s["alive"] & (s["job"] < 0)
    any_idle = idle.any(1)
    # release idle spares one per step, in launch order; ``rel_mode``
    # snapshots whether the serial assign was ENTERED with an empty queue
    rel = torch.argmin(torch.where(idle, s["ordv"], _BIG), 1)
    rel_mode = s["rel_mode"]
    b_release = rel_mode & any_idle
    b_stop = (rel_mode & ~any_idle) | (~rel_mode & q_empty)

    top = torch.clamp(s["stack_len"] - 1, min=0)
    from_stack = s["stack_len"] > 0
    head = torch.where(from_stack, _g(s["stack"], top),
                       torch.clamp(s["next_fresh"], max=J - 1))
    length_h = c["lengths"][c["bag_index"], head]
    done_h = torch.where(from_stack, _g(s["stack_done"], top), 0.0)
    rem = length_h - done_h
    if c["ckpt_on"]:
        n_ck = torch.floor(rem / c["ckpt_interval"]).to(_I64).to(_F64)
        seg = rem + n_ck * c["ckpt_cost"]
    else:
        seg = rem

    # model-policy approval: ReuseTable.decide's index arithmetic over the
    # V candidate slots
    age = now[:, None] - s["launched"]
    T_values = c["T_values"]
    ti = torch.searchsorted(T_values, rem)
    t_lo = T_values[torch.clamp(ti - 1, min=0)]
    t_hi = T_values[torch.clamp(ti, max=Tn - 1)]
    adj = (ti >= Tn) | ((ti > 0) & (rem - t_lo < t_hi - rem))
    ti = torch.clamp(ti - adj.to(_I64), 0, Tn - 1)
    ai = torch.clamp(torch.round(age / c["reuse_L"] * (A - 1)).to(_I64),
                     0, A - 1)
    appr = torch.where((c["policy"] == POLICY_MEMORYLESS)[:, None], True,
                       c["tables"][c["table_index"][:, None], ti[:, None],
                                   ai])
    approved = idle & appr
    any_appr = approved.any(1)
    cand = torch.argmin(torch.where(approved, s["ordv"], _BIG), 1)

    can_launch = s["n_active"] < c["cluster_size"]
    free = torch.argmin(torch.where(s["alive"], _BIG, c["slot_ids"]), 1)
    cap_c = _g(s["cap"], cand)
    start_l = now + c["relaunch_overhead"]
    est_reuse = now + seg / cap_c
    est_launch = start_l + seg
    dl = c["deadlines"][c["bag_index"], head]
    rej_reuse = est_reuse > dl
    rej_launch = est_launch > dl

    b_reuse = ~q_empty & any_appr & ~rej_reuse
    b_rejct = ~q_empty & ((any_appr & rej_reuse)
                          | (~any_appr & can_launch & rej_launch))
    b_launch = ~q_empty & ~any_appr & can_launch & ~rej_launch
    b_block = ~q_empty & ~any_appr & ~can_launch
    pop = b_reuse | b_rejct | b_launch
    b_start = b_reuse | b_launch
    slot = torch.where(b_reuse, cand, free)
    start_t = torch.where(b_reuse, now, start_l)
    life_new = c["pools"][c["pool_index"],
                          torch.clamp(s["cursor"], max=P - 1)]
    pop_stack = pop & (s["stack_len"] > 0)
    fin_val = torch.where(b_reuse, now + seg / cap_c, start_l + seg)
    l_rel = _g(s["launched"], rel)
    up = dict(
        vm_hours=s["vm_hours"] + torch.where(b_release, now - l_rel, 0.0),
        # dollars mirrors every vm_hours increment at the launch-cell price
        dollars=s["dollars"] + torch.where(
            b_release, (now - l_rel) * _launch_price(c, l_rel), 0.0),
        pending=~(b_stop | b_block),
        stack_len=s["stack_len"] - pop_stack.to(_I64),
        next_fresh=s["next_fresh"] + (pop & ~pop_stack).to(_I64),
        n_rej=s["n_rej"] + b_rejct.to(_I64),
        n_done=s["n_done"] + b_rejct.to(_I64),
        cursor=s["cursor"] + b_launch.to(_I64),
        exhausted=s["exhausted"] | (b_launch & (s["cursor"] >= P)),
        n_launch=s["n_launch"] + b_launch.to(_I64),
        n_active=(s["n_active"] + b_launch.to(_I64)
                  - b_release.to(_I64)),
        seq=seqv + torch.where(b_launch, 2, torch.where(b_reuse, 1, 0)))
    writes = dict(
        alive=[(rel, False, b_release), (free, True, b_launch)],
        rejected=[(head, True, b_rejct)],
        # fresh launch at now + relaunch_overhead
        launched=[(free, start_l, b_launch)],
        life=[(free, life_new, b_launch)],
        pre_at=[(free, start_l + life_new, b_launch)],
        seq_p=[(free, seqv, b_launch)],
        ordv=[(free, s["n_launch"], b_launch)],
        cap=[(free, 1.0, b_launch)],
        defl=[(free, False, b_launch)],
        # start the job (reused spare at now, fresh VM at start_l)
        job=[(slot, head, b_start)],
        att_start=[(slot, start_t, b_start)],
        att_w0=[(slot, 0.0, b_start)],
        att_done=[(slot, done_h, b_start)],
        fin_at=[(slot, fin_val, b_start)],
        seq_f=[(slot, torch.where(b_reuse, seqv, seqv + 1), b_start)],
        has_exp=[(slot, False, b_start)],
        attempts=[(head, _g(s["attempts"], head) + 1, b_start)])
    return up, writes


def _event_step(s, c):
    """Advance every lane to its next (time, seq)-minimal finish / preempt
    / expire: (scalar updates, per-array writes)."""
    J = c["lengths"].shape[1]
    P = c["pools"].shape[1]
    B, V = s["alive"].shape
    times = torch.stack([s["pre_at"], s["fin_at"], s["exp_at"]], 1)
    valid = torch.stack([s["alive"], s["alive"] & (s["job"] >= 0),
                         s["alive"] & (s["job"] < 0) & s["has_exp"]], 1)
    seqs = torch.stack([s["seq_p"], s["seq_f"], s["seq_e"]], 1)
    tt = torch.where(valid, times, float("inf"))
    t_min = tt.reshape(B, -1).amin(1)
    live = torch.isfinite(t_min)
    sq = torch.where(valid & (tt == t_min[:, None, None]), seqs, _BIG)
    # first-index argmin over the kind-major (3, V) flattening
    flat = torch.argmin(sq.reshape(B, -1), 1)
    kind = flat // V
    v = flat % V
    now = torch.where(live, t_min, s["now"])
    j = _g(s["job"], v)
    j0 = torch.clamp(j, 0, J - 1)

    k_pre = live & (kind == 0)
    k_fin = live & (kind == 1)
    k_exp = live & (kind == 2)
    defl_now = k_pre & c["deflate"] & (j >= 0) & ~_g(s["defl"], v)
    kill = k_pre & ~defl_now
    # a slot with job >= 0 always holds an unfinished job
    job_running = kill & (j >= 0)

    l_v = _g(s["launched"], v)
    cap_v = _g(s["cap"], v)
    att_start_v = _g(s["att_start"], v)
    att_w0_v = _g(s["att_w0"], v)
    att_done_v = _g(s["att_done"], v)
    dvh_kill = torch.minimum(now - l_v, _g(s["life"], v))
    dvh_exp = now - l_v
    # checkpoint banking: whole (interval + cost) blocks of this attempt's
    # work-equivalent progress
    ran = torch.clamp(now - att_start_v, min=0.0)
    w = att_w0_v + ran * cap_v
    kck = torch.floor(w / c["ckpt_period"]).to(_I64).to(_F64)
    len_j = c["lengths"][c["bag_index"], j0]
    bank = torch.minimum(att_done_v + kck * c["ckpt_interval"], len_j)
    sl = torch.clamp(s["stack_len"], 0, V - 1)
    stack_len = s["stack_len"] + job_running.to(_I64)
    # deflation: the survivor draws a fresh lifetime at the pool cursor
    life_new = c["pools"][c["pool_index"],
                          torch.clamp(s["cursor"], max=P - 1)]
    w0 = att_w0_v + (now - att_start_v) * cap_v
    fin2 = now + (_g(s["fin_at"], v) - now) * cap_v / c["deflate_factor"]
    price_v = _launch_price(c, l_v)
    up = dict(
        now=now, halt=~live,
        pending=k_fin | kill | k_exp,
        n_events=s["n_events"] + live.to(_I64),
        n_done=s["n_done"] + k_fin.to(_I64),
        seq=s["seq"] + (k_fin | defl_now).to(_I64),
        vm_hours=(s["vm_hours"] + torch.where(kill, dvh_kill, 0.0)
                  + torch.where(k_exp, dvh_exp, 0.0)),
        # kill and expire are exclusive: one product is billed, the other
        # add is +0.0
        dollars=(s["dollars"] + torch.where(kill, dvh_kill * price_v, 0.0)
                 + torch.where(k_exp, dvh_exp * price_v, 0.0)),
        n_active=s["n_active"] - (kill | k_exp).to(_I64),
        n_preempt=s["n_preempt"] + job_running.to(_I64),
        n_fail=s["n_fail"] + job_running.to(_I64),
        stack_len=stack_len,
        # the serial assign(now) releases idle spares only when ENTERED
        # with an empty queue: snapshot that entry condition
        rel_mode=(stack_len == 0) & (s["next_fresh"] >= J),
        cursor=s["cursor"] + defl_now.to(_I64),
        exhausted=s["exhausted"] | (defl_now & (s["cursor"] >= P)),
        n_defl=s["n_defl"] + defl_now.to(_I64))
    writes = dict(
        # finish: the job completes, the VM becomes a hot spare (finish and
        # checkpoint banking are exclusive: the merged ``done`` write picks
        # by flag)
        fin_t=[(j0, now, k_fin)],
        done=[(j0, torch.where(k_fin, len_j, bank),
               k_fin | (job_running & c["ckpt_on"]))],
        job=[(v, -1, k_fin | kill)],
        exp_at=[(v, now + c["hot_spare_hours"], k_fin)],
        seq_e=[(v, s["seq"], k_fin)],
        has_exp=[(v, k_fin, k_fin | k_exp)],
        # preempt (kill) / expire: the slot dies, its wall-clock is billed
        alive=[(v, False, kill | k_exp)],
        failures=[(j0, _g(s["failures"], j0) + 1, job_running)],
        # the preempted job goes to the FRONT of the queue with its banked
        # work
        stack=[(sl, j0, job_running)],
        stack_done=[(sl, bank if c["ckpt_on"] else att_done_v,
                     job_running)],
        # deflation: capacity degrades, the segment stretches, the survivor
        # draws a fresh lifetime (one deflation per VM life)
        att_w0=[(v, w0, defl_now)],
        att_start=[(v, now, defl_now)],
        fin_at=[(v, fin2, defl_now)],
        cap=[(v, c["deflate_factor"], defl_now)],
        defl=[(v, True, defl_now)],
        pre_at=[(v, now + life_new, defl_now)],
        life=[(v, now + life_new - l_v, defl_now)],
        seq_p=[(v, s["seq"], defl_now)])
    return up, writes


def _step(s, c):
    """One step of every lane, in place on the state ``s``.  A lane that
    is done, halted or out of steps keeps its state: its scalars are
    where'd back and ``active`` gates every write."""
    J = c["lengths"].shape[1]
    active = _active(s, J, c["max_steps"])
    p = s["pending"]
    sa, wa = _assign_step(s, c)
    se, we = _event_step(s, c)
    for k in set(sa) | set(se):
        a, e = sa.get(k, s[k]), se.get(k, s[k])
        s[k] = torch.where(active, torch.where(p, a, e), s[k])
    pa, pe = p & active, ~p & active
    for k in set(wa) | set(we):
        arr = s[k]
        la, le = wa.get(k, []), we.get(k, [])
        # a lane takes one branch, so the i-th write of each branch can
        # share one masked scatter; writes within a branch stay in order
        for i in range(max(len(la), len(le))):
            if i < len(la) and i < len(le):
                (ia, va, fa), (ie, ve, fe) = la[i], le[i]
                idx = torch.where(p, ia, ie)
                val = torch.where(p, va, ve)
                flag = torch.where(p, fa, fe) & active
            elif i < len(la):
                idx, val, flag = la[i][0], la[i][1], la[i][2] & pa
            else:
                idx, val, flag = le[i][0], le[i][1], le[i][2] & pe
            old = arr.gather(1, idx[:, None])
            arr.scatter_(1, idx[:, None],
                         torch.where(flag[:, None], _col(val, arr), old))
    s["steps"] = s["steps"] + active.to(_I64)


def _col(val, arr):
    """A write's value as a ``(B, 1)`` column (or a scalar) of ``arr``'s
    dtype."""
    if isinstance(val, torch.Tensor):
        return val.to(arr.dtype)[:, None]
    return val


def _epilogue(s, c):
    """Per-lane exit accounting: still-alive VMs are billed one at a time
    in launch order, as the serial epilogue bills them."""
    J = c["lengths"].shape[1]
    V = s["alive"].shape[1]
    order = torch.argsort(torch.where(s["alive"], s["ordv"], _BIG), dim=1)
    vm_hours, dollars = s["vm_hours"], s["dollars"]
    for i in range(V):
        v = order[:, i]
        alive = _g(s["alive"], v)
        l_v = _g(s["launched"], v)
        inc = s["now"] - l_v
        vm_hours = vm_hours + torch.where(alive, inc, 0.0)
        dollars = dollars + torch.where(alive, inc * _launch_price(c, l_v),
                                        0.0)
    makespan = torch.where(torch.isnan(s["fin_t"]), s["now"][:, None],
                           s["fin_t"]).amax(1)
    unfinished = s["n_done"] < J
    return dict(
        makespan=makespan, vm_hours=vm_hours, dollars=dollars,
        final_time=s["now"],
        n_preemptions=s["n_preempt"], n_job_failures=s["n_fail"],
        n_deflations=s["n_defl"], n_rejected=s["n_rej"],
        n_launches=s["n_launch"], n_events=s["n_events"],
        steps=s["steps"], n_done=s["n_done"],
        pool_exhausted=s["exhausted"],
        deadlocked=s["halt"] & unfinished,
        truncated=(s["steps"] >= c["max_steps"]) & unfinished,
        finished_time=s["fin_t"], failures=s["failures"],
        attempts=s["attempts"], done_work=s["done"],
        rejected=s["rejected"])


def _service_loop(c, B, V):
    """Run every lane to its end; the host checks once per block.  Returns
    the epilogue and the number of steps the loop ran."""
    J = c["lengths"].shape[1]
    s = _init_state(B, J, V, c["lengths"].device)
    n = 0
    while bool(_active(s, J, c["max_steps"]).any()):
        for _ in range(_CHECK_EVERY):
            _step(s, c)
        n += _CHECK_EVERY
    return _epilogue(s, c), n


# ---------------------------------------------------------------------------
# public batched entry point
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServiceBatchResult:
    """Per-lane outputs of one batched service run (numpy, host-side)."""
    makespan: np.ndarray          # (B,)
    vm_hours: np.ndarray          # (B,)
    dollars: np.ndarray           # (B,) market-priced cost (== vm_hours when
    #                               run without price_rows: unit price rows)
    final_time: np.ndarray        # (B,) last processed event time
    n_preemptions: np.ndarray     # (B,)
    n_job_failures: np.ndarray    # (B,)
    n_deflations: np.ndarray      # (B,)
    n_rejected: np.ndarray        # (B,)
    n_launches: np.ndarray        # (B,)
    n_events: np.ndarray          # (B,) finish+preempt+expire events
    steps: np.ndarray             # (B,) loop steps (incl. assigns)
    pool_exhausted: np.ndarray    # (B,) bool
    deadlocked: np.ndarray        # (B,) bool
    truncated: np.ndarray         # (B,) bool
    finished_time: np.ndarray     # (B, J) NaN = never finished
    failures: np.ndarray          # (B, J)
    attempts: np.ndarray          # (B, J)
    done_work: np.ndarray         # (B, J)
    rejected: np.ndarray          # (B, J) bool
    priced: bool = False          # True when real price_rows were supplied
    loop_steps: int = 0           # steps the loop ran (all lanes at once)

    def __len__(self) -> int:
        return len(self.makespan)


def _host(x):
    """A result tensor as numpy, integers as int32 (``repro``'s dtypes)."""
    a = x.cpu().numpy()
    return a.astype(np.int32) if a.dtype == np.int64 else a


def _np(x, dtype):
    return (x.cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)).astype(dtype)


def simulate_service_batch(
        *, lengths, pools, bag_index, pool_index, policy, cluster_size,
        tables=None, T_values=None, reuse_L: float = 1.0, table_index=None,
        deadlines=None, deflate=None, deflate_factor=0.5,
        checkpointing: bool = False, ckpt_interval: float = 0.5,
        ckpt_cost: float = 1.0 / 60.0,
        relaunch_overhead: float = RELAUNCH_OVERHEAD,
        hot_spare_hours: float = HOT_SPARE_HOURS,
        max_slots: Optional[int] = None, max_steps: Optional[int] = None,
        price_rows=None, price_dt: float = 1.0,
        on_exhausted: str = "raise", device="cuda") -> ServiceBatchResult:
    """Run B service lanes step-synchronously on ``device``.

    Deduplicated inputs (the leading-axis convention): ``lengths`` is
    ``(R, J)`` unique bags, ``pools`` ``(Q, P)`` unique lifetime streams,
    ``tables`` ``(U, T, A)`` unique reuse-decision grids (an
    ``engine.ReuseTables``' ``tensor`` or ``tables``; ``T_values`` /
    ``reuse_L`` are its remaining-work axis and deadline); per-lane
    ``bag_index`` / ``pool_index`` / ``table_index`` pick a lane's slice of
    each.  Arrays may be numpy or tensors.

    ``policy`` is per-lane int codes (``POLICY_CODES``) or strings;
    ``deadlines`` an optional ``(R, J)`` per-job completion deadline (jobs
    whose estimated completion misses it are rejected at scheduling time);
    ``deflate``/``deflate_factor`` enable the per-lane VM-deflation branch.
    ``price_rows`` is an optional ``(B, Tp)`` (or ``(Tp,)``) per-lane
    spot-price trace sampled every ``price_dt`` hours: each VM is billed
    for all its vm-hours at its launch-cell price.  Without ``price_rows``
    unit prices are billed, so ``dollars == vm_hours`` and ``priced`` is
    False.  ``on_exhausted="raise"`` fails when any lane consumes its whole
    lifetime pool or exceeds ``max_steps``; ``"flag"`` returns the per-lane
    flags instead.
    """
    dev = resolve_device(device)
    if on_exhausted not in ("raise", "flag"):
        raise ValueError("on_exhausted must be 'raise' or 'flag'")
    lengths = np.atleast_2d(_np(lengths, np.float64))
    pools = (pools.to(device=dev, dtype=_F64) if isinstance(pools, torch.Tensor)
             else torch.as_tensor(np.array(pools, np.float64), device=dev))
    pools = torch.atleast_2d(pools)
    if isinstance(policy, (str, int, np.integer)):
        policy = [policy]
    policy = np.asarray([POLICY_CODES[p] if isinstance(p, str) else int(p)
                         for p in np.atleast_1d(np.asarray(policy, object))],
                        np.int64)
    B = len(policy)
    bag_index = np.broadcast_to(_np(bag_index, np.int64), (B,))
    pool_index = np.broadcast_to(_np(pool_index, np.int64), (B,))
    cluster_size = np.broadcast_to(_np(cluster_size, np.int64), (B,))
    if np.any(bag_index < 0) or np.any(bag_index >= len(lengths)):
        raise ValueError("bag_index out of range")
    if np.any(pool_index < 0) or np.any(pool_index >= pools.shape[0]):
        raise ValueError("pool_index out of range")
    if np.any(cluster_size < 1):
        raise ValueError("cluster_size must be >= 1")
    if tables is None:
        if np.any(policy == POLICY_MODEL):
            raise ValueError("model-policy lanes need tables= (an "
                             "engine.ReuseTables tensor) and T_values=")
        tables = torch.zeros((1, 1, 1), dtype=torch.bool, device=dev)
        T_values = np.zeros((1,), np.float64)
        table_index = np.zeros((B,), np.int64)
    else:
        if not isinstance(tables, torch.Tensor):
            tables = torch.as_tensor(np.array(tables, bool))
        tables = tables.to(device=dev, dtype=torch.bool)
        T_values = _np(T_values, np.float64)
        if tables.ndim != 3 or tables.shape[1] != len(T_values):
            raise ValueError("tables must be (U, len(T_values), n_age)")
        table_index = (np.zeros((B,), np.int64) if table_index is None
                       else np.broadcast_to(_np(table_index, np.int64),
                                            (B,)))
        if np.any(table_index < 0) or np.any(table_index >= len(tables)):
            raise ValueError("table_index out of range")
    if deadlines is None:
        deadlines = np.full(lengths.shape, np.inf)
    else:
        deadlines = np.broadcast_to(_np(deadlines, np.float64),
                                    lengths.shape)
    deflate = (np.zeros((B,), bool) if deflate is None
               else np.broadcast_to(_np(deflate, bool), (B,)))
    dfac = np.broadcast_to(_np(deflate_factor, np.float64), (B,))
    if np.any(deflate & ((dfac <= 0.0) | (dfac > 1.0))):
        raise ValueError("deflate_factor must be in (0, 1] on deflate lanes")
    if checkpointing and ckpt_interval <= 0:
        raise ValueError("ckpt_interval must be positive")
    priced = price_rows is not None
    if priced:
        price_rows = np.atleast_2d(_np(price_rows, np.float64))
        if price_rows.shape[0] == 1:
            price_rows = np.broadcast_to(price_rows, (B, price_rows.shape[1]))
        if price_rows.shape[0] != B or price_rows.shape[1] == 0:
            raise ValueError("price_rows must be (B, Tp) or (Tp,)")
        if not np.all(price_rows > 0):
            raise ValueError("price_rows must be strictly positive")
        if not float(price_dt) > 0:
            raise ValueError("price_dt must be > 0")
    else:
        price_rows = np.ones((B, 1), np.float64)

    V = int(max_slots) if max_slots is not None else int(cluster_size.max())
    if V < int(cluster_size.max()):
        raise ValueError("max_slots must cover the largest cluster_size")
    J, P = lengths.shape[1], pools.shape[1]
    if max_steps is None:
        max_steps = 8 * (J + P) + 16 * V + 64

    def on(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    def scalar(x):
        # divisors stay float64 tensors on the device: CUDA divides by a
        # host scalar as a multiplication by its reciprocal
        return torch.tensor(float(x), dtype=_F64, device=dev)

    c = dict(
        bag_index=on(bag_index, _I64), pool_index=on(pool_index, _I64),
        table_index=on(table_index, _I64), policy=on(policy, _I64),
        cluster_size=on(cluster_size, _I64),
        deflate=on(deflate, torch.bool), deflate_factor=on(dfac, _F64),
        price=on(price_rows, _F64),
        lengths=on(lengths, _F64), deadlines=on(deadlines, _F64),
        pools=pools, tables=tables, T_values=on(T_values, _F64),
        reuse_L=scalar(reuse_L), relaunch_overhead=scalar(relaunch_overhead),
        hot_spare_hours=scalar(hot_spare_hours),
        ckpt_on=bool(checkpointing), ckpt_interval=scalar(ckpt_interval),
        ckpt_cost=scalar(ckpt_cost), price_dt=scalar(price_dt),
        max_steps=int(max_steps),
        slot_ids=torch.arange(V, dtype=_I64, device=dev))
    c["ckpt_period"] = c["ckpt_interval"] + c["ckpt_cost"]
    out, loop_steps = _service_loop(c, B, V)
    out = {k: _host(v) for k, v in out.items()}
    res = ServiceBatchResult(
        makespan=out["makespan"], vm_hours=out["vm_hours"],
        dollars=out["dollars"], priced=priced, loop_steps=loop_steps,
        final_time=out["final_time"], n_preemptions=out["n_preemptions"],
        n_job_failures=out["n_job_failures"], n_deflations=out["n_deflations"],
        n_rejected=out["n_rejected"], n_launches=out["n_launches"],
        n_events=out["n_events"], steps=out["steps"],
        pool_exhausted=out["pool_exhausted"], deadlocked=out["deadlocked"],
        truncated=out["truncated"], finished_time=out["finished_time"],
        failures=out["failures"], attempts=out["attempts"],
        done_work=out["done_work"], rejected=out["rejected"])
    if on_exhausted == "raise":
        if res.pool_exhausted.any():
            raise RuntimeError(
                f"service lifetime pool exhausted on lanes "
                f"{np.flatnonzero(res.pool_exhausted).tolist()}; increase "
                f"pool_size (P={P})")
        if res.truncated.any():
            raise RuntimeError(
                f"service kernel hit max_steps={max_steps} on lanes "
                f"{np.flatnonzero(res.truncated).tolist()}")
    return res


# ---------------------------------------------------------------------------
# grid cells, shared by service.run_bag_grid and scenarios.sweep_service
# ---------------------------------------------------------------------------

def cell_inputs(*, cells: Sequence[dict], dists: Sequence,
                lengths_by_seed: dict, reuse_tables=None,
                pool_size: int = 4096, deadline_hours=None,
                deflate_factor: float = 0.5, checkpointing: bool = False,
                ckpt_interval: float = 0.5, ckpt_cost: float = 1.0 / 60.0,
                price_rows=None, price_dt: float = 1.0,
                device="cuda") -> dict:
    """The :func:`simulate_service_batch` keywords of a list of grid cells,
    one lane each (see :func:`run_cells_batched`), with the pools drawn on
    ``device``."""
    dev = resolve_device(device)
    cells = list(cells)
    dists = list(dists)
    seeds_order = list(dict.fromkeys(c["seed"] for c in cells))
    bag_pos = {s: i for i, s in enumerate(seeds_order)}
    lengths = np.stack([np.asarray(lengths_by_seed[s], np.float64)
                        for s in seeds_order])
    pairs = list(dict.fromkeys((c["dist_index"], c["seed"]) for c in cells))
    pool_pos = {p: i for i, p in enumerate(pairs)}
    pool_mat = draw_service_pool_batch([dists[di] for di, _ in pairs],
                                       [s for _, s in pairs], size=pool_size,
                                       device=dev)
    parsed = [split_policy(c["policy"]) for c in cells]
    tables = T_values = None
    reuse_L = 1.0
    if any(base == "model" for base, _ in parsed):
        if reuse_tables is None:
            raise ValueError("model-policy cells need reuse_tables=")
        tables, T_values = reuse_tables.tensor, reuse_tables.T_values
        reuse_L = reuse_tables.L
    deadlines = (None if deadline_hours is None
                 else np.full(lengths.shape, float(deadline_hours)))
    return dict(
        lengths=lengths, pools=pool_mat,
        bag_index=[bag_pos[c["seed"]] for c in cells],
        pool_index=[pool_pos[(c["dist_index"], c["seed"])] for c in cells],
        policy=[base for base, _ in parsed],
        cluster_size=[c["cluster_size"] for c in cells],
        tables=tables, T_values=T_values, reuse_L=reuse_L,
        table_index=[c["dist_index"] for c in cells],
        deadlines=deadlines, deflate=[d for _, d in parsed],
        deflate_factor=deflate_factor, checkpointing=checkpointing,
        ckpt_interval=ckpt_interval, ckpt_cost=ckpt_cost,
        price_rows=price_rows, price_dt=price_dt)


def run_cells_batched(*, cells: Sequence[dict], dists: Sequence,
                      lengths_by_seed: dict, reuse_tables=None,
                      pool_size: int = 4096, deadline_hours=None,
                      deflate_factor: float = 0.5,
                      checkpointing: bool = False, ckpt_interval: float = 0.5,
                      ckpt_cost: float = 1.0 / 60.0,
                      return_jobs: bool = False,
                      price_rows=None, price_dt: float = 1.0,
                      on_exhausted: str = "raise", device="cuda") -> list:
    """Run a list of grid cells as the lanes of ONE batched loop.

    Each cell is ``dict(dist_index, vm_type, policy, cluster_size, seed)``
    (policy may carry a ``"+deflate"`` suffix).  ``dists[dist_index]`` is
    the cell's lifetime model, ``lengths_by_seed[seed]`` its bag;
    ``reuse_tables`` an :class:`engine.ReuseTables` aligned with ``dists``
    (required iff any cell runs the model policy).  Lifetime pools are
    drawn once per unique ``(dist_index, seed)`` pair: the per-seed streams
    the serial ``BatchService`` consumes.  Returns ``run_bag_grid``-style
    rows (cell coords + :class:`ServiceResult`).
    """
    cells = list(cells)
    if not cells:
        return []
    kw = cell_inputs(
        cells=cells, dists=dists, lengths_by_seed=lengths_by_seed,
        reuse_tables=reuse_tables, pool_size=pool_size,
        deadline_hours=deadline_hours, deflate_factor=deflate_factor,
        checkpointing=checkpointing, ckpt_interval=ckpt_interval,
        ckpt_cost=ckpt_cost, price_rows=price_rows, price_dt=price_dt,
        device=device)
    res = simulate_service_batch(**kw, on_exhausted=on_exhausted,
                                 device=device)
    return [dict(vm_type=cell["vm_type"], policy=cell["policy"],
                 cluster_size=cell["cluster_size"], seed=cell["seed"],
                 result=lane_result(res, i, kw["lengths"][kw["bag_index"][i]],
                                    cell["vm_type"], jobs=return_jobs))
            for i, cell in enumerate(cells)]


def lane_result(res: ServiceBatchResult, i: int, bag_lengths, vm_type: str,
                *, jobs: bool = False) -> ServiceResult:
    """Package lane ``i`` as a serial-compatible :class:`ServiceResult`.

    The cost expressions mirror ``BatchService.run``'s epilogue (the same
    numpy float64 host arithmetic), so the whole row is bit-identical to
    the serial loop on a shared pool.  ``jobs=True`` also builds per-job
    :class:`Job` records (``started`` / ``attempt_started`` are not tracked
    by the loop and stay ``None``).
    """
    vm_hours = float(res.vm_hours[i])
    price = PRICES_PREEMPTIBLE[vm_type]
    od_price = PRICES_ON_DEMAND[vm_type]
    cost = vm_hours * price
    # market dollars when a price trace was supplied, else the flat-price
    # cost: the serial epilogue's fallback
    dollars = float(res.dollars[i]) if res.priced else cost
    total_work = float(np.sum([float(l) for l in bag_lengths]))
    job_list = []
    if jobs:
        for j, l in enumerate(bag_lengths):
            fin = res.finished_time[i, j]
            job_list.append(Job(
                j, float(l), finished=None if np.isnan(fin) else float(fin),
                attempts=int(res.attempts[i, j]),
                failures=int(res.failures[i, j]),
                done_work=float(res.done_work[i, j])))
    return ServiceResult(
        makespan=float(res.makespan[i]), vm_hours=vm_hours,
        cost=cost, on_demand_cost=total_work * od_price,
        n_preemptions=int(res.n_preemptions[i]),
        n_job_failures=int(res.n_job_failures[i]), jobs=job_list,
        n_deflations=int(res.n_deflations[i]),
        n_rejected=int(res.n_rejected[i]), dollars=dollars)
