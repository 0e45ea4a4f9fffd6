"""The port's MoE block (``repro_torch.models.moe``) and the two MoE archs
(moonshot-v1-16b-a3b, phi3.5-moe-42b-a6.6b) against ``repro`` on the CPU,
at smoke size.

``repro``'s routing is read out of its own ``moe_mlp``: the test evaluates
the function's jaxpr one equation at a time and keeps the router's logits,
the probabilities ``top_k`` takes, its indices, the renormalised gates,
the slots and the capacity (the width of the slots' one-hot).  Both sides
get the same weights (``repro``'s init, carried across) and the same numpy
inputs.

Tolerances, case by case:
- ``_group_size``: equal for T = 1..5,000.
- Routing from ``repro``'s probabilities: top-k indices, gates, capacity
  and slots bit for bit (the same float32 operations in the same order);
  from the port's own float32 probabilities (PyTorch's exp rounds
  differently from XLA's in ~9 % of elements): indices, capacity and slots
  equal, probabilities and gates within rtol 1e-6.
- ``moe_mlp`` in float32: atol = rtol = 1e-5 (the combine sums its K
  products in another order).  In bf16 a pair's route may differ only
  where the two experts' bf16 router logits are equal or adjacent bf16
  numbers, on at most 1 % of the pairs; tokens routed alike agree within
  ``test_torch_models.BF16_TOL``.
- Eight smoke layers at the published capacity: logits within
  ``test_torch_models.F32_TOL`` of ``repro``'s forward, and each layer's
  experts, slots and capacity equal to ``repro``'s routing of the port's
  router input to that layer.
- Zero input gives zero output (atol 1e-5, as ``tests/test_models.py``);
  at ``capacity_factor = 8`` nothing drops and each token's gates sum to
  1 within 1e-6.
- ``aux_load_balance_loss``: within 1e-6.
- ``moe_mlp``'s gradients (x, router, gate, up, down) against ``jax.vjp``
  of ``repro``'s: within 1e-5 of each tensor's largest element, float32.
- Dispatch and combine: ``torch.autograd.gradcheck`` in float64; their
  backward against autograd of the plain indexed version within rtol
  1e-12 in float64 (autograd accumulates in another order).
- A smoke model's loss (rtol 1e-6) and every gradient leaf (atol 1e-6 +
  rtol 1e-4) against ``jax.value_and_grad``, remat on and off; a
  ``grad_accum=2`` step against ``repro``'s at
  ``test_torch_embeds_mrope.py``'s tolerances (loss rtol 1e-6, AdamW's
  first moment atol 1e-7 + rtol 1e-4, parameters within 2 x lr).
The module runs on one intra-op thread, as the other training tests do.
"""
import dataclasses
import functools

import jax
import jax.extend as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as JS
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch import configs as TC
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import serve as TSV
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TTR
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models import weights as TW
from repro_torch.optim import adamw_init

from test_torch_models import BF16_TOL, F32_TOL

ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations: one intra-op thread, so that test workers
    sharing the cores do not oversubscribe them (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, dtype="float32", **over):
    return (dataclasses.replace(JC.smoke(arch), compute_dtype=dtype, **over),
            dataclasses.replace(TC.smoke(arch), compute_dtype=dtype, **over))


@functools.cache
def _jax_params(cfg):
    params, _ = JT.init(cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _moe_params(cfg, tie=False):
    """Layer 0's MoE weights (numpy); with ``tie``, router columns 1 and 3
    copy columns 0 and 2, so those experts tie exactly on every token."""
    p = {k: np.array(v[0]) for k, v in
         _jax_params(cfg)["groups"][0]["moe"].items()}
    if tie:
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 3] = p["router"][:, 2]
    return p


def _torch_params(tcfg, p):
    return TW.stored(tcfg, {k: torch.as_tensor(v) for k, v in p.items()})


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _tdtype(cfg):
    return getattr(torch, cfg.compute_dtype)


def _jdtype(cfg):
    return getattr(jnp, cfg.compute_dtype)


def _repro_routing(cfg, p, x):
    """``repro``'s ``moe_mlp(cfg, p, x)`` evaluated equation by equation
    from its jaxpr.  Returns its output and routing as numpy: logits (the
    softmax's input), probs (``top_k``'s input), idx, gate (the division
    after ``top_k``), slot (the max over experts after it) and capacity
    (the width of the one-hot of the slots)."""
    closed = jax.make_jaxpr(functools.partial(JM.moe_mlp, cfg))(p, x)
    jaxpr, env = closed.jaxpr, {}

    def read(v):
        return v.val if isinstance(v, jex.core.Literal) else env[v]

    env.update(zip(jaxpr.constvars, closed.consts))
    env.update(zip(jaxpr.invars, jax.tree_util.tree_leaves((p, x))))
    seen = []
    for eqn in jaxpr.eqns:
        subfuns, params = eqn.primitive.get_bind_params(eqn.params)
        ins = [read(v) for v in eqn.invars]
        out = eqn.primitive.bind(*subfuns, *ins, **params)
        out = out if eqn.primitive.multiple_results else [out]
        env.update(zip(eqn.outvars, out))
        seen.append((eqn.primitive.name, ins, out))
    names = [s[0] for s in seen]
    at = names.index("top_k")
    after = names[at:]
    slot_at = at + after.index("reduce_max")
    r = {"logits": seen[names.index("reduce_max")][1][0],
         "probs": seen[at][1][0], "idx": seen[at][2][1],
         "gate": seen[at + after.index("div")][2][0],
         "slot": seen[slot_at][2][0],
         "capacity": seen[slot_at + 1][2][0].shape[-1]}
    r = {k: v if k == "capacity" else np.array(
        jnp.asarray(v, v.dtype if v.dtype != jnp.bfloat16 else jnp.float32))
        for k, v in r.items()}
    return np.asarray(read(jaxpr.outvars[0]).astype(jnp.float32)), r


# -- groups ---------------------------------------------------------------------

def test_group_size_matches_repro():
    got = [TM._group_size(T) for T in range(1, 5001)]
    assert got == [JM._group_size(T) for T in range(1, 5001)]
    assert TM.MOE_GROUP == JM.MOE_GROUP
    assert TM._group_size(1200) == 16      # collapses for an awkward T


# -- routing ---------------------------------------------------------------------

# name: (B, S, overrides, tie)
ROUTING_CASES = {
    "two groups": (2, 512, {}, False),
    "one ragged group": (1, 120, {}, False),
    "T = 1200, group 16": (2, 600, {}, False),
    "capacity 0.5, drops": (2, 512, {"capacity_factor": 0.5}, False),
    "tied experts": (2, 512, {}, True),
}


def _port_probs(tcfg, p_t, x, Tg):
    xt = torch.as_tensor(x).reshape(-1, Tg, tcfg.d_model).to(_tdtype(tcfg))
    return TM.router_probs(tcfg, p_t["router"], xt)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(ROUTING_CASES))
def test_routing_matches_repro_bit_for_bit(arch, case):
    B, S, over, tie = ROUTING_CASES[case]
    cfg, tcfg = _cfg(arch, **over)
    p = _moe_params(cfg, tie)
    x = _x(cfg, B, S)
    _, want = _repro_routing(cfg, p, x)
    Tg = TM._group_size(B * S)
    assert want["probs"].shape == (B * S // Tg, Tg, cfg.n_experts)

    def equal(r, exact_gate):
        assert r.capacity == want["capacity"]
        np.testing.assert_array_equal(r.idx.numpy(), want["idx"])
        np.testing.assert_array_equal(r.slot.numpy(),
                                      want["slot"].astype(np.int64))
        if exact_gate:
            np.testing.assert_array_equal(r.gate.numpy(), want["gate"])
        else:
            np.testing.assert_allclose(r.gate.numpy(), want["gate"],
                                       rtol=1e-6)

    # repro's probabilities through the port's routing: bit for bit
    equal(TM.route(tcfg, torch.as_tensor(want["probs"])), True)
    # the port's own probabilities
    probs = _port_probs(tcfg, _torch_params(tcfg, p), x, Tg)
    np.testing.assert_allclose(probs.numpy(), want["probs"], rtol=1e-6)
    equal(TM.route(tcfg, probs), False)

    if "drops" in case:
        assert (want["slot"] < 0).mean() > 0.2
    if tie:
        # the tied experts' probabilities are equal on both sides, and the
        # ties decide routes: the lower index comes first
        for a, b in ((0, 1), (2, 3)):
            for pr in (want["probs"], probs.numpy()):
                np.testing.assert_array_equal(pr[..., a], pr[..., b])
        idx = want["idx"]
        both = ((idx == 0).any(-1) & (idx == 1).any(-1))
        assert both.any()
        k0 = np.argmax(idx == 0, -1)
        k1 = np.argmax(idx == 1, -1)
        assert (k0 < k1)[both].all()
        assert ((idx == 1).any(-1) & ~(idx == 0).any(-1)).sum() == 0


# -- the MLP ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["two groups", "T = 1200, group 16",
                                  "capacity 0.5, drops"])
def test_moe_mlp_matches_repro_float32(arch, case):
    B, S, over, _ = ROUTING_CASES[case]
    cfg, tcfg = _cfg(arch, **over)
    p = _moe_params(cfg)
    x = _x(cfg, B, S, seed=1)
    want = np.asarray(jax.jit(functools.partial(JM.moe_mlp, cfg))(p, x))
    got = TM.moe_mlp(tcfg, _torch_params(tcfg, p), torch.as_tensor(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _bf16_neighbours(a, b):
    """a and b (float32 holding bf16 values) equal or adjacent bf16s."""
    ia = a.astype(np.float32).view(np.int32) >> 16
    ib = b.astype(np.float32).view(np.int32) >> 16
    # the sign-magnitude bit patterns of bf16 as a monotone integer line
    key = lambda i: np.where(i < 0, -(i & 0x7FFF), i)       # noqa: E731
    return np.abs(key(ia) - key(ib)) <= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_bf16_routes_differ_only_at_bf16_ties(arch):
    cfg, tcfg = _cfg(arch, "bfloat16")
    p = _moe_params(cfg)
    B, S = 2, 512
    x = _x(cfg, B, S, seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_want, want = _repro_routing(cfg, p, xb)
    p_t = _torch_params(tcfg, p)
    xt = torch.as_tensor(x).to(torch.bfloat16)
    Tg = TM._group_size(B * S)
    r = TM.route(tcfg, TM.router_probs(tcfg, p_t["router"],
                                       xt.reshape(-1, Tg, cfg.d_model)))
    assert r.capacity == want["capacity"]
    idx, slot = r.idx.numpy(), r.slot.numpy()
    differ = idx != want["idx"]
    assert differ.mean() <= 0.01
    logits = want["logits"]
    for g, t, k in zip(*np.nonzero(differ)):
        mine, theirs = idx[g, t, k], want["idx"][g, t, k]
        assert _bf16_neighbours(logits[g, t, mine], logits[g, t, theirs]), \
            (g, t, k, logits[g, t, mine], logits[g, t, theirs])
    alike = ((idx == want["idx"]) & (slot == want["slot"])).all(-1)
    y = TM.moe_mlp(tcfg, p_t, xt)
    assert y.dtype == torch.bfloat16
    got = y.float().numpy().reshape(-1, Tg, cfg.d_model)
    np.testing.assert_allclose(got[alike],
                               y_want.reshape(-1, Tg, cfg.d_model)[alike],
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_input_and_mass_conservation(arch):
    """The analogue of ``tests/test_models.py``'s MoE check: at
    ``capacity_factor = 8`` every pair is kept and each token's gates sum
    to 1; zero input gives zero output."""
    cfg, tcfg = _cfg(arch, capacity_factor=8.0)
    p_t = _torch_params(tcfg, _moe_params(cfg))
    x = 0.1 * torch.as_tensor(_x(cfg, 2, 16, seed=3))
    y = TM.moe_mlp(tcfg, p_t, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    r = TM.route(tcfg, TM.router_probs(tcfg, p_t["router"],
                                       x.reshape(1, 32, -1)))
    assert (r.slot >= 0).all()
    torch.testing.assert_close(r.gate.sum(-1), torch.ones(1, 32),
                               rtol=0, atol=1e-6)
    y0 = TM.moe_mlp(tcfg, p_t, torch.zeros_like(x))
    np.testing.assert_allclose(y0.numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aux_load_balance_loss_matches_repro(arch, dtype):
    cfg, tcfg = _cfg(arch, dtype)
    p = _moe_params(cfg)
    x = _x(cfg, 2, 64, seed=4)
    want = float(jax.jit(functools.partial(JM.aux_load_balance_loss, cfg))(
        jnp.asarray(x, _jdtype(cfg)), p))
    got = TM.aux_load_balance_loss(
        tcfg, torch.as_tensor(x).to(_tdtype(tcfg)), _torch_params(tcfg, p))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_grads_match_jax_vjp(arch):
    cfg, tcfg = _cfg(arch, capacity_factor=0.75)      # some pairs drop
    p = _moe_params(cfg)
    x = _x(cfg, 2, 128, seed=5)
    dy = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(functools.partial(JM.moe_mlp, cfg), p, x)
    jp, jx = vjp(jnp.asarray(dy))
    p_t = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    x_t = torch.as_tensor(x).requires_grad_()
    y = TM.moe_mlp(tcfg, p_t, x_t)
    names = list(p_t)
    grads = torch.autograd.grad(y, [x_t] + [p_t[n] for n in names],
                                torch.as_tensor(dy))
    for name, got, want in zip(["x"] + names, grads,
                               [jx] + [jp[n] for n in names]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
        assert np.abs(want).max() > 0, name


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_at_depth_matches_repro(arch):
    """Eight smoke layers at the published capacity factor, 2 x 384 tokens
    (three groups of 256): the port's logits against ``repro``'s forward
    within ``test_torch_models.F32_TOL``, and every layer's routing, read
    at the port's router input, equal to ``repro``'s on that input
    (experts, slots, capacity), so the pairs dropped at depth are
    ``repro``'s."""
    cfg, tcfg = _cfg(arch, n_layers=8)
    B, S = 2, 384
    params_np = _jax_params(cfg)
    model = TW.from_jax_params(tcfg, params_np, device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    inputs, routes = [], []
    real_probs, real_route = TM.router_probs, TM.route

    def spy_probs(c, router, xt):
        inputs.append(xt.detach().clone())
        return real_probs(c, router, xt)

    def spy_route(c, probs):
        routes.append(real_route(c, probs))
        return routes[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "router_probs", spy_probs)
        mp.setattr(TM, "route", spy_route)
        got, _ = model(torch.as_tensor(toks))
    want, _ = jax.jit(functools.partial(JT.forward, cfg, mode="train"))(
        params_np, jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_TOL, rtol=F32_TOL)
    assert len(inputs) == len(routes) == cfg.n_layers
    layers = params_np["groups"][0]["moe"]
    dropped = []
    for i, (xt, r) in enumerate(zip(inputs, routes)):
        assert xt.shape == (3, 256, cfg.d_model)
        p = {k: np.array(v[i]) for k, v in layers.items()}
        _, jr = _repro_routing(cfg, p, xt.reshape(B, S, -1).numpy())
        assert r.capacity == jr["capacity"], i
        np.testing.assert_array_equal(r.idx.numpy(), jr["idx"],
                                      err_msg=f"layer {i}")
        np.testing.assert_array_equal(r.slot.numpy(),
                                      jr["slot"].astype(np.int64),
                                      err_msg=f"layer {i}")
        dropped.append(float((r.slot < 0).float().mean()))
    assert sum(d > 0 for d in dropped) >= cfg.n_layers // 2, dropped
    print(f"{arch}: dropped share by layer {dropped}")


# -- dispatch and combine ----------------------------------------------------------

def _routing_maps(E=4, K=2, G=2, Tg=8, capacity_factor=0.75, seed=7):
    cfg = dataclasses.replace(TC.smoke("phi3.5-moe-42b-a6.6b"), n_experts=E,
                              top_k=K, capacity_factor=capacity_factor)
    probs = torch.softmax(torch.as_tensor(np.random.default_rng(
        seed).standard_normal((G, Tg, E))), -1)
    r = TM.route(cfg, probs)
    return r, TM._index_maps(r, E), E * G * r.capacity


def test_index_maps_are_a_partial_bijection():
    r, (pair_slot, slot_pair), n_slots = _routing_maps()
    n_pairs = pair_slot.numel()
    kept = pair_slot < n_slots
    assert 0 < int(kept.sum()) < n_pairs          # some pairs dropped
    assert torch.equal(slot_pair[pair_slot[kept]],
                       torch.arange(n_pairs)[kept])
    full = slot_pair < n_pairs
    assert torch.equal(pair_slot[slot_pair[full]],
                       torch.arange(n_slots)[full])
    assert int(full.sum()) == int(kept.sum())


def _pad(t):
    """``t`` with a row of zeros appended: the row an index one past the
    end reads."""
    return torch.cat([t, t.new_zeros((1,) + t.shape[1:])])


def _plain_dispatch(x, pair_slot, slot_pair, K):
    return _pad(x)[slot_pair // K]


def _plain_combine(ye, w, pair_slot, slot_pair, dtype):
    rows = _pad(ye)[pair_slot].view(*w.shape, -1)
    return (w[..., None] * rows).sum(1).to(dtype)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_dispatch_and_combine_gradcheck_and_plain_autograd(K):
    r, (pair_slot, slot_pair), n_slots = _routing_maps(K=K)
    T = pair_slot.numel() // K
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.standard_normal((T, 5))).requires_grad_()
    ye = torch.as_tensor(rng.standard_normal((n_slots, 5))).requires_grad_()
    w = r.gate.reshape(T, K).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x: TM.Dispatch.apply(x, pair_slot, slot_pair, K), (x,))
    assert torch.autograd.gradcheck(
        lambda ye, w: TM.Combine.apply(ye, w, pair_slot, slot_pair,
                                       torch.float64), (ye, w))
    for fn, plain, ins, extra in (
            (TM.Dispatch.apply, _plain_dispatch, (x,), (K,)),
            (TM.Combine.apply, _plain_combine, (ye, w), (torch.float64,))):
        out = fn(*ins, pair_slot, slot_pair, *extra)
        ref = plain(*ins, pair_slot, slot_pair, *extra)
        torch.testing.assert_close(out, ref, rtol=1e-12, atol=0)
        cot = torch.as_tensor(rng.standard_normal(out.shape))
        got = torch.autograd.grad(out, ins, cot)
        want = torch.autograd.grad(ref, ins, cot)
        for g, wnt in zip(got, want):
            torch.testing.assert_close(g, wnt, rtol=1e-12, atol=1e-15)


# -- the model --------------------------------------------------------------------

def _batch(cfg, B=2, S=32, seed=9):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "mask": (rng.uniform(size=(B, S)) > 0.2).astype(np.float32)}


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_grads_match_jax(arch, remat):
    cfg, tcfg = _cfg(arch, remat=remat)
    params_np = _jax_params(dataclasses.replace(cfg, remat=True))
    batch = _batch(cfg)
    (want, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(cfg, p, b), has_aux=True))(params_np, batch)
    model = TW.from_jax_params(tcfg, params_np, device="cpu",
                               trainable=True)
    loss, aux, grads = TS.value_and_grad(model, _tbatch(batch))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    for key in ("nll", "zloss"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-6)
    names = [n for n, _ in model.named_parameters()]
    assert any(n.endswith("moe.router") for n in names)
    got = TW.grouped(tcfg, dict(zip(names, grads)))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray,
                                                            jgrads))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_2_step_matches_repro(arch):
    cfg, tcfg = _cfg(arch)
    params_np = _jax_params(cfg)
    batch = _batch(cfg, B=4, S=16, seed=10)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jstep = jax.jit(JS.make_train_step(cfg, JTrainConfig(grad_accum=2)))
    jparams, jstate, jm = jstep(jparams, JA.adamw_init(jparams), batch)
    model = TW.from_jax_params(tcfg, params_np, device="cpu",
                               trainable=True)
    opt = adamw_init(dict(model.named_parameters()))
    step = TS.make_train_step(tcfg, TrainConfig(grad_accum=2))
    model, opt, m = step(model, opt, _tbatch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    lr = float(m["lr"])
    np.testing.assert_allclose(lr, float(jm["lr"]), rtol=1e-6)
    for g, w in zip(jax.tree_util.tree_leaves(TW.grouped(tcfg, opt.mu)),
                    jax.tree_util.tree_leaves(jstate.mu)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-7)
    params = dict(model.named_parameters())
    for g, w in zip(jax.tree_util.tree_leaves(TW.grouped(tcfg, params)),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2 * lr)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_of_a_moe_layer(arch):
    """``weights.stored`` keeps the router and the experts (2 and 3
    dimensions) in the compute dtype, the norms in float32;
    ``_port_tree`` carries the ``moe`` subtree across and ``grouped``
    maps it back; the port's own init draws the same shapes and no
    ``mlp``."""
    cfg, tcfg = _cfg(arch, "bfloat16")
    params_np = _jax_params(cfg)
    model = TW.from_jax_params(tcfg, params_np, device="cpu")
    layer = model.layers[1]
    assert model.kinds == ["moe"] * cfg.n_layers
    for name in ("router", "gate", "up", "down"):
        assert layer["moe"][name].dtype == torch.bfloat16, name
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert tuple(layer["moe"]["router"].shape) == (d, E)
    assert tuple(layer["moe"]["down"].shape) == (E, f, d)
    assert layer["ln2"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        layer["moe"]["up"].float().numpy(),
        np.asarray(jnp.asarray(params_np["groups"][0]["moe"]["up"][1],
                               jnp.bfloat16).astype(jnp.float32)))
    trainable = TW.from_jax_params(tcfg, params_np, device="cpu",
                                   trainable=True)
    back = TW.grouped(tcfg, dict(trainable.named_parameters()))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params_np)):
        np.testing.assert_array_equal(g, w)
    drawn = TT.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in
           drawn.state_dict().items()}
    assert got == {k: (tuple(v.shape), v.dtype) for k, v in
                   model.state_dict().items()}
    assert not any(".mlp." in k for k in got)
    assert sum(v.numel() for v in drawn.state_dict().values()) \
        == tcfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_clis(arch, tmp_path, capsys):
    TSV.main(["--arch", arch, "--smoke", "--device", "cpu", "--batches",
              "2", "--batch-size", "2", "--prompt-len", "16", "--decode",
              "3"])
    out = capsys.readouterr().out
    assert "batch 1: (2, 3) tokens" in out and "served 2 batches" in out
    res = TTR.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "3", "--ckpt-dir", str(tmp_path)])
    assert res.steps_run == 3 and np.isfinite(res.final_loss)
