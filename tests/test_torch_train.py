"""Parity of the port's training path with ``repro`` on the CPU: the loss
and its gradients, AdamW and its schedule, gradient accumulation, and the
preemption-aware trainer.

Both sides get the same weights (``repro``'s ``transformer.init``, carried
across with ``weights.from_jax_params(..., trainable=True)``) and the same
numpy batches (``repro``'s ``SyntheticLM``: the port draws its own tokens
with a torch.Generator, which cannot give JAX's bits).  On the CPU the
attention goes through the plain forward and backward of the flash pair.

Tolerances: float32 loss rtol 1e-6 (summation order); gradients atol 1e-6
+ rtol 1e-4 (summation order through 3 layers and the backward's
recomputed softmax); bf16 loss rtol 5e-3 (the two frameworks round bf16
intermediates at different places); AdamW params / mu / nu rtol 1e-6 with
an atol of one float32 ulp at the tensor's largest element (XLA on the
CPU contracts ``p - lr * delta`` into an FMA, which moves an element that
cancels to near zero by up to an ulp of the operands) and the schedule
rtol 1e-6 (float32 elementwise arithmetic, pow and cos from different
libms).  The trainer is held to ``repro``'s ``train()`` on its
schedule counts, which depend on the DP tables and the lifetime draws
only, and to itself: a preempted run replays a clean one to the bit.
The module runs on one intra-op thread: its tiny models are many small
operations, which parallel test workers otherwise slow down by
oversubscribing the cores.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.train import train as jtrain
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch import configs as TC
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TTR
from repro_torch.models import transformer as TT
from repro_torch.models import weights as TW
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               global_norm)

ARCH = "smollm-135m"



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations: one intra-op thread, so that test workers
    sharing the cores do not oversubscribe them (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfg(arch=ARCH, **over):
    return (dataclasses.replace(JC.smoke(arch), **over),
            dataclasses.replace(TC.smoke(arch), **over))


@functools.cache
def _jax_params(cfg):
    params, _ = JT.init(cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(cfg, B=4, S=32, step=3):
    b = JSyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                     seed=1).batch(step)
    return {k: np.array(v) for k, v in b.items()}


def _torch_batch(batch_np):
    return {k: torch.as_tensor(v) for k, v in batch_np.items()}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _port_grads(model, batch):
    loss, aux = TT.lm_loss(model, _torch_batch(batch))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, aux, dict(zip(names, grads))


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_grads_match_jax_float32(remat):
    cfg, tcfg = _cfg(compute_dtype="float32", remat=remat)
    params_np = _jax_params(cfg)
    batch = _batch(cfg)
    (want, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(cfg, p, b), has_aux=True))(params_np, batch)
    model = TW.from_jax_params(tcfg, params_np, device="cpu",
                               trainable=True)
    loss, aux, grads = _port_grads(model, batch)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    for key in ("nll", "zloss"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-6)
    got = TW.grouped(tcfg, grads)
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(jax.tree_util.tree_map(
            np.asarray, jgrads))
    for g, w in zip(_leaves(got), _leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)


def test_lm_loss_matches_jax_bf16():
    cfg, tcfg = _cfg(compute_dtype="bfloat16")
    params_np = _jax_params(cfg)
    batch = _batch(cfg)
    want, _ = jax.jit(lambda p, b: JT.lm_loss(cfg, p, b))(params_np, batch)
    model = TW.from_jax_params(tcfg, params_np, device="cpu",
                               trainable=True)
    loss, _, grads = _port_grads(model, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=5e-3)
    assert all(g.dtype == torch.float32 for g in grads.values())


def test_loss_backward_is_softmax_minus_onehot():
    """The loss's hand-written backward (deterministic on CUDA) against
    autograd of the plain expression, on the logits."""
    rng = np.random.default_rng(0)
    logits = torch.as_tensor(rng.standard_normal((2, 5, 11)),
                             dtype=torch.float32).requires_grad_()
    labels = torch.as_tensor(rng.integers(0, 11, (2, 5)))
    w = torch.as_tensor(rng.standard_normal((2, 5)), dtype=torch.float32)
    logz, gold = TT._LogZGold.apply(logits, labels)
    got = torch.autograd.grad((w * (logz - gold) + logz ** 2).sum(), logits)
    x = logits.detach().clone().requires_grad_()
    ref_logz = torch.logsumexp(x, -1)
    ref_gold = torch.gather(x, -1, labels[..., None])[..., 0]
    want = torch.autograd.grad((w * (ref_logz - ref_gold)
                                + ref_logz ** 2).sum(), x)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-7)


def test_trainable_model_keeps_float32_master_weights():
    cfg, tcfg = _cfg(compute_dtype="bfloat16")
    params_np = _jax_params(cfg)
    model = TW.from_jax_params(tcfg, params_np, device="cpu",
                               trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    for g, w in zip(_leaves(TW.grouped(tcfg, dict(
            model.named_parameters()))), _leaves(params_np)):
        np.testing.assert_array_equal(g, w)
    serving = TW.from_jax_params(tcfg, params_np, device="cpu")
    assert serving.embed.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serving.parameters())
    drawn = TT.init(tcfg, torch.Generator().manual_seed(0), device="cpu",
                    trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in drawn.parameters())
    with pytest.raises(ValueError, match="param_dtype"):
        TT.Model(tcfg, TW.stored(tcfg, TW._port_tree(
            tcfg, params_np, torch.device("cpu"))), trainable=True)


def _ulp_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=2.0 ** -23 * np.abs(want).max())


def _shared_grads(params_np, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
        params_np)


def test_adamw_update_matches_jax():
    """Three updates on shared grads: the first clipped (global norm far
    above 1), the others not; params, mu, nu, the norm and the rate."""
    cfg, tcfg = _cfg()
    params_np = _jax_params(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jstate = JA.adamw_init(jparams)
    params = TW.named(tcfg, params_np, device="cpu")
    state = adamw_init(params)
    kw = dict(base_lr=3e-4, warmup_steps=2, total_steps=10)
    for i, scale in enumerate((1.0, 1e-3, 1e-2)):
        grads_np = _shared_grads(params_np, scale, seed=i)
        jlr = JA.cosine_schedule(jstate.step, **kw)
        jparams, jstate, jm = JA.adamw_update(grads_np, jstate, jparams,
                                              learning_rate=jlr)
        lr = cosine_schedule(state.step, **kw)
        params, state, m = adamw_update(TW.named(tcfg, grads_np, "cpu"),
                                        state, params, learning_rate=lr)
        assert int(state.step) == int(jstate.step) == i + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for got, want in ((params, jparams), (state.mu, jstate.mu),
                          (state.nu, jstate.nu)):
            for g, w in zip(_leaves(TW.grouped(tcfg, got)), _leaves(want)):
                _ulp_close(g, w)


def test_cosine_schedule_matches_jax_over_1000_steps():
    steps = np.arange(1000, dtype=np.int32)
    kw = dict(base_lr=3e-4, warmup_steps=100, total_steps=1000)
    want = np.asarray(JA.cosine_schedule(jnp.asarray(steps), **kw))
    got = cosine_schedule(torch.as_tensor(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[0] > 0 and float(got[-1]) == pytest.approx(3e-5, rel=1e-5)


def _adamw_leaf_by_leaf(grads, mu, nu, params, lr, step, beta1=0.9,
                        beta2=0.95, eps=1e-8, wd=0.1, clip=1.0):
    """AdamW written one leaf at a time, as the update's formula reads."""
    gnorm = global_norm(grads.values())
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1c = 1.0 - beta1 ** step.float()
    b2c = 1.0 - beta2 ** step.float()
    for n, p in params.items():
        g = grads[n].float() * scale
        m, v = mu[n], nu[n]
        m.copy_(beta1 * m + (1 - beta1) * g)
        v.copy_(beta2 * v + (1 - beta2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps) + wd * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))


@pytest.mark.parametrize("group", [1 << 26, 700])
def test_adamw_batches_of_leaves_match_leaf_by_leaf_to_the_bit(
        monkeypatch, group):
    """The update takes its leaves in batches; every element comes out as
    the leaf-by-leaf formula gives it, with batches cut by size (a leaf
    over the batch's size alone) and by dtype."""
    from repro_torch.optim import adamw as TA
    monkeypatch.setattr(TA, "GROUP", group)
    gen = torch.Generator().manual_seed(7)
    shapes = [(3, 5), (1000,), (40, 20), (7,), (300,), (2, 2)]
    dtypes = [torch.float32] * 4 + [torch.bfloat16, torch.float32]
    params = {f"l{i}": torch.randn(s, generator=gen).to(d)
              for i, (s, d) in enumerate(zip(shapes, dtypes))}
    want = {n: p.clone() for n, p in params.items()}
    state = adamw_init(params)
    mu = {n: m.clone() for n, m in state.mu.items()}
    nu = {n: v.clone() for n, v in state.nu.items()}
    for i in range(3):
        grads = {n: torch.randn(p.shape, generator=gen) * 10 ** -i
                 for n, p in params.items()}
        lr = cosine_schedule(state.step, base_lr=3e-4, warmup_steps=2,
                             total_steps=10)
        _adamw_leaf_by_leaf(grads, mu, nu, want, lr, state.step + 1)
        params, state, _ = adamw_update(grads, state, params,
                                        learning_rate=lr)
        for got, ref in ((params, want), (state.mu, mu), (state.nu, nu)):
            for n in got:
                assert got[n].dtype == ref[n].dtype
                assert torch.equal(got[n], ref[n]), (i, n)


def test_global_norm_matches_jax():
    params_np = _jax_params(_cfg()[0])
    want = float(JA.global_norm(params_np))
    got = float(global_norm(torch.as_tensor(np.array(x))
                            for x in _leaves(params_np)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_opt_state_carries_across():
    """repro's AdamWState after one update, carried into the port, takes
    the next update as repro does."""
    cfg, tcfg = _cfg()
    params_np = _jax_params(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jstate = JA.adamw_init(jparams)
    g0, g1 = (_shared_grads(params_np, 1e-2, seed=s) for s in (5, 6))
    jparams, jstate, _ = JA.adamw_update(g0, jstate, jparams,
                                         learning_rate=1e-3)
    opt_np = jax.tree_util.tree_map(np.asarray, jstate)
    model = TW.from_jax_params(tcfg, jax.tree_util.tree_map(
        np.asarray, jparams), device="cpu", trainable=True)
    state = TW.opt_state_from_jax(tcfg, opt_np, device="cpu")
    assert int(state.step) == 1
    params = dict(model.named_parameters())
    adamw_update(TW.named(tcfg, g1, "cpu"), state, params,
                 learning_rate=1e-3)
    jparams, _, _ = JA.adamw_update(g1, jstate, jparams, learning_rate=1e-3)
    for g, w in zip(_leaves(TW.grouped(tcfg, params)), _leaves(jparams)):
        _ulp_close(g, w)


def test_train_step_grad_accum_equivalence():
    """accum=2 gives (numerically) the same update as accum=1, as
    tests/test_launch.py holds repro's train step."""
    cfg, tcfg = _cfg("llama3.2-1b", compute_dtype="float32")
    params_np = _jax_params(cfg)
    rng = np.random.default_rng(1)
    B, S = 4, 16
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (B, S))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (B, S))),
             "mask": torch.ones((B, S))}
    out = []
    for accum in (1, 2):
        model = TW.from_jax_params(tcfg, params_np, device="cpu",
                                   trainable=True)
        opt = adamw_init(dict(model.named_parameters()))
        step = TS.make_train_step(tcfg, TrainConfig(warmup_steps=1,
                                                    grad_accum=accum))
        model, opt, m = step(model, opt, batch)
        out.append((model, m))
    (m1, x1), (m2, x2) = out
    np.testing.assert_allclose(float(x1["loss"]), float(x2["loss"]),
                               rtol=1e-5)
    for a, b in zip(m1.parameters(), m2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5)


# -- the trainer ---------------------------------------------------------------

TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=256)
# 40 steps of 0.05 simulated hours under preemption seed 2: two
# preemptions (steps 16 and 36) among the DP's checkpoints
RUN = dict(total_steps=40, sim_hours_per_step=0.05, preemption_seed=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg, tcfg = _cfg(**TINY)
    d = tmp_path_factory.mktemp("train")
    want = jtrain(cfg, JTrainConfig(ckpt_dir=str(d / "jax"), warmup_steps=5),
                  inject_preemptions=True, verbose=False, **RUN)
    tc = TrainConfig(ckpt_dir=str(d / "bumpy"), warmup_steps=5)
    bumpy = TTR.train(tcfg, tc, inject_preemptions=True, verbose=False,
                      device="cpu", **RUN)
    clean = TTR.train(tcfg, dataclasses.replace(tc, ckpt_dir=str(
        d / "clean")), total_steps=RUN["total_steps"], verbose=False,
        device="cpu")
    return want, bumpy, clean


def test_train_schedule_matches_repro(runs):
    want, got, _ = runs
    keys = ("steps_run", "restarts", "checkpoints", "emergency_checkpoints",
            "wasted_steps")
    assert got.restarts >= 1
    assert {k: getattr(got, k) for k in keys} \
        == {k: getattr(want, k) for k in keys}


def test_train_loss_decreases(runs):
    _, got, _ = runs
    assert all(np.isfinite(got.losses))
    assert got.final_loss < np.mean(got.losses[:5]) - 0.1


def test_preempted_run_replays_a_clean_one_bit_for_bit(runs):
    _, bumpy, clean = runs
    assert bumpy.restarts >= 1 and clean.restarts == 0
    assert bumpy.losses == clean.losses
    for a, b in zip(bumpy.model.parameters(), clean.model.parameters()):
        assert torch.equal(a, b)


def test_train_cli_smoke(tmp_path):
    res = TTR.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                    "3", "--ckpt-dir", str(tmp_path)])
    assert res.steps_run == 3 and np.isfinite(res.final_loss)
    # a second run resumes from the last checkpoint instead of retraining
    again = TTR.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert again.steps_run == 0
