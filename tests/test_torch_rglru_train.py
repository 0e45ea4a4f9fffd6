"""Training recurrentgemma-2b in the port against ``repro`` on the CPU: the
RG-LRU recurrence's backward, and the model's loss, gradients and train
step at smoke size.

``linear_recurrence_bwd_plain`` (the plain version of the backward kernel
in ``kernels/csrc/rglru_scan.cu``) and the ``LinearRecurrence`` autograd
Function, which on the CPU pairs the plain forward with it, are held to:

- torch.autograd through ``linear_recurrence_plain``: bit-identical, in
  float32 and bfloat16, with and without h0 and a gradient of h_last.  The
  reverse loop does autograd's arithmetic in its order (dh_t = g_t +
  a_{t+1} dh_{t+1} in float32, da_t = dh_t h_{t-1} with the float32 state,
  one rounding to the input type).
- ``jax.vjp`` of ``repro.kernels.ref.linear_recurrence`` (a scan) and of
  ``repro.kernels.ops.linear_recurrence(impl="assoc")`` (an associative
  scan, XLA's autodiff of which ``repro`` trains through), on the same
  numpy inputs.  float32: rtol = atol = 1e-5 (the associative scan sums in
  another order).  bfloat16: within 2 bf16 ulps of the tensor's largest
  element, ``2 * 2**-8 * max|want|``, elementwise: both sides carry float32
  and round each gradient once, but ``assoc`` folds a_0 h0 into b_0 in
  bf16 before its scan, which moves h and so da by a bf16 rounding.

The model (``repro``'s weights carried across with
``weights.from_jax_params(..., trainable=True)``, ``repro``'s numpy
batches) is held at ``tests/test_torch_train.py``'s tolerances: float32
loss rtol 1e-6 and every gradient leaf atol 1e-6 + rtol 1e-4, remat on
and off; the bf16 loss rtol 5e-3; a ``grad_accum=2`` step against
``grad_accum=1`` at loss rtol 1e-5 and parameters atol 2e-5.  The kernels
themselves run only on the card (``chip_smoke.py`` phases 6, 16 and 20).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import ops as TO
from repro_torch.kernels import rglru_scan as RS
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TTR
from repro_torch.models import transformer as TT
from repro_torch.models import weights as TW
from repro_torch.optim import adamw_init

ARCH = "recurrentgemma-2b"
W = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations: one intra-op thread, so that test workers
    sharing the cores do not oversubscribe them (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rec_inputs(S, dtype, with_h0, with_g_last, seed=0, B=2):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32) if with_h0 else None
    g = rng.standard_normal((B, S, W)).astype(np.float32)
    g_last = (rng.standard_normal((B, W)).astype(np.float32)
              if with_g_last else None)

    def t(x):
        return None if x is None else torch.as_tensor(x).to(dtype)

    return (a, b, h0, g, g_last), tuple(map(t, (a, b, h0, g, g_last)))


def _grads_through(fn, a, b, h0, g, g_last):
    """(da, db[, dh0]) of ``fn``'s outputs at cotangents (g, g_last)."""
    ins = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    if h0 is not None:
        ins.append(h0.clone().requires_grad_())
    h, h_last = fn(*ins) if h0 is not None else fn(*ins, None)
    outs, cots = [h], [g]
    if g_last is not None:
        outs.append(h_last)
        cots.append(g_last)
    return torch.autograd.grad(outs, ins, cots)


REC_CASES = [(S, dt, h0, gl) for S in (1, 37)
             for dt in ("float32", "bfloat16")
             for h0 in (False, True) for gl in (False, True)]


@pytest.mark.parametrize("S,dtype,with_h0,with_g_last", REC_CASES)
def test_bwd_plain_equals_autograd_through_the_plain_loop(S, dtype, with_h0,
                                                          with_g_last):
    _, (a, b, h0, g, g_last) = _rec_inputs(S, getattr(torch, dtype),
                                           with_h0, with_g_last)
    want = _grads_through(RS.linear_recurrence_plain, a, b, h0, g, g_last)
    states = RS._forward(a, b, h0, keep_states=True)[2]
    assert states.dtype == torch.float32
    da, db, dh0 = RS.linear_recurrence_bwd_plain(a, states, g, g_last, h0)
    got = (da, db) if h0 is None else (da, db, dh0)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # the Function, and the wrapper's CPU branch, take the same numbers
    via_fn = _grads_through(RS.LinearRecurrence.apply, a, b, h0, g, g_last)
    via_wrapper = RS.linear_recurrence_bwd(a, states, g, g_last, h0)
    for x, y, z in zip(via_fn, via_wrapper, want):
        assert torch.equal(x, z) and torch.equal(y, z)


@pytest.mark.parametrize("S", [1, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_without_a_gradient_of_h(S, dtype):
    """Only h_last carries a gradient (g is None): the chain starts from
    g_last and carries it back alone."""
    _, (a, b, h0, _, g_last) = _rec_inputs(S, getattr(torch, dtype), True,
                                           True, seed=2)
    ins = [x.clone().requires_grad_() for x in (a, b, h0)]
    want = torch.autograd.grad(RS.linear_recurrence_plain(*ins)[1], ins,
                               g_last)
    states = RS._forward(a, b, h0, keep_states=True)[2]
    got = RS.linear_recurrence_bwd_plain(a, states, None, g_last, h0)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    h, h_last = RS.LinearRecurrence.apply(*ins)
    for x, y in zip(torch.autograd.grad(h_last, ins, g_last), want):
        assert torch.equal(x, y)


def _jax_vjp(fn, a, b, h0, g, g_last):
    args = [jnp.asarray(a), jnp.asarray(b)] + (
        [] if h0 is None else [jnp.asarray(h0)])
    (h, h_last), vjp = jax.vjp(
        lambda *xs: fn(xs[0], xs[1], xs[2] if len(xs) > 2 else None), *args)
    cot_last = (jnp.zeros_like(h_last) if g_last is None
                else jnp.asarray(g_last))
    return vjp((jnp.asarray(g), cot_last))


JAX_REFS = {
    "ref": JR.linear_recurrence,
    "assoc": lambda a, b, h0: JO.linear_recurrence(a, b, h0, impl="assoc"),
}


@pytest.mark.parametrize("impl", sorted(JAX_REFS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0,with_g_last", [(False, False),
                                                 (True, True)])
def test_function_matches_jax_autodiff(impl, dtype, with_h0, with_g_last):
    _, (a, b, h0, g, g_last) = _rec_inputs(
        37, getattr(torch, dtype), with_h0, with_g_last, seed=1)
    got = _grads_through(TO.linear_recurrence, a, b, h0, g, g_last)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    # the same values on both sides: the torch inputs, rounded as given
    jin = [None if x is None else np.asarray(x.float().numpy()).astype(jdt)
           for x in (a, b, h0, g, g_last)]
    want = _jax_vjp(JAX_REFS[impl], *jin)
    assert len(got) == len(want)
    for x, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        x = x.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(x, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_less(
                np.abs(x - w), 2 * 2.0 ** -8 * np.abs(w).max() + 1e-30)


def test_ops_linear_recurrence_records_only_where_autograd_records():
    """``ops.linear_recurrence`` goes through the Function where an input
    needs a gradient, and through the forward alone otherwise (serving,
    decode), with the same outputs."""
    _, (a, b, h0, _, _) = _rec_inputs(9, torch.float32, True, False)
    h, h_last = TO.linear_recurrence(a, b, h0)
    assert h.grad_fn is None and h_last.grad_fn is None
    a_ = a.clone().requires_grad_()
    h2, h_last2 = TO.linear_recurrence(a_, b, h0)
    assert type(h2.grad_fn).__name__ == "LinearRecurrenceBackward"
    assert torch.equal(h2.detach(), h) and torch.equal(h_last2.detach(),
                                                       h_last)
    with torch.no_grad():
        assert TO.linear_recurrence(a_, b, h0)[0].grad_fn is None


def test_bwd_checks_its_inputs():
    _, (a, b, h0, g, _) = _rec_inputs(5, torch.float32, True, False)
    states = RS._forward(a, b, h0, keep_states=True)[2]
    with pytest.raises(ValueError, match="states must be float32"):
        RS.linear_recurrence_bwd(a, states.bfloat16(), g)
    with pytest.raises(ValueError, match="g must be"):
        RS.linear_recurrence_bwd(a, states, g[:, :3])
    with pytest.raises(ValueError, match="g_last must be"):
        RS.linear_recurrence_bwd(a, states, g, g[:, 0].bfloat16())
    with pytest.raises(ValueError, match="runs on cuda"):
        RS.linear_recurrence_bwd(*(x.to("meta") for x in (a, states, g)))


# -- the model ---------------------------------------------------------------

def _cfg(**over):
    return (dataclasses.replace(JC.smoke(ARCH), **over),
            dataclasses.replace(TC.smoke(ARCH), **over))


@functools.cache
def _jax_params(cfg):
    params, _ = JT.init(cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(cfg, B=4, S=32, step=3):
    b = JSyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                     seed=1).batch(step)
    return {k: np.array(v) for k, v in b.items()}


def _port_grads(model, batch):
    loss, aux = TT.lm_loss(model, {k: torch.as_tensor(v)
                                   for k, v in batch.items()})
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
        np.testing.assert_allclose(float(aux[key].detach()), float(jaux[key]),
                                   rtol=1e-6)
    got = jax.tree_util.tree_leaves(TW.grouped(tcfg, grads))
    want_leaves = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want_leaves) == 67
    for g, w in zip(got, want_leaves):
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
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values())


def test_remat_runs_each_recurrence_twice_forward_once_backward(
        monkeypatch):
    """Under remat each RG-LRU layer's recurrence runs through the Function:
    its forward twice (the forward, then the backward's recomputation) and
    its backward once, as the card's launch counts show it."""
    cfg, tcfg = _cfg(compute_dtype="float32", remat=True)
    model = TW.from_jax_params(tcfg, _jax_params(cfg), device="cpu",
                               trainable=True)
    calls = {"forward": 0, "forward_kept": 0, "backward": 0}
    fwd, bwd = RS._forward, RS.linear_recurrence_bwd

    def count_fwd(a, b, h0, keep_states):
        calls["forward"] += 1
        calls["forward_kept"] += keep_states
        return fwd(a, b, h0, keep_states)

    def count_bwd(*args):
        calls["backward"] += 1
        return bwd(*args)

    monkeypatch.setattr(RS, "_forward", count_fwd)
    monkeypatch.setattr(RS, "linear_recurrence_bwd", count_bwd)
    _port_grads(model, _batch(cfg, B=2, S=16))
    n_rec = TT.layer_kinds(tcfg).count("rglru")
    assert n_rec == 4
    assert calls == {"forward": 2 * n_rec, "forward_kept": 2 * n_rec,
                     "backward": n_rec}


def test_train_step_grad_accum_equivalence():
    """accum=2 gives (numerically) the same update as accum=1."""
    cfg, tcfg = _cfg(compute_dtype="float32")
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


def test_train_cli_smoke(tmp_path):
    """``python -m repro_torch.launch.train --arch recurrentgemma-2b
    --smoke --device cpu``."""
    res = TTR.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                    "3", "--ckpt-dir", str(tmp_path)])
    assert res.steps_run == 3 and np.isfinite(res.final_loss)
    assert all(np.isfinite(res.losses))
