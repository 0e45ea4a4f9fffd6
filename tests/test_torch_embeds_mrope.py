"""Embeddings input and M-RoPE in the port (musicgen-medium, qwen2-vl-2b)
against ``repro`` on the CPU at smoke size, and the port's three repairs:
the recurrence's autograd (an earlier guard that raised where autograd
records, now the ``LinearRecurrence`` Function), ``REPRO_SOLVER_BACKEND``
for ``"auto"``, and ``PAPER_FIT_N1_HIGHCPU_16``.

Both sides get the same weights (``repro``'s ``transformer.init``, carried
across with ``weights.from_jax_params``) and the same numpy inputs:
embeddings, labels, masks and, for qwen2-vl, three DISTINCT position
streams (t, h, w), since with equal streams M-RoPE is RoPE.

Tolerances:
- ``apply_mrope`` in float32: atol = rtol = 1e-6.  Both sides form the
  same float32 angles (``repro``'s one-hot ``einsum`` adds exact zeros, the
  port gathers), so only cos / sin from different libms differ, by an ulp.
- Forwards in float32: atol = rtol = 1e-4 (summation order and libm, as
  ``tests/test_torch_models.py``); in bf16 5e-2 in logits of order one (the
  two frameworks round bf16 intermediates at different places).  Decode
  against the full forward: 2e-3 (``tests/test_models.py``'s tolerance).
- Loss and gradients in float32: loss rtol 1e-6, gradients atol 1e-6 +
  rtol 1e-4 (``tests/test_torch_train.py``'s).
- One ``grad_accum=2`` train step against ``repro``'s: loss rtol 1e-6;
  AdamW's first moment (0.1 x the accumulated gradient after one step)
  at the gradients' tolerance scaled by 0.1; the parameters within
  atol 2 x lr (lr = 3e-6 at step 0 of the 100-step warmup): Adam's first
  step moves each element by lr x g / (|g| + eps), so an element whose
  gradient sits within summation noise of zero may move by a different
  fraction of lr on each side.
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
from repro.core import distributions as JD
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch import configs as TC
from repro_torch.configs.base import TrainConfig
from repro_torch.core import distributions as TD
from repro_torch.core.policies import solver_backends
from repro_torch.kernels import ops as TO
from repro_torch.launch import serve as TSV
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TTR
from repro_torch.models import layers as TL
from repro_torch.models import weights as TW
from repro_torch.optim import adamw_init

ARCHS = ["musicgen-medium", "qwen2-vl-2b"]
F32_TOL = 1e-4
BF16_TOL = 5e-2


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


def _jit(fn, cfg, **static):
    return jax.jit(functools.partial(fn, cfg, **static))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _streams(B, S, seed=0, start=0):
    """(3, B, S) int32 position streams that differ from one another: t
    counts on with a per-row offset, h and w walk a 4-wide patch grid."""
    rng = np.random.default_rng(seed)
    s = start + np.arange(S, dtype=np.int32)
    t = s[None, :] + rng.integers(0, 5, (B, 1)).astype(np.int32)
    h = np.broadcast_to(s // 4, (B, S))
    w = np.broadcast_to(s % 4 + 7, (B, S))
    return np.stack([t, h, w]).astype(np.int32)


def _inputs(cfg, B, S, seed=0):
    """embeds (B, S, d) float32 of the init's scale, and positions for
    M-RoPE archs (None otherwise)."""
    rng = np.random.default_rng(seed)
    embeds = (0.02 * rng.standard_normal((B, S, cfg.d_model))).astype(
        np.float32)
    pos = _streams(B, S, seed) if cfg.pos_type == "mrope" else None
    return embeds, pos


def _jbatch(**kw):
    return {k: jnp.asarray(v) for k, v in kw.items() if v is not None}


def _tbatch(**kw):
    return {k: torch.as_tensor(v) for k, v in kw.items() if v is not None}


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("get", ["get", "smoke"])
def test_config_equals_repro(arch, get):
    """``repro``'s fields as ``repro`` has them; the port's own (the
    vision tower's and the q/k/v biases') at their defaults, off."""
    got, want = getattr(TC, get)(arch), getattr(JC, get)(arch)
    mine, theirs = dataclasses.asdict(got), dataclasses.asdict(want)
    assert {k: mine[k] for k in theirs} == theirs
    off = {f.name: f.default for f in dataclasses.fields(got)
           if f.name not in theirs}
    assert off and {k: mine[k] for k in off} == off
    assert got.embeds_input


def test_full_config_parameter_counts():
    """Both models whole in bf16 on one 80 GB card (the parameter counts
    the chip run holds its models to)."""
    counts = {a: TC.get(a).param_count() for a in ARCHS}
    assert round(counts["musicgen-medium"] / 1e9, 3) == 1.365
    assert round(counts["qwen2-vl-2b"] / 1e9, 3) == 1.544


# -- M-RoPE --------------------------------------------------------------------

@pytest.mark.parametrize("sections,D", [((16, 24, 24), 128), ((8, 4, 4), 32),
                                        ((2, 1, 1), 8)])
def test_apply_mrope_matches_jax_at_distinct_streams(sections, D):
    rng = np.random.default_rng(3)
    B, S, H = 2, 9, 3
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = _streams(B, S, seed=3, start=100)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = TL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                         sections)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_apply_mrope_with_equal_streams_is_rope():
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((2, 5, 2, 32)),
                        dtype=torch.float32)
    pos = torch.as_tensor(rng.integers(0, 300, (2, 5)), dtype=torch.int32)
    got = TL.apply_mrope(x, pos.expand(3, 2, 5), 1e4, (8, 4, 4))
    assert torch.equal(got, TL.apply_rope(x, pos, 1e4))


def test_apply_mrope_checks_its_sections():
    x = torch.zeros((1, 2, 1, 32))
    with pytest.raises(AssertionError):
        TL.apply_mrope(x, torch.zeros((3, 1, 2), dtype=torch.int32), 1e4,
                       (8, 4, 2))


# -- the forward, prefill and decode -------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_embeds_forward_matches_jax(arch, dtype, tol):
    cfg, tcfg = _cfg(arch, dtype)
    params_np = _jax_params(cfg)
    model = TW.from_jax_params(tcfg, params_np, device="cpu")
    embeds, pos = _inputs(cfg, 2, 24)
    want, _ = _jit(JT.forward, cfg, mode="train")(
        params_np, None, embeds=jnp.asarray(embeds),
        positions=None if pos is None else jnp.asarray(pos))
    got, _ = model(embeds=torch.as_tensor(embeds),
                   positions=None if pos is None else torch.as_tensor(pos))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    _close(got, want, tol)


def test_forward_takes_exactly_one_input():
    _, tcfg = _cfg("qwen2-vl-2b")
    model = TW.from_jax_params(tcfg, _jax_params(_cfg("qwen2-vl-2b")[0]),
                               device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        model()
    with pytest.raises(ValueError, match="exactly one"):
        model(torch.zeros((1, 2), dtype=torch.long),
              embeds=torch.zeros((1, 2, tcfg.d_model)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_embeds_then_token_decode(arch):
    """Prefill on embeds (qwen2-vl with distinct streams), then decode of
    given tokens through the embedding table at the default
    positions: each decode step matches ``repro``'s decode step and the
    full forward over the embeds plus the tokens' table rows, with the
    positions extended by the decode positions in every stream."""
    cfg, tcfg = _cfg(arch)
    params_np = _jax_params(cfg)
    model = TW.from_jax_params(tcfg, params_np, device="cpu")
    B, S, n_dec = 2, 20, 3
    embeds, pos = _inputs(cfg, B, S, seed=1)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, n_dec))
    cache = model.init_cache(B, S + n_dec)
    last, cache = TS.make_prefill_step(tcfg)(
        model, cache, _tbatch(embeds=embeds, positions=pos))
    jcache = JT.init_cache(cfg, B, S + n_dec)
    jlast, jcache = _jit(JT.prefill_step, cfg)(
        params_np, None, embeds=jnp.asarray(embeds),
        positions=None if pos is None else jnp.asarray(pos), cache=jcache)
    assert last.shape == (B, 1, cfg.vocab_size)
    _close(last, jlast, F32_TOL)
    decode = TS.make_decode_step(tcfg)
    j_decode = _jit(JT.decode_step, cfg)
    dec = []
    for i in range(n_dec):
        logits, _, cache = decode(model, cache,
                                  _tbatch(tokens=toks[:, i:i + 1]))
        jlogits, jcache = j_decode(params_np, jnp.asarray(
            toks[:, i:i + 1], jnp.int32), cache=jcache)
        _close(logits, jlogits, F32_TOL)
        dec.append(logits[:, 0])
    assert cache["t"] == S + n_dec
    table = params_np["embed"]["table"]
    full_embeds = np.concatenate([embeds, table[toks]], axis=1)
    full_pos = None
    if pos is not None:
        ext = np.broadcast_to(S + np.arange(n_dec, dtype=np.int32),
                              (3, B, n_dec))
        full_pos = torch.as_tensor(np.concatenate([pos, ext], axis=2))
    full, _ = model(embeds=torch.as_tensor(full_embeds), positions=full_pos)
    _close(last[:, 0], full[:, S - 1], F32_TOL)
    for i in range(n_dec):
        _close(dec[i], full[:, S + i], 2e-3)


# -- loss, gradients and the train step ----------------------------------------

def _loss_batch(cfg, B=4, S=16, seed=5):
    embeds, pos = _inputs(cfg, B, S, seed)
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.uniform(size=(B, S)) > 0.2).astype(np.float32)
    return dict(embeds=embeds, labels=labels, mask=mask, positions=pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_with_embeds_match_jax(arch):
    cfg, tcfg = _cfg(arch)
    params_np = _jax_params(cfg)
    batch = _loss_batch(cfg)
    (want, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(cfg, p, b), has_aux=True))(
        params_np, _jbatch(**batch))
    model = TW.from_jax_params(tcfg, params_np, device="cpu",
                               trainable=True)
    loss, aux, grads = TS.value_and_grad(model, _tbatch(**batch))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    for key in ("nll", "zloss"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-6)
    names = [n for n, _ in model.named_parameters()]
    got = TW.grouped(tcfg, dict(zip(names, grads)))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray,
                                                            jgrads))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)
    table_grad = dict(zip(names, grads))["embed"]
    if cfg.tie_embeddings:
        # qwen2-vl reads its table as the LM head
        assert float(table_grad.abs().max()) > 0
    else:
        # musicgen's table is unused under embeds: zeros, as in JAX
        assert torch.equal(table_grad, torch.zeros_like(table_grad))
        assert not np.asarray(jgrads["embed"]["table"]).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_2_step_matches_repro(arch):
    """One ``grad_accum=2`` step, embeds and (for qwen2-vl) (3, B, S)
    positions cut along their batch axis, against ``repro``'s
    ``make_train_step``."""
    cfg, tcfg = _cfg(arch)
    params_np = _jax_params(cfg)
    batch = _loss_batch(cfg, seed=7)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jstep = jax.jit(JS.make_train_step(cfg, JTrainConfig(grad_accum=2)))
    jparams, jstate, jm = jstep(jparams, JA.adamw_init(jparams),
                                _jbatch(**batch))
    model = TW.from_jax_params(tcfg, params_np, device="cpu",
                               trainable=True)
    opt = adamw_init(dict(model.named_parameters()))
    step = TS.make_train_step(tcfg, TrainConfig(grad_accum=2))
    model, opt, m = step(model, opt, _tbatch(**batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    lr = float(m["lr"])
    np.testing.assert_allclose(lr, float(jm["lr"]), rtol=1e-6)
    assert lr == pytest.approx(3e-6, rel=1e-5)
    for g, w in zip(jax.tree_util.tree_leaves(TW.grouped(tcfg, opt.mu)),
                    jax.tree_util.tree_leaves(jstate.mu)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-7)
    params = dict(model.named_parameters())
    for g, w in zip(jax.tree_util.tree_leaves(TW.grouped(tcfg, params)),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2 * lr)


def test_grad_accum_cuts_positions_along_the_batch_axis(monkeypatch):
    """Each microbatch of a (3, B, S) positions batch keeps all three
    streams of its own rows: accumulating two halves equals the whole."""
    cfg, tcfg = _cfg("qwen2-vl-2b")
    params_np = _jax_params(cfg)
    batch = _tbatch(**_loss_batch(cfg, seed=9))
    seen = []
    model = TW.from_jax_params(tcfg, params_np, device="cpu",
                               trainable=True)
    real = TS.T.lm_loss

    def spy(model, b):
        seen.append(b["positions"])
        return real(model, b)

    monkeypatch.setattr(TS.T, "lm_loss", spy)
    TS.make_train_step(tcfg, TrainConfig(grad_accum=2))(
        model, adamw_init(dict(model.named_parameters())), batch)
    assert [tuple(p.shape) for p in seen] == [(3, 2, 16), (3, 2, 16)]
    assert torch.equal(torch.cat(seen, dim=1), batch["positions"])


# -- the entry points ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_refuses_embeds_archs(arch):
    with pytest.raises(SystemExit, match="token-input"):
        TSV.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_serve_rotates_an_old_pod():
    """A pod that has run 23.5 h when the first batch arrives is rotated
    (``replace_pod``: age 0 again), the next batch keeps it."""
    cfg = TC.smoke("llama3.2-1b")
    from repro_torch.models import transformer as TT
    model = TT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    recs = TSV.serve(cfg, model, batches=2, batch_size=2, prompt_len=8,
                     n_decode=2, device="cpu", start_hours=23.5)
    assert [r["rotated"] for r in recs] == [True, False]
    assert recs[0]["pod_age"] == pytest.approx(TSV.EST_JOB_HOURS)
    assert recs[1]["pod_age"] == pytest.approx(2 * TSV.EST_JOB_HOURS)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_on_tokens(arch, tmp_path):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu``: both archs train on SyntheticLM tokens through their tables."""
    res = TTR.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "3", "--ckpt-dir", str(tmp_path)])
    assert res.steps_run == 3 and np.isfinite(res.final_loss)


# -- the repairs ---------------------------------------------------------------

def test_linear_recurrence_records_a_grad_fn_where_autograd_records():
    """The recurrence trains: called on inputs that require grad it records
    its autograd Function and returns finite gradients for a, b and h0."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, 5, 8)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((2, 5, 8)), dtype=torch.float32)
    h0 = torch.as_tensor(rng.standard_normal((2, 8)), dtype=torch.float32)
    args = [x.clone().requires_grad_() for x in (a, b, h0)]
    h, h_last = TO.linear_recurrence(*args)
    assert type(h.grad_fn).__name__ == "LinearRecurrenceBackward"
    grads = torch.autograd.grad(h.sum() + h_last.sum(), args)
    for x, g in zip(args, grads):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert torch.isfinite(g).all() and g.abs().sum() > 0
    with torch.no_grad():
        assert TO.linear_recurrence(*args)[0].grad_fn is None


def test_solver_backend_env_steers_auto_only(monkeypatch):
    monkeypatch.delenv(solver_backends.ENV_VAR, raising=False)
    assert solver_backends.resolve("auto", "cpu") == "reference"
    assert solver_backends.resolve("auto", "cuda") == "cuda"
    monkeypatch.setenv(solver_backends.ENV_VAR, "cuda")
    assert solver_backends.resolve("auto", "cpu") == "cuda"
    assert solver_backends.resolve("reference", "cpu") == "reference"
    monkeypatch.setenv(solver_backends.ENV_VAR, " Reference ")
    assert solver_backends.resolve("auto", "cuda") == "reference"
    assert solver_backends.resolve("cuda", "cuda") == "cuda"
    monkeypatch.setenv(solver_backends.ENV_VAR, "pallas")
    with pytest.raises(ValueError, match="reference"):
        solver_backends.resolve("auto", "cpu")
    assert solver_backends.resolve("reference", "cpu") == "reference"


POOL_RTOL = 1e-8      # chip_smoke.py's card-vs-CPU pool tolerance


@pytest.mark.parametrize("which", ["phase 4", "phase 18"])
def test_pool_tolerance_covers_exp_rounding(which, monkeypatch):
    """The pools that ``chip_smoke.py`` draws on the card and on the CPU
    (phase 4: the default grid's first scenario, 4000 trials, seed 0;
    phase 18: Fig. 7's n1-highcpu-16 model from age 6 h, 600 trials, seed
    17) evaluate the same float64 expressions, but the card's exp rounds
    differently.  Perturbing every exp of the inverse CDF by one ulp, at
    random, moves them by less than a tenth of the card's tolerance."""
    from repro_torch.core import engine, scenarios
    if which == "phase 4":
        dists = [scenarios.default_grid()[0].dist()]
        kw = dict(n_trials=4000, seed=[0])
    else:
        dists = [TD.constrained_for("n1-highcpu-16")]
        kw = dict(n_trials=600, seed=[17], start_age=6.0)

    def draw():
        return engine.draw_lifetime_pool_batch(dists, max_restarts=64,
                                               device="cpu", **kw)

    want = draw()
    exact = TD._exp
    gen = torch.Generator().manual_seed(0)

    def exp_off_by_an_ulp(x):
        y = exact(x)
        step = torch.randint(-1, 2, y.shape, generator=gen).to(y.dtype)
        return y * (1.0 + step * 2.0 ** -52)

    monkeypatch.setattr(TD, "_exp", exp_off_by_an_ulp)
    got = draw()
    moved = False
    for g, w in zip(got, want):
        rel = float(((g - w).abs() / w.abs()).max())
        assert rel < POOL_RTOL / 10, rel
        moved |= not torch.equal(g, w)
    assert moved


def test_paper_fit_n1_highcpu_16_equals_repro():
    assert TD.PAPER_FIT_N1_HIGHCPU_16 == JD.PAPER_FIT_N1_HIGHCPU_16
    assert TD.PAPER_FIT_N1_HIGHCPU_16 == TD.VM_TYPE_PARAMS["n1-highcpu-16"]
