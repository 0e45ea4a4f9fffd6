"""Parity of the port's serving-path models (``repro_torch.models``) with
``repro.models`` on the CPU, at smoke size.

Both sides get the same weights - JAX's ``transformer.init``, carried
across with ``weights.from_jax_params`` - and the same numpy inputs.  On
the CPU every kernel wrapper takes its plain version, so these tests hold
the layers, the cache logic and the assembly to the reference.

Tolerances: in float32 compute the two differ only by summation order and
libm rounding, so outputs agree to atol = rtol = 1e-4.  In bfloat16
compute the two frameworks round intermediates at different places (XLA
may keep excess precision inside fused elementwise chains, PyTorch rounds
each op), so a layer agrees to a few bf16 ulps and a whole forward to
BF16_TOL in logits of order one.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TR
from repro_torch.models import transformer as TT
from repro_torch.models import weights as TW

F32_TOL = 1e-4
BF16_TOL = 5e-2
ARCHS = ["recurrentgemma-2b", "llama3.2-1b", "smollm-135m", "yi-34b",
         "deepseek-coder-33b", "musicgen-medium", "qwen2-vl-2b",
         "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
MOE_ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]


def _cfg(arch, dtype="float32", **over):
    cfg = dataclasses.replace(JC.smoke(arch), compute_dtype=dtype, **over)
    return cfg, dataclasses.replace(TC.smoke(arch), compute_dtype=dtype,
                                    **over)


@functools.cache
def _jax_params(cfg):
    params, _ = JT.init(cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _jit(fn, cfg, **static):
    """``fn(cfg, ...)`` of repro, compiled once per mode (JAX's eager
    dispatch of a whole layer costs seconds a call)."""
    return jax.jit(functools.partial(fn, cfg, **static))


def _port_layer(tcfg, np_layer):
    """One layer's numpy pytree as the port's stored tensors."""
    tree = jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a)),
                                  np_layer)
    return TW.stored(tcfg, tree)


def _layer_of(params_np, pidx, g=0):
    return jax.tree_util.tree_map(lambda a: a[g], params_np["groups"][pidx])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_registry_has_the_ported_archs_only():
    assert set(TC.ARCHS) == set(ARCHS)
    for arch in ARCHS:
        for get in ("get", "smoke"):
            assert dataclasses.asdict(getattr(TC, get)(arch)) \
                == dataclasses.asdict(getattr(JC, get)(arch))
    with pytest.raises(KeyError, match="ROADMAP.md"):
        TC.get("xlstm-1.3b")


def test_unported_block_kinds_raise():
    cfg = dataclasses.replace(TC.smoke("llama3.2-1b"),
                              block_pattern=("mlstm",))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TT.init(cfg, torch.Generator(), device="cpu")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2 ** -7)])
def test_rms_norm(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = JL.rms_norm(jnp.asarray(x, jdt), {"scale": jnp.asarray(scale)},
                       1e-6)
    got = TL.rms_norm(torch.as_tensor(x).to(dtype), torch.as_tensor(scale),
                      1e-6)
    assert got.dtype == dtype
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
def test_apply_rope_half_split(dtype, tol):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = JL.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 10000.0)
    got = TL.apply_rope(torch.as_tensor(x).to(dtype), torch.as_tensor(pos),
                        10000.0)
    _close(got, want, tol)
    # half-split pairs: feature i rotates with feature i + D/2
    unit = np.zeros((1, 1, 1, 32), np.float32)
    unit[..., 0] = 1.0
    out = TL.apply_rope(torch.as_tensor(unit),
                        torch.ones((1, 1), dtype=torch.int32), 10000.0)
    nz = np.flatnonzero(np.abs(out.numpy().ravel()) > 1e-6)
    assert nz.tolist() == [0, 16]


def _attn_inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def test_attention_block_prefill_and_decode_through_the_ring():
    """A local-attention layer: prefill S = 32 through a window of 16 (the
    cache holds 16 slots, rolled by S % 16), then 20 decode steps, which
    wrap the ring once more.  Outputs and cache contents match."""
    cfg, tcfg = _cfg("recurrentgemma-2b")
    params_np = _jax_params(cfg)
    p_np = _layer_of(params_np, 2)["attn"]          # (rglru, rglru, local)
    p_t = _port_layer(tcfg, p_np)
    B, S, n_dec, win = 2, 32, 20, cfg.window
    x = _attn_inputs(cfg, B, S + n_dec, 3)
    size = min(S + n_dec, win)
    jc = JL.init_kv_cache(cfg, B, size)
    tc = TL.init_kv_cache(tcfg, B, size, device="cpu")
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    j_prefill = _jit(JL.attention_block, cfg, mode="prefill", window=win)
    j_decode = _jit(JL.attention_block, cfg, mode="decode", window=win)
    jo, jc = j_prefill(p_np, jnp.asarray(x[:, :S]),
                       positions=jnp.asarray(pos), cache=jc)
    to, tc = TL.attention_block(tcfg, p_t, torch.as_tensor(x[:, :S]),
                                positions=torch.as_tensor(pos), cache=tc,
                                mode="prefill", window=win)
    _close(to, jo, F32_TOL)
    for t in range(S, S + n_dec):
        pos = np.full((B, 1), t, np.int32)
        jo, jc = j_decode(p_np, jnp.asarray(x[:, t:t + 1]),
                          positions=jnp.asarray(pos), cache=jc)
        to, tc = TL.attention_block(tcfg, p_t, torch.as_tensor(x[:, t:t + 1]),
                                    positions=torch.as_tensor(pos), cache=tc,
                                    mode="decode", window=win)
        _close(to, jo, F32_TOL)
    _close(tc["k"], jc["k"], F32_TOL)
    _close(tc["v"], jc["v"], F32_TOL)
    assert tc["pos"] == int(jc["pos"]) == S + n_dec


def test_rglru_layer_prefill_and_decode():
    cfg, tcfg = _cfg("recurrentgemma-2b")
    p_np = _layer_of(_jax_params(cfg), 0)
    p_t = _port_layer(tcfg, p_np)
    B, S, n_dec = 2, 20, 4
    x = _attn_inputs(cfg, B, S + n_dec, 4)
    jc = JR.init_rglru_cache(cfg, B)
    tc = TR.init_rglru_cache(tcfg, B, device="cpu")
    j_prefill = _jit(JR.rglru_layer, cfg, mode="prefill")
    j_decode = _jit(JR.rglru_layer, cfg, mode="decode")
    jo, jc = j_prefill(p_np, jnp.asarray(x[:, :S]), cache=jc)
    to, tc = TR.rglru_layer(tcfg, p_t, torch.as_tensor(x[:, :S]), cache=tc,
                            mode="prefill")
    _close(to, jo, F32_TOL)
    for t in range(S, S + n_dec):
        jo, jc = j_decode(p_np, jnp.asarray(x[:, t:t + 1]), cache=jc)
        to, tc = TR.rglru_layer(tcfg, p_t, torch.as_tensor(x[:, t:t + 1]),
                                cache=tc, mode="decode")
        _close(to, jo, F32_TOL)
    assert tc["h"].dtype == torch.float32
    _close(tc["h"], jc["h"], F32_TOL)
    _close(tc["conv"], jc["conv"], F32_TOL)
    # the no-cache (train) form of the layer
    jo, _ = _jit(JR.rglru_layer, cfg)(p_np, jnp.asarray(x))
    to, _ = TR.rglru_layer(tcfg, p_t, torch.as_tensor(x))
    _close(to, jo, F32_TOL)


def test_weights_dtype_rule():
    cfg, tcfg = _cfg("recurrentgemma-2b", "bfloat16")
    model = TW.from_jax_params(tcfg, _jax_params(cfg), device="cpu")
    assert model.embed.dtype == torch.bfloat16
    rg, attn = model.layers[0], model.layers[2]
    for name in ("in_x", "in_gate", "conv", "out"):
        assert rg[name].dtype == torch.bfloat16, name
    for name in ("w_a", "b_a", "w_i", "b_i", "lam"):
        assert rg[name].dtype == torch.float32, name
    assert rg["ln1"]["scale"].dtype == torch.float32
    assert model.final_norm.dtype == torch.float32
    assert attn["attn"]["wq"].dtype == torch.bfloat16
    assert attn["mlp"]["down"].dtype == torch.bfloat16
    assert model.kinds == ["rglru", "rglru", "local_attn", "rglru", "rglru"]


def _tokens(cfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_full_forward_matches_jax(arch, dtype, tol):
    """The whole smoke model's train-mode logits.  S = 40 crosses the
    recurrentgemma smoke window (16)."""
    cfg, tcfg = _cfg(arch, dtype)
    params_np = _jax_params(cfg)
    model = TW.from_jax_params(tcfg, params_np, device="cpu")
    toks = _tokens(cfg, 2, 40)
    want, _ = _jit(JT.forward, cfg, mode="train")(
        params_np, jnp.asarray(toks, jnp.int32))
    got, _ = model(torch.as_tensor(toks))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    _close(got, want, tol)


def _prefill_decode(cfg, tcfg, B, S, n_dec, full_tol):
    """The port's prefill + decode against its full forward (within
    ``full_tol``, unless None) and against ``repro``'s prefill_step /
    decode_step (within F32_TOL)."""
    params_np = _jax_params(cfg)
    model = TW.from_jax_params(tcfg, params_np, device="cpu")
    toks = _tokens(cfg, B, S + n_dec)
    full, _ = model(torch.as_tensor(toks))
    cache = model.init_cache(B, S + n_dec)
    last, cache = model.prefill_step(torch.as_tensor(toks[:, :S]), cache)
    assert last.shape == (B, 1, cfg.vocab_size)
    if full_tol is not None:
        _close(last[:, 0], full[:, S - 1], F32_TOL)
    jcache = JT.init_cache(cfg, B, S + n_dec)
    j_decode = _jit(JT.decode_step, cfg)
    jlast, jcache = _jit(JT.prefill_step, cfg)(
        params_np, jnp.asarray(toks[:, :S], jnp.int32), cache=jcache)
    _close(last, jlast, F32_TOL)
    for t in range(S, S + n_dec):
        dec, cache = model.decode_step(torch.as_tensor(toks[:, t:t + 1]),
                                       cache)
        jdec, jcache = j_decode(params_np, jnp.asarray(toks[:, t:t + 1],
                                                       jnp.int32),
                                cache=jcache)
        if full_tol is not None:
            _close(dec[:, 0], full[:, t], full_tol)
        _close(dec, jdec, F32_TOL)
    assert cache["t"] == S + n_dec


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Prefill + decode reproduces the full-sequence forward (as
    tests/test_models.py checks for repro), and the decode logits match
    JAX's decode step.  MoE archs run at ``capacity_factor =
    n_experts``: capacity is then Tg * K, so no pair drops, and the full
    forward's grouping of the tokens (which decides drops) cannot change
    what a token gets."""
    over = {}
    if arch in MOE_ARCHS:
        over["capacity_factor"] = float(TC.smoke(arch).n_experts)
    cfg, tcfg = _cfg(arch, **over)
    # 2e-3: test_models.py's tolerance
    _prefill_decode(cfg, tcfg, 2, 24, 3, 2e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_decode_matches_repro_at_published_capacity(arch):
    """At the published capacity factor (1.25) pairs may drop, and a
    prefill groups its tokens otherwise than a full forward: prefill and
    decode are held to ``repro``'s prefill_step / decode_step only.  The
    prefill of 2 x 40 tokens is one group of 80 (capacity 25 for
    moonshot's 8 experts, 50 for phi3.5's 4)."""
    cfg, tcfg = _cfg(arch)
    assert cfg.capacity_factor == 1.25
    _prefill_decode(cfg, tcfg, 2, 40, 3, None)


def test_init_draws_the_reference_shapes():
    """The port's own initialisation gives every parameter repro's shape,
    and recurrentgemma-2b's full config counts 2.66 B parameters."""
    cfg, tcfg = _cfg("recurrentgemma-2b", "bfloat16")
    model = TT.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ref = TW.from_jax_params(tcfg, _jax_params(cfg), device="cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in ref.state_dict().items()}
    assert got == want
    assert sum(v.numel() for v in model.state_dict().values()) \
        == tcfg.param_count()
    assert round(TC.get("recurrentgemma-2b").param_count() / 1e9, 2) == 2.66
