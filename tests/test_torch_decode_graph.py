"""The decode step as one CUDA graph per cache (``launch/steps.py::
DecodeGraph``): where it engages, that its steps equal the eager steps,
that no output aliases the graph's static tensors, that a new cache
storage releases the old graph while the caches of later batches, which
take the storage of the last, replay it, and that the kernels' launch
counts hold the replayed launches.

The graph's tests need an NVIDIA card (marker ``chip``; they skip
elsewhere): ``PYTHONPATH=src python3 -m pytest -q
tests/test_torch_decode_graph.py -m chip``.  They run a small Yi-shaped
decoder (2 layers, GQA 7:1, head dim 128) in bfloat16 through the port's
own kernels, and compare the graph with the same model's eager steps.
The CPU tests hold that nothing is captured off CUDA, how a model hands
its next cache the storage of its last, and the launch counts' sums.
"""
import dataclasses
import weakref

import pytest
import torch

from repro_torch import configs, tracing
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.launch import serve, steps
from repro_torch.models import transformer as T

N_STEPS = 20


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the graph captures CUDA kernels")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.clear()
    yield
    tracing.clear()


def _yi_small():
    return dataclasses.replace(
        configs.get("yi-34b"), n_layers=2, d_model=896, n_heads=7,
        n_kv_heads=1, head_dim=128, d_ff=1792, vocab_size=4096)


def _model(cfg, dev, seed=0):
    return T.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                  device=dev)


def _prompts(cfg, B, S, dev, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev)


def _prefilled(cfg, model, prompts, n_dec):
    B, S = prompts.shape
    cache = model.init_cache(B, S + n_dec)
    logits, cache = steps.make_prefill_step(cfg)(model, cache,
                                                {"tokens": prompts})
    return cache, torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def _eager_steps(model, cache, tok, n):
    """``n`` greedy steps through ``Model.decode_step`` alone."""
    logits, toks = [], []
    for _ in range(n):
        lg, cache = model.decode_step(tok[:, None], cache)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
        logits.append(lg)
        toks.append(tok)
    return logits, toks


def _counts():
    rows = tracing.summary()
    return {name: rows.get(name, {"count": 0})["count"]
            for name in ("step.decode", "decode.eager", "decode.capture",
                         "decode.replay")}


@pytest.mark.chip
def test_graph_steps_equal_the_eager_steps(card):
    """Over 20 steps: the same tokens and logits, bit for bit, as the
    eager steps on a second cache (the same kernels, replayed from the
    graph), and one eager step, one capture and 18 replays."""
    cfg = _yi_small()
    model = _model(cfg, card)
    prompts = _prompts(cfg, 4, 64, card)
    cache_g, tok_g = _prefilled(cfg, model, prompts, N_STEPS)
    cache_e, tok_e = _prefilled(cfg, model, prompts, N_STEPS)
    want_logits, want_toks = _eager_steps(model, cache_e, tok_e, N_STEPS)
    decode = steps.make_decode_step(cfg)
    got_logits, got_toks = [], []
    launched = decode_attention.launches
    with tracing.recording():
        for _ in range(N_STEPS):
            lg, tok_g, cache_g = decode(model, cache_g,
                                        {"tokens": tok_g[:, None]})
            got_logits.append(lg)
            got_toks.append(tok_g)
    # a launch a layer and step, the replays' included
    assert decode_attention.launches - launched == 2 * N_STEPS
    for i in range(N_STEPS):
        assert torch.equal(got_logits[i], want_logits[i]), i
        assert torch.equal(got_toks[i], want_toks[i]), i
    assert _counts() == {"step.decode": N_STEPS, "decode.eager": 1,
                         "decode.capture": 1,
                         "decode.replay": N_STEPS - 2}
    assert cache_g["t"] == cache_e["t"] == 64 + N_STEPS
    assert [c["pos"] for c in cache_g["layers"]] == [64 + N_STEPS] * 2
    for name in ("k", "v"):
        for a, b in zip(cache_g["layers"], cache_e["layers"]):
            assert torch.equal(a[name], b[name])


@pytest.mark.chip
def test_no_step_output_aliases_the_graph(card):
    """Every step returns tensors of its own: the tokens of 20 steps kept
    side by side hold their own addresses, and ``serve_batch``'s stacked
    tokens equal the eager steps' tokens column by column."""
    cfg = _yi_small()
    model = _model(cfg, card)
    prompts = _prompts(cfg, 4, 64, card, seed=5)
    cache, tok = _prefilled(cfg, model, prompts, N_STEPS)
    decode = steps.make_decode_step(cfg)
    kept = []
    for _ in range(N_STEPS):
        lg, tok, cache = decode(model, cache, {"tokens": tok[:, None]})
        kept.append((lg, tok))
    assert len({lg.data_ptr() for lg, _ in kept}) == N_STEPS
    assert len({t.data_ptr() for _, t in kept}) == N_STEPS

    got = serve.serve_batch(cfg, model, prompts, n_decode=N_STEPS,
                            device=card)
    cache_e, tok_e = _prefilled(cfg, model, prompts, N_STEPS)
    _, toks = _eager_steps(model, cache_e, tok_e, N_STEPS - 1)
    want = torch.stack([tok_e] + toks, dim=1)
    assert torch.equal(got, want)


@pytest.mark.chip
def test_a_new_cache_captures_anew_and_releases_the_old_graph(card):
    cfg = _yi_small()
    model = _model(cfg, card)
    prompts = _prompts(cfg, 4, 64, card)
    cache_a, tok_a = _prefilled(cfg, model, prompts, 8)
    cache_b, tok_b = _prefilled(cfg, model, prompts, 8)
    decode = steps.make_decode_step(cfg)
    with tracing.recording():
        for _ in range(3):
            _, tok_a, cache_a = decode(model, cache_a,
                                       {"tokens": tok_a[:, None]})
        first = weakref.ref(decode.graph.graph)
        _, tok_b, cache_b = decode(model, cache_b,
                                   {"tokens": tok_b[:, None]})
        # the same model and shape: captured at its first step
        assert first() is None and decode.graph.graph is not None
        for _ in range(2):
            _, tok_b, cache_b = decode(model, cache_b,
                                       {"tokens": tok_b[:, None]})
    assert decode.graph.graph is not None
    assert _counts() == {"step.decode": 6, "decode.eager": 1,
                         "decode.capture": 2, "decode.replay": 3}
    # both caches decoded the same prompts from the same position
    assert torch.equal(tok_a, tok_b)


@pytest.mark.chip
def test_later_batches_replay_the_graph_of_the_kept_storage(card):
    """A batch whose cache takes the storage of the last (gone) one starts
    with a replay and decodes the tokens and logits of eager steps on a
    cache of its own size, bit for bit; a longer batch grows the storage
    and is captured at its first step."""
    cfg = _yi_small()
    model = _model(cfg, card)
    decode = steps.make_decode_step(cfg)
    n = 6

    def batch(S, seed):
        prompts = _prompts(cfg, 4, S, card, seed=seed)
        cache, tok = _prefilled(cfg, model, prompts, n)
        k = cache["layers"][0]["k"]
        where = (k.data_ptr(), k.shape[1])
        got = []
        for _ in range(n):
            lg, tok, cache = decode(model, cache, {"tokens": tok[:, None]})
            got.append((lg, tok))
        cache_e, tok_e = _prefilled(cfg, model, prompts, n)   # its own
        assert cache_e["layers"][0]["k"].shape[1] == S + n
        want = _eager_steps(model, cache_e, tok_e, n)
        for i, ((lg, tok), w_lg, w_tok) in enumerate(zip(got, *want)):
            assert torch.equal(lg, w_lg) and torch.equal(tok, w_tok), i
        return where

    with tracing.recording():
        first = batch(64, 1)
        assert batch(40, 2) == first            # shorter: the same storage
        assert _counts()["decode.replay"] == 2 * n - 2
        assert batch(96, 3)[1] == 96 + n        # longer: grown
    assert _counts() == {"step.decode": 3 * n, "decode.eager": 1,
                         "decode.capture": 2, "decode.replay": 3 * n - 3}


def _moe_small():
    return dataclasses.replace(configs.smoke("moonshot-v1-16b-a3b"),
                               head_dim=64)


@pytest.mark.chip
@pytest.mark.parametrize("case", ["embeds", "positions", "moe", "xlstm"])
def test_other_inputs_and_layer_kinds_never_capture(card, case):
    """Embeddings in, positions from the caller, MoE layers and the xLSTM
    blocks keep the eager step at every step."""
    cfg = {"embeds": _yi_small, "positions": _yi_small, "moe": _moe_small,
           "xlstm": lambda: configs.smoke("xlstm-1.3b")}[case]()
    model = _model(cfg, card)
    B = 2
    cache = model.init_cache(B, 8)
    decode = steps.make_decode_step(cfg)
    tok = torch.zeros((B,), dtype=torch.int32, device=card)
    with tracing.recording():
        for i in range(4):
            batch = {"tokens": tok[:, None]}
            if case == "embeds":
                batch = {"embeds": model.embed[tok][:, None]}
            elif case == "positions":
                batch["positions"] = torch.full((B, 1), i, dtype=torch.int32,
                                                device=card)
            _, tok, cache = decode(model, cache, batch)
    assert _counts() == {"step.decode": 4, "decode.eager": 4,
                         "decode.capture": 0, "decode.replay": 0}
    assert decode.graph.graph is None and cache["t"] == 4


def test_make_decode_step_never_captures_off_cuda():
    cfg = configs.smoke("yi-34b")
    model = _model(cfg, torch.device("cpu"))
    prompts = _prompts(cfg, 2, 6, torch.device("cpu"))
    cache, tok = _prefilled(cfg, model, prompts, 5)
    decode = steps.make_decode_step(cfg)
    with tracing.recording():
        for _ in range(5):
            _, tok, cache = decode(model, cache, {"tokens": tok[:, None]})
    assert _counts() == {"step.decode": 5, "decode.eager": 5,
                         "decode.capture": 0, "decode.replay": 0}
    assert decode.graph.graph is None and decode.graph.key is None
    assert cache["t"] == 11


@pytest.fixture
def kept_on_cpu(monkeypatch):
    """CPU models that hand their caches' storage on as CUDA ones do."""
    keeps = T._keeps_storage
    monkeypatch.setattr(T, "_keeps_storage",
                        lambda dev, kinds: keeps(torch.device("cuda"), kinds))


def _local_and_global():
    """Attention layers alternating with windowed ones (a ring of 16)."""
    return dataclasses.replace(configs.smoke("recurrentgemma-2b"),
                               block_pattern=("attn", "local_attn"),
                               n_layers=2)


@pytest.mark.parametrize("make", [lambda: configs.smoke("llama3.2-1b"),
                                  _local_and_global],
                         ids=["attn", "attn+local_attn"])
def test_a_cache_takes_the_storage_of_the_last_once_it_is_gone(kept_on_cpu,
                                                              make):
    """Unwindowed layers keep longer storage and grow shorter storage; a
    windowed ring is kept at its size only; a cache still referenced gets
    storage of its own; kept storage comes back zeroed."""
    cfg = make()
    model = _model(cfg, torch.device("cpu"))

    def storage(cache):
        return [(c["k"].data_ptr(), c["k"].shape[1])
                for c in cache["layers"] if "k" in c]

    a = model.init_cache(2, 40)
    for c in a["layers"]:
        if "k" in c:
            c["k"].fill_(1.0)
    first = storage(a)
    held = model.init_cache(2, 40)               # a is alive: its own
    assert all(p != q for (p, _), (q, _) in zip(storage(held), first))
    del a, held
    b = model.init_cache(2, 24)
    got = storage(b)
    for kind, (p, n), (q, m), c in zip(
            [k for k in model.kinds if k != "rglru"], got, first,
            [c for c in b["layers"] if "k" in c]):
        if kind == "local_attn":                 # 16 slots both times
            assert (p, n) == (q, m) == (q, cfg.window)
        else:                                    # 40 slots kept for 24
            assert (p, n) == (q, 40)
        assert not c["k"].any() and c["pos"] == 0
    assert b["t"] == 0
    del b
    c = model.init_cache(3, 24)                  # another batch size
    assert all(n == (cfg.window if m == cfg.window else 24)
               for (_, n), (_, m) in zip(storage(c), first))
    del c
    d = model.init_cache(3, 64)                  # longer: grown
    assert [n for _, n in storage(d)] == [
        cfg.window if k == "local_attn" else 64
        for k in model.kinds if k != "rglru"]


@pytest.mark.parametrize("arch,kept", [
    ("llama3.2-1b", False),            # on the CPU
    ("recurrentgemma-2b", True),       # RG-LRU layers decode eagerly
    ("moonshot-v1-16b-a3b", True),     # so do MoE layers
])
def test_caches_that_no_graph_replays_keep_no_storage(monkeypatch, arch,
                                                      kept):
    if kept:
        keeps = T._keeps_storage
        monkeypatch.setattr(
            T, "_keeps_storage",
            lambda dev, kinds: keeps(torch.device("cuda"), kinds))
    cfg = configs.smoke(arch)
    model = _model(cfg, torch.device("cpu"))
    a = model.init_cache(2, 8)
    del a
    assert model._kept == {} and model._lent is None
    b = model.init_cache(2, 4)
    assert all(c["k"].shape[1] == 4 for c in b["layers"] if "k" in c)


def test_a_replay_counts_the_launches_its_capture_made():
    """``launches_since`` is what the counted wrappers launched, by kernel
    too; ``count_launches`` adds it once a replay."""
    saved = {fn: (fn.launches, dict(getattr(fn, "launches_by_kernel", {})))
             for fn in ops.COUNTED}
    try:
        before = ops.launch_counts()
        decode_attention.launches += 3
        rec = ops.COUNTED[2]
        rec.launches += 2
        rec.launches_by_kernel["loop"] += 2
        grew = ops.launches_since(before)
        assert grew[decode_attention] == (3, {})
        assert grew[rec] == (2, {"loop": 2, "chunked": 0})
        ops.count_launches(grew)
        ops.count_launches(grew)
        assert decode_attention.launches == before[decode_attention][0] + 9
        assert rec.launches_by_kernel["loop"] == \
            before[rec][1]["loop"] + 6
    finally:
        for fn, (n, by) in saved.items():
            fn.launches = n
            if by:
                fn.launches_by_kernel = by
