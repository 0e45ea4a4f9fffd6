"""Step builders: the train step (loss, gradients, AdamW), prefill and
greedy decode.

Counterpart of ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` in ``repro.launch.steps``.  A step takes the model
where JAX's takes its params: ``train_step(model, opt_state, batch)``
updates the model's parameters and the optimizer state in place and
returns them with the metrics; the serving steps update the cache in place
and return it.  The abstract specs and shardings of ``repro.launch.steps``
are XLA's and have no counterpart.
"""
from __future__ import annotations

import weakref

import torch

from .. import sharding, tracing
from ..kernels import ops
from ..models import transformer as T
from ..optim import adamw_update, cosine_schedule


def value_and_grad(model, batch):
    """``lm_loss`` of ``batch``, its aux terms, and the gradient of every
    parameter in ``model.parameters()`` order.  A parameter the loss does
    not read (musicgen's untied embedding table under an embeds batch)
    gets zeros, as ``jax.value_and_grad`` gives it."""
    params = list(model.parameters())
    with tracing.span("step.forward", device=model.device):
        loss, aux = T.lm_loss(model, batch)
    # remat's recomputation of each layer runs inside the backward
    with tracing.span("step.backward", device=model.device):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def _average_over_ranks(group, loss, aux, grads):
    """The loss, the aux terms and the gradients summed over the ranks of
    ``group`` and divided by its size, through one flat float32 buffer and
    one ``all_reduce`` a step."""
    world = torch.distributed.get_world_size(group)
    keys = list(aux)
    scalars = [loss, *(aux[k] for k in keys)]
    flat = torch.cat([torch.stack(scalars).float()]
                     + [g.reshape(-1).float() for g in grads])
    sharding.all_reduce_sum_(flat, group).div_(world)
    parts = flat.split([len(scalars)] + [g.numel() for g in grads])
    out = [p.view(g.shape) for p, g in zip(parts[1:], grads)]
    return parts[0][0], dict(zip(keys, parts[0][1:])), out


def make_train_step(cfg, tc, group=None):
    """The train step of ``tc`` (a ``TrainConfig``): ``lm_loss`` and its
    gradients, over ``tc.grad_accum`` microbatches (consecutive slices of
    the batch axis, which is axis 1 of (3, B, S) M-RoPE positions;
    gradients summed in float32 and divided by their count, the losses
    averaged), then the cosine learning rate and AdamW.

    Data parallelism, the counterpart of ``repro``'s gradient anchoring on
    its batch axes: with a ``torch.distributed`` ``group`` of W > 1 ranks,
    each rank's ``batch`` is its slice of the global batch; after its own
    gradients (accumulated, when ``grad_accum > 1``) the float32 gradients,
    the loss and the aux terms are summed over the ranks and divided by W,
    so that AdamW, the clip and ``grad_norm`` see the same values on every
    rank.  At W = 2 a step equals one process's step on the global batch
    with ``grad_accum = 2`` bit for bit (a + b rounds alike in either
    order); at larger W the sums' order differs.  Routing capacity and
    ``moe.aux_load_balance_loss`` are computed per rank's slice, so a MoE
    arch under data parallelism matches ``grad_accum = W``, not one
    process on the global batch."""
    accum = max(int(tc.grad_accum), 1)
    world = 1 if group is None else torch.distributed.get_world_size(group)

    def microbatch(batch, i, mb):
        def cut(k, v):
            if k == "positions" and v.ndim == 3:
                return v[:, i * mb:(i + 1) * mb]
            return v[i * mb:(i + 1) * mb]
        return {k: cut(k, v) for k, v in batch.items()}

    def update(model, opt_state, batch):
        names = [n for n, _ in model.named_parameters()]
        if accum == 1:
            loss, aux, grads = value_and_grad(model, batch)
        else:
            B = batch["labels"].shape[0]
            if batch.get("pixels") is not None:
                raise ValueError("microbatches of image rows are not cut: "
                                 "pixels and grids run in one microbatch")
            if B % accum:
                raise ValueError(f"batch {B} does not split into "
                                 f"{accum} microbatches")
            mb = B // accum
            # summed and divided in place (the same roundings as a + g and
            # a / accum), each microbatch's gradients dropped once summed:
            # no second float32 copy of the parameters' size is held
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in model.parameters()]
            losses, auxes = [], []
            for i in range(accum):
                loss_i, aux_i, g = value_and_grad(model,
                                                  microbatch(batch, i, mb))
                for a, gi in zip(acc, g):
                    a.add_(gi.float())
                del g
                losses.append(loss_i)
                auxes.append(aux_i)
            grads = [a.div_(accum) for a in acc]
            loss = torch.stack(losses).mean()
            aux = {k: torch.stack([a[k] for a in auxes]).mean()
                   for k in auxes[0]}
        if world > 1:
            loss, aux, grads = _average_over_ranks(group, loss, aux, grads)
        with tracing.span("step.optimizer", device=model.device):
            lr = cosine_schedule(opt_state.step, base_lr=tc.learning_rate,
                                 warmup_steps=tc.warmup_steps,
                                 total_steps=tc.total_steps)
            _, opt_state, om = adamw_update(
                dict(zip(names, grads)), opt_state,
                dict(model.named_parameters()), learning_rate=lr,
                beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
        return model, opt_state, {"loss": loss, **aux, **om}

    def train_step(model, opt_state, batch):
        with tracing.span("step.train", device=model.device,
                          tokens=batch["labels"].numel(), unit=True):
            return update(model, opt_state, batch)

    return train_step


def _positions(batch) -> int:
    """The (B, S) positions a serving batch feeds, tokens or embeds."""
    x = batch.get("tokens")
    return x.numel() if x is not None else batch["embeds"].shape[:2].numel()


# what image serving lacks, named where a batch with pixels is refused
NO_IMAGE_SERVING = ("serving images is not ported: the prefill does not run "
                    "the vision tower, splice its merged cells into the "
                    "cache or carry the image's M-RoPE positions on into "
                    "decode; serve text prompts, or train on image rows")


def make_prefill_step(cfg):
    def prefill(model, cache, batch):
        if batch.get("pixels") is not None:
            raise ValueError(NO_IMAGE_SERVING)
        # a batch's prefill opens its unit, which its decode steps join
        with tracing.span("step.prefill", device=model.device,
                          tokens=_positions(batch), unit=True):
            return model.prefill_step(batch.get("tokens"), cache,
                                      embeds=batch.get("embeds"),
                                      positions=batch.get("positions"))

    return prefill


def _capturable(model, batch) -> bool:
    """Whether the decode step of ``batch`` may be captured: on CUDA, from
    tokens at the default positions, through capturable layers only."""
    return (model.device.type == "cuda" and batch.get("embeds") is None
            and batch.get("tokens") is not None
            and batch.get("positions") is None
            and set(model.kinds) <= T.CAPTURABLE)


def _decode(model, cache, batch, t=None):
    logits, _ = model.decode_step(
        batch.get("tokens"), cache, embeds=batch.get("embeds"),
        positions=batch.get("positions"), t=t)
    # greedy next token inside the step, as repro keeps it in-graph
    return logits, torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


class DecodeGraph:
    """The decode step of one cache storage as one CUDA graph.

    Keyed on the model, its config and the cache's storage (its tensors'
    addresses and shapes) and the tokens' shape.  A new key releases the
    previous graph and its memory pool.  For a new model or tokens' shape
    the first step runs eagerly on the capture stream (which builds what
    is made lazily, such as cuBLAS's workspace for that stream and the
    decode kernel's counters, outside the capture) and the second is
    captured and replayed; a new storage alone is captured at its first
    step.  Later steps copy the tokens and the position into the graph's
    inputs and replay it.  A model hands its next cache the storage of its
    last one (``Model.init_cache`` on CUDA), so the batches of one model
    replay one graph until a longer batch grows the storage.  The host's position
    counts advance as the eager forward advances them, and the kernel
    wrappers' launch counts by what the capture launched.  Each step
    returns fresh tensors: a caller keeps every step's token.  The graph
    holds the weights' addresses: a model's parameters are not replaced
    while it decodes."""

    def __init__(self):
        self.key = self.graph = self.stream = None
        self.tokens = self.t = self.logits = self.next = None
        self.launched = None

    def release(self):
        self.key = self.graph = None
        self.tokens = self.t = self.logits = self.next = None
        self.launched = None

    def step(self, model, cache, tokens):
        key = (weakref.ref(model), id(model.cfg), tokens.shape, tokens.dtype,
               tuple((c["k"].data_ptr(), c["v"].data_ptr(), c["k"].shape)
                     for c in cache["layers"]))
        if key != self.key:
            # a new storage of the same model and tokens' shape is
            # captured at once; a new model or shape first runs eagerly
            warm = self.key is not None and key[:4] == self.key[:4]
            self.release()
            self.key = key
            if not warm:
                with tracing.span("decode.eager"):
                    return self._eager(model, cache, tokens)
        if self.graph is None:
            with tracing.span("decode.capture"):
                self._capture(model, cache, tokens)
                self.graph.replay()
        else:
            with tracing.span("decode.replay"):
                self.tokens.copy_(tokens)
                self.t.fill_(cache["t"])
                self.graph.replay()
                ops.count_launches(self.launched)
                for c in cache["layers"]:
                    c["pos"] += 1
                cache["t"] += 1
        return self.logits.clone(), self.next.clone()

    def _eager(self, model, cache, tokens):
        dev = model.device
        main = torch.cuda.current_stream(dev)
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = _decode(model, cache, {"tokens": tokens})
        main.wait_stream(self.stream)
        for x in out:
            x.record_stream(main)
        return out

    def _capture(self, model, cache, tokens):
        self.tokens = tokens.clone()
        # the position's scalar, filled from the host's count before each
        # replay (one fill, no sync)
        self.t = torch.full((), cache["t"], dtype=torch.int32,
                            device=model.device)
        self.graph = torch.cuda.CUDAGraph()
        # the capture advances the host's counts once, for this step (the
        # replay that follows it makes the launches it counted)
        before = ops.launch_counts()
        with torch.cuda.graph(self.graph, stream=self.stream):
            self.logits, self.next = _decode(model, cache,
                                             {"tokens": self.tokens}, self.t)
        self.launched = ops.launches_since(before)


def make_decode_step(cfg):
    """The greedy decode step: ``decode(model, cache, batch)`` returns the
    logits, the next token and the cache.  Where ``_capturable`` holds, a
    ``DecodeGraph`` (``decode.graph``; one live graph a step function)
    replays it; elsewhere every step runs eagerly.  The child spans
    ``decode.eager``, ``decode.capture`` and ``decode.replay`` of
    ``step.decode`` count which."""
    graph = DecodeGraph()

    def decode(model, cache, batch):
        # the host's issue of the step: nothing in it waits for the card
        with tracing.span("step.decode", device=model.device,
                          tokens=_positions(batch)):
            if _capturable(model, batch):
                logits, next_tok = graph.step(model, cache, batch["tokens"])
            else:
                with tracing.span("decode.eager"):
                    logits, next_tok = _decode(model, cache, batch)
        return logits, next_tok, cache

    decode.graph = graph
    return decode
