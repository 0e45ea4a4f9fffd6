"""Batched server: prefill + greedy decode with preemption-aware
placement.

Counterpart of ``repro.launch.serve``.  Serving on preemptible pods uses
the paper's scheduling policy: each request batch is a job of estimated
length, and ``PreemptionSource.reuse_decision`` decides before admitting
it whether to keep the current pod or rotate to a fresh reservation
(Fig. 6 economics at pod granularity).  The driver feeds token prompts, so
it refuses the ``embeds_input`` archs (musicgen-medium, qwen2-vl-2b), as
``repro``'s does; serve those through ``launch/steps.py``'s prefill and
decode steps with ``embeds=``.

Run (any token-input arch: recurrentgemma-2b, llama3.2-1b, smollm-135m,
yi-34b, deepseek-coder-33b, and the MoE archs moonshot-v1-16b-a3b and
phi3.5-moe-42b-a6.6b):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..core import distributions
from ..device import resolve_device
from ..fault import PreemptionSource
from ..models import transformer as T
from . import steps

EST_JOB_HOURS = 0.05


def serve_batch(cfg, model, prompts, n_decode: int = 16, device="cuda"):
    """Greedy-decode ``n_decode`` tokens for a (B, S) batch of token
    prompts on ``device`` (where ``model`` must live).  Returns (B,
    n_decode) int32 tokens: the prefill's next token, then one per decode
    step."""
    dev = resolve_device(device)
    if model.device.type != dev.type or dev.index not in (
            None, model.device.index):
        raise ValueError(f"the model is on {model.device}, not {dev}")
    prompts = torch.as_tensor(prompts, device=dev)
    B, S = prompts.shape
    cache = model.init_cache(B, S + n_decode)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    logits, cache = prefill(model, cache, {"tokens": prompts})
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(n_decode - 1):
        logits, tok, cache = decode(model, cache, {"tokens": tok[:, None]})
        out.append(tok)
    return torch.stack(out, dim=1)


def serve(cfg, model, *, batches: int, batch_size: int, prompt_len: int,
          n_decode: int, device="cuda", seed: int = 0,
          start_hours: float = 0.0):
    """Serve ``batches`` batches of random prompts (numpy ``seed``), each
    admitted by the paper's reuse policy on one simulated pod, which has
    run ``start_hours`` simulated hours when the first batch arrives (near
    the 24 h deadline the policy rotates it).  Returns one record per
    batch: its tokens, wall seconds, whether the pod was rotated before
    it, and the pod's age after it."""
    dev = resolve_device(device)
    src = PreemptionSource(distributions.constrained_for(), n_pods=1, seed=3,
                           device=dev)
    rng = np.random.default_rng(seed)
    sim_now, records = float(start_hours), []
    for _ in range(batches):
        rotated = not src.reuse_decision(0, EST_JOB_HOURS, sim_now)
        if rotated:
            src.replace_pod(0, sim_now)
        prompts = rng.integers(0, cfg.vocab_size, (batch_size, prompt_len))
        t0 = time.perf_counter()
        toks = serve_batch(cfg, model, prompts, n_decode=n_decode, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        sim_now += EST_JOB_HOURS
        records.append({"tokens": toks, "seconds": seconds,
                        "rotated": rotated,
                        "pod_age": src.pod_age(0, sim_now)})
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b",
                    choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    if cfg.embeds_input:
        raise SystemExit("serve driver feeds tokens; pick a token-input arch")
    dev = resolve_device(args.device)
    model = T.init(cfg, torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    records = serve(cfg, model, batches=args.batches,
                    batch_size=args.batch_size, prompt_len=args.prompt_len,
                    n_decode=args.decode, device=dev)
    for i, r in enumerate(records):
        print(f"batch {i}: {tuple(r['tokens'].shape)} tokens in "
              f"{r['seconds']:.2f}s (pod age {r['pod_age']:.2f}h)")
    print(f"served {len(records)} batches, "
          f"{sum(r['rotated'] for r in records)} pod rotations")


if __name__ == "__main__":
    main()
