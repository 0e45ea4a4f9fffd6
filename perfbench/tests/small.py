"""Small copies of the cells' configurations and mixes, for the CPU tests:
every width cut, the structure (GQA, RoPE, SwiGLU, an untied head) kept.
A run of a small copy goes through the harness's one path: only the
contents of the cell's files are replaced (``cell.inputs``)."""
import contextlib
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

_DENSE = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=8,
              num_key_value_heads=2, intermediate_size=128, vocab_size=96)
CONFIG = {"yi-34b": _DENSE, "yi-34b-4l": _DENSE}
TRAFFIC = {
    "pretrain-4k": dict(batch=4, seq_len=24, reference_rows=2, trace_steps=1),
    "code-completion": dict(batch=3, batches=4, block=2,
                            prompt=dict(median=12, sigma=0.5, min=4, max=20),
                            answer=dict(median=3, sigma=0.6, min=1, max=6),
                            check_requests=3),
}
CELLS = {"yi-34b-4l.pretrain-4k": ("yi-34b-4l", "pretrain-4k"),
         "yi-34b.code-completion": ("yi-34b", "code-completion")}
# The small copies' own limits: on seed 7 their sound bf16 runs read loss
# and gradient gaps of a few 1e-3 and a token gap under 0.2; the planted
# faults read 0.05 (change) to several logits (token gap) or more.
LIMITS = {"yi-34b-4l.pretrain-4k": {"grad_norm_gap": 0.05,
                                    "change_norm_gap": 0.02},
          "yi-34b.code-completion": {"token_gap": 0.4}}


def config(name: str) -> dict:
    """The configuration at its small size.  Its weights are drawn wider
    (std 0.2) so that the few logits of a small vocabulary spread as a
    full-size model's do and a wrong token shows in the token gap."""
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return {**c, **CONFIG[name], "initializer_range": 0.2}


def traffic(name: str) -> dict:
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    return {**t, **TRAFFIC[name]}


@contextlib.contextmanager
def files(workload: str):
    """The cell's files read as their small copies."""
    from perfbench.harness import cell
    conf, mix = CELLS[workload]
    small = (config(conf), traffic(mix),
             {k: {"limit": v} for k, v in LIMITS[workload].items()})
    old = cell.inputs
    cell.inputs = lambda f: small
    try:
        yield
    finally:
        cell.inputs = old


def run_small(workload: str, seed: int = 7):
    """The cell at its small size on the CPU, through the harness's whole
    run but the look for a card.  Returns (Run, result)."""
    from perfbench.harness import cell
    with files(workload):
        return cell.run(workload, seed, 0.0, False, device="cpu")
