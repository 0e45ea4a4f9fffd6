"""The numbers that decide ``correct``, each computed from the program's
outputs and the reference's; a cell's limits file names those it
compares, and a run prints the others as readings.

Training: each checked step's loss; each leaf's gradient norm at the first
step, before clipping; each leaf's change over the checked steps.  A norm
is judged by the worst leaf: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's (nought to rounding, such as an embedding
table that embeddings bypass) move by weight decay alone and are left out
of the change.  Serving: the widest gap by which a served token's
reference logit lies below the reference's best at its position.
"""
from __future__ import annotations

import statistics

QUIET_GRADIENT = 1e-3       # of the median leaf's gradient norm


def _worst_leaf(prog: dict, ref: dict, names) -> tuple[float, str]:
    """The worst leaf's gap and its name."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    return max((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n)
               for n in names)


def train_numbers(prog: dict, ref: dict, worst: dict | None = None) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "grad_norms": {leaf: x},
    "change_norms": {leaf: x}}.  ``worst``, if given, receives the name
    of the leaf that set each norm's gap."""
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"],
                                              strict=True))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moving = [n for n in g if g[n] >= QUIET_GRADIENT * med]
    grad, grad_leaf = _worst_leaf(prog["grad_norms"], g, g)
    change, change_leaf = _worst_leaf(prog["change_norms"],
                                      ref["change_norms"], moving)
    if worst is not None:
        worst.update(grad_norm_gap=grad_leaf, change_norm_gap=change_leaf)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad,
            "change_norm_gap": change}


def token_gaps(ref_logits, tokens) -> list[float]:
    """The gap at each position between the reference's best logit and its
    logit of the served token; ``ref_logits`` (n, vocab) float32,
    ``tokens`` the n tokens served at those positions."""
    import torch
    idx = torch.as_tensor(tokens, device=ref_logits.device).long()[:, None]
    gaps = ref_logits.max(dim=-1).values - ref_logits.gather(1, idx)[:, 0]
    return gaps.tolist()


def token_gap(ref_logits, tokens) -> float:
    """Widest gap, over positions, between the reference's best logit and
    its logit of the served token; ``ref_logits`` (n, vocab) float32,
    ``tokens`` the n tokens served at those positions."""
    return max(token_gaps(ref_logits, tokens))
