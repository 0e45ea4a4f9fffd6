"""serve_mfu: the model FLOPs of every batch completed in the window,
prefill and decode steps, over the window's seconds at the bf16 peak (the
whole serving step's share, beside the kernels' rooflines)."""
from perfbench.harness.yardstick import PEAK_FLOPS


def read(r):
    h = r.host
    if not h.get("batches"):
        return None
    return 100.0 * h["flops"] / (h["window_s"] * PEAK_FLOPS)
