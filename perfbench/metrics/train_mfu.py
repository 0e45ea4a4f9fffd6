"""train_mfu: the model FLOPs of the window's train steps over the
window's seconds at the bf16 peak (``yardstick.train_step_flops``: 6 N a
token and 12 D a causal pair, each head and layer; remat not counted)."""
from perfbench.harness.yardstick import PEAK_FLOPS


def read(r):
    h = r.host
    if not h.get("steps"):
        return None
    return 100.0 * h["flops"] / (h["window_s"] * PEAK_FLOPS)
