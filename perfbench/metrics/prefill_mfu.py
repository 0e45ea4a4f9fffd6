"""prefill_mfu: the window's prefill model FLOPs over the prefills' wall
seconds (each from handing the batch over to its first token on the host)
at the bf16 peak (``yardstick.prefill_flops``: 2 N a token through the
layers, 4 D a causal pair, each head and layer, the last position's
unembedding)."""
from perfbench.harness.yardstick import PEAK_FLOPS


def read(r):
    h = r.host
    if not h.get("batches"):
        return None
    return 100.0 * h["prefill_flops"] / (h["prefill_s"] * PEAK_FLOPS)
