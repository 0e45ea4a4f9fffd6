"""decode_attn_roofline: the decode kernel's least time over its device
time in the traced batches' decode steps: one call a layer a step, each
over the cache's length at that step (``yardstick.decode_attn_bound_s``,
bound by its bytes); the time sums ``csrc/decode_attention.cu``'s kernel's
device events."""
from perfbench.harness.yardstick import decode_attn_bound_s

KERNEL = r"\bdecode_kernel"


def read(r):
    if r.traced is None:
        return None
    seconds, count = r.traced.kernel_time(KERNEL)
    if not count:
        return None
    dm, w = r.dims, r.work
    bound = dm.attention_layers * sum(
        decode_attn_bound_s(w["B"], dm.heads, dm.kv_heads, dm.head_dim,
                            S + j + 1)
        for S, steps in w["batches"] for j in range(steps - 1))
    return 100.0 * bound / seconds
