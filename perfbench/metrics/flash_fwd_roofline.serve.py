"""flash_fwd_roofline.serve: the flash forward's least time over its device
time in the traced batches' prefills: one call a layer a batch, no LSE, at
each batch's prompt length (``yardstick.flash_fwd_bound_s``); the time
sums the forward kernel's device events (``csrc/flash_attention.cu``)."""
from perfbench.harness.yardstick import flash_fwd_bound_s

KERNEL = r"\bflash_wgmma_kernel|\bflash_f32_kernel"


def read(r):
    if r.traced is None:
        return None
    seconds, count = r.traced.kernel_time(KERNEL)
    if not count:
        return None
    dm, w = r.dims, r.work
    bound = dm.attention_layers * sum(
        flash_fwd_bound_s(w["B"], S, dm.heads, dm.kv_heads, dm.head_dim)
        for S, _ in w["batches"])
    return 100.0 * bound / seconds
