"""decoder_flash_fwd_roofline: the decoder's flash forward's least time
over its device time in the traced train steps of an image cell, where the
tower's D-80 instance runs beside it.  Each decoder layer calls it twice a
step (the forward and remat's recomputation), with LSE, causal over the
cell's B rows of S; the bound is ``yardstick.flash_fwd_bound_s``; the time
sums the device events of the forward kernel's D-128 instance alone
(``csrc/flash_attention.cu``), matched by its name."""
from perfbench.harness.yardstick import flash_fwd_bound_s

KERNEL = r"\bflash_wgmma_kernel<128\b"


def read(r):
    if r.traced is None:
        return None
    seconds, count = r.traced.kernel_time(KERNEL)
    if not count:
        return None
    dm, w = r.dims, r.work
    calls = 2 * dm.attention_layers * w["steps"]
    bound = calls * flash_fwd_bound_s(w["B"], w["S"], dm.heads, dm.kv_heads,
                                      dm.head_dim, lse=True)
    return 100.0 * bound / seconds
