"""flash_fwd_roofline.train: the flash forward's least time over its device
time in the traced train steps.  Each layer calls it twice a step (the
forward and remat's recomputation), with LSE, at the cell's shapes; the
bound is ``yardstick.flash_fwd_bound_s``; the time sums the device events
of the forward kernel (``csrc/flash_attention.cu``)."""
from perfbench.harness.yardstick import flash_fwd_bound_s

KERNEL = r"\bflash_wgmma_kernel|\bflash_f32_kernel"


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
