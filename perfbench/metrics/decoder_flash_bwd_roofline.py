"""decoder_flash_bwd_roofline: the decoder's flash backward's least time
over its device time in the traced train steps of an image cell, where the
tower's D-80 instances run beside it: one call a decoder layer a step,
causal over the cell's B rows of S, bound by ``yardstick.flash_bwd_bound_s``
(10 D a causal pair); the time sums the D-128 instances of the dq and
dk / dv kernels (``csrc/flash_attention_bwd.cu``), matched by their
names."""
from perfbench.harness.yardstick import flash_bwd_bound_s

KERNEL = r"\bdq_wgmma_kernel<128\b|\bdkdv_wgmma_kernel<128\b"


def read(r):
    if r.traced is None:
        return None
    seconds, count = r.traced.kernel_time(KERNEL)
    if not count:
        return None
    dm, w = r.dims, r.work
    calls = dm.attention_layers * w["steps"]
    bound = calls * flash_bwd_bound_s(w["B"], w["S"], dm.heads, dm.kv_heads,
                                      dm.head_dim)
    return 100.0 * bound / seconds
