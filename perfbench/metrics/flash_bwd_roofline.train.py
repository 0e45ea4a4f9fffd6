"""flash_bwd_roofline.train: the flash backward's least time over its
device time in the traced train steps: one call a layer a step at the
cell's shapes, bound by ``yardstick.flash_bwd_bound_s`` (10 D a causal
pair); the time sums the dq and dk / dv kernels'
(``csrc/flash_attention_bwd.cu``)."""
from perfbench.harness.yardstick import flash_bwd_bound_s

KERNEL = r"\bdq_wgmma_kernel|\bdkdv_wgmma_kernel|\bdq_kernel|\bdkdv_kernel"


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
