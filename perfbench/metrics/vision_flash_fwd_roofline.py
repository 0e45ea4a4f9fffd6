"""vision_flash_fwd_roofline: the D-80 flash forward's least time over its
device time in the traced train steps.  Each tower block calls it twice a
step (the forward and remat's recomputation), with LSE, over the step's
packed patches cut into its images, no causal mask; the bound is
``yardstick.flash_fwd_segments_bound_s`` of the traced steps' patch counts
(``image_rows.grids`` of steps ``checked_steps + steps`` onward, as the
train loop traces them); the time sums the device events of the forward
kernel's D-80 instance alone (``csrc/flash_attention.cu``), matched by
its name."""
from perfbench.generators import image_rows
from perfbench.harness.yardstick import flash_fwd_segments_bound_s

KERNEL = r"\bflash_wgmma_kernel<80,"


def read(r):
    if r.traced is None or "steps" not in r.host:
        return None
    seconds, count = r.traced.kernel_time(KERNEL)
    if not count:
        return None
    dm, t = r.dims, r.traffic
    first = t["checked_steps"] + r.host["steps"]
    bound = sum(
        2 * dm.v_layers * flash_fwd_segments_bound_s(
            [a * b * c for a, b, c in image_rows.grids(t, r.seed, i)],
            dm.v_heads, dm.v_heads, dm.v_head_dim, causal=False, lse=True)
        for i in range(first, first + r.work["steps"]))
    return 100.0 * bound / seconds
