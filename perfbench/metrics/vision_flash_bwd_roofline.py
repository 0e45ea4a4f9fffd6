"""vision_flash_bwd_roofline: the D-80 flash backward's least time over
its device time in the traced train steps: one call a tower block a step
over the step's packed patches cut into its images, no causal mask,
bound by ``yardstick.flash_bwd_segments_bound_s`` (10 D a visible pair)
of the traced steps' patch counts (``image_rows.grids``, as
``vision_flash_fwd_roofline`` takes them); the time sums the D-80
instances of the dq and dk / dv kernels (``csrc/flash_attention_bwd.cu``),
matched by their names."""
from perfbench.generators import image_rows
from perfbench.harness.yardstick import flash_bwd_segments_bound_s

KERNEL = r"\bdq_wgmma_kernel<80,|\bdkdv_wgmma_kernel<80,"


def read(r):
    if r.traced is None or "steps" not in r.host:
        return None
    seconds, count = r.traced.kernel_time(KERNEL)
    if not count:
        return None
    dm, t = r.dims, r.traffic
    first = t["checked_steps"] + r.host["steps"]
    bound = sum(
        dm.v_layers * flash_bwd_segments_bound_s(
            [a * b * c for a, b, c in image_rows.grids(t, r.seed, i)],
            dm.v_heads, dm.v_heads, dm.v_head_dim, causal=False)
        for i in range(first, first + r.work["steps"]))
    return 100.0 * bound / seconds
