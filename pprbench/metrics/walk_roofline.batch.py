"""walk_roofline.batch: the raw walk phase's fused kernel (K6+K4,
``raw_walk_kernel``) as a percentage of its roofline over the traced
stretch: the least time of the bytes the walks demanded in the stretch's
level records need (``pprbench/roofline.py``) at the published
bandwidth, over the kernel's device time in the trace."""

from pprbench import roofline


def read(run):
    if run.trace is None or not run.traced_records:
        return None
    return roofline.share(roofline.walk_bytes(run.traced_records, run.alpha),
                          run.trace.kernel_s.get("raw_walk_kernel", 0.0),
                          run.device_name)
