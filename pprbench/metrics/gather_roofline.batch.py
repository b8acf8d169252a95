"""gather_roofline.batch: the push's gather (K1) and the index SpMV (K2),
both ``gather_tasks_kernel``, as a percentage of their roofline over the
traced stretch: the least time of the bytes the stretch's level records
need (``pprbench/roofline.py``) at the published bandwidth, over the
kernel's device time in the trace."""

from pprbench import roofline


def read(run):
    if run.trace is None or not run.traced_records:
        return None
    nbytes = roofline.gather_bytes(run.traced_records, run.n, run.n_out,
                                   run.m_in, run.index_edges, run.depth_of)
    return roofline.share(nbytes,
                          run.trace.kernel_s.get("gather_tasks_kernel", 0.0),
                          run.device_name)
