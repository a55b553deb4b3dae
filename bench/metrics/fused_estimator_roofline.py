"""fused_estimator_roofline: the least time of the kernel's work in the traced
calls (the larger of its bytes over the card's bandwidth and its
operations over its float32 peak, counted from the inputs by
``reference/work.py``) over the kernel's device time in the trace, in %.
Nothing where the trace or the work is missing."""
from bench.reference.work import least_s


def read(rec):
    work = rec["work"].get("fused_estimator")
    tr = rec["trace"]
    if not work or tr is None or rec["peak"] is None:
        return None
    t = tr["kernel_s"].get("fused_estimator")
    if not t:
        return None
    return 100.0 * least_s(*work, rec["peak"])[0] / t
