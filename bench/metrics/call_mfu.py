"""call_mfu: the whole call's share of the chip's peak: the least time of
all the work of the traced calls (each part of the entry's ``PARTS``,
counted by ``reference/work.py``; bytes over the bandwidth or float32
operations over the peak, whichever is larger) over the traced window's
length, in %."""
from bench.reference.work import least_s


def read(rec):
    tr = rec["trace"]
    if tr is None or rec["peak"] is None or tr["window_s"] <= 0:
        return None
    parts = [rec["work"][p] for p in rec["parts"] if p in rec["work"]]
    if len(parts) != len(rec["parts"]):
        return None
    nbytes = sum(b for b, _ in parts)
    flops = sum(f for _, f in parts)
    return 100.0 * least_s(nbytes, flops, rec["peak"])[0] / tr["window_s"]
