"""pool_select_ms: device time a call of the program's span
``index.select`` (CUDA events in ``IVFIndex.topk_batch``: the stable sort
of each query's pool and the id gather), the mean over the traced calls;
nothing where the program has no such span."""
from bench.program import stage_ms


def read(rec):
    return stage_ms(rec, "index.select")
