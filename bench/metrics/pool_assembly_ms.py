"""pool_assembly_ms: device time a call of the program's spans
``index.pool`` (CUDA events in ``IVFIndex``: the ``cat`` of member and
overflow scores and ids, the dead-slot ``where``, the padding), the mean
over the traced calls; nothing where the program has no such span."""
from bench.program import stage_ms


def read(rec):
    return stage_ms(rec, "index.pool")
