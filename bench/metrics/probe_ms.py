"""probe_ms: device time a call of the benchmark's span ``probe`` (CUDA
events around the benchmark's call into the layer), the mean over the
traced calls; nothing where the cell's entry has no such span."""


def read(rec):
    ms = rec["layer_ms"].get("probe")
    return sum(ms) / len(ms) if ms else None
