"""sampler_ms: device time a call of the benchmark's span ``sampler`` (CUDA
events around the benchmark's call into the layer), the mean over the
traced calls; nothing where the cell's entry has no such span."""


def read(rec):
    ms = rec["layer_ms"].get("sampler")
    return sum(ms) / len(ms) if ms else None
