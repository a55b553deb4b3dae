"""draws_ms: device time a call of the program's span ``sampler.draws``
(CUDA events around ``rng.tail_draws`` in ``local_gumbel_max``: the Philox
Gumbel, Poisson, uniform-integer and height draws), the mean over the
traced calls; nothing where the program has no such span."""
from bench.program import stage_ms


def read(rec):
    return stage_ms(rec, "sampler.draws")
