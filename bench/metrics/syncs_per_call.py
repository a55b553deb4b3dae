"""syncs_per_call: host-device synchronizations the program made inside its
own spans (PyTorch's sync reporting, counted by the program's profiler
session and charged to the innermost span), the mean over the traced
calls; nothing where the program counted none (no session, or the
CPU)."""
from bench.program import of


def read(rec):
    prog = of(rec)
    if not prog["syncs_counted"]:
        return None
    return sum(sum((s["syncs"] or {}).values()) for c in prog["calls"]
               for s in c) / len(prog["calls"])
