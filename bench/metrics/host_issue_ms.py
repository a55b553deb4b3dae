"""host_issue_ms: the host's time from a call's start until the entry
returns, before the wait for results; the mean over the traced calls."""


def read(rec):
    calls = rec["calls"]
    if not calls:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in calls) / len(calls)
