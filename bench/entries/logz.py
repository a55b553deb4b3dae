"""Entry ``logz``: partition-function estimation by Algorithm 3. Each call
probes the index for the queries' top-k S (``Port.probe``), draws the tail
T from each query's key row and returns the stratified log Ẑ of S ∪ T
(``Port.logz``: ``amortized_candidates``, then ``stratified_logz``, which
streams the candidates through ``fused_estimator`` on the card)."""
from bench.reference import judge as J
from bench.reference import work as W

LAYERS = ("probe", "estimator")
PARTS = ("probe", "fused_estimator")


def call(sut, theta, keys, span):
    with span("probe"):
        ids, vals = sut.probe(theta)
    with span("estimator"):
        log_z = sut.logz(theta, keys, ids, vals)
    return {"log_z": log_z}, {"s_ids": ids, "s_vals": vals}


def top_k(sut, theta, out, keep):
    """The window's own S."""
    return keep["s_ids"], keep["s_vals"]


def judge(y, theta, keys, s_ids, s_vals, out, tables, cfg, limits):
    nums = J.probe(y, theta, s_ids, s_vals, tables, cfg["index"]["n_probe"])
    nums.update(J.logz(y, keys, s_ids, s_vals, out, cfg))
    nums["lost"] = J.lost(y, s_ids, cfg["k"])
    return nums


def work(acc, theta, keys, s_ids, s_vals, tables, cfg):
    W.probe(acc, theta, tables, cfg["index"]["n_probe"])
    W.estimator(acc, keys, s_ids, s_vals, cfg, theta.shape[1])
