"""Entry ``topk``: top-k (MAP) inference. Each call returns the IVF
probe's top-k ids and scores of every query (``Port.probe``:
``IVFIndex.topk_batch``); neither the sampler nor the estimator runs."""
from bench.reference import judge as J
from bench.reference import work as W

LAYERS = ("probe",)
PARTS = ("probe",)


def call(sut, theta, keys, span):
    with span("probe"):
        ids, vals = sut.probe(theta)
    return {"ids": ids, "values": vals}, {}


def top_k(sut, theta, out, keep):
    """The answer itself."""
    return out["ids"], out["values"]


def judge(y, theta, keys, s_ids, s_vals, out, tables, cfg, limits):
    nums = J.probe(y, theta, s_ids, s_vals, tables, cfg["index"]["n_probe"])
    nums["lost"] = J.lost(y, s_ids, cfg["k"])
    return nums


def work(acc, theta, keys, s_ids, s_vals, tables, cfg):
    W.probe(acc, theta, tables, cfg["index"]["n_probe"])
