"""Entry ``sample``: exact sampling by Algorithm 2. Each call hands the
system a batch of queries with their key rows and takes back one sample
per query with its certificate (``Port.sample``: the IVF probe, the
Philox tail draws and the tail scoring inside ``local_gumbel_max``)."""
from bench.reference import judge as J
from bench.reference import work as W

LAYERS = ("sampler",)  # the spans a traced call records
PARTS = ("probe", "tail")  # the work of a whole call


def call(sut, theta, keys, span):
    """-> (outputs the caller takes to the host, device tensors kept)."""
    with span("sampler"):
        out = sut.sample(theta, keys)
    return out, {}


def top_k(sut, theta, out, keep):
    """The top-k S the sample started from: the same probe on the same
    queries, run again once the window has closed (the entry does not
    return it)."""
    return sut.probe(theta)


def judge(y, theta, keys, s_ids, s_vals, out, tables, cfg, limits):
    nums = J.probe(y, theta, s_ids, s_vals, tables, cfg["index"]["n_probe"])
    nums.update(J.sample(y, keys, s_ids, s_vals, out, cfg,
                         limits["sample_value_err"]))
    nums["lost"] = J.lost(y, s_ids, cfg["k"])
    return nums


def work(acc, theta, keys, s_ids, s_vals, tables, cfg):
    W.probe(acc, theta, tables, cfg["index"]["n_probe"])
    W.tail(acc, keys, s_ids, s_vals, cfg, theta.shape[1])
