"""The serving tier on a tp-2 mesh of spawned gloo CPU ranks, the trunk
sharded (the reference test's small tinyllama: d 64, vocab 4096, IVF head
over a ``ShardedIndex``). Host decisions read off a clock or fitted from
data are made on rank 0 and broadcast, so on both ranks:

* slo ≡ fifo streams under staggered open-loop arrivals (a 1 ms TTFT
  target: slo reorders admission and shrinks its windows);
* paged (block_len 8) ≡ dense;
* ``probe_router="fit"`` gives ONE router, equal on both ranks, and the
  tokens it serves are unchanged when the router rank 0 saved is
  reloaded from its ``.npz``;

each run bitwise equal on both ranks.
"""
import numpy as np
import pytest
import torch

import _torch_dist as td

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = np.random.default_rng(3)
    prompts = [r.integers(0, 4096, int(n)).tolist()
               for n in r.integers(3, 11, 5)]
    d = tmp_path_factory.mktemp("serve_tier")
    return td.spawn(td.serve_tier_case, d, 1, 2, {
        "prompts": prompts, "arrivals": [0.0, 0.0, 0.02, 0.04, 0.06],
        "priorities": [1, 0, 1, 0, 1], "dir": str(d)})


def test_slo_equals_fifo_under_arrivals(ranks):
    for o in ranks:
        assert o["slo"] == o["fifo"] == ranks[0]["fifo"]
        assert all(len(t) == 6 for t in o["fifo"])
        assert o["slo_dispatches"] == ranks[0]["slo_dispatches"]
        # slo shrank its windows (the target is blown at once): more
        # dispatches for the same tokens
        assert o["slo_dispatches"] > o["fifo_dispatches"]


def test_paged_equals_dense(ranks):
    for o in ranks:
        assert o["paged"] == o["dense"] == ranks[0]["dense"]


def test_fitted_router_is_one_router_and_reloads(ranks):
    for o in ranks:
        for f, w in ranks[0]["router"].items():
            np.testing.assert_array_equal(o["router"][f], w)
        assert o["fit"] == o["loaded"] == ranks[0]["fit"]
        assert all(len(t) == 6 for t in o["fit"])
