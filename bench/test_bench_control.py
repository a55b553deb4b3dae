"""The comparison can fail: the control (the reference in TF32 in the
program's place) and faults planted in the timed path, each at the tiny
CPU shapes, make ``correct`` false. The harness's look for a card is
skipped (``--tiny``); the rest of a run is driven as on the card."""
from __future__ import annotations

import pytest
import torch

from bench import port
from bench._testing import run_tiny

CELLS = ("imagenet.sample", "words.logz", "imagenet.topk")


def judged(res):
    bad = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    return res["correct"], bad


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(capsys, cell):
    rc, res, err = run_tiny(capsys, cell, "--control", "1")
    assert rc == 0, err
    correct, bad = judged(res)
    assert not correct and "topk_value_err" in bad
    assert res["failed"] > 0


def altered_sample(self, theta, keys):
    """A sample altered where it is produced: query 0 gets another row."""
    out = dict(SAMPLE(self, theta, keys))
    out["index"] = out["index"].clone()
    out["index"][0] = (out["index"][0] + 1) % self.cfg["n"]
    return out


def altered_count_sample(self, theta, keys):
    """A tail count altered where it is produced."""
    out = dict(SAMPLE(self, theta, keys))
    out["m"] = out["m"] + 1
    return out


def half_batch_sample(self, theta, keys):
    """Half of the batch left out: the second half repeats the first's
    answers."""
    h = theta.shape[0] // 2
    out = SAMPLE(self, theta[:h], keys[:h])
    return {k: torch.cat([v, v]) for k, v in out.items()}


def altered_probe(self, theta):
    """A top-k altered where it is produced: query 0 keeps its best row
    twice and loses its worst."""
    ids, vals = PROBE(self, theta)
    ids = ids.clone()
    ids[0, -1] = ids[0, 0]
    return ids, vals


def altered_logz(self, theta, keys, ids, vals):
    """A log Ẑ altered where it is produced."""
    z = LOGZ(self, theta, keys, ids, vals).clone()
    z[0] += 1e-2
    return z


def dropped_row_index(self, db, cfg):
    """An index that lost a row of the table."""
    INIT(self, db, cfg)
    st = self.index.state
    live = (st.member_ids >= 0).nonzero()[0]
    st.member_ids[live[0], live[1]] = -1


def random_centroid_index(self, db, cfg):
    """An index whose centroids never left a random start (Lloyd's update
    left out), its rows packed around them: the centroids are the
    program's own, so only the recall against the dense top-k judges
    them."""
    from repro_torch.core.mips.ivf import IVFIndex

    INIT(self, db, cfg)
    cent = self.index.state.centroids
    gen = torch.Generator().manual_seed(0)
    cent = torch.randn(cent.shape, generator=gen)
    cent /= torch.linalg.norm(cent, dim=1, keepdim=True)
    self.index = IVFIndex.build(db, self.index.config, init_cent=cent,
                                iters=0)


SAMPLE, PROBE = port.Port.sample, port.Port.probe
LOGZ, INIT = port.Port.logz, port.Port.__init__
FAULTS = [
    ("imagenet.sample", "sample", altered_sample, {"sample_gap"}),
    ("imagenet.sample", "sample", altered_count_sample,
     {"sample_flag_faults"}),
    ("imagenet.sample", "sample", half_batch_sample, {"sample_gap"}),
    ("imagenet.topk", "probe", altered_probe, {"topk_gap",
                                               "topk_value_err"}),
    ("words.logz", "logz", altered_logz, {"logz_err"}),
    ("imagenet.topk", "__init__", dropped_row_index, {"index_pack_faults"}),
    ("imagenet.topk", "__init__", random_centroid_index, {"topk_miss"}),
    ("imagenet.sample", "__init__", random_centroid_index, {"topk_miss"}),
]


@pytest.mark.parametrize("cell,method,fault,numbers", FAULTS,
                         ids=[f[2].__name__ for f in FAULTS])
def test_planted_fault_reads_not_correct(capsys, monkeypatch, cell, method,
                                         fault, numbers):
    monkeypatch.setattr(port.Port, method, fault)
    rc, res, err = run_tiny(capsys, cell)
    assert rc == 0, err
    correct, bad = judged(res)
    assert not correct and numbers <= set(bad)
