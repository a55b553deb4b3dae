"""The port's training path with the IVF-PQ top-k probe: against the JAX
package's trainer step (the same params, PQ index state, batches and head
draws; each side refreshes its own index every 3 steps), and the port's
trainer contracts with a PQ head — the index re-ranks against a frozen
copy of the rows, not the live ones the optimizer updates in place, and a
resume from a mid-run checkpoint equals the uninterrupted run bit for bit
(the checkpoint carries the rows, centroids and codebooks).

Test size: as tests/test_torch_ivf_train.py (whose ``run_both`` drives
both sides): tinyllama-1.1b's smoke config (2 layers, d 64) at the full
vocabulary of 32000, the reference's PQConfig defaults (8 subspaces of 256
codewords) and r = 2k = 1152; the trainer tests at vocab 4096.

The first EVERY steps run unsynced: each side steps its own params. With
the LUT screen's top-r ahead of the exact top-k, a near-tie flip of one
token's top-k set on rounding is likelier than with the IVF probe; one
flip changes that token's complement draws, which AdamW turns into row
updates of ~lr that every later step inherits. So the losses are held up
to and including the first step with a flip, and every flip up to there
must be a near tie: the contested ids' scores within rtol 1e-6 (about 16
ulp) of the reference's k-th value. After step EVERY and each later one,
the port's params and AdamW state are reset to the reference's before the
refresh (``run_both(sync_from=EVERY)``), so both refreshes and steps 4-6
are held from a common state, their flips near ties too.

Tolerances: losses rtol=1e-5; params after one step rtol=1e-4, atol=2e-5
(both as in test_torch_ivf_train.py); refreshed centroids and codebooks
atol=1e-6, the packed member / overflow ids and the member codes equal.
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro_torch.checkpoint import manager
from repro_torch.configs import get_smoke
from repro_torch.launch import steps
from repro_torch.optim import adamw
from repro_torch.train.trainer import RunConfig, Trainer
from test_torch_ivf_train import ARCH, EVERY, STEPS, run_both
from test_torch_train import OPT, B, L, _cfgs, _equal_trees, _run


@pytest.fixture(scope="module")
def smoke_runs():
    torch.set_num_threads(1)  # the suite runs six workers on the same cores
    kw = dict(vocab=32000, head_mips="ivfpq")
    return run_both(jget_smoke(ARCH).scaled(**kw),
                    get_smoke(ARCH).scaled(**kw), batch=2, seq=128, lr=1e-3,
                    sync_from=EVERY)


def _held_steps(r) -> list[int]:
    """The steps whose two sides start from a common state, up to rounding:
    the unsynced ones up to and including the first with a top-k flip, and
    the synced ones."""
    first = next((i for i, f in enumerate(r["flips"]) if f), STEPS)
    return [i for i in range(STEPS) if i <= first or i >= EVERY]


def test_ivfpq_train_step_matches_jax(smoke_runs):
    """One train step through the IVF-PQ probe: the loss and every updated
    param."""
    r = smoke_runs
    np.testing.assert_allclose(r["port_loss"][0], r["jax_loss"][0],
                               rtol=1e-5)
    got = adamw.tree_leaves(r["port_params1"])
    want = jax.tree.leaves(r["jax_params1"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=2e-5)


def test_ivfpq_trajectory_and_exact_nll_match_jax(smoke_runs):
    """Six steps with refreshes at 3 and 6: the amortized loss and the exact
    NLL of each held step's batch agree with the reference's."""
    r = smoke_runs
    held = _held_steps(r)
    assert held[:2] == [0, 1]  # at least two unsynced steps are held
    for name in ("loss", "nll"):
        np.testing.assert_allclose([r["port_" + name][i] for i in held],
                                   [r["jax_" + name][i] for i in held],
                                   rtol=1e-5, err_msg=name)


def test_ivfpq_topk_flips_are_near_ties(smoke_runs):
    """Where the two sides' IVF-PQ probes pick different top-k sets on a
    held step, the contested ids score within rounding of the reference's
    k-th value: a flip of a near tie, not a different index."""
    r = smoke_runs
    for i in _held_steps(r):
        for f in r["flips"][i]:
            assert len(f["jax_only"]) == len(f["port_only"]), (i, f)
            np.testing.assert_allclose(f["scores"], f["kth"], rtol=1e-6,
                                       err_msg=f"step {i + 1}: {f}")


def test_ivfpq_refresh_matches_jax(smoke_runs):
    """Each side's warm-start refresh of its own index over its own drifted
    rows: the same centroids and codebooks, members, overflow and codes."""
    r = smoke_runs
    assert len(r["refreshes"]) == STEPS // EVERY
    for js, ts in r["refreshes"]:
        for name in ("centroids", "codebooks"):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(js, name)), rtol=0,
                                       atol=1e-6, err_msg=name)
        for name in ("member_ids", "overflow_ids", "member_codes"):
            assert np.array_equal(getattr(ts, name).numpy(),
                                  np.asarray(getattr(js, name))), name


def test_trainer_pq_index_reranks_a_frozen_copy(tmp_path):
    """The trainer builds the PQ index over its drift snapshot, a copy: a
    train step moves the live output embedding in place, and the index's
    re-rank rows keep the values it was built over."""
    _, tcfg = _cfgs(head_mips="ivfpq")
    tr = Trainer(tcfg, RunConfig(batch=B, seq=L, train=steps.TrainConfig(
        opt=adamw.OptConfig(**OPT), precision="f32")), str(tmp_path),
        device="cpu")
    state = tr.init_state()
    tr._init_head_index(state["params"])
    live = tr.model.head_index_db(state["params"])
    db = tr.head_index.state.db
    assert db is tr._index_snapshot and db.data_ptr() != live.data_ptr()
    assert torch.equal(db, live)
    before = db.clone()
    tr.step_fn({"params": state["params"], "opt": state["opt"]},
               tr._stack_batches(1), range(0, 1), 0, tr.head_index)
    assert not torch.equal(live, before)  # the optimizer moved the rows
    assert torch.equal(tr.head_index.state.db, before)


def test_pq_resume_equals_uninterrupted_bitwise(tmp_path):
    """Checkpoint at step 3, resume, finish: losses and final params bitwise
    the uninterrupted run's, with an IVF-PQ head refreshed every 2 steps —
    the resume re-packs the saved rows around the saved centroids and
    codebooks."""
    _, tcfg = _cfgs(head_mips="ivfpq")
    kw = dict(ckpt_every=3, index_refresh_every=2)
    full, _ = _run(tcfg, tmp_path / "a", 6, **kw)
    first, _ = _run(tcfg, tmp_path / "b", 4, **kw)
    shutil.rmtree(tmp_path / "b" / "ckpt_00000004")
    second, res = _run(tcfg, tmp_path / "b", 6, **kw)
    assert res["status"] == "done" and second.index_refreshes == 2
    losses = [e["loss"] for e in first.metrics_log[:3] + second.metrics_log]
    assert losses == [e["loss"] for e in full.metrics_log]
    st_a, _, _ = manager.restore(str(tmp_path / "a"), step=6)
    st_b, _, _ = manager.restore(str(tmp_path / "b"), step=6)
    assert set(st_a["index"]) == {"db", "centroids", "codebooks"}
    assert _equal_trees(st_a, st_b)
