"""The port's training path with the IVF top-k probe against the JAX
package's: the same params, IVF index state, batches and head draws go
through both trainers' steps, with the index refreshed every 3 steps by each
side's own ``IVFIndex.refresh``. Each step reads the amortized loss the step
optimizes and the exact NLL of the same batch (a dense logsumexp over the
whole vocabulary), before the update.

Test size: tinyllama-1.1b's smoke config (2 layers, d 64) at the full
vocabulary of 32000, so the amortized head (k = l = 576) and the IVF index
are live; f32 policy, batch 2 x 128 (one head chunk), lr 1e-3.

Run as a script, the same comparison (unsynced, with each step's top-k
flips) prints its table at other sizes; the full-width witness (d 2048, one layer, batch 1 x 256, lr 1e-4: a few
minutes on a CPU) is

    PYTHONPATH=src python tests/test_torch_ivf_train.py --full-width

(``--mips ivfpq`` runs it with the IVF-PQ head;
tests/test_torch_ivfpq_train.py holds that path at smoke width.)

Tolerances: losses rtol=1e-5 (the trunk and head reduced in different
orders); params after one AdamW step rtol=1e-4, atol=2e-5 (as in
``test_torch_train.py``: an element whose gradient is within rounding of
zero can move by a small fraction of lr differently); refreshed centroids
atol=1e-6 and the packed member and overflow ids equal (the same warm-start
Lloyd steps on the same rows).
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtr
from repro.configs import get as jget
from repro.configs import get_smoke as jget_smoke
from repro.core import estimators as jest
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.launch import steps as jsteps
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch.configs import get, get_smoke
from repro_torch.convert import (ivf_state_from_jax, opt_state_from_jax,
                                 params_from_jax, pq_state_from_jax)
from repro_torch.core import amortized_head as ah
from repro_torch.core import estimators as est
from repro_torch.core.mips.ivf import IVFConfig, IVFIndex
from repro_torch.core.mips.pq import IVFPQIndex, PQConfig
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from test_torch_estimator import jax_tail_draws

ARCH = "tinyllama-1.1b"
STEPS, EVERY = 6, 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_index(hc, jindex, db: torch.Tensor):
    """The port's counterpart of the JAX head index ``jindex`` (its state
    carried across); an IVF-PQ index re-ranks against ``db``."""
    st = jax.device_get(jindex.state)
    if hc.mips == "ivf":
        return IVFIndex(IVFConfig(n_probe=hc.n_probe), ivf_state_from_jax(st))
    return IVFPQIndex(PQConfig(n_probe=hc.n_probe,
                               rerank=jindex.config.rerank),
                      pq_state_from_jax(st, db))


def _flips(jtopk, ptopk, h, jdb) -> list[dict]:
    """The tokens whose top-k id sets differ between the reference's probe
    ``jtopk`` and the port's ``ptopk``: the ids only one side picked, their
    scores on the reference's side (``h`` against the index rows ``jdb``)
    and the reference's k-th value."""
    jids, pids = np.asarray(jtopk.ids), ptopk.ids.numpy()
    out = []
    for t in range(jids.shape[0]):
        a, b = set(jids[t].tolist()), set(pids[t].tolist())
        if a == b:
            continue
        ids = sorted(a ^ b)
        out.append(dict(token=t, jax_only=sorted(a - b),
                        port_only=sorted(b - a),
                        scores=np.asarray(jdb[np.array(ids)] @ h[t]).tolist(),
                        kth=float(jtopk.values[t, -1])))
    return out


def run_both(jcfg, tcfg, batch: int, seq: int, lr: float,
             sync_from: int | None = None) -> dict:
    """STEPS steps of each trainer's train step from the same params and
    index, with the reference's tail draws handed to the port. Returns the
    per-step losses of both sides, both sides' params after the first
    step, both sides' index states after each refresh, and per step the
    top-k flips: each token whose probed top-k set differs between the
    sides, with the contested ids' scores on the reference's side (its
    hidden state against the rows its index was last built over) beside
    its k-th value.

    The head's backend is the config's (``ivf`` or ``ivfpq``). As in the
    port's trainer, the port's index is built and refreshed over a copy of
    the rows: its optimizer updates the live ones in place, and an IVF-PQ
    index re-ranks against the rows it holds.

    ``sync_from=s`` resets the port's params and AdamW state to the
    reference's after step s and every later one (before the refresh), so
    each later step and refresh starts from the same state on both sides:
    a top-k membership that flips between two near-tied candidates on
    rounding changes that token's complement draws, and AdamW's
    normalization turns the changed gradient of a rarely-touched row into
    a step of ~lr, which an unsynced run carries into every later step."""
    saved = jtr.REMAT
    jtr.REMAT = False  # same numerics, faster compile
    try:
        jm = JModel(jcfg, precision_policy="f32")
        hc = jm.head_cfg
        assert hc.mode == "amortized" and hc.mips in ("ivf", "ivfpq")
        opt = dict(lr=lr, warmup_steps=2, total_steps=STEPS)
        jparams = jm.init(jax.random.key(0))
        jindex = jm.make_head_index(jparams)
        jdb = jm.head_index_db(jparams)  # the rows jindex was built over
        jstep = jax.jit(jsteps.make_train_step(jm, jsteps.TrainConfig(
            opt=jadamw.OptConfig(**opt), precision="f32")))
        jopt = jadamw.init(jparams)

        @jax.jit
        def jhidden(p, b):
            x, pos, _ = jm._embed_inputs(p, b)
            h, _ = jtr.apply_trunk(p, jcfg, x, pos)
            return h.reshape(-1, h.shape[-1])

        model = Model(tcfg, "f32", device="cpu")
        params = params_from_jax(jax.device_get(jparams), tcfg)
        index = _port_index(hc, jindex, model.head_index_db(params).clone())
        tstep = steps.make_train_step(model, steps.TrainConfig(
            opt=adamw.OptConfig(**opt), precision="f32"))
        topt = adamw.init(params)
        exact_head = ah.HeadConfig(n=hc.n, mode="exact")

        out = {k: [] for k in ("jax_loss", "jax_nll", "port_loss",
                               "port_nll", "refreshes", "flips")}
        for i in range(STEPS):
            b = jmake_batch(jcfg, JDataConfig(batch=batch, seq=seq), i)
            key = jax.random.fold_in(jax.random.key(21), i)
            # the reference's per-token tail draws: its probe's live S
            # count fixes each token's complement size
            h = jhidden(jparams, b)
            emb = jm._out_embed(jparams)[: hc.n]
            topk = jest.topk_probe(emb, h, hc.k, index=jindex, n_valid=hc.n)
            live = np.asarray((~jnp.isneginf(topk.values)).sum(1))
            draws = _t(jax_tail_draws(key, h.shape[0], hc.chunk, hc.l,
                                      np.maximum(hc.n - live, 1)))
            labels = jnp.asarray(b["labels"]).reshape(-1)
            s = h @ emb.T
            out["jax_nll"].append(float(jnp.mean(
                jax.nn.logsumexp(s, -1)
                - jnp.take_along_axis(s, labels[:, None], 1)[:, 0])))
            jparams, jopt, jm_ = jstep(jparams, jopt, b, key, jindex)
            out["jax_loss"].append(float(jm_["loss"]))

            tb = {k: _t(v) for k, v in b.items()}
            with torch.no_grad():
                x, pos, _ = model._embed_inputs(params, tb)
                th, _ = transformer.apply_trunk(params, tcfg, x, pos)
                out["port_nll"].append(ah.head_loss(
                    model._out_embed(params), th.reshape(-1, th.shape[-1]),
                    tb["labels"].reshape(-1), exact_head
                ).loss.mean().item())
                ptopk = est.topk_probe(
                    model._out_embed(params)[: hc.n],
                    th.reshape(-1, th.shape[-1]), hc.k, index=index,
                    n_valid=hc.n)
            out["flips"].append(_flips(topk, ptopk, h, jdb))
            params, topt, tm_ = tstep(params, topt, tb, (0, i), index,
                                      draws=draws)
            out["port_loss"].append(tm_["loss"].item())
            if i == 0:
                out["jax_params1"] = jax.device_get(jparams)
                out["port_params1"] = adamw.tree_map(
                    lambda p: p.clone(), params)
            if sync_from is not None and i + 1 >= sync_from:
                params = params_from_jax(jax.device_get(jparams), tcfg)
                topt = opt_state_from_jax(jax.device_get(jopt), tcfg)
            if (i + 1) % EVERY == 0:
                jdb = jm.head_index_db(jparams)
                jindex = jindex.refresh(jdb)
                index = index.refresh(model.head_index_db(params).clone())
                out["refreshes"].append((jax.device_get(jindex.state),
                                         index.state))
    finally:
        jtr.REMAT = saved
    return out


@pytest.fixture(scope="module")
def smoke_runs():
    torch.set_num_threads(1)  # the suite runs six workers on the same cores
    kw = dict(vocab=32000, head_mips="ivf")
    return run_both(jget_smoke(ARCH).scaled(**kw),
                    get_smoke(ARCH).scaled(**kw), batch=2, seq=128, lr=1e-3)


def test_ivf_train_step_matches_jax(smoke_runs):
    """One train step through the IVF probe: the loss and every updated
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


def test_ivf_trajectory_and_exact_nll_match_jax(smoke_runs):
    """Six steps with refreshes at 3 and 6: the amortized loss and the exact
    NLL of each step's batch agree with the reference's."""
    r = smoke_runs
    np.testing.assert_allclose(r["port_loss"], r["jax_loss"], rtol=1e-5)
    np.testing.assert_allclose(r["port_nll"], r["jax_nll"], rtol=1e-5)


def test_ivf_refresh_matches_jax(smoke_runs):
    """Each side's warm-start refresh of its own index over its own drifted
    rows gives the same centroids and the same packed members."""
    r = smoke_runs
    assert len(r["refreshes"]) == STEPS // EVERY
    for js, ts in r["refreshes"]:
        np.testing.assert_allclose(ts.centroids.numpy(),
                                   np.asarray(js.centroids), rtol=0,
                                   atol=1e-6)
        for name in ("member_ids", "overflow_ids"):
            assert np.array_equal(getattr(ts, name).numpy(),
                                  np.asarray(getattr(js, name))), name


def main() -> None:
    ap = argparse.ArgumentParser(description="IVF-probe training: the port "
                                 "against the JAX package, step by step")
    ap.add_argument("--full-width", action="store_true",
                    help="tinyllama-1.1b's full width (d 2048) at --layers")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--mips", default="ivf", choices=["ivf", "ivfpq"],
                    help="the head's index backend")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    kw = dict(vocab=32000, head_mips=args.mips, n_layers=args.layers)
    jg, tg = (jget, get) if args.full_width else (jget_smoke, get_smoke)
    jcfg, tcfg = jg(ARCH).scaled(**kw), tg(ARCH).scaled(**kw)
    r = run_both(jcfg, tcfg, args.batch, args.seq, args.lr)
    print(f"{args.mips} head, d {tcfg.d_model}, {tcfg.n_layers} layers, "
          f"vocab {tcfg.vocab}, "
          f"batch {args.batch} x {args.seq}, lr {args.lr}, refresh every "
          f"{EVERY}")
    print("step  jax_loss  jax_nll  port_loss  port_nll")
    for i in range(STEPS):
        print(f"{i + 1:4d}  {r['jax_loss'][i]:.5f}  {r['jax_nll'][i]:.5f}  "
              f"{r['port_loss'][i]:.5f}  {r['port_nll'][i]:.5f}")
    for i, flips in enumerate(r["flips"]):
        for f in flips:
            print(f"step {i + 1} top-k flip: {json.dumps(f)}")
    print(json.dumps({k: r[k] for k in ("jax_loss", "jax_nll", "port_loss",
                                        "port_nll")}))


if __name__ == "__main__":
    main()
