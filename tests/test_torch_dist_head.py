"""The port's distributed amortized head (``repro_torch.models.head``) on
spawned gloo ranks, the output embedding's rows sharded over the model
axis (mp 2 and 4, a padded vocabulary: the last shard masks its pad rows).

* ``dist_head_loss`` in exact mode against the reference's single-device
  ``head_loss`` on the whole table: the loss, ``d_emb`` (the shards'
  gradients side by side) and ``d_h`` at rtol 1e-5 (atol 1e-6) — the
  reference's own test_dist_head_loss_matches_single_device asserts it for
  the loss.
* Amortized mode with each shard's tail draws injected: against the
  reference's per-shard ``loss_partials`` (its ``dist_head_loss``'s local
  function: ``fold_in(key, midx)``, per-shard k, l and ``n_valid``)
  combined by its ``combine_loss_psum``, run in-process under
  ``jax.vmap(..., axis_name="model")``; gradients from one replica's
  output (the vmapped sum would count it mp times).
* ``dist_head_sample``: a chi-square goodness of fit against the exact
  softmax on 3 seeds (as tests/test_torch_sampler.py), fused ≡ unfused over
  an IVF ShardedIndex, and the adaptive width = the max of the shards'
  own widths.
* mp 1 equals the single-device head bit for bit on an unpadded table
  (its keys folded with model index 0, as every shard folds its own).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from repro.core import amortized_head as jah
from repro.core import estimators as jest
from repro.models import head as jhead
from repro_torch.core import amortized_head as ah
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import slot_keys
from repro_torch.models import head as dh
from test_torch_estimator import jax_tail_draws
from test_torch_sampler import ALPHA, _chi2_pvalue, _softmax_np

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
VP, N, D, T, CHUNK = 1024, 1000, 16, 40, 16
AMORT = dict(n=N, mode="amortized", k=64, l=64, chunk=CHUNK,
             min_amortized_n=0)
EXACT = dict(n=N, mode="exact", chunk=CHUNK)
SAMPLE = dict(n=512, k=96, l=96, min_amortized_n=0)
IVF = dict(n=512, k=32, l=32, mips="ivf", min_amortized_n=0)
SAMPLE_DRAWS = 10_000


def _case(seed=0):
    r = np.random.default_rng(seed)
    emb = (r.standard_normal((VP, D)) / np.sqrt(D)).astype(np.float32)
    h = (r.standard_normal((T, D)) * 2.0).astype(np.float32)
    tgt = r.integers(0, N, T).astype(np.int64)
    w = r.uniform(0.5, 1.5, T).astype(np.float32)
    return emb, h, tgt, w


def _jax_dist_loss(emb, h, tgt, w, key, cfg_kw, mp):
    """The reference's dist_head_loss local function per shard, under
    vmap -> (loss, d_emb (VP, d), d_h)."""
    cfg = jah.HeadConfig(**cfg_kw).resolved()
    v_loc, k_loc, l_loc = jhead._shard_geometry(cfg, VP, mp)

    def local(emb_loc, hh):
        midx = jax.lax.axis_index("model")
        offset = midx * v_loc
        n_valid = jnp.clip(cfg.n - offset, 0, v_loc)
        kk = jax.random.fold_in(key, midx)

        def one_chunk(kc, hc, tc):
            return jest.loss_partials(
                kc, emb_loc, hc, tc, mode=cfg.mode, k=k_loc, l=l_loc,
                n_valid=n_valid, score_dtype=cfg.score_dt)

        parts = jest.chunked_map(one_chunk, cfg.chunk, kk, hh,
                                 jnp.asarray(tgt, jnp.int32) - offset)
        return jest.combine_loss_psum(parts, cfg.mode, "model")

    def obj(e, hh):
        loss = jax.vmap(local, in_axes=(0, None), axis_name="model")(
            e.reshape(mp, v_loc, D), hh)[0]
        return (loss * jnp.asarray(w)).sum(), loss

    (_, loss), (de, dhh) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(jnp.asarray(emb), jnp.asarray(h))
    return np.asarray(loss), np.asarray(de), np.asarray(dhh)


def _shard_draws(key, mp, cfg_kw):
    """Each shard's tail uniforms, as its fold_in(key, midx) draws them:
    below n_valid - k_loc (the dense probe fills all k_loc slots)."""
    cfg = jah.HeadConfig(**cfg_kw).resolved()
    v_loc, k_loc, l_loc = jhead._shard_geometry(cfg, VP, mp)
    out = []
    for s in range(mp):
        nv = min(max(N - s * v_loc, 0), v_loc)
        out.append(jax_tail_draws(jax.random.fold_in(key, s), T, CHUNK,
                                  l_loc, np.full(T, nv - k_loc)))
    return np.stack(out).astype(np.int64)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn per model width: the loss cases at mp 2 and 4, and at mp 2
    also the sampling runs over a 512-row table."""
    runs = {}
    for mp in (2, 4):
        emb, h, tgt, w = _case(mp)
        key = jax.random.key(31 + mp)
        spec = {"emb": emb, "loss": [
            {"cfg": EXACT, "h": h, "tgt": tgt, "w": w},
            {"cfg": AMORT, "h": h, "tgt": tgt, "w": w,
             "draws": _shard_draws(key, mp, AMORT)}]}
        if mp == 2:
            r = np.random.default_rng(5)
            semb = (r.standard_normal((512, D)) / np.sqrt(D)).astype(
                np.float32)
            spec["sample"] = {
                "emb": semb, "cfg": SAMPLE,
                "h": r.standard_normal(D).astype(np.float32),
                "seeds": (0, 1, 2), "draws": SAMPLE_DRAWS, "ivf_cfg": IVF,
                "q": (r.standard_normal((8, D)) * 2.0).astype(np.float32)}
        outs = td.spawn(td.dist_head_cases, tmp_path_factory.mktemp("head"),
                        1, mp, spec)
        runs[mp] = (spec, (emb, h, tgt, w, key), outs)
    return runs


@pytest.fixture(params=[2, 4])
def run(request, spawned):
    _, case, outs = spawned[request.param]
    return request.param, case, outs


@pytest.fixture
def sample_run(spawned):
    spec, _, outs = spawned[2]
    return spec["sample"]["emb"], spec["sample"]["h"], outs


def test_exact_loss_and_grads_match_single_device(run):
    mp, (emb, h, tgt, w, key), outs = run
    jcfg = jah.HeadConfig(**EXACT)

    def obj(e, hh):
        loss = jah.head_loss(e, hh, jnp.asarray(tgt), key, jcfg).loss
        return (loss * jnp.asarray(w)).sum(), loss

    (_, loss), (de, dhh) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(jnp.asarray(emb), jnp.asarray(h))
    got_de = np.concatenate([o["loss"][0]["d_emb"] for o in outs])
    for o in outs:
        np.testing.assert_allclose(o["loss"][0]["loss"], np.asarray(loss),
                                   **TOL)
        np.testing.assert_allclose(o["loss"][0]["d_h"], np.asarray(dhh),
                                   **TOL)
    np.testing.assert_allclose(got_de, np.asarray(de), **TOL)


def test_amortized_loss_matches_reference_partials(run):
    mp, (emb, h, tgt, w, key), outs = run
    loss, de, dhh = _jax_dist_loss(emb, h, tgt, w, key, AMORT, mp)
    got_de = np.concatenate([o["loss"][1]["d_emb"] for o in outs])
    for o in outs:
        np.testing.assert_allclose(o["loss"][1]["loss"], loss, **TOL)
        np.testing.assert_allclose(o["loss"][1]["d_h"], dhh, **TOL)
    np.testing.assert_allclose(got_de, de, **TOL)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_dist_sample_matches_softmax(sample_run, seed):
    emb, h, outs = sample_run
    ids, ok = outs[0]["sample"][seed]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["sample"][seed][0], ids)
    assert ok.mean() > 0.99
    pv = _chi2_pvalue(np.bincount(ids, minlength=512),
                      _softmax_np(emb @ h))
    assert pv > ALPHA, f"distributed sampler deviates: p={pv:.2e}"


def test_dist_sample_fused_equals_unfused(sample_run):
    _, _, outs = sample_run
    for o in outs:
        for a, b in zip(o["ivf"]["unfused"], o["ivf"]["fused"]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[0]["ivf"]["fused"][0],
                                  outs[1]["ivf"]["fused"][0])


def test_dist_sample_adaptive_width_is_shard_max(sample_run):
    _, _, outs = sample_run
    for o in outs:
        np.testing.assert_array_equal(o["ivf"]["adaptive_width"],
                                      o["ivf"]["local_widths"].max(0))
        assert (o["ivf"]["adaptive_width"] >= 1).all()


@pytest.mark.parametrize("mode", ["exact", "amortized"])
def test_mp1_equals_single_device_bitwise(mode):
    emb, h, tgt, _ = _case(9)
    mesh = mesh_lib.make_train_mesh(1, 1)
    # an unpadded table: the single-device head slices pad rows away where
    # a shard masks them, which sums in another order
    cfg = dataclasses.replace(
        ah.HeadConfig(**(AMORT if mode == "amortized" else EXACT)), n=VP)
    rids = torch.arange(T)
    keys = slot_keys(3, rids, rids)
    outs = []
    for dist in (True, False):
        e = torch.from_numpy(emb).requires_grad_(True)
        hh = torch.from_numpy(h).requires_grad_(True)
        if dist:
            loss = dh.dist_head_loss(mesh, e, hh, torch.from_numpy(tgt), cfg,
                                     keys=keys)
        else:
            loss = ah.head_loss(e, hh, torch.from_numpy(tgt), cfg,
                                keys=dh.shard_keys(keys, 0)).loss
        loss.sum().backward()
        outs.append((loss.detach(), e.grad, hh.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    ids, ok, _ = dh.dist_head_sample(mesh, torch.from_numpy(emb),
                                     torch.from_numpy(h), cfg, keys=keys)
    ref = ah.head_sample(torch.from_numpy(emb), torch.from_numpy(h), cfg,
                         keys=dh.shard_keys(keys, 0))
    assert torch.equal(ids, ref.index.long())
    assert torch.equal(ok, ref.ok)
