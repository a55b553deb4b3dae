"""The port's probe router (``models/router.py``) against the JAX package's,
on a JAX-built IVF index carried across (``convert.ivf_state_from_jax``):
the features, the MLP's logits and starting stages, the certified-stage
labels, 300 steps of the plain-SGD fit from the same initial weights, and
the ``.npz`` format both ways. Then the router inside the port: routed
adaptive probes stay certified where the unrouted ones are, and the server
fits and loads a router.

Tolerances: labels, stages and ids exact; features and logits fp32
rtol=atol=1e-5; the fitted weights rtol=atol=1e-4 (300 full-batch steps of
fp32 matmuls reduced in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mips as jmips
from repro.core.mips.adaptive import stage_widths as jstage_widths
from repro.models import router as jrouter
from repro_torch.configs import get_smoke
from repro_torch.convert import ivf_state_from_jax
from repro_torch.core import mips
from repro_torch.models import router
from repro_torch.models.model import Model
from repro_torch.serve.server import ServeConfig, Server

# one intra-op thread: the suite runs six workers on the same cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N, D, B, K = 4096, 32, 96, 64
INIT, TOP = 1, 16


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def case():
    """Unit rows around 32 centres, queries = rows at three temperatures
    (so the labels spread over the stages), the JAX index and the port's
    index on its state."""
    r = np.random.default_rng(0)
    centers = r.standard_normal((32, D))
    db = centers[r.integers(0, 32, N)] + 0.3 * r.standard_normal((N, D))
    db = (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)
    temps = np.repeat([0.05, 0.3, 2.0], B // 3)
    q = (db[r.integers(0, N, B)] / temps[:, None]).astype(np.float32)
    kw = dict(n_clusters=32, kmeans_iters=4, n_probe=8, n_probe_init=INIT,
              n_probe_max=TOP)
    jindex = jmips.build_index(jmips.IVFConfig(**kw), jnp.asarray(db))
    index = mips.IVFIndex(mips.IVFConfig(**kw),
                          ivf_state_from_jax(jax.device_get(jindex.state)))
    widths = jstage_widths(INIT, TOP)
    c_scores = q @ np.asarray(jindex.state.centroids).T
    return q, jindex, index, widths, c_scores


def test_features_logits_and_stages_match_jax(case):
    q, _, _, widths, c_scores = case
    want = np.asarray(jrouter.stage_features(jnp.asarray(c_scores),
                                             jnp.asarray(q), widths))
    got = router.stage_features(_t(c_scores), _t(q), widths)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jr = jrouter.init_router(jax.random.key(3), len(widths))
    tr = router.ProbeRouter(*(_t(a) for a in jax.device_get(jr)))
    assert tr.n_stages == jr.n_stages == len(widths)
    np.testing.assert_allclose(
        tr.logits(_t(c_scores), _t(q), widths).numpy(),
        np.asarray(jr.logits(jnp.asarray(c_scores), jnp.asarray(q), widths)),
        **TOL)
    np.testing.assert_array_equal(
        tr.init_stage(_t(c_scores), _t(q), widths).numpy(),
        np.asarray(jr.init_stage(jnp.asarray(c_scores), jnp.asarray(q),
                                 widths)))


def test_certified_stage_labels_match_jax(case):
    q, jindex, index, widths, _ = case
    want = np.asarray(jrouter.certified_stage_labels(jindex, jnp.asarray(q),
                                                     K, widths))
    got = router.certified_stage_labels(index, _t(q), K, widths)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) >= 2  # the labels exercise several stages


def test_fit_router_matches_jax(case):
    q, jindex, _, widths, c_scores = case
    feats = jrouter.stage_features(jnp.asarray(c_scores), jnp.asarray(q),
                                   widths)
    labels = jrouter.certified_stage_labels(jindex, jnp.asarray(q), K, widths)
    jr0 = jrouter.init_router(jax.random.key(5), len(widths))
    want = jax.device_get(jrouter.fit_router(jr0, feats, labels))
    got = router.fit_router(
        router.ProbeRouter(*(_t(a) for a in jax.device_get(jr0))),
        _t(feats), _t(labels))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    # the fit learned something: fewer wrong starting stages than at init
    c_t = _t(c_scores)
    wrong = [int((r.init_stage(c_t, _t(q), widths) != _t(labels)).sum())
             for r in (router.ProbeRouter(*(_t(a) for a in
                                           jax.device_get(jr0))), got)]
    assert wrong[1] < wrong[0]


def test_npz_round_trip_both_ways(case, tmp_path):
    _, _, _, widths, _ = case
    jr = jrouter.init_router(jax.random.key(7), len(widths))
    jrouter.save_router(str(tmp_path / "jax.npz"), jr)
    got = router.load_router(str(tmp_path / "jax.npz"))
    for a, b in zip(got, jax.device_get(jr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.float32
    tr = router.init_router(11, len(widths))
    router.save_router(str(tmp_path / "sub" / "port.npz"), tr)
    back = jrouter.load_router(str(tmp_path / "sub" / "port.npz"))
    for a, b in zip(jax.device_get(back), tr):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_routed_probe_keeps_the_certificate(case):
    """A router only moves where rows start: each row's certificate and,
    where it is certified, its top-k ids hold whatever stage it starts at
    (widths may only grow)."""
    q, _, index, _, _ = case
    fitted = router.train_router(index, _t(q), K, steps=300)
    plain = index.topk_adaptive(_t(q), K)
    routed = index.topk_adaptive(_t(q), K, router=fitted)
    assert torch.equal(routed.certified, plain.certified)
    assert bool((routed.width >= plain.width).all())
    both = plain.certified
    assert torch.equal(routed.ids[both], plain.ids[both])


def test_server_fits_and_loads_a_router(tmp_path):
    cfg = get_smoke("tinyllama-1.1b").scaled(
        vocab=4096, head_mips="ivf", head_adaptive_probe=True,
        head_n_probe_init=2, head_n_probe_max=8)
    params = Model(cfg, "f32", device="cpu").init(0)
    kw = dict(batch_slots=2, max_seq=32, max_new_tokens=3, decode_window=2)
    fit = Server(cfg, params, ServeConfig(probe_router="fit", **kw),
                 precision_policy="f32", device="cpu")
    assert isinstance(fit.router, router.ProbeRouter)
    assert fit.router.n_stages == len(jstage_widths(2, 8))
    path = str(tmp_path / "r.npz")
    router.save_router(path, fit.router)
    loaded = Server(cfg, params, ServeConfig(probe_router=path, **kw),
                    precision_policy="f32", device="cpu", index=fit.index)
    for a, b in zip(loaded.router, fit.router):
        assert torch.equal(a, b)
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    res = [s.run(prompts) for s in (fit, loaded)]
    assert [r.tokens for r in res[0]] == [r.tokens for r in res[1]]
    # every decoded token is binned (the prefill's first token is not)
    assert sum(fit.stats["probe_width_hist"].values()) == 2 * 2
    with pytest.warns(UserWarning, match="router ignored"):
        off = Server(cfg.scaled(head_adaptive_probe=False), params,
                     ServeConfig(probe_router="fit", **kw),
                     precision_policy="f32", device="cpu")
    assert off.router is None
