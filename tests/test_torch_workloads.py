"""The port's workloads against the JAX package: the beam search's
conditioning, the trunk taps, deep-kNN on reps the JAX package made,
MAP beam search with the exact log Z; and the reference's internal
contracts of ``tests/test_workloads.py`` on the port (stochastic beam
search against brute-force enumeration, teacher-forced log-probs, distinct
and deterministic beams, MAP ⊇ greedy), plus the workloads launcher's
three subcommands on the CPU. Gumbel top-k without replacement, the
expansion primitive, is held in ``tests/test_torch_gumbel_topk.py``.

Tolerances: ids, predictions, p-values, flags and counts exact; fp32
values rtol=atol=1e-5 (the taps and the beams' log-probs, which run a
trunk, rtol=atol=1e-4: the f32 policy in both packages, matmuls summed in
different orders).
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtr
from repro.configs import get_smoke as jget_smoke
from repro.models.model import Model as JModel
from repro.workloads import dknn as jdknn
from repro.workloads import structured as jstructured
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import mips
from repro_torch.launch import workloads as launcher
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.workloads import dknn, structured

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TRUNK_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _no_remat(monkeypatch):
    monkeypatch.setattr(jtr, "REMAT", False)
    monkeypatch.setattr(transformer, "REMAT", False)


def test_shift_gumbel_identities_and_reference():
    """Kool conditioning: the argmax child maps exactly to the parent's
    value, -inf children stay -inf, order is kept; equal to the
    reference's."""
    g_tilde = torch.tensor([1.5, 0.2, -3.0, -float("inf")])
    z = g_tilde.max()
    parent = torch.tensor(-0.7)
    g = structured.shift_gumbel(parent, z, g_tilde)
    assert float(g[0]) == float(parent)
    assert torch.isneginf(g[3])
    assert (torch.diff(g[:3]) < 0).all() and (g[1:3] < -0.7).all()
    want = jstructured.shift_gumbel(jnp.float32(-0.7), jnp.float32(1.5),
                                    jnp.asarray(g_tilde.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ trunk taps
def _pair(arch, vocab=None):
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    if vocab:
        jcfg, cfg = jcfg.scaled(vocab=vocab), cfg.scaled(vocab=vocab)
    jm = JModel(jcfg, precision_policy="f32")
    jp = jm.init(jax.random.key(0))
    m = Model(cfg, precision_policy="f32", device="cpu")
    return jm, jp, m, params_from_jax(jax.device_get(jp), cfg)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b"])
def test_trunk_taps_match_jax(arch):
    """One tap per block-group step (a whole (rec, rec, attn) period for
    Griffin) plus the final normed output, mean-pooled, with and without
    the lengths mask."""
    jm, jp, m, p = _pair(arch)
    toks = np.random.default_rng(2).integers(0, 512, (3, 10)).astype(
        np.int32)
    lengths = np.array([10, 4, 7], np.int32)
    for ln in (None, lengths):
        want = np.asarray(jm.trunk_taps(
            jp, {"tokens": jnp.asarray(toks)},
            lengths=None if ln is None else jnp.asarray(ln)))
        got = m.trunk_taps(p, {"tokens": _t(toks)},
                           lengths=None if ln is None else _t(ln))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TRUNK_TOL)
    groups = transformer.block_groups(m.cfg)
    assert got.shape[0] == sum(c for _, c in groups) + 1


def test_trunk_taps_pooling_masks_padding():
    _, _, m, p = _pair("tinyllama-1.1b", vocab=64)
    toks = torch.randint(0, 64, (3, 10), generator=torch.Generator()
                         .manual_seed(2))
    lengths = torch.tensor([10, 4, 7])
    a = m.trunk_taps(p, {"tokens": toks}, lengths=lengths)
    cut = toks.clone()
    cut[1, 4:] = 0
    b = m.trunk_taps(p, {"tokens": cut}, lengths=lengths)
    torch.testing.assert_close(a[:, 1], b[:, 1], rtol=1e-5, atol=1e-6)
    assert a.ndim == 3 and a.shape[1] == 3
    # the training forward is unchanged by the taps
    x, pos, _ = m._embed_inputs(p, {"tokens": toks})
    h, aux = transformer.apply_trunk(p, m.cfg, x, pos)
    h2, aux2, taps = transformer.apply_trunk(p, m.cfg, x, pos,
                                             return_taps=True)
    assert torch.equal(h, h2) and torch.equal(aux, aux2)
    assert torch.equal(taps[-1], h.float())


# ----------------------------------------------------------------- dknn
def _toy_reps(n_per, n_classes, d, seed, spread=0.15):
    """Two taps of separated class clusters on the sphere (the reference
    test's data): class centres and the second tap's rotation fixed (seed
    77), ``seed`` varies the noise."""
    geo = np.random.default_rng(77)
    centers = geo.normal(size=(n_classes, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rot = np.linalg.qr(geo.normal(size=(d, d)))[0]
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(n_classes), n_per)
    pts = centers[labels] + spread * rng.normal(size=(len(labels), d))
    return np.stack([pts, pts @ rot]).astype(np.float32), labels


def test_dknn_matches_jax_on_jax_reps():
    """Reps made by the JAX package's trunk taps (band data, spread wide so
    classes overlap): predictions, p-values, nonconformity and neighbours
    exactly the reference's."""
    jm, jp, _, _ = _pair("tinyllama-1.1b", vocab=64)
    r = np.random.default_rng(0)
    n = 96 + 32 + 24  # train, calibration, test: one trunk call
    labels = r.integers(0, 4, n)
    toks = labels[:, None] * 16 + r.integers(0, 16, (n, 8))
    toks = np.where(r.random((n, 8)) < 0.5, r.integers(0, 64, (n, 8)), toks)
    reps = np.asarray(jm.trunk_taps(jp, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)}))
    tr, ca, te = reps[:, :96], reps[:, 96:128], reps[:, 128:]
    tl, cl = labels[:96], labels[96:128]
    jcfg = jdknn.DKNNConfig(n_classes=4, k=6)
    jstate = jdknn.fit(jnp.asarray(tr), jnp.asarray(tl), jnp.asarray(ca),
                       jnp.asarray(cl), jcfg)
    want = jdknn.classify(jstate, jdknn.normalize_reps(jnp.asarray(te)),
                          jcfg)
    cfg = dknn.DKNNConfig(n_classes=4, k=6)
    state = dknn.fit(_t(tr), _t(tl), _t(ca), _t(cl), cfg)
    got = dknn.classify(state, dknn.normalize_reps(_t(te)), cfg)
    np.testing.assert_array_equal(state.cal_sorted.numpy(),
                                  np.asarray(jstate.cal_sorted))
    for f in ("pred", "p_values", "alpha", "neighbors", "credibility",
              "confidence"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert len(set(got.pred.tolist())) > 1


@pytest.mark.parametrize("backend", ["exact", "ivf", "lsh"])
def test_dknn_classifies_separable_clusters(backend):
    icfg = {"exact": mips.ExactConfig(),
            "ivf": mips.IVFConfig(n_clusters=8, n_probe=8, kmeans_iters=4),
            "lsh": mips.LSHConfig(n_tables=8, n_bits=3)}[backend]
    cfg = dknn.DKNNConfig(n_classes=4, k=8, index_cfg=icfg)
    train, tl = _toy_reps(64, 4, 16, seed=0)
    cal, cl = _toy_reps(16, 4, 16, seed=1)
    test, wl = _toy_reps(16, 4, 16, seed=2)
    state = dknn.fit(_t(train), _t(tl), _t(cal), _t(cl), cfg)
    res = dknn.classify(state, dknn.normalize_reps(_t(test)), cfg)
    assert float((res.pred.numpy() == wl).mean()) >= 0.95
    p = res.p_values.numpy()
    assert (p > 0).all() and (p <= 1).all()
    np.testing.assert_allclose(res.credibility.numpy(), p.max(axis=1))
    np.testing.assert_allclose(res.confidence.numpy(),
                               1.0 - np.sort(p, axis=1)[:, -2])
    neigh = res.neighbors.numpy()
    assert neigh.shape == (2, 64, 8)
    assert (neigh[neigh >= 0] < train.shape[1]).all()


def test_dknn_credibility_flags_ood():
    cfg = dknn.DKNNConfig(n_classes=4, k=8)
    train, tl = _toy_reps(64, 4, 16, seed=0)
    cal, cl = _toy_reps(16, 4, 16, seed=1)
    state = dknn.fit(_t(train), _t(tl), _t(cal), _t(cl), cfg)
    test, _ = _toy_reps(16, 4, 16, seed=2)
    ood = np.random.default_rng(9).normal(size=(2, 24, 16)).astype(
        np.float32)
    r_in = dknn.classify(state, dknn.normalize_reps(_t(test)), cfg)
    r_ood = dknn.classify(state, dknn.normalize_reps(_t(ood)), cfg)
    assert float(r_ood.credibility.mean()) < 0.5 * float(
        r_in.credibility.mean())


# --------------------------------------------------- structured search
def test_map_exact_logz_matches_jax():
    """MAP with the exact per-step log Z has no randomness: the tokens are
    the reference's, the log-probs allclose."""
    jm, jp, m, p = _pair("tinyllama-1.1b", vocab=64)
    prompt = np.array([2, 4, 9], np.int32)
    for expand_k in (64, 8):
        kw = dict(n_beams=4, horizon=5, expand_k=expand_k, mode="map")
        want = jstructured.search(jm, jp, jnp.asarray(prompt),
                                  jax.random.key(0),
                                  jstructured.BeamConfig(**kw))
        got = structured.search(m, p, prompt, 0, structured.BeamConfig(**kw))
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_allclose(got.logp.numpy(), np.asarray(want.logp),
                                   **TRUNK_TOL)
        np.testing.assert_array_equal(got.exact.numpy(),
                                      np.asarray(want.exact))
        assert float(got.ok_rate) == float(want.ok_rate)


def _model(vocab):
    m = Model(get_smoke("tinyllama-1.1b").scaled(vocab=vocab),
              precision_policy="f32", device="cpu")
    return m, m.init(0)


def test_sbs_matches_bruteforce_enumeration_bitwise():
    """Beam width |V|^H enumerates every sequence; the width-W run returns
    its top W leaves bit for bit (keys follow the path, not the batch)."""
    V, H, W = 6, 3, 3
    m, p = _model(V)
    prompt = [1, 2]
    small = structured.search(m, p, prompt, 9, structured.BeamConfig(
        n_beams=W, horizon=H, expand_k=V, l=8))
    full = structured.search(m, p, prompt, 9, structured.BeamConfig(
        n_beams=V**H, horizon=H, expand_k=V, l=8))
    live = full.live.numpy()
    assert live.sum() == V**H
    assert len({tuple(r) for r in full.tokens.numpy()[live]}) == V**H
    order = np.argsort(-full.gumbel.numpy(), kind="stable")[:W]
    for f in ("tokens", "gumbel", "logp"):
        np.testing.assert_array_equal(getattr(full, f).numpy()[order],
                                      getattr(small, f).numpy(), f)


def test_sbs_logp_matches_teacher_forcing():
    m, p = _model(64)
    prompt = torch.tensor([3, 5, 7])
    out = structured.search(m, p, prompt, 42, structured.BeamConfig(
        n_beams=4, horizon=5, expand_k=64, l=16))
    emb = m._out_embed(p)[:64].float()
    for b in range(4):
        toks = torch.cat([prompt, out.tokens[b]])
        x = p["embed"][toks][None]
        pos = torch.arange(toks.shape[0])[None]
        h, _ = transformer.apply_trunk_prefill(p, m.cfg, x, pos,
                                               max_seq=int(toks.shape[0]))
        lsm = torch.log_softmax(h[0].float() @ emb.T, dim=-1)
        want = sum(float(lsm[len(prompt) - 1 + i, int(t)])
                   for i, t in enumerate(out.tokens[b]))
        assert abs(want - float(out.logp[b])) < 5e-3, (b, want)


@pytest.mark.parametrize("logz", ["exact", "amortized"])
def test_sbs_distinct_and_deterministic(logz):
    m, p = _model(64)
    bcfg = structured.BeamConfig(n_beams=4, horizon=6, expand_k=64, l=16,
                                 logz=logz, logz_l=16)
    a = structured.search(m, p, [3, 5], 1, bcfg)
    b = structured.search(m, p, [3, 5], 1, bcfg)
    c = structured.search(m, p, [3, 5], 2, bcfg)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.gumbel,
                                                           b.gumbel)
    assert not torch.equal(a.tokens, c.tokens)
    assert len({tuple(r) for r in a.tokens.tolist()}) == 4
    assert (torch.diff(a.gumbel) <= 0).all()


def test_map_contains_greedy_and_dominates():
    m, p = _model(64)
    prompt = [2, 4]
    out = structured.search(m, p, prompt, 0, structured.BeamConfig(
        n_beams=4, horizon=4, expand_k=64, mode="map"))
    assert (torch.diff(out.logp) <= 1e-6).all()
    assert bool(out.exact.all()) and float(out.ok_rate) == 1.0
    emb = m._out_embed(p)[:64].float()
    toks, lp = list(prompt), 0.0
    for _ in range(4):
        tt = torch.tensor(toks)
        h, _ = transformer.apply_trunk_prefill(
            p, m.cfg, p["embed"][tt][None],
            torch.arange(len(toks))[None], max_seq=len(toks))
        lsm = torch.log_softmax(h[0, -1].float() @ emb.T, dim=-1)
        nxt = int(torch.argmax(lsm))
        lp += float(lsm[nxt])
        toks.append(nxt)
    assert float(out.logp[0]) >= lp - 5e-3


def test_sbs_through_an_index():
    """The expansion through an index (IVF, LSH): beams distinct and live,
    repeatable; a full-probe IVF index is exhaustive and equals the exact
    expansion."""
    m, p = _model(256)
    emb = m._out_embed(p)[:256].float()
    bcfg = structured.BeamConfig(n_beams=4, horizon=4, expand_k=32, l=64)
    exact_run = structured.search(m, p, [7, 3], 5, bcfg)
    full = mips.build_index(mips.IVFConfig(n_clusters=8, n_probe=8,
                                           kmeans_iters=4), emb)
    ivf_run = structured.search(m, p, [7, 3], 5, bcfg, full)
    assert torch.equal(exact_run.tokens, ivf_run.tokens)
    lsh = mips.build_index(mips.LSHConfig(n_tables=8, n_bits=4), emb)
    a = structured.search(m, p, [7, 3], 5, bcfg, lsh)
    b = structured.search(m, p, [7, 3], 5, bcfg, lsh)
    assert torch.equal(a.tokens, b.tokens) and bool(a.live.all())


# --------------------------------------------------------------- launcher
def _run(*argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(list(argv))
    return json.loads(out.getvalue())


@pytest.mark.parametrize("mips_name", ["exact", "lsh"])
def test_launcher_dknn(mips_name):
    rep = _run("dknn", "--mips", mips_name, "--vocab", "256", "--train",
               "64", "--cal", "16", "--test", "16", "--device", "cpu")
    assert set(rep) == {"workload", "mips", "n_taps", "classes", "k",
                        "accuracy", "credibility_mean", "confidence_mean",
                        "credibility_p10", "p_value_spread"}
    assert rep["n_taps"] == get_smoke("tinyllama-1.1b").n_layers + 1
    assert 0.0 <= rep["accuracy"] <= 1.0


@pytest.mark.parametrize("flags", [("--mode", "sbs", "--mips", "ivf"),
                                   ("--mode", "map", "--logz", "amortized",
                                    "--mips", "lsh")])
def test_launcher_structured(flags):
    rep = _run("structured", "--vocab", "4096", "--horizon", "3",
               "--device", "cpu", *flags)
    assert set(rep) == {"workload", "mode", "mips", "beams", "horizon",
                        "tokens", "logp", "gumbel", "exact", "ok_rate",
                        "distinct"}
    assert rep["distinct"] == 4 and len(rep["tokens"]) == 4


def test_launcher_estimator():
    rep = _run("estimator", "--n", "2048", "--d", "16", "--queries", "4",
               "--k", "64", "--l", "64", "--tables", "16", "--bits", "4",
               "--device", "cpu")
    assert set(rep) == {"workload", "n", "queries", "alg3_rmse",
                        "lsh_sampler_rmse", "lsh_tables", "lsh_bits",
                        "lsh_dropped", "exact_logz_mean"}
    assert rep["lsh_dropped"] == 0
    assert np.isfinite(rep["alg3_rmse"]) and np.isfinite(
        rep["lsh_sampler_rmse"])


def test_launcher_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["estimator", "--n", "64", "--d", "8"])
