"""The port's serving tier beyond the dense fifo engine, on ``device="cpu"``:
strict exact re-sampling, the single-step reference engine, the slo
scheduler, ``refresh_index``, the adaptive probe in the head and the server,
and the engine's admission and observability cases of the reference's
``tests/test_serve.py`` that apply to the attention family (the launcher's
new flags are in ``tests/test_torch_serve.py``).

Against the JAX package: ``local_gumbel_max(adaptive=True)`` with the
reference's own random numbers injected (``draws=``) gives the index, ok
and width of the reference's unfused adaptive path, on IVF and IVF-PQ.
Inside the port, bit for bit: the reference engine ≡ the pipelined one;
slo ≡ fifo streams under staggered arrivals; fused T=8 ≡ unfused T=1 with
the adaptive probe; a refresh with unchanged params leaves the index and
the tokens unchanged once the clustering has converged (a refresh of an unconverged
one moves its members, so the candidate sets and the tokens change).
Strict is held three ways: certified rows keep the amortized id,
failed live rows take ``gumbel_max_dense`` on the strict stream, and a
chi-square test against the softmax (significance 1e-3 per assertion, as
tests/test_sampling_stats.py) passes where the certificate fails often.

Tolerances: ids, widths, flags and tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core import estimators as jest
from repro.core import mips as jmips
from repro_torch.configs import get_smoke
from repro_torch.convert import ivf_state_from_jax, pq_state_from_jax
from repro_torch.core import amortized_head as ah
from repro_torch.core import estimators, mips, rng
from repro_torch.core.gumbel import default_m_cap, gumbel_max_dense
from repro_torch.launch.steps import slot_keys
from repro_torch.models.model import Model
from repro_torch.serve.server import ServeConfig, Server

# one intra-op thread: the suite runs six workers on the same cores
torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
ALPHA = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


_MODELS: dict = {}


def _mk(vocab=512, **scale):
    key = (vocab, tuple(sorted(scale.items())))
    if key not in _MODELS:
        cfg = get_smoke(ARCH).scaled(vocab=vocab, **scale)
        _MODELS[key] = (cfg, Model(cfg, "f32", device="cpu").init(0))
    return _MODELS[key]


def _server(cfg, params, index=None, **kw):
    return Server(cfg, params, ServeConfig(**kw), precision_policy="f32",
                  device="cpu", index=index)


def _prompts(cfg, n, lo=3, hi=11, seed=0):
    r = np.random.default_rng(seed)
    return [list(r.integers(0, cfg.vocab, size=int(r.integers(lo, hi))))
            for _ in range(n)]


# --------------------------------------------------- reference engine
@pytest.mark.parametrize("head,vocab", [("exact", 512), ("amortized", 4096)])
def test_engine_matches_reference_bitwise(head, vocab):
    """Batched prefill + decode windows sample the SAME tokens as the
    teacher-forced one-step-per-token loop: keys derive from (request,
    position), so batching and windows cannot shift randomness."""
    cfg, params = _mk(vocab, head_mode=head)
    prompts = _prompts(cfg, 5)
    outs = {}
    index = None
    for eng, window in (("reference", 1), ("pipelined", 8)):
        srv = _server(cfg, params, index, batch_slots=2, max_seq=64,
                      max_new_tokens=6, seed=7, engine=eng,
                      decode_window=window)
        index = srv.index
        rs = srv.run(prompts)
        assert all(len(r.tokens) == 6 for r in rs)
        outs[eng] = ([r.tokens for r in rs], [r.ok_rate for r in rs])
    assert outs["reference"] == outs["pipelined"]


def test_single_step_serving_steps_agree_with_the_engine_steps():
    """``make_prefill_step`` (equal-length prompts, a fresh cache) samples
    the first tokens ``prefill_into_cache`` samples for the same keys and
    builds the same rings; ``make_serve_step`` and the reference engine's
    step decode what ``decode_step`` decodes."""
    from repro_torch.launch import steps

    cfg, params = _mk(4096, head_mips="ivf")
    srv = _server(cfg, params, batch_slots=3, max_seq=32, max_new_tokens=4)
    model, rp = srv.model, srv.run_params
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4096, (3, 6)))
    rids = torch.tensor([4, 0, 9])
    keys = slot_keys(3, rids, torch.full((3,), 5))
    nxt, ok, pos, cache = steps.make_prefill_step(model, 32)(
        rp, {"tokens": tokens}, keys, srv.index)
    into = model.init_cache(3, 32)
    want, want_ok, into = model.prefill_into_cache(
        rp, into, tokens, torch.full((3,), 6), torch.arange(3), keys, 32,
        srv.index)
    assert torch.equal(nxt, want) and torch.equal(ok, want_ok)
    assert pos.tolist() == [6, 6, 6]
    for name in ("k", "v"):
        assert torch.equal(cache[0]["0"][name], into[0]["0"][name])
    keys = slot_keys(3, rids, pos)
    c1 = [{"0": {n: t.clone() for n, t in cache[0]["0"].items()}}]
    a, a_ok, _, a_pos = steps.make_serve_step(model)(rp, c1, nxt, pos, keys,
                                                    srv.index)
    c2 = [{"0": {n: t.clone() for n, t in cache[0]["0"].items()}}]
    b, b_ok, _, b_pos, width = steps.make_reference_serve_step(model)(
        rp, c2, nxt, pos, rids, 3, srv.index)
    d, d_ok, _, _ = model.decode_step(rp, cache, nxt, pos, srv.index,
                                      keys=keys)
    assert torch.equal(a, d) and torch.equal(b, d)
    assert torch.equal(a_ok, d_ok) and torch.equal(b_ok, d_ok)
    assert a_pos.tolist() == b_pos.tolist() == [7, 7, 7]
    assert width.tolist() == [-1, -1, -1]  # a fixed-width probe


def test_slot_recycling_and_eos_match_reference():
    """Many requests through 2 slots, and EOS freeing slots early: the
    engine and the reference loop agree token for token."""
    cfg, params = _mk(32)
    prompts = _prompts(cfg, 8, lo=2, hi=6, seed=5)
    kw = dict(batch_slots=2, max_seq=64, max_new_tokens=24, eos_id=7, seed=2)
    rs = _server(cfg, params, decode_window=4, **kw).run(prompts)
    rs2 = _server(cfg, params, engine="reference", **kw).run(prompts)
    assert [r.request_id for r in rs] == list(range(8))
    assert [r.tokens for r in rs] == [r.tokens for r in rs2]
    assert any(len(r.tokens) < 24 for r in rs)
    for r in rs:
        if len(r.tokens) < 24:  # stopped early => at EOS, and only there
            assert r.tokens[-1] == 7
        assert 7 not in r.tokens[:-1]


# --------------------------------------------------- admission control
def test_overlength_prompt_truncated_and_rejected():
    cfg, params = _mk()
    kw = dict(batch_slots=2, max_seq=32, max_new_tokens=8, seed=4)
    cap = 32 - 8
    long_prompt = list(np.random.default_rng(0).integers(0, 512, size=60))
    short = _prompts(cfg, 1, lo=4, hi=5)[0]
    rs = _server(cfg, params, **kw).run([long_prompt, short])
    assert all(r.status == "ok" for r in rs)
    assert len(rs[0].tokens) == 8 and rs[0].prompt_len == cap
    rs_pre = _server(cfg, params, **kw).run([long_prompt[-cap:], short])
    assert rs[0].tokens == rs_pre[0].tokens
    rs_ref = _server(cfg, params, engine="reference", **kw).run(
        [long_prompt, short])
    assert rs_ref[0].tokens == rs[0].tokens
    srv = _server(cfg, params, overlength="reject", **kw)
    rs = srv.run([long_prompt, [1, 2, 3], []])
    assert [r.status for r in rs] == ["rejected", "ok", "rejected"]
    assert rs[0].tokens == [] and rs[2].tokens == []
    assert srv.stats["rejected"] == 2


def test_length_budget_and_config_validation():
    cfg, params = _mk()
    with pytest.raises(ValueError):  # max_new >= max_seq: unsatisfiable
        _server(cfg, params, batch_slots=1, max_seq=16, max_new_tokens=64)
    for bad in (dict(engine="warp"), dict(overlength="explode"),
                dict(decode_window=0), dict(sched="edf")):
        with pytest.raises(ValueError):
            _server(cfg, params, **bad)
    srv = _server(cfg, params, batch_slots=1, max_seq=16, max_new_tokens=8)
    (r,) = srv.run([list(range(14))])  # truncated to cap = 8
    assert r.prompt_len == 8 and len(r.tokens) == 8


def test_latency_fields_and_stats():
    cfg, params = _mk()
    srv = _server(cfg, params, batch_slots=2, max_seq=64, max_new_tokens=6,
                  decode_window=3)
    rs = srv.run(_prompts(cfg, 4))
    for r in rs:
        assert r.ttft_s > 0.0 and r.itl_ms >= 0.0
        assert r.latency_s >= r.ttft_s and r.prompt_len >= 1
    st = srv.stats
    assert st["prefill_tokens"] == sum(r.prompt_len for r in rs)
    assert st["tokens"] == sum(len(r.tokens) for r in rs)
    assert st["steps"] < st["tokens"]  # windows: fewer dispatches than tokens


# ----------------------------------------------------------- slo scheduler
def test_slo_equals_fifo_under_staggered_arrivals():
    """The slo scheduler reorders admission and shrinks windows under TTFT
    pressure; tokens are a function of (request, position) alone, so the
    streams equal fifo's. A TTFT target of 1 ms is blown at once, so slo
    picks the 1-token window while requests wait and the full one when
    none do."""
    cfg, params = _mk()
    prompts = _prompts(cfg, 6, seed=3)
    arrivals = [0.0, 0.0, 0.02, 0.04, 0.06, 0.08]
    kw = dict(batch_slots=2, max_seq=48, max_new_tokens=8, seed=3,
              decode_window=8)
    fifo = _server(cfg, params, **kw)
    slo = _server(cfg, params, sched="slo", ttft_slo_s=1e-3, **kw)
    picked = []
    pick = slo.sched.pick_window

    def spy(*a):
        picked.append(pick(*a))
        return picked[-1]

    slo.sched.pick_window = spy
    r_f = fifo.run(prompts, arrivals=arrivals)
    r_s = slo.run(prompts, arrivals=arrivals, priorities=[1, 0, 1, 0, 1, 0])
    assert [r.tokens for r in r_f] == [r.tokens for r in r_s]
    assert slo._windows == [1, 2, 8]
    assert {1, 8} <= set(picked)
    for r in r_s:
        assert r.queue_time_s >= 0.0 and r.ttft_s >= r.queue_time_s


# -------------------------------------------------------- refresh_index
@pytest.mark.parametrize("mips_kind", ["ivf", "ivfpq"])
def test_refresh_index_with_same_params_keeps_tokens(mips_kind):
    """A refresh is a warm-started Lloyd rebuild: over an unchanged table
    whose clustering has converged (30 Lloyd iterations here; the default
    build's 10 have not, so a refresh moves its centroids and members, and
    the probed candidate sets, hence the tokens, change) it is a fixed
    point: the same index state bit for bit, so the same tokens. Either
    way the refresh keeps the geometry and the index health fields."""
    cfg, params = _mk(4096, head_mips=mips_kind)
    prompts = _prompts(cfg, 3, seed=6)
    kw = dict(batch_slots=2, max_seq=32, max_new_tokens=5, seed=1,
              decode_window=4)
    a = _server(cfg, params, **kw)
    default = a.index
    a.refresh_index()
    assert all(x.shape == y.shape for x, y in zip(default.state,
                                                  a.index.state)
               if isinstance(x, torch.Tensor))
    assert a.stats["index_bytes"] == default.memory_bytes() > 0
    assert a.stats["index_spill"] == 0
    over = dict(kmeans_iters=30)
    if mips_kind == "ivfpq":
        over["pq_iters"] = 30
    db = a.model.head_index_db(params)
    converged = mips.build_index(
        dataclasses.replace(default.config, **over), db)
    b = _server(cfg, params, converged, **kw)
    c = _server(cfg, params, converged, **kw)
    c.refresh_index(params)  # a params push of the same params
    assert c.index is not converged
    for x, y in zip(converged.state, c.index.state):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    assert [r.tokens for r in b.run(prompts)] == [
        r.tokens for r in c.run(prompts)]


# -------------------------------------------------------------- strict
def _strict_problem(seed, n=512, d=16, k=64, l=4):
    """A head whose lazy sampler fails its certificate often: l = 4 tail
    draws at n = 512 leave the tail's cutoff B = log((n - k) / l) high."""
    r = np.random.default_rng(seed)
    emb = torch.from_numpy((r.standard_normal((n, d)) / np.sqrt(d))
                           .astype(np.float32))
    h = torch.from_numpy(r.standard_normal(d).astype(np.float32))
    cfg = ah.HeadConfig(n=n, k=k, l=l, mips="exact", min_amortized_n=0)
    return emb, h, cfg


def test_strict_keeps_certified_ids_and_takes_the_exact_fallback():
    emb, h, cfg = _strict_problem(0)
    t = 400
    hh = h[None].expand(t, -1) + 0.5 * torch.randn(
        (t, h.shape[0]), generator=torch.Generator().manual_seed(1))
    rids = torch.arange(t)
    keys = slot_keys(5, rids, torch.zeros_like(rids))
    lazy = ah.head_sample(emb, hh, cfg, keys=keys)
    strict = ah.head_sample(emb, hh, cfg, keys=keys, strict=True)
    ok = lazy.ok
    assert 0.05 < float((~ok).float().mean()) < 0.95  # fails often
    assert torch.equal(strict.index[ok], lazy.index[ok])
    assert torch.equal(strict.ok, lazy.ok)
    exact = gumbel_max_dense(keys, hh @ emb.T, stream=rng.STREAM_STRICT)
    assert torch.equal(strict.index[~ok], exact[~ok])
    # the strict stream is not the exact head's
    dense = gumbel_max_dense(keys, hh @ emb.T)
    assert not torch.equal(dense[~ok], exact[~ok])
    # no live row failed: nothing is re-sampled (the reference's cond)
    none_live = ah.head_sample(emb, hh, cfg, keys=keys, strict=True,
                               strict_live=torch.zeros(t, dtype=torch.bool))
    assert torch.equal(none_live.index, lazy.index)
    live = torch.zeros(t, dtype=torch.bool)
    live[int(torch.nonzero(~ok)[0])] = True  # one live failure: all rerun
    one_live = ah.head_sample(emb, hh, cfg, keys=keys, strict=True,
                              strict_live=live)
    assert torch.equal(one_live.index, strict.index)


def _chi2_pvalue(counts: np.ndarray, p: np.ndarray) -> float:
    """Chi-square GOF p-value with the tail merged so every expected count
    is >= 5 (tests/test_sampling_stats.py)."""
    n = counts.sum()
    order = np.argsort(p)[::-1]
    counts, p = counts[order], p[order]
    exp = n * p
    keep = np.where(exp >= 5)[0]
    cut = len(keep) if len(keep) == len(exp) else max(1, keep[-1] + 1)
    obs = np.concatenate([counts[:cut], [counts[cut:].sum()]])
    ex = np.concatenate([exp[:cut], [exp[cut:].sum()]])
    obs, ex = obs[ex > 0], ex[ex > 0]
    stat = ((obs - ex) ** 2 / ex).sum()
    return float(stats.chi2.sf(stat, df=len(ex) - 1))


@pytest.mark.parametrize("seed", (0, 1))
def test_strict_sampler_matches_softmax(seed):
    """10,000 strict samples of one query against the exact softmax, on a
    problem where a large share of the lazy draws fail their certificate."""
    emb, h, cfg = _strict_problem(seed)
    y = (emb @ h).double().numpy()
    p = np.exp(y - y.max())
    p /= p.sum()
    ids, fails = [], []
    for c in range(4):
        rids = torch.arange(c * 2500, (c + 1) * 2500)
        keys = slot_keys(seed + 300, rids, torch.zeros_like(rids))
        res = ah.head_sample(emb, h[None].expand(2500, -1), cfg, keys=keys,
                             strict=True)
        ids.append(res.index.numpy())
        fails.append((~res.ok).numpy())
    assert np.concatenate(fails).mean() > 0.05
    pv = _chi2_pvalue(np.bincount(np.concatenate(ids), minlength=len(p)), p)
    assert pv > ALPHA, f"strict sampler deviates from softmax: p={pv:.2e}"


def test_strict_serving_matches_strict_reference_engine():
    cfg, params = _mk(4096, head_mode="amortized", head_k=64, head_l=4)
    prompts = _prompts(cfg, 3)
    kw = dict(batch_slots=2, max_seq=64, max_new_tokens=6, seed=9,
              strict=True)
    srv = _server(cfg, params, decode_window=4, **kw)
    rs = srv.run(prompts)
    ref = _server(cfg, params, srv.index, engine="reference", **kw)
    assert [r.tokens for r in rs] == [r.tokens for r in ref.run(prompts)]
    st = srv.stats
    assert st["fallbacks"] == st["tokens"] - st["ok"] > 0
    lazy = _server(cfg, params, srv.index, decode_window=4,
                   **dict(kw, strict=False))
    # rows whose certificate held sample the same ids with or without strict
    # until the first re-sampled token changes the stream that follows
    for a, b in zip(rs, lazy.run(prompts)):
        assert a.tokens[0] == b.tokens[0] or a.ok_rate < 1.0


# -------------------------------------------------------- adaptive probe
def _jax_draws(keys, k, l, m_cap, n, kv):
    """The raw numbers JAX's sample_fixed_b draws from each token's key."""

    def one(key, kvi):
        k_s, k_t = jax.random.split(key)
        g_s = jax.random.gumbel(k_s, (k,), dtype=jnp.float32)
        k_m, k_pos, k_h = jax.random.split(k_t, 3)
        m = jax.random.poisson(k_m, jnp.float32(l), dtype=jnp.int32)
        hi = jnp.maximum(jnp.asarray(n, jnp.int32) - kvi, 1)
        u = jax.random.randint(k_pos, (m_cap,), 0, hi, dtype=jnp.int32)
        e = jax.random.exponential(k_h, (m_cap,), dtype=jnp.float32)
        return g_s, m, u, e

    g_s, m, u, e = jax.vmap(one)(keys, kv)
    return rng.Draws(_t(g_s), _t(m).long(), _t(u).long(), _t(e))


_ADAPTIVE: dict = {}


def _adaptive_case(kind):
    """The reference's adaptive sample over a JAX-built index, and what the
    port needs to repeat it: its index on the same state, the queries and
    the reference's draws (built once per index kind)."""
    if kind in _ADAPTIVE:
        return _ADAPTIVE[kind]
    r = np.random.default_rng(4)
    n, d, t, k, l = 4096, 32, 24, 64, 64
    centers = r.standard_normal((32, d))
    db = centers[r.integers(0, 32, n)] + 0.3 * r.standard_normal((n, d))
    db = (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)
    temps = np.repeat([0.05, 0.5, 4.0], t // 3)
    h = (db[r.integers(0, n, t)] / temps[:, None]).astype(np.float32)
    kw = dict(n_clusters=32, kmeans_iters=4, n_probe=8, n_probe_init=1,
              n_probe_max=16)
    if kind == "ivf":
        jindex = jmips.build_index(jmips.IVFConfig(**kw), jnp.asarray(db))
        index = mips.IVFIndex(mips.IVFConfig(**kw), ivf_state_from_jax(
            jax.device_get(jindex.state)))
    else:
        pkw = dict(kw, m_sub=4, pq_iters=4, rerank=2 * k)
        jindex = jmips.build_index(jmips.PQConfig(**pkw), jnp.asarray(db))
        index = mips.IVFPQIndex(mips.PQConfig(**pkw), pq_state_from_jax(
            jax.device_get(jindex.state), _t(db)))
    keys = jax.random.split(jax.random.key(13), t)
    want = jest.local_gumbel_max(None, jnp.asarray(db), jnp.asarray(h), k=k,
                                 l=l, index=jindex, keys=keys, adaptive=True)
    atk = jindex.topk_adaptive(jnp.asarray(h), k)
    ok = atk.ids >= 0
    topk = jest.TopK(atk.ids, jnp.where(ok, atk.values, -jnp.inf))
    _, kv = jest.sanitize_topk(topk, n)
    draws = _jax_draws(keys, k, l, default_m_cap(l), n, kv)
    _ADAPTIVE[kind] = (db, h, k, l, index, draws, jax.device_get(want))
    return _ADAPTIVE[kind]


@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_adaptive_local_gumbel_max_matches_jax(kind, fused):
    """Same index state, same queries, the reference's draws: the port's
    adaptive head (unfused, and fused on the screens' plain versions) picks
    the reference's unfused adaptive ids, certificates and widths."""
    db, h, k, l, index, draws, want = _adaptive_case(kind)
    got = estimators.local_gumbel_max(_t(db), _t(h), k=k, l=l, index=index,
                                      draws=draws, adaptive=True,
                                      fused=fused)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_array_equal(got.width.numpy(), np.asarray(want.width))
    assert len(np.unique(np.asarray(want.width))) >= 2


@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
def test_adaptive_serving_fused_equals_unfused(kind):
    """Fused T=8 (the screens at per-row widths) ≡ unfused T=1 (the pool
    masked to each width), on one index: tokens and width histograms."""
    cfg, params = _mk(4096, head_mips=kind, head_adaptive_probe=True,
                      head_n_probe_init=2, head_n_probe_max=16)
    prompts = _prompts(cfg, 4, seed=8)
    kw = dict(batch_slots=2, max_seq=32, max_new_tokens=6, seed=2)
    fused = _server(cfg.scaled(head_fused_decode=True), params,
                    decode_window=8, **kw)
    unfused = _server(cfg, params, fused.index, decode_window=1, **kw)
    r_f, r_u = fused.run(prompts), unfused.run(prompts)
    assert [r.tokens for r in r_f] == [r.tokens for r in r_u]
    hist = fused.stats["probe_width_hist"]
    assert hist == unfused.stats["probe_width_hist"]
    assert sum(hist.values()) == 4 * 5 and set(hist) <= {2, 4, 8, 16}


def test_head_config_adaptive_reaches_the_index():
    hc = ah.HeadConfig(n=4096, mips="ivfpq", adaptive_probe=True,
                       n_probe_init=2, n_probe_max=16).resolved()
    emb = torch.randn((4096, 16), generator=torch.Generator().manual_seed(0))
    index = ah.make_index(hc, emb, device="cpu")
    assert (index.config.n_probe_init, index.config.n_probe_max) == (2, 16)
    with pytest.raises(ValueError, match="clustered"):
        ah.HeadConfig(n=4096, mips="exact", adaptive_probe=True).resolved()
