"""The port's learning-side estimator against the JAX package: the
``fused_estimator`` plain version against the Pallas kernel (interpret
mode), the forward's scores y and the backward from them, the complement
draw with its ``n_excluded`` rule, the S ∪ T candidates, the stratified
``log Ẑ`` with its gradients (plain and kernel paths), and ``head_loss``
in all three modes. JAX's randomness is passed in
as data: the tests derive the reference's per-token uniforms with its own
key splits (``estimators.py:779-805`` chunk keys, ``estimators.py:250-262``
per-token ``fold_in``, ``complement.py:53`` ``randint``) and hand them to
the port's ``draws=``.

Tolerances: ids exact; ``fused_estimator`` values rtol=1e-5, atol=1e-6
(XLA-CPU and torch sum the same terms in different orders); ``log Ẑ``,
losses and their gradients rtol=1e-4, atol=1e-6 (d-wide dot products and
the logsumexp reduced in different orders, then differentiated); the port's
kernel path against its plain path rtol=1e-5, atol=1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amortized_head as jah
from repro.core import complement as jcomplement
from repro.core import estimators as jest
from repro.core.gumbel import TopK as JTopK
from repro.kernels import ops as jops
from repro_torch import precision
from repro_torch.core import amortized_head as ah
from repro_torch.core import complement, estimators
from repro_torch.core.gumbel import TopK
from repro_torch.kernels import ops, ref

# one intra-op thread: the suite runs six workers on the same cores
torch.set_num_threads(1)

EST_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_tail_draws(key, t: int, chunk: int, l: int, hi) -> np.ndarray:
    """The reference's per-token tail uniforms for ``t`` tokens: one key per
    token chunk (``chunked_map``), ``fold_in`` of the row within its chunk
    (``amortized_candidates``), ``randint(0, hi)`` (``sample_complement``)."""
    ch = min(chunk, max(1, t))
    nck = -(-t // ch)
    hi = np.concatenate([np.asarray(hi, np.int32),
                         np.ones(nck * ch - t, np.int32)])
    keys = jax.random.split(key, nck)
    out = []
    for c in range(nck):
        kk = jax.vmap(jax.random.fold_in, (None, 0))(
            keys[c], jnp.arange(ch, dtype=jnp.uint32))
        u = jax.vmap(lambda k_, h_: jax.random.randint(
            k_, (l,), 0, h_, dtype=jnp.int32))(kk, jnp.asarray(
                hi[c * ch:(c + 1) * ch]))
        out.append(np.asarray(u))
    return np.concatenate(out)[:t]


def _estimator_case(seed=0, n=200, d=32, t=5, m=24, all_dead=True):
    r = np.random.default_rng(seed)
    emb = r.standard_normal((n, d)).astype(np.float32)
    ids = r.integers(0, n, (t, m)).astype(np.int32)
    h = (r.standard_normal((t, d)) / np.sqrt(d)).astype(np.float32)
    log_w = r.standard_normal((t, m)).astype(np.float32)
    log_w[0, ::3] = -np.inf  # dead slots
    if all_dead:
        log_w[3] = -np.inf  # an all-dead token
    return emb, ids, h, log_w


# ------------------------------------------------------- fused_estimator
def test_fused_estimator_ref_matches_pallas_kernel():
    """Plain version against the Pallas kernel (interpret mode), with dead
    slots and an all-dead token: the -1e30 running-max sentinel gives
    log_z = -inf and expv = NaN there, in both."""
    emb, ids, h, log_w = _estimator_case()
    want_z, want_v = jops.fused_estimator(*map(jnp.asarray,
                                               (emb, ids, h, log_w)))
    got_z, got_v = ref.fused_estimator_ref(*map(_t, (emb, ids, h, log_w)))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), **EST_TOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **EST_TOL)
    assert np.isneginf(got_z[3].item()) and np.isnan(got_v[3].numpy()).all()
    assert np.isfinite(got_z.numpy()[[0, 1, 2, 4]]).all()


def test_fused_estimator_bwd_ref_matches_jax_vjp():
    """The plain backward against the reference's custom VJP of the fused
    path (``_fused_logz_bwd``), cotangents of emb, h and log_w."""
    emb, ids, h, log_w = _estimator_case(1, all_dead=False)
    g = np.random.default_rng(2).standard_normal(ids.shape[0]).astype(
        np.float32)
    _, vjp = jax.vjp(lambda e, hh, lw: jest._fused_logz(e, jnp.asarray(ids),
                                                          hh, lw),
                     *map(jnp.asarray, (emb, h, log_w)))
    want_e, want_h, want_w = vjp(jnp.asarray(g))
    log_z, expv = ref.fused_estimator_ref(*map(_t, (emb, ids, h, log_w)))
    d_emb, p = ref.fused_estimator_bwd_ref(*map(_t, (emb, ids, h, log_w)),
                                           log_z, _t(g))
    np.testing.assert_allclose(d_emb.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(want_w), **TOL)
    np.testing.assert_allclose((_t(g)[:, None] * expv).numpy(),
                               np.asarray(want_h), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_stratified_logz_matches_jax(use_kernel):
    """Value and gradients w.r.t. emb and h, with -1 pads and dead slots."""
    emb, ids, h, log_w = _estimator_case(3, all_dead=False)
    ids[1, :4] = -1
    log_w[1, :4] = -np.inf
    g = np.random.default_rng(4).standard_normal(ids.shape[0]).astype(
        np.float32)

    def jloss(e, hh):
        lz = jest.stratified_logz(e, hh, jnp.asarray(ids), jnp.asarray(log_w),
                                  use_kernel=use_kernel)
        return jnp.sum(lz * g), lz

    (_, want_z), (want_de, want_dh) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(emb), jnp.asarray(h))
    te = _t(emb).requires_grad_(True)
    th = _t(h).requires_grad_(True)
    lz = estimators.stratified_logz(te, th, _t(ids).long(), _t(log_w),
                                    use_kernel=use_kernel)
    (lz * _t(g)).sum().backward()
    np.testing.assert_allclose(lz.detach().numpy(), np.asarray(want_z), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(want_de), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh), **TOL)


def test_fused_path_equals_unfused_path_in_port():
    """The kernel path (here: its plain versions behind the autograd
    Function) against the gather + logsumexp path: value and gradients
    w.r.t. emb, h and log_w."""
    emb, ids, h, log_w = _estimator_case(5, n=300, d=48, t=7, m=33,
                                         all_dead=False)
    g = _t(np.random.default_rng(6).standard_normal(7).astype(np.float32))
    outs = []
    for use_kernel in (False, True):
        te, th, tw = (_t(x).requires_grad_(True) for x in (emb, h, log_w))
        lz = estimators.stratified_logz(te, th, _t(ids).long(), tw,
                                        use_kernel=use_kernel)
        (lz * g).sum().backward()
        outs.append([lz.detach(), te.grad, th.grad,
                     tw.grad.nan_to_num(0.0)])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, **EST_TOL)


def test_ops_dispatch_cpu_to_plain_versions():
    emb, ids, h, log_w = map(_t, _estimator_case(7, all_dead=False))
    z1, v1 = ops.fused_estimator(emb, ids, h, log_w)
    z2, v2 = ref.fused_estimator_ref(emb, ids, h, log_w)
    assert torch.equal(z1, z2) and torch.equal(v1, v2)
    g = torch.ones(ids.shape[0])
    d1, p1 = ops.fused_estimator_bwd(emb, ids, h, log_w, z1, g)
    d2, p2 = ref.fused_estimator_bwd_ref(emb, ids, h, log_w, z1, g)
    assert torch.equal(d1, d2) and torch.equal(p1, p2)


def test_fused_estimator_ref_scores_match_jax():
    """The plain forward's scores y (``return_y=True``, what the backward
    takes) against the reference's: the gathered rows' dot with h plus
    log_w, -inf on exactly the dead slots; log_z and expv unchanged by the
    request."""
    emb, ids, h, log_w = _estimator_case(8)
    je, jh = jnp.asarray(emb), jnp.asarray(h)
    want = np.asarray(jnp.einsum("tmd,td->tm", je[jnp.asarray(ids)], jh)
                      + jnp.asarray(log_w))
    args = tuple(map(_t, (emb, ids, h, log_w)))
    log_z, expv, y = ref.fused_estimator_ref(*args, return_y=True)
    dead = np.isneginf(log_w)
    assert np.array_equal(np.isneginf(y.numpy()), dead)
    np.testing.assert_allclose(y.numpy()[~dead], want[~dead], **EST_TOL)
    z2, v2 = ref.fused_estimator_ref(*args)
    assert torch.equal(log_z, z2) and torch.equal(expv.nan_to_num(7.0),
                                                  v2.nan_to_num(7.0))


def test_fused_estimator_bwd_ref_from_scores():
    """The plain backward from the forward's scores against the reference's
    custom VJP (cotangents of emb and log_w) and, bit for bit, against the
    plain backward that re-scores the rows."""
    emb, ids, h, log_w = _estimator_case(9, n=120, d=24, t=6, m=30,
                                         all_dead=False)
    ids[2, 5:9] = ids[2, 4]  # repeats of one row within a token
    g = np.random.default_rng(10).standard_normal(ids.shape[0]).astype(
        np.float32)
    _, vjp = jax.vjp(lambda e, hh, lw: jest._fused_logz(e, jnp.asarray(ids),
                                                          hh, lw),
                     *map(jnp.asarray, (emb, h, log_w)))
    want_e, _, want_w = vjp(jnp.asarray(g))
    args = tuple(map(_t, (emb, ids, h, log_w)))
    log_z, _, y = ref.fused_estimator_ref(*args, return_y=True)
    d_emb, p = ref.fused_estimator_bwd_ref(*args, log_z, _t(g), y=y)
    np.testing.assert_allclose(d_emb.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(want_w), **TOL)
    d2, p2 = ref.fused_estimator_bwd_ref(*args, log_z, _t(g))
    assert torch.equal(d_emb, d2) and torch.equal(p, p2)


def test_fused_logz_backward_takes_forward_scores(monkeypatch):
    """``_FusedLogZ`` on the CPU (``use_kernel=True``) hands the forward's
    scores to the backward, and its value and gradients w.r.t. emb, h and
    log_w match the reference's kernel path, with -1 pads (no all-dead
    token: its NaN p would reach every row it names)."""
    emb, ids, h, log_w = _estimator_case(11, n=150, d=40, t=9, m=30,
                                         all_dead=False)
    ids[4, :6] = -1
    ids[7, 10:] = -1
    log_w[ids < 0] = -np.inf
    g = np.random.default_rng(12).standard_normal(ids.shape[0]).astype(
        np.float32)

    def jloss(e, hh, lw):
        lz = jest.stratified_logz(e, hh, jnp.asarray(ids), lw, use_kernel=True)
        return jnp.sum(lz * g), lz

    (_, want_z), want_grads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray,
                                                     (emb, h, log_w)))
    seen = []
    plain_bwd = ref.fused_estimator_bwd_ref

    def spy(*a, y=None):
        seen.append(y)
        return plain_bwd(*a, y=y)

    monkeypatch.setattr(ref, "fused_estimator_bwd_ref", spy)
    te, th, tw = (_t(x).requires_grad_(True) for x in (emb, h, log_w))
    lz = estimators.stratified_logz(te, th, _t(ids).long(), tw,
                                    use_kernel=True)
    (lz * _t(g)).sum().backward()
    assert len(seen) == 1 and seen[0] is not None
    assert seen[0].shape == ids.shape
    np.testing.assert_allclose(lz.detach().numpy(), np.asarray(want_z), **TOL)
    for got, want in zip((te.grad, th.grad, tw.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------- candidates (Alg 3)
def test_sample_complement_matches_jax_with_n_excluded():
    """Virtual entries >= n mark dead slots: they exclude nothing and the
    draw spans n - n_excluded elements, as the reference's rule has it."""
    n, num = 500, 40
    r = np.random.default_rng(8)
    s = np.sort(r.choice(n, 12, replace=False)).astype(np.int32)
    s = np.concatenate([s, n + np.arange(4, dtype=np.int32)])  # 4 dead
    key = jax.random.key(9)
    want = np.asarray(jcomplement.sample_complement(
        key, n, jnp.asarray(s), num, n_excluded=jnp.int32(12)))
    u = np.asarray(jax.random.randint(key, (num,), 0, n - 12,
                                      dtype=jnp.int32))
    got = complement.sample_complement(None, n, _t(s), num, n_excluded=12,
                                       u=_t(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.isin(want, s[:12]).any()


def test_amortized_candidates_match_jax():
    """S ∪ T ids exactly and stratum weights, with dead probe slots (id -1,
    value -inf) and a token whose probe came back empty."""
    n, k, l, t = 400, 16, 24, 6
    r = np.random.default_rng(10)
    ids = np.stack([r.choice(n, k, replace=False) for _ in range(t)]
                   ).astype(np.int32)
    vals = np.sort(r.standard_normal((t, k)).astype(np.float32), 1)[:, ::-1]
    vals = np.ascontiguousarray(vals)
    vals[1, -5:] = -np.inf
    ids[1, -5:] = -1
    vals[4] = -np.inf
    ids[4] = -1
    key = jax.random.key(11)
    want_ids, want_w = jest.amortized_candidates(
        key, JTopK(jnp.asarray(ids), jnp.asarray(vals)), n, l)
    kv = (~np.isneginf(vals)).sum(1)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        key, jnp.arange(t, dtype=jnp.uint32))
    u = np.asarray(jax.vmap(lambda k_, h_: jax.random.randint(
        k_, (l,), 0, h_, dtype=jnp.int32))(keys, jnp.asarray(
            np.maximum(n - kv, 1).astype(np.int32))))
    got_ids, got_w = estimators.amortized_candidates(
        TopK(_t(ids), _t(vals)), n, l, draws=_t(u))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


def test_amortized_candidates_keys_give_in_range_tail():
    """The port's own draws: tail ids avoid S and stay below n."""
    n, k, l, t = 300, 10, 50, 4
    r = np.random.default_rng(12)
    ids = torch.stack([torch.from_numpy(r.choice(n, k, replace=False))
                       for _ in range(t)])
    vals = torch.zeros((t, k))
    keys = torch.stack([torch.zeros(t, dtype=torch.long),
                        torch.zeros(t, dtype=torch.long),
                        torch.arange(t)], dim=-1)
    out, _ = estimators.amortized_candidates(TopK(ids, vals), n, l, keys=keys)
    tail = out[:, k:]
    assert (tail >= 0).all() and (tail < n).all()
    for i in range(t):
        assert not np.isin(tail[i].numpy(), ids[i].numpy()).any()


# ------------------------------------------------------------ head_loss
def _head_case(n=4096, d=32, t=70, seed=13):
    r = np.random.default_rng(seed)
    emb = (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    h = (2.0 * r.standard_normal((t, d))).astype(np.float32)
    tgt = r.integers(0, n, t).astype(np.int32)
    return emb, h, tgt


@pytest.mark.parametrize("mode", ["exact", "topk_only", "amortized"])
def test_head_loss_matches_jax(mode):
    """Per-token loss and log Ẑ, and the gradients of the mean loss
    w.r.t. emb and h, over three token chunks (the last one padded)."""
    emb, h, tgt = _head_case()
    n, chunk = emb.shape[0], 32
    jcfg = jah.HeadConfig(n=n, mode=mode, chunk=chunk)
    tcfg = ah.HeadConfig(n=n, mode=mode, chunk=chunk)
    key = jax.random.key(14)

    def jloss(e, hh):
        out = jah.head_loss(e, hh, jnp.asarray(tgt), key, jcfg)
        return out.loss.mean(), out

    (_, jout), (want_de, want_dh) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(emb), jnp.asarray(h))
    k = tcfg.resolved().k
    draws = _t(jax_tail_draws(key, len(tgt), chunk, tcfg.resolved().l,
                              np.full(len(tgt), n - k)))
    te = _t(emb).requires_grad_(True)
    th = _t(h).requires_grad_(True)
    out = ah.head_loss(te, th, _t(tgt), tcfg, draws=draws)
    out.loss.mean().backward()
    np.testing.assert_allclose(out.loss.detach().numpy(),
                               np.asarray(jout.loss), **TOL)
    np.testing.assert_allclose(out.log_z.detach().numpy(),
                               np.asarray(jout.log_z), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(want_de), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh), **TOL)


def test_head_loss_kernel_path_equals_plain_path_and_chunking():
    """Within the port: ``use_kernel`` (the fused estimator's autograd
    Function) equals the gather path, and with per-token keys the loss
    does not depend on the token chunk size."""
    emb, h, tgt = _head_case(t=50, seed=15)
    keys = torch.stack([torch.zeros(50, dtype=torch.long),
                        torch.full((50,), 3, dtype=torch.long),
                        torch.arange(50)], dim=-1)
    outs = []
    for use_kernel, chunk in ((False, 16), (True, 16), (False, 50)):
        cfg = ah.HeadConfig(n=emb.shape[0], chunk=chunk,
                            use_kernel=use_kernel)
        te, th = (_t(x).requires_grad_(True) for x in (emb, h))
        out = ah.head_loss(te, th, _t(tgt), cfg, keys=keys)
        out.loss.mean().backward()
        outs.append([out.loss.detach(), te.grad, th.grad])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            torch.testing.assert_close(b, a, **EST_TOL)


def test_head_loss_needs_randomness_for_amortized():
    emb, h, tgt = _head_case(t=4)
    with pytest.raises(ValueError, match="keys or draws"):
        ah.head_loss(_t(emb), _t(h), _t(tgt), ah.HeadConfig(n=4096))


def test_precision_policy_fp32_guards():
    with pytest.raises(ValueError, match="gradient accumulators"):
        precision.Policy("x", torch.bfloat16, grad_accum_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="master params"):
        precision.Policy("x", torch.bfloat16, param_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="estimator"):
        precision.Policy("x", torch.bfloat16, estimator_dtype=torch.float16)
    assert precision.BF16.score_dtype == "f32"
    assert ah.HeadConfig(n=8, score_dtype="bf16").score_dt == torch.bfloat16
