"""The port's sort-dispatched MoE (``repro_torch.models.moe``) against the JAX
package's ``moe.forward``, on the same weights, at the smoke
qwen3-moe-30b-a3b width (d 64, 8 experts, top-2, expert d_ff 64).

The reference's dispatch indices are recomputed in JAX with the lines of
``repro/models/moe.py`` (``lax.top_k``, ``jnp.argsort``, ``searchsorted``),
and the port's must equal them exactly: the top-k ids, the sort ``order``,
the source tokens, each assignment's rank, ``keep`` and slot. Cases: a
plain batch, one that overflows capacity, right-padded rows whose pads take
capacity from real tokens (the reference's semantics), and bf16 router ties
(duplicated router columns) that must break toward the lower expert.

Tolerances: indices exact; fp32 outputs and aux rtol=atol=1e-4; bf16
outputs rtol=2e-2 with an atol of 2e-2 times the largest magnitude (about
two bf16 ulps of it) and aux rtol=1e-3 (bf16 products and sums rounded in
different places by XLA-CPU and PyTorch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke
from repro_torch.models import moe

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen3-moe-30b-a3b"


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_dispatch(p, cfg, x):
    """The reference's routing and dispatch indices (repro/models/moe.py,
    ``forward``'s lines, single device)."""
    t = x.shape[0]
    e, kx = cfg.n_experts, cfg.experts_per_token
    cap = jmoe._capacity(cfg, t)
    logits = (x @ p["router"].astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, kx)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, jnp.arange(e), side="left")
    rank = jnp.arange(t * kx) - seg_start[sorted_e]
    keep = rank < cap
    out = dict(idx=idx, order=order, sorted_e=sorted_e, tok=order // kx,
               rank=rank, keep=keep, slot=jnp.where(keep, rank, cap))
    return {k: np.asarray(v) for k, v in out.items()}, cap


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_smoke(ARCH), get_smoke(ARCH)
    jp = jmoe.init(jax.random.key(0), jcfg)
    tp = {k: _t(v) for k, v in jax.device_get(jp).items()}
    return jcfg, tcfg, jp, tp


def _check(jcfg, tcfg, jp, tp, x, dtype=np.float32):
    """Indices exact, output and aux close; returns the port's routing."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(x).to(tdt)
    want, cap = _jax_dispatch(jp, jcfg, jx)
    got = moe.route(tp, tcfg, tx)
    assert got["cap"] == cap
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    jout, jaux = jmoe.forward(jp, jcfg, jx)
    tout, taux = moe.forward(tp, tcfg, tx)
    assert tout.dtype == tdt
    if dtype == "bf16":
        w = np.asarray(jout.astype(jnp.float32))
        np.testing.assert_allclose(tout.float().numpy(), w, rtol=2e-2,
                                   atol=2e-2 * np.abs(w).max())
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-3)
    else:
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    return got


def test_capacity_matches_jax(setup):
    jcfg, tcfg, _, _ = setup
    for t in (1, 4, 13, 64, 100, 2048):
        assert moe.capacity(tcfg, t) == jmoe._capacity(jcfg, t)
    big = get_smoke(ARCH).scaled(n_experts=128, experts_per_token=8)
    jbig = jget_smoke(ARCH).scaled(n_experts=128, experts_per_token=8)
    for t in (4, 2048, 1000):
        assert moe.capacity(big, t) == jmoe._capacity(jbig, t)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["f32", "bf16"])
def test_dispatch_and_output_match_jax(setup, dtype):
    jcfg, tcfg, jp, tp = setup
    x = np.random.default_rng(1).standard_normal((24, jcfg.d_model)).astype(
        np.float32)
    _check(jcfg, tcfg, jp, tp, x, dtype)


def test_capacity_overflow_matches_jax(setup):
    """Tokens crowd onto two experts: assignments past capacity ride in the
    trash slot, and the port drops exactly the reference's."""
    jcfg, tcfg, jp, tp = setup
    r = np.random.default_rng(2)
    w = np.asarray(jp["router"])
    pull = (w[:, 0] + w[:, 1]) * 40.0  # towards experts 0 and 1
    x = (r.standard_normal((64, jcfg.d_model)) * 0.1 + pull).astype(
        np.float32)
    got = _check(jcfg, tcfg, jp, tp, x)
    assert (~got["keep"]).sum() > 0


def test_pad_tokens_take_capacity_like_jax(setup):
    """Two right-padded rows: row 0's pads sit before row 1's tokens in the
    flattened batch, route like any token and take capacity from row 1's
    real tokens, as in the reference (not "fixed")."""
    jcfg, tcfg, jp, tp = setup
    r = np.random.default_rng(3)
    w = np.asarray(jp["router"])
    pull = (w[:, 2] + w[:, 5]) * 40.0
    lp = 16
    x = (r.standard_normal((2, lp, jcfg.d_model)) * 0.1 + pull).astype(
        np.float32)
    got = _check(jcfg, tcfg, jp, tp, x.reshape(-1, jcfg.d_model))
    real_only = _check(jcfg, tcfg, jp, tp,
                       np.concatenate([x[0, :3], x[1]], 0))
    tok_kept = lambda g: g["tok"][g["keep"].numpy()].numpy()  # noqa: E731
    row1_with_pads = (tok_kept(got) >= lp).sum()
    row1_alone = (tok_kept(real_only) >= 3).sum()
    assert row1_with_pads < row1_alone


def test_bf16_router_ties_break_to_the_lower_expert(setup):
    """Identical router columns give bitwise-equal bf16 logits: the top-k
    keeps the lower expert ids, as ``lax.top_k`` does."""
    jcfg, tcfg, jp, tp = setup
    w = np.asarray(jp["router"]).copy()
    w[:, 3] = w[:, 6] = w[:, 1]
    w[:, 7] = w[:, 4]
    jp2 = dict(jp, router=jnp.asarray(w))
    tp2 = dict(tp, router=_t(w))
    r = np.random.default_rng(4)
    x = (r.standard_normal((32, jcfg.d_model)) + w[:, 1] * 30.0).astype(
        np.float32)
    got = _check(jcfg, tcfg, jp2, tp2, x, "bf16")
    assert (got["idx"] == 1).any() and (got["idx"] == 3).any()
    assert not (got["idx"] == 6).any()


def test_forward_is_deterministic(setup):
    _, tcfg, _, tp = setup
    x = _t(np.random.default_rng(6).standard_normal((40, 64)).astype(
        np.float32)).bfloat16()
    a, _ = moe.forward(tp, tcfg, x)
    b, _ = moe.forward(tp, tcfg, x)
    assert torch.equal(a, b)


def test_trace_records_drops_and_load(setup):
    _, tcfg, _, tp = setup
    x = _t(np.random.default_rng(7).standard_normal((16, 64)).astype(
        np.float32))
    moe.TRACE = []
    try:
        moe.forward(tp, tcfg, x)
        (rec,) = moe.TRACE
    finally:
        moe.TRACE = None
    assert rec["assigned"] == 16 * tcfg.experts_per_token
    assert int(rec["load"].sum()) == rec["assigned"]
    assert 0 <= int(rec["dropped"]) <= rec["assigned"]
