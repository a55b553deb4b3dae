"""The port's cross-shard combines (``repro_torch.core.estimators``
``combine_sample_pmax`` and ``combine_loss_psum``, over the mesh's model
axis on spawned gloo ranks) against the reference's, run in-process under
``jax.vmap(..., axis_name="model")`` over the same per-shard stacked
inputs.

Sample ids and ``ok`` exactly equal, at mp 2 and 4, with near-ties, an
all-tie case (the smaller global id wins) and failed certificates; the
loss and its gradient in the per-shard partials at fp32 allclose (rtol
1e-6, atol 1e-6), in the amortized (logsumexp) and topk_only modes. The
reference's gradient is taken from one replica's output: the vmapped sum
would count it mp times.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from repro.core import estimators as jest

torch.set_num_threads(1)

T = 24
TOL = dict(rtol=1e-6, atol=1e-6)


def _sample_case(rng, mp, tie=False):
    gid = np.stack([rng.integers(0, 100, T) + 100 * s
                    for s in range(mp)]).astype(np.int64)
    if tie:
        val = np.full((mp, T), 1.5, np.float32)
    else:
        val = rng.normal(size=(mp, T)).astype(np.float32)
        val[:, :4] = val[0, :4]  # exact ties across shards
    bound = (val.max(0)[None] - rng.uniform(-0.3, 0.5, (mp, T))).astype(
        np.float32)
    ok = rng.uniform(size=(mp, T)) > 0.1
    return {"kind": "sample", "gid": gid, "val": val, "bound": bound,
            "ok": ok}


def _loss_case(rng, mp, mode):
    log_z = rng.normal(2.0, 1.5, (mp, T)).astype(np.float32)
    owner = rng.integers(0, mp, T)
    y_t = np.where(np.arange(mp)[:, None] == owner[None],
                   rng.normal(size=(mp, T)), 0.0).astype(np.float32)
    return {"kind": "loss", "mode": mode, "log_z": log_z, "y_t": y_t,
            "w": rng.uniform(0.5, 1.5, T).astype(np.float32)}


def _jax_sample(c):
    def fn(g, v, b, o):
        return jest.combine_sample_pmax(g, v, b, o, "model")

    ids, ok = jax.vmap(fn, axis_name="model")(
        jnp.asarray(c["gid"], jnp.int32), jnp.asarray(c["val"]),
        jnp.asarray(c["bound"]), jnp.asarray(c["ok"]))
    return np.asarray(ids[0]), np.asarray(ok[0])


def _jax_loss(c):
    mode = c["mode"]

    def one(lz, yt):
        return jest.combine_loss_psum(jest.LossPartials(lz, yt), mode,
                                      "model")

    def obj(lz, yt):
        loss = jax.vmap(one, axis_name="model")(lz, yt)
        return (loss[0] * jnp.asarray(c["w"])).sum(), loss[0]

    (_, loss), (d_lz, d_yt) = jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True)(jnp.asarray(c["log_z"]),
                                           jnp.asarray(c["y_t"]))
    return np.asarray(loss), np.asarray(d_lz), np.asarray(d_yt)


@pytest.fixture(scope="module", params=[2, 4])
def run(request, tmp_path_factory):
    mp = request.param
    rng = np.random.default_rng(mp)
    cases = [_sample_case(rng, mp), _sample_case(rng, mp, tie=True),
             _loss_case(rng, mp, "amortized"), _loss_case(rng, mp, "exact"),
             _loss_case(rng, mp, "topk_only")]
    outs = td.spawn(td.combine_cases, tmp_path_factory.mktemp("comb"), 1,
                    mp, cases)
    return mp, cases, outs


def test_sample_pmax_exact(run):
    mp, cases, outs = run
    for i in (0, 1):
        ids, ok = _jax_sample(cases[i])
        for o in outs:
            np.testing.assert_array_equal(o[i]["ids"], ids)
            np.testing.assert_array_equal(o[i]["ok"], ok)


def test_sample_pmax_all_tie(run):
    """Every shard's value equal: the smallest global id wins, on every
    rank."""
    mp, cases, outs = run
    want = cases[1]["gid"].min(0)
    for o in outs:
        np.testing.assert_array_equal(o[1]["ids"], want)


@pytest.mark.parametrize("i", [2, 3, 4], ids=["amortized", "exact",
                                              "topk_only"])
def test_loss_psum_and_grad(run, i):
    mp, cases, outs = run
    loss, d_lz, d_yt = _jax_loss(cases[i])
    for m, o in enumerate(outs):
        np.testing.assert_allclose(o[i]["loss"], loss, **TOL)
        np.testing.assert_allclose(o[i]["d_log_z"], d_lz[m], **TOL)
        np.testing.assert_allclose(o[i]["d_y_t"], d_yt[m], **TOL)
