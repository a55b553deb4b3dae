"""Blocks computed whole on every rank of ``model`` where ``tp`` does not
divide their heads or gate blocks (``models/tp.py::replicated``), held on
the CPU against the reference's single-device JAX functions on the same
weights (the reference's init, converted):

* attention whose query heads ``tp`` does not divide: a tinyllama-like
  smoke model with 6 query heads on 2 KV heads at tp 4 — the exact-head
  loss, ``d_x`` and every leaf's gradient block (``wq`` split mid-head by
  the reference's spec, so the gather's backward keeps a rank's block of
  the whole gradient), and a prefill and decode steps past the ring's
  length on its position-split ring (2 KV heads do not divide 4 either):
  each step's hidden state and each rank's positions of the final cache;
* an RG-LRU layer at tp 3 (8 gate blocks): forward, ``d_x``, each rank's
  gradient blocks, and two decode steps with the ``state`` split over
  ``model`` as the reference's cache placement splits it.

Tolerance: fp32, rtol = atol = 1e-4 (the per-family tests').
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_trunk import TOL, _check_grads, _reference, jax_decode
from repro.configs import get_smoke as jget_smoke
from repro.models import rglru as jrg
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as mesh_lib

torch.set_num_threads(1)

ATTN_KW = dict(n_heads=6, n_kv_heads=2, head_dim=16, head_mode="exact")
RG_KW = dict(lru_width=48)


@pytest.fixture(scope="module")
def attn_tp4(tmp_path_factory):
    cfg = get_smoke("tinyllama-1.1b").scaled(**ATTN_KW)
    jcfg = jget_smoke("tinyllama-1.1b").scaled(**ATTN_KW)
    ref = _reference("tinyllama-1.1b", 3, **ATTN_KW)
    params = ref["params"]
    r = np.random.default_rng(3)
    dec = {"arch": "tinyllama-1.1b", "kw": ATTN_KW, "params": params,
           "max_seq": 8, "block_len": 4, "n_blocks": 0,
           "tokens": r.integers(0, cfg.vocab, (2, 3)).astype(np.int64),
           "lengths": np.array([3, 2], np.int64),
           "next_ids": r.integers(0, cfg.vocab, (7, 2)).astype(np.int64)}
    spec = {"loss": {"rep": {"arch": "tinyllama-1.1b", "kw": ATTN_KW,
                             "params": params, "batch": ref["batch"]}}}
    d = tmp_path_factory.mktemp("rep")
    loss = td.spawn(td.trunk_cases, d, 1, 4, spec)
    dec_out = td.spawn(td.ring_decode_cases, d, 1, 4, {"rep": dec})
    return cfg, jcfg, ref, dec, loss, dec_out


def test_attention_heads_not_dividing_tp_grads(attn_tp4):
    cfg, _, ref, _, loss, _ = attn_tp4
    mesh = mesh_lib.Mesh(1, 4, 0, None, None, None)
    wq = mesh_lib.param_spec(["blocks", "0", "0", "mix", "wq"],
                             (cfg.n_layers, cfg.d_model, cfg.d_attn), mesh,
                             cfg)
    assert wq[-1] == "model" and cfg.n_heads % 4  # split mid-head
    _check_grads(loss, ref, "rep", 1, 4, cfg)


def test_attention_heads_not_dividing_tp_decode(attn_tp4):
    _, jcfg, _, dec, _, dec_out = attn_tp4
    want_h, want_cache = jax_decode(jcfg, dec["params"], dec)
    assert max(dec["lengths"]) + len(dec["next_ids"]) > dec["max_seq"]
    n = dec["max_seq"] // 4
    for rank, o in enumerate(dec_out):
        got = o["rep"]
        assert len(got["h"]) == len(want_h)
        for i, (a, b) in enumerate(zip(got["h"], want_h)):
            np.testing.assert_allclose(a, b, **TOL,
                                       err_msg=f"rank {rank} step {i}")
        for k in ("k", "v"):
            c = got["cache"][0]["0"][k]
            assert c.shape[2] == n  # positions split
            np.testing.assert_allclose(
                c, np.asarray(want_cache[0]["0"][k])[:, :, rank * n:
                                                     (rank + 1) * n],
                **TOL, err_msg=f"rank {rank} cache {k}")


def _rglru_reference(jcfg, spec):
    """The reference's RG-LRU layer on ``spec``: the forward, the gradients
    of sum(out * w) with respect to x and to every leaf, then the decode
    steps from the forward's cache."""
    jp = {k: jnp.asarray(v[0]) for k, v in spec["params"].items()}
    w = jnp.asarray(spec["w"])

    def f(p, x):
        out, cache = jrg.forward(p, jcfg, x, return_cache=True)
        return (out * w).sum(), (out, cache)

    (_, (out, cache)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(spec["x"]))
    dec = []
    for xd in spec["x_dec"]:
        o, cache = jrg.decode(jp, jcfg, jnp.asarray(xd), cache)
        dec.append(np.asarray(o))
    return {"out": np.asarray(out), "d_x": np.asarray(gx),
            "grads": {k: np.asarray(g) for k, g in gp.items()}, "dec": dec,
            "cache": {k: np.asarray(v) for k, v in cache.items()}}


def test_rglru_gate_blocks_not_dividing_tp(tmp_path):
    cfg = get_smoke("recurrentgemma-9b").scaled(**RG_KW)
    jcfg = jget_smoke("recurrentgemma-9b").scaled(**RG_KW)
    params = {k: np.asarray(v)[None] for k, v in jax.device_get(
        jrg.init(jax.random.key(5), jcfg)).items()}  # stacked: one layer
    r = np.random.default_rng(5)
    b, l = 2, 6
    spec = {"kw": RG_KW, "params": params,
            "x": r.standard_normal((b, l, cfg.d_model)).astype(np.float32),
            "w": r.standard_normal((b, l, cfg.d_model)).astype(np.float32),
            "x_dec": [r.standard_normal((b, 1, cfg.d_model)).astype(
                np.float32) for _ in range(2)]}
    ranks = td.spawn(td.rglru_rep_case, tmp_path, 1, 3, spec)
    one = _rglru_reference(jcfg, spec)
    mesh = mesh_lib.Mesh(1, 3, 0, None, None, None)
    w = cfg.lru_dim // 3
    assert cfg.lru_dim % 3 == 0 and 8 % 3  # the gate blocks do not divide
    for rank, o in enumerate(ranks):
        np.testing.assert_allclose(o["out"], one["out"], **TOL)
        np.testing.assert_allclose(o["d_x"], one["d_x"], **TOL)
        assert set(o["grads"]) == set(one["grads"])
        for k, g in o["grads"].items():
            sp = mesh_lib.param_spec([k], params[k].shape, mesh, cfg)[1:]
            d = mesh_lib.shard_dim(sp)
            want = one["grads"][k]
            if d is not None:
                n = g.shape[d]
                want = np.take(want, range(rank * n, (rank + 1) * n), d)
            np.testing.assert_allclose(g, want, **TOL, err_msg=k)
        for a, bb in zip(o["dec"], one["dec"]):
            np.testing.assert_allclose(a, bb, **TOL)
        np.testing.assert_allclose(
            o["cache"]["state"], one["cache"]["state"][:, rank * w:
                                                       (rank + 1) * w],
            **TOL)
        np.testing.assert_allclose(o["cache"]["conv"], one["cache"]["conv"],
                                   **TOL)
