"""Shared helpers of the trunk-on-the-mesh tests
(``test_torch_dist_trunk.py``, ``test_torch_dist_fsdp.py``,
``test_torch_dist_ring.py``, ``test_torch_dist_rep.py``): the reference's
exact-head loss of a family with its gradients, the comparison of each
rank's gradient blocks with it, and the reference's single-device serving
trunk (a prefill, then decode steps).

Tolerance: fp32, rtol = atol = 1e-4 (the per-family tests').
"""
import jax
import jax.numpy as jnp
import numpy as np

import repro.models.transformer as jtr
from repro.configs import get_smoke as jget_smoke
from repro.core import amortized_head as jah
from repro.models.model import Model as JModel
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as ttr

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ["tinyllama-1.1b", "mamba2-780m", "recurrentgemma-9b",
            "qwen3-moe-30b-a3b"]
B, L = 2, 16


def _key_str(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _batch(cfg, seed):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab, (B, L)).astype(np.int32),
            "labels": r.integers(0, cfg.vocab, (B, L)).astype(np.int32)}


def _reference(arch, seed, **kw):
    """The reference's exact-head loss, its gradient with respect to the
    embedded input, and the gradient of every leaf (the smoke config
    scaled by ``kw``)."""
    jcfg = jget_smoke(arch).scaled(**{"head_mode": "exact", **kw})
    jm = JModel(jcfg, precision_policy="f32")
    params = jm.init(jax.random.key(seed))
    batch = _batch(jcfg, seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(1)

    def total(p, dx):
        x, pos, prefix = jm._embed_inputs(p, jb)
        h, aux = jtr.apply_trunk(p, jcfg, x + dx, pos, prefix=prefix)
        h2 = h.reshape(-1, h.shape[-1])
        t2 = jb["labels"].reshape(-1)
        loss = jah.head_loss(p["out_embed"], h2, t2, key, jm.head_cfg).loss
        return loss.mean() + 0.01 * aux

    dx0 = jnp.zeros((B, L, jcfg.d_model), jnp.float32)
    loss, (gp, gx) = jax.jit(jax.value_and_grad(total, argnums=(0, 1)))(
        params, dx0)
    grads = {_key_str(p): np.asarray(g)
             for p, g in jax.tree_util.tree_flatten_with_path(gp)[0]}
    return {"params": jax.device_get(params), "batch": batch,
            "loss": float(loss), "d_x": np.asarray(gx), "grads": grads}


def jax_decode(jcfg, jp, spec):
    """The reference's single-device trunk on ``spec``'s right-padded
    prompts (``tokens``, ``lengths``) into a cache of ``max_seq``, then a
    decode step for each row of ``next_ids`` -> (the hidden state of each
    step, the final cache)."""
    emb = jnp.asarray(jp["embed"])
    lengths = jnp.asarray(spec["lengths"], jnp.int32)
    tokens = jnp.asarray(spec["tokens"])
    b, l = tokens.shape
    pos = jnp.broadcast_to(jnp.arange(l), (b, l))
    h, cache = jtr.apply_trunk_prefill(jp, jcfg, emb[tokens], pos,
                                       max_seq=spec["max_seq"],
                                       lengths=lengths)
    hs = [np.asarray(h[jnp.arange(b), lengths - 1])]
    p = lengths
    for ids in spec["next_ids"]:
        h, cache = jtr.apply_trunk_decode(jp, jcfg, emb[ids][:, None],
                                          cache, p)
        hs.append(np.asarray(h[:, 0]))
        p = p + 1
    return hs, jax.device_get(cache)


def _block(full, dims, coords, shape):
    """The block of ``full`` a rank at ``coords`` ({axis: index}) holds."""
    for a, d in dims.items():
        n = shape[d]
        full = full[(slice(None),) * d + (slice(coords[a] * n,
                                                (coords[a] + 1) * n),)]
    return full


def _check_grads(outs, refs, arch, dp, tp, cfg):
    mesh = mesh_lib.Mesh(dp, tp, 0, None, None, None)
    want = refs["grads"]
    for rank, o in enumerate(outs):
        got = o["loss"][arch]
        coords = {"data": rank // tp, "model": rank % tp}
        np.testing.assert_allclose(got["loss"], refs["loss"], **TOL)
        np.testing.assert_allclose(got["d_x"], refs["d_x"], **TOL)
        assert set(got["grads"]) == set(want)
        for path, g in got["grads"].items():
            dims = mesh_lib.spec_dims(ttr.spec_of(path.split("/"), mesh, cfg))
            w = _block(want[path], dims, coords, g.shape)
            if "data" in dims:  # reduce-scattered over two equal batches
                w = w * dp
            np.testing.assert_allclose(g, w, **TOL, err_msg=path)


