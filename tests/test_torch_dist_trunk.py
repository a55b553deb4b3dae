"""The trunk on the mesh, on spawned gloo CPU ranks, at the smoke widths:
every leaf stored as ``launch.mesh.param_spec`` places it, every block
computing the single-device function.

* tp 2 — tinyllama (attention, SwiGLU), mamba2 (the SSD block),
  recurrentgemma (RG-LRU and local attention on ONE KV head: the KV
  projections gathered, the ring replicated) and qwen3-moe (the experts
  split): the exact-head loss, its gradient with respect to the embedded
  input (``d_x``) and each rank's block of the gradient of every leaf,
  against the reference's single-device JAX functions on the same weights
  and batch at the per-family tolerance (fp32, rtol = atol = 1e-4);
  (dp 2 × tp 2, the FSDP half, is ``test_torch_dist_fsdp.py``);
* leaves stored whole over ``model`` that each rank uses only a share of
  (RG-LRU gate blocks of odd width, SSM B / C projections of odd state):
  every rank's gradient the whole single-device one;
* tied embeddings (tinyllama, ``embed`` both the vocab-parallel lookup and
  the head) and hubert's ``encode`` (each rank's vocab slice of the logits
  gathered) on tp 2 against the port on one device;
* serving's trunk on tp 2: a right-padded batched prefill into the cache,
  then three decode steps, dense and paged (block_len 8, permuted blocks),
  for tinyllama, recurrentgemma and mamba2 — the hidden state of every
  step and each rank's block of the final cache against one device.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_trunk import (B, FAMILIES, L, TOL, _batch, _block, _check_grads,
                          _reference)
from repro.configs import get_smoke as jget_smoke
from repro.models.model import Model as JModel
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as ttr
from repro_torch.models.model import Model

torch.set_num_threads(1)


# widths at which a leaf each rank uses only its share of is stored whole
# over "model" (its split dim odd): the RG-LRU gate blocks (width 3) and
# the SSM's B / C projections (state 15)
WHOLE = {"recurrentgemma-9b": {"lru_width": 24},
         "mamba2-780m": {"ssm_state": 15}}


def _decode_spec(arch, seed, paged):
    cfg = get_smoke(arch).scaled(head_mode="exact")
    r = np.random.default_rng(seed)
    params = jax.device_get(JModel(jget_smoke(arch).scaled(
        head_mode="exact"), precision_policy="f32").init(
        jax.random.key(seed)))
    max_seq, bl = 32, 8
    n_pages = max_seq // bl
    tokens = r.integers(0, cfg.vocab, (B, 16)).astype(np.int64)
    return {"arch": arch, "params": params, "paged": paged,
            "max_seq": max_seq, "block_len": bl, "n_blocks": B * n_pages,
            "pages": r.permutation(B * n_pages).reshape(B, n_pages),
            "tokens": tokens, "lengths": np.array([16, 11], np.int64),
            "next_ids": r.integers(0, cfg.vocab, (3, B)).astype(np.int64)}


def _own_params(arch, seed, **kw):
    """The port's own init of ``arch`` (with ``kw``) as numpy."""
    cfg = get_smoke(arch).scaled(head_mode="exact", **kw)
    p = Model(cfg, "f32", device="cpu").init(seed)

    def np_(t):
        if isinstance(t, dict):
            return {k: np_(v) for k, v in t.items()}
        if isinstance(t, list):
            return [np_(v) for v in t]
        return None if t is None else t.numpy()
    return np_(p)


@pytest.fixture(scope="module")
def cases():
    refs = {arch: _reference(arch, i) for i, arch in enumerate(FAMILIES)}
    spec = {"loss": {a: {"arch": a, "kw": {"head_mode": "exact"},
                         "params": r["params"], "batch": r["batch"]}
                     for a, r in refs.items()}}
    tied = _own_params("tinyllama-1.1b", 5, tie_embeddings=True)
    spec["loss"]["tied"] = {
        "arch": "tinyllama-1.1b",
        "kw": {"head_mode": "exact", "tie_embeddings": True},
        "params": tied, "batch": _batch(get_smoke("tinyllama-1.1b"), 5)}
    for i, (arch, kw) in enumerate(WHOLE.items()):
        spec["loss"][f"whole/{arch}"] = {
            "arch": arch, "kw": dict(kw, head_mode="exact"),
            "params": _own_params(arch, 11 + i, **kw),
            "batch": _batch(get_smoke(arch), 11 + i)}
    r = np.random.default_rng(9)
    hub = get_smoke("hubert-xlarge")
    spec["encode"] = {"arch": "hubert-xlarge",
                      "params": _own_params("hubert-xlarge", 9),
                      "frames": r.standard_normal(
                          (B, L, hub.d_model)).astype(np.float32)}
    spec["decode"] = {f"{a}/{'paged' if p else 'dense'}": _decode_spec(a, 3, p)
                      for a in ("tinyllama-1.1b", "recurrentgemma-9b",
                                "mamba2-780m")
                      for p in ((False, True) if a != "mamba2-780m"
                                else (False,))}
    return refs, spec


@pytest.fixture(scope="module")
def tp2(tmp_path_factory, cases):
    _, spec = cases
    return td.spawn(td.trunk_cases, tmp_path_factory.mktemp("trunk_tp2"),
                    1, 2, spec)


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp2_loss_and_grads_match_reference(arch, cases, tp2):
    refs, _ = cases
    cfg = get_smoke(arch).scaled(head_mode="exact")
    _check_grads(tp2, refs[arch], arch, 1, 2, cfg)


def test_tied_embeddings_on_tp2(cases, tp2):
    _, spec = cases
    c = spec["loss"]["tied"]
    cfg = get_smoke("tinyllama-1.1b").scaled(**c["kw"])
    one = td.trunk_loss_case(None, cfg, c["params"], c["batch"])
    assert "out_embed" not in "".join(one["grads"])
    _check_grads(tp2, {"loss": one["loss"], "d_x": one["d_x"],
                       "grads": one["grads"]}, "tied", 1, 2, cfg)


@pytest.mark.parametrize("arch", sorted(WHOLE))
def test_tp2_grads_of_leaves_stored_whole(arch, cases, tp2):
    """A leaf stored whole over "model" whose use is shard-local enters
    through ``copy_to``: every rank's gradient is the whole one."""
    _, spec = cases
    c = spec["loss"][f"whole/{arch}"]
    cfg = get_smoke(arch).scaled(**c["kw"])
    one = td.trunk_loss_case(None, cfg, c["params"], c["batch"])
    mesh = mesh_lib.Mesh(1, 2, 0, None, None, None)
    names = ("w_a", "w_i") if arch == "recurrentgemma-9b" else ("wb", "wc")
    whole = [p for p in one["grads"] if p.rsplit("/", 1)[-1] in names]
    assert whole and all(
        "model" not in mesh_lib.spec_dims(ttr.spec_of(p.split("/"), mesh,
                                                      cfg))
        for p in whole)
    _check_grads(tp2, {"loss": one["loss"], "d_x": one["d_x"],
                       "grads": one["grads"]}, f"whole/{arch}", 1, 2, cfg)


def test_encode_on_tp2(cases, tp2):
    _, spec = cases
    c = spec["encode"]
    cfg = get_smoke(c["arch"]).scaled(head_mode="exact")
    want = Model(cfg, "f32", device="cpu").encode(
        params_from_jax(c["params"], cfg),
        {"frames": torch.from_numpy(c["frames"])}).numpy()
    assert want.shape == (B, L, cfg.vocab)
    for o in tp2:
        np.testing.assert_allclose(o["encode"], want, **TOL)


@pytest.mark.parametrize("name", ["tinyllama-1.1b/dense",
                                  "tinyllama-1.1b/paged",
                                  "recurrentgemma-9b/dense",
                                  "recurrentgemma-9b/paged",
                                  "mamba2-780m/dense"])
def test_tp2_decode_matches_one_device(name, cases, tp2):
    _, spec = cases
    c = spec["decode"][name]
    cfg = get_smoke(c["arch"]).scaled(head_mode="exact")
    one = td.trunk_decode_case(None, cfg, c["params"], c, c["paged"])
    meta = ttr.init_cache(cfg, B, c["max_seq"], torch.float32,
                          device="meta",
                          paged=(ttr.PagedLayout(c["block_len"], c["n_blocks"])
                                 if c["paged"] else None))
    mesh = mesh_lib.Mesh(1, 2, 0, None, None, None)
    specs = mesh_lib.cache_shardings(meta, mesh, cfg, paged=c["paged"])
    for rank, o in enumerate(tp2):
        got = o["decode"][name]
        for a, b in zip(got["h"], one["h"]):
            np.testing.assert_allclose(a, b, **TOL)
        for g, (gg, og) in enumerate(zip(got["cache"], one["cache"])):
            for j in og:
                for k, full in og[j].items():
                    dims = {a: d for a, d in mesh_lib.spec_dims(
                        specs[g][j][k]).items() if a == "model"}
                    loc = gg[j][k]
                    np.testing.assert_allclose(
                        loc, _block(full, dims, {"model": rank}, loc.shape),
                        **TOL, err_msg=f"{name} cache {g}/{j}/{k}")
