"""The dense attention decoders of ``configs/`` (tinyllama, stablelm,
granite, starcoder2) decoding like the JAX package's, as
``test_torch_families_decode.py`` holds the other families; Griffin's KV
ring wrapping past its local window of 32 (trunk hidden states and caches
against the reference's); hubert's ``encode`` against the reference's; and
the set of leaves ``compute_params`` casts to the compute dtype.

Tolerances: f32 policy; hidden states, caches and logits rtol=atol=1e-4;
sampled ids exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (TOL, batch_for, caches_close, cfgs,
                             decode_like_jax, t as _t)
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch.configs import ARCHS, get, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.models.model import Model

torch.set_num_threads(1)

DENSE = [a for a in ARCHS if get(a).has_decode and get(a).layer_pattern
         == "attn" and not get(a).is_moe and get(a).frontend == "none"]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_then_decode_sample_like_jax(arch):
    """tinyllama, stablelm, granite, starcoder2: prefill + three decode
    steps pick the reference's ids (:func:`decode_like_jax`)."""
    assert len(DENSE) == 4
    decode_like_jax(arch)


def test_hubert_encode_matches_jax():
    jcfg, tcfg = cfgs("hubert-xlarge")
    jm = JModel(jcfg, precision_policy="f32")
    jp = jm.init(jax.random.key(4))
    tp = params_from_jax(jax.device_get(jp), tcfg)
    batch = batch_for(tcfg, 2, 12, seed=4)
    want = np.asarray(jm.encode(jp, {"frames": jnp.asarray(batch["frames"])}))
    step = steps.make_encode_step(Model(tcfg, "f32", device="cpu"))
    got = step(tp, {"frames": _t(batch["frames"])})
    assert got.shape == (2, 12, tcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _cast_paths(arch):
    cfg = get_smoke(arch)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    run = transformer.compute_params(params, torch.bfloat16)
    out, kept = set(), set()

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        elif a is not None:
            (out if b.dtype == torch.bfloat16 else kept).add(path)
            assert a.dtype == torch.float32  # masters untouched

    walk(params, run, ())
    return params, out, kept


def test_compute_params_casts_the_attention_family_as_before():
    """tinyllama's cast set is the block matmul weights, every rank-3 block
    leaf (the rule the serving path used so far), and nothing else."""
    params, cast, _ = _cast_paths("tinyllama-1.1b")
    rank3 = {("blocks", 0, "0") + k for k in
             [("mix", "wq"), ("mix", "wk"), ("mix", "wv"), ("mix", "wo"),
              ("mlp", "w1"), ("mlp", "w2"), ("mlp", "w3")]}
    assert cast == rank3


@pytest.mark.parametrize("arch,fp32,bf16", [
    ("mamba2-780m", {"conv", "dt_bias", "a_log", "d_skip", "norm"},
     {"wx", "wz", "wb", "wc", "wdt", "wo"}),
    ("recurrentgemma-9b", {"conv", "lam", "w_a", "w_i"},
     {"w_gate_branch", "w_in", "w_out", "wq", "wk", "wv", "wo", "w1", "w2",
      "w3"}),
    ("qwen3-moe-30b-a3b", set(),
     {"router", "w1", "w2", "w3", "wq", "wk", "wv", "wo"}),
])
def test_compute_params_casts_by_role(arch, fp32, bf16):
    """The leaves the reference casts at use go to the compute dtype (the
    rank-4 expert weights too); those it reads in fp32 stay fp32 (the SSM
    and RG-LRU conv taps are read in fp32 at decode)."""
    _, cast, kept = _cast_paths(arch)
    assert {p[-1] for p in cast} == bf16
    names = {p[-1] for p in kept if p[0] == "blocks"}
    assert fp32 <= names and not names & bf16
    assert all(p[0] == "blocks" for p in cast)


@pytest.mark.parametrize("lengths", [None, (30, 40)],
                         ids=["ring-buffer", "padded"])
def test_griffin_ring_wraps_past_the_local_window(lengths):
    """Griffin's local attention keeps a ring of ``local_window`` (32 at the
    smoke size) positions: a 40-token prefill and decode steps past 32
    agree with the reference's hidden states and caches."""
    jcfg, tcfg = cfgs("recurrentgemma-9b")
    assert transformer.ring_len(tcfg, 64) == jtr.ring_len(jcfg, 64) == 32
    jp = JModel(jcfg, precision_policy="f32").init(jax.random.key(3))
    tp = params_from_jax(jax.device_get(jp), tcfg)
    b, lp, max_seq = 2, 40, 64
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (b, lp))
    x = np.asarray(jp["embed"])[tokens]
    pos = np.tile(np.arange(lp), (b, 1)).astype(np.int32)
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    jh, jc = jtr.apply_trunk_prefill(
        jp, jcfg, jnp.asarray(x), pos, max_seq=max_seq,
        lengths=None if ln is None else jnp.asarray(ln))
    th, tc = transformer.apply_trunk_prefill(
        tp, tcfg, _t(x), _t(pos), max_seq=max_seq,
        lengths=None if ln is None else _t(ln))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    caches_close(tc, jc)
    assert tc[0]["2"]["k"].shape[2] == 32  # the attention layer's ring
    p = np.full(b, lp, np.int32) if ln is None else ln.copy()
    r = np.random.default_rng(4)
    for _ in range(4):
        ids = r.integers(0, tcfg.vocab, b)
        xe = np.asarray(jp["embed"])[ids][:, None]
        jh, jc = jtr.apply_trunk_decode(jp, jcfg, jnp.asarray(xe), jc,
                                        jnp.asarray(p))
        th, tc = transformer.apply_trunk_decode(tp, tcfg, _t(xe), tc, _t(p))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        caches_close(tc, jc)
        p = p + 1
