"""Every family of ``configs/`` through the port's ``Model`` against the JAX
package's, on the same weights (``params_from_jax``), at the smoke widths:
dense attention, MoE (mixtral, qwen3-moe), Mamba-2 SSM, Griffin (rec, rec,
local attention), the vision stub (paligemma) and the audio encoder
(hubert).

Per arch: the port's own init has the reference's parameter structure and
shapes; ``loss_fn`` gives the reference's (nll, aux); gradients are finite
and reach every parameter; ``param_count`` / ``active_param_count`` equal
the JAX values at full size. Decoding is held in
``test_torch_families_decode.py`` and ``test_torch_families_dense.py``,
serving and the launchers in ``test_torch_families_serve.py``.

Tolerances: losses and aux under the f32 policy rtol=atol=1e-4; under the
bf16 policy, nll within 2e-2 nats and aux rtol=2e-2 (bf16 activations
rounded in different places by XLA-CPU and PyTorch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get as jget
from repro.configs import get_smoke as jget_smoke
from repro.models import model as jmodel_mod
from repro.models.model import Model as JModel
from repro_torch.configs import ARCHS, get, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import model as model_mod
from repro_torch.models import transformer
from repro_torch.models.model import Model

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(arch, **kw):
    return jget_smoke(arch).scaled(**kw), get_smoke(arch).scaled(**kw)


def _batch(cfg, b, l, seed=0, labels=True):
    r = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio_stub":
        out["frames"] = r.standard_normal((b, l, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = r.integers(0, cfg.vocab, (b, l)).astype(np.int32)
        if cfg.frontend == "vision_stub":
            out["patches"] = r.standard_normal(
                (b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if labels:
        out["labels"] = r.integers(0, cfg.vocab, (b, l)).astype(np.int32)
    return out


def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_shapes(v) for v in tree]
    return None if tree is None else tuple(tree.shape)


def test_archs_match_the_reference_registry():
    assert tuple(ARCHS) == tuple(JARCHS) and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_param_structure_and_loss_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jm = JModel(jcfg, precision_policy="f32")
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.device_get(jp), tcfg)
    own = transformer.init_params(torch.Generator().manual_seed(0), tcfg)
    assert _tree_shapes(own) == _tree_shapes(jax.device_get(jp))
    assert ("embed" in own) == (tcfg.frontend != "audio_stub")

    batch = _batch(tcfg, 2, 16)
    jl, jmet = jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(1))
    tm = Model(tcfg, "f32", device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    tl, tmet = tm.loss_fn(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tmet["nll"]), float(jmet["nll"]), **TOL)
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]), **TOL)
    assert (float(tmet["aux"]) > 0) == tcfg.is_moe

    # gradients: finite, and reaching every parameter
    diff = [t.detach().requires_grad_(True) for t in _leaves(tp)]
    it = iter(diff)
    loss, _ = tm.loss_fn(_map(lambda _: next(it), tp), tb)
    gs = torch.autograd.grad(loss, diff, allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in gs)

    # the bf16 policy within its band
    jl16, jm16 = JModel(jcfg).loss_fn(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    tl16, tm16 = Model(tcfg, device="cpu").loss_fn(tp, tb)
    assert abs(float(tm16["nll"]) - float(jm16["nll"])) < 2e-2
    np.testing.assert_allclose(float(tm16["aux"]), float(jm16["aux"]),
                               rtol=2e-2)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax_at_full_size(arch):
    assert model_mod.param_count(get(arch)) == jmodel_mod.param_count(
        jget(arch))
    assert (model_mod.active_param_count(get(arch))
            == jmodel_mod.active_param_count(jget(arch)))
