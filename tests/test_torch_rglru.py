"""The port's Griffin recurrent block (``repro_torch.models.rglru``) against
the JAX package's, on the same weights, at the smoke recurrentgemma-9b width
(d 64, lru 64, 8 gate blocks).

Tolerances: fp32 outputs and states rtol=atol=1e-4 (the doubling scan sums
in another order than ``lax.associative_scan``); conv tails rtol=atol=1e-6
(copies of matmul rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke as jget_smoke
from repro.models import rglru as jrg
from repro_torch.configs import get_smoke
from repro_torch.models import rglru

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "recurrentgemma-9b"


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_smoke(ARCH), get_smoke(ARCH)
    jp = jrg.init(jax.random.key(0), jcfg)
    tp = {k: _t(v) for k, v in jax.device_get(jp).items()}
    return jcfg, tcfg, jp, tp


def _x(seed, b, l, d, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (b, l, d))).astype(np.float32)


def test_scan_matches_a_sequential_recurrence():
    r = np.random.default_rng(0)
    a = _t(r.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32))
    b = _t(r.standard_normal((2, 37, 5)).astype(np.float32))
    h = torch.zeros(2, 5)
    want = []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(rglru.scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), **TOL)


@pytest.mark.parametrize("l", [1, 16, 33])
def test_forward_and_cache_match_jax(setup, l):
    jcfg, tcfg, jp, tp = setup
    x = _x(1, 2, l, jcfg.d_model)
    jout, jc = jrg.forward(jp, jcfg, jnp.asarray(x), return_cache=True)
    tout, tc = rglru.forward(tp, tcfg, _t(x), return_cache=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tc["state"].numpy(), np.asarray(jc["state"]),
                               **TOL)
    if l >= jcfg.conv_width - 1:  # the reference's tail of a shorter
        # prompt is narrower than its cache (it never prefills one)
        np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]),
                                   rtol=1e-6, atol=1e-6)


def test_forward_with_lengths_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    x = _x(2, 3, 16, jcfg.d_model)
    lengths = np.asarray([16, 5, 2], np.int32)
    jout, jc = jrg.forward(jp, jcfg, jnp.asarray(x), return_cache=True,
                           lengths=jnp.asarray(lengths))
    tout, tc = rglru.forward(tp, tcfg, _t(x), return_cache=True,
                             lengths=_t(lengths))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(tout[b, :n].numpy(),
                                   np.asarray(jout[b, :n]), **TOL)
    np.testing.assert_allclose(tc["state"].numpy(), np.asarray(jc["state"]),
                               **TOL)
    np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]),
                               rtol=1e-6, atol=1e-6)


def test_decode_after_prefill_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    x = _x(3, 2, 8, jcfg.d_model)
    _, jc = jrg.forward(jp, jcfg, jnp.asarray(x), return_cache=True)
    _, tc = rglru.forward(tp, tcfg, _t(x), return_cache=True)
    for step in range(3):
        xs = _x(10 + step, 2, 1, jcfg.d_model)
        jy, jc = jrg.decode(jp, jcfg, jnp.asarray(xs), jc)
        ty, tc = rglru.decode(tp, tcfg, _t(xs), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **TOL)


def test_gelu_is_the_tanh_approximation(setup, monkeypatch):
    """``jax.nn.gelu`` defaults to the tanh form: the port matches it, and
    the exact (erf) gelu, torch's default, would not at this tolerance."""
    jcfg, tcfg, jp, tp = setup
    x = _x(4, 2, 8, jcfg.d_model, scale=3.0)  # gate pre-activations ~±2
    want = np.asarray(jrg.forward(jp, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(rglru.forward(tp, tcfg, _t(x)).numpy(), want,
                               **TOL)
    monkeypatch.setattr(rglru, "_gelu", F.gelu)
    erf = rglru.forward(tp, tcfg, _t(x)).numpy()
    assert not np.allclose(erf, want, **TOL)


def test_cache_geometry_matches_jax(setup):
    jcfg, tcfg, _, _ = setup
    jc = jrg.init_cache(jcfg, 3, jnp.bfloat16)
    tc = rglru.init_cache(tcfg, 3, torch.bfloat16)
    for name in ("state", "conv"):
        assert tuple(tc[name].shape) == jc[name].shape
    assert (rglru.cache_bytes_per_slot(tcfg, torch.bfloat16)
            == jrg.cache_bytes_per_slot(jcfg, jnp.bfloat16))
