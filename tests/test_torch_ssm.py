"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) against the JAX
package's, on the same weights, at the smoke mamba2-780m width (d 64, 8
heads of 16, state 16), plus ``layers.masked_conv_tail``.

Tolerances: fp32 outputs and states rtol=atol=1e-4 (the SSD einsums reduce
in different orders in XLA-CPU and PyTorch); the conv tails, which are
copies of projection rows, and ``masked_conv_tail`` exactly (the tails at
rtol=atol=1e-6: the projections are matmuls on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke
from repro_torch.models import layers, ssm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mamba2-780m"


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_smoke(ARCH), get_smoke(ARCH)
    jp = jssm.init(jax.random.key(0), jcfg)
    # a non-trivial decay and skip: the reference initializes them to 0 / 1
    r = np.random.default_rng(5)
    jp = dict(jp, a_log=jnp.asarray(r.uniform(-1, 1, jcfg.ssm_heads),
                                    jnp.float32),
              dt_bias=jnp.asarray(r.uniform(-2, 1, jcfg.ssm_heads),
                                  jnp.float32),
              d_skip=jnp.asarray(r.uniform(0, 2, jcfg.ssm_heads),
                                 jnp.float32))
    tp = {k: _t(v) for k, v in jax.device_get(jp).items()}
    return jcfg, tcfg, jp, tp


def _x(seed, b, l, d):
    return np.random.default_rng(seed).standard_normal((b, l, d)).astype(
        np.float32)


def test_masked_conv_tail_matches_jax():
    r = np.random.default_rng(0)
    x = r.standard_normal((4, 9, 5)).astype(np.float32)
    lengths = np.asarray([1, 3, 9, 2], np.int32)
    want = jlayers.masked_conv_tail(jnp.asarray(x), jnp.asarray(lengths), 3)
    got = layers.masked_conv_tail(_t(x), _t(lengths), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("l,chunk", [(16, 128), (32, 8)],
                         ids=["one-chunk", "four-chunks"])
def test_forward_and_cache_match_jax(setup, l, chunk):
    jcfg, tcfg, jp, tp = setup
    x = _x(1, 2, l, jcfg.d_model)
    jout, jc = jssm.forward(jp, jcfg, jnp.asarray(x), chunk=chunk,
                            return_cache=True)
    tout, tc = ssm.forward(tp, tcfg, _t(x), chunk=chunk, return_cache=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tc["state"].numpy(), np.asarray(jc["state"]),
                               **TOL)
    np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]),
                               rtol=1e-6, atol=1e-6)
    # the plain forward is the cached one's output
    np.testing.assert_array_equal(
        ssm.forward(tp, tcfg, _t(x), chunk=chunk).numpy(), tout.numpy())


def test_forward_with_lengths_matches_jax(setup):
    """Right-padded rows: the state passes pads unchanged, the conv tail is
    each row's last valid window."""
    jcfg, tcfg, jp, tp = setup
    x = _x(2, 3, 16, jcfg.d_model)
    lengths = np.asarray([16, 5, 2], np.int32)
    jout, jc = jssm.forward(jp, jcfg, jnp.asarray(x), return_cache=True,
                            lengths=jnp.asarray(lengths))
    tout, tc = ssm.forward(tp, tcfg, _t(x), return_cache=True,
                           lengths=_t(lengths))
    for b, n in enumerate(lengths):  # pad outputs are unused garbage
        np.testing.assert_allclose(tout[b, :n].numpy(),
                                   np.asarray(jout[b, :n]), **TOL)
    np.testing.assert_allclose(tc["state"].numpy(), np.asarray(jc["state"]),
                               **TOL)
    np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]),
                               rtol=1e-6, atol=1e-6)
    # row 1's state equals an unpadded prefill of its 5 tokens
    _, short = ssm.forward(tp, tcfg, _t(x[1:2, :5]), return_cache=True)
    np.testing.assert_allclose(tc["state"][1:2].numpy(),
                               short["state"].numpy(), **TOL)


def test_decode_after_prefill_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    x = _x(3, 2, 8, jcfg.d_model)
    _, jc = jssm.forward(jp, jcfg, jnp.asarray(x), return_cache=True)
    _, tc = ssm.forward(tp, tcfg, _t(x), return_cache=True)
    for step in range(3):
        xs = _x(10 + step, 2, 1, jcfg.d_model)
        jy, jc = jssm.decode(jp, jcfg, jnp.asarray(xs), jc)
        ty, tc = ssm.decode(tp, tcfg, _t(xs), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **TOL)


def test_decode_continues_the_prefill(setup):
    """Prefill of L+1 tokens ≡ prefill of L then one decode step (the O(1)
    update is the chunked scan's recurrence)."""
    _, tcfg, _, tp = setup
    x = _t(_x(4, 2, 9, tcfg.d_model))
    full, fc = ssm.forward(tp, tcfg, x, return_cache=True, chunk=9)
    _, c = ssm.forward(tp, tcfg, x[:, :8], return_cache=True)
    y, c = ssm.decode(tp, tcfg, x[:, 8:], c)
    np.testing.assert_allclose(y.numpy(), full[:, 8:].numpy(), **TOL)
    np.testing.assert_allclose(c["state"].numpy(), fc["state"].numpy(), **TOL)


def test_cache_geometry_matches_jax(setup):
    jcfg, tcfg, _, _ = setup
    jc = jssm.init_cache(jcfg, 3, jnp.bfloat16)
    tc = ssm.init_cache(tcfg, 3, torch.bfloat16)
    for name in ("state", "conv"):
        assert tuple(tc[name].shape) == jc[name].shape
    assert tc["state"].dtype == torch.float32
    assert (ssm.cache_bytes_per_slot(tcfg, torch.bfloat16)
            == jssm.cache_bytes_per_slot(jcfg, jnp.bfloat16))


def test_chunk_must_divide_the_length(setup):
    """The reference's tiling assertion is kept, not padded around."""
    _, tcfg, _, tp = setup
    with pytest.raises(AssertionError):
        ssm.forward(tp, tcfg, _t(_x(5, 1, 160, tcfg.d_model)))
