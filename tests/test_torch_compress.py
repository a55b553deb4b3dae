"""The port's int8 compressed collectives (``repro_torch.optim.compress``)
against the reference's ``repro/optim/compress.py``: ``quantize`` /
``dequantize`` bit for bit with the reference's uniform noise injected,
and ``ring_allreduce_int8`` on 4 spawned gloo ranks (the data axis)
against the exact all-reduce: relative error below 0.04 and the
unbiasedness check of the reference's
test_compressed_allreduce_matches_psum (the error averaged over 16 seeds
at under half the single-run error).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from repro.optim import compress as jcompress
from repro_torch.optim import compress

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,scale", [((4096,), 1.0), ((64, 33), 1e-3),
                                         ((7,), 50.0)])
def test_quantize_matches_reference(shape, scale):
    r = np.random.default_rng(len(shape))
    x = (r.standard_normal(shape) * scale).astype(np.float32)
    key = jax.random.key(3)
    jq, js = jcompress.quantize(jnp.asarray(x), key)
    u = np.asarray(jax.random.uniform(key, shape))
    q, s = compress.quantize(torch.from_numpy(x), torch.from_numpy(u.copy()))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        compress.dequantize(q, s).numpy(),
        np.asarray(jcompress.dequantize(jq, js)))


def test_hop_noise_is_uniform_and_keyed():
    a = compress.hop_noise(0, 1, 2, 10_000, "cpu")
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    assert abs(float(a.mean()) - 0.5) < 0.01
    assert torch.equal(a, compress.hop_noise(0, 1, 2, 10_000, "cpu"))
    assert not torch.equal(a, compress.hop_noise(0, 1, 3, 10_000, "cpu"))


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    x = np.asarray(jax.random.normal(jax.random.key(0), (4, 4096)))
    return td.spawn(td.ring_int8_cases, tmp_path_factory.mktemp("ring"), 4,
                    1, {"x": x, "seeds": list(range(16))}), x


def test_ring_allreduce_int8_matches_psum(ring):
    outs, x = ring
    exact = x.sum(0)
    for o in outs:
        np.testing.assert_allclose(o["exact"], exact, rtol=1e-5, atol=1e-5)
        rel = np.linalg.norm(o["approx"][0] - exact) / np.linalg.norm(exact)
        assert rel < 0.04, rel  # int8 stochastic-rounding noise only


def test_ring_allreduce_int8_unbiased(ring):
    outs, x = ring
    exact = x.sum(0)
    for o in outs:
        errs = [a - exact for a in o["approx"]]
        bias = np.abs(np.mean(errs, axis=0)).mean()
        noise = np.abs(errs[0]).mean()
        assert bias < noise * 0.5, (bias, noise)


def test_ring_length_must_divide():
    from repro_torch.collectives import Axis

    ax = Axis("data", 4, 0, (0, 1, 2, 3))
    with pytest.raises(ValueError, match="must divide"):
        compress.ring_allreduce_int8(torch.zeros(6), ax, 0)
