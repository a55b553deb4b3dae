"""The port's plain kernel versions (``repro_torch.kernels.ref``, what the
CPU runs in place of the CUDA kernels) against the JAX package: the Pallas
kernels in interpret mode where they trace on the installed jax, else the
JAX oracles in ``repro.kernels.ref``.

The fused Pallas family (``decode_fused.py``) does not trace on jax 0.9.0
(``pl.store`` / ``pl.load`` are gone), so ``ivf_screen_select_ref`` and
``tail_gather_argmax_ref`` are held against the JAX oracles here and
against the unfused XLA path in test_torch_ivf.py / test_torch_sampler.py.

Tolerances: ids and indices exact; fp32 values rtol=atol=1e-5 (XLA-CPU and
PyTorch reduce in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.ivf_gather_score import ivf_gather_score as jax_ivf_gather_score
from repro_torch.kernels import ops, ref

# one intra-op thread: the suite runs six workers on the same cores, and
# torch's default thread pool per worker oversubscribes them
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ flash_decode
@pytest.mark.parametrize("lengths", [[1, 1, 1], [32, 32, 32], [1, 17, 32]],
                         ids=["len1", "full", "ragged"])
def test_flash_decode_ref_matches_jax(lengths):
    rng = np.random.default_rng(0)
    b, s, hq, hkv, hd = 3, 32, 8, 2, 16
    q = rng.standard_normal((b, hq, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, hd), dtype=np.float32)
    lens = np.asarray(lengths, np.int32)
    want_kernel = jax_flash_decode(q, k, v, lens, s_block=16, interpret=True)
    want_ref = jref.flash_decode_ref(q, k, v, lens)
    got = ref.flash_decode_ref(_t(q), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    assert got.dtype == torch.float32


def test_flash_decode_ref_bf16_inputs():
    """bf16 cache in, fp32 out — the serving layout under the bf16 policy."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 8, 1, 16), dtype=np.float32)
    v = rng.standard_normal((2, 8, 1, 16), dtype=np.float32)
    lens = np.asarray([3, 8], np.int32)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = jref.flash_decode_ref(*bf, lens)
    got = ref.flash_decode_ref(*(_t(np.asarray(x, np.float32)).bfloat16()
                                 for x in bf), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------- ivf_gather_score
def test_ivf_gather_score_ref_matches_interpret_kernel():
    rng = np.random.default_rng(2)
    n_c, cap, d, b, n_probe = 16, 8, 256, 4, 3
    mv = rng.standard_normal((n_c, cap, d), dtype=np.float32)
    mids = rng.integers(-1, n_c * cap, (n_c, cap)).astype(np.int32)
    probe = rng.integers(0, n_c, (b, n_probe)).astype(np.int32)
    q = rng.standard_normal((b, d), dtype=np.float32)
    want_s, want_i = jax_ivf_gather_score(mv, mids, probe, q, d_block=128,
                                          interpret=True)
    got_s, got_i = ref.ivf_gather_score_ref(_t(mv), _t(mids), _t(probe), _t(q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # ops on CPU tensors = the plain version, flattened like the JAX ops
    s2, i2 = ops.ivf_gather_score(_t(mv), _t(mids), _t(probe), _t(q))
    assert torch.equal(s2, got_s.reshape(b, -1))
    assert torch.equal(i2, got_i.reshape(b, -1))


# ------------------------------------------------------ ivf_screen_select
def _screen_case(kind: str):
    rng = np.random.default_rng({"random": 3, "small_pool": 4, "dead_row": 5,
                                 "ties": 6}[kind])
    n_c, cap, d, b, n_probe, o_cap, k = 12, 8, 32, 4, 3, 16, 24
    if kind == "small_pool":  # pool (np*cap + o_cap) narrower than k
        n_c, cap, n_probe, o_cap, k = 4, 4, 2, 4, 16
    if kind == "ties":  # small integers: exact, heavily tied scores
        mv = rng.integers(-1, 2, (n_c, cap, d)).astype(np.float32)
        q = rng.integers(-1, 2, (b, d)).astype(np.float32)
        osc = rng.integers(-3, 4, (b, o_cap)).astype(np.float32)
    else:
        mv = rng.standard_normal((n_c, cap, d), dtype=np.float32)
        q = rng.standard_normal((b, d), dtype=np.float32)
        osc = rng.standard_normal((b, o_cap), dtype=np.float32)
    mids = rng.integers(0, 1000, (n_c, cap)).astype(np.int32)
    mids[rng.random((n_c, cap)) < 0.3] = -1
    oids = rng.integers(0, 1000, (o_cap,)).astype(np.int32)
    oids[rng.random(o_cap) < 0.3] = -1
    probe = np.stack([rng.permutation(n_c)[:n_probe] for _ in range(b)])
    probe = probe.astype(np.int32)
    if kind == "dead_row":  # row 0 probes only dead clusters, no overflow
        mids[probe[0]] = -1
        oids[:] = -1
    return mv, mids, osc, oids, probe, q, k


@pytest.mark.parametrize("kind", ["random", "small_pool", "dead_row", "ties"])
def test_ivf_screen_select_ref_matches_jax_oracle(kind):
    mv, mids, osc, oids, probe, q, k = _screen_case(kind)
    want_v, want_i = jref.ivf_screen_select_ref(mv, mids, osc, oids, probe, q,
                                                k)
    got_v, got_i = ref.ivf_screen_select_ref(_t(mv), _t(mids), _t(osc),
                                             _t(oids), _t(probe), _t(q), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    if kind == "dead_row":
        assert (got_i[0] == -1).all() and torch.isneginf(got_v[0]).all()


def test_ivf_screen_select_ref_probe_width():
    """Stages at or past a row's probe_width are dead: each row equals the
    oracle run on its probe prefix alone."""
    mv, mids, osc, oids, probe, q, k = _screen_case("random")
    width = np.asarray([3, 1, 0, 2], np.int32)
    got_v, got_i = ref.ivf_screen_select_ref(
        _t(mv), _t(mids), _t(osc), _t(oids), _t(probe), _t(q), k,
        probe_width=_t(width))
    for i, w in enumerate(width):
        want_v, want_i = jref.ivf_screen_select_ref(
            mv, mids, osc[i:i + 1], oids, probe[i:i + 1, :w], q[i:i + 1], k)
        np.testing.assert_array_equal(got_i[i].numpy(), np.asarray(want_i)[0])
        np.testing.assert_allclose(got_v[i].numpy(), np.asarray(want_v)[0],
                                   **TOL)


# ----------------------------------------------------- tail_gather_argmax
@pytest.mark.parametrize("kind", ["random", "ties", "no_tail"])
def test_tail_gather_argmax_ref_matches_jax_oracle(kind):
    rng = np.random.default_rng({"random": 7, "ties": 8, "no_tail": 9}[kind])
    n, d, t, m_cap, k = 64, 16, 6, 20, 8
    if kind == "ties":  # integer scores and heights: exact ties everywhere
        emb = rng.integers(-1, 2, (n, d)).astype(np.float32)
        h = rng.integers(-1, 2, (t, d)).astype(np.float32)
        heights = rng.integers(0, 3, (t, m_cap)).astype(np.float32)
        pert_s = rng.integers(-2, 3, (t, k)).astype(np.float32)
    else:
        emb = rng.standard_normal((n, d), dtype=np.float32)
        h = rng.standard_normal((t, d), dtype=np.float32)
        heights = rng.standard_normal((t, m_cap), dtype=np.float32) + 2.0
        pert_s = rng.standard_normal((t, k), dtype=np.float32)
    pert_s[:, ::3] = -np.inf
    pos = rng.integers(0, n, (t, m_cap)).astype(np.int32)
    s_ids = rng.integers(0, n, (t, k)).astype(np.int32)
    m_used = rng.integers(0, m_cap + 1, (t,)).astype(np.int32)
    m_used[0] = 0
    if kind == "no_tail":  # nothing materialized, every S slot dead
        m_used[:] = 0
        pert_s[:] = -np.inf
    args = (emb, pos, m_used, pert_s, s_ids, heights, h)
    want_i, want_v = jref.tail_gather_argmax_ref(*args)
    got_i, got_v = ref.tail_gather_argmax_ref(*(_t(a) for a in args))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    gi, gv = ops.tail_gather_argmax(*(_t(a) for a in args))
    assert torch.equal(gi, got_i) and torch.equal(gv, got_v)


# ------------------------------------------------------------- dispatch
def test_ops_dispatch_cpu_uses_plain_versions_and_counts_no_launch():
    ops.reset_launch_counts()
    q = torch.randn(2, 4, 8)
    kv = torch.randn(2, 5, 2, 8)
    out = ops.flash_decode(q, kv, kv, torch.tensor([2, 5]))
    assert torch.equal(out, ref.flash_decode_ref(q, kv, kv,
                                                 torch.tensor([2, 5])))
    # the paged layout: a pool of 3 blocks of 2 rows (the last the sink),
    # page tables that reorder them
    pool = torch.randn(3, 2, 2, 8)
    pages = torch.tensor([[1, 0, 2], [0, 2, 2]])
    out = ops.flash_decode(q, pool, pool, torch.tensor([3, 2]), pages=pages)
    assert torch.equal(out, ref.flash_decode_paged_ref(
        q, pool, pool, torch.tensor([3, 2]), pages))
    view = pool[pages].reshape(2, 6, 2, 8)
    assert torch.equal(out, ref.flash_decode_ref(q, view, view,
                                                 torch.tensor([3, 2])))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    assert set(ops.KERNELS) == {"flash_decode", "flash_decode_paged",
                                "ivf_gather_score", "ivf_screen_select",
                                "pq_lut_score", "pq_screen_select",
                                "rerank_select", "tail_gather_argmax",
                                "fused_estimator", "fused_estimator_bwd"}


def test_ops_rejects_devices_without_a_kernel_or_plain_version():
    """A device with neither a kernel nor a plain version raises; the meta
    device (the cost model's dry run) gets the kernel's output shapes and
    runs nothing."""
    import types

    q = types.SimpleNamespace(is_cuda=False, is_meta=False,
                              device=torch.device("xla"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.flash_decode(q, q, q, q)
    qm = torch.empty(2, 4, 8, device="meta")
    kc = torch.empty(2, 16, 2, 8, device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    out = ops.flash_decode(qm, kc, kc, lens)
    assert out.is_meta and out.shape == (2, 4, 8) and out.dtype == torch.float32
    o, lse = ops.flash_decode(qm, kc, kc, lens, return_lse=True)
    assert o.shape == (2, 4, 8) and lse.shape == (2, 4)
    assert ops.launch_counts()["flash_decode"] == 0
