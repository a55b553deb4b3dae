"""The position-split KV ring on 2 gloo ranks (``models/attention.py``):
where the KV heads do not divide ``tp`` (recurrentgemma's and paligemma's
one KV head), each rank holds ``s_c / 2`` ring positions, attends every
query head over them with ``flash_decode(..., return_lse=True)`` and the
ranks combine their partial softmaxes.

* a right-padded prefill into the split cache, then decode steps past
  the ring's length (it wraps; the second shard is empty on the first
  steps), at both configs' smoke widths in fp32: every step's hidden
  state equals the JAX single-device trunk's within 1e-5, and each rank's
  cache block equals the reference cache's positions it owns;
* ``flash_decode_lse_ref`` equals a float64 ``logsumexp`` of the masked
  scores and its output the float64 softmax average, an empty row giving
  0 and -inf;
* a tp-2 ``Server`` of recurrentgemma (IVF head over a ShardedIndex):
  fused T=4 ≡ unfused T=1 bit for bit, the ring split (4 of 8 positions
  a rank).
"""
import jax
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_trunk import jax_decode
from repro.configs import get_smoke as jget_smoke
from repro.models.model import Model as JModel
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, L, MAX_SEQ, WINDOW, STEPS = 2, 3, 8, 8, 8
CASES = {"recurrentgemma-9b": {"local_window": WINDOW},
         "paligemma-3b": {}}


def _case(arch, seed):
    kw = CASES[arch]
    jcfg = jget_smoke(arch).scaled(head_mode="exact", **kw)
    jp = JModel(jcfg, precision_policy="f32").init(jax.random.key(seed))
    r = np.random.default_rng(seed)
    return jcfg, jax.device_get(jp), {
        "arch": arch, "kw": kw, "params": jax.device_get(jp),
        "max_seq": MAX_SEQ, "block_len": 4, "n_blocks": 0,
        "tokens": r.integers(0, jcfg.vocab, (B, L)).astype(np.int64),
        "lengths": np.array([3, 2], np.int64),
        "next_ids": r.integers(0, jcfg.vocab, (STEPS, B)).astype(np.int64)}


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    cases = {arch: _case(arch, i) for i, arch in enumerate(CASES)}
    spec = {arch: c for arch, (_, _, c) in cases.items()}
    ranks = td.spawn(td.ring_decode_cases, tmp_path_factory.mktemp("ring"),
                     1, 2, spec)
    return cases, ranks


@pytest.mark.parametrize("arch", list(CASES))
def test_split_ring_decode_matches_jax(arch, ring):
    cases, ranks = ring
    jcfg, jp, c = cases[arch]
    want_h, want_cache = jax_decode(jcfg, jp, c)
    assert max(c["lengths"]) + 1 <= MAX_SEQ // 2  # shard 1 starts empty
    assert max(c["lengths"]) + STEPS > MAX_SEQ  # and the ring wraps
    for rank, out in enumerate(ranks):
        got = out[arch]
        assert len(got["h"]) == len(want_h)
        for i, (a, b) in enumerate(zip(got["h"], want_h)):
            np.testing.assert_allclose(a, b, **TOL,
                                       err_msg=f"{arch} rank {rank} step {i}")
        n = MAX_SEQ // 2
        seen = 0
        for g, (gg, wg) in enumerate(zip(got["cache"], want_cache)):
            for j, lay in gg.items():
                if "k" not in lay:
                    continue
                for k in ("k", "v"):
                    assert lay[k].shape[2] == n  # half the ring a rank
                    np.testing.assert_allclose(
                        lay[k], np.asarray(wg[j][k])[:, :, rank * n:
                                                      (rank + 1) * n],
                        **TOL, err_msg=f"{arch} cache {g}/{j}/{k}")
                    seen += 1
        assert seen


def test_lse_ref_matches_float64_logsumexp():
    gen = torch.Generator().manual_seed(0)
    b, s, hq, hkv, hd = 4, 37, 6, 2, 16
    q = torch.randn((b, hq, hd), generator=gen)
    k = torch.randn((b, s, hkv, hd), generator=gen)
    v = torch.randn((b, s, hkv, hd), generator=gen)
    lengths = torch.tensor([37, 0, 5, 1], dtype=torch.int32)
    o, lse = ref.flash_decode_lse_ref(q, k, v, lengths)
    via_ops = ops.flash_decode(q, k, v, lengths, return_lse=True)
    assert torch.equal(via_ops[0], o) and torch.equal(via_ops[1], lse)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq)
    kd = k.double().repeat_interleave(hq // hkv, 2)
    vd = v.double().repeat_interleave(hq // hkv, 2)
    sc = torch.einsum("bhd,bshd->bhs", q.double(), kd) / hd ** 0.5
    live = torch.arange(s)[None, None] < lengths[:, None, None]
    sc = torch.where(live, sc, torch.tensor(float("-inf"), dtype=sc.dtype))
    want = torch.logsumexp(sc, -1)
    full = lengths > 0
    np.testing.assert_allclose(lse[full].numpy(), want[full].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.isneginf(lse[~full]).all()  # an empty row weighs nothing
    p = torch.softmax(sc[full], -1)
    np.testing.assert_allclose(
        o[full].numpy(),
        torch.einsum("bhs,bshd->bhd", p, vd[full]).numpy(),
        rtol=1e-5, atol=1e-5)
    assert (o[~full] == 0).all()
    # the default call keeps the reference's all-masked semantics
    d = ops.flash_decode(q, k, v, lengths)
    assert torch.equal(d, ref.flash_decode_ref(q, k, v, lengths))
    assert torch.allclose(d[full], o[full], rtol=1e-5, atol=1e-6)


def test_tp2_server_fused_equals_unfused_on_split_ring(tmp_path):
    r = np.random.default_rng(4)
    prompts = [list(map(int, r.integers(0, 4096, n))) for n in (5, 9, 3)]
    spec = {"prompts": prompts, "window": 8, "max_seq": 24, "new_tokens": 7}
    ranks = td.spawn(td.ring_serve_case, tmp_path, 1, 2, spec)
    for out in ranks:
        assert out["ring"] == 4  # 8 positions split over 2 ranks
        assert out["fused"] == out["unfused"]
        assert all(len(t) == 7 for t in out["fused"])
    assert ranks[0]["fused"] == ranks[1]["fused"]
