"""The port's CUDA kernels against their plain versions on the card, at
small shapes with the edge cases the serving path can produce (pools
narrower than k, dead rows, exact ties, probe widths, empty tails, d not a
multiple of 4, lengths 0, 1 and full). Marked ``cuda``: they skip without
an NVIDIA GPU; run them on one with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX, which a
machine with the card need not have.)

Tolerances: ids exact; fp32 values rtol=atol=1e-5 (small-integer inputs
make the fp32 ones exact); flash_decode atol=2e-3.
"""
import pytest
import torch

from repro_torch.kernels import decode_fused, flash_decode, ivf_gather_score
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _ints(gen, shape, lo=-2, hi=3):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda").float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,hd", [(32, 4, 64), (4, 2, 16), (8, 8, 128)])
def test_flash_decode_kernel(gen, dtype, hq, hkv, hd):
    b, s = 4, 130
    q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").to(dtype)
    lengths = torch.tensor([0, 1, 77, s], device="cuda", dtype=torch.int32)
    got = flash_decode.flash_decode(q, k, v, lengths)
    want = ref.flash_decode_ref(q, k, v, lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)


def _tables(gen, n_c=12, cap=40, d=64, b=5, n_probe=4, o_cap=24):
    mv = _ints(gen, (n_c, cap, d))
    mids = torch.randint(0, 1000, (n_c, cap), generator=gen, device="cuda",
                         dtype=torch.int32)
    mids[torch.rand((n_c, cap), generator=gen, device="cuda") < 0.3] = -1
    probe = torch.stack([torch.randperm(n_c, generator=gen, device="cuda")
                         [:n_probe] for _ in range(b)]).int()
    q = _ints(gen, (b, d))
    o_ids = torch.randint(0, 1000, (o_cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    o_ids[::3] = -1
    o_sc = _ints(gen, (b, o_cap), -20, 20)
    return mv, mids, o_sc, o_ids, probe, q


@pytest.mark.parametrize("d", [64, 30])
def test_ivf_gather_score_kernel(gen, d):
    mv, mids, _, _, probe, q = _tables(gen, d=d)
    s, i = ivf_gather_score.ivf_gather_score(mv, mids, probe, q)
    ws, wi = ref.ivf_gather_score_ref(mv, mids, probe, q)
    torch.testing.assert_close(s, ws, **TOL)
    assert torch.equal(i, wi)


@pytest.mark.parametrize("case", ["ties", "small_pool", "dead_row", "width"])
def test_ivf_screen_select_kernel(gen, case):
    kw = dict(n_c=4, cap=4, n_probe=2, o_cap=4) if case == "small_pool" else {}
    mv, mids, o_sc, o_ids, probe, q = _tables(gen, **kw)
    k = 16 if case == "small_pool" else 50
    width = None
    if case == "dead_row":
        mids[probe[0].long()] = -1
        o_ids[:] = -1
    if case == "width":
        width = torch.tensor([4, 0, 1, 3, 2], device="cuda",
                             dtype=torch.int32)
    args = (mv, mids, o_sc, o_ids, probe, q)
    v, i = decode_fused.ivf_screen_select(*args, k=k, probe_width=width)
    wv, wi = ref.ivf_screen_select_ref(*args, k, probe_width=width)
    assert torch.equal(i, wi)
    assert torch.equal(v, wv)  # exact: integer-valued scores


def test_screen_select_bitwise_equals_gather_score_plus_topk(gen):
    """Random fp32 data: the fused screen's values are bitwise the unfused
    kernel's scores, and its picks those of a top-k over them."""
    mv = torch.randn((16, 48, 256), generator=gen, device="cuda")
    mids = torch.randint(0, 5000, (16, 48), generator=gen, device="cuda",
                         dtype=torch.int32)
    probe = torch.stack([torch.randperm(16, generator=gen, device="cuda")[:5]
                         for _ in range(3)]).int()
    q = torch.randn((3, 256), generator=gen, device="cuda")
    o_ids = torch.arange(10, device="cuda", dtype=torch.int32) + 6000
    o_sc = torch.randn((3, 10), generator=gen, device="cuda") * 10
    v, i = decode_fused.ivf_screen_select(mv, mids, o_sc, o_ids, probe, q,
                                          k=64)
    s, ids = ops.ivf_gather_score(mv, mids, probe, q)
    pool_s = torch.cat([s, o_sc], 1)
    pool_i = torch.cat([ids, o_ids[None].expand(3, -1)], 1)
    wv, wi = ref.topk_select_ref(pool_s, pool_i, 64)
    assert torch.equal(v, wv) and torch.equal(i, wi)


@pytest.mark.parametrize("d", [64, 30])
def test_tail_gather_argmax_kernel(gen, d):
    n, t, m_cap, k = 300, 6, 70, 20
    emb = _ints(gen, (n, d))
    h = _ints(gen, (t, d))
    pos = torch.randint(0, n, (t, m_cap), generator=gen, device="cuda",
                        dtype=torch.int32)
    m_used = torch.tensor([0, 1, 35, 69, 70, 70], device="cuda",
                          dtype=torch.int32)
    pert_s = _ints(gen, (t, k), -10, 10)
    pert_s[:, ::4] = float("-inf")
    pert_s[4] = float("-inf")
    s_ids = torch.randint(0, n, (t, k), generator=gen, device="cuda",
                          dtype=torch.int32)
    heights = _ints(gen, (t, m_cap), 0, 4) * 0.5
    args = (emb, pos, m_used, pert_s, s_ids, heights, h)
    i, v = decode_fused.tail_gather_argmax(*args)
    wi, wv = ref.tail_gather_argmax_ref(*args)
    assert torch.equal(i, wi)
    torch.testing.assert_close(v, wv, **TOL)


def test_kernels_reject_bad_inputs(gen):
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode.flash_decode(torch.zeros(1, 2, 8), torch.zeros(1, 3, 1, 8),
                                  torch.zeros(1, 3, 1, 8), torch.ones(1))
    kv = torch.zeros(2, 3, 1, 8, device="cuda")
    with pytest.raises(ValueError, match="lengths"):
        flash_decode.flash_decode(torch.zeros(2, 2, 8, device="cuda"), kv, kv,
                                  torch.ones(1, device="cuda"))
