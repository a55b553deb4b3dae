"""The port's CUDA kernels against their plain versions on the card, at
small shapes with the edge cases the serving and training paths can produce
(pools narrower than k, dead rows, exact ties, probe widths, empty tails, d
not a multiple of 4, lengths 0, 1 and full, dead candidate slots, all-dead
tokens, row segments of hundreds of entries, token counts past the
backward's tile of h, one table row, PQ subspace counts 4, 8
and 16, codebooks narrower than 256; flash_decode lengths around its split
of the sequence, query-group sizes 1 to 32 and head dims 16 to 256;
duplicate, out-of-range and piled-up IVF probes, the IVF probe at the
paper's caps (3,400 rows a cluster at d 256, 4,248 at d 300); the paged flash_decode with block
lengths 1 to 128 over permuted pools, sentinel pages and rows past each
length poisoned with NaN; the split IVF screen at
1 to 256 queries, pools at and past a power of two and up to its 16,384
slots, k from 1 to past the pool, probe widths 0 to past n_probe, dead
cluster tails; the same for the split IVF-PQ screen; the split tail argmax
at tail lengths around its chunk of slots, ties across chunks and between
-0.0 and +0.0, and batches that stride); then the trunk families on the
card against the CPU: the MoE (bitwise repeatable, the CPU's dispatch),
the SSD and RG-LRU scans, and the compute-dtype cast set; and the index
side on the card: the LSH build's tables against the CPU build's, the
chunked LSH sampler against the unchunked one, the batched per-cluster
Σ u uᵀ of the anisotropic codebooks against the per-row form, and the LSH
probe against the CPU's; and the sharding slice on the card: two ranks
sharing it under gloo (collectives staged through the host), a
``ShardedIndex``'s global top-k and the distributed head's exact loss and
fused IVF samples on CUDA tensors against the same ranks on the CPU.
Marked ``cuda``: they skip without
an NVIDIA GPU; run them on one with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX, which a
machine with the card need not have.)

Tolerances: ids exact; fp32 values rtol=atol=1e-5 (small-integer inputs
make the fp32 ones exact; the PQ LUT sums are bitwise on any input, both
sides adding the same terms in the same order); flash_decode atol=2e-3; fused_estimator and its
backward on random fp32 data rtol=atol=1e-5 (the kernel and the plain
version sum the same terms in different orders), NaN where the plain
version has NaN (an all-dead token).
"""
import pytest
import torch

from repro_torch.core import estimators
from repro_torch.core.mips import IVFPQIndex, PQConfig
from repro_torch.kernels import decode_fused, flash_decode, fused_estimator
from repro_torch.kernels import ivf_gather_score, pq_lut_score
from repro_torch.kernels import ops, ref
from repro_torch.configs import get_smoke
from repro_torch.models import moe, rglru, ssm, transformer

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 24, 64, 128, 256])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (16, 2), (32, 1)],
                         ids=["G1", "G8", "G32"])
def test_flash_decode_split_edges(gen, dtype, hq, hkv, hd):
    """Lengths around the kernel's split of the sequence (0, 1, split - 1,
    split, split + 1, S) with S not a multiple of the split; each sequence
    alone equals its row of the batch bit for bit, and two launches agree.
    bf16 with hd % 16 == 0 runs on the tensor cores, hd 24 and fp32 on the
    CUDA cores."""
    split = flash_decode.SPLIT_ROWS
    s = 3 * split + 11
    lengths = torch.tensor([0, 1, split - 1, split, split + 1, s],
                           device="cuda", dtype=torch.int32)
    b = lengths.numel()
    q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").to(dtype)
    got = flash_decode.flash_decode(q, k, v, lengths)
    want = ref.flash_decode_ref(q, k, v, lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)
    assert torch.equal(flash_decode.flash_decode(q, k, v, lengths), got)
    for i in range(b):
        alone = flash_decode.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                          lengths[i:i + 1])
        assert torch.equal(alone[0], got[i])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,hd", [(16, 1, 256), (32, 4, 64), (4, 2, 24)])
def test_flash_decode_return_lse(gen, dtype, hq, hkv, hd):
    """``return_lse=True`` against its plain version: the output, and the
    log-sum-exp where it is finite; a row of length 0 gives 0 and -inf.
    The default call on the same inputs is unchanged by the option and
    agrees with the lse call's output on every non-empty row."""
    split = flash_decode.SPLIT_ROWS
    s = 3 * split + 11
    lengths = torch.tensor([0, 1, split, split + 1, s], device="cuda",
                           dtype=torch.int32)
    b = lengths.numel()
    q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").to(dtype)
    o, lse = flash_decode.flash_decode(q, k, v, lengths, return_lse=True)
    wo, wl = ref.flash_decode_lse_ref(q, k, v, lengths)
    torch.testing.assert_close(o, wo, rtol=0, atol=2e-3)
    fin = torch.isfinite(wl)
    assert torch.equal(torch.isfinite(lse), fin)
    assert not fin[0].any() and fin[1:].all()
    torch.testing.assert_close(lse[fin], wl[fin], rtol=1e-5, atol=1e-4)
    assert (o[0] == 0).all()
    plain = flash_decode.flash_decode(q, k, v, lengths)
    assert torch.equal(plain[1:], o[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_unaligned_cache(gen, dtype):
    """A KV cache whose rows do not start on 16 bytes takes the scalar copy
    path; same results as the plain version."""
    b, s, hq, hkv, hd = 3, 150, 8, 2, 64
    q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(dtype)
    n = b * s * hkv * hd
    kb = torch.randn((n + 1,), generator=gen, device="cuda").to(dtype)
    vb = torch.randn((n + 1,), generator=gen, device="cuda").to(dtype)
    k, v = kb[1:].view(b, s, hkv, hd), vb[1:].view(b, s, hkv, hd)
    assert k.data_ptr() % 16 and k.is_contiguous()
    lengths = torch.tensor([0, 70, 150], device="cuda", dtype=torch.int32)
    torch.testing.assert_close(flash_decode.flash_decode(q, k, v, lengths),
                               ref.flash_decode_ref(q, k, v, lengths),
                               rtol=0, atol=2e-3)


def test_flash_decode_batch_of_four_is_bitwise_per_sequence(gen):
    """A sequence computed alone equals it computed inside a batch of 4
    (other slots at other lengths), at tinyllama's heads in bf16."""
    b, s, hq, hkv, hd = 4, 2048, 32, 4, 64
    q = torch.randn((b, hq, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").bfloat16()
    lengths = torch.tensor([2048, 5, 1000, 129], device="cuda",
                           dtype=torch.int32)
    got = flash_decode.flash_decode(q, k, v, lengths)
    torch.testing.assert_close(got, ref.flash_decode_ref(q, k, v, lengths),
                               rtol=0, atol=2e-3)
    for i in range(b):
        alone = flash_decode.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                          lengths[i:i + 1])
        assert torch.equal(alone[0], got[i])


def _paged(gen, dtype, b, n_pages, block_len, hkv, hd, lengths, extra=3):
    """A permuted block pool (one sink block last) and page tables: each
    sequence's pages past its length hold the sentinel (the sink's id)."""
    n_blocks = b * n_pages + extra
    shape = (n_blocks + 1, block_len, hkv, hd)
    kp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(n_blocks, generator=gen, device="cuda")
    pages = perm[: b * n_pages].view(b, n_pages).int()
    live = -(-lengths.long() // block_len)  # pages a sequence's rows touch
    page = torch.arange(n_pages, device="cuda")[None]
    pages = torch.where((page < live[:, None]) | (lengths[:, None] == 0),
                        pages, n_blocks)
    return kp, vp, pages.int()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,hd", [(32, 4, 64), (8, 8, 128), (4, 2, 24)])
@pytest.mark.parametrize("block_len", [1, 16, 48, 64, 128])
def test_flash_decode_paged_kernel(gen, dtype, hq, hkv, hd, block_len):
    """The paged layout against its plain version (gather + dense plain
    version), and bit for bit against the dense kernel over the gathered
    view: the same rows in the same order, so the same arithmetic. Lengths
    0 (every row, sentinels clamped into the pool), 1, within a split,
    across splits and full; block_len 1 to past the kernel's split."""
    b, n_pages = 5, -(-200 // block_len)
    s = n_pages * block_len
    lengths = torch.tensor([0, 1, 63, 130, s], device="cuda",
                           dtype=torch.int32)
    q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(dtype)
    kp, vp, pages = _paged(gen, dtype, b, n_pages, block_len, hkv, hd,
                           lengths)
    n0 = flash_decode.launches["flash_decode_paged"]
    got = ops.flash_decode(q, kp, vp, lengths, pages=pages)
    assert flash_decode.launches["flash_decode_paged"] == n0 + 1
    want = ref.flash_decode_paged_ref(q, kp, vp, lengths, pages)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)
    idx = pages.long().clamp(max=kp.shape[0] - 1)
    view = (b, s, hkv, hd)
    dense = flash_decode.flash_decode(q, kp[idx].reshape(view),
                                      vp[idx].reshape(view), lengths)
    assert torch.equal(got, dense)
    assert torch.equal(flash_decode.flash_decode(q, kp, vp, lengths,
                                                 pages=pages), got)


@pytest.mark.parametrize("block_len", [16, 64])
def test_flash_decode_paged_never_reads_past_lengths(gen, block_len):
    """NaN in the sink block and in every block a sequence does not own:
    a row at or past lengths[b] read by the kernel would poison its output
    (a -1e30 score weighs 0, but 0 * NaN is NaN). Tinyllama's heads, bf16
    (tensor cores) and fp32."""
    b, hq, hkv, hd, n_pages = 4, 32, 4, 64, 2048 // block_len
    lengths = torch.tensor([1, 700, 2047, 2048], device="cuda",
                           dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(dtype)
        kp, vp, pages = _paged(gen, dtype, b, n_pages, block_len, hkv, hd,
                               lengths)
        want = ref.flash_decode_paged_ref(q, kp, vp, lengths, pages)
        owned = torch.zeros(kp.shape[0], dtype=torch.bool, device="cuda")
        owned[pages.long().flatten()] = True
        owned[-1] = False  # the sink
        # rows past each length inside a sequence's last block stay live
        # data of that block; poison every row no sequence may read
        for i in range(b):
            last = (int(lengths[i]) - 1) // block_len
            blk = int(pages[i, last])
            kp[blk, int(lengths[i]) - last * block_len:] = float("nan")
            vp[blk, int(lengths[i]) - last * block_len:] = float("nan")
        kp[~owned], vp[~owned] = float("nan"), float("nan")
        got = flash_decode.flash_decode(q, kp, vp, lengths, pages=pages)
        assert bool(torch.isfinite(got).all())
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


@pytest.mark.parametrize("data", ["small_int", "unit_rows"])
@pytest.mark.parametrize("b,n_probe", [(4, 16), (64, 16), (8, 64)])
@pytest.mark.parametrize("d,cap", [(256, 3400), (300, 4248)],
                         ids=["imagenet", "word_embeddings"])
def test_ivf_gather_score_paper_geometry(gen, d, cap, b, n_probe, data):
    """The paper setting's probe (``configs/paper_loglinear.py``): the IVF
    index's cap at ImageNet's width (3,400 at d 256) and the word
    embeddings' (4,248 at d 300: 75 float4 chunks a row, not a multiple of
    the warp's 32 lanes), members dead past each cluster's size, 16 probes
    (``topk_batch``) and 64 (the adaptive probe's pool). Small-integer rows
    are exact; unit rows against θ = row / 0.05, as the paper queries,
    rtol 1e-5 and an atol of 1e-5 times the largest score (d-term dot
    products summed in different orders)."""
    n_c = n_probe + 4
    if data == "small_int":
        mv = _ints(gen, (n_c, cap, d))
        q = _ints(gen, (b, d))
    else:
        mv = torch.randn((n_c, cap, d), generator=gen, device="cuda")
        mv /= mv.norm(dim=-1, keepdim=True)
        q = mv[torch.randint(0, n_c, (b,), generator=gen, device="cuda"),
               torch.randint(0, cap, (b,), generator=gen, device="cuda")]
        q = q / 0.05
    mids = torch.randint(0, 10 ** 6, (n_c, cap), generator=gen,
                         device="cuda", dtype=torch.int32)
    sizes = torch.randint(cap // 3, cap + 1, (n_c,), generator=gen,
                          device="cuda")
    dead = torch.arange(cap, device="cuda")[None] >= sizes[:, None]
    mids[dead] = -1
    mv[dead] = 0.0
    probe = torch.stack([torch.randperm(n_c, generator=gen, device="cuda")
                         [:n_probe] for _ in range(b)]).int()
    s, i = ivf_gather_score.ivf_gather_score(mv, mids, probe, q)
    ws, wi = ref.ivf_gather_score_ref(mv, mids, probe, q)
    assert torch.equal(i, wi)
    if data == "small_int":
        assert torch.equal(s, ws)
    else:
        torch.testing.assert_close(s, ws, rtol=1e-5,
                                   atol=1e-5 * ws.abs().max().item())


@pytest.mark.parametrize("case", ["duplicates", "out_of_range", "one_cluster",
                                  "b1", "b256_d30", "small_batch_piled",
                                  "small_batch_d30"])
def test_ivf_gather_score_kernel_probe_shapes(gen, case):
    """Probe sets the cluster-major kernel must get right: a query naming a
    cluster twice (both slots filled), ids out of range (clamped, as a
    gather does), every query probing one cluster (its query list split
    over several blocks), one query, and 256 queries at d 30; caps that are
    not a multiple of the kernel's row chunk; and the small-batch kernel
    (at most 4 queries) with more pairs on one cluster than it scores at
    once, duplicates and out-of-range ids. Small-integer rows: exact."""
    n_c, cap, d, b, n_probe = 12, 45, 64, 40, 4
    if case == "b1":
        b, cap = 1, 77
    if case == "b256_d30":
        b, d, cap = 256, 30, 33
    if case.startswith("small_batch"):
        b, n_probe = 3, 6
        d = 30 if case == "small_batch_d30" else 64
    mv, mids, _, _, probe, q = _tables(gen, n_c=n_c, cap=cap, d=d, b=b,
                                       n_probe=n_probe)
    if case == "duplicates":
        probe[:, 1] = probe[:, 0]
        probe[3, :] = probe[3, 2]
    if case == "out_of_range":
        probe[0, 0], probe[1, 2], probe[2, 3] = -5, n_c, 10 ** 6
    if case == "one_cluster":
        probe[:, 2] = 7
    if case.startswith("small_batch"):  # 7 pairs on cluster 5
        probe[:, 0], probe[:, 4] = 5, 5
        probe[1, 5], probe[2, 1], probe[0, 3] = 5, -1, n_c + 3
    s, i = ivf_gather_score.ivf_gather_score(mv, mids, probe, q)
    ws, wi = ref.ivf_gather_score_ref(mv, mids, probe.clamp(0, n_c - 1), q)
    assert torch.equal(s, ws) and torch.equal(i, wi)
    s2, i2 = ivf_gather_score.ivf_gather_score(mv, mids, probe, q)
    assert torch.equal(s2, s) and torch.equal(i2, i)


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


@pytest.mark.parametrize("d,b,skew", [(256, 3, False), (2048, 64, True)],
                         ids=["d256_b3", "d2048_b64_skewed"])
def test_screen_select_bitwise_equals_gather_score_plus_topk(gen, d, b, skew):
    """Random fp32 data: the fused screen's values are bitwise the unfused
    kernel's scores, and its picks those of a top-k over them — also at
    tinyllama's d 2048 with many queries piling onto a few clusters, where
    the order of the sums shows in the last bits."""
    n_c, cap = 16, 48
    mv = torch.randn((n_c, cap, d), generator=gen, device="cuda")
    mids = torch.randint(0, 5000, (n_c, cap), generator=gen, device="cuda",
                         dtype=torch.int32)
    if skew:  # popularity ~ 1 / rank: cluster 0 in most queries' probes
        pop = 1.0 / torch.arange(1, n_c + 1, device="cuda",
                                 dtype=torch.float32)
        probe = torch.multinomial(pop.expand(b, -1), 5, generator=gen).int()
    else:
        probe = torch.stack([torch.randperm(n_c, generator=gen,
                                            device="cuda")[:5]
                             for _ in range(b)]).int()
    q = torch.randn((b, d), generator=gen, device="cuda")
    o_ids = torch.arange(10, device="cuda", dtype=torch.int32) + 6000
    o_sc = torch.randn((b, 10), generator=gen, device="cuda") * 10
    v, i = decode_fused.ivf_screen_select(mv, mids, o_sc, o_ids, probe, q,
                                          k=64)
    s, ids = ops.ivf_gather_score(mv, mids, probe, q)
    pool_s = torch.cat([s, o_sc], 1)
    pool_i = torch.cat([ids, o_ids[None].expand(b, -1)], 1)
    wv, wi = ref.topk_select_ref(pool_s, pool_i, 64)
    assert torch.equal(v, wv) and torch.equal(i, wi)
    # d-term dot products summed in another order than the plain version's:
    # rtol 1e-5 and an atol of 1e-5 times the largest |score| (a score that
    # cancels to ~0 keeps the rounding of its terms), as rerank_select's
    ws = ref.ivf_gather_score_ref(mv, mids, probe, q)[0].reshape(b, -1)
    torch.testing.assert_close(s, ws, rtol=1e-5,
                               atol=1e-5 * ws.abs().max().item())


def _screen_equals_gather_topk(args, k, width=None):
    """The split screen against the unfused kernel probe + a top-k, values
    and ids bit for bit (stages at or past a query's width dead, dead ids at
    -inf, -inf picks id -1), and against a second launch; returns (values,
    ids)."""
    mv, mids, o_sc, o_ids, probe, q = args
    b, n_probe = probe.shape
    v, i = decode_fused.ivf_screen_select(*args, k=k, probe_width=width)
    s, ids = ops.ivf_gather_score(mv, mids, probe, q)
    if width is not None:
        stage = torch.arange(n_probe, device="cuda")
        live = (stage[None] < width.clamp(0, n_probe)[:, None])
        live = live.repeat_interleave(mv.shape[1], 1)
        s = torch.where(live, s, float("-inf"))
        ids = torch.where(live, ids, -1)
    pool_s = torch.cat([s, o_sc], 1)
    pool_i = torch.cat([ids, o_ids[None].expand(b, -1)], 1)
    pool_s = torch.where(pool_i >= 0, pool_s, float("-inf"))
    wv, wi = ref.topk_select_ref(pool_s, pool_i, k)
    assert torch.equal(v, wv) and torch.equal(i, wi)
    v2, i2 = decode_fused.ivf_screen_select(*args, k=k, probe_width=width)
    assert torch.equal(v2, v) and torch.equal(i2, i)
    return v, i


def _random_tables(gen, n_c=12, cap=40, d=64, b=5, n_probe=4, o_cap=24):
    """_tables with random fp32 rows, queries and overflow scores."""
    mv, mids, _, o_ids, probe, _ = _tables(gen, n_c, cap, d, b, n_probe,
                                           o_cap)
    mv = torch.randn(mv.shape, generator=gen, device="cuda")
    q = torch.randn((b, d), generator=gen, device="cuda")
    o_sc = torch.randn((b, o_cap), generator=gen, device="cuda") * 10
    return mv, mids, o_sc, o_ids, probe, q


@pytest.mark.parametrize("b", [1, 4, 5, 64, 256])
def test_ivf_screen_select_batch_sizes(gen, b):
    """Batches on both sides of the score pass's small kernel (at most 4
    queries) and its plan (5 and up), random fp32: bitwise the unfused
    probe + top-k, two launches equal, a query screened alone equal to its
    row of the batch; values within rtol 1e-5 and an atol of 1e-5 times the
    largest |score| of the plain version's (another order of sums)."""
    args = _random_tables(gen, b=b)
    v, i = _screen_equals_gather_topk(args, 50)
    for j in sorted({0, b // 2, b - 1}):
        va, ia = decode_fused.ivf_screen_select(
            args[0], args[1], args[2][j:j + 1], args[3], args[4][j:j + 1],
            args[5][j:j + 1], k=50)
        assert torch.equal(va[0], v[j]) and torch.equal(ia[0], i[j])
    wv, _ = ref.ivf_screen_select_ref(*args, 50)
    fin = torch.isfinite(wv)
    assert torch.equal(fin, torch.isfinite(v))
    torch.testing.assert_close(v[fin], wv[fin], rtol=1e-5,
                               atol=1e-5 * wv[fin].abs().max().item())


@pytest.mark.parametrize("case", ["k1", "k_pool", "k_past_pool", "pool_pow2",
                                  "pool_pow2_plus1", "pool_max",
                                  "pool_max_k_pool"])
def test_ivf_screen_select_k_and_pool_edges(gen, case):
    """k = 1, k = the pool, k past the pool (padding picks: -inf, id -1); a
    pool of exactly 256 slots and one of 257 (padded to 512); the widest
    pool the select holds, 16,384 slots, at k 600 and k = the pool.
    Small-integer rows, so also exact against the plain version."""
    kw = dict(n_c=12, cap=48, d=36, b=5, n_probe=4, o_cap=24)
    pool = 4 * 48 + 24
    k = {"k1": 1, "k_pool": pool, "k_past_pool": pool + 9}.get(case, 50)
    if case.startswith("pool_pow2"):
        kw["o_cap"] = 256 - 4 * 48 + (case == "pool_pow2_plus1")
    if case.startswith("pool_max"):
        kw.update(n_c=10, cap=1800, n_probe=8, o_cap=16384 - 8 * 1800, b=4)
        k = 16384 if case == "pool_max_k_pool" else 600
    args = _tables(gen, **kw)
    v, i = _screen_equals_gather_topk(args, k)
    wv, wi = ref.ivf_screen_select_ref(*args, k)
    assert torch.equal(v, wv) and torch.equal(i, wi)
    if case == "k_past_pool":
        assert torch.isneginf(v[:, pool:]).all() and (i[:, pool:] == -1).all()


def test_ivf_screen_select_rejects_a_pool_past_its_select(gen):
    """A pool wider than the select kernel's 16,384 register-held keys is
    refused before any launch."""
    args = _tables(gen, n_c=4, cap=8, d=16, b=2, n_probe=2, o_cap=16)
    with pytest.raises(ValueError, match="pool"):
        decode_fused.ivf_screen_select(*args,
                                       k=decode_fused.SCREEN_POOL_MAX + 1)


@pytest.mark.parametrize("case", ["zero", "mixed", "full"])
@pytest.mark.parametrize("b", [4, 6])
def test_ivf_screen_select_probe_width_edges(gen, case, b):
    """probe_width 0 for every query (the overflow alone), mixed widths
    (0, 1, all, negative and past n_probe, which clamp), and the full width
    given explicitly; on the small kernel (4 queries) and the plan (6)."""
    args = _random_tables(gen, b=b)
    n_probe = args[4].shape[1]
    width = {"zero": [0] * b, "full": [n_probe] * b,
             "mixed": [0, 1, n_probe, -3, n_probe + 5, 2][:b]}[case]
    width = torch.tensor(width, device="cuda", dtype=torch.int32)
    v, i = _screen_equals_gather_topk(args, 50, width)
    if case == "full":
        v0, i0 = decode_fused.ivf_screen_select(*args, k=50)
        assert torch.equal(v0, v) and torch.equal(i0, i)


@pytest.mark.parametrize("case", ["all_dead", "duplicates", "out_of_range",
                                  "dead_tails"])
@pytest.mark.parametrize("b", [3, 5])
def test_ivf_screen_select_special_probes(gen, case, b):
    """A query whose probed members and overflow are all dead (every pick
    -inf, id -1); queries naming one cluster in several slots (each slot
    scored, ties by pool index); probe ids out of range (clamped, as a
    gather does); members dead past each cluster's size, as the index packs
    them, so whole row chunks of the score pass hold no live row."""
    args = _random_tables(gen, n_c=12, cap=100, b=b)
    mv, mids, o_sc, o_ids, probe, q = args
    if case == "all_dead":
        mids[probe[0].long()] = -1
        o_ids = torch.full_like(o_ids, -1)
    if case == "duplicates":
        probe[:, 1] = probe[:, 0]
        probe[1, :] = probe[1, 2]
    if case == "out_of_range":
        probe[0, 0], probe[1, 2], probe[2, 3] = -5, 12, 10 ** 6
    if case == "dead_tails":
        sizes = torch.randint(0, 101, (12,), generator=gen, device="cuda")
        sizes[0], sizes[1] = 0, 100
        dead = torch.arange(100, device="cuda")[None] >= sizes[:, None]
        mids[dead] = -1
    args = (mv, mids, o_sc, o_ids, probe, q)
    v, i = _screen_equals_gather_topk(args, 60)
    if case == "all_dead":
        assert torch.isneginf(v[0]).all() and (i[0] == -1).all()


@pytest.mark.parametrize("d", [36, 2048])
@pytest.mark.parametrize("b", [4, 5])
def test_ivf_screen_select_widths(gen, d, b):
    """d 36 and tinyllama's 2,048 on random fp32 rows, both score paths:
    bitwise the unfused probe + top-k, two launches equal."""
    _screen_equals_gather_topk(_random_tables(gen, n_c=16, cap=48, d=d, b=b,
                                              n_probe=5, o_cap=10), 64)


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


def _tail_inputs(gen, t, m_cap, k, d=64, n=300, values="ints"):
    """Tail inputs: a table of n rows, t tokens of m_cap tail slots and k S
    values (a quarter of them -inf); small integers (exact sums, ties among
    them) or random fp32."""
    if values == "ints":
        emb, h = _ints(gen, (n, d)), _ints(gen, (t, d))
        pert_s = _ints(gen, (t, k), -10, 10)
        heights = _ints(gen, (t, m_cap), 0, 4) * 0.5
    else:
        emb = torch.randn((n, d), generator=gen, device="cuda")
        h = torch.randn((t, d), generator=gen, device="cuda")
        pert_s = torch.randn((t, k), generator=gen, device="cuda") * 8
        heights = torch.rand((t, m_cap), generator=gen, device="cuda") * 16
    pert_s[:, ::4] = float("-inf")
    pos = torch.randint(0, n, (t, m_cap), generator=gen, device="cuda",
                        dtype=torch.int32)
    s_ids = torch.randint(0, n, (t, k), generator=gen, device="cuda",
                          dtype=torch.int32)
    m_used = torch.full((t,), m_cap, device="cuda", dtype=torch.int32)
    return emb, pos, m_used, pert_s, s_ids, heights, h


@pytest.mark.parametrize("k", [1, 20])
@pytest.mark.parametrize("d", [30, 2048])
def test_tail_gather_argmax_chunk_edges(gen, d, k):
    """m_used around the score kernel's chunk of tail slots (0, 1, chunk -
    1, chunk, chunk + 1, m_cap, and past m_cap, which clamps), m_cap not a
    multiple of the chunk, k = 1 and 20, d not a multiple of 4 and
    tinyllama's 2,048: small integers, so kernel and plain version agree
    bit for bit, ties included."""
    rows = decode_fused.TAIL_ROWS
    m_cap = 3 * rows + 5
    args = list(_tail_inputs(gen, 7, m_cap, k, d=d))
    args[2] = torch.tensor([0, 1, rows - 1, rows, rows + 1, m_cap, m_cap + 9],
                           device="cuda", dtype=torch.int32)
    i, v = decode_fused.tail_gather_argmax(*args)
    wi, wv = ref.tail_gather_argmax_ref(*args)
    assert torch.equal(i, wi) and torch.equal(v, wv)


def test_tail_gather_argmax_ties_and_signed_zeros(gen):
    """Ties the argmax must break as the plain version's first-occurrence
    argmax does: an S value -0.0 against a tail value +0.0 (equal: the S
    slot, the lower index, wins, value -0.0); two tail slots in different
    chunks with one value (the lower slot wins); a token whose every value
    is -inf (index 0: s_ids[0]), and one with no S value (k = 0) and no
    live tail (index 0: pos[0])."""
    rows = decode_fused.TAIL_ROWS
    t, m_cap, k, d = 4, 3 * rows + 2, 6, 16
    emb, pos, m_used, pert_s, s_ids, heights, h = _tail_inputs(gen, t, m_cap,
                                                               k, d=d)
    pert_s[:] = float("-inf")
    heights[:] = 0.0
    # token 0: S slot 2 is -0.0, every live tail slot scores +0.0 (h = 0)
    h[0] = 0.0
    pert_s[0, 2] = -0.0
    # token 1: tail slots 1 and rows + 3 (two chunks) tie at the maximum
    h[1] = 0.0
    heights[1, 1] = heights[1, rows + 3] = 2.5
    # token 2: every value -inf (no live tail)
    m_used[2] = 0
    args = (emb, pos, m_used, pert_s, s_ids, heights, h)
    i, v = decode_fused.tail_gather_argmax(*args)
    wi, wv = ref.tail_gather_argmax_ref(*args)
    assert torch.equal(i, wi) and torch.equal(v, wv)
    assert torch.equal(torch.signbit(v), torch.signbit(wv))
    assert i[0] == s_ids[0, 2] and v[0] == 0 and torch.signbit(v[0])
    assert i[1] == pos[1, 1] and v[1] == 2.5
    assert i[2] == s_ids[2, 0] and torch.isneginf(v[2])
    args0 = (emb, pos[2:3], m_used[2:3], pert_s[2:3, :0], s_ids[2:3, :0],
             heights[2:3], h[2:3])
    i0, v0 = decode_fused.tail_gather_argmax(*args0)
    assert i0[0] == pos[2, 0] and torch.isneginf(v0[0])


@pytest.mark.parametrize("values", ["ints", "random"])
def test_tail_gather_argmax_striding_batch(gen, values):
    """A batch that fills the card on its own, so each score block strides
    over several chunks of a token's slots (300 tokens of 70 slots; 600 at
    tinyllama's d and m_cap for random fp32): bitwise the plain version on
    small integers; on random fp32 two launches bitwise equal and a token
    alone equal to its row of the batch, values within rtol 1e-5 and an atol
    of 1e-5 times the largest |value| (d-term dot products summed in
    another order)."""
    if values == "ints":
        t, m_cap, k, d, n = 300, 70, 20, 64, 300
    else:
        t, m_cap, k, d, n = 600, 728, 576, 2048, 5000
    args = list(_tail_inputs(gen, t, m_cap, k, d=d, n=n, values=values))
    args[2] = torch.randint(0, m_cap + 1, (t,), generator=gen, device="cuda",
                            dtype=torch.int32)
    i, v = decode_fused.tail_gather_argmax(*args)
    wi, wv = ref.tail_gather_argmax_ref(*args)
    if values == "ints":
        assert torch.equal(i, wi) and torch.equal(v, wv)
        return
    i2, v2 = decode_fused.tail_gather_argmax(*args)
    assert torch.equal(i, i2) and torch.equal(v, v2)
    for j in (0, 1, t // 2, t - 1):
        ia, va = decode_fused.tail_gather_argmax(
            args[0], *(a[j:j + 1] for a in args[1:]))
        assert torch.equal(ia[0], i[j]) and torch.equal(va[0], v[j])
    torch.testing.assert_close(v, wv, rtol=1e-5,
                               atol=1e-5 * wv.abs().max().item())


def test_tail_gather_argmax_serving_shape_is_repeatable(gen):
    """The serving path's shape (4 tokens, tinyllama's d, k and m_cap, every
    m_used near l = 576) on random fp32: two launches bitwise equal, each
    token alone equal to its row of the batch, and the plain version's
    indices."""
    t, m_cap, k, d = 4, 728, 576, 2048
    args = list(_tail_inputs(gen, t, m_cap, k, d=d, n=5000, values="random"))
    args[2] = torch.tensor([560, 576, 590, 600], device="cuda",
                           dtype=torch.int32)
    i, v = decode_fused.tail_gather_argmax(*args)
    i2, v2 = decode_fused.tail_gather_argmax(*args)
    assert torch.equal(i, i2) and torch.equal(v, v2)
    for j in range(t):
        ia, va = decode_fused.tail_gather_argmax(
            args[0], *(a[j:j + 1] for a in args[1:]))
        assert torch.equal(ia[0], i[j]) and torch.equal(va[0], v[j])
    wi, wv = ref.tail_gather_argmax_ref(*args)
    assert torch.equal(i, wi)
    torch.testing.assert_close(v, wv, rtol=1e-5,
                               atol=1e-5 * wv.abs().max().item())


def test_kernels_reject_bad_inputs(gen):
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode.flash_decode(torch.zeros(1, 2, 8), torch.zeros(1, 3, 1, 8),
                                  torch.zeros(1, 3, 1, 8), torch.ones(1))
    kv = torch.zeros(2, 3, 1, 8, device="cuda")
    with pytest.raises(ValueError, match="lengths"):
        flash_decode.flash_decode(torch.zeros(2, 2, 8, device="cuda"), kv, kv,
                                  torch.ones(1, device="cuda"))
    with pytest.raises(ValueError, match="pages"):
        flash_decode.flash_decode(torch.zeros(2, 2, 8, device="cuda"), kv, kv,
                                  torch.ones(2, device="cuda"),
                                  pages=torch.zeros(3, 2, device="cuda"))
    codes, mids, coarse, o_sc, o_ids, probe, lut = _pq_tables(gen)
    with pytest.raises(ValueError, match="ksub"):
        pq_lut_score.pq_lut_score(codes, probe, torch.zeros(
            (lut.shape[0], lut.shape[1], 300), device="cuda"))
    with pytest.raises(ValueError, match="uint8"):
        pq_lut_score.pq_lut_score(codes.int(), probe, lut)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pq_lut_score.pq_lut_score(codes.cpu(), probe, lut)
    with pytest.raises(ValueError, match="do not fit"):
        decode_fused.pq_screen_select(codes, mids, coarse[:, :1], o_sc, o_ids,
                                      probe, lut, r=8)
    db = _ints(gen, (50, 16))
    cand = torch.zeros((2, 8), device="cuda", dtype=torch.int32)
    lv = torch.zeros((2, 8), device="cuda")
    q = _ints(gen, (2, 16))
    with pytest.raises(ValueError, match="k=9"):
        decode_fused.rerank_select(db, cand, lv, q, k=9)
    with pytest.raises(ValueError, match="float32"):
        decode_fused.rerank_select(db.double(), cand, lv, q, k=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_fused.rerank_select(db.cpu(), cand, lv, q, k=4)


def _pq_tables(gen, n_c=12, cap=40, m_sub=8, ksub=256, b=5, n_probe=4,
               o_cap=24, values="ints"):
    """IVF-PQ screen inputs: codes, member ids (30 % dead), coarse scores,
    overflow scores and ids (a third dead), probe, LUTs."""
    codes = torch.randint(0, ksub, (n_c, cap, m_sub), generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.uint8)
    mids = torch.randint(0, 1000, (n_c, cap), generator=gen, device="cuda",
                         dtype=torch.int32)
    mids[torch.rand((n_c, cap), generator=gen, device="cuda") < 0.3] = -1
    probe = torch.stack([torch.randperm(n_c, generator=gen, device="cuda")
                         [:n_probe] for _ in range(b)]).int()
    o_ids = torch.randint(0, 1000, (o_cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    o_ids[::3] = -1
    if values == "ints":
        lut = _ints(gen, (b, m_sub, ksub), -3, 4)
        coarse = _ints(gen, (b, n_probe), -5, 6)
        o_sc = _ints(gen, (b, o_cap), -20, 20)
    else:
        lut = torch.randn((b, m_sub, ksub), generator=gen, device="cuda")
        coarse = torch.randn((b, n_probe), generator=gen, device="cuda")
        o_sc = torch.randn((b, o_cap), generator=gen, device="cuda") * 3
    return codes, mids, coarse, o_sc, o_ids, probe, lut


@pytest.mark.parametrize("values", ["ints", "random"])
@pytest.mark.parametrize("m_sub,ksub", [(8, 256), (4, 16), (16, 100)])
def test_pq_lut_score_kernel(gen, m_sub, ksub, values):
    codes, _, _, _, _, probe, lut = _pq_tables(gen, m_sub=m_sub, ksub=ksub,
                                               values=values)
    got = pq_lut_score.pq_lut_score(codes, probe, lut)
    assert torch.equal(got, ref.pq_lut_score_ref(codes, probe, lut))


@pytest.mark.parametrize("cap,b", [(255, 4), (256, 4), (257, 4), (544, 1),
                                   (544, 4), (1800, 4), (544, 256)])
def test_pq_lut_score_split_stages(gen, cap, b):
    """Clusters around the score block's 256 members and a few to many
    queries, so stages split into 1 up to ceil(cap / 256) parts: random
    fp32 LUTs, bitwise the plain version, and two launches equal."""
    codes, _, _, _, _, probe, lut = _pq_tables(gen, n_c=20, cap=cap, b=b,
                                               n_probe=8, values="random")
    got = pq_lut_score.pq_lut_score(codes, probe, lut)
    assert torch.equal(got, ref.pq_lut_score_ref(codes, probe, lut))
    assert torch.equal(got, pq_lut_score.pq_lut_score(codes, probe, lut))


@pytest.mark.parametrize("case", ["ties", "small_pool", "dead_row", "width",
                                  "all_dead", "m_sub4"])
def test_pq_screen_select_kernel(gen, case):
    kw = {"small_pool": dict(n_c=4, cap=4, n_probe=2, o_cap=4),
          "m_sub4": dict(m_sub=4, ksub=16)}.get(case, {})
    codes, mids, coarse, o_sc, o_ids, probe, lut = _pq_tables(gen, **kw)
    r = 16 if case == "small_pool" else 50
    width = None
    if case == "dead_row":
        mids[probe[0].long()] = -1
        o_ids[:] = -1
    if case == "width":
        width = torch.tensor([4, 0, 1, 3, 2], device="cuda",
                             dtype=torch.int32)
    if case == "all_dead":  # row 1: no probe stage and no live overflow
        o_ids[:] = -1
        width = torch.tensor([4, 0, 2, 4, 1], device="cuda",
                             dtype=torch.int32)
    args = (codes, mids, coarse, o_sc, o_ids, probe, lut)
    v, i = decode_fused.pq_screen_select(*args, r=r, probe_width=width)
    wv, wi = ref.pq_screen_select_ref(*args, r, probe_width=width)
    assert torch.equal(i, wi)
    assert torch.equal(v, wv)  # exact: integer-valued scores
    if case in ("dead_row", "all_dead"):
        row = 0 if case == "dead_row" else 1
        assert (i[row] == -1).all() and torch.isneginf(v[row]).all()


def test_pq_screen_select_bitwise_equals_lut_score_plus_top_r(gen):
    """Random fp32 LUTs: the fused screen's values are bitwise
    pq_lut_score's sums plus the coarse term, and its picks those of a
    top-r over them."""
    codes, mids, coarse, o_sc, o_ids, probe, lut = _pq_tables(
        gen, values="random")
    v, i = decode_fused.pq_screen_select(codes, mids, coarse, o_sc, o_ids,
                                         probe, lut, r=64)
    s = pq_lut_score.pq_lut_score(codes, probe, lut) + coarse[..., None]
    pool_s = torch.cat([s.reshape(s.shape[0], -1), o_sc], 1)
    pool_i = torch.cat([mids[probe.long()].reshape(s.shape[0], -1),
                        o_ids[None].expand(s.shape[0], -1)], 1)
    pool_s = torch.where(pool_i >= 0, pool_s, float("-inf"))
    wv, wi = ref.topk_select_ref(pool_s, pool_i, 64)
    assert torch.equal(v, wv) and torch.equal(i, wi)


@pytest.mark.parametrize("case", ["pool_pow2", "pool_pow2_plus1", "r_pool",
                                  "r_past_pool", "pool_max"])
def test_pq_screen_select_pool_edges(gen, case):
    """Pools the select pads to a power of two: exactly 256 slots and 257
    (padded to 512), r = the pool, r past the pool (padding picks: -inf, id
    -1), and the widest pool the select holds, 16,384 slots, at r 1,152.
    Small integers: bitwise the plain version."""
    kw = dict(n_c=12, cap=48, b=5, n_probe=4, o_cap=24)
    pool = 4 * 48 + 24
    r = {"r_pool": pool, "r_past_pool": pool + 9}.get(case, 50)
    if case.startswith("pool_pow2"):
        kw["o_cap"] = 256 - 4 * 48 + (case == "pool_pow2_plus1")
    if case == "pool_max":
        kw.update(n_c=10, cap=1800, n_probe=8, o_cap=16384 - 8 * 1800, b=4)
        r = 1152
    args = _pq_tables(gen, **kw)
    v, i = decode_fused.pq_screen_select(*args, r=r)
    wv, wi = ref.pq_screen_select_ref(*args, r)
    assert torch.equal(v, wv) and torch.equal(i, wi)
    if case == "r_past_pool":
        assert torch.isneginf(v[:, pool:]).all() and (i[:, pool:] == -1).all()


def test_pq_screen_select_rejects_a_pool_past_its_select(gen):
    """A pool wider than the select kernel's 16,384 register-held keys is
    refused before any launch."""
    args = _pq_tables(gen, n_c=4, cap=8, b=2, n_probe=2, o_cap=16)
    with pytest.raises(ValueError, match="pool"):
        decode_fused.pq_screen_select(*args,
                                      r=decode_fused.SCREEN_POOL_MAX + 1)


@pytest.mark.parametrize("b", [1, 4, 5, 256])
def test_pq_screen_select_batches_are_repeatable(gen, b):
    """Random fp32 LUTs at tinyllama's geometry (8 probes of 544 slots, 8 x
    256 codewords, r 1,152), 1 to 256 queries (the score grid splits stages
    for few queries and not for many), some probe widths narrowed: two
    launches bitwise equal, a query screened alone equal to its row of the
    batch, and bitwise pq_lut_score + coarse + a top-r."""
    codes, mids, coarse, o_sc, o_ids, probe, lut = _pq_tables(
        gen, n_c=40, cap=544, b=b, n_probe=8, o_cap=400, values="random")
    width = torch.full((b,), 8, device="cuda", dtype=torch.int32)
    width[b // 2] = 3
    args = (codes, mids, coarse, o_sc, o_ids, probe, lut)
    v, i = decode_fused.pq_screen_select(*args, r=1152, probe_width=width)
    v2, i2 = decode_fused.pq_screen_select(*args, r=1152, probe_width=width)
    assert torch.equal(v, v2) and torch.equal(i, i2)
    for j in sorted({0, b // 2, b - 1}):
        va, ia = decode_fused.pq_screen_select(
            codes, mids, coarse[j:j + 1], o_sc[j:j + 1], o_ids,
            probe[j:j + 1], lut[j:j + 1], r=1152, probe_width=width[j:j + 1])
        assert torch.equal(va[0], v[j]) and torch.equal(ia[0], i[j])
    s = pq_lut_score.pq_lut_score(codes, probe, lut) + coarse[..., None]
    live = torch.arange(8, device="cuda")[None] < width[:, None]
    s = torch.where(live[..., None], s, float("-inf")).reshape(b, -1)
    pool_i = torch.where(live[..., None], mids[probe.long()], -1)
    pool_i = torch.cat([pool_i.reshape(b, -1), o_ids[None].expand(b, -1)], 1)
    pool_s = torch.where(pool_i >= 0, torch.cat([s, o_sc], 1), float("-inf"))
    wv, wi = ref.topk_select_ref(pool_s, pool_i, 1152)
    assert torch.equal(v, wv) and torch.equal(i, wi)


@pytest.mark.parametrize("d", [64, 30])
def test_rerank_select_kernel(gen, d):
    n, b, r, k = 400, 6, 100, 40
    db = _ints(gen, (n, d))
    q = _ints(gen, (b, d))
    cand = torch.randint(0, n, (b, r), generator=gen, device="cuda",
                         dtype=torch.int32)
    lut_vals = torch.randn((b, r), generator=gen, device="cuda")
    cand[:, ::7] = -1  # dead ids
    lut_vals[:, 3::9] = float("-inf")  # dead screening values
    cand[2] = -1  # an all-dead query
    v, i = decode_fused.rerank_select(db, cand, lut_vals, q, k=k)
    wv, wi = ref.rerank_select_ref(db, cand, lut_vals, q, k)
    assert torch.equal(i, wi) and torch.equal(v, wv)
    assert (i[2] == -1).all() and torch.isneginf(v[2]).all()


def _rerank_inputs(gen, b, r, d, n=3000, values="ints"):
    """A table of n rows, b queries and r survivors a query, ~10 % of them
    dead (id -1 or a -inf screening value)."""
    if values == "ints":
        db, q = _ints(gen, (n, d)), _ints(gen, (b, d))
    else:
        db = torch.randn((n, d), generator=gen, device="cuda")
        q = torch.randn((b, d), generator=gen, device="cuda")
    cand = torch.randint(0, n, (b, r), generator=gen, device="cuda",
                         dtype=torch.int32)
    lut_vals = torch.randn((b, r), generator=gen, device="cuda")
    dead = torch.rand((b, r), generator=gen, device="cuda")
    cand[dead < 0.05] = -1
    lut_vals[dead > 0.95] = float("-inf")
    return db, cand, lut_vals, q


@pytest.mark.parametrize("d", [30, 2048])
@pytest.mark.parametrize("b", [1, 4, 256])
@pytest.mark.parametrize("r", [1, decode_fused.RERANK_ROWS - 1,
                               decode_fused.RERANK_ROWS,
                               decode_fused.RERANK_ROWS + 1, 1152])
def test_rerank_select_split_edges(gen, r, b, d):
    """r around the score kernel's chunk of survivors (1, chunk - 1, chunk,
    chunk + 1, and the serving path's 1,152), k = 1 and k = r, 1 to 256
    queries, d not a multiple of 4 and tinyllama's 2,048: small-integer
    values, so kernel and plain version agree bit for bit, ties
    included."""
    args = _rerank_inputs(gen, b, r, d)
    for k in sorted({1, r}):
        v, i = decode_fused.rerank_select(*args, k=k)
        wv, wi = ref.rerank_select_ref(*args, k)
        assert torch.equal(i, wi) and torch.equal(v, wv), (k, b, r, d)


def test_rerank_select_special_survivors(gen):
    """An all-dead query, one with fewer live survivors than k, duplicate
    candidate ids and ids >= n (clamped to the last row, as a gather)."""
    n, d, b, r, k = 50, 64, 5, 100, 40
    db, cand, lut_vals, q = _rerank_inputs(gen, b, r, d, n=n)
    cand[0] = -1  # all dead
    lut_vals[1, :10] = 0.0
    lut_vals[1, 10:] = float("-inf")  # 10 live survivors, k = 40
    cand[1, :10] = torch.arange(10, device="cuda", dtype=torch.int32)
    cand[2, 50:] = cand[2, :50]  # every id twice
    cand[2, cand[2] < 0] = 7
    lut_vals[2] = 0.0
    cand[3, ::2] = n + 5  # past the table, the only live survivors
    lut_vals[3, ::2] = 0.0
    lut_vals[3, 1::2] = float("-inf")
    v, i = decode_fused.rerank_select(db, cand, lut_vals, q, k=k)
    wv, wi = ref.rerank_select_ref(db, cand, lut_vals, q, k)
    assert torch.equal(i, wi) and torch.equal(v, wv)
    assert (i[0] == -1).all() and torch.isneginf(v[0]).all()
    assert (i[1, 10:] == -1).all() and torch.isfinite(v[1, :10]).all()
    assert (i[3] == n + 5).all()  # the id is emitted as given


def test_rerank_select_every_query_names_the_same_rows(gen):
    """256 queries re-rank the same survivors, on random fp32 rows: each
    query alone equals its row of the batch bit for bit."""
    b, r, d, k = 256, 300, 2048, 100
    db, cand, lut_vals, q = _rerank_inputs(gen, b, r, d, n=1000,
                                           values="random")
    cand[:] = cand[0]
    lut_vals[:] = lut_vals[0]
    v, i = decode_fused.rerank_select(db, cand, lut_vals, q, k=k)
    for j in (0, b // 2, b - 1):
        va, ia = decode_fused.rerank_select(db, cand[j:j + 1],
                                            lut_vals[j:j + 1], q[j:j + 1],
                                            k=k)
        assert torch.equal(va[0], v[j]) and torch.equal(ia[0], i[j])
    wv, wi = ref.rerank_select_ref(db, cand, lut_vals, q, k)
    fin = wv[torch.isfinite(wv)]
    torch.testing.assert_close(v, wv, rtol=1e-5,
                               atol=1e-5 * fin.abs().max().item())


def test_rerank_select_query_alone_equals_batch(gen):
    """Random fp32 at tinyllama's width: a query re-ranked alone equals its
    row of a 256-query batch bit for bit, two launches agree, and both are
    within rtol 1e-5 and an atol of 1e-5 times the largest |score| of the
    plain version (2,048-term dot products summed in another order)."""
    b, r, d, k = 256, 1152, 2048, 576
    args = _rerank_inputs(gen, b, r, d, n=5000, values="random")
    v, i = decode_fused.rerank_select(*args, k=k)
    v2, i2 = decode_fused.rerank_select(*args, k=k)
    assert torch.equal(v, v2) and torch.equal(i, i2)
    for j in (0, 1, 77, 255):
        va, ia = decode_fused.rerank_select(
            args[0], *(a[j:j + 1] for a in args[1:]), k=k)
        assert torch.equal(va[0], v[j]) and torch.equal(ia[0], i[j])
    wv, _ = ref.rerank_select_ref(*args, k)
    fin = wv[torch.isfinite(wv)]
    torch.testing.assert_close(v, wv, rtol=1e-5,
                               atol=1e-5 * fin.abs().max().item())


@pytest.mark.parametrize("k", [32, 700], ids=["k32", "k_past_pool"])
def test_ivfpq_screen_select_equals_topk_batch_on_card(gen, k):
    """The IVF-PQ index on the card: ``screen_select`` (pq_screen_select +
    rerank_select) equals ``topk_batch`` (pq_lut_score + top-r +
    rerank_select) bit for bit, ids and values, on random fp32 data."""
    centers = torch.randn((24, 32), generator=gen, device="cuda")
    pick = torch.randint(0, 24, (3000,), generator=gen, device="cuda")
    db = centers[pick] + 0.5 * torch.randn((3000, 32), generator=gen,
                                           device="cuda")
    index = IVFPQIndex.build(db, PQConfig(n_probe=3, m_sub=8, ksub=64))
    assert index.state.db is db
    q = torch.randn((7, 32), generator=gen, device="cuda")
    ops.reset_launch_counts()
    a = index.topk_batch(q, k)
    b = index.screen_select(q, k)
    counts = ops.launch_counts()
    assert counts["pq_lut_score"] == 1 and counts["pq_screen_select"] == 1
    assert counts["rerank_select"] == 2
    assert torch.equal(a.ids, b.ids) and torch.equal(a.values, b.values)


def _estimator_inputs(gen, dtype, n=300, d=64, t=6, m=40, all_dead=True):
    emb = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    ids = torch.randint(0, n, (t, m), generator=gen, device="cuda",
                        dtype=torch.int32)
    h = torch.randn((t, d), generator=gen, device="cuda") * (0.5 / d ** 0.5)
    log_w = torch.randn((t, m), generator=gen, device="cuda")
    log_w[0, ::3] = float("-inf")  # dead slots
    if all_dead:
        log_w[2] = float("-inf")  # an all-dead token
    return emb, ids, h, log_w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 2048, 36])
def test_fused_estimator_kernel(gen, dtype, d):
    emb, ids, h, log_w = _estimator_inputs(gen, dtype, d=d)
    log_z, expv = fused_estimator.fused_estimator(emb, ids, h, log_w)
    want_z, want_v = ref.fused_estimator_ref(emb, ids, h, log_w)
    torch.testing.assert_close(log_z, want_z, equal_nan=True, **TOL)
    torch.testing.assert_close(expv, want_v, equal_nan=True, **TOL)
    assert torch.isneginf(log_z[2]) and torch.isnan(expv[2]).all()
    assert torch.isfinite(log_z[[0, 1, 3, 4, 5]]).all()


def _chunk_inputs(gen, case):
    """Inputs of the forward's edge cases: (emb, ids, h, log_w), with an
    all-dead token 7 wherever t > 7."""
    n, d, t, m, dtype = 32000, 2048, 256, 1152, torch.float32
    if case in ("shared_rows", "duplicates"):
        n, t, m = 500, 64, 100
    elif case in ("d36", "d200", "bf16"):
        n, t, m = 3000, 40, 300
        d = {"d36": 36, "d200": 200, "bf16": 520}[case]
        dtype = torch.bfloat16 if case == "bf16" else dtype
    elif case == "t1":
        t = 1
    elif case == "t300":
        n, d, t, m = 5000, 256, 300, 200
    emb = (torch.randn((n, d), generator=gen, device="cuda") * 0.02).to(dtype)
    h = torch.randn((t, d), generator=gen, device="cuda")
    k = m // 2
    # S: a popular head of 2,000 ids shared across tokens; T: uniform
    ids = torch.cat([
        torch.randint(0, min(2000, n), (t, k), generator=gen, device="cuda"),
        torch.randint(0, n, (t, m - k), generator=gen, device="cuda")], 1)
    log_w = torch.cat([torch.zeros((t, k), device="cuda"),
                       torch.full((t, m - k), 3.0, device="cuda")], 1)
    log_w[:, :k][torch.rand((t, k), generator=gen, device="cuda") < 0.1] = \
        float("-inf")
    if case == "shared_rows":  # every token names the same m rows
        ids = ids[:1].expand(t, m).contiguous()
    if case == "duplicates":  # repeats within a token, ids past the table
        ids[:, 1::3] = ids[:, 0:1]
        ids[:, 2::7] = n + 5
        ids[:, 5::11] = -4
    if t > 7:
        log_w[7] = float("-inf")
    return emb, ids.int(), h, log_w


@pytest.mark.parametrize("case", ["chunk", "shared_rows", "duplicates",
                                  "d36", "d200", "bf16", "t1", "t300"])
def test_fused_estimator_edge_cases(gen, case):
    """The forward at the training chunk (t 256, m 1,152, d 2,048, S from a
    popular head of 2,000 rows), every token naming the same rows, repeated
    and out-of-range ids, d = 36 and d = 200 (not a multiple of 64), bf16
    rows, t = 1 and t = 300 (past one 256-token head chunk): the plain
    version's values (the all-dead token -inf / NaN) and two launches
    bitwise equal."""
    emb, ids, h, log_w = _chunk_inputs(gen, case)
    log_z, expv = fused_estimator.fused_estimator(emb, ids, h, log_w)
    want_z, want_v = ref.fused_estimator_ref(emb, ids.clamp(0, emb.shape[0] - 1),
                                             h, log_w)
    torch.testing.assert_close(log_z, want_z, equal_nan=True, **TOL)
    torch.testing.assert_close(expv, want_v, equal_nan=True, **TOL)
    if ids.shape[0] > 7:
        assert torch.isneginf(log_z[7]) and torch.isnan(expv[7]).all()
    again_z, again_v = fused_estimator.fused_estimator(emb, ids, h, log_w)
    assert torch.equal(log_z.nan_to_num(7.0), again_z.nan_to_num(7.0))
    assert torch.equal(expv.nan_to_num(7.0), again_v.nan_to_num(7.0))


def _route_inputs(gen, case):
    """Inputs of the forward's routes: (emb, ids, h, log_w, row, uses) —
    ``row`` a table row named by exactly ``uses`` live slots (None where
    the case has no such row). Random ids name each row ~2 times, far below
    R; an all-dead token 7 wherever t > 7, but where |U| must reach the
    cap."""
    R = fused_estimator.POPULAR_USES
    n, d, t, m, dtype = 3000, 64, 64, 100, torch.float32
    row, uses = None, None
    if case in ("d36", "d200", "d4096"):
        d = int(case[1:])
    elif case == "bf16":
        dtype = torch.bfloat16
    elif case in ("cap_at", "cap_past"):  # |U| at, and past, the cap
        n, d, t, m = 12000, 36, 64, 4608 if case == "cap_at" else 6144
    elif case == "bands":  # a table of five L2-sized bands of rows
        n, d, t, m = 40000, 512, 64, 700
    elif case.startswith("split"):
        t, m = {"split_t1": (1, 1), "split_t1_m": (1, 1000),
                "split_t4": (4, 131), "split_t64": (64, 70),
                "split_m1": (64, 1)}[case]
    emb = (torch.randn((n, d), generator=gen, device="cuda") * 0.3).to(dtype)
    h = torch.randn((t, d), generator=gen, device="cuda") * (2.0 / d ** 0.5)
    ids = torch.randint(0, n, (t, m), generator=gen, device="cuda")
    log_w = torch.randn((t, m), generator=gen, device="cuda")
    log_w[torch.rand((t, m), generator=gen, device="cuda") < 0.1] = \
        float("-inf")
    if case in ("cap_at", "cap_past"):  # rows 0 .. k-1, 36+ live uses each
        k = 8192 if case == "cap_at" else 10000
        perm = torch.randperm(t * m, generator=gen, device="cuda")
        ids = (perm % k).reshape(t, m)
        log_w = torch.randn((t, m), generator=gen, device="cuda")
    if t > 7 and not case.startswith("cap_"):  # |U| at the cap: all live
        log_w[7] = float("-inf")
    if case.startswith("uses_"):  # row 5 named R-1, R or R+1 times
        uses = R + {"uses_r_minus_1": -1, "uses_r": 0, "uses_r_plus_1": 1}[case]
        row = 5
        ids[ids == row] = row + 1
        ids[3, :2] = row  # one token naming it twice, with other weights
        log_w[3, :2] = torch.tensor([0.5, -1.5], device="cuda")
        free = torch.isfinite(log_w)
        free[3, :2] = False
        cand = free.view(-1).nonzero()[:, 0]
        pick = cand[torch.randperm(cand.numel(), generator=gen,
                                   device="cuda")[:uses - 2]]
        ids.view(-1)[pick] = row
    elif case in ("repeats", "bf16", "d36", "d200", "d4096", "bands"):
        # rows 0-19 popular, named twice by every token; token 9 names row
        # 7 in every other slot
        ids[:, :40] = torch.arange(40, device="cuda") % 20
        if case == "repeats":
            ids[9, 40:] = 7
    elif case == "all_u":  # tokens 0-9: every slot a popular row
        ids[:, :30] = torch.randint(0, 30, (t, 30), generator=gen,
                                    device="cuda")
        ids[:10] = torch.randint(0, 30, (10, m), generator=gen, device="cuda")
        log_w[:7] = torch.randn((7, m), generator=gen, device="cuda")
    return emb, ids.int(), h, log_w, row, uses


@pytest.mark.parametrize("case", [
    "uses_r_minus_1", "uses_r", "uses_r_plus_1", "cap_at", "cap_past",
    "repeats", "all_u", "bands", "bf16", "d36", "d200", "d4096", "split_t1",
    "split_t1_m", "split_t4", "split_t64", "split_m1"])
def test_fused_estimator_routes(gen, case):
    """The forward on the routes of its shape rule: the popular-row plan
    with a row named R-1, R and R+1 times (and twice by one token, with
    other weights), |U| at the cap and past it (slot ranges), tokens naming
    popular rows many times or only popular rows, a walk over five row
    bands, bf16 rows, d 36 / 200 / 4,096; the split stream alone at t 1, 4
    and 64, m 1 and m not a multiple of the range. The plain version's values (the all-dead token -inf / NaN), y
    -inf on exactly the dead slots, two launches bitwise equal, the backward
    from the new y against the plain backward, and the plan against its
    plain version."""
    emb, ids, h, log_w, row, uses = _route_inputs(gen, case)
    n, d = emb.shape
    t, m = ids.shape
    r = fused_estimator.route(n, d, t, m)
    # t < 2R, or too few slots for a row to reach R: the split stream alone
    assert r["popular"] == (case not in ("split_t1", "split_t1_m", "split_t4",
                                         "split_m1"))
    # the plan's slots walked by row band, but past 4,096 slots a token
    assert (r["bands"] > 0) == (r["popular"] and not case.startswith("cap_"))
    if case == "bands":
        assert r["bands"] == 5
    log_z, expv, y = fused_estimator.fused_estimator(emb, ids, h, log_w,
                                                     return_y=True)
    want_z, want_v, want_y = ref.fused_estimator_ref(emb, ids, h, log_w,
                                                     return_y=True)
    torch.testing.assert_close(log_z, want_z, equal_nan=True, **TOL)
    torch.testing.assert_close(expv, want_v, equal_nan=True, **TOL)
    dead = torch.isneginf(log_w)
    assert torch.equal(torch.isneginf(y), dead)
    torch.testing.assert_close(y[~dead], want_y[~dead], **TOL)
    if t > 7 and dead[7].all():
        assert torch.isneginf(log_z[7]) and torch.isnan(expv[7]).all()
    again_z, again_v, again_y = fused_estimator.fused_estimator(
        emb, ids, h, log_w, return_y=True)
    assert torch.equal(log_z.nan_to_num(7.0), again_z.nan_to_num(7.0))
    assert torch.equal(expv.nan_to_num(7.0), again_v.nan_to_num(7.0))
    assert torch.equal(y, again_y)
    if r["popular"]:
        colmap, rows, n_u = fused_estimator.popular_rows(ids, log_w, n,
                                                         cap=r["cap"])
        w_colmap, w_rows, w_n_u = ref.popular_rows_ref(
            ids, log_w, n, fused_estimator.POPULAR_USES, r["cap"])
        assert torch.equal(colmap, w_colmap) and torch.equal(rows, w_rows)
        assert torch.equal(n_u, w_n_u)
        if row is not None:
            assert (colmap[row] >= 0) == (uses >= fused_estimator.POPULAR_USES)
        if case == "cap_at":
            assert int(n_u.item()) == r["cap"] == 8192
        if case == "cap_past":
            assert int(n_u.item()) == r["cap"] and rows[-1] == r["cap"] - 1
        if case == "split_t64":  # the plan runs, no row reaches R
            assert int(n_u.item()) == 0
    live_tok = ~dead.all(1)
    if not live_tok.any():
        return
    bargs = (emb, ids[live_tok], h[live_tok], log_w[live_tok],
             log_z[live_tok], 0.5 + torch.rand((int(live_tok.sum()),),
                                               generator=gen, device="cuda"))
    d_emb, p = fused_estimator.fused_estimator_bwd(*bargs, y=y[live_tok])
    want_d, want_p = ref.fused_estimator_bwd_ref(*bargs)
    torch.testing.assert_close(p, want_p, **TOL)
    torch.testing.assert_close(d_emb, want_d, **TOL)


@pytest.mark.parametrize("case", ["popular", "split"])
def test_fused_estimator_in_a_cuda_graph(gen, case):
    """The forward issues no host sync: one call captured in a CUDA graph
    and replayed on new inputs equals an eager call on them, bit for bit."""
    t = 64 if case == "popular" else 8
    emb, ids, h, log_w, _, _ = _route_inputs(gen, "repeats")
    ids, h, log_w = ids[:t].clone(), h[:t].clone(), log_w[:t].clone()
    fused_estimator.fused_estimator(emb, ids, h, log_w, return_y=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_estimator.fused_estimator(emb, ids, h, log_w,
                                              return_y=True)
    h.copy_(torch.randn(h.shape, generator=gen, device="cuda") * 0.25)
    log_w[1:] = torch.randn(log_w[1:].shape, generator=gen, device="cuda")
    graph.replay()
    want = fused_estimator.fused_estimator(emb, ids, h, log_w, return_y=True)
    torch.cuda.synchronize()
    for a, b in zip(out, want):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    torch.testing.assert_close(out[0], ref.fused_estimator_ref(
        emb, ids, h, log_w)[0], equal_nan=True, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,t,m", [(300, 64, 6, 40), (3, 2048, 8, 100),
                                     (1000, 36, 5, 17)])
def test_fused_estimator_bwd_kernel(gen, dtype, n, d, t, m):
    """n=3 with 800 candidates gives row segments of ~266 entries, many
    32-entry batches of p; n=1000 leaves most rows untouched (exact
    zeros)."""
    emb, ids, h, log_w = _estimator_inputs(gen, dtype, n=n, d=d, t=t, m=m,
                                           all_dead=n > 3)
    log_z, _ = ref.fused_estimator_ref(emb, ids, h, log_w)
    g = torch.randn((t,), generator=gen, device="cuda")
    d_emb, p = fused_estimator.fused_estimator_bwd(emb, ids, h, log_w, log_z,
                                                   g)
    want_d, want_p = ref.fused_estimator_bwd_ref(emb, ids, h, log_w, log_z, g)
    torch.testing.assert_close(p, want_p, equal_nan=True, **TOL)
    torch.testing.assert_close(d_emb, want_d, equal_nan=True, **TOL)
    touched = torch.zeros(n, dtype=torch.bool, device="cuda")
    touched[ids.long().reshape(-1)] = True
    assert torch.equal(d_emb[~touched], torch.zeros_like(d_emb[~touched]))
    # deterministic: no float atomics, so a second run is bitwise the first
    d2, p2 = fused_estimator.fused_estimator_bwd(emb, ids, h, log_w, log_z, g)
    assert torch.equal(d_emb.nan_to_num(7.0), d2.nan_to_num(7.0))
    assert torch.equal(p.nan_to_num(7.0), p2.nan_to_num(7.0))


def _bwd_inputs(gen, case):
    """The backward's edge cases: (emb, ids, h, log_w), dead slots and an
    all-dead token (2) as ``_estimator_inputs`` makes them — none where
    every token names the same rows, whose p would all be NaN."""
    n, d, t, m, dtype = 300, 64, 6, 40, torch.float32
    if case == "t1000":  # past one token tile of h's 128-column slice
        n, d, t, m = 5000, 2048, 1000, 64
    elif case in ("d36", "d132", "d4096"):  # d not a multiple of 128; 4096
        d = int(case[1:])
        n, t, m = (2000, 16, 100) if d == 4096 else (1000, 9, 50)
    elif case == "shared":  # one S for every token: segments of t entries
        n, d, t, m = 3000, 256, 300, 64
    elif case == "n1":  # one row: every entry in one segment
        n, d, t, m = 1, 128, 20, 30
    elif case == "untouched":  # most rows named by no candidate
        n = 20000
    elif case == "bf16":
        n, d, dtype = 500, 520, torch.bfloat16
    emb, ids, h, log_w = _estimator_inputs(
        gen, dtype, n=n, d=d, t=t, m=m, all_dead=case not in ("shared", "n1"))
    if case == "shared":
        ids = ids[:1].expand(t, m).contiguous()
    return emb, ids, h, log_w


@pytest.mark.parametrize("case", ["small", "t1000", "d36", "d132", "d4096",
                                  "shared", "n1", "untouched", "bf16"])
def test_fused_estimator_bwd_from_scores(gen, case):
    """The backward from the forward kernel's scores y: the plain version's
    values, exact zeros on rows no candidate names, two launches bitwise
    equal, and bitwise the wrapper's own y (one forward launch) — the
    training path passes y, other callers may not."""
    emb, ids, h, log_w = _bwd_inputs(gen, case)
    n, t = emb.shape[0], ids.shape[0]
    log_z, _, y = fused_estimator.fused_estimator(emb, ids, h, log_w,
                                                  return_y=True)
    g = torch.randn((t,), generator=gen, device="cuda")
    d_emb, p = fused_estimator.fused_estimator_bwd(emb, ids, h, log_w, log_z,
                                                   g, y=y)
    want_d, want_p = ref.fused_estimator_bwd_ref(emb, ids, h, log_w, log_z, g)
    torch.testing.assert_close(p, want_p, equal_nan=True, **TOL)
    torch.testing.assert_close(d_emb, want_d, equal_nan=True, **TOL)
    touched = torch.zeros(n, dtype=torch.bool, device="cuda")
    touched[ids.long().reshape(-1)] = True
    assert torch.equal(d_emb[~touched], torch.zeros_like(d_emb[~touched]))
    if case == "untouched":
        assert (~touched).sum() > n // 2
    for kw in ({"y": y}, {}):
        d2, p2 = fused_estimator.fused_estimator_bwd(emb, ids, h, log_w,
                                                     log_z, g, **kw)
        assert torch.equal(d_emb.nan_to_num(7.0), d2.nan_to_num(7.0))
        assert torch.equal(p.nan_to_num(7.0), p2.nan_to_num(7.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [36, 2048])
def test_fused_estimator_scores_output(gen, dtype, d):
    """The forward's y: -inf on exactly the dead slots, the plain version's
    scores elsewhere, two launches bitwise equal; log_z and expv bitwise
    the same with and without it."""
    emb, ids, h, log_w = _estimator_inputs(gen, dtype, d=d)
    log_z, expv, y = fused_estimator.fused_estimator(emb, ids, h, log_w,
                                                     return_y=True)
    _, _, want_y = ref.fused_estimator_ref(emb, ids, h, log_w, return_y=True)
    dead = torch.isneginf(log_w)
    assert torch.equal(torch.isneginf(y), dead)
    torch.testing.assert_close(y[~dead], want_y[~dead], **TOL)
    z2, v2 = fused_estimator.fused_estimator(emb, ids, h, log_w)
    _, _, y2 = fused_estimator.fused_estimator(emb, ids, h, log_w,
                                               return_y=True)
    assert torch.equal(log_z, z2) and torch.equal(y, y2)
    assert torch.equal(expv.nan_to_num(7.0), v2.nan_to_num(7.0))


def test_fused_estimator_rejects_bad_inputs(gen):
    emb, ids, h, log_w = _estimator_inputs(gen, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_estimator.fused_estimator(emb.half(), ids, h, log_w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_estimator.fused_estimator(emb.cpu(), ids, h, log_w)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_estimator.fused_estimator(emb[:, :30], ids, h[:, :30], log_w)
    with pytest.raises(ValueError, match="do not fit"):
        fused_estimator.fused_estimator(emb, ids, h[:3], log_w)
    log_z = torch.zeros(ids.shape[0], device="cuda")
    with pytest.raises(ValueError, match="must be"):
        fused_estimator.fused_estimator_bwd(emb, ids, h, log_w, log_z[:2],
                                            log_z)
    with pytest.raises(ValueError, match="y must be"):
        fused_estimator.fused_estimator_bwd(emb, ids, h, log_w, log_z, log_z,
                                            y=log_w[:, :3])


def test_stratified_logz_kernel_path_equals_plain_path(gen):
    """The autograd Function over both kernels against the gather +
    logsumexp formulation on the card: value and gradients w.r.t. emb and
    h. On CUDA tensors ``stratified_logz`` takes the kernels whatever
    ``use_kernel`` says: ``fused_estimator`` and ``fused_estimator_bwd``
    launch once per call and backward either way."""
    emb, ids, h, log_w = _estimator_inputs(gen, torch.float32, all_dead=False)
    g = torch.randn((ids.shape[0],), generator=gen, device="cuda")
    te = emb.clone().requires_grad_(True)
    th = h.clone().requires_grad_(True)
    y = torch.einsum("tmd,td->tm", te[ids.long()], th)
    lz = torch.logsumexp(y + log_w, dim=1)
    (lz * g).sum().backward()
    want = [lz.detach(), te.grad, th.grad]
    for use_kernel in (False, True):
        te = emb.clone().requires_grad_(True)
        th = h.clone().requires_grad_(True)
        ops.reset_launch_counts()
        lz = estimators.stratified_logz(te, th, ids.long(), log_w,
                                        use_kernel=use_kernel)
        (lz * g).sum().backward()
        assert ops.launch_counts()["fused_estimator"] == 1
        assert ops.launch_counts()["fused_estimator_bwd"] == 1
        for a, b in zip(want, [lz.detach(), te.grad, th.grad]):
            torch.testing.assert_close(b, a, **TOL)


# ---------------------------------------------------------------- families
def _family_params(name, module, gen):
    cfg = get_smoke(name)
    p = module.init(gen, cfg, 1, device="cuda")
    return cfg, {k: v[0] for k, v in p.items()}


def _cpu(tree):
    return {k: v.cpu() for k, v in tree.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_forward_on_the_card_is_repeatable_and_matches_the_cpu(gen,
                                                                    dtype):
    """The sort-dispatched MoE: two launches bitwise equal (no atomics in
    the combine), dispatch indices equal to the CPU's, output allclose
    (bf16: rtol 2e-2 and an atol of 2e-2 times the largest magnitude)."""
    cfg, p = _family_params("qwen3-moe-30b-a3b", moe, gen)
    x = torch.randn((96, cfg.d_model), generator=gen, device="cuda").to(dtype)
    a, aux_a = moe.forward(p, cfg, x)
    b, aux_b = moe.forward(p, cfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    want, aux_w = moe.forward(_cpu(p), cfg, x.cpu())
    ra, rw = moe.route(p, cfg, x), moe.route(_cpu(p), cfg, x.cpu())
    for k in ("idx", "order", "rank", "keep", "slot"):
        assert torch.equal(ra[k].cpu(), rw[k]), k
    if dtype == torch.float32:
        torch.testing.assert_close(a.cpu(), want, **TOL)
    else:
        scale = want.float().abs().max().item()
        torch.testing.assert_close(a.float().cpu(), want.float(), rtol=2e-2,
                                   atol=2e-2 * scale)
    torch.testing.assert_close(aux_a.cpu(), aux_w, rtol=1e-4, atol=1e-5)


def test_ssd_and_rglru_forward_on_the_card_match_the_cpu(gen):
    """The chunked SSD scan (two chunks of 16) and the RG-LRU doubling scan
    on the card against the CPU, fp32 (TF32 off): rtol=atol=1e-4."""
    cfg, p = _family_params("mamba2-780m", ssm, gen)
    x = torch.randn((2, 32, cfg.d_model), generator=gen, device="cuda")
    out, cache = ssm.forward(p, cfg, x, chunk=16, return_cache=True)
    want, wc = ssm.forward(_cpu(p), cfg, x.cpu(), chunk=16, return_cache=True)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["state"].cpu(), wc["state"], rtol=1e-4,
                               atol=1e-4)
    y, _ = ssm.decode(p, cfg, x[:, :1], cache)
    wy, _ = ssm.decode(_cpu(p), cfg, x[:, :1].cpu(), wc)
    torch.testing.assert_close(y.cpu(), wy, rtol=1e-4, atol=1e-4)

    cfg, p = _family_params("recurrentgemma-9b", rglru, gen)
    x = torch.randn((2, 33, cfg.d_model), generator=gen, device="cuda")
    out, cache = rglru.forward(p, cfg, x, return_cache=True)
    want, wc = rglru.forward(_cpu(p), cfg, x.cpu(), return_cache=True)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["state"].cpu(), wc["state"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "mamba2-780m",
                                  "recurrentgemma-9b", "qwen3-moe-30b-a3b"])
def test_compute_params_cast_set_on_the_card(gen, name):
    """On CUDA params the cast set is the CPU's: the matmul weights in bf16
    (the rank-4 expert weights too), conv taps, gates and norms in fp32."""
    cfg = get_smoke(name)
    params = transformer.init_params(gen, cfg, device="cuda")
    run = transformer.compute_params(params, torch.bfloat16)
    cpu = transformer.compute_params(
        transformer.init_params(torch.Generator().manual_seed(0), cfg),
        torch.bfloat16)

    def dtypes(tree, path=()):
        if isinstance(tree, dict):
            return {q: d for k, v in tree.items()
                    for q, d in dtypes(v, path + (k,)).items()}
        if isinstance(tree, list):
            return {q: d for i, v in enumerate(tree)
                    for q, d in dtypes(v, path + (i,)).items()}
        return {} if tree is None else {path: tree.dtype}

    assert dtypes(run) == dtypes(cpu)
    for path, dt in dtypes(run).items():
        if path[-1] in ("conv", "lam", "w_a", "w_i", "dt_bias", "a_log",
                        "d_skip") or "norm" in str(path[-1]):
            assert dt == torch.float32, path



# ------------------------------------------------------------ index side
def _lsh_rows(gen, n=4096, d=64):
    x = torch.randn((n, d), generator=gen, device="cuda")
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def test_lsh_build_on_the_card_equals_the_cpu_build(gen):
    """The card hashes the same rows into the same tables: projections
    from the config's seed, fp32 with TF32 off, a stable sort."""
    from repro_torch.core import mips

    db = _lsh_rows(gen)
    cfg = mips.LSHConfig(n_tables=8, n_bits=8, bucket_cap=24, seed=5)
    dev = mips.build_index(cfg, db)
    cpu = mips.build_index(cfg, db.cpu())
    assert torch.equal(dev.db_aug.cpu(), cpu.db_aug)
    assert torch.equal(dev.counts.cpu(), cpu.counts)
    assert torch.equal(dev.table_ids.cpu(), cpu.table_ids)
    assert dev.dropped_count == cpu.dropped_count > 0
    q = _lsh_rows(gen, 16) * 5.0
    got, want = dev.topk_batch(q, 64), cpu.topk_batch(q.cpu(), 64)
    assert torch.equal(got.ids.cpu(), want.ids)
    torch.testing.assert_close(got.values.cpu(), want.values, **TOL)


def test_lsh_sampler_chunked_equals_unchunked(gen, monkeypatch):
    from repro_torch.core import mips

    db = _lsh_rows(gen, 8192, 32)
    index = mips.build_index(mips.LSHConfig(n_tables=12, n_bits=5,
                                            bucket_cap=8192), db)
    h = db[:20] * 8.0
    whole = estimators.lsh_sampler_logz(index, h, per_table=True)
    per_table_bytes = h.shape[0] * 8192 * 16
    for chunk in (1, 5, 12):  # tables a chunk
        monkeypatch.setattr(estimators, "_LSH_CHUNK_BYTES",
                            chunk * per_table_bytes)
        got = estimators.lsh_sampler_logz(index, h, per_table=True)
        assert torch.equal(got, whole)
    cpu = estimators.lsh_sampler_logz(
        mips.LSHIndex(index.config, type(index.state)(
            *(x.cpu() for x in index.state))), h.cpu(), per_table=True)
    torch.testing.assert_close(whole.cpu(), cpu, **TOL)


def test_lsh_sampler_candidate_path_on_the_card_equals_cpu(gen):
    from repro_torch.core import mips

    db = _lsh_rows(gen, 8192, 32)
    index = mips.build_index(mips.LSHConfig(n_tables=8, n_bits=6,
                                            bucket_cap=512), db)
    assert index.n_tables * index.bucket_cap < db.shape[0]
    # queries that are not rows: a query along a row has a cosine within
    # ulps of 1 with it, where arccos turns one ulp of the dot into ~1e-4
    # of the weight (fp32 against fp64: 8.5e-5 on rows, 8.5e-7 off them)
    h = _lsh_rows(gen, 20, 32) * 8.0
    got = estimators.lsh_sampler_logz(index, h, per_table=True)
    cpu = estimators.lsh_sampler_logz(
        mips.LSHIndex(index.config, type(index.state)(
            *(x.cpu() for x in index.state))), h.cpu(), per_table=True)
    assert torch.equal(torch.isneginf(got.cpu()), torch.isneginf(cpu))
    fin = torch.isfinite(cpu)
    torch.testing.assert_close(got.cpu()[fin], cpu[fin], **TOL)


def test_cluster_outer_on_the_card_equals_per_row_form(gen):
    from repro_torch.core.quant import kmeans

    u = torch.randn((3000, 48), generator=gen, device="cuda")
    assign = torch.randint(0, 40, (3000,), generator=gen, device="cuda")
    want = torch.zeros((45, 48, 48), device="cuda").index_add_(
        0, assign, u[:, :, None] * u[:, None, :])
    torch.testing.assert_close(kmeans.cluster_outer(u, assign, 45), want,
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ sharding
def test_sharded_index_and_dist_head_on_the_card_equal_cpu(gen, tmp_path):
    import numpy as np

    import _torch_dist as td

    r = np.random.default_rng(0)
    emb = (r.standard_normal((4096, 64)) / 8.0).astype(np.float32)
    n_loc = 2048
    n_c = 45  # the IVF geometry's max(4, sqrt(2048)) clusters a shard
    init = np.stack([emb[s * n_loc:(s + 1) * n_loc][r.permutation(n_loc)[
        :n_c]] for s in range(2)])
    spec = {"emb": emb, "init_cent": init,
            "q": (r.standard_normal((16, 64)) * 2.0).astype(np.float32),
            "tgt": r.integers(0, 4096, 16)}
    outs = td.spawn(td.cuda_sharded_cases, tmp_path, 1, 2, spec,
                    timeout_s=300, device=None)
    for o in outs:
        c, g = o["cpu"], o["cuda"]
        assert (c["ids"] == g["ids"]).all()
        torch.testing.assert_close(torch.from_numpy(g["values"]),
                                   torch.from_numpy(c["values"]), **TOL)
        torch.testing.assert_close(torch.from_numpy(g["loss"]),
                                   torch.from_numpy(c["loss"]), **TOL)
        assert (c["sample"] == g["sample"]).all()
        assert (c["ok"] == g["ok"]).all()
    assert (outs[0]["cuda"]["sample"] == outs[1]["cuda"]["sample"]).all()
