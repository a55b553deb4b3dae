"""The port's paged KV pool and admission schedulers, on ``device="cpu"``.

Against the JAX package: the host allocator, the spec, the page rows and
both schedulers on the same call sequences and clocks (raises included);
paged ``attention.decode`` and paged ``insert_cache_slots`` on the same
inputs. Inside the port: the paged layout decodes the dense layout's tokens
bit for bit (mixed lengths, EOS re-admission, slot recycling, a pool so
tight that admission stalls, the adaptive probe's width trace), and the
config validation of the reference's ``tests/test_paging.py``.

Tolerances: paged decode outputs and the pool rows it writes fp32
rtol=atol=1e-4 (the q/k/v projections are matmuls reduced in different
orders by XLA-CPU and PyTorch); every pool row the reference leaves alone,
and every row of the paged insert, exactly. The port's pool has one more
block than the reference's, the sink at id ``n_blocks`` that takes the
writes the reference's scatter drops: only blocks 0 .. n_blocks-1 are
compared.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, strategies as st

from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.serve import paging as jpaging
from repro.serve.scheduler import make_scheduler as jmake_scheduler
from repro_torch.configs import get_smoke
from repro_torch.models import attention, transformer
from repro_torch.models.model import Model
from repro_torch.serve import paging
from repro_torch.serve.scheduler import make_scheduler
from repro_torch.serve.server import ServeConfig, Server

# one intra-op thread: the suite runs six workers on the same cores
torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _outcome(fn):
    """(value, None) or (None, exception type) of calling ``fn``."""
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return None, type(e)
    if isinstance(out, np.ndarray):
        out = (out.dtype.str, out.tolist())
    return out, None


# ------------------------------------------------ host side against JAX
def _allocator_script(mod):
    """One call sequence on an allocator of ``mod`` -> every outcome."""
    sp = mod.PagedSpec(block_len=8, n_blocks=6, n_pages=4)
    al = mod.BlockAllocator(sp)
    out = []
    rec = lambda f: out.append(_outcome(f))  # noqa: E731
    rec(lambda: (al.n_free, al.n_used, al.utilization))
    rec(lambda: al.alloc(3))
    rec(lambda: al.free([1]))
    rec(lambda: al.alloc(1))
    rec(lambda: al.can_alloc(3))
    rec(lambda: al.can_alloc(4))
    rec(lambda: al.alloc(4))  # exhausted
    rec(lambda: al.free([1]))
    rec(lambda: al.free([1]))  # double free
    rec(lambda: al.free([99]))  # never allocated
    rec(lambda: al.alloc(4))
    rec(lambda: (al.n_free, al.n_used, al.utilization, sorted(al._free)))
    rec(lambda: al.free([0, 2, 1, 3, 4, 5]))
    rec(lambda: sorted(al._free))
    for prompt, new in ((1, 0), (8, 0), (9, 0), (8, 8), (100, 100), (0, 1)):
        rec(lambda p=prompt, n=new: sp.pages_needed(p, n))
    rec(lambda: sp.sentinel)
    rec(lambda: mod.page_row(sp, [7, 2]))
    rec(lambda: mod.page_row(sp, []))
    rec(lambda: mod.page_row(sp, [0, 1, 2, 3, 4]))
    return out


def test_allocator_spec_and_page_rows_match_jax():
    assert _allocator_script(paging) == _allocator_script(jpaging)


@pytest.mark.parametrize("max_seq,block_len", [(64, 16), (64, 7), (64, 64),
                                               (32, 8), (512, 64)])
def test_spec_from_arch_matches_jax(max_seq, block_len):
    def spec(mod, cfg):
        return _outcome(lambda: mod.PagedSpec.from_arch(
            cfg, max_seq, block_len, 8).__dict__)

    assert (spec(paging, get_smoke(ARCH))
            == spec(jpaging, jget_smoke(ARCH)))


def _scheduler_script(make):
    reqs = {
        0: {"t_enq": 0.0, "priority": 1},
        1: {"t_enq": 5.0, "priority": 0},
        2: {"t_enq": -5.0, "priority": 1},
        3: {"t_enq": 0.04},
    }
    windows = [1, 2, 8]
    out = []
    for s in (make("fifo"), make("slo", ttft_slo_s=0.1),
              make("slo", ttft_slo_s=2.0)):
        out.append((s.name, s.skip_blocked))
        for waiting in ([0, 1, 2], [2, 0, 1], [3, 0], []):
            for now in (0.0, 0.05, 0.088, 9.0, 99.0):
                out.append(s.order(waiting, reqs, now))
                for itl in (0.0, 5.0, 40.0):
                    out.append(s.pick_window(waiting, reqs, now, itl,
                                             windows))
    out.append(_outcome(lambda: make("edf")))
    return out


def test_schedulers_match_jax():
    assert (_scheduler_script(make_scheduler)
            == _scheduler_script(jmake_scheduler))


# --------------------------------------------- device side against JAX
def _t(x):
    return torch.from_numpy(np.array(x))


def _pool_case(seed=0, block_len=8, n_pages=4):
    cfg = jget_smoke(ARCH)
    r = np.random.default_rng(seed)
    b = 4
    n_blocks = b * n_pages + 2
    shape = (n_blocks, block_len, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: r.standard_normal(shape).astype(np.float32) for n in "kv"}
    perm = r.permutation(n_blocks)[: b * n_pages].reshape(b, n_pages)
    pages = perm.astype(np.int32)
    return cfg, r, n_blocks, pool, pages


def test_paged_decode_matches_jax():
    """One paged decode step of one attention layer: ring rows whose pages
    are allocated, a slot whose write is masked, sentinel pages past a
    slot's length; positions across blocks and at a block's last row."""
    cfg, r, n_blocks, pool, pages = _pool_case()
    block_len, n_pages = pool["k"].shape[1], pages.shape[1]
    pos = np.asarray([3, 17, 31, 8], np.int32)
    used = -(-(pos + 1) // block_len)
    pages = np.where(np.arange(n_pages)[None] < used[:, None], pages,
                     n_blocks).astype(np.int32)
    write_mask = np.asarray([True, False, True, True])
    p = jax.device_get(jattn.init(jax.random.key(0), cfg))
    x = r.standard_normal((4, 1, cfg.d_model)).astype(np.float32)
    jout, jc = jattn.decode(
        p, cfg, jnp.asarray(x), {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(pos), use_kernel=False, pages=jnp.asarray(pages),
        write_mask=jnp.asarray(write_mask))
    tpool = {n: torch.cat([_t(a), torch.zeros((1,) + a.shape[1:])])
             for n, a in pool.items()}
    tout, tc = attention.decode({n: _t(a) for n, a in p.items()}, cfg,
                                _t(x), tpool, _t(pos), pages=_t(pages),
                                write_mask=_t(write_mask))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for n in "kv":
        want = np.asarray(jc[n])
        got = tc[n][:n_blocks].numpy()
        np.testing.assert_allclose(got, want, **TOL)
        same = want == pool[n]  # rows the reference left alone
        assert same.sum() == want.size - 3 * cfg.n_kv_heads * cfg.head_dim
        np.testing.assert_array_equal(got[same], want[same])


def test_paged_insert_cache_slots_matches_jax():
    """A prefill-built ring cut into pages and written to each admitted
    row's blocks: pad rows (all sentinel) and unallocated pages dropped,
    every other pool row untouched."""
    cfg, r, n_blocks, pool, pages = _pool_case(seed=1)
    layers = 2
    block_len, n_pages = pool["k"].shape[1], pages.shape[1]
    full = {n: np.stack([a] * layers) for n, a in pool.items()}
    full["v"] = full["v"] + 1.0  # layers and leaves differ
    ring = (layers, 4, n_pages * block_len, cfg.n_kv_heads, cfg.head_dim)
    part = {n: r.standard_normal(ring).astype(np.float32) for n in "kv"}
    pages[1, 2:] = n_blocks  # a short request
    pages[3] = n_blocks  # an admission pad row
    slots = np.asarray([0, 1, 2, 4], np.int32)
    jfull = [{"0": {n: jnp.asarray(a) for n, a in full.items()}}]
    jpart = [{"0": {n: jnp.asarray(a) for n, a in part.items()}}]
    jout = jtr.insert_cache_slots(jfull, jpart, jnp.asarray(slots), cfg=cfg,
                                  pages=jnp.asarray(pages))
    tfull = [{"0": {n: torch.cat([_t(a), torch.zeros((layers, 1)
                                                     + a.shape[2:])], dim=1)
                    for n, a in full.items()}}]
    tpart = [{"0": {n: _t(a) for n, a in part.items()}}]
    tout = transformer.insert_cache_slots(tfull, tpart, _t(slots),
                                          pages=_t(pages))
    for n in "kv":
        np.testing.assert_array_equal(tout[0]["0"][n][:, :n_blocks].numpy(),
                                      np.asarray(jout[0]["0"][n]))


def test_init_pool_and_cache_geometry():
    cfg = get_smoke(ARCH)
    layout = transformer.PagedLayout(block_len=16, n_blocks=5)
    assert layout.n_pages(cfg, 64) == 4 and layout.sentinel == 5
    cache = transformer.init_cache(cfg, 3, 64, torch.float32,
                                   paged=layout)
    assert cache[0]["0"]["k"].shape == (cfg.n_layers, 6, 16, cfg.n_kv_heads,
                                        cfg.head_dim)
    with pytest.raises(ValueError):
        transformer.init_cache(cfg, 3, 64, torch.float32,
                               paged=transformer.PagedLayout(7, 5))
    jbytes = jattn.cache_bytes_per_slot(jget_smoke(ARCH), 64, jnp.bfloat16)
    assert attention.cache_bytes_per_slot(cfg, 64, torch.bfloat16) == jbytes
    assert transformer.ring_len(cfg, 64) == jtr.ring_len(jget_smoke(ARCH), 64)


# ------------------------------------------------ paged == dense, serving
@functools.lru_cache(maxsize=None)
def _mk(vocab=512, **scale):
    cfg = get_smoke(ARCH).scaled(vocab=vocab, **scale)
    return cfg, Model(cfg, "f32", device="cpu").init(0)


def _server(cfg, params, **kw):
    return Server(cfg, params, ServeConfig(**kw), precision_policy="f32",
                  device="cpu")


def _prompts(cfg, lengths, seed=0):
    r = np.random.default_rng(seed)
    return [list(r.integers(0, cfg.vocab, size=int(n))) for n in lengths]


def test_paged_config_validation():
    cfg, params = _mk()
    base = dict(batch_slots=2, max_seq=32, max_new_tokens=8)
    with pytest.raises(ValueError, match="pipelined"):
        _server(cfg, params, engine="reference", block_len=8, **base)
    with pytest.raises(ValueError, match="scheduler"):
        _server(cfg, params, sched="edf", **base)
    with pytest.raises(ValueError):  # 7 does not divide the 32-position ring
        _server(cfg, params, block_len=7, **base)
    # a pool that cannot hold the maximal admissible request (24 + 8 = 32
    # positions = 4 blocks) would stall forever: refused at construction
    with pytest.raises(ValueError, match="maximal"):
        _server(cfg, params, block_len=8, n_blocks=3, **base)
    _server(cfg, params, block_len=8, n_blocks=4, **base)
    ref = _server(cfg, params, engine="reference", **base)
    with pytest.raises(ValueError):
        ref.run([[1, 2, 3]], arrivals=[0.0])


def test_paged_matches_reference_engine_bitwise():
    """The dense single-step reference loop against the paged pipelined
    engine: tokens and certificate outcomes identical, every block freed."""
    cfg, params = _mk()
    prompts = _prompts(cfg, [3, 9, 5, 12, 7, 4])
    base = dict(batch_slots=2, max_seq=32, max_new_tokens=6, seed=11)
    ref = _server(cfg, params, engine="reference", **base)
    pg = _server(cfg, params, decode_window=8, block_len=8, **base)
    r_ref, r_pg = ref.run(prompts), pg.run(prompts)
    assert [r.tokens for r in r_ref] == [r.tokens for r in r_pg]
    assert [r.ok_rate for r in r_ref] == [r.ok_rate for r in r_pg]
    assert pg.alloc.n_used == 0


@pytest.mark.parametrize("mips", ["ivf", "ivfpq"])
def test_paged_parity_index_heads(mips):
    cfg, params = _mk(4096, head_mode="amortized", head_mips=mips)
    prompts = _prompts(cfg, [4, 11, 6, 9], seed=2)
    base = dict(batch_slots=2, max_seq=32, max_new_tokens=4, seed=5,
                decode_window=4)
    dense = _server(cfg, params, **base)
    pg = _server(cfg, params, block_len=8, **base)
    pg.index = dense.index
    r_d, r_p = dense.run(prompts), pg.run(prompts)
    assert [r.tokens for r in r_d] == [r.tokens for r in r_p]
    assert [r.ok_rate for r in r_d] == [r.ok_rate for r in r_p]


def test_block_exhaustion_recoverable_never_oob():
    """A pool of exactly one maximal request forces admission stalls;
    they resolve as requests retire, no block leaks, tokens unchanged."""
    cfg, params = _mk()
    prompts = _prompts(cfg, [2, 14, 5, 9, 13, 3, 8, 11], seed=4)
    base = dict(batch_slots=3, max_seq=32, max_new_tokens=8, seed=2,
                decode_window=4)
    dense = _server(cfg, params, **base)
    tight = _server(cfg, params, block_len=8, n_blocks=4, **base)
    r_d, r_t = dense.run(prompts), tight.run(prompts)
    assert [r.tokens for r in r_d] == [r.tokens for r in r_t]
    assert all(r.status == "ok" for r in r_t)
    assert tight.stats["block_stalls"] > 0
    assert tight.alloc.n_used == 0
    assert tight.stats["block_util_peak"] > 0.5


def test_queue_time_and_gauges():
    cfg, params = _mk()
    srv = _server(cfg, params, batch_slots=2, max_seq=32, max_new_tokens=6,
                  decode_window=4, block_len=8)
    rs = srv.run(_prompts(cfg, [5, 3, 8, 6, 4, 7], seed=1))
    for r in rs:
        assert r.queue_time_s >= 0.0
        assert r.ttft_s >= r.queue_time_s
    st = srv.stats
    assert st["slot_occupancy_peak"] == 2
    assert st["queue_depth_peak"] >= 1
    assert 0.0 < st["block_util_peak"] <= 1.0
    assert st["cache_bytes"] > 0
    assert st["slot_occupancy"] == 0


# ------------------------------------------- randomized admission traces
@functools.lru_cache(maxsize=None)
def _pair(kind):
    if kind == "eos":  # a tiny vocab hits EOS fast: re-admission
        cfg, params = _mk(32)
        base = dict(batch_slots=2, max_seq=32, max_new_tokens=12, eos_id=7,
                    seed=6, decode_window=4)
        dense = _server(cfg, params, **base)
        # 6 blocks < 2 slots x 4 pages: stalls interleave with re-admission
        pg = _server(cfg, params, block_len=8, n_blocks=6, **base)
    else:  # the adaptive IVF probe: certificate-driven widths per token
        cfg, params = _mk(4096, head_mode="amortized", head_mips="ivf",
                          head_adaptive_probe=True, head_n_probe_init=2)
        base = dict(batch_slots=2, max_seq=32, max_new_tokens=4, seed=6,
                    decode_window=4)
        dense = _server(cfg, params, **base)
        pg = _server(cfg, params, block_len=8, **base)
        pg.index = dense.index
    return cfg, dense, pg


def _run_pair(kind, lengths, seed):
    cfg, dense, pg = _pair(kind)
    prompts = _prompts(cfg, lengths, seed=seed)
    h0_d = dict(dense.stats["probe_width_hist"])
    h0_p = dict(pg.stats["probe_width_hist"])
    # both servers of a pair always run together, so their run counts
    # (which seed each run's stream) stay equal
    r_d, r_p = dense.run(prompts), pg.run(prompts)
    assert [r.tokens for r in r_d] == [r.tokens for r in r_p], (
        f"layout divergence: lengths={lengths} seed={seed}")
    assert [r.ok_rate for r in r_d] == [r.ok_rate for r in r_p]
    assert pg.alloc.n_used == 0

    def delta(h1, h0):
        return {k: v - h0.get(k, 0) for k, v in h1.items()
                if v != h0.get(k, 0)}

    assert (delta(dense.stats["probe_width_hist"], h0_d)
            == delta(pg.stats["probe_width_hist"], h0_p))
    return r_d


@settings(max_examples=3, deadline=None)
@given(data=st.data())
def test_admission_trace_property_eos_recycling(data):
    n = data.draw(st.integers(min_value=5, max_value=9))
    lengths = data.draw(st.lists(st.integers(min_value=1, max_value=20),
                                 min_size=n, max_size=n))
    seed = data.draw(st.integers(min_value=0, max_value=2**31 - 1))
    for r in _run_pair("eos", tuple(lengths), seed):
        if len(r.tokens) < 12:
            assert r.tokens[-1] == 7


@settings(max_examples=3, deadline=None)
@given(data=st.data())
def test_admission_trace_property_probe_widths(data):
    n = data.draw(st.integers(min_value=4, max_value=6))
    lengths = data.draw(st.lists(st.integers(min_value=1, max_value=20),
                                 min_size=n, max_size=n))
    seed = data.draw(st.integers(min_value=0, max_value=2**31 - 1))
    rs = _run_pair("adaptive", tuple(lengths), seed)
    assert all(len(r.tokens) == 4 for r in rs)
