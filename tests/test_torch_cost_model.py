"""The port's cost model (``repro_torch.launch.cost_model``, the counterpart
of ``repro/launch/hlo_analysis.py``), its roofline and its dry run:

* the counterparts of ``tests/test_hlo_analysis.py``: a loop of 11 matmuls
  counts 2·128³·11 flops exactly, a nested loop 2·64³·12, a batched einsum
  2·4·32·48·16; ``x * 2`` moves at least its read and its write; each
  collective's operand bytes follow the reference's rule (all-gather:
  result / group, reduce-scatter: result × group, the rest: the result);
* ``roofline.analyze`` on fixed counts;
* each ``kernels/cost.py`` count equals the formula ``chip_smoke.py``'s
  records used for the kernel's bound before the counts moved there, at
  the serving and training shapes of tinyllama-1.1b, with this run's
  data-dependent figures (distinct clusters, live rows);
* a data-dependent op on meta fails, naming the op;
* the meta trace of a small train step on a virtual (2, 2) mesh records,
  per kind and axis, exactly the collective bytes that rank 0 of a real
  gloo run of the same step records;
* a smoke train step's counted flops against the reference's
  ``analyze_hlo`` of the same single-device cell (the ratio printed, held
  within [0.5, 2]);
* ``python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape
  decode_32k --multi-pod single`` exits 0.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from repro_torch import collectives as coll
from repro_torch.kernels import cost
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline
from repro_torch.launch.cost_model import CostMode, DataDependentOp, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ----------------------------------------------- test_hlo_analysis's five
def test_loop_matmul_flops_exact():
    def f(x, w):
        c = x
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c @ w

    _, c = trace(f, _meta(128, 128), _meta(128, 128))
    assert c.flops == 2 * 128**3 * 11
    assert c.flops_by_dtype == {"fp32": 2 * 128**3 * 11}


def test_nested_loop_flops():
    def f(x, w):
        c = x
        for _ in range(4):
            for _ in range(3):
                c = c @ w
        return c

    _, c = trace(f, _meta(64, 64), _meta(64, 64))
    assert c.flops == 2 * 64**3 * 12


def test_batched_dot_contraction_dims():
    _, c = trace(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                 _meta(4, 32, 48), _meta(4, 48, 16))
    assert c.flops == 2 * 4 * 32 * 48 * 16
    _, c = trace(lambda a, b: a @ b, _meta(4, 32, 48, dtype=torch.bfloat16),
                 _meta(4, 48, 16, dtype=torch.bfloat16))
    assert c.flops_by_dtype == {"bf16": 2 * 4 * 32 * 48 * 16}


def test_hbm_bytes_lower_bounded_by_io():
    n = 1 << 20
    _, c = trace(lambda x: x * 2.0, _meta(n))
    assert c.hbm_bytes >= 2 * 4 * n  # read + write
    assert c.peak_bytes == 4 * n  # the one fresh output


def test_collective_operand_rules():
    """Per kind on a virtual axis of 4: the operand bytes of the reference's
    rule, a count each, and 2 × the operand in HBM."""
    ax = coll.Axis.virtual("model", 4)
    x = _meta(64, 32)  # 8 KiB

    def f():
        g = coll.all_gather(x, ax)  # result 4x: operand = result / 4
        assert g.shape == (4, 64, 32) and g.is_meta
        r = coll.reduce_scatter(x, ax, dim=0)  # result / 4: operand = res * 4
        assert r.shape == (16, 32)
        s = coll.psum(x[:, :16].contiguous(), ax)  # same shape
        assert s.shape == (64, 16)

    _, c = trace(f)
    nb = 64 * 32 * 4
    assert c.coll_by_kind == {"all-gather": nb, "reduce-scatter": nb,
                              "all-reduce": nb / 2}
    assert c.coll_counts == {"all-gather": 1, "reduce-scatter": 1,
                             "all-reduce": 1}
    assert c.coll_by_axis == {("all-gather", "model"): nb,
                              ("reduce-scatter", "model"): nb,
                              ("all-reduce", "model"): nb / 2}
    assert c.hbm_sites["collective"] == 2 * 2.5 * nb
    with pytest.raises(ValueError, match="virtual axis"):
        coll.psum(torch.zeros(3), ax)  # never a stand-in for a real axis


def test_data_dependent_op_fails_by_name():
    with pytest.raises(DataDependentOp, match="_local_scalar_dense"):
        trace(lambda x: x.sum().item(), _meta(4))
    with pytest.raises(DataDependentOp, match="nonzero"):
        trace(lambda x: torch.nonzero(x), _meta(4))


# -------------------------------------------------------------- roofline
def test_roofline_on_fixed_counts():
    from repro_torch.launch.cost_model import CostRecord

    c = CostRecord(flops=1.989e12, flops_by_dtype={"bf16": 989e9,
                                                   "fp32": 1e12},
                   hbm_bytes=6.7e9, coll_bytes=4.5e8,
                   coll_by_kind={"all-reduce": 4.5e8},
                   coll_counts={"all-reduce": 3})
    rep = roofline.analyze("a", "s", "16x16", 256, c, model_flops=1e14)
    assert rep.t_compute == pytest.approx(1e-3 + 1e12 / 67e12)
    assert rep.t_memory == pytest.approx(2e-3)
    assert rep.t_collective == pytest.approx(1e-3)
    assert rep.bottleneck == "compute"  # 15.9 ms of fp32 at 67 TFLOP/s
    assert rep.useful_frac == pytest.approx(1e14 / (1.989e12 * 256))
    assert roofline.HW["peak_flops"] == {"bf16": 989e12, "fp32": 67e12}
    assert roofline.HW["hbm_bw"] == 3.35e12


# -------------------------------------------------- kernels/cost.py counts
def _nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _geometry():
    """chip_smoke.py's serving geometry at tinyllama-1.1b's width."""
    from repro_torch.configs import get
    from repro_torch.core.gumbel import default_m_cap
    from repro_torch.core.mips.ivf import IVFConfig, _geometry
    from repro_torch.core.mips.pq import PQConfig
    from repro_torch.models.model import head_config

    cfg = get("tinyllama-1.1b")
    hc = head_config(cfg)
    n_c, cap, o_cap = _geometry(cfg.vocab, IVFConfig(n_probe=hc.n_probe))
    return dict(slots=4, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                hd=cfg.head_dim, n=cfg.vocab, d=cfg.d_model, n_c=n_c,
                cap=cap, o_cap=o_cap, n_probe=hc.n_probe, k=hc.k,
                m_cap=default_m_cap(hc.l), m_sub=PQConfig().m_sub,
                ksub=PQConfig().ksub, r=2 * max(8, hc.k))


@pytest.mark.parametrize("b", [4, 256])
def test_kernel_counts_equal_chip_smoke_bounds(b):
    g = _geometry()
    gen = torch.Generator().manual_seed(b)
    i32 = torch.int32
    # flash_decode over the 4 x 512 and 4 x 2,048 rings (bf16)
    for s in (512, 2048):
        q = _meta(g["slots"], g["hq"], g["hd"], dtype=torch.bfloat16)
        kc = _meta(g["slots"], s, g["hkv"], g["hd"], dtype=torch.bfloat16)
        lengths = torch.randint(0, s + 1, (g["slots"],), generator=gen,
                                dtype=i32)
        live = int(lengths.clamp(1, s).sum())
        got = cost.flash_decode(q, kc, lengths, live=live)
        assert got == (_nb(q, lengths) + 2 * live * g["hkv"] * g["hd"] * 2
                       + g["slots"] * g["hq"] * g["hd"] * 4,
                       4 * live * g["hq"] * g["hd"], "bf16")
        pages = torch.zeros((g["slots"], s // 64), dtype=i32)
        pool = _meta(4 * s // 64 + 1, 64, g["hkv"], g["hd"],
                     dtype=torch.bfloat16)
        got = cost.flash_decode(q, pool, lengths, pages=pages, live=live)
        assert got.bytes == (_nb(q, lengths, pages)
                             + 2 * live * g["hkv"] * g["hd"] * 2
                             + g["slots"] * g["hq"] * g["hd"] * 4)
    # the IVF probe: b queries over n_probe of n_c clusters
    mv = _meta(g["n_c"], g["cap"], g["d"])
    mids = torch.randint(-1, g["n"], (g["n_c"], g["cap"]), generator=gen,
                         dtype=i32)
    probe = torch.randint(0, g["n_c"], (b, g["n_probe"]), generator=gen,
                          dtype=i32)
    qv = _meta(b, g["d"])
    uniq = torch.unique(probe)
    got = cost.ivf_gather_score(mv, mids, probe, qv, n_unique=uniq.numel())
    assert got == (uniq.numel() * g["cap"] * (g["d"] + 1) * 4
                   + _nb(probe, qv) + b * g["n_probe"] * g["cap"] * 8,
                   2.0 * b * g["n_probe"] * g["cap"] * g["d"], "fp32")
    o_sc, o_ids = _meta(b, g["o_cap"]), _meta(g["o_cap"], dtype=i32)
    live_rows = int((mids[probe.long()] >= 0).sum())
    live_uniq = int((mids[uniq.long()] >= 0).sum())
    got = cost.ivf_screen_select(mv, mids, o_sc, o_ids, probe, qv, g["k"],
                                 n_unique=uniq.numel(),
                                 live_unique=live_uniq, live_rows=live_rows)
    assert got == (live_uniq * g["d"] * 4 + uniq.numel() * g["cap"] * 4
                   + _nb(o_sc, o_ids, probe, qv) + b * g["k"] * 8,
                   2.0 * g["d"] * live_rows, "fp32")
    # tail_gather_argmax over the output embedding
    t = g["slots"]
    emb, h = _meta(g["n"], g["d"]), _meta(t, g["d"])
    pos = torch.randint(0, g["n"], (t, g["m_cap"]), generator=gen, dtype=i32)
    m_used = torch.randint(0, g["m_cap"] + 1, (t,), generator=gen, dtype=i32)
    pert_s, s_ids = _meta(t, g["k"]), _meta(t, g["k"], dtype=i32)
    heights = _meta(t, g["m_cap"])
    alive = torch.arange(g["m_cap"])[None] < m_used[:, None]
    rows = int(torch.unique(pos[alive]).numel())
    got = cost.tail_gather_argmax(emb, pos, m_used, pert_s, s_ids, heights, h,
                                  rows=rows, m_total=int(m_used.sum()))
    assert got == (rows * g["d"] * 4
                   + _nb(pos, m_used, pert_s, s_ids, heights, h) + t * 8,
                   2.0 * g["d"] * int(m_used.sum()), "fp32")
    # the PQ kernels
    codes = _meta(g["n_c"], g["cap"], g["m_sub"], dtype=torch.uint8)
    lut = _meta(b, g["m_sub"], g["ksub"])
    pool = b * g["n_probe"] * g["cap"]
    got = cost.pq_lut_score(codes, probe, lut, n_unique=uniq.numel())
    assert got == (uniq.numel() * g["cap"] * g["m_sub"] + _nb(probe, lut)
                   + pool * 4, float(pool * g["m_sub"]), "fp32")
    coarse = _meta(b, g["n_probe"])
    live = mids[probe.long()] >= 0
    slots_ = torch.unique((probe.long()[:, :, None] * g["cap"]
                           + torch.arange(g["cap"])[None, None, :])[live])
    got = cost.pq_screen_select(codes, mids, coarse, o_sc, o_ids, probe, lut,
                                g["r"], tiles=uniq.numel(),
                                live_slots=slots_.numel(),
                                live=int(live.sum()))
    assert got == (uniq.numel() * g["cap"] * 4 + slots_.numel() * g["m_sub"]
                   + _nb(lut, coarse, probe, o_sc, o_ids) + b * g["r"] * 8,
                   float(int(live.sum()) * (g["m_sub"] + 1)), "fp32")
    cand = torch.randint(-1, g["n"], (b, g["r"]), generator=gen, dtype=i32)
    vals = _meta(b, g["r"])
    q = _meta(b, g["d"])
    ok = cand >= 0
    rows = int(torch.unique(cand[ok]).numel())
    got = cost.rerank_select(emb, cand, vals, q, g["k"], rows=rows,
                             alive=int(ok.sum()))
    assert got == (rows * g["d"] * 4 + _nb(cand, vals, q) + b * g["k"] * 8,
                   2.0 * g["d"] * int(ok.sum()), "fp32")
    # fused_estimator and its backward at one head chunk (m = 2k slots)
    tc, m = 256, 2 * g["k"]
    ids = torch.randint(0, 2000, (tc, m), generator=gen, dtype=i32)
    log_w, hc = _meta(tc, m), _meta(tc, g["d"])
    dead = torch.rand((tc, m), generator=gen) < 0.1
    rows = int(torch.unique(ids[~dead]).numel())
    n_live = int((~dead).sum())
    got = cost.fused_estimator(emb, ids, hc, log_w, return_y=True, rows=rows,
                               n_live=n_live)
    assert got == (rows * g["d"] * 4 + _nb(ids, log_w, hc) + tc * 4
                   + tc * g["d"] * 4 + tc * m * 4,
                   4.0 * g["d"] * n_live, "fp32")
    log_z, gv, y = _meta(tc), _meta(tc), _meta(tc, m)
    got = cost.fused_estimator_bwd(emb, ids, hc, log_w, log_z, gv, y=y,
                                   n_live=n_live)
    assert got == (_nb(ids, hc, log_z, gv, y) + g["n"] * g["d"] * 4
                   + tc * m * 4, 2.0 * g["d"] * n_live, "fp32")


def test_meta_ops_charge_the_kernel_counts():
    """On meta tensors each op returns the kernel's output shapes and
    charges exactly its count, whatever the wrapper does around it; a
    charge is not a launch: nothing launches on meta."""
    q = _meta(4, 32, 64, dtype=torch.bfloat16)
    kc = _meta(4, 512, 4, 64, dtype=torch.bfloat16)
    lens = _meta(4, dtype=torch.int32)
    emb, h = _meta(1000, 64), _meta(8, 64)
    ids, log_w = _meta(8, 40, dtype=torch.int32), _meta(8, 40)

    def f():
        o, lse = ops.flash_decode(q, kc, kc, lens, return_lse=True)
        assert o.shape == (4, 32, 64) and lse.shape == (4, 32)
        z, e, y = ops.fused_estimator(emb, ids, h, log_w, return_y=True)
        assert (z.shape, e.shape, y.shape) == ((8,), (8, 64), (8, 40))

    ops.reset_launch_counts()
    _, c = trace(f)
    assert not any(ops.launch_counts().values())
    fd = cost.flash_decode(q, kc, lens, lse=True)
    fe = cost.fused_estimator(emb, ids, h, log_w, return_y=True)
    assert c.kernels == {
        "flash_decode": {"charges": 1, "bytes": fd.bytes,
                         "flops": fd.flops},
        "fused_estimator": {"charges": 1, "bytes": fe.bytes,
                            "flops": fe.flops}}
    assert c.flops_by_dtype == {"bf16": fd.flops, "fp32": fe.flops}
    assert c.hbm_bytes == fd.bytes + fe.bytes
    assert c.op_count == 0


# ----------------------------------------- virtual mesh against real gloo
def test_virtual_mesh_collectives_equal_gloo_rank0(tmp_path):
    from repro_torch.launch import steps
    from repro_torch.models.model import Model, _meta_params
    from repro_torch.optim import adamw

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 4096, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, 4096, (4, 16)).astype(np.int32)}
    ranks = td.spawn(td.cost_train_case, tmp_path, 2, 2, {"batch": batch})
    real = ranks[0]

    cfg = td._small_cfg(head_mode="exact")
    mesh = mesh_lib.make_virtual_mesh(2, 2)
    model = Model(cfg, "f32", device="meta", mesh=mesh)
    params = mesh_lib.shard_params(_meta_params(cfg), mesh, cfg)
    opt = adamw.init(params)
    b = mesh_lib.data_shardings(
        {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
         for k, v in batch.items()}, mesh)
    step = steps.make_train_step(model, steps.TrainConfig(precision="f32"))
    with CostMode() as mode:
        step(params, opt, b, (0, 0))
    c = mode.cost
    got = {f"{k}@{a}": v for (k, a), v in c.coll_by_axis.items()}
    assert got == real["by_axis"]
    assert dict(c.coll_counts) == real["counts"]
    assert {k.split("@")[1] for k in got} == {"data", "model", "world"}


# ------------------------------------------ against the reference's model
def test_smoke_train_flops_against_reference_hlo():
    from repro.configs import get_smoke as jget_smoke
    from repro.launch import steps as jsteps
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models.model import Model as JModel
    from repro.optim import adamw as jadamw
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps
    from repro_torch.models.model import Model, _meta_params
    from repro_torch.optim import adamw

    b, l = 2, 32
    jcfg = jget_smoke("tinyllama-1.1b")
    jm = JModel(jcfg, precision_policy="f32")
    key = jax.eval_shape(lambda: jax.random.key(0))
    params_s = jax.eval_shape(jm.init, key)
    opt_s = jax.eval_shape(jadamw.init, params_s)
    batch_s = {k: jax.ShapeDtypeStruct((b, l), jnp.int32)
               for k in ("tokens", "labels")}
    step = jsteps.make_train_step(jm, jsteps.TrainConfig(precision="f32"))
    text = jax.jit(step).lower(params_s, opt_s, batch_s, key).compile() \
        .as_text()
    ref = analyze_hlo(text).flops

    cfg = get_smoke("tinyllama-1.1b")
    model = Model(cfg, "f32", device="meta")
    params = _meta_params(cfg)
    batch = {k: torch.empty((b, l), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    tstep = steps.make_train_step(model, steps.TrainConfig(precision="f32"))
    with CostMode() as mode:
        tstep(params, adamw.init(params), batch, (0, 0))
    ratio = mode.cost.flops / ref
    print(f"smoke train flops: port {mode.cost.flops:.6g}, reference HLO "
          f"{ref:.6g}, ratio {ratio:.4f}")
    assert 0.5 <= ratio <= 2.0


def test_dryrun_cli_decode_cell():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "decode_32k", "--multi-pod", "single"],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "dry-run: 1 ok / 0 skip / 0 FAIL" in r.stdout
