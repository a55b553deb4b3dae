"""The port's ``(data, model)`` mesh on torch.distributed
(``repro_torch.launch.mesh``) against the reference's
``repro/launch/mesh.py``: the rank layout and the groups equal the
reference mesh's device layout (``devs[:dp*tp].reshape(dp, tp)``) on 4
spawned CPU ranks under gloo; ``param_spec`` equals the reference's on
every leaf of the ten configs' params at (dp, tp) in {(1, 2), (1, 4),
(2, 2)}, both MoE placements; ``cache_shardings`` equals the reference's
on the dense and paged caches of each family, entry for entry (a dense
ring whose KV heads do not divide ``tp`` split over its positions);
``shard_params`` gives each rank ``1 / (dp · tp)`` of every trunk leaf
split over both axes, the blocks tiling the whole; each data rank holds
the global-batch rows the reference's ``data_shardings`` /
``stacked_data_shardings`` would place there. Also: a mesh of more ranks
than the group has is refused, as are NCCL without a card per rank and an
unknown backend; and the reference test's (2, 4) layout is rank = data ·
tp + model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_dist as td
import repro.models.transformer as jtr
from repro.configs import get_smoke as jget_smoke
from repro.launch import mesh as jmesh
from repro_torch.configs import ARCHS, get_smoke
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr

MESHES = [(1, 2), (1, 4), (2, 2)]

torch.set_num_threads(1)


def _ref_layout(monkeypatch, dp, tp):
    """The reference's make_train_mesh device array, over integer
    stand-ins for devices."""
    monkeypatch.setattr(jmesh.jax, "devices", lambda: list(range(dp * tp)))
    monkeypatch.setattr(jmesh.jax.sharding, "Mesh",
                        lambda devs, names: (np.asarray(devs), names))
    devs, names = jmesh.make_train_mesh(dp, tp)
    assert names == ("data", "model")
    return devs


def _rows(spec_entry, n, dp, d):
    """Rows of a dim placed by ``spec_entry`` that data index d holds."""
    if spec_entry is None:
        return (0, n)
    b = n // dp
    return (d * b, (d + 1) * b)


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4), (4, 1)])
def test_rank_layout_and_groups(dp, tp, tmp_path, monkeypatch):
    outs = td.spawn(td.mesh_layout, tmp_path, dp, tp)
    devs = _ref_layout(monkeypatch, dp, tp)
    am = AbstractMesh((dp, tp), ("data", "model"))
    for o in outs:
        d, m = o["coords"]
        assert devs[d, m] == o["rank"]
        assert list(o["model_ranks"]) == devs[d].tolist()
        assert list(o["data_ranks"]) == devs[:, m].tolist()
        assert o["model_sum"] == float(devs[d].sum())
        assert o["data_sum"] == float(devs[:, m].sum())
        assert o["world_max"] == float(dp * tp - 1)
        assert o["gather"] == [float(x) for x in devs[d]]
        assert o["ring"] == float(devs[d, (m - 1) % tp])
        # the batch rows this data rank holds = the reference's placement
        for n, key in ((8, "rows8"), (3, "rows3")):
            spec = jmesh.data_shardings({"x": np.zeros((n, 2))}, am)["x"].spec
            assert tuple(o[key]) == _rows(spec[0], n, dp, d)
            sspec = jmesh.stacked_data_shardings(
                {"x": np.zeros((2, n, 2))}, am)["x"].spec
            assert tuple(o[key]) == _rows(sspec[1], n, dp, d)


def test_reference_layout_2x4(monkeypatch):
    """The reference test's (2, 4) mesh: rank = data * tp + model."""
    devs = _ref_layout(monkeypatch, 2, 4)
    for d in range(2):
        for m in range(4):
            assert devs[d, m] == d * 4 + m


def _leaves(tree, path=(), leaf=None):
    """(path, leaf) of nested dicts / lists (``leaf``: a type that is a
    leaf even though it is a tuple)."""
    if leaf is not None and isinstance(tree, leaf):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),), leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),), leaf)
    elif tree is not None:
        yield path, tree


def _spec_mesh(dp, tp):
    return mesh_lib.Mesh(dp, tp, 0, None, None, None)


@pytest.mark.parametrize("mode", ["ep", "tp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference(arch, mode, monkeypatch):
    """On every leaf of the arch's params, at every mesh: the port's spec
    IS the reference's, entry for entry."""
    monkeypatch.setattr(jmesh, "MOE_SHARDING", mode)
    monkeypatch.setattr(mesh_lib, "MOE_SHARDING", mode)
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    n_split = 0
    for dp, tp in MESHES:
        am = AbstractMesh((dp, tp), ("data", "model"))
        mesh = _spec_mesh(dp, tp)
        for path, leaf in _leaves(tmodel._meta_params(cfg)):
            shape = tuple(leaf.shape)
            ours = mesh_lib.param_spec(list(path), shape, mesh, cfg)
            ref = tuple(jmesh.param_spec(list(path), shape, am, jcfg))
            ref = ref + (None,) * (len(shape) - len(ref))
            assert ours == ref, (arch, (dp, tp), path, ours, ref)
            assert ttr.spec_of(path, mesh, cfg) == ours
            n_split += "model" in ours
    assert n_split > 3 * 2  # the trunk is split, not only the embeddings


def _cache_cases():
    out = []
    for arch in ARCHS:
        cfg = get_smoke(arch)
        if not cfg.has_decode:
            continue
        out.append((arch, False))
        if "attn" in cfg.layer_kinds():
            out.append((arch, True))
    return out


@pytest.mark.parametrize("arch,paged", _cache_cases())
def test_cache_shardings_match_reference(arch, paged):
    """The serving cache's placement against the reference's
    ``cache_shardings`` on the reference's own cache shapes: equal leaf
    for leaf, a dense KV ring whose heads do not divide ``tp`` split over
    its positions as the reference splits it."""
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    batch, max_seq = 4, 64
    layout = ttr.PagedLayout(block_len=16, n_blocks=8) if paged else None
    jlayout = jtr.PagedLayout(block_len=16, n_blocks=8) if paged else None
    jcache = jax.eval_shape(lambda: jtr.init_cache(
        jcfg, batch, max_seq, jnp.bfloat16, paged=jlayout))
    ours_meta = ttr.init_cache(cfg, batch, max_seq, torch.bfloat16,
                               device="meta", paged=layout)
    for dp, tp in MESHES:
        am = AbstractMesh((dp, tp), ("data", "model"))
        ref = jmesh.cache_shardings(jcache, am, jcfg, paged=paged)
        ours = mesh_lib.cache_shardings(ours_meta, _spec_mesh(dp, tp), cfg,
                                        paged=paged)
        ref_flat = {p: tuple(v.spec) for p, v in _leaves_j(ref)}
        for path, spec in _leaves(ours, leaf=tuple):
            want = ref_flat[path]
            want = want + (None,) * (len(spec) - len(want))
            assert spec == want, (arch, paged, (dp, tp), path, spec, want)


def _leaves_j(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_j(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_j(v, path + (str(i),))
    else:
        yield path, tree


def test_shard_params_cuts_blocks():
    """shard_params keeps each rank's contiguous block of a sharded leaf."""
    cfg = get_smoke("qwen3-moe-30b-a3b")
    params = tmodel.Model(cfg, "f32", device="cpu").init(0)
    for m in range(2):
        mesh = mesh_lib.Mesh(1, 2, m, mesh_lib.Axis.trivial("data"),
                             mesh_lib.Axis("model", 2, m, (0, 1)), None)
        loc = mesh_lib.shard_params(params, mesh, cfg)
        v = cfg.vocab_padded // 2
        for name in ("out_embed", "embed"):  # rows over the model axis
            assert torch.equal(loc[name], params[name][m * v:(m + 1) * v])
        e = cfg.n_experts // 2
        w1 = params["blocks"][0]["0"]["mlp"]["w1"]
        assert torch.equal(loc["blocks"][0]["0"]["mlp"]["w1"],
                           w1[:, m * e:(m + 1) * e])
        wq = params["blocks"][0]["0"]["mix"]["wq"]
        f = wq.shape[2] // 2
        assert torch.equal(loc["blocks"][0]["0"]["mix"]["wq"],
                           wq[:, :, m * f:(m + 1) * f])
        # replicated: not copied
        assert loc["final_norm"] is params["final_norm"]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m",
                                  "recurrentgemma-9b", "qwen3-moe-30b-a3b"])
def test_shard_params_rank_fraction(arch):
    """On a (2, 2) mesh every trunk leaf split over both axes holds
    1 / (dp · tp) of its elements on each rank, and the four ranks' blocks
    tile the whole leaf."""
    cfg = get_smoke(arch)
    params = tmodel.Model(cfg, "f32", device="cpu").init(0)
    dp, tp = 2, 2
    locs = {}
    for d in range(dp):
        for m in range(tp):
            mesh = mesh_lib.Mesh(dp, tp, d * tp + m,
                                 mesh_lib.Axis("data", dp, d, (m, tp + m)),
                                 mesh_lib.Axis("model", tp, m,
                                               (d * tp, d * tp + 1)), None)
            locs[d, m] = dict(_leaves(mesh_lib.shard_params(params, mesh,
                                                            cfg)))
    both = 0
    for path, full in _leaves(params):
        spec = ttr.spec_of(path, _spec_mesh(dp, tp), cfg)
        dims = mesh_lib.spec_dims(spec)
        if set(dims) != {"data", "model"}:
            continue
        both += 1
        for d in range(dp):
            for m in range(tp):
                t = locs[d, m][path]
                assert t.numel() * dp * tp == full.numel(), path
                blk = full.narrow(dims["data"], d * t.shape[dims["data"]],
                                  t.shape[dims["data"]])
                blk = blk.narrow(dims["model"], m * t.shape[dims["model"]],
                                 t.shape[dims["model"]])
                assert torch.equal(t, blk), path
    assert both >= 4  # e.g. the attention / SSM / RG-LRU projections


def test_mesh_refusals():
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh_lib.make_train_mesh(2, 2)
    with pytest.raises(ValueError, match="nccl needs one card per rank"):
        mesh_lib.init_rank(0, 4, "file:///nonexistent", backend="nccl",
                           device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        mesh_lib.init_rank(0, 1, "file:///nonexistent", backend="mpi",
                           device="cpu")
    one = mesh_lib.make_train_mesh(1, 1)
    assert one.shape == {"data": 1, "model": 1} and one.world.size == 1
