"""The port's ``(data, model)`` mesh on torch.distributed
(``repro_torch.launch.mesh``) against the reference's
``repro/launch/mesh.py``: the rank layout and the groups equal the
reference mesh's device layout (``devs[:dp*tp].reshape(dp, tp)``) on 4
spawned CPU ranks under gloo; ``param_spec`` places the leaves the port
shards (the output embedding, the MoE experts in "ep" and "tp") on the
reference's "model" dim, and leaves the rest replicated; each data rank
holds the global-batch rows the reference's ``data_shardings`` /
``stacked_data_shardings`` would place there. Also: a mesh of more ranks
than the group has is refused, as are NCCL without a card per rank and an
unknown backend; and the reference test's (2, 4) layout is rank = data ·
tp + model.
"""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_dist as td
from repro.configs import get_smoke as jget_smoke
from repro.launch import mesh as jmesh
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as tmodel

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


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


@pytest.mark.parametrize("arch,tp,mode", [
    ("qwen3-moe-30b-a3b", 2, "ep"), ("qwen3-moe-30b-a3b", 4, "ep"),
    ("qwen3-moe-30b-a3b", 2, "tp"), ("tinyllama-1.1b", 2, "ep"),
    ("mixtral-8x22b", 4, "ep")])
def test_param_spec_matches_reference(arch, tp, mode, monkeypatch):
    """On every leaf of the arch's params: where the port shards, the
    reference puts "model" on the same dim; elsewhere the port
    replicates (the trunk's TP is not in the port)."""
    monkeypatch.setattr(jmesh, "MOE_SHARDING", mode)
    monkeypatch.setattr(mesh_lib, "MOE_SHARDING", mode)
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    am = AbstractMesh((1, tp), ("data", "model"))
    mesh = mesh_lib.Mesh(1, tp, 0, None, None, None)
    sharded = n_moe = 0
    for path, leaf in _leaves(tmodel._meta_params(cfg)):
        n_moe += path[-1] in ("w1", "w2", "w3") and leaf.dim() == 4
        shape = tuple(leaf.shape)
        ours = mesh_lib.param_spec(list(path), shape, mesh, cfg)
        ref = tuple(jmesh.param_spec(list(path), shape, am, jcfg))
        ref = ref + (None,) * (len(shape) - len(ref))
        dim = mesh_lib.shard_dim(ours)
        if dim is None:
            assert set(ours) == {None}
            continue
        sharded += 1
        assert ref[dim] == "model", (path, ours, ref)
        assert shape[dim] % tp == 0
    assert sharded == 1 + n_moe  # out_embed and every expert weight


def test_shard_params_cuts_blocks():
    """shard_params keeps each rank's contiguous block of a sharded leaf."""
    cfg = get_smoke("qwen3-moe-30b-a3b")
    params = tmodel.Model(cfg, "f32", device="cpu").init(0)
    for m in range(2):
        mesh = mesh_lib.Mesh(1, 2, m, mesh_lib.Axis.trivial("data"),
                             mesh_lib.Axis("model", 2, m, (0, 1)), None)
        loc = mesh_lib.shard_params(params, mesh, cfg)
        v = cfg.vocab_padded // 2
        assert torch.equal(loc["out_embed"],
                           params["out_embed"][m * v:(m + 1) * v])
        e = cfg.n_experts // 2
        w1 = params["blocks"][0]["0"]["mlp"]["w1"]
        assert torch.equal(loc["blocks"][0]["0"]["mlp"]["w1"],
                           w1[:, m * e:(m + 1) * e])
        assert loc["embed"] is params["embed"]  # replicated: not copied


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
