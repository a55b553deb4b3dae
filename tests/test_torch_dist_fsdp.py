"""The trunk's FSDP half on a dp 2 × tp 2 mesh of spawned gloo CPU ranks,
at the smoke widths: tinyllama, mamba2, recurrentgemma and qwen3-moe with
every leaf stored as ``launch.mesh.param_spec`` places it — each matrix's
other dim over ``data`` — and gathered per layer on use.

Each data rank runs the SAME batch, so the gradient of a leaf split over
``data`` comes back from its gather's reduce-scatter summed over two equal
halves: ``dp`` times the reference's single-device gradient; every other
leaf's gradient, the loss and the gradient with respect to the embedded
input equal the reference's (fp32, rtol = atol = 1e-4, the per-family
tolerance). The step that averages over real data halves is
``test_torch_dist_train.py``'s.
"""
import pytest
import torch

import _torch_dist as td
from _torch_trunk import FAMILIES, _check_grads, _reference
from repro_torch.configs import get_smoke

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def refs():
    return {arch: _reference(arch, i) for i, arch in enumerate(FAMILIES)}


@pytest.fixture(scope="module")
def dp2tp2(tmp_path_factory, refs):
    spec = {"loss": {a: {"arch": a, "kw": {"head_mode": "exact"},
                         "params": r["params"], "batch": r["batch"]}
                     for a, r in refs.items()}}
    return td.spawn(td.trunk_cases, tmp_path_factory.mktemp("trunk_dp2tp2"),
                    2, 2, spec)


@pytest.mark.parametrize("arch", FAMILIES)
def test_dp2_tp2_fsdp_grads_match_reference(arch, refs, dp2tp2):
    cfg = get_smoke(arch).scaled(head_mode="exact")
    _check_grads(dp2tp2, refs[arch], arch, 2, 2, cfg)


def test_fsdp_leaves_are_split_over_data(dp2tp2):
    """Every trunk projection of the four families is split over both
    axes on this mesh (the gradients above went through the gathers)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as ttr

    mesh = mesh_lib.Mesh(2, 2, 0, None, None, None)
    for arch in FAMILIES:
        cfg = get_smoke(arch).scaled(head_mode="exact")
        grads = dp2tp2[0]["loss"][arch]["grads"]
        both = [p for p in grads if set(mesh_lib.spec_dims(
            ttr.spec_of(p.split("/"), mesh, cfg))) == {"data", "model"}]
        assert len(both) >= 3, arch
        for path in both:
            assert grads[path].ndim == len(ttr.spec_of(path.split("/"), mesh,
                                                       cfg))
