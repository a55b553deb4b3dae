"""The port's cells (``repro_torch.launch.specs``) against the reference's
``repro/launch/specs.py``: ``SHAPES``, every skip reason, ``all_cells()``
and, for each of the ten archs and every shape, ``batch_specs``' leaves —
names, shapes and dtypes (int32 ids and labels, embeddings in the compute
dtype) — on meta tensors, nothing allocated."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.launch import specs as jspecs
from repro_torch.configs import ARCHS, get
from repro_torch.launch import specs

_DTYPES = {torch.int32: np.dtype("int32"), torch.bfloat16: jax.numpy.bfloat16}


def test_shapes_and_cells_match_reference():
    assert specs.SHAPES == jspecs.SHAPES
    assert [(c.arch, c.shape, c.kind, c.seq, c.batch)
            for c in specs.all_cells()] == [
        (c.arch, c.shape, c.kind, c.seq, c.batch) for c in jspecs.all_cells()]


@pytest.mark.parametrize("arch", ARCHS)
def test_skips_and_batch_specs_match_reference(arch):
    cfg, jcfg = get(arch), jget(arch)
    assert [c.shape for c in specs.cells_for(cfg)] == [
        c.shape for c in jspecs.cells_for(jcfg)]
    for shape in specs.SHAPES:
        assert specs.skip_reason(cfg, shape) == jspecs.skip_reason(jcfg,
                                                                   shape)
        ours = specs.batch_specs(cfg, shape)
        ref = jspecs.batch_specs(jcfg, shape)
        flat = {k: v for k, v in ours.get("batch", ours).items()}
        rflat = {k: v for k, v in ref.get("batch", ref).items()}
        assert set(flat) == set(rflat), (arch, shape)
        for k, t in flat.items():
            assert t.is_meta, (arch, shape, k)
            assert tuple(t.shape) == tuple(rflat[k].shape), (arch, shape, k)
            assert np.dtype(_DTYPES[t.dtype]) == np.dtype(rflat[k].dtype), (
                arch, shape, k)
