"""The port's distributed MoE layer (``repro_torch.models.moe.forward_dist``)
on spawned gloo ranks against the reference's single-device
``moe.forward`` on the full params, at the smoke qwen3-moe-30b-a3b width
(top-2) over tp 2 and 4: expert parallelism ("ep": with its 8 experts,
E / tp a rank) and the FFN-hidden split ("tp": with 7 experts, which no tp
divides), each placed by ``launch.mesh.moe_mode``. The output and aux, and
the gradients of ``sum(out · w) + 3 aux`` in x, the router and each rank's
slice of the expert weights — the f / g pair must give every rank the
full ``dL/dx`` and router gradient.

Tolerance: rtol=atol=1e-4 (the single-device MoE test's; the partial
outputs are summed across ranks in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from repro.configs import get_smoke as jget_smoke
from repro.models import moe as jmoe

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen3-moe-30b-a3b"
T = 48


# expert count of each mode's case: 8 divides tp 2 and 4, 7 divides neither
EXPERTS = {"ep": 8, "tp": 7}


@pytest.fixture(scope="module", params=[2, 4])
def run(request, tmp_path_factory):
    tp = request.param
    r = np.random.default_rng(tp)
    d = jget_smoke(ARCH).d_model
    x = r.standard_normal((T, d)).astype(np.float32)
    w = r.standard_normal((T, d)).astype(np.float32)
    cfgs, want, cases = {}, {}, {}
    for mode, n_exp in EXPERTS.items():
        jcfg = jget_smoke(ARCH).scaled(n_experts=n_exp)
        p = jax.device_get(jmoe.init(jax.random.key(tp), jcfg))

        def obj(pp, xx, jcfg=jcfg):
            y, aux = jmoe.forward(pp, jcfg, xx)
            return (y * jnp.asarray(w)).sum() + 3.0 * aux, (y, aux)

        (_, (y, aux)), (dp, dx) = jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, p),
                                               jnp.asarray(x))
        cfgs[mode] = jcfg
        want[mode] = {"out": np.asarray(y), "aux": float(aux),
                      "dx": np.asarray(dx),
                      **{f"d_{k}": np.asarray(v) for k, v in dp.items()}}
        cases[mode] = {"n_experts": n_exp,
                       "params": {k: np.asarray(v) for k, v in p.items()}}
    outs = td.spawn(td.moe_dist_cases, tmp_path_factory.mktemp("moe"), 1,
                    tp, {"arch": ARCH, "cases": cases, "x": x, "w": w})
    return tp, cfgs, want, outs


def _slice(name, arr, mode, tp, m, cfg):
    if name in ("d_router",) or name in ("out", "dx"):
        return arr
    if mode == "ep":
        e = cfg.n_experts // tp
        return arr[m * e:(m + 1) * e]
    f = cfg.expert_d_ff // tp
    if name == "d_w2":
        return arr[:, m * f:(m + 1) * f]
    return arr[:, :, m * f:(m + 1) * f]


@pytest.mark.parametrize("mode", ["ep", "tp"])
def test_forward_dist_matches_reference_forward(run, mode):
    tp, cfgs, want, outs = run
    for m, o in enumerate(outs):
        got, ref = o[mode], want[mode]
        assert got["mode"] == mode
        np.testing.assert_allclose(got["out"], ref["out"], **TOL)
        np.testing.assert_allclose(got["aux"], ref["aux"], **TOL)
        for name in ("dx", "d_router", "d_w1", "d_w2", "d_w3"):
            np.testing.assert_allclose(
                got[name], _slice(name, ref[name], mode, tp, m, cfgs[mode]),
                err_msg=name, **TOL)
