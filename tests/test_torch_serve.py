"""The port's serving slice as a whole on ``device="cpu"``: continuous
batching through slot recycling, the internal sample contracts (decode
window T=N ≡ T=1, fused ≡ unfused), the launcher and its JSON report (with
each serving-tier flag: paged, slo, strict, the reference engine, the
adaptive probe and its router), what it still refuses, the no-silent-CPU
rule, and that the port never loads JAX."""
import ast
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.mips import IVFIndex, IVFPQIndex
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.model import Model
from repro_torch.serve.server import ServeConfig, Server

# one intra-op thread: the suite runs six workers on the same cores, and
# torch's default thread pool per worker oversubscribes them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above
    return env


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke(ARCH).scaled(vocab=4096, head_mips="ivf")
    params = Model(cfg, "f32", device="cpu").init(3)
    r = np.random.default_rng(0)
    prompts = [list(r.integers(0, 4096, size=r.integers(4, 13)))
               for _ in range(6)]
    return cfg, params, prompts


def _serve(cfg, params, prompts, window, index=None):
    srv = Server(cfg, params, ServeConfig(batch_slots=2, max_seq=48,
                                          max_new_tokens=10,
                                          decode_window=window),
                 precision_policy="f32", device="cpu", index=index)
    return srv, srv.run(prompts)


def test_server_recycles_slots_and_finishes_every_request(setup):
    cfg, params, prompts = setup
    srv, res = _serve(cfg.scaled(head_fused_decode=True), params, prompts, 4)
    assert [r.request_id for r in res] == list(range(6))
    assert all(r.status == "ok" and len(r.tokens) == 10 for r in res)
    assert all(0 <= t < 4096 for r in res for t in r.tokens)
    assert srv.stats["prefill_dispatches"] >= 3  # 6 requests through 2 slots
    assert srv.stats["slot_occupancy_peak"] == 2
    assert srv.stats["tokens"] == 60 and srv.index is not None


def test_tokens_invariant_to_window_and_fusion(setup):
    """fused T=4 ≡ fused T=1 ≡ unfused-with-kernel-probe T=1 ≡ unfused
    T=3: a token is a function of (request, position), and both head paths
    select the same top-k and finish Algorithm 2 on the same draws."""
    cfg, params, prompts = setup
    fused = cfg.scaled(head_fused_decode=True)
    srv, ref = _serve(fused, params, prompts, 4)
    kernel_index = IVFIndex(dataclasses.replace(srv.index.config,
                                                use_kernel=True),
                            srv.index.state)
    runs = [
        _serve(fused, params, prompts, 1, srv.index)[1],
        _serve(cfg.scaled(head_use_kernel=True), params, prompts, 1,
               kernel_index)[1],
        _serve(cfg, params, prompts, 3, srv.index)[1],
    ]
    for res in runs:
        assert [r.tokens for r in res] == [r.tokens for r in ref]


def test_ivfpq_tokens_invariant_to_window_and_fusion(setup):
    """The IVF-PQ head: fused T=4 (pq_screen_select + rerank_select) ≡
    unfused T=1 (pq_lut_score + rerank_select) ≡ unfused T=3, on one shared
    index."""
    cfg, params, prompts = setup
    pq_cfg = cfg.scaled(head_mips="ivfpq")
    srv, ref = _serve(pq_cfg.scaled(head_fused_decode=True), params,
                      prompts, 4)
    assert isinstance(srv.index, IVFPQIndex)
    assert srv.index.state.db is params["out_embed"]
    assert all(r.status == "ok" and len(r.tokens) == 10 for r in ref)
    runs = [
        _serve(pq_cfg, params, prompts, 1, srv.index)[1],
        _serve(pq_cfg, params, prompts, 3, srv.index)[1],
    ]
    for res in runs:
        assert [r.tokens for r in res] == [r.tokens for r in ref]


def test_bf16_policy_serves(setup):
    cfg, params, prompts = setup
    srv = Server(cfg.scaled(head_fused_decode=True), params,
                 ServeConfig(batch_slots=2, max_seq=48, max_new_tokens=4),
                 device="cpu")
    assert srv.model.compute_dtype == torch.bfloat16
    assert srv.cache[0]["0"]["k"].dtype == torch.bfloat16
    assert srv.run_params["blocks"][0]["0"]["mix"]["wq"].dtype == torch.bfloat16
    assert srv.run_params["out_embed"].dtype == torch.float32
    res = srv.run(prompts[:3])
    assert all(len(r.tokens) == 4 for r in res)


def _reference_report_keys() -> set[str]:
    """Keys of the JAX launcher's JSON report (repro/launch/serve.py)."""
    src = (ROOT / "src/repro/launch/serve.py").read_text()
    block = src[src.index("print(json.dumps({"):]
    return set(re.findall(r'^\s+"(\w+)":', block, flags=re.M))


def _launch_serve(mips: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--vocab", "4096", "--mips", mips, "--fused-decode",
         "--device", "cpu", "--requests", "3", "--slots", "2",
         "--new-tokens", "4", "--max-seq", "64"],
        capture_output=True, text=True, env=_env(), timeout=240, check=True,
    )
    rep = json.loads(out.stdout)
    keys = _reference_report_keys()
    assert len(keys) >= 20 and set(rep) == keys
    assert rep["requests"] == 3 and rep["decoded_tokens"] == 12
    assert rep["index_mb"] > 0
    return rep


def test_launcher_cpu_report_has_reference_fields():
    _launch_serve("ivf")


def test_launcher_cpu_ivfpq_report():
    """``--mips ivfpq``: the reference launcher's report, every token
    certified, and an index far smaller than the IVF one (uint8 codes in
    place of fp32 row copies)."""
    rep = _launch_serve("ivfpq")
    assert rep["ok_rate"] == 1.0
    assert rep["index_mb"] < _launch_serve("ivf")["index_mb"] / 4


@pytest.mark.parametrize("flags,what", [
    (("--mips", "bogus"), "invalid choice: 'bogus'"),
    (("--arch", "hubert-xlarge"), "is encoder-only: no decode serving"),
])
def test_launcher_rejects_unported_flags(flags, what):
    """What the serving launcher refuses: an index backend it does not
    know, and encoder-only archs, which do not decode (as the reference
    launcher refuses them). ``--mips lsh`` serves since the index side was
    ported (``tests/test_torch_lsh.py``)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", *flags],
        capture_output=True, text=True, env=_env(), timeout=240,
    )
    assert out.returncode != 0
    assert what in out.stderr


def _launch(*flags) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_launcher.main(
            ["--arch", ARCH, "--smoke", "--vocab", "4096", "--mips", "ivf",
             "--device", "cpu", "--requests", "3", "--slots", "2",
             "--new-tokens", "4", "--max-seq", "64", *flags])
    rep = json.loads(out.getvalue())
    assert set(rep) == _reference_report_keys()
    new = int(flags[flags.index("--new-tokens") + 1]
              if "--new-tokens" in flags else 4)
    assert rep["requests"] == 3 and rep["decoded_tokens"] == 3 * new
    return rep


@pytest.mark.parametrize("flags", [
    ("--block-len", "16"),
    ("--block-len", "16", "--n-blocks", "4", "--new-tokens", "40"),
    ("--sched", "slo", "--ttft-slo", "0.001"),
    ("--strict",),
    ("--engine", "reference"),
    ("--adaptive-probe", "--n-probe-init", "2", "--n-probe-max", "8"),
    ("--adaptive-probe", "--n-probe-init", "2", "--n-probe-max", "8",
     "--probe-router", "fit", "--fused-decode"),
], ids=["paged", "paged-tight", "slo", "strict", "reference", "adaptive",
        "adaptive-router-fused"])
def test_launcher_new_flags(flags):
    rep = _launch(*flags)
    if "--block-len" in flags:
        assert 0.0 < rep["block_util_peak"] <= 1.0
    if "--n-blocks" in flags:  # 4 blocks of 16 hold one 44-56 position
        assert rep["block_stalls"] > 0  # request at a time: stalls
    if "--engine" in flags:
        assert rep["prefill_dispatches"] == 0 and rep["steps"] > 12
    if "--strict" in flags:
        assert rep["fallbacks"] == round(12 * (1 - rep["ok_rate"]))
    if "--adaptive-probe" in flags:
        hist = rep["probe_width_hist"]
        assert sum(hist.values()) == 3 * 3 and set(hist) <= {"2", "4", "8"}
    else:
        assert rep["probe_width_hist"] == {}


def test_entry_points_without_cuda_or_device_raise():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    cfg = get_smoke(ARCH)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(cfg, {}, ServeConfig())
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke"], capture_output=True, text=True, env=_env(), timeout=240,
    )
    assert out.returncode != 0 and "CUDA is not available" in out.stderr


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.kernels.build; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro'); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_import_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src/repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{f}: {name}"
