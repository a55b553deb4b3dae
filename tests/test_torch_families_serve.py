"""Serving and the launchers over the new trunk families, on
``device="cpu"`` at the smoke widths with vocab 4096 (the smoke vocab of
512 is below ``min_amortized_n``: the head would fall back to the exact
sampler and build no index).

* Fused T=8 ≡ unfused T=1 tokens for each decoder family (SSM, Griffin,
  MoE) on one shared IVF index; the reference engine ≡ the pipelined one
  (it zeroes a recycled slot's recurrent state); strict keeps certified
  requests' tokens; the adaptive probe fused ≡ unfused.
* Griffin: paged ≡ dense (also on a pool tight enough to stall), and
  ``refresh_index`` keeps the index's shapes and serves on.
* Mamba-2 has no attention to page: ``block_len`` fails with the
  reference's ``ValueError``; a prompt bucket past 128 positions is
  coarsened to a multiple of the SSD chunk, as in the reference.
* Both launchers with ``--smoke --device cpu`` on one arch of each family.

Tokens are compared exactly: each is a function of (request, position) on
both sides of every comparison.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.serve.server import ServeConfig, Server, _bucket

torch.set_num_threads(1)

FAMILIES = ["mamba2-780m", "recurrentgemma-9b", "qwen3-moe-30b-a3b"]


def _setup(arch, seed=3):
    cfg = get_smoke(arch).scaled(vocab=4096, head_mips="ivf")
    params = Model(cfg, "f32", device="cpu").init(seed)
    r = np.random.default_rng(0)
    prompts = [list(r.integers(0, 4096, size=r.integers(4, 13)))
               for _ in range(5)]
    return cfg, params, prompts


def _serve(cfg, params, prompts, index=None, **kw):
    kw = dict(dict(batch_slots=2, max_seq=64, max_new_tokens=10), **kw)
    srv = Server(cfg, params, ServeConfig(**kw), precision_policy="f32",
                 device="cpu", index=index)
    return srv, srv.run(prompts)


@pytest.mark.parametrize("arch", FAMILIES)
def test_fused_window_equals_unfused_single_steps(arch):
    cfg, params, prompts = _setup(arch)
    srv, ref = _serve(cfg.scaled(head_fused_decode=True), params, prompts,
                      decode_window=8)
    assert all(r.status == "ok" and len(r.tokens) == 10 for r in ref)
    assert srv.stats["index_bytes"] > 0
    _, unfused = _serve(cfg, params, prompts, srv.index, decode_window=1)
    assert [r.tokens for r in unfused] == [r.tokens for r in ref]
    # the single-step reference engine: prompts fed token by token through
    # the decode path, slots recycled (their state zeroed on admission)
    _, eng = _serve(cfg, params, prompts, srv.index, engine="reference")
    assert [r.tokens for r in eng] == [r.tokens for r in ref]


@pytest.mark.parametrize("arch", FAMILIES)
def test_strict_and_adaptive_heads_serve_each_family(arch):
    """Strict keeps every fully certified request's tokens; the adaptive
    probe (2 -> 8 clusters) fused T=8 ≡ unfused T=1, with the same width
    histogram."""
    cfg, params, prompts = _setup(arch)
    srv, lazy = _serve(cfg, params, prompts)
    strict_srv, strict = _serve(cfg, params, prompts, srv.index, strict=True)
    kept = [i for i, r in enumerate(strict) if r.ok_rate == 1.0]
    assert all(strict[i].tokens == lazy[i].tokens for i in kept)
    assert strict_srv.stats["fallbacks"] == sum(
        round(len(r.tokens) * (1 - r.ok_rate)) for r in strict)
    acfg = cfg.scaled(head_adaptive_probe=True, head_n_probe_init=2,
                      head_n_probe_max=8)
    fsrv, fused = _serve(acfg.scaled(head_fused_decode=True), params,
                         prompts, decode_window=8)
    usrv, unfused = _serve(acfg, params, prompts, fsrv.index,
                           decode_window=1)
    assert [r.tokens for r in fused] == [r.tokens for r in unfused]
    hist = fsrv.stats["probe_width_hist"]
    # every decoded token (the first comes from the prefill) binned once
    assert hist == usrv.stats["probe_width_hist"] and sum(hist.values()) == 45


def test_griffin_paged_equals_dense_and_refreshes():
    cfg, params, prompts = _setup("recurrentgemma-9b")
    fused = cfg.scaled(head_fused_decode=True)
    srv, dense = _serve(fused, params, prompts)
    _, paged = _serve(fused, params, prompts, srv.index, block_len=16)
    assert [r.tokens for r in paged] == [r.tokens for r in dense]
    # a tight pool: admissions stall on blocks, tokens stay
    tight, res = _serve(fused, params, prompts, srv.index, block_len=8,
                        n_blocks=4)
    assert tight.stats["block_stalls"] > 0
    assert [r.tokens for r in res] == [r.tokens for r in dense]
    # rec layers stay slot-resident; the attention leaves are the pool
    kinds = {name: t.shape for name, t in tight.cache[0]["0"].items()}
    assert kinds["state"][1] == 2 and tight.cache[0]["2"]["k"].shape[1] == 5
    shapes = [tuple(t.shape) for t in srv.index.state]
    srv.refresh_index()  # warm-started rebuild: same state shapes
    assert [tuple(t.shape) for t in srv.index.state] == shapes
    assert all(len(r.tokens) == 10 for r in srv.run(prompts))


def test_mamba_refuses_a_paged_cache_like_the_reference():
    cfg, params, _ = _setup("mamba2-780m")
    with pytest.raises(ValueError, match="requires attention layers"):
        Server(cfg, params, ServeConfig(batch_slots=2, max_seq=64,
                                        max_new_tokens=10, block_len=16),
               device="cpu")
    with pytest.raises(ValueError, match="requires attention layers"):
        serve_launcher.main(["--arch", "mamba2-780m", "--smoke", "--device",
                             "cpu", "--block-len", "16"])


def test_prompt_buckets_keep_the_ssd_chunk():
    """Buckets past 128 positions are multiples of 128 (past 512, of 512),
    as the reference's; so a 140-token prompt prefills as 256."""
    assert [_bucket(n, 32) for n in (5, 100, 129, 140, 300, 513)] == [
        32, 128, 256, 256, 384, 1024]
    cfg, params, _ = _setup("mamba2-780m")
    r = np.random.default_rng(1)
    long = [list(r.integers(0, 4096, size=140))]
    srv, res = _serve(cfg, params, long, max_seq=192, max_new_tokens=4)
    assert len(res[0].tokens) == 4 and srv.stats["prefill_tokens"] >= 140


def test_cache_bytes_per_slot_covers_every_layer():
    for arch in ("mamba2-780m", "recurrentgemma-9b", "tinyllama-1.1b"):
        cfg = get_smoke(arch)
        cache = transformer.init_cache(cfg, 1, 64, torch.bfloat16)
        got = sum(t.numel() * t.element_size() for g in cache
                  for layer in g.values() for t in layer.values())
        assert transformer.cache_bytes_per_slot(cfg, 64,
                                                torch.bfloat16) == got
    griffin = get_smoke("recurrentgemma-9b")
    # the attention rings take the local window, not max_seq
    assert (transformer.cache_bytes_per_slot(griffin, 64, torch.bfloat16)
            == transformer.cache_bytes_per_slot(griffin, 4096,
                                                torch.bfloat16))


def _serve_json(*argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_launcher.main(list(argv))
    return json.loads(out.getvalue())


@pytest.mark.parametrize("arch,flags", [
    ("mamba2-780m", ("--fused-decode",)),
    ("recurrentgemma-9b", ("--fused-decode", "--block-len", "16")),
    ("qwen3-moe-30b-a3b", ()),
    ("paligemma-3b", ("--engine", "reference")),
])
def test_serve_launcher_runs_each_family(arch, flags):
    rep = _serve_json("--arch", arch, "--smoke", "--vocab", "4096", "--mips",
                      "ivf", "--device", "cpu", "--requests", "3",
                      "--slots", "2", "--new-tokens", "4", "--max-seq", "64",
                      *flags)
    assert rep["requests"] == 3 and rep["decoded_tokens"] == 12
    assert rep["index_mb"] > 0 and rep["cache_mb"] > 0


def test_serve_launcher_refuses_the_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_launcher.main(["--arch", "hubert-xlarge", "--smoke",
                             "--device", "cpu"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b",
                                  "qwen3-moe-30b-a3b", "paligemma-3b",
                                  "hubert-xlarge"])
def test_train_launcher_runs_each_family(arch, tmp_path, capsys):
    extra = ([] if arch == "hubert-xlarge"
             else ["--vocab", "4096", "--mips", "ivf"])
    seq = "24" if arch == "paligemma-3b" else "16"  # 8 image + 16 text
    train_launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", seq,
                         "--workdir", str(tmp_path), *extra])
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "done" and out["step"] == 2
    assert np.isfinite(out["loss"]) and "aux" in out
    assert (out["aux"] > 0) == (arch == "qwen3-moe-30b-a3b")
