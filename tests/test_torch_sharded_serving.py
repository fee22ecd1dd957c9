"""Sharded serving on the CPU: the port's prefill, decode steps and
``serve_uncertain(mesh=)`` on DTensor parameters and caches, held to the
port unsharded and to the reference's ``prefill``/``decode_step`` and
``serve_uncertain`` on the same numpy weights.

Four ranks (gloo, ``tests/torch_dist_worker.py``'s ``serve`` scenario) on a
(2, 2) ``("data", "model")`` mesh: parameters restored as DTensors laid out
by ``param_shardings``, the prompt laid out by ``batch_shardings``, caches
by ``cache_shardings``. Families and the prefill attention layout each one
takes: qwen2 and phi3.5-moe head-TP (both head counts divide "model"),
granite (one KV head) the KV sequence over "model", recurrentgemma the
scan on local shards and one local-attention KV head (its 16-slot window
wraps during the decode steps). Smoke configs, fp32, N = 4 masks, two
requests of 14 tokens, 4 decode steps fed the reference's greedy tokens.

Tolerances: logits within ``TOL_LOGITS`` (absolute) of the port unsharded
and of the reference; ``serve_uncertain``'s rel-unc within ``POST``, its
tokens and flags equal. Gaps measured here (logits against the port
unsharded / the reference): qwen2 3.6e-7 / 5.4e-7, recurrentgemma
4.7e-6 / 6.2e-6, phi3.5-moe 2.1e-6 / 2.1e-6, granite 1.9e-6 / 2.1e-6.
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import build_model as j_build_model
from repro.models import transformer as j_transformer
from repro.serving import engine as j_engine
from repro_torch.configs import registry as t_registry
from repro_torch.core import uncertainty as t_unc
from repro_torch.distributed import checkpoint, sharding
from repro_torch.models import transformer as t_transformer
from repro_torch.models.model import build_model
from repro_torch.serving import engine as t_engine

import torch_dist_worker as worker

FAMILIES = ("qwen2-1.5b", "recurrentgemma-2b", "phi3.5-moe-42b-a6.6b",
            "granite-20b")
PROMPT, REQUESTS, STEPS = 14, 2, 4
BUCKET = 16         # serve_uncertain's prefill bucket for PROMPT tokens
TOL_LOGITS = 5e-5
POST = dict(rtol=1e-4, atol=1e-5)


def _greedy(logits: np.ndarray, n: int) -> np.ndarray:
    """The next tokens of a mask-expanded batch: the posterior mean's
    argmax of each request, repeated over its N rows, [N*b, 1]."""
    mean, _ = t_unc.token_posterior(torch.tensor(logits), n)
    return mean.argmax(-1).to(torch.int32).repeat(n)[:, None].numpy()


def _reference(arch, toks):
    """The reference's weights (numpy), its prefill + decode logits on the
    greedy chain, the chain's tokens, and its serve_uncertain outputs."""
    cfg = j_registry.smoke_config(arch)
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    n = cfg.mask_samples
    ids = jnp.repeat(jnp.arange(n), toks.shape[0] // n)
    logits, caches = j_transformer.prefill(
        cfg, params, {"tokens": jnp.asarray(toks)}, max_seq=PROMPT + STEPS,
        mask_ids=ids)
    out, steps = [np.asarray(logits)], []
    for i in range(STEPS):
        steps.append(_greedy(out[-1], n))
        logits, caches = j_transformer.decode_step(
            cfg, params, caches, jnp.asarray(steps[-1]), PROMPT + i,
            mask_ids=ids)
        out.append(np.asarray(logits))
    served = j_engine.serve_uncertain(
        model, params, jnp.asarray(toks[:REQUESTS]),
        j_engine.ServeConfig(max_new_tokens=STEPS, fused=False))
    return (jax.tree.map(np.asarray, params), np.stack(out),
            np.stack(steps), [np.asarray(a) for a in served])


def _unsharded(arch, params, toks, steps):
    cfg = t_registry.smoke_config(arch)
    n = cfg.mask_samples
    ids = torch.arange(n).repeat_interleave(toks.shape[0] // n)
    logits, caches = t_transformer.prefill(
        cfg, params, {"tokens": torch.from_numpy(toks)},
        max_seq=PROMPT + STEPS, mask_ids=ids)
    out = [logits]
    for i, tok in enumerate(steps):
        logits, caches = t_transformer.decode_step(
            cfg, params, caches, torch.from_numpy(tok), PROMPT + i,
            mask_ids=ids)
        out.append(logits)
    served = t_engine.serve_uncertain(
        build_model(cfg), params, torch.from_numpy(toks[:REQUESTS]),
        t_engine.ServeConfig(max_new_tokens=STEPS, fused=False),
        device="cpu")
    return torch.stack(out).numpy(), [a.numpy() for a in served]


@pytest.fixture(scope="module")
def world():
    """Every family's reference and unsharded runs here, its sharded run
    on 4 ranks (one world for all four) -> {arch: results}."""
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as workdir:
        out = {}
        for arch in FAMILIES:
            cfg = t_registry.smoke_config(arch)
            prompts = rng.integers(0, cfg.vocab_size, (REQUESTS, PROMPT),
                                   dtype=np.int32)
            toks = np.tile(prompts, (cfg.mask_samples, 1))
            jp, ref_logits, steps, ref_served = _reference(arch, toks)
            params = t_transformer.params_from_jax(cfg, jp, device="cpu")
            d = os.path.join(workdir, arch)
            checkpoint.save_checkpoint(d, 0, params)
            np.savez(os.path.join(d, "io.npz"), tokens=toks, steps=steps)
            logits, served = _unsharded(arch, params, toks, steps)
            out[arch] = {"ref": (ref_logits, ref_served),
                         "single": (logits, served), "steps": steps}
        with open(os.path.join(workdir, "families.json"), "w") as f:
            json.dump(list(FAMILIES), f)
        worker.spawn("serve", 4, workdir, timeout_s=240.0)
        for arch in FAMILIES:
            d = os.path.join(workdir, arch)
            got = dict(np.load(os.path.join(d, "sharded.npz")))
            with open(os.path.join(d, "sharded.json")) as f:
                got.update(json.load(f))
            out[arch]["sharded"] = got
        yield out


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_prefill_and_decode_match(world, arch):
    """Prefill + 4 decode steps on DTensors: the logits of every step
    against the port unsharded and the reference, the greedy chain's
    tokens equal, and every cache leaf still laid out by
    ``cache_shardings`` after the last step."""
    got = world[arch]
    logits = got["sharded"]["logits"]
    n = t_registry.smoke_config(arch).mask_samples
    gaps = (float(np.abs(logits - got["single"][0]).max()),
            float(np.abs(logits - got["ref"][0]).max()))
    assert max(gaps) < TOL_LOGITS, gaps
    for i, want in enumerate(got["steps"]):
        np.testing.assert_array_equal(_greedy(logits[i], n), want)
    assert not got["sharded"]["plain_leaves"]
    cfg = t_registry.smoke_config(arch)
    specs = t_transformer.cache_specs(cfg, n * REQUESTS, PROMPT + STEPS)
    meta = [{b: {k: torch.empty(shape, dtype=dt, device="meta")
                 for k, (shape, dt) in c.items()} for b, c in seg.items()}
            for seg in specs]
    want = sharding.cache_shardings({"data": 2, "model": 2}, meta)
    for si, seg in enumerate(want):
        for b, c in seg.items():
            for k, sh in c.items():
                placed = [str(p) for p in sharding.to_placements(
                    sh.spec, {"data": 2, "model": 2})]
                assert got["sharded"]["cache_layouts"][f"{si}/{b}/{k}"] \
                    == placed, (si, b, k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_serve_uncertain_matches(world, arch):
    """``serve_uncertain(mesh=)`` per-op on DTensor parameters: tokens and
    flags equal to the reference's and the port unsharded, rel-unc within
    ``POST``."""
    got = world[arch]
    s = got["sharded"]
    for want in (got["single"][1], got["ref"][1]):
        np.testing.assert_array_equal(s["gen"], want[0])
        np.testing.assert_allclose(s["unc"], want[1], **POST)
        np.testing.assert_array_equal(s["flags"], want[2])


@pytest.mark.parametrize("arch", FAMILIES)
def test_kernels_take_local_shards(world, arch):
    """Each ``flash_attention`` call on DTensors runs the wrapper again on
    plain local tensors: head-TP keeps half the rows and half the heads
    local (batch over "data", heads over "model"), the KV-sequence layout
    gathers K/V along S first (every head, the whole prompt). ``moments``
    runs on local [N, b, V/2] shards: the mask axis whole, the vocabulary
    over "model"."""
    cfg = t_registry.smoke_config(arch)
    s = world[arch]["sharded"]
    n, dh = cfg.mask_samples, cfg.resolved_head_dim
    rows = n * REQUESTS
    local = [c for c in s["flash"] if c[0][0] == "Tensor"]
    assert local and len(local) == len(s["flash"]) - len(local)
    head_tp = cfg.n_kv_heads % 2 == 0
    h, hkv = ((cfg.n_heads // 2, cfg.n_kv_heads // 2) if head_tp
              else (cfg.n_heads, cfg.n_kv_heads))
    for q, k, v in local:
        seq = q[1][2]       # the prompt, or its bucket (bucketed prefill)
        assert seq in (PROMPT, BUCKET)
        assert q[1] == [rows // 2, h, seq, dh]
        assert k[1] == v[1] == [rows // 2, hkv, seq, dh]
    mom = [c[0] for c in s["moments"] if c[0][0] == "Tensor"]
    assert mom and all(m[1][0] == n for m in mom)
    assert {m[1][2] for m in mom} == {cfg.vocab_size // 2}
