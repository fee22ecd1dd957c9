"""The port's examples (``repro_torch.examples``) on the CPU: each
``main([..., "--device", "cpu"])`` at small step counts with its printed
claims checked, the flags' mutual checks, and the examples' serving paths
against the JAX package's on the same parameters and inputs.

Tolerances: the packed IVIM samples within 1e-5 of the reference's
``packed_apply`` (fp32 products in another order); the one-shot LM
serving's tokens equal and its rel-unc within 1e-3 of the reference's
``serve_uncertain`` (the example's own bar for a cross-framework run of 12
greedy steps); chaos tokens equal to the unfaulted router's (the port's
failover is bit for bit).
"""

import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.ivim import data as j_data
from repro.ivim import model as j_ivim
from repro.ivim import train as j_train
from repro.models import build_model as j_build_model
from repro.serving import engine as j_engine
from repro_torch.configs import registry as t_registry
from repro_torch.examples import (quickstart, serve_uncertainty_lm,
                                  train_ivim, train_lm)
from repro_torch.ivim import data as t_data
from repro_torch.ivim import model as t_ivim
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.obs import registry as t_reg
from repro_torch.obs import trace as t_trace

CPU = ["--device", "cpu"]
VERIFY_OBS = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "verify_obs.py"


@pytest.fixture(autouse=True)
def _isolate_port_obs():
    """The server examples switch the process tracer on and fill the
    process registry: both are restored after every test."""
    state = t_reg.REGISTRY.dump_state()
    was_enabled = t_trace.TRACER.enabled
    try:
        yield
    finally:
        t_reg.REGISTRY.restore_state(state)
        if not was_enabled:
            t_trace.TRACER.disable()
            t_trace.TRACER.clear()


def _floats(pattern, text):
    """The numbers of ``pattern``'s groups at its first match."""
    return [float(v) for v in re.search(pattern, text).groups()]


# ---------------------------------------------------------------------------
# main() of each example, as a user runs it
# ---------------------------------------------------------------------------


def test_quickstart_main(capsys):
    assert quickstart.main(CPU) == 0
    out = capsys.readouterr().out
    first, last = _floats(r"loss: ([\d.]+) -> ([\d.]+)", out)
    assert last < first
    (err,) = _floats(r"max\|err\| vs training form = ([\d.e+-]+)", out)
    assert err < 1e-5
    assert "volume serving: (16, 16, 2, 11) -> mean/std (16, 16, 2, 4)" \
        in out
    for name in t_ivim.PARAM_NAMES:
        assert re.search(rf"{name}: [\d.]+ \+/- [\d.]+ \(truth", out)


def test_train_ivim_main(capsys):
    assert train_ivim.main(["--steps", "60"] + CPU) == 0
    out = capsys.readouterr().out
    assert "training uIVIM-NET: 11 b-values, N=4, scale=2.0, 60 steps" in out
    rows = re.findall(r"^\s*(\d+) +([\d.]+)((?: +[\d.]+){8})$", out, re.M)
    assert [int(r[0]) for r in rows] == [int(s) for s in t_data.SNR_LEVELS]
    assert all(np.isfinite(float(r[1])) for r in rows)
    assert "Phase-2 gate (paper Figs. 6-7 trends):" in out


def test_train_lm_main_resumes_as_an_uninterrupted_run(tmp_path, capsys):
    """Six steps, then a rerun to eight that resumes from the sixth step's
    checkpoint: its two losses equal an uninterrupted eight-step run's."""
    small = ["--d-model", "64", "--layers", "2", "--seq", "16",
             "--batch", "4"] + CPU
    assert train_lm.main(["--steps", "6", "--ckpt-dir",
                          str(tmp_path / "a")] + small) == 0
    out = capsys.readouterr().out
    assert re.search(r"arch=qwen2-1.5b family=dense params=[\d.]+M "
                     r"masksembles N=4", out)
    assert re.search(r"step     0  loss [\d.]+ +[\d.]+ ms  \[ok\]", out)
    assert "done: loss" in out
    kw = dict(d_model=64, layers=2, seq=16, batch=4, device="cpu")
    resumed = train_lm.run(steps=8, ckpt_dir=str(tmp_path / "a"), **kw)
    whole = train_lm.run(steps=8, ckpt_dir=str(tmp_path / "b"), **kw)
    assert [h["step"] for h in resumed["history"]] == [6, 7]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in whole["history"][6:]]
    assert resumed["ckpt_dir"].endswith(f"_qwen2-1.5b_{whole['n_params']}")


def test_serve_uncertainty_lm_one_shot_main(capsys):
    assert serve_uncertainty_lm.main(["--tokens", "4"] + CPU) == 0
    out = capsys.readouterr().out
    assert "arch=qwen2-1.5b (reduced), N=4 fixed masks" in out
    assert len(re.findall(r"^req \d: tokens(?: +\d+){4}$", out, re.M)) == 2
    assert re.search(r"flagged \d+/8 tokens for review", out)


def test_serve_uncertainty_lm_pooled_main(tmp_path, capsys):
    """``--server --scan --hosts 3 --chaos``, traced, with the metrics
    written: every request and the scan complete, host 0 dies and is
    recovered from, the trace passes the repository's verifier and the
    exposition names the serving metrics."""
    trace, prom = tmp_path / "trace.jsonl", tmp_path / "metrics.prom"
    argv = ["--server", "--scan", "--hosts", "3", "--chaos", "--tokens", "4",
            "--trace-out", str(trace), "--metrics-out", str(prom)] + CPU
    assert serve_uncertainty_lm.main(argv) == 0
    out = capsys.readouterr().out
    assert "chaos: host 0 goes silent at router step 2" in out
    assert len(re.findall(r"^req \d: tokens(?: +\d+){4}$", out, re.M)) == 4
    assert re.search(r"chunks    4 \(\d+ flagged above 0.35, 0 "
                     r"preemptions\)", out)
    assert re.search(r"router: 5/5 completed .* deaths 1", out)
    (n,) = [int(v) for v in re.findall(r"wrote (\d+) trace records", out)]
    assert n > 0 and len(trace.read_text().splitlines()) == n
    spec = importlib.util.spec_from_file_location("verify_obs", VERIFY_OBS)
    verify_obs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(verify_obs)
    events = [json.loads(line) for line in trace.read_text().splitlines()]
    assert verify_obs.verify_trace_events(events) == []
    assert "# TYPE router_host_deaths_total counter" in prom.read_text()


@pytest.mark.parametrize("argv,message", [
    (["--scan"], "--scan needs --server"),
    (["--hosts", "2"], "--hosts needs --server"),
    (["--server", "--chaos"], "--chaos needs --hosts >= 2"),
    (["--trace-out", "t.jsonl"], "--trace-out/--metrics-out need --server"),
])
def test_serve_uncertainty_lm_flag_checks(argv, message):
    with pytest.raises(SystemExit, match=message):
        serve_uncertainty_lm.main(argv + CPU)


@pytest.mark.parametrize("example,argv", [
    (quickstart, []), (train_ivim, ["--steps", "1"]),
    (train_lm, ["--steps", "1"]), (serve_uncertainty_lm, []),
    (serve_uncertainty_lm, ["--server"])])
def test_examples_run_on_the_card_unless_told(monkeypatch, tmp_path, example,
                                              argv):
    """Without ``--device`` an example runs on the card, and raises where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if example is train_lm:
        argv = argv + ["--ckpt-dir", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main(argv)


# ---------------------------------------------------------------------------
# the examples' paths against the reference
# ---------------------------------------------------------------------------


def test_quickstart_packed_path_matches_the_reference():
    """The quickstart's packed check on the reference's trained parameters
    (20 steps at its settings, carried over by ``params_from_jax``): the
    packed samples within 1e-5 of the reference's ``packed_apply``, and the
    packed-vs-training-form gap under 1e-5 as in the reference's run."""
    cfg = j_ivim.IvimConfig(n_masks=4, scale=2.0)
    ds = j_data.make_dataset(j_data.SyntheticConfig(n_voxels=512, snr=20.0,
                                                    seed=0))
    params, state, _ = j_train.train(
        cfg, j_train.TrainConfig(steps=20, batch_size=128, lr=3e-3),
        dataset=ds)
    x = np.array(ds["signals"][:8])
    want = np.asarray(j_ivim.packed_apply(
        j_ivim.pack_for_serving(cfg, params, state), jnp.asarray(x),
        backend="xla"))
    model = t_ivim.params_from_jax(
        t_ivim.IvimConfig(n_masks=4, scale=2.0),
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state),
        device="cpu")
    plan, served, err = quickstart.packed_check(model, torch.from_numpy(x),
                                                device="cpu")
    np.testing.assert_allclose(served.numpy(), want, rtol=1e-5, atol=1e-5)
    assert err < 1e-5
    assert plan.pairs[0].keep == \
        j_ivim.pack_for_serving(cfg, params, state).pairs[0].keep


def test_serving_example_matches_the_reference():
    """``serve_oneshot`` on the reference's weights (``params_from_jax``)
    and the example's numpy prompts: the reference's ``serve_uncertain``
    tokens, its rel-unc within 1e-3, its flags."""
    jcfg = j_registry.smoke_config("qwen2-1.5b", mask_samples=4)
    tcfg = t_registry.smoke_config("qwen2-1.5b", mask_samples=4)
    jmodel = j_build_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    toks = serve_uncertainty_lm.prompts(2, tcfg.vocab_size)
    jg, ju, jf = j_engine.serve_uncertain(
        jmodel, jp, jnp.asarray(toks),
        j_engine.ServeConfig(max_new_tokens=12, uncertainty_threshold=0.35))
    tg, tu, tf = serve_uncertainty_lm.serve_oneshot(
        t_model.build_model(tcfg), tp, toks, tokens=12, threshold=0.35,
        device="cpu")
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg)[:, 8:])
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_chaos_tokens_equal_the_unfaulted_routers():
    """Host 0 killed at router step 2: every request's tokens and
    uncertainties, and the scan's moments, equal the unfaulted run's."""
    kw = dict(server=True, hosts=3, scan=True, tokens=6, device="cpu")
    clean = serve_uncertainty_lm.run(chaos=False, **kw)
    chaos = serve_uncertainty_lm.run(chaos=True, **kw)
    assert chaos["summary"].host_deaths == 1 and \
        clean["summary"].host_deaths == 0
    for a, b in zip(clean["requests"], chaos["requests"]):
        assert len(a.generated) == 6
        assert list(a.generated) == list(b.generated)
        assert list(a.uncertainty) == list(b.uncertainty)
    for a, b in zip(clean["scan"].scan_moments(),
                    chaos["scan"].scan_moments()):
        assert torch.equal(a, b)
