"""A whole run at small shapes on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: ``correct`` holds for the
sound runs and comes out false when a token or an answer is altered where
it is produced."""

import pytest

from portbench.tests import smoke

CELLS = ["ivim-slab-stream", "lm-batch-decode", "lm-chat-open"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, _ = smoke.run_small(name, seconds=2.5)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0


@pytest.mark.parametrize("name", ["lm-batch-decode", "lm-chat-open"])
def test_altered_token_is_not_correct(name, monkeypatch):
    from repro_torch.serving import server
    absorb = server.BayesianLMServer._absorb
    calls = {"n": 0}

    def altered(self, st, next_tok, rel):
        calls["n"] += 1
        if calls["n"] % 5 == 0:                 # one token in five
            next_tok = (next_tok + 1) % 512
        return absorb(self, st, next_tok, rel)

    monkeypatch.setattr(server.BayesianLMServer, "_absorb", altered)
    result, _ = smoke.run_small(name, seconds=2.5)
    assert result["correct"] is False


@pytest.mark.parametrize("name", ["ivim-slab-stream"])
def test_altered_answer_is_not_correct(name, monkeypatch):
    from repro_torch.core import plan
    fused = plan.fused_executor

    def altered(*args, **kwargs):
        run = fused(*args, **kwargs)

        def apply(x):
            mean, std = run(x)
            mean = mean.clone()
            mean[::4] += 1e-3               # every fourth voxel's answer
            return mean, std
        return apply

    monkeypatch.setattr(plan, "fused_executor", altered)
    result, _ = smoke.run_small(name, seconds=2.5)
    assert result["correct"] is False
