"""The traffic generator: deterministic per seed, the same set of sizes
and gaps for every seed, and the parameters of each cell file."""

import numpy as np
import pytest

from portbench import run, traffic
from portbench.tests import smoke

LM_CELLS = ["lm-batch-decode", "lm-chat-open"]
SECONDS = smoke.BENCH["run_seconds"]


@pytest.mark.parametrize("name", LM_CELLS)
def test_requests_deterministic_per_seed(name):
    tr = run.load("workloads", name)["traffic"]
    a = traffic.lm_requests(tr, 152064, 2**31 + 17, SECONDS)
    b = traffic.lm_requests(tr, 152064, 2**31 + 17, SECONDS)
    assert len(a) == sum(traffic._blocks(tr, SECONDS))
    c = traffic.lm_requests(tr, 152064, 5, SECONDS)
    assert [(r.max_new_tokens, r.tokens.tolist()) for r in a] == \
        [(r.max_new_tokens, r.tokens.tolist()) for r in b]
    assert [r.max_new_tokens for r in a] != [r.max_new_tokens for r in c]


def _window_blocks(tr, reqs):
    """The requests split into the generator's blocks; the window blocks
    (every block but an open loop's priming one)."""
    sizes = traffic._blocks(tr, SECONDS)
    out, at = [], 0
    for n in sizes:
        out.append(reqs[at:at + n])
        at += n
    assert at == len(reqs)
    return out[1:] if tr["loop"] == "open" else out


@pytest.mark.parametrize("name", LM_CELLS)
def test_sizes_match_cell_file(name):
    tr = run.load("workloads", name)["traffic"]
    reqs = traffic.lm_requests(tr, 152064, 123, SECONDS)
    other = traffic.lm_requests(tr, 152064, 999, SECONDS)
    p, o = tr["prompt"], tr["output"]
    for block, twin in zip(_window_blocks(tr, reqs),
                           _window_blocks(tr, other)):
        assert len(block) == traffic.window_block(tr, SECONDS)
        prompts = np.array([len(r.tokens) for r in block])
        outs = np.array([r.max_new_tokens for r in block])
        assert prompts.min() >= p["min"] and prompts.max() <= p["max"]
        assert outs.min() >= o["min"] and outs.max() <= o["max"]
        for got, spec in ((prompts, p), (outs, o)):
            # the block's median is the stated one, to its grid's step
            assert abs(np.median(got) - spec["median"]) \
                <= 0.1 * spec["median"]
        assert sorted(prompts) == sorted(len(r.tokens) for r in twin)
        assert sorted(outs) == sorted(r.max_new_tokens for r in twin)
    assert all(0 <= r.tokens.min() and r.tokens.max() < 152064
               for r in reqs)


@pytest.mark.parametrize("name", ["lm-chat-open"])
def test_arrivals_poisson_at_cell_rate(name):
    tr = run.load("workloads", name)["traffic"]
    reqs = traffic.lm_requests(tr, 152064, 42, SECONDS)
    a = traffic.arrivals(tr, 42, SECONDS)
    assert len(a) == len(reqs) and np.all(np.diff(a) > 0)
    rate = tr["rate_per_s"]
    assert abs(len(a) / a[-1] - rate) / rate < 0.05
    gaps = np.diff(np.concatenate([[0.0], a]))
    assert abs(np.std(gaps) / np.mean(gaps) - 1.0) < 0.2     # exponential
    b = traffic.arrivals(tr, 43, SECONDS)
    assert np.allclose(np.sort(np.diff(np.concatenate([[0.0], b]))),
                       np.sort(gaps))
    assert not np.allclose(a, b)
    assert np.array_equal(a, traffic.arrivals(tr, 42, SECONDS))
    # every seed's window (after the priming block) offers one whole block,
    # spanning the benchmark's window at the cell's rate
    blocks = traffic._blocks(tr, SECONDS)
    start = blocks[0] if len(blocks) > tr["cycles"] else 0
    n = traffic.window_block(tr, SECONDS)
    span = a[start + n - 1] - (a[start - 1] if start else 0)
    assert abs(span - SECONDS) / SECONDS < 0.1


def test_blocks_follow_run_seconds():
    tr = {"loop": "open", "rate_per_s": 2.0, "prime_s": 3.0, "cycles": 2}
    assert traffic._blocks(tr, 10) == [6, 20, 20]
    assert traffic._blocks(tr, 51) == [6, 102, 102]
    closed = {"loop": "closed", "block": 32, "cycles": 3}
    assert traffic._blocks(closed, 51) == [32, 32, 32]


def test_residual_outputs_stagger():
    outs = [1000] * 16
    cut = traffic.residual_outputs(outs, 7)
    assert sorted(cut) == sorted(int(np.ceil((i + 0.5) / 16 * 1000))
                                 for i in range(16))
    assert cut == traffic.residual_outputs(outs, 7)
    assert cut != traffic.residual_outputs(outs, 8)


def test_uniform_quantiles_cover_range():
    v = traffic.quantile_sizes({"dist": "uniform", "min": 384, "max": 1024},
                               641)
    assert sorted(set(v)) == list(range(384, 1025))
