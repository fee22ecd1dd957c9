"""The two plain references against the port's CPU path at small widths,
on the benchmark's own weights. (The test imports both; the references
import nothing of the program.)"""

import numpy as np
import torch

from portbench import inputs
from portbench.drivers import ivim_volume, lm_server
from portbench.reference import ivim as ivim_ref
from portbench.reference import qwen2 as lm_ref
from portbench.tests import smoke

CPU = smoke.CPU


def test_ivim_reference_matches_the_packed_plan():
    from repro_torch.serving import engine
    cfg = smoke.configs()["uivim-dense104-m8"]
    raw = inputs.ivim_raw(cfg, 8, 31337, CPU)
    plan = ivim_volume.build_plan(cfg, raw, 8)
    x = inputs.ivim_slabs(cfg, [4, 4, 8], 1, 20.0, 5, CPU)[0].reshape(-1, 104)
    mean, std = engine.predict_packed(plan, x, chunk=32, device=CPU)
    rm, rs = ivim_ref.moments(raw, x, cfg["out_ranges"])
    assert torch.allclose(mean, rm, atol=2e-6, rtol=0)
    assert torch.allclose(std, rs, atol=2e-6, rtol=0)
    assert float(rs.max()) > 1e-3          # the masks do spread the samples


def test_ivim_reference_follows_its_masks():
    cfg = smoke.configs()["uivim-dense104-m8"]
    raw = inputs.ivim_raw(cfg, 8, 1, CPU)
    x = torch.rand(16, 104)
    one = {**raw, "mask1": raw["mask1"][:1].repeat(8, 1),
           "mask2": raw["mask2"][:1].repeat(8, 1)}
    _, std = ivim_ref.moments(one, x, cfg["out_ranges"])
    assert float(std.max()) < 1e-6         # one mask: no spread


def test_lm_reference_matches_the_port_forward():
    from repro_torch.core import uncertainty
    from repro_torch.models import transformer
    config = smoke.lm_config()
    d = lm_server.dims(config)
    model = lm_server.build_model(d)
    raw = inputs.lm_raw(d, 2024, CPU)
    params = lm_server.program_params(raw)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 512, 19))
    n = d["mask_samples"]
    logits, _ = transformer.forward(
        model.cfg, params, {"tokens": toks[None].repeat(n, 1)},
        mask_ids=torch.arange(n), device=CPU)
    logp = torch.log_softmax(logits.float(), -1)
    want_mean, want_std = uncertainty.predictive_moments(logp)

    def layer(li):
        return {k: raw[k][li].float() for k in lm_ref.LAYER_KEYS}

    head = {"norm_w": raw["norm_w"], "unembed": raw["unembed"]}
    mean, std = lm_ref.posterior(d, layer, raw["embed"], head, raw["masks"],
                                 toks, 0)
    assert torch.allclose(mean, want_mean, atol=2e-5, rtol=0)
    assert torch.allclose(std, want_std, atol=2e-5, rtol=0)
    last, _ = lm_ref.posterior(d, layer, raw["embed"], head, raw["masks"],
                               toks, 15)
    assert torch.allclose(last, mean[15:], atol=1e-6, rtol=0)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def test_lm_weights_fill_the_programs_tree():
    d = lm_server.dims(smoke.lm_config())
    raw = inputs.lm_raw(d, 1, CPU)
    model = lm_server.build_model(d)
    assert _shapes(lm_server.program_params(raw)) == \
        _shapes(model.param_specs())
