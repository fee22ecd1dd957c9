"""Model FLOPs of the whole window's LM work (every prefill and decode
token row, each mask's row, layers, output head and attention:
``counts/lm_model_flops.py``) over the window times the bf16 peak."""

from portbench.counts import lm_model_flops, peaks


def read(ctx):
    tl = ctx.tally
    if not tl["steps"]:
        return None
    flops = 0
    for positions, prefills in tl["steps"]:
        flops += lm_model_flops.decode_flops(tl["dims"], positions)
        flops += sum(lm_model_flops.prefill_flops(tl["dims"], n,
                                                  tl["n_masks"])
                     for n in prefills)
    return 100.0 * flops / (tl["window_s"] * peaks.BF16_FLOPS)
