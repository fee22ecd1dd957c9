"""The packed uIVIM-NET chain's FLOPs for every voxel served in the window
(``counts/fused_moments.py``) over the window times the 3xTF32 rate."""

from portbench.counts import fused_moments, peaks


def read(ctx):
    tl = ctx.tally
    p = tl["plan"]
    flops = tl["voxels"] * fused_moments.flops_per_voxel(
        p["width"], p["groups"], p["n_masks"], p["k1"], p["k2"])
    return 100.0 * flops / (tl["window_s"] * peaks.TF32X3_FLOPS)
