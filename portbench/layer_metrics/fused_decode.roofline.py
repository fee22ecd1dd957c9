"""``fused_decode`` (``kernels/csrc/fused_decode.cu``) against its roofline:
the least time each decode step of the window could take (the larger of
its FLOPs at the bf16 peak and its bytes at the HBM rate, counted by
``counts/fused_decode.py`` from the positions of the rows served) over the
kernel's device time in the trace."""

from portbench.counts import fused_decode, peaks


def read(ctx):
    tl = ctx.tally
    kernel_s = ctx.trace.op_seconds("fused_decode_kernel")
    if not kernel_s:
        return None
    bound = 0.0
    for positions, _ in tl["steps"]:
        if positions:
            f, b = fused_decode.step_bound(tl["dims"], positions,
                                           tl["n_masks"])
            bound += max(f / peaks.BF16_FLOPS, b / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / kernel_s
