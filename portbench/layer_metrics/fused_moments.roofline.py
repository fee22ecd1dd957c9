"""``fused_plan``'s moments kernel (``fused_moments_kernel`` in
``kernels/csrc/fused_plan.cu``) against its roofline: each chunk's least
time (its packed-chain FLOPs at the 3xTF32 rate, or its bytes at the HBM
rate, whichever is larger: ``counts/fused_moments.py``) over the kernel's
device time in the trace."""

from portbench.counts import fused_moments, peaks


def read(ctx):
    tl = ctx.tally
    kernel_s = ctx.trace.op_seconds("fused_moments_kernel")
    if not kernel_s:
        return None
    p = tl["plan"]
    chunks, rest = divmod(tl["slab_voxels"], tl["chunk"])
    bound = 0.0
    for n, voxels in ((chunks * tl["slabs"], tl["chunk"]),
                      (tl["slabs"] if rest else 0, rest)):
        f, b = fused_moments.chunk_bound(voxels, p["width"], p["groups"],
                                         p["n_masks"], p["k1"], p["k2"])
        bound += n * max(f / peaks.TF32X3_FLOPS, b / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / kernel_s
