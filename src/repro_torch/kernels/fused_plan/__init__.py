"""fused_plan: the whole lowered plan chain in one launch, samples and
moments modes (``csrc/fused_plan.cu``)."""
