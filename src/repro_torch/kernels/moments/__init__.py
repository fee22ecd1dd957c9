"""moments: mean and std over the mask-sample axis (``csrc/moments.cu``)."""
