"""AdamW and Adafactor over parameter trees (the port's twin of
``repro.optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, OptimizerConfig, adafactor, adamw, build_optimizer,
    clip_by_global_norm, cosine_schedule)
