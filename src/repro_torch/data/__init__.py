"""Seeded, stateless LM batches (the port's twin of ``repro.data``)."""

from repro_torch.data.pipeline import (  # noqa: F401
    LMDataConfig, batch_specs, host_slice, lm_batch)
