"""Distributed helpers of the port.

sharding.py    — leaf-path -> spec rules (FSDP over "data", TP over "model",
                 EP for experts, sequence-sharded KV caches) and their
                 DTensor placements on a ``DeviceMesh``.
checkpoint.py  — atomic manifest checkpoints, keep-last-K rotation; restore
                 reshards onto any mesh (the elastic restart path).
compression.py — the int8 quantizer (serving), error-feedback gradient
                 compression (training) and the int8 all-reduce.
elastic.py     — remesh planner: device loss -> nearest valid submesh, and
                 the planned ``DeviceMesh``.
pipeline.py    — GPipe stage runner over a "stage" mesh dim (point-to-point
                 sends between stages).
straggler.py   — step-time outlier detection + mitigation policy.
"""

from repro_torch.distributed import (  # noqa: F401
    checkpoint, compression, elastic, pipeline, sharding, straggler)
