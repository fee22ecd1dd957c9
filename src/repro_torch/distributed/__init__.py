"""Distributed helpers of the port.

checkpoint.py  — atomic manifest checkpoints, keep-last-K rotation.
compression.py — the int8 quantizer (serving) and error-feedback gradient
                 compression (training).
elastic.py     — remesh planner: device loss -> nearest valid submesh.
straggler.py   — step-time outlier detection + mitigation policy.
"""

from repro_torch.distributed import (  # noqa: F401
    checkpoint, compression, elastic, straggler)
