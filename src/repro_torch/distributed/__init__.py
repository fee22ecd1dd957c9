"""Distributed helpers of the port.

compression.py — the int8 quantizer the serving precision path shares.
elastic.py     — remesh planner: device loss -> nearest valid submesh.
straggler.py   — step-time outlier detection + mitigation policy.
"""

from repro_torch.distributed import (  # noqa: F401
    compression, elastic, straggler)
