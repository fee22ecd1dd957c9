"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit), and the card's own power limit, which is
printed beside every share of a peak."""

from __future__ import annotations

import subprocess

__all__ = ["BF16_FLOPS", "TF32X3_FLOPS", "HBM_BYTES_PER_S", "power_limit"]

BF16_FLOPS = 989e12          # bf16 tensor cores
TF32X3_FLOPS = 495e12 / 3    # fp32 as three TF32 products (3xTF32)
HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """``name, power.limit`` of card 0 as ``nvidia-smi`` reads them, or
    "not read" where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip() or "not read"
