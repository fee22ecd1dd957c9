"""Canonical (architecture x input-shape) dry-run cell enumeration (the
port's twin of ``repro.configs.cells``).

40 cells in all; cells that are structurally inapplicable are
*enumerated with a skip reason* (never silently dropped):

  * encoder-only archs (hubert-xlarge) have no decode step -> decode_32k and
    long_500k are skipped;
  * long_500k requires sub-quadratic sequence mixing -> skipped for pure
    full-attention archs, run for hybrid (RG-LRU) and ssm (xLSTM) families.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, InputShape
from repro_torch.configs.registry import ARCH_IDS, get_config

__all__ = ["Cell", "enumerate_cells", "runnable_cells", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class Cell:
    arch_id: str
    shape: InputShape
    skip: str = ""          # non-empty -> skipped, with reason

    @property
    def name(self) -> str:
        return f"{self.arch_id}/{self.shape.name}"

    @property
    def runnable(self) -> bool:
        return not self.skip


def skip_reason(arch_id: str, shape: InputShape) -> str:
    cfg = get_config(arch_id)
    if shape.kind == "decode" and not cfg.has_decode:
        return "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full quadratic attention at 524k seq is not a supported "
                "serving configuration (O(S^2)); run for hybrid/ssm only")
    return ""


def enumerate_cells() -> list[Cell]:
    return [Cell(a, s, skip_reason(a, s))
            for a in ARCH_IDS for s in SHAPES.values()]


def runnable_cells() -> list[Cell]:
    return [c for c in enumerate_cells() if c.runnable]
