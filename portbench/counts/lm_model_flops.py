"""Model FLOPs of LM serving work, for a whole window's share of the
chip's peak: every prefill and decode token row (each mask's row counts),
through every layer and the output head, with causal attention."""

from __future__ import annotations

from portbench.counts import fused_decode

__all__ = ["prefill_flops", "decode_flops"]


def prefill_flops(cfg: dict, length: int, n_masks: int) -> int:
    """One admission's prefill of a ``length``-token prompt on ``n_masks``
    rows (the prompt, not its padded bucket); position i attends i + 1
    keys. The output head runs on the last position only."""
    layers = fused_decode.row_flops(
        {**cfg, "vocab_size": 0}, 0) * length
    attn = (cfg["n_layers"] * 2 * 2 * cfg["n_heads"] * cfg["head_dim"]
            * length * (length + 1) // 2)
    return n_masks * (layers + attn + 2 * cfg["d_model"] * cfg["vocab_size"])


def decode_flops(cfg: dict, positions: list[int]) -> int:
    """One decode step over rows at ``positions``."""
    return sum(fused_decode.row_flops(cfg, p + 1) for p in positions)
