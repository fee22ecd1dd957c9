"""What one fused decode step of a dense GQA decoder needs, counted from
the configuration and the positions of the rows it serves (the
``fused_decode`` kernel computes the step in one launch). Only rows of
occupied slots count: an empty row needs nothing. Each row attends over
the keys up to its own position, however many cache slots the kernel
visits."""

from __future__ import annotations

__all__ = ["layer_params", "layer_small_params", "row_flops", "step_bound"]


def layer_params(cfg: dict) -> int:
    """Product weights of one layer (q, k, v, o and the gated FFN)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    qd = cfg["n_heads"] * cfg["head_dim"]
    kvd = cfg["n_kv_heads"] * cfg["head_dim"]
    return d * qd + 2 * d * kvd + qd * d + 3 * d * f


def layer_small_params(cfg: dict) -> int:
    """A layer's parameters outside the products: the two norms' scales
    (and biases, for LayerNorm) and the q/k/v biases where the block has
    them."""
    d = cfg["d_model"]
    norms = 2 * d * (2 if cfg["norm"] == "layernorm" else 1)
    kvd = cfg["n_kv_heads"] * cfg["head_dim"]
    bias = cfg["n_heads"] * cfg["head_dim"] + 2 * kvd if cfg["qkv_bias"] \
        else 0
    return norms + bias


def row_flops(cfg: dict, context: int) -> int:
    """FLOPs of one token row through every layer and the output head,
    attending over ``context`` keys (QK^T and PV, 2 FLOPs a multiply-add)."""
    attn = 2 * 2 * cfg["n_heads"] * cfg["head_dim"] * context
    return (cfg["n_layers"] * (2 * layer_params(cfg) + attn)
            + 2 * cfg["d_model"] * cfg["vocab_size"])


def step_bound(cfg: dict, positions: list[int], n_masks: int,
               kv_bytes: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode step whose occupied rows feed tokens at
    ``positions`` (one entry a row; a slot's ``n_masks`` rows each count).

    Bytes: every weight once in the config's dtype (layers, norms, biases,
    masks, output head and final norm; the fed tokens' embedding rows),
    each row's cached keys
    and values at positions 0 .. pos-1 read, its fresh k/v written, and the
    slots' fp32 mean log-probs written."""
    wb = 2 if cfg["dtype"] == "bfloat16" else 4
    d, nl = cfg["d_model"], cfg["n_layers"]
    kvd = cfg["n_kv_heads"] * cfg["head_dim"]
    rows = len(positions)
    final_norm = d * (2 if cfg["norm"] == "layernorm" else 1)
    weights = (nl * (layer_params(cfg) + layer_small_params(cfg)
                     + n_masks * cfg["d_ff"])
               + d * cfg["vocab_size"] + final_norm + rows * d)
    kv_read = sum(positions) * nl * 2 * kvd * kv_bytes
    kv_write = rows * nl * 2 * kvd * kv_bytes
    out = (rows // n_masks) * cfg["vocab_size"] * 4
    flops = sum(row_flops(cfg, p + 1) for p in positions)
    return flops, weights * wb + kv_read + kv_write + out
