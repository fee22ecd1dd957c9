"""Plain fp32 uIVIM-NET (paper §IV, Fig. 2): the reference the IVIM cells
are judged by.

Four separate sub-networks (D, D*, f, S0), each linear -> BN -> ReLU ->
mask -> linear -> BN -> ReLU -> mask -> linear -> sigmoid -> C(.), run on
the raw, unfolded and unpacked weights with the Masksembles masks
multiplied in, every voxel under every mask, then the mean and the
population std over the masks. Plain PyTorch; imports nothing of the
program. TF32 is switched off for the products (``fp32_products``).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["fp32_products", "tf32_products", "moments"]

BN_EPS = 1e-5


@contextlib.contextmanager
def _matmul_precision(tf32: bool):
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = (cuda.allow_tf32, cudnn.allow_tf32)
    cuda.allow_tf32 = cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = was


def fp32_products():
    """Float32 products as float32: TF32 off on cuBLAS and cuDNN."""
    return _matmul_precision(False)


def tf32_products():
    """Float32 products in TF32 (the control's precision)."""
    return _matmul_precision(True)


def _bn(h: torch.Tensor, bn: dict, g: int) -> torch.Tensor:
    return ((h - bn["mean"][g]) / torch.sqrt(bn["var"][g] + BN_EPS)
            * bn["gamma"][g] + bn["beta"][g])


@torch.no_grad()
def moments(raw: dict, x: torch.Tensor, out_ranges
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, Nb] fp32 -> (mean [B, 4], std [B, 4]) over the masks.

    ``raw``: fc1/fc2/enc {w [4, d_in, d_out], b [4, d_out]}, bn1/bn2
    {gamma, beta, mean, var} [4, W], mask1/mask2 [N, W] (0/1)."""
    x = x.float()
    n = raw["mask1"].shape[0]
    cols = []
    for g in range(raw["fc1"]["w"].shape[0]):
        samples = []
        for i in range(n):
            h = x @ raw["fc1"]["w"][g] + raw["fc1"]["b"][g]
            h = torch.relu(_bn(h, raw["bn1"], g)) * raw["mask1"][i]
            h = h @ raw["fc2"]["w"][g] + raw["fc2"]["b"][g]
            h = torch.relu(_bn(h, raw["bn2"], g)) * raw["mask2"][i]
            z = h @ raw["enc"]["w"][g] + raw["enc"]["b"][g]
            lo, hi = out_ranges[g]
            samples.append(lo + torch.sigmoid(z[:, 0]) * (hi - lo))
        cols.append(torch.stack(samples))                 # [N, B]
    s = torch.stack(cols, -1)                             # [N, B, 4]
    mean = s.mean(0)
    std = torch.sqrt(((s - mean) ** 2).mean(0))
    return mean, std
