"""Encoder4, the concept-token encoder, NCHW.

Counterpart of ``encdiff_tpu/nn/encoder4.py:30-148``: a stride-2 CNN maps a
(B, 3, S, S) image to ``latent_unit`` scalars (``encoding``), and
``latent_unit`` scalar->token MLPs lift them to concept tokens (``warp``).
``bn3`` is followed by no ReLU, as in the reference. The final Linear reads
the CHW flatten; the converter permutes the flax HWC-ordered fc rows to
match. In eval mode the BatchNorms run on their running statistics; in
train mode they follow flax (``BatchNorm`` below).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from encdiff_tpu_torch.nn.layers import TorchConv


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5) whose train mode is flax's
    ``nn.BatchNorm(momentum=0.9)``: normalise with the batch mean and the
    biased batch variance E[x²] − E[x]² (flax's fast variance, clipped at
    0), and update the running statistics as ``ra = 0.9·ra + 0.1·batch``
    with that biased variance. ``nn.BatchNorm2d`` itself updates the
    running variance with the unbiased one, at momentum 0.1. With
    ``update_stats=False`` train mode leaves the running statistics as they
    are, as a flax ``apply`` whose ``batch_stats`` update is discarded."""

    def forward(self, x, update_stats: bool = True):
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3)
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        if update_stats:
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None])


class EncResBlock(nn.Module):
    """x + Conv1x1(ReLU(BN(Conv3x3(ReLU(x)))))."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = TorchConv(channels, channels, 3, padding=1)
        self.bn = BatchNorm(channels, eps=1e-5)
        self.conv2 = TorchConv(channels, channels, 1)

    def forward(self, x):
        h = F.relu(self.bn(self.conv1(F.relu(x))))
        return x + self.conv2(h)


class WarpMLPs(nn.Module):
    """``latent_unit`` independent 1 -> 64 -> 128 -> context_dim ELU MLPs
    on stacked weights: (B, U) -> (B, U, D)."""

    def __init__(self, latent_unit: int, context_dim: int):
        super().__init__()
        u, d = latent_unit, context_dim
        self.w1 = nn.Parameter(torch.zeros(u, 1, 64))
        self.b1 = nn.Parameter(torch.zeros(u, 64))
        self.w2 = nn.Parameter(torch.zeros(u, 64, 128))
        self.b2 = nn.Parameter(torch.zeros(u, 128))
        self.w3 = nn.Parameter(torch.zeros(u, 128, d))
        self.b3 = nn.Parameter(torch.zeros(u, d))

    def forward(self, u):
        h = F.elu(u[:, :, None] * self.w1[None, :, 0, :] + self.b1)
        h = F.elu(torch.einsum("bud,udk->buk", h, self.w2) + self.b2)
        return torch.einsum("bud,udk->buk", h, self.w3) + self.b3


class Encoder4(nn.Module):
    def __init__(self, d: int = 128, context_dim: int = 16,
                 latent_unit: int = 20, num_channels: int = 3,
                 image_size: int = 64):
        super().__init__()
        for i, cin in enumerate((num_channels, d, d, d), start=1):
            self.add_module(f"conv{i}", TorchConv(cin, d, 4, stride=2,
                                                  padding=1))
        for i in range(1, 6):
            self.add_module(f"bn{i}", BatchNorm(d, eps=1e-5))
        self.res1 = EncResBlock(d)
        self.res2 = EncResBlock(d)
        side = image_size // 16
        self.fc = nn.Linear(d * side * side, latent_unit)
        self.warp_mlps = WarpMLPs(latent_unit, context_dim)

    def encoding(self, x):
        """(B, 3, S, S) -> (B, latent_unit) raw scalars; S is the
        ``image_size`` the fc was sized for."""
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        h = F.relu(self.bn4(self.conv4(h)))
        h = self.res1(h)
        h = F.relu(self.bn5(h))
        h = self.res2(h)
        return self.fc(h.flatten(1))

    def warp(self, u):
        """(B, latent_unit) -> flat tokens (B, latent_unit * context_dim)."""
        return self.warp_mlps(u).reshape(u.shape[0], -1)

    def forward(self, x):
        return self.warp(self.encoding(x))
