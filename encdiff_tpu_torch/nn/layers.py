"""Shared layers, NCHW. Counterpart of ``encdiff_tpu/nn/layers.py:70-235``.

Weights come from converted flax checkpoints (``encdiff_tpu_torch/convert.py``),
so module and parameter names follow the flax tree: a flax
``<name>/Conv_0/kernel`` is ``<name>.weight`` here. ``TorchDense`` of the
JAX package is ``nn.Linear``; ``GroupNorm`` (eps 1e-6 in the
SpatialTransformer and the VQ ``AttnBlock``) is ``nn.GroupNorm``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from encdiff_tpu_torch.nn.kernels.groupnorm_silu import groupnorm_silu


class TorchConv(nn.Conv2d):
    """2-d convolution with torch-integer padding: an int, or
    ``((top, bottom), (left, right))`` for the asymmetric case."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding=0,
                 bias: bool = True):
        self.pad4 = None
        if not isinstance(padding, int):
            (top, bottom), (left, right) = padding
            self.pad4 = (left, right, top, bottom)
            padding = 0
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, bias=bias)

    def forward(self, x):
        if self.pad4 is not None:
            x = F.pad(x, self.pad4)
        return super().forward(x)


class GNSiLU(nn.Module):
    """GroupNorm (+ FiLM scale/shift) + SiLU through the ``groupnorm_silu``
    kernel; the GN-SiLU prologue of every UNet ResBlock (eps 1e-5) and VQ
    ResnetBlock (eps 1e-6)."""

    def __init__(self, channels: int, eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps
        self.groups = groups

    def forward(self, x, scale=None, shift=None):
        return groupnorm_silu(x, self.weight, self.bias, scale, shift,
                              groups=self.groups, eps=self.eps)


def nonlinearity(x):
    """SiLU."""
    return F.silu(x)


def timestep_embedding(timesteps, dim: int, max_period: int = 10000):
    """Sinusoidal embedding in [cos | sin] order: (B,) -> (B, dim) fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def avg_pool_2x(x):
    """2x2 average pool, stride 2."""
    return F.avg_pool2d(x, 2)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
