"""Vector quantization, forward only, NCHW.

Counterpart of ``encdiff_tpu/nn/quantize.py:23-69``: the nearest codebook
entry by squared distance ||z||² + ||e||² - 2 z·e, and the straight-through
form z + (z_q - z). The distances need exact fp32: near-ties flip under
TF32, which ``core.device.resolve_device`` turns off on CUDA.
"""

from __future__ import annotations

import torch
from torch import nn


class VectorQuantizer(nn.Module):
    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(n_embed, embed_dim))

    def forward(self, z):
        """z: (B, e, H, W) -> (z_q (B, e, H, W), indices (B, H, W))."""
        b, e, h, w = z.shape
        flat = z.permute(0, 2, 3, 1).reshape(-1, e).float()
        emb = self.embedding
        dist = ((flat ** 2).sum(1, keepdim=True) + (emb ** 2).sum(1)[None]
                - 2.0 * flat @ emb.t())
        indices = dist.argmin(1)
        z_q = emb[indices].view(b, h, w, e).permute(0, 3, 1, 2)
        return z + (z_q - z), indices.view(b, h, w)
