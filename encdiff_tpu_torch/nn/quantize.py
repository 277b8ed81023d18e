"""Vector quantization with the straight-through estimator, NCHW.

Counterpart of ``encdiff_tpu/nn/quantize.py:23-69``: the nearest codebook
entry by squared distance ||z||² + ||e||² - 2 z·e, the straight-through form
z + (z_q - z), the legacy codebook loss
β·mean((sg(z_q) − z)²) + mean((z_q − sg(z))²) with β 0.25, and the
perplexity of the batch's code use. The distances need exact fp32:
near-ties flip under TF32, which ``core.device.resolve_device`` turns off on
CUDA. The code counts are summed with ``index_add_``: the JAX one-hot mean
without its (N, n_embed) matrix, and without the host sync of
``bincount``.
"""

from __future__ import annotations

import torch
from torch import nn


def code_frequencies(indices, n_embed: int):
    """(n_embed,) the share of each code among ``indices``."""
    flat = indices.reshape(-1)
    counts = torch.zeros(n_embed, device=flat.device).index_add_(
        0, flat, torch.ones(flat.shape, device=flat.device))
    return counts / flat.numel()


def perplexity(indices, n_embed: int):
    """exp(-Σ p log(p + 1e-10)) of the code frequencies p of ``indices``."""
    p = code_frequencies(indices, n_embed)
    return torch.exp(-(p * torch.log(p + 1e-10)).sum())


class VectorQuantizer(nn.Module):
    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(n_embed, embed_dim))
        self.beta = beta

    def forward(self, z):
        """z: (B, e, H, W) -> (z_q (B, e, H, W), loss, (perplexity, None,
        indices (B, H, W))). z_q is z + (z_q - z): its gradient reaches z
        unchanged, and the codebook is trained by the loss alone."""
        b, e, h, w = z.shape
        flat = z.permute(0, 2, 3, 1).reshape(-1, e).float()
        emb = self.embedding
        dist = ((flat ** 2).sum(1, keepdim=True) + (emb ** 2).sum(1)[None]
                - 2.0 * flat @ emb.t())
        indices = dist.argmin(1)
        z_q = emb[indices].view(b, h, w, e).permute(0, 3, 1, 2)
        loss = (self.beta * ((z_q.detach() - z) ** 2).mean()
                + ((z_q - z.detach()) ** 2).mean())
        return (z + (z_q - z).detach(), loss,
                (perplexity(indices, emb.shape[0]), None, indices.view(b, h, w)))
