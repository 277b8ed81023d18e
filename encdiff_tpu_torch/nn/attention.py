"""Cross-attention stack of the UNet, NCHW at its edges.

Counterpart of ``encdiff_tpu/nn/attention.py:28-191`` without attention-map
capture, which is not on the serving or training path. ``attention`` routes
as the JAX ``attention`` does: large self-attention to the flash kernels,
everything else to the ``attention_core`` kernel.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from encdiff_tpu_torch.nn.kernels.attention import attention_core
from encdiff_tpu_torch.nn.kernels.flash_attention import flash_attention
from encdiff_tpu_torch.nn.layers import TorchConv


def takes_flash(n: int, m: int) -> bool:
    """Whether attention of N queries over M keys runs the flash kernels:
    self-attention with N == M >= 1024 and N % 512 == 0, the JAX package's
    rule (``encdiff_tpu/nn/attention.py:45``), so that each site runs the
    counterpart of the kernel the JAX package runs there."""
    return n == m and n >= 1024 and n % 512 == 0


def attention(q, k, v, scale: float):
    """softmax(q kᵀ·scale) v on (B, H, N, dh) tensors, through the flash
    kernels where ``takes_flash``, else through ``attention_core``."""
    if takes_flash(q.shape[2], k.shape[2]):
        return flash_attention(q, k, v, scale)
    return attention_core(q, k, v, scale)


class CrossAttention(nn.Module):
    """Q from x, K/V from the context (x itself when context is None)."""

    def __init__(self, query_dim: int, context_dim: int | None = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        h, dh = self.heads, self.dim_head
        q = self.to_q(x).view(b, n, h, dh).transpose(1, 2)
        k = self.to_k(context).view(b, m, h, dh).transpose(1, 2)
        v = self.to_v(context).view(b, m, h, dh).transpose(1, 2)
        out = attention(q, k, v, self.scale)
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))


class GEGLU(nn.Module):
    """val * gelu(gate) with the exact (erf) gelu."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        val, gate = self.proj(x).chunk(2, dim=-1)
        return val * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU MLP with 4x expansion."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.geglu = GEGLU(dim, dim * mult)
        self.proj_out = nn.Linear(dim * mult, dim)

    def forward(self, x):
        return self.proj_out(self.geglu(x))


class BasicTransformerBlock(nn.Module):
    """self-attention -> cross-attention -> GEGLU FF, pre-LN residuals."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: int | None = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, None, n_heads, d_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm(eps 1e-6) -> 1x1 proj_in -> (B, HW, C) transformer blocks
    -> 1x1 proj_out + residual, on NCHW."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: int | None = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = TorchConv(in_channels, inner, 1)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                inner, n_heads, d_head, context_dim=context_dim))
        self.proj_out = TorchConv(inner, in_channels, 1)

    def forward(self, x, context=None):
        b, _, hgt, wid = x.shape
        h = self.proj_in(self.norm(x))
        inner = h.shape[1]
        h = h.flatten(2).transpose(1, 2)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context=context)
        # back to contiguous NCHW: a channels-last view here would make
        # cuDNN return channels-last, which the GN-SiLU kernel refuses
        h = h.transpose(1, 2).contiguous().view(b, inner, hgt, wid)
        return self.proj_out(h) + x
