"""Cross-attention stack of the UNet, NCHW at its edges.

Counterpart of ``encdiff_tpu/nn/attention.py:28-191``. ``attention``
routes as the JAX ``attention`` does: large self-attention to the flash
kernels, everything else to the ``attention_core`` kernel.

``CrossAttention.forward`` takes the ``fused_attention`` kernel (the
projections, the per-head softmax and the output projection in one launch)
when both hold:

- a ``context`` is given (cross-attention: the queries attend to the
  concept tokens);
- autograd will not need a gradient: grad mode is off, or neither the
  inputs nor the module's weights require grad.

Every other call projects in PyTorch and runs ``attention``. So serving
(``swap_sample``, ``sample_ddim``, the FID sampler, all under
``torch.no_grad``) runs ``fused_attention`` at every cross-attention site,
and the train step keeps ``attention_core`` and its backward there. Inside
``plain_path()`` the route reaches ``fused_attention_plain``. This departs
from the JAX routing only in which implementation computes the same
function: the JAX package runs XLA's projections around ``attention_core``
there (``encdiff_tpu/nn/pallas/__init__.py:28-36``).

Attention-map capture (``capture=True``, passed to each block's
cross-attention ``attn2`` only, as the JAX ``BasicTransformerBlock`` passes
it) returns the per-head probabilities (B, heads, N, M) beside the output.
It takes the route the JAX capture forces (``encdiff_tpu/nn/attention.py:
56-60, 92-97``), the one site where the JAX package runs no Pallas kernel:
the projections, the scores, an fp32 softmax and the value product in
PyTorch ops, and no kernel of the port. The maps come back under the JAX
collection's names, the flax path joined by ``/``
(``down_1_0_attn/block_0/attn2/attn``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from encdiff_tpu_torch.nn.kernels.attention import attention_core
from encdiff_tpu_torch.nn.kernels.flash_attention import flash_attention
from encdiff_tpu_torch.nn.kernels.fused_attention import fused_attention
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

    def takes_fused(self, x, context) -> bool:
        """Whether this call runs the ``fused_attention`` kernel: a context
        is given and autograd will not need a gradient."""
        if context is None:
            return False
        return not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, context, *self.parameters())))

    def forward(self, x, context=None, capture: bool = False):
        """The attention's output; with ``capture`` (output, probabilities
        (B, heads, N, M))."""
        if capture:
            return self._captured(x, context)
        if self.takes_fused(x, context):
            # no gradient is needed here, so every argument goes in detached
            # (a parameter's view still reports requires_grad under no_grad)
            return fused_attention(
                x.detach(), context.detach(), self.to_q.weight.detach().t(),
                self.to_k.weight.detach().t(), self.to_v.weight.detach().t(),
                self.to_out.weight.detach().t(), self.to_out.bias.detach(),
                heads=self.heads, dim_head=self.dim_head)
        return self._out(attention(*self._project(x, context), self.scale))

    def _project(self, x, context):
        """q (B, H, N, dh) from x; k and v (B, H, M, dh) from the context
        (x itself when None)."""
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        h, dh = self.heads, self.dim_head
        return (self.to_q(x).view(b, n, h, dh).transpose(1, 2),
                self.to_k(context).view(b, m, h, dh).transpose(1, 2),
                self.to_v(context).view(b, m, h, dh).transpose(1, 2))

    def _out(self, out):
        """The heads (B, H, N, dh) merged and projected out."""
        b, h, n, dh = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))

    def _captured(self, x, context):
        """The JAX capture route: einsum, fp32 softmax, einsum, in PyTorch
        ops."""
        q, k, v = self._project(x, context)
        sim = torch.einsum("bhid,bhjd->bhij", q, k) * self.scale
        attn = torch.softmax(sim.float(), dim=-1)
        return self._out(torch.einsum("bhij,bhjd->bhid", attn, v)), attn


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

    def forward(self, x, context=None, capture: bool = False):
        """The block's output; with ``capture`` (output, {"attn2/attn":
        attn2's probabilities})."""
        x = self.attn1(self.norm1(x)) + x
        if capture:
            h, attn = self.attn2(self.norm2(x), context=context, capture=True)
        else:
            h = self.attn2(self.norm2(x), context=context)
        x = h + x
        x = self.ff(self.norm3(x)) + x
        return (x, {"attn2/attn": attn}) if capture else x


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

    def forward(self, x, context=None, capture: bool = False):
        """The layer's output; with ``capture`` (output, maps by
        ``block_i/attn2/attn``)."""
        b, _, hgt, wid = x.shape
        h = self.proj_in(self.norm(x))
        inner = h.shape[1]
        h = h.flatten(2).transpose(1, 2)
        maps = {}
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            if capture:
                h, block_maps = block(h, context=context, capture=True)
                maps.update({f"block_{i}/{k}": v
                             for k, v in block_maps.items()})
            else:
                h = block(h, context=context)
        # back to contiguous NCHW: a channels-last view here would make
        # cuDNN return channels-last, which the GN-SiLU kernel refuses
        h = h.transpose(1, 2).contiguous().view(b, inner, hgt, wid)
        out = self.proj_out(h) + x
        return (out, maps) if capture else out
