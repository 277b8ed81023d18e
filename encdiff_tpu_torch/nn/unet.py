"""The EncDiff denoiser ε_θ(x_t, t, concept tokens), NCHW.

Counterpart of ``encdiff_tpu/nn/unet.py:35-247`` for the configuration the
EncDiff configs use: FiLM ResBlocks (``use_scale_shift_norm``), ResBlock
up/down-sampling (``resblock_updown``) and SpatialTransformer attention.
Module names follow the flax tree (``down_{level}_{i}_res``, ``mid_attn``,
``up_{level}_us``, ...), so converted checkpoints load by name.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn
import torch

from encdiff_tpu_torch.nn.attention import SpatialTransformer
from encdiff_tpu_torch.nn.layers import (GNSiLU, TorchConv, avg_pool_2x,
                                         nonlinearity, timestep_embedding,
                                         upsample_nearest_2x)


class ResBlock(nn.Module):
    """GN-SiLU -> [resample] -> conv -> FiLM GN-SiLU -> conv, plus skip.
    FiLM: (1 + scale) * GN(h) + shift, scale and shift split from
    ``emb_proj(SiLU(emb))``. Up/down resample both branches."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.in_norm = GNSiLU(channels, eps=1e-5)
        self.in_conv = TorchConv(channels, out_channels, 3, padding=1)
        self.emb_proj = nn.Linear(emb_channels, 2 * out_channels)
        self.out_norm = GNSiLU(out_channels, eps=1e-5)
        self.out_conv = TorchConv(out_channels, out_channels, 3, padding=1)
        self.skip = (TorchConv(channels, out_channels, 1)
                     if out_channels != channels else None)

    def forward(self, x, emb):
        h = self.in_norm(x)
        if self.up:
            h, x = upsample_nearest_2x(h), upsample_nearest_2x(x)
        elif self.down:
            h, x = avg_pool_2x(h), avg_pool_2x(x)
        h = self.in_conv(h)
        scale, shift = self.emb_proj(nonlinearity(emb)).chunk(2, dim=1)
        h = self.out_norm(h, scale.contiguous(), shift.contiguous())
        h = self.out_conv(h)
        return (x if self.skip is None else self.skip(x)) + h


class UNetModel(nn.Module):
    """ε-prediction UNet; ``forward(x, timesteps, context)`` with x
    (B, C, H, W), timesteps (B,) and context (B, U*D) flat tokens or
    (B, U, D)."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 num_heads: int = 8, num_head_channels: int = -1,
                 context_dim: int = 16, latent_unit: int = 20,
                 transformer_depth: int = 1,
                 use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True,
                 use_spatial_transformer: bool = True):
        super().__init__()
        if not (use_scale_shift_norm and resblock_updown
                and use_spatial_transformer):
            raise NotImplementedError(
                "the port builds the FiLM / resblock_updown / spatial "
                "transformer UNet of the EncDiff configs only")
        del image_size, latent_unit  # shapes follow the inputs
        self.model_channels = model_channels
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.context_dim = context_dim
        mc, emb_ch = model_channels, model_channels * 4

        def heads(ch):
            if num_head_channels == -1:
                return num_heads, ch // num_heads
            return ch // num_head_channels, num_head_channels

        def attn(ch):
            return SpatialTransformer(ch, *heads(ch), depth=transformer_depth,
                                      context_dim=context_dim)

        self.time_embed_0 = nn.Linear(mc, emb_ch)
        self.time_embed_2 = nn.Linear(emb_ch, emb_ch)
        self.conv_in = TorchConv(in_channels, mc, 3, padding=1)
        ch, ds, skips = mc, 1, [mc]
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_{i}_res",
                                ResBlock(ch, emb_ch, mult * mc))
                ch = mult * mc
                if ds in self.attention_resolutions:
                    self.add_module(f"down_{level}_{i}_attn", attn(ch))
                skips.append(ch)
            if level != len(self.channel_mult) - 1:
                self.add_module(f"down_{level}_ds",
                                ResBlock(ch, emb_ch, ch, down=True))
                skips.append(ch)
                ds *= 2
        self.mid_res1 = ResBlock(ch, emb_ch, ch)
        self.mid_attn = attn(ch)
        self.mid_res2 = ResBlock(ch, emb_ch, ch)
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_{i}_res",
                                ResBlock(ch + skips.pop(), emb_ch, mc * mult))
                ch = mc * mult
                if ds in self.attention_resolutions:
                    self.add_module(f"up_{level}_{i}_attn", attn(ch))
                if level and i == num_res_blocks:
                    self.add_module(f"up_{level}_us",
                                    ResBlock(ch, emb_ch, ch, up=True))
                    ds //= 2
        self.out_norm = GNSiLU(ch, eps=1e-5)
        self.out_conv = TorchConv(ch, out_channels, 3, padding=1)

    def forward(self, x, timesteps, context):
        b = x.shape[0]
        if context.dim() == 2:
            context = context.reshape(b, -1, self.context_dim)
        emb = self.time_embed_0(timestep_embedding(timesteps,
                                                   self.model_channels))
        emb = self.time_embed_2(nonlinearity(emb))

        def block(name, h):
            return getattr(self, name)(h, emb)

        def maybe_attn(name, h):
            return getattr(self, name)(h, context) if hasattr(self, name) else h

        h = self.conv_in(x)
        hs = [h]
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = block(f"down_{level}_{i}_res", h)
                h = maybe_attn(f"down_{level}_{i}_attn", h)
                hs.append(h)
            if level != len(self.channel_mult) - 1:
                h = block(f"down_{level}_ds", h)
                hs.append(h)
        h = self.mid_res2(self.mid_attn(self.mid_res1(h, emb), context), emb)
        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = block(f"up_{level}_{i}_res", torch.cat([h, hs.pop()], 1))
                h = maybe_attn(f"up_{level}_{i}_attn", h)
                if level and i == self.num_res_blocks:
                    h = block(f"up_{level}_us", h)
        return self.out_conv(self.out_norm(h))
