"""VQ encoder and decoder backbones, NCHW.

Counterpart of ``encdiff_tpu/nn/vae.py:24-222``: ResnetBlock (GN-SiLU eps
1e-6 through the ``groupnorm_silu`` kernel), AttnBlock (single head over
all positions through ``nn.attention.attention``: the flash kernel from
1,024 positions on, ``attention_core`` below), the asymmetric-pad Downsample,
Upsample, Encoder and Decoder. The first stage runs frozen, so these run
forward only.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from encdiff_tpu_torch.nn.attention import attention
from encdiff_tpu_torch.nn.layers import GNSiLU, TorchConv, upsample_nearest_2x


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int | None = None):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GNSiLU(in_channels, eps=1e-6)
        self.conv1 = TorchConv(in_channels, out_channels, 3, padding=1)
        self.norm2 = GNSiLU(out_channels, eps=1e-6)
        self.conv2 = TorchConv(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = (TorchConv(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """x + proj_out(attention(q, k, v)) with 1x1-conv q/k/v, one head of
    size C, scale C^-1/2."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.q = TorchConv(channels, channels, 1)
        self.k = TorchConv(channels, channels, 1)
        self.v = TorchConv(channels, channels, 1)
        self.proj_out = TorchConv(channels, channels, 1)

    def forward(self, x):
        b, c, hgt, wid = x.shape
        h = self.norm(x)

        def tokens(conv):  # (B, C, H, W) -> (B, 1, HW, C), rows contiguous
            return conv(h).flatten(2).transpose(1, 2).contiguous()[:, None]

        out = attention(tokens(self.q), tokens(self.k), tokens(self.v),
                        c ** -0.5)
        out = out[:, 0].transpose(1, 2).contiguous().view(b, c, hgt, wid)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """3x3 stride-2 conv after the reference's asymmetric pad: none at the
    top and left, one row and column at the bottom and right."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = TorchConv(channels, channels, 3, stride=2,
                              padding=((0, 1), (0, 1)))

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = TorchConv(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class Encoder(nn.Module):
    """Image (B, in_channels, H, W) -> latent moments (B, z_channels or
    2 * z_channels, H / 2^(L-1), W / 2^(L-1))."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 in_channels: int, resolution: int, z_channels: int,
                 double_z: bool = True, attn_resolutions: Sequence[int] = ()):
        super().__init__()
        del resolution  # shapes follow the input image
        if attn_resolutions:
            raise NotImplementedError(
                "encoder attention outside the mid block is not ported")
        self.num_levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = TorchConv(in_channels, ch, 3, padding=1)
        block_in = ch
        for i_level, mult in enumerate(ch_mult):
            for i_block in range(num_res_blocks):
                self.add_module(f"down_{i_level}_block_{i_block}",
                                ResnetBlock(block_in, ch * mult))
                block_in = ch * mult
            if i_level != self.num_levels - 1:
                self.add_module(f"down_{i_level}_downsample",
                                Downsample(block_in))
        self.mid_block_1 = ResnetBlock(block_in)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in)
        self.norm_out = GNSiLU(block_in, eps=1e-6)
        self.conv_out = TorchConv(block_in, 2 * z_channels if double_z
                                  else z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for i_level in range(self.num_levels):
            for i_block in range(self.num_res_blocks):
                h = getattr(self, f"down_{i_level}_block_{i_block}")(h)
            if i_level != self.num_levels - 1:
                h = getattr(self, f"down_{i_level}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    """Latent (B, z_channels, h, w) -> image (B, out_ch, H, W)."""

    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int],
                 num_res_blocks: int, resolution: int, z_channels: int,
                 attn_resolutions: Sequence[int] = ()):
        super().__init__()
        del resolution  # shapes follow the input latent
        if attn_resolutions:
            raise NotImplementedError(
                "decoder attention outside the mid block is not ported")
        self.num_levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        block_in = ch * ch_mult[-1]
        self.conv_in = TorchConv(z_channels, block_in, 3, padding=1)
        self.mid_block_1 = ResnetBlock(block_in)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in)
        for i_level in reversed(range(self.num_levels)):
            block_out = ch * ch_mult[i_level]
            for i_block in range(num_res_blocks + 1):
                self.add_module(f"up_{i_level}_block_{i_block}",
                                ResnetBlock(block_in, block_out))
                block_in = block_out
            if i_level != 0:
                self.add_module(f"up_{i_level}_upsample", Upsample(block_in))
        self.norm_out = GNSiLU(block_in, eps=1e-6)
        self.conv_out = TorchConv(block_in, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for i_level in reversed(range(self.num_levels)):
            for i_block in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i_level}_block_{i_block}")(h)
            if i_level != 0:
                h = getattr(self, f"up_{i_level}_upsample")(h)
        return self.conv_out(self.norm_out(h))
