"""VQ decoder backbone, NCHW.

Counterpart of the decoding half of ``encdiff_tpu/nn/vae.py:24-222``:
ResnetBlock (GN-SiLU eps 1e-6 through the ``groupnorm_silu`` kernel),
AttnBlock (single head over all positions through ``attention_core``),
Upsample and Decoder. The VQ Encoder and its asymmetric-pad Downsample are
not on the serving path and are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from encdiff_tpu_torch.nn.kernels.attention import attention_core
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

        out = attention_core(tokens(self.q), tokens(self.k), tokens(self.v),
                             c ** -0.5)
        out = out[:, 0].transpose(1, 2).contiguous().view(b, c, hgt, wid)
        return x + self.proj_out(out)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = TorchConv(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


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
