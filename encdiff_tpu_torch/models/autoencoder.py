"""The VQ first stage, NCHW, as ``VQModelInterface`` uses it for EncDiff.

Counterpart of ``encdiff_tpu/models/autoencoder.py:86-116,309-317``:
``encode`` is the pre-quant code ``quant_conv(Encoder(x))`` (no
quantization: the LDM diffuses the continuous latent); ``decode``
quantizes, concatenates the disentangled scalars broadcast over the latent
grid (zero-filled when none are given), then runs ``post_quant_conv`` and
the Decoder. The first stage is frozen: neither path is trained.
"""

from __future__ import annotations

import torch
from torch import nn

from encdiff_tpu_torch.nn.layers import TorchConv
from encdiff_tpu_torch.nn.quantize import VectorQuantizer
from encdiff_tpu_torch.nn.vae import Decoder, Encoder


class VQModelInterface(nn.Module):
    """The VQ model; built from the config's ``first_stage_config``
    fields."""

    def __init__(self, embed_dim: int, n_embed: int, ddconfig: dict,
                 use_disentangled_concat: bool = False,
                 disentangled_dim: int = 0):
        super().__init__()
        if ddconfig.get("dropout", 0.0):
            raise ValueError("the VQ decoder is built for inference: dropout 0")
        self.disentangled_dim = disentangled_dim if use_disentangled_concat else 0
        self.resolution = ddconfig["resolution"]  # the decoded image's side
        self.encoder = Encoder(
            ch=ddconfig["ch"], ch_mult=tuple(ddconfig["ch_mult"]),
            num_res_blocks=ddconfig["num_res_blocks"],
            in_channels=ddconfig["in_channels"],
            resolution=ddconfig["resolution"],
            z_channels=ddconfig["z_channels"],
            double_z=ddconfig.get("double_z", False),
            attn_resolutions=tuple(ddconfig.get("attn_resolutions") or ()))
        self.quant_conv = TorchConv(
            2 * ddconfig["z_channels"] if ddconfig.get("double_z", False)
            else ddconfig["z_channels"], embed_dim, 1)
        self.decoder = Decoder(
            ch=ddconfig["ch"], out_ch=ddconfig["out_ch"],
            ch_mult=tuple(ddconfig["ch_mult"]),
            num_res_blocks=ddconfig["num_res_blocks"],
            resolution=ddconfig["resolution"],
            z_channels=ddconfig["z_channels"],
            attn_resolutions=tuple(ddconfig.get("attn_resolutions") or ()))
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.post_quant_conv = TorchConv(embed_dim + self.disentangled_dim,
                                         ddconfig["z_channels"], 1)

    def encode(self, x):
        """x: (B, in_channels, H, W) in [-1, 1] -> the pre-quant latent
        (B, embed_dim, H / 4, W / 4) of ``VQModelInterface.encode``."""
        return self.quant_conv(self.encoder(x))

    def decode(self, h, force_not_quantize: bool = False,
               disentangled_repr=None):
        """h: (B, embed_dim, H, W) latent -> (B, out_ch, 4H, 4W) image."""
        quant = h if force_not_quantize else self.quantize(h)[0]
        if self.disentangled_dim:
            b, _, hh, ww = quant.shape
            if disentangled_repr is None:
                s = quant.new_zeros(b, self.disentangled_dim, hh, ww)
            else:
                s = disentangled_repr[:, :, None, None].to(quant.dtype).expand(
                    b, -1, hh, ww)
            quant = torch.cat([quant, s], dim=1)
        return self.decoder(self.post_quant_conv(quant))
