"""The VQ first stage's decoding path, NCHW.

Counterpart of ``encdiff_tpu/models/autoencoder.py:96-116``
(``VQVAE._concat_and_decode``, ``VQVAE.decode``) as ``VQModelInterface``
uses it for EncDiff: quantize, concatenate the disentangled scalars
broadcast over the latent grid (zero-filled when none are given), then
``post_quant_conv`` and the Decoder.
"""

from __future__ import annotations

import torch
from torch import nn

from encdiff_tpu_torch.nn.layers import TorchConv
from encdiff_tpu_torch.nn.quantize import VectorQuantizer
from encdiff_tpu_torch.nn.vae import Decoder


class VQModelInterface(nn.Module):
    """Decode side of the VQ model; built from the config's
    ``first_stage_config`` fields."""

    def __init__(self, embed_dim: int, n_embed: int, ddconfig: dict,
                 use_disentangled_concat: bool = False,
                 disentangled_dim: int = 0):
        super().__init__()
        if ddconfig.get("dropout", 0.0):
            raise ValueError("the VQ decoder is built for inference: dropout 0")
        self.disentangled_dim = disentangled_dim if use_disentangled_concat else 0
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
