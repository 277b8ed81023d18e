"""The VQ first stage, NCHW: ``VQModel``, trained by the VQ-GAN trainer, and
``VQModelInterface``, the frozen first stage of EncDiff.

Counterpart of ``encdiff_tpu/models/autoencoder.py:44-127,182-317``.
``VQModel`` is Encoder -> quant_conv -> VectorQuantizer -> [concat u] ->
post_quant_conv -> Decoder, with the reference constructor's ``lossconfig``
(the ``VQLPIPSWithDiscriminator`` it trains against, held as ``loss``),
``lr_g_factor``, ``monitor`` and ``use_disentangled_concat``; its forward
gives (reconstruction, codebook loss, code indices).
``VQModelInterface`` encodes without quantizing (the LDM diffuses the
continuous pre-quant latent); its ``decode`` quantizes, concatenates the
disentangled scalars broadcast over the latent grid (zero-filled when none
are given), then runs ``post_quant_conv`` and the Decoder. Its
``ckpt_path`` names a trained first stage, which ``load_ckpt_path`` loads
over the seeded fresh init (``load_generator``: the JAX ``init_variables``
with ``load_reference_checkpoint``, :230-291); ``LatentDiffusion``'s
``init_parameters`` calls it after its draws.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from encdiff_tpu_torch import convert
from encdiff_tpu_torch.core.compact_ckpt import load_compact
from encdiff_tpu_torch.core.config import instantiate_from_config
from encdiff_tpu_torch.nn.encoder4 import BatchNorm
from encdiff_tpu_torch.nn.layers import GNSiLU, TorchConv
from encdiff_tpu_torch.nn.quantize import VectorQuantizer
from encdiff_tpu_torch.nn.vae import Decoder, Encoder
from encdiff_tpu_torch.train.checkpoint_io import STATE_FILE

#: the generator's submodules: what the generator's optimizer trains
GENERATOR = ("encoder", "quant_conv", "quantize", "post_quant_conv",
             "decoder")


@torch.no_grad()
def init_fresh(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX ``init_variables`` laws over ``module``'s own submodules,
    drawn from ``generator`` in module order: convolutions U(±1/√fan_in)
    for weight and bias (``encdiff_tpu/nn/layers.py:56``), the codebook
    U(±1/n_embed), norms at ones and zeros, BatchNorm statistics at 0 and
    1. Raises on a parameter no rule covers."""
    def uniform(t, bound):
        t.uniform_(-bound, bound, generator=generator)

    done = set()
    for m in module.modules():
        own = list(m.parameters(recurse=False))
        if isinstance(m, nn.Conv2d):
            for t in own:
                uniform(t, m.weight[0].numel() ** -0.5)
        elif isinstance(m, (GNSiLU, nn.GroupNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        elif isinstance(m, VectorQuantizer):
            uniform(m.embedding, 1.0 / m.embedding.shape[0])
        elif own:
            raise TypeError(f"no init rule for {type(m).__name__}")
        done.update(id(t) for t in own)
    missing = {id(t) for t in module.parameters()} - done
    if missing:
        raise TypeError(f"{len(missing)} parameters have no init rule")


class VQModel(nn.Module):
    """The VQ model of a ``first_stage_config`` or a VQ-GAN config's
    ``model.params``. Built in train mode; the harness moves it to its
    device."""

    def __init__(self, ddconfig: dict, lossconfig: dict | None = None,
                 n_embed: int = 2048, embed_dim: int = 3, monitor=None,
                 lr_g_factor: float = 1.0,
                 use_disentangled_concat: bool = False,
                 disentangled_dim: int = 0):
        super().__init__()
        if ddconfig.get("dropout", 0.0):
            raise ValueError("dropout is not ported: the configs train at 0")
        self.ddconfig = dict(ddconfig)
        self.n_embed = n_embed
        self.embed_dim = embed_dim
        self.monitor = monitor
        self.lr_g_factor = lr_g_factor
        self.disentangled_dim = disentangled_dim if use_disentangled_concat else 0
        self.resolution = ddconfig["resolution"]  # the decoded image's side
        attn = tuple(ddconfig.get("attn_resolutions") or ())
        double_z = ddconfig.get("double_z", False)
        self.encoder = Encoder(
            ch=ddconfig["ch"], ch_mult=tuple(ddconfig["ch_mult"]),
            num_res_blocks=ddconfig["num_res_blocks"],
            in_channels=ddconfig["in_channels"],
            resolution=ddconfig["resolution"],
            z_channels=ddconfig["z_channels"], double_z=double_z,
            attn_resolutions=attn)
        self.quant_conv = TorchConv(
            2 * ddconfig["z_channels"] if double_z else ddconfig["z_channels"],
            embed_dim, 1)
        self.decoder = Decoder(
            ch=ddconfig["ch"], out_ch=ddconfig["out_ch"],
            ch_mult=tuple(ddconfig["ch_mult"]),
            num_res_blocks=ddconfig["num_res_blocks"],
            resolution=ddconfig["resolution"],
            z_channels=ddconfig["z_channels"], attn_resolutions=attn)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.post_quant_conv = TorchConv(embed_dim + self.disentangled_dim,
                                         ddconfig["z_channels"], 1)
        self.loss = (instantiate_from_config(lossconfig)
                     if lossconfig is not None else None)

    def generator_parameters(self) -> dict:
        """name -> parameter of the generator (``gen_params`` in the JAX
        package): everything but ``loss``."""
        return {f"{name}.{k}": p for name in GENERATOR
                for k, p in getattr(self, name).named_parameters()}

    def init_parameters(self, generator: torch.Generator) -> None:
        """A seeded fresh init of the generator and then of the
        discriminator (``init_fresh``). LPIPS keeps its own fixed trunk."""
        for name in GENERATOR:
            init_fresh(getattr(self, name), generator)
        if self.loss is not None:
            init_fresh(self.loss.discriminator, generator)

    @torch.no_grad()
    def load_vq_state(self, sds: dict) -> None:
        """Load ``convert.vq_state_dicts``' generator, discriminator (params
        and batch statistics) and, if given, LPIPS state dicts."""
        sd = dict(sds["generator"])
        parts = [("discriminator", "loss.discriminator.")]
        if "lpips" in sds:
            parts.append(("lpips", "loss.lpips."))
        for key, prefix in parts:
            sd.update({prefix + k: v for k, v in sds[key].items()})
        missing, unexpected = self.load_state_dict(sd, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")
                   and not (k.startswith("loss.lpips.") and "lpips" not in sds)]
        if missing or unexpected:
            raise KeyError(f"VQ state: missing {missing}, unexpected "
                           f"{unexpected}")

    def get_last_layer(self):
        """The kernel the adaptive GAN weight differentiates against."""
        return self.decoder.conv_out.weight

    def encode_pre_quant(self, x):
        """x: (B, in_channels, H, W) in [-1, 1] -> the pre-quant latent
        (B, embed_dim, H / 4, W / 4)."""
        return self.quant_conv(self.encoder(x))

    def encode(self, x):
        """(z_q, codebook loss, (perplexity, None, indices))."""
        return self.quantize(self.encode_pre_quant(x))

    def _concat_and_decode(self, quant, disentangled_repr):
        if self.disentangled_dim:
            b, _, hh, ww = quant.shape
            if disentangled_repr is None:
                s = quant.new_zeros(b, self.disentangled_dim, hh, ww)
            else:
                s = disentangled_repr[:, :, None, None].to(quant.dtype).expand(
                    b, -1, hh, ww)
            quant = torch.cat([quant, s], dim=1)
        return self.decoder(self.post_quant_conv(quant))

    def decode(self, h, force_not_quantize: bool = False,
               disentangled_repr=None):
        """h: (B, embed_dim, H, W) latent -> (B, out_ch, 4H, 4W) image."""
        quant = h if force_not_quantize else self.quantize(h)[0]
        return self._concat_and_decode(quant, disentangled_repr)

    def forward(self, x, disentangled_repr=None):
        """(reconstruction, codebook loss, indices (B, h, w))."""
        quant, qloss, (_, _, indices) = self.encode(x)
        return self._concat_and_decode(quant, disentangled_repr), qloss, indices

    def reconstruct(self, x, disentangled_repr=None):
        return self(x, disentangled_repr)[0]


def generator_state(path: str) -> dict[str, torch.Tensor]:
    """The VQ generator's state dict (``GENERATOR`` leaves) of a trained
    first stage: a compact ``.npz`` (``state/gen_params``: a VQ-GAN run's
    ``compact_last.npz``, the JAX package's ``v4vq_fp16.npz``) or a VQ-GAN
    checkpoint directory of the port (``<path>/train_state.pt``, whose
    ``model`` entry ``train.harness`` writes as the fp32 state dict). A
    Lightning ``.ckpt`` raises ``NotImplementedError``."""
    if path.endswith(".ckpt"):
        raise NotImplementedError(
            f"{path}: importing a Lightning .ckpt first stage "
            "(core/checkpoints.load_torch_vq_checkpoint) is not ported "
            "(ROADMAP queue 1 #15)")
    if os.path.isdir(path):
        saved = torch.load(os.path.join(path, STATE_FILE),
                           map_location="cpu", weights_only=True)["model"]
        return {k: v for k, v in saved.items()
                if k.split(".", 1)[0] in GENERATOR}
    if path.endswith(".npz"):
        tree = load_compact(path)
        state = tree.get("state", tree)
        return convert.flax_to_state_dict(state.get("gen_params", state))
    raise ValueError(f"{path}: a first-stage checkpoint is a compact .npz "
                     "or a VQ-GAN checkpoint directory")


class VQModelInterface(VQModel):
    """The VQ model as EncDiff's first stage: ``encode`` does not quantize;
    built from the config's ``first_stage_config`` fields. ``ignore_keys``
    filters only a Lightning ``.ckpt`` in the JAX interface, which is not
    ported; the frozen first stage computes no loss, so ``lossconfig`` may
    only name the configs' ``torch.nn.Identity``; parameters are fp32
    whatever ``dtype`` names."""

    def __init__(self, embed_dim: int, n_embed: int, ddconfig: dict,
                 use_disentangled_concat: bool = False,
                 disentangled_dim: int = 0, ckpt_path: str | None = None,
                 ignore_keys=(), monitor=None, lossconfig=None, dtype=None):
        del ignore_keys, dtype
        if lossconfig is not None and lossconfig.get("target") != \
                "torch.nn.Identity":
            raise NotImplementedError(
                f"first_stage_config.lossconfig {lossconfig.get('target')!r}"
                ": the frozen first stage trains no loss")
        super().__init__(ddconfig, n_embed=n_embed, embed_dim=embed_dim,
                         monitor=monitor,
                         use_disentangled_concat=use_disentangled_concat,
                         disentangled_dim=disentangled_dim)
        self.ckpt_path = ckpt_path

    def load_ckpt_path(self) -> None:
        """Load the generator of ``ckpt_path``, if one is set, over the
        current weights (``load_generator``)."""
        if self.ckpt_path is not None:
            self.load_generator(generator_state(self.ckpt_path))

    @torch.no_grad()
    def load_generator(self, sd: dict) -> None:
        """Copy a trained generator's leaves (``generator_state``) over this
        interface's. Where the interface concatenates the disentangled
        scalars and the checkpoint's ``post_quant_conv`` reads only the
        latent's channels, those input channels are copied and the
        ``disentangled_dim`` others keep their values (the JAX widening of
        :276-283). Raises on any other shape mismatch, and on a leaf
        missing on either side."""
        own = self.state_dict()
        missing = sorted(set(own) - set(sd))
        unexpected = sorted(set(sd) - set(own))
        if missing or unexpected:
            raise KeyError(f"first-stage checkpoint: missing {missing[:4]}, "
                           f"unexpected {unexpected[:4]}")
        for k, v in sd.items():
            dst = own[k]
            if dst.shape == v.shape:
                dst.copy_(v)
            elif (k == "post_quant_conv.weight" and self.disentangled_dim
                  and v.dim() == 4 and dst.shape[0] == v.shape[0]
                  and dst.shape[2:] == v.shape[2:]
                  and dst.shape[1] == v.shape[1] + self.disentangled_dim):
                dst[:, :v.shape[1]] = v
            else:
                raise ValueError(f"first-stage checkpoint: shape mismatch "
                                 f"at {k}: {tuple(v.shape)} vs "
                                 f"{tuple(dst.shape)}")

    def encode(self, x):
        """x: (B, in_channels, H, W) in [-1, 1] -> the pre-quant latent
        (B, embed_dim, H / 4, W / 4) of ``VQModelInterface.encode``."""
        return self.encode_pre_quant(x)
