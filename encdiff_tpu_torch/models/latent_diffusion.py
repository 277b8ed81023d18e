"""LatentDiffusion for inference: the EncDiff model behind the serving path.

Counterpart of the inference half of ``encdiff_tpu/models/latent_diffusion.py``
(``apply_model``, ``cond_encoding``, ``cond_warp``, ``decode_first_stage``,
``sample_ddim``). Public methods take and return the JAX package's NHWC
layout for images and latents; the modules inside run NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from encdiff_tpu_torch import convert
from encdiff_tpu_torch.configs import FLAGSHIP
from encdiff_tpu_torch.core.compact_ckpt import load_model_variables
from encdiff_tpu_torch.core.device import resolve_device
from encdiff_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule
from encdiff_tpu_torch.diffusion.ddim import ddim_sample
from encdiff_tpu_torch.models.autoencoder import VQModelInterface
from encdiff_tpu_torch.nn.encoder4 import Encoder4
from encdiff_tpu_torch.nn.unet import UNetModel


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


class LatentDiffusion(nn.Module):
    """UNet + Encoder4 + VQ decoder with the flagship's linear schedule.

    ``device`` defaults to CUDA and raises when no CUDA device is present;
    pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, config: dict = FLAGSHIP, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.image_size = config["image_size"]
        self.channels = config["channels"]
        self.unet = UNetModel(**config["unet_config"])
        self.cond_stage_model = Encoder4(**config["cond_stage_config"])
        self.first_stage_model = VQModelInterface(**config["first_stage_config"])
        self.schedule = DiffusionSchedule.create(
            timesteps=config["timesteps"], beta_schedule="linear",
            linear_start=config["linear_start"],
            linear_end=config["linear_end"])
        self.scale_factor = 1.0
        self.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda") -> "LatentDiffusion":
        """The flagship with the weights of a compact ``.npz`` checkpoint."""
        model = cls(FLAGSHIP, device)
        model.load_variables(*load_model_variables(path))
        return model

    def load_variables(self, variables: dict, scale_factor: float) -> None:
        """Load the JAX package's variable tree (nested numpy dicts). The
        UNet takes the EMA params when the tree has them."""
        unet = variables.get("ema") or variables["unet"]["params"]
        self.unet.load_state_dict(convert.flax_to_state_dict(unet))
        cond = variables["cond"]
        self.cond_stage_model.load_state_dict(convert.encoder4_state_dict(
            cond["params"], cond.get("batch_stats") or {}))
        self.first_stage_model.load_state_dict(
            convert.first_stage_state_dict(variables["first_stage"]["params"]))
        self.scale_factor = float(scale_factor)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def apply_model(self, x_noisy, t, cond):
        """ε_θ(x_t, t, tokens): x_noisy (B, H, W, C), t (B,), cond (B, U*D)."""
        t = torch.as_tensor(t, device=self.device).long()
        return _nhwc(self.unet(_nchw(self._tensor(x_noisy)), t,
                               self._tensor(cond)))

    @torch.no_grad()
    def cond_encoding(self, x):
        """Images (B, 64, 64, 3) in [-1, 1] -> (B, latent_unit) scalars."""
        return self.cond_stage_model.encoding(_nchw(self._tensor(x)))

    @torch.no_grad()
    def cond_warp(self, u):
        """(B, latent_unit) scalars -> flat tokens (B, latent_unit * D)."""
        return self.cond_stage_model.warp(self._tensor(u))

    @torch.no_grad()
    def decode_first_stage(self, z, disentangled_repr=None,
                           force_not_quantize: bool = False):
        """Latents (B, h, w, C) -> images (B, 4h, 4w, 3): 1/scale_factor,
        then quantize (unless forced off), then decode."""
        z = _nchw(self._tensor(z)) * (1.0 / self.scale_factor)
        return _nhwc(self.first_stage_model.decode(
            z, force_not_quantize=force_not_quantize,
            disentangled_repr=disentangled_repr))

    @torch.no_grad()
    def sample_ddim(self, tokens, steps: int = 200, eta: float = 0.0,
                    x_T=None, generator: torch.Generator | None = None,
                    noises=None, temperature: float = 1.0):
        """DDIM in latent space conditioned on flat tokens (B, U*D).
        ``x_T`` (B, H, W, C) and the per-step ``noises`` (S, B, H, W, C) may
        be injected; otherwise they are drawn from ``generator``. Returns
        latents (B, H, W, C)."""
        tokens = self._tensor(tokens)
        b = tokens.shape[0]
        if x_T is None:
            x_T = torch.randn(b, self.image_size, self.image_size,
                              self.channels, generator=generator,
                              device=self.device)
        if noises is not None:
            noises = [_nchw(self._tensor(n)) for n in noises]
        dsched = DDIMSchedule.create(self.schedule, steps, eta=eta)
        out = ddim_sample(dsched, lambda x, t: self.unet(x, t, tokens),
                          _nchw(self._tensor(x_T)), noises=noises,
                          generator=generator, temperature=temperature)
        return _nhwc(out)
