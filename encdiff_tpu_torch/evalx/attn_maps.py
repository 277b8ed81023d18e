"""Cross-attention maps: each concept token's share of every spatial query.

Counterpart of ``encdiff_tpu/evalx/attn_maps.py:25-123``
(``extract_attention_maps``, ``cross_attention_maps_for_images``,
``ddim_sample_with_attn``). One UNet call with capture returns the
probabilities of every cross-attention site as {path: (B, heads, HW, M)},
keyed as the JAX ``attn_maps`` collection (``down_1_0_attn/block_0/attn2/
attn``); the cross-attention maps are those whose M is ``latent_unit``.
Captured calls run attn2 in PyTorch ops, as the JAX capture runs it in
XLA's (``nn.attention``).
"""

from __future__ import annotations

import numpy as np
import torch

from encdiff_tpu_torch.core import ema as ema_lib
from encdiff_tpu_torch.core.schedules import DDIMSchedule
from encdiff_tpu_torch.diffusion.ddim import ddim_sample
from encdiff_tpu_torch.diffusion.ddpm import q_sample


def _cross(model, maps: dict) -> dict:
    """The maps whose keys are the ``latent_unit`` concept tokens."""
    return {k: v for k, v in maps.items() if v.shape[-1] == model.latent_unit}


@torch.no_grad()
def extract_attention_maps(model, x, t, tokens, ema=None) -> dict:
    """One denoiser call with capture: {path: probabilities (B, heads,
    N, M)} for x (B, h, w, C) noisy latents, t (B,) and flat tokens
    (B, U*D)."""
    with ema_lib.maybe_applied(ema, model.unet):
        return model.apply_model(x, t, tokens, capture_attn=True)[1]


@torch.no_grad()
def cross_attention_maps_for_images(model, images, t_value: int = 500,
                                    noise=None,
                                    generator: torch.Generator | None = None):
    """Images (B, S, S, 3), uint8 or floats in [-1, 1] -> (cross-attention
    maps, flat tokens, scalars u): the images' tokens, their latents noised
    to ``t_value`` with ``noise`` (B, h, w, C) or a draw from ``generator``
    (seed 0 by default), one captured call."""
    x = torch.as_tensor(np.asarray(images), device=model.device)
    x = x.float() / 127.5 - 1.0 if not x.dtype.is_floating_point else x.float()
    u = model.cond_encoding(x)
    tokens = model.cond_warp(u)
    z = model.encode_first_stage(x) * model.scale_factor
    b = z.shape[0]
    t = torch.full((b,), t_value, dtype=torch.long, device=model.device)
    if noise is None:
        if generator is None:
            generator = torch.Generator(model.device).manual_seed(0)
        noise = torch.randn(z.shape, generator=generator, device=model.device)
    z_noisy = q_sample(model.tables, z, t, model._tensor(noise))
    maps = extract_attention_maps(model, z_noisy, t, tokens)
    return _cross(model, maps), tokens, u


@torch.no_grad()
def ddim_sample_with_attn(model, tokens, ddim_steps: int = 50,
                          eta: float = 0.0, capture_every: int = 10,
                          ema=None, x_T=None, noises=None,
                          generator: torch.Generator | None = None):
    """DDIM from flat tokens (B, U*D) that captures the cross-attention maps
    before every ``capture_every``-th step, with a captured call of its own
    beside the step's. ``x_T`` (B, h, w, C) and the per-step ``noises``
    (S, B, h, w, C) may be injected; otherwise they are drawn from
    ``generator``. Returns (latents (B, h, w, C), {timestep: {path: numpy
    maps}})."""
    tokens = model._tensor(tokens)
    dsched = DDIMSchedule.create(model.schedule, ddim_steps, eta=eta)
    timesteps = iter(enumerate(int(t) for t in dsched.timesteps[::-1]))
    denoise = model.make_denoiser(tokens)
    collected = {}

    def capturing(x, t_b):
        i, t = next(timesteps)
        if i % capture_every == 0:
            maps = model.unet(x, t_b, tokens, capture=True)[1]
            collected[t] = {k: v.cpu().numpy()
                            for k, v in _cross(model, maps).items()}
        return denoise(x, t_b)

    x_T = model._x_T(tokens.shape[0], x_T, generator)
    if noises is not None:
        noises = [model._tensor(n).permute(0, 3, 1, 2).contiguous()
                  for n in noises]
    with ema_lib.maybe_applied(ema, model.unet):
        img = ddim_sample(dsched, capturing,
                          x_T.permute(0, 3, 1, 2).contiguous(),
                          noises=noises, generator=generator)
    return img.permute(0, 2, 3, 1).contiguous(), collected
