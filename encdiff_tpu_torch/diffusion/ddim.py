"""DDIM sampling, inversion and classifier-free guidance as Python loops.

Counterpart of ``encdiff_tpu/diffusion/ddim.py:26-136`` (``ddim_sample``
with its inpainting mask, x0 quantization and intermediates,
``ddim_invert``, ``ddim_sample_cfg``), where the JAX package runs one
``lax.scan``. The updates are elementwise, so they run on any latent
layout the denoiser takes.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from encdiff_tpu_torch.core.schedules import DDIMSchedule
from encdiff_tpu_torch.diffusion.ddpm import q_sample


def ddim_coefficients(dsched: DDIMSchedule) -> list[tuple]:
    """Per step, from the highest noise level down: (t, sqrt(ᾱ_t),
    sqrt(1 - ᾱ_t), sqrt(ᾱ_prev), sqrt(max(1 - ᾱ_prev - σ², 0)), σ), each
    rounded to float32 as the JAX sampler computes them."""
    f32 = np.float32
    out = []
    for i in reversed(range(dsched.num_steps)):
        at, aprev = f32(dsched.alphas[i]), f32(dsched.alphas_prev[i])
        sig = f32(dsched.sigmas[i])
        c_dir = np.sqrt(np.maximum(f32(1.0) - aprev - sig * sig, f32(0.0)))
        out.append((int(dsched.timesteps[i]), float(np.sqrt(at)),
                    float(f32(dsched.sqrt_one_minus_alphas[i])),
                    float(np.sqrt(aprev)), float(c_dir), float(sig)))
    return out


@torch.no_grad()
def ddim_sample(dsched: DDIMSchedule, denoise_fn: Callable, x_T,
                noises: Sequence | None = None,
                generator: torch.Generator | None = None,
                temperature: float = 1.0,
                quantize_fn: Callable | None = None,
                mask=None, x0=None, tables: dict | None = None,
                q_noises: Sequence | None = None,
                log_every: int | None = None):
    """Run S DDIM steps from ``x_T`` (ε-parameterization).

    ``denoise_fn(x, t_batch) -> ε``. Per-step noise (used where σ > 0, i.e.
    eta > 0) is ``noises[i]`` when given, else drawn from ``generator``.

    - ``mask`` / ``x0``: before each step the sample becomes
      ``q_sample(x0, t) * mask + (1 - mask) * sample``, the forward noising
      from ``tables`` (``ddpm.schedule_tables``) with ``q_noises[i]`` when
      given, else a draw from ``generator`` made before the step's own.
    - ``quantize_fn`` maps each step's predicted x0.
    - ``log_every``: also return the sample and the predicted x0 after
      steps 0, log_every, 2 log_every, ..., stacked: (img, (imgs, x0s)).
    """
    img = x_T
    t_b = torch.empty(x_T.shape[0], dtype=torch.long, device=x_T.device)
    imgs, x0s = [], []
    for i, (t, sqrt_at, som, sqrt_aprev, c_dir, sig) in enumerate(
            ddim_coefficients(dsched)):
        t_b.fill_(t)
        if mask is not None:
            q_noise = (q_noises[i] if q_noises is not None else torch.randn(
                img.shape, generator=generator, device=img.device))
            img_orig = q_sample(tables, x0, t_b, q_noise)
            img = img_orig * mask + (1.0 - mask) * img
        e_t = denoise_fn(img, t_b).float()
        pred_x0 = (img - som * e_t) / sqrt_at
        if quantize_fn is not None:
            pred_x0 = quantize_fn(pred_x0)
        img = sqrt_aprev * pred_x0 + c_dir * e_t
        if sig > 0.0:
            noise = (noises[i] if noises is not None else torch.randn(
                img.shape, generator=generator, device=img.device))
            img = img + sig * noise * temperature
        if log_every and i % log_every == 0:
            imgs.append(img)
            x0s.append(pred_x0)
    if log_every:
        return img, (torch.stack(imgs), torch.stack(x0s))
    return img


@torch.no_grad()
def ddim_invert(dsched: DDIMSchedule, denoise_fn: Callable, x0):
    """Deterministic DDIM inversion x_0 -> x_T: the update run from the
    lowest noise level up, on the ᾱ_next tables."""
    f32 = np.float32
    img = x0.float()
    t_b = torch.empty(x0.shape[0], dtype=torch.long, device=x0.device)
    for i in range(dsched.num_steps):
        at, anext = f32(dsched.alphas[i]), f32(dsched.alphas_next[i])
        e_t = denoise_fn(img, t_b.fill_(int(dsched.timesteps[i]))).float()
        pred_x0 = (img - float(np.sqrt(f32(1.0) - at)) * e_t) / float(
            np.sqrt(at))
        img = (float(np.sqrt(anext)) * pred_x0
               + float(np.sqrt(f32(1.0) - anext)) * e_t)
    return img


def ddim_sample_cfg(dsched: DDIMSchedule, denoise_fn: Callable, cond, uncond,
                    guidance_scale: float, x_T, **kwargs):
    """Classifier-free-guided DDIM: each step runs the unconditional and the
    conditional batch through one call of ``denoise_fn(x, t, cond)`` and
    takes ε_uc + guidance_scale (ε_c - ε_uc). ``kwargs`` go to
    ``ddim_sample``."""

    def guided(x, t_b):
        e = denoise_fn(torch.cat([x, x]), torch.cat([t_b, t_b]),
                       torch.cat([uncond, cond]))
        e_uc, e_c = e.chunk(2)
        return e_uc + guidance_scale * (e_c - e_uc)

    return ddim_sample(dsched, guided, x_T, **kwargs)
