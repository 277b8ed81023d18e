"""DDIM sampler as a Python loop over steps.

Counterpart of ``encdiff_tpu/diffusion/ddim.py:26-87`` (``ddim_sample``)
without inpainting masks and x0 quantization, which the serving path does
not use. The update is elementwise, so it runs on any latent layout.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from encdiff_tpu_torch.core.schedules import DDIMSchedule


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
                temperature: float = 1.0):
    """Run S DDIM steps from ``x_T`` (ε-parameterization).

    ``denoise_fn(x, t_batch) -> ε``. Per-step noise (used where σ > 0, i.e.
    eta > 0) is ``noises[i]`` when given, else drawn from ``generator``."""
    img = x_T
    t_b = torch.empty(x_T.shape[0], dtype=torch.long, device=x_T.device)
    for i, (t, sqrt_at, som, sqrt_aprev, c_dir, sig) in enumerate(
            ddim_coefficients(dsched)):
        e_t = denoise_fn(img, t_b.fill_(t)).float()
        pred_x0 = (img - som * e_t) / sqrt_at
        img = sqrt_aprev * pred_x0 + c_dir * e_t
        if sig > 0.0:
            noise = (noises[i] if noises is not None else torch.randn(
                img.shape, generator=generator, device=img.device))
            img = img + sig * noise * temperature
    return img
