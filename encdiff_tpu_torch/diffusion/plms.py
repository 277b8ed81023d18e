"""PLMS (pseudo linear multistep) sampling as a Python loop.

Counterpart of ``encdiff_tpu/diffusion/plms.py:20-80`` (``plms_sample``):
the Adams-Bashforth combinations of the newest ε and up to three earlier
ones, where the JAX package carries a fixed-size history through one
``lax.scan`` and picks the order with ``lax.switch``. The first step makes
a second denoiser call at the next timestep (0 after the last).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from encdiff_tpu_torch.core.schedules import DDIMSchedule


@torch.no_grad()
def plms_sample(dsched: DDIMSchedule, denoise_fn: Callable, x_T,
                temperature: float = 1.0):
    """S deterministic PLMS steps from ``x_T`` (ε-parameterization);
    ``denoise_fn(x, t_batch) -> ε``. ``temperature`` is ignored, as the JAX
    sampler ignores it."""
    del temperature
    f32 = np.float32
    steps = [int(t) for t in dsched.timesteps[::-1]]
    steps_next = steps[1:] + [0]
    coefs = []
    for i in reversed(range(dsched.num_steps)):
        at, aprev = f32(dsched.alphas[i]), f32(dsched.alphas_prev[i])
        coefs.append((float(np.sqrt(at)),
                      float(f32(dsched.sqrt_one_minus_alphas[i])),
                      float(np.sqrt(aprev)),
                      float(np.sqrt(np.maximum(f32(1.0) - aprev, f32(0.0))))))

    def x_prev_from(e_t, img, sqrt_at, som, sqrt_aprev, c_dir):
        pred_x0 = (img - som * e_t) / sqrt_at
        return sqrt_aprev * pred_x0 + c_dir * e_t

    img = x_T
    b = x_T.shape[0]
    old_eps = []  # newest first, at most 3
    for t, t_next, coef in zip(steps, steps_next, coefs):
        t_b = torch.full((b,), t, dtype=torch.long, device=img.device)
        e_t = denoise_fn(img, t_b).float()
        if not old_eps:
            x_prev = x_prev_from(e_t, img, *coef)
            e_next = denoise_fn(x_prev, torch.full_like(t_b, t_next)).float()
            e_prime = (e_t + e_next) / 2
        elif len(old_eps) == 1:
            e_prime = (3 * e_t - old_eps[0]) / 2
        elif len(old_eps) == 2:
            e_prime = (23 * e_t - 16 * old_eps[0] + 5 * old_eps[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * old_eps[0] + 37 * old_eps[1]
                       - 9 * old_eps[2]) / 24
        img = x_prev_from(e_prime, img, *coef)
        old_eps = [e_t] + old_eps[:2]
    return img
