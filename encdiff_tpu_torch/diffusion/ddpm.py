"""DDPM math: forward noising, posteriors, ancestral sampling and the loss.

Counterpart of ``encdiff_tpu/diffusion/ddpm.py:22-162`` (``extract``,
``q_sample``, ``predict_start_from_noise``, ``q_posterior``,
``p_mean_variance``, ``p_sample_loop``, ``simple_loss``, ``ddpm_losses``)
at the flagship's settings: ε target, L1 loss, simple-loss weight 1, vlb
weight 0. Per-timestep coefficients are gathers into the schedule's tables,
held as float32 tensors on the device (``schedule_tables``), as the JAX
package gathers from float32 arrays. The ancestral loop is a Python loop
over the timesteps where the JAX package runs one ``lax.scan``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from encdiff_tpu_torch.core.schedules import DiffusionSchedule

_TABLES = ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
           "lvlb_weights", "sqrt_recip_alphas_cumprod",
           "sqrt_recipm1_alphas_cumprod", "posterior_variance",
           "posterior_log_variance_clipped", "posterior_mean_coef1",
           "posterior_mean_coef2")


def schedule_tables(sched: DiffusionSchedule, device) -> dict:
    """The tables the loss and the samplers gather from, as float32 tensors
    on ``device``."""
    return {name: torch.as_tensor(getattr(sched, name), dtype=torch.float32,
                                  device=device) for name in _TABLES}


def extract(table, t, ndim: int):
    """table[t] as (B, 1, ..., 1) for an ``ndim`` tensor."""
    out = table[t]
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def q_sample(tables: dict, x_start, t, noise):
    """x_t = sqrt(ᾱ_t) x_0 + sqrt(1-ᾱ_t) ε."""
    nd = x_start.dim()
    return (extract(tables["sqrt_alphas_cumprod"], t, nd) * x_start
            + extract(tables["sqrt_one_minus_alphas_cumprod"], t, nd) * noise)


def predict_start_from_noise(tables: dict, x_t, t, noise):
    """x_0 = sqrt(1/ᾱ_t) x_t - sqrt(1/ᾱ_t - 1) ε."""
    nd = x_t.dim()
    return (extract(tables["sqrt_recip_alphas_cumprod"], t, nd) * x_t
            - extract(tables["sqrt_recipm1_alphas_cumprod"], t, nd) * noise)


def q_posterior(tables: dict, x_start, x_t, t):
    """The moments of q(x_{t-1} | x_t, x_0): (mean, variance, clipped log
    variance)."""
    nd = x_t.dim()
    mean = (extract(tables["posterior_mean_coef1"], t, nd) * x_start
            + extract(tables["posterior_mean_coef2"], t, nd) * x_t)
    var = extract(tables["posterior_variance"], t, nd)
    log_var = extract(tables["posterior_log_variance_clipped"], t, nd)
    return mean, var, log_var


def p_mean_variance(tables: dict, model_out, x, t, clip_denoised: bool = True):
    """The moments of p(x_{t-1} | x_t) for an ε prediction ``model_out``:
    the x_0 it implies, clipped to [-1, 1] where ``clip_denoised``, through
    ``q_posterior``."""
    x_recon = predict_start_from_noise(tables, x, t, noise=model_out)
    if clip_denoised:
        x_recon = x_recon.clamp(-1.0, 1.0)
    return q_posterior(tables, x_recon, x, t)


@torch.no_grad()
def p_sample_loop(tables: dict, denoise_fn: Callable, x_T,
                  noises: Sequence | None = None,
                  generator: torch.Generator | None = None,
                  log_every_t: int | None = None):
    """Ancestral DDPM from ``x_T`` over every timestep, T-1 down to 0, the
    predicted x0 clipped to [-1, 1] (the configs' ``clip_denoised``).

    ``denoise_fn(x, t_batch) -> ε``. Step i (timestep T-1-i) adds
    ``noises[i]`` when given, else a draw from ``generator``, scaled by the
    posterior's standard deviation; at t = 0 the noise is masked out.
    Returns the sample; with ``log_every_t`` also the stacked samples after
    steps 0, log_every_t, 2 log_every_t, ... (K, *x_T.shape)."""
    n_steps = tables["posterior_variance"].shape[0]
    img = x_T
    t_b = torch.empty(x_T.shape[0], dtype=torch.long, device=x_T.device)
    inter = []
    for i, t in enumerate(range(n_steps - 1, -1, -1)):
        t_b.fill_(t)
        model_out = denoise_fn(img, t_b).float()
        mean, _, log_var = p_mean_variance(tables, model_out, img, t_b)
        noise = (noises[i] if noises is not None else torch.randn(
            img.shape, generator=generator, device=img.device))
        nonzero = float(t > 0)
        img = mean + nonzero * torch.exp(0.5 * log_var) * noise
        if log_every_t and i % log_every_t == 0:
            inter.append(img)
    if log_every_t:
        return img, torch.stack(inter)
    return img


def simple_loss(pred, target):
    """Per-sample L1 loss averaged over the non-batch dimensions."""
    loss = (target - pred).abs()
    return loss.reshape(loss.shape[0], -1).mean(dim=1)


def ddpm_losses(tables: dict, apply_fn: Callable, x_start, t, noise, logvar):
    """The flagship's ε-prediction L1 loss with the logvar weighting.
    ``apply_fn(x_noisy, t)`` is the denoiser; ``logvar`` the (T,) table.
    Returns (loss, loss_dict) with the JAX package's loss names; the vlb
    term is reported, and weighted 0 in the loss as the flagship sets it."""
    x_noisy = q_sample(tables, x_start, t, noise)
    model_output = apply_fn(x_noisy, t)
    loss_simple = simple_loss(model_output.float(), noise.float())
    logvar_t = logvar[t]
    loss = (loss_simple / torch.exp(logvar_t) + logvar_t).mean()
    loss_vlb = (tables["lvlb_weights"][t] * loss_simple).mean()
    loss_dict = {
        "train/loss_simple": loss_simple.mean(),
        "train/loss_vlb": loss_vlb,
        "train/loss": loss,
    }
    return loss, loss_dict
