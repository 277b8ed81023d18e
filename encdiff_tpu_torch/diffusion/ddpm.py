"""DDPM training math: forward noising and the ε-prediction loss.

Counterpart of ``encdiff_tpu/diffusion/ddpm.py:22-34,118-162`` (``extract``,
``q_sample``, ``simple_loss``, ``ddpm_losses``) at the flagship's settings:
ε target, L1 loss, simple-loss weight 1, vlb weight 0. Per-timestep coefficients
are gathers into the schedule's tables, held as float32 tensors on the
device (``schedule_tables``), as the JAX package gathers from float32
arrays.
"""

from __future__ import annotations

from typing import Callable

import torch

from encdiff_tpu_torch.core.schedules import DiffusionSchedule

_TABLES = ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
           "lvlb_weights")


def schedule_tables(sched: DiffusionSchedule, device) -> dict:
    """The tables the loss gathers from, as float32 tensors on ``device``."""
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
