"""The stage-2 train step: loss, backward, AdamW, EMA and scale-by-std;
the first-stage latent cache and the representation sweep.

Counterpart of ``encdiff_tpu/train/loop.py:128-250`` (``TrainState``,
``scaled_learning_rate``, ``build_optimizer`` with its ``optax.MultiSteps``
gradient accumulation, ``create_train_state``, ``build_train_step``, the
MCL heads among the trained leaves as :163-189 puts them; the split-program
MCL step of :252-383 is not ported, see ``models.latent_diffusion``), of
``precompute_latents`` (:74-130) and of the encode sweep
(``build_encode_step``, ``build_encode_sweep``: :637-679). The JAX step is
one jitted XLA program; here it is eager PyTorch whose GN-SiLU and
attention run the port's kernels forward and backward. As in the JAX
step:

- scale_by_std sets the scale factor from the batch at global step 0 only;
  later steps keep the state's;
- the LR is keyed on the optimizer's own update count (``updates``), which
  starts at 0 with a fresh optimizer, not on the global step: a run resumed
  from weights alone begins the warmup again. Each step sets the LR itself;
- ``grad_norm`` is the global L2 norm of the gradients, and nothing clips
  them;
- the EMA of the UNet moves after the optimizer step;
- with accumulation over k micro-batches (``optax.MultiSteps``) each call
  is one micro-batch: its gradients go into a running mean kept in buffers
  of its own (Welford's update, as optax), AdamW (its moments, its count
  and so the LR) moves on every k-th call only, with the mean, and the
  other calls leave the parameters as they are; the global step,
  Encoder4's batch statistics and the EMA move on every call, and
  ``grad_norm`` is the micro-batch's.

t and the noise come from an explicit ``torch.Generator``, or are given;
so does the MCL term's random draw (drawn after them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from encdiff_tpu_torch.core import ema as ema_lib
from encdiff_tpu_torch.core.lr_scheduler import (LambdaLinearScheduler,
                                                 as_lr_schedule)

EMA_DECAY = 0.9999


@dataclass
class TrainState:
    """What the train step carries. The parameters and Encoder4's batch
    statistics live in the model's modules; the AdamW moments in
    ``optimizer``."""

    step: int                       # global step
    optimizer: torch.optim.Optimizer
    updates: int                    # the optimizer's own count: keys the LR
    lr_fn: Callable[[int], float]
    ema: ema_lib.EmaState           # over the UNet only
    scale_factor: torch.Tensor      # float32 scalar
    accumulate: int = 1             # micro-batches per optimizer update
    mini_step: int = 0              # micro-batches in the running mean
    acc_grads: list | None = None   # the running mean of their gradients


def scaled_learning_rate(base_lr: float, batch_size: int,
                         accumulate: int = 1) -> float:
    """The reference's LR rule, accumulate x ngpu x batch x base_lr, on one
    device."""
    return accumulate * batch_size * base_lr


def trainable_parameters(model) -> dict:
    """name -> parameter of what the step trains: the UNet, Encoder4 and,
    with MCL, the critic, Pi_g and Pi_u (the JAX ``params`` tree's
    ``unet``, ``cond`` and ``mcl``)."""
    out = {f"unet.{k}": p for k, p in model.unet.named_parameters()}
    out.update({f"cond.{k}": p
                for k, p in model.cond_stage_model.named_parameters()})
    if getattr(model, "mcl", None) is not None:
        out.update({f"mcl.{k}": p for k, p in model.mcl.named_parameters()})
    return out


def build_optimizer(params, learning_rate: float) -> torch.optim.Optimizer:
    """AdamW(β 0.9 / 0.999, eps 1e-8), weight decay 1e-2 on every leaf, as
    ``optax.adamw`` in the JAX package."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-2)


def create_train_state(model, config: dict, step: int = 0,
                       learning_rate: float | None = None) -> TrainState:
    """A fresh optimizer (AdamW over every leaf of
    ``trainable_parameters``) and EMA (of the UNet alone, from its current
    weights) for ``model``, whose UNet, Encoder4 and MCL heads become
    trainable; ``step`` is the
    global step the weights were saved at. ``config`` gives
    ``base_learning_rate``, ``batch_size``, the ``scheduler_config`` of a
    ``LambdaLinearScheduler`` and optionally ``accumulate_grad_batches``
    (1 by default); the peak LR is ``learning_rate`` if given, else the
    reference's rule (``scaled_learning_rate``)."""
    for p in trainable_parameters(model).values():
        p.requires_grad_(True)
    accumulate = config.get("accumulate_grad_batches", 1)
    lr = learning_rate or scaled_learning_rate(
        config["base_learning_rate"], config["batch_size"], accumulate)
    lr_fn = as_lr_schedule(
        LambdaLinearScheduler(**config["scheduler_config"]), lr)
    optimizer = build_optimizer(list(trainable_parameters(model).values()),
                                lr)
    return TrainState(step=step, optimizer=optimizer, updates=0, lr_fn=lr_fn,
                      ema=ema_lib.init(dict(model.unet.named_parameters())),
                      scale_factor=torch.tensor(
                          model.scale_factor, dtype=torch.float32,
                          device=model.device),
                      accumulate=accumulate)


def draw_t_and_noise(model, batch_size: int, generator: torch.Generator):
    """t (B,) uniform over the timesteps and the noise (B, h, w, C)."""
    t = torch.randint(0, model.num_timesteps, (batch_size,),
                      generator=generator, device=model.device)
    noise = torch.randn(batch_size, model.image_size, model.image_size,
                        model.channels, generator=generator,
                        device=model.device)
    return t, noise


def loss_and_grads(model, state: TrainState, batch, t, noise, mcl_draw=None,
                   generator: torch.Generator | None = None):
    """The loss at ``state`` with its gradients left in the parameters'
    ``.grad`` and Encoder4's running statistics updated; the MCL term's
    draw is ``mcl_draw`` or comes from ``generator``. Returns (loss_dict,
    scale factor used)."""
    x, z = model.split_batch(batch)
    if z is None:
        z = model.encode_first_stage(x)
    batch = {"image": x, "z": z}
    sf = (model.compute_scale_factor(batch)
          if model.scale_by_std and state.step == 0 else state.scale_factor)
    state.optimizer.zero_grad(set_to_none=True)
    loss, loss_dict = model.loss_fn(batch, t, noise, sf, mcl_draw=mcl_draw,
                                    generator=generator)
    loss.backward()
    # a leaf the loss does not reach (the MCL critic's out.bias: the
    # mechanism gradient is a derivative in z) gets a zero gradient, as in
    # jax.grad, so that AdamW's weight decay moves it as optax.adamw does
    for p in trainable_parameters(model).values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return loss_dict, sf


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def accumulate_grads(acc, params) -> bool:
    """``optax.MultiSteps`` over ``acc.accumulate`` micro-batches: fold the
    ``.grad`` of ``params`` into the running mean ``acc.acc_grads`` (counted
    in ``acc.mini_step``) and return whether the optimizer updates on this
    call; on the k-th call the parameters' ``.grad`` become the mean. With
    ``acc.accumulate`` 1, every call updates on its own gradients. ``acc``
    is a ``TrainState`` or anything with its three fields."""
    if acc.accumulate == 1:
        return True
    grads = [p.grad for p in params]
    if acc.acc_grads is None:
        acc.acc_grads = [torch.zeros_like(g) for g in grads]
    # acc + (g - acc) / (n + 1): optax.MultiSteps' running mean
    diff = torch._foreach_sub(grads, acc.acc_grads)
    torch._foreach_div_(diff, acc.mini_step + 1)
    torch._foreach_add_(acc.acc_grads, diff)
    acc.mini_step += 1
    if acc.mini_step < acc.accumulate:
        return False
    for p, mean in zip(params, acc.acc_grads):
        p.grad = mean
    return True


def end_update(acc, optimizer) -> None:
    """After an optimizer update of ``accumulate_grads``: start the next
    running mean."""
    if acc.accumulate > 1:
        optimizer.zero_grad(set_to_none=True)
        torch._foreach_zero_(acc.acc_grads)
        acc.mini_step = 0


def train_step(model, state: TrainState, batch, *, t=None, noise=None,
               mcl_draw=None,
               generator: torch.Generator | None = None) -> dict:
    """One step on ``batch`` (B, S, S, 3) uint8 or [-1, 1] floats, or
    ``{"image": those, "z": their cached first-stage code}``, one
    micro-batch when ``state.accumulate`` > 1; t and noise, and the MCL
    term's draw, are drawn from ``generator`` unless given. Updates
    ``state`` and the model in place; returns the metrics as device
    scalars: the loss dict, ``grad_norm`` and ``lr`` (the LR of the
    optimizer's next update)."""
    if t is None or noise is None:
        images = batch["image"] if isinstance(batch, dict) else batch
        t, noise = draw_t_and_noise(model, len(images), generator)
    loss_dict, sf = loss_and_grads(model, state, batch, t, noise,
                                   mcl_draw=mcl_draw, generator=generator)
    params = list(trainable_parameters(model).values())
    grad_norm = global_norm([p.grad for p in params])
    lr = state.lr_fn(state.updates)
    if accumulate_grads(state, params):
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.updates += 1
        end_update(state, state.optimizer)
    ema_lib.update(state.ema, dict(model.unet.named_parameters()),
                   decay=EMA_DECAY)
    state.step += 1
    state.scale_factor = sf
    return {**{k: v.detach() for k, v in loss_dict.items()},
            "grad_norm": grad_norm, "lr": lr}


@torch.no_grad()
def precompute_latents(model, images, chunk: int = 2048) -> torch.Tensor:
    """The frozen first stage's pre-quant code (N, h, w, C) of every row of
    ``images`` (N, S, S, 3) uint8, on their device: one encode per row,
    ``chunk`` rows at a time (fewer above 64 px, as the activations grow
    with S²). As the JAX package's, the last chunk ends at row N and
    overlaps the one before, so every encode sees ``chunk`` rows; the
    overlap is dropped."""
    n, side = len(images), images.shape[1]
    if side > 64:
        chunk = max(64, int(chunk * (64.0 / side) ** 2))
    chunk = int(min(chunk, n))
    starts = list(range(0, n - chunk + 1, chunk))
    if starts[-1] + chunk < n:
        starts.append(n - chunk)
    parts, prev_end = [], 0
    for s in starts:
        z = model.encode_first_stage(model.split_batch(images[s:s + chunk])[0])
        parts.append(z[prev_end - s:] if s < prev_end else z)
        prev_end = s + chunk
    return torch.cat(parts)


@torch.no_grad()
def encode_sweep(model, images, chunk: int = 2048) -> torch.Tensor:
    """Encoder4's scalars (N, latent_unit) of every row of ``images`` (N, S,
    S, 3) uint8 on the model's device, in row order: the representation
    sweep the metrics look up by index. Encoder4 runs on its running
    statistics (``cond_encoding``). As ``build_encode_sweep`` is driven,
    the row order is padded with row 0 to a whole number of chunks of
    ``min(chunk, N)``, and the padding's codes are dropped."""
    n = len(images)
    chunk = min(chunk, n)
    n_chunks = -(-n // chunk)
    order = torch.zeros(n_chunks * chunk, dtype=torch.long,
                        device=images.device)
    order[:n] = torch.arange(n, device=images.device)
    us = [model.cond_encoding(model.split_batch(images[order[i:i + chunk]])[0])
          for i in range(0, n_chunks * chunk, chunk)]
    return torch.cat(us)[:n]
