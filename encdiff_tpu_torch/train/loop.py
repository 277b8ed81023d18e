"""The stage-2 train step: loss, backward, AdamW, EMA and scale-by-std.

Counterpart of ``encdiff_tpu/train/loop.py:128-250`` (``TrainState``,
``scaled_learning_rate``, ``build_optimizer``, ``create_train_state``,
``build_train_step``) without MCL. The JAX step is one jitted XLA program;
here it is eager PyTorch whose GN-SiLU and attention run the port's kernels
forward and backward. As in the JAX step:

- scale_by_std sets the scale factor from the batch at global step 0 only;
  later steps keep the state's;
- the LR is keyed on the optimizer's own update count (``updates``), which
  starts at 0 with a fresh optimizer, not on the global step: a run resumed
  from weights alone begins the warmup again. Each step sets the LR itself;
- ``grad_norm`` is the global L2 norm of the gradients, and nothing clips
  them;
- the EMA of the UNet moves after the optimizer step.

t and the noise come from an explicit ``torch.Generator``, or are given.
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


def scaled_learning_rate(base_lr: float, batch_size: int) -> float:
    """The reference's LR rule, accumulate x ngpu x batch x base_lr, on one
    device without accumulation."""
    return batch_size * base_lr


def trainable_parameters(model) -> dict:
    """name -> parameter of what the step trains: the UNet and Encoder4
    (the JAX ``params`` tree's ``unet`` and ``cond``)."""
    out = {f"unet.{k}": p for k, p in model.unet.named_parameters()}
    out.update({f"cond.{k}": p
                for k, p in model.cond_stage_model.named_parameters()})
    return out


def build_optimizer(params, learning_rate: float) -> torch.optim.Optimizer:
    """AdamW(β 0.9 / 0.999, eps 1e-8), weight decay 1e-2 on every leaf, as
    ``optax.adamw`` in the JAX package."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-2)


def create_train_state(model, config: dict, step: int = 0) -> TrainState:
    """A fresh optimizer and EMA (from the model's current UNet) for
    ``model``, whose UNet and Encoder4 become trainable; ``step`` is the
    global step the weights were saved at. ``config`` gives
    ``base_learning_rate``, ``batch_size`` and the ``scheduler_config`` of
    a ``LambdaLinearScheduler``."""
    model.unet.requires_grad_(True)
    model.cond_stage_model.requires_grad_(True)
    lr = scaled_learning_rate(config["base_learning_rate"],
                              config["batch_size"])
    lr_fn = as_lr_schedule(
        LambdaLinearScheduler(**config["scheduler_config"]), lr)
    optimizer = build_optimizer(list(trainable_parameters(model).values()),
                                lr)
    return TrainState(step=step, optimizer=optimizer, updates=0, lr_fn=lr_fn,
                      ema=ema_lib.init(dict(model.unet.named_parameters())),
                      scale_factor=torch.tensor(
                          model.scale_factor, dtype=torch.float32,
                          device=model.device))


def draw_t_and_noise(model, batch_size: int, generator: torch.Generator):
    """t (B,) uniform over the timesteps and the noise (B, h, w, C)."""
    t = torch.randint(0, model.num_timesteps, (batch_size,),
                      generator=generator, device=model.device)
    noise = torch.randn(batch_size, model.image_size, model.image_size,
                        model.channels, generator=generator,
                        device=model.device)
    return t, noise


def loss_and_grads(model, state: TrainState, batch, t, noise):
    """The loss at ``state`` with its gradients left in the parameters'
    ``.grad`` and Encoder4's running statistics updated. Returns
    (loss_dict, scale factor used)."""
    x, z = model.split_batch(batch)
    if z is None:
        z = model.encode_first_stage(x)
    batch = {"image": x, "z": z}
    sf = (model.compute_scale_factor(batch)
          if model.scale_by_std and state.step == 0 else state.scale_factor)
    state.optimizer.zero_grad(set_to_none=True)
    loss, loss_dict = model.loss_fn(batch, t, noise, sf)
    loss.backward()
    return loss_dict, sf


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def train_step(model, state: TrainState, batch, *, t=None, noise=None,
               generator: torch.Generator | None = None) -> dict:
    """One step on ``batch`` (B, 64, 64, 3) uint8 or [-1, 1] floats; t and
    noise are drawn from ``generator`` unless given. Updates ``state`` and
    the model in place; returns the metrics as device scalars: the loss
    dict, ``grad_norm`` and ``lr``."""
    if t is None or noise is None:
        t, noise = draw_t_and_noise(model, len(batch), generator)
    loss_dict, sf = loss_and_grads(model, state, batch, t, noise)
    params = list(trainable_parameters(model).values())
    grad_norm = global_norm([p.grad for p in params])
    lr = state.lr_fn(state.updates)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.updates += 1
    ema_lib.update(state.ema, dict(model.unet.named_parameters()),
                   decay=EMA_DECAY)
    state.step += 1
    state.scale_factor = sf
    return {**{k: v.detach() for k, v in loss_dict.items()},
            "grad_norm": grad_norm, "lr": lr}
