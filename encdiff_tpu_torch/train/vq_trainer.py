"""The VQ-GAN first-stage train step: two optimizers on one batch.

Counterpart of ``encdiff_tpu/train/vq_trainer.py``: ``make_optimizers``
(:41, two ``Adam(b1 0.5, b2 0.9)``, the generator's LR times
``lr_g_factor``; with accumulation above 1 each runs ``optax.MultiSteps``,
here ``train.loop.accumulate_grads``), the train state (:52), the
two-optimizer step body (:72-129) and the eval step (:169). As there:

- the generator update comes first: reconstruction (L1 + LPIPS), the
  adaptive-weight GAN term and the codebook loss, differentiated with
  respect to the generator's parameters only
  (``torch.autograd.grad``), so that no gradient of it reaches the
  discriminator's;
- the discriminator update follows on the same batch, on the
  reconstruction the generator pass made (before its update), detached;
- both passes are keyed on the global step before its increment
  (``disc_start``);
- the eval step computes the validation metrics only: the generator loss
  with ``disc_weight`` for the GAN weight, the discriminator loss on the
  running statistics.

The batch of the device-resident epoch (``encdiff_tpu/train/vq_trainer.py:145``)
is gathered by the harness: rows ``order[i·B:(i+1)·B]`` of the grid at
``i = step % steps_per_epoch``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from encdiff_tpu_torch.train.loop import accumulate_grads, end_update


@dataclass
class Accumulation:
    """One optimizer's ``optax.MultiSteps`` buffers
    (``train.loop.accumulate_grads``)."""

    accumulate: int = 1
    mini_step: int = 0
    acc_grads: list | None = None


@dataclass
class VQTrainState:
    """What the VQ-GAN step carries beside the model: the global step and
    the two optimizers with their accumulation buffers. The generator's
    and the discriminator's parameters and batch statistics live in the
    model (``model.loss.discriminator``)."""

    step: int
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
    gen_acc: Accumulation = field(default_factory=Accumulation)
    disc_acc: Accumulation = field(default_factory=Accumulation)


def make_optimizers(model, learning_rate: float):
    """Adam(β 0.5 / 0.9, eps 1e-8) over the generator at
    ``learning_rate · model.lr_g_factor`` and over the discriminator at
    ``learning_rate``."""
    gen_opt = torch.optim.Adam(list(model.generator_parameters().values()),
                               lr=learning_rate * model.lr_g_factor,
                               betas=(0.5, 0.9), eps=1e-8)
    disc_opt = torch.optim.Adam(model.loss.discriminator.parameters(),
                                lr=learning_rate, betas=(0.5, 0.9), eps=1e-8)
    return gen_opt, disc_opt


def create_vq_train_state(model, learning_rate: float, accumulate: int = 1,
                          step: int = 0) -> VQTrainState:
    """Fresh optimizers over ``model``'s current weights, which become
    trainable (LPIPS stays frozen)."""
    model.train()
    model.requires_grad_(True)
    if model.loss.lpips is not None:
        model.loss.lpips.requires_grad_(False)
    gen_opt, disc_opt = make_optimizers(model, learning_rate)
    return VQTrainState(step=step, gen_opt=gen_opt, disc_opt=disc_opt,
                        gen_acc=Accumulation(accumulate),
                        disc_acc=Accumulation(accumulate))


def as_images(batch):
    """(B, S, S, C) uint8 (or [-1, 1] floats) -> (B, C, S, S) float32 in
    [-1, 1]."""
    x = (batch.float() / 127.5 - 1.0 if not batch.is_floating_point()
         else batch.float())
    return x.permute(0, 3, 1, 2).contiguous()


def _update(optimizer, acc, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    if accumulate_grads(acc, params):
        optimizer.step()
        end_update(acc, optimizer)


def train_step(model, state: VQTrainState, batch) -> dict:
    """One generator update and one discriminator update on ``batch``
    (B, S, S, 3) uint8. Updates ``state`` and the model in place; returns
    the logs of both passes as device scalars."""
    loss_obj = model.loss
    x = as_images(batch)

    # ---- generator pass (optimizer_idx 0)
    gen = list(model.generator_parameters().values())
    xrec, qloss, indices = model(x)
    g_total, g_log = loss_obj.generator_loss(
        qloss, x, xrec, state.step, last_layer=model.get_last_layer(),
        split="train", predicted_indices=indices)
    _update(state.gen_opt, state.gen_acc, gen,
            torch.autograd.grad(g_total, gen))

    # ---- discriminator pass (optimizer_idx 1, same batch)
    disc = list(loss_obj.discriminator.parameters())
    d_total, d_log = loss_obj.discriminator_loss(x, xrec, state.step,
                                                 split="train", train=True)
    _update(state.disc_opt, state.disc_acc, disc,
            torch.autograd.grad(d_total, disc))

    state.step += 1
    return {**g_log, **d_log}


@torch.no_grad()
def eval_step(model, state: VQTrainState, batch) -> dict:
    """The validation metrics of ``batch`` (``autoencoder.py:210-239``):
    no update, no batch statistic moves."""
    loss_obj = model.loss
    x = as_images(batch)
    xrec, qloss, indices = model(x)
    _, log = loss_obj.generator_loss(qloss, x, xrec, state.step, split="val",
                                     predicted_indices=indices)
    _, d_log = loss_obj.discriminator_loss(x, xrec, state.step, split="val",
                                           train=False)
    return {**log, **d_log}


def optimizer_count(optimizer) -> int:
    """The number of updates ``optimizer`` (an Adam) has taken."""
    steps = [s["step"] for s in optimizer.state.values() if "step" in s]
    return int(steps[0]) if steps else 0


@torch.no_grad()
def load_adam(optimizer, params: dict, count: int, mu: dict, nu: dict):
    """Set the Adam state of ``optimizer`` over ``params`` (name ->
    parameter) to the moments ``mu`` / ``nu`` (name -> tensor) after
    ``count`` updates, as ``convert.vq_state_dicts`` gives them."""
    for name, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device).clone(),
            "exp_avg_sq": nu[name].to(p.device).clone()}
