"""A few stage-2 train steps of the flagship or the faces configuration.

Counterpart of ``main_val.py -t true --max_steps N -s SEED``
(``encdiff_tpu/train/harness.py``) for

- ``--config flagship`` (default): the flagship's final purification phase
  (``configs.FLAGSHIP_TRAIN``: L1 ε-loss, HSIC at λ 2, AdamW at batch x 2e-6
  with the 10k-step warmup, EMA 0.9999, scale_by_std) on batches of the v4
  renderer's ``TRAIN_GRID`` (4,096 images, 64 px);
- ``--config faces``: ``configs.FACES_TRAIN`` (no HSIC, micro-batch 8 with
  4-way accumulation, the LR 4 x 8 x 2e-6) on batches of the face
  renderer's ``TRAIN_GRID`` (512 images, 256 px).

With ``--ckpt`` the model starts from a compact checkpoint's weights;
without it from a fresh init drawn from ``--seed``, as ``main_val.py -t
true`` starts. The optimizer and the EMA start fresh either way, so the LR
warmup starts at its first value. A step is one micro-batch (the global
step, as the JAX harness counts ``--max_steps``); AdamW moves every
``--accumulate`` of them. Batches are drawn through a permutation seeded
with ``--seed``; t and the noise from a ``torch.Generator`` seeded the
same. Prints one line per step and optionally saves the trained state as a
compact ``.npz`` that ``LatentDiffusion.from_checkpoint`` reads.

    python -m encdiff_tpu_torch.train_steps [--config faces] [--ckpt <npz>] \
        --steps N [--batch_size B] [--accumulate K] [--seed S] \
        [--device cuda] [--out <npz>]
"""

from __future__ import annotations

import argparse

import torch

from encdiff_tpu_torch.configs import FACES_TRAIN, FLAGSHIP_TRAIN
from encdiff_tpu_torch.core.compact_ckpt import load_compact, model_variables
from encdiff_tpu_torch.data import synthetic_faces, synthetic_shapes
from encdiff_tpu_torch.data.synthetic_shapes import epoch_batches
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.train.checkpoint_io import (fresh_variables,
                                                   save_checkpoint)
from encdiff_tpu_torch.train.loop import create_train_state, train_step


def load_for_training(path: str, config: dict, device):
    """(model, state, variables): the model with the checkpoint's raw
    weights, a fresh train state at the checkpoint's global step, and the
    loaded variable tree (the paths the trained state is saved under)."""
    tree = load_compact(path)
    variables, scale_factor = model_variables(tree)
    model = LatentDiffusion(config, device)
    model.load_variables(variables, scale_factor, use_ema=False)
    step = int(tree["state"].get("step", 0))
    return model, create_train_state(model, config, step=step), variables


def fresh_for_training(config: dict, seed: int, device):
    """(model, state, variables) as ``load_for_training`` gives them, for a
    model initialised from ``seed`` (``LatentDiffusion.init_parameters``)
    at global step 0; ``variables`` holds the first stage and the paths the
    trained state is saved under."""
    model = LatentDiffusion(config, device)
    model.init_parameters(torch.Generator(model.device).manual_seed(seed))
    variables = fresh_variables(model)
    return model, create_train_state(model, config), variables


def training_images(name: str, config: dict, device) -> torch.Tensor:
    """The uint8 training sub-grid of configuration ``name`` at the first
    stage's resolution, on ``device``."""
    size = config["first_stage_config"]["ddconfig"]["resolution"]
    if name == "faces":
        images = synthetic_faces.render_faces(
            size, factor_sizes=synthetic_faces.TRAIN_GRID)
    else:
        images = synthetic_shapes.render_all_v4(
            size, factor_sizes=synthetic_shapes.TRAIN_GRID)
    return torch.from_numpy(images).to(device)


def run(model, state, images, steps: int, batch_size: int, seed: int,
        generator: torch.Generator):
    """Yield the metrics of ``steps`` train steps on batches of ``images``
    (a uint8 tensor on the model's device), drawn epoch after epoch through
    permutations seeded from ``seed``."""
    epoch, pending = 0, []
    for _ in range(steps):
        if not pending:
            pending = epoch_batches(len(images), batch_size, seed, epoch)
            epoch += 1
        idx = torch.from_numpy(pending.pop(0)).to(model.device)
        yield train_step(model, state, images[idx], generator=generator)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("flagship", "faces"),
                    default="flagship")
    ap.add_argument("--ckpt", default=None,
                    help="compact .npz to start from; a fresh init without")
    ap.add_argument("--steps", type=int, default=20,
                    help="micro-batches (global steps)")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--accumulate", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    base = FACES_TRAIN if args.config == "faces" else FLAGSHIP_TRAIN
    config = {**base, "batch_size": args.batch_size or base["batch_size"],
              "accumulate_grad_batches": (
                  args.accumulate or base.get("accumulate_grad_batches", 1))}
    seed = base["seed"] if args.seed is None else args.seed
    if args.ckpt:
        model, state, variables = load_for_training(args.ckpt, config,
                                                    args.device)
        start = f"loaded {args.ckpt}"
    else:
        model, state, variables = fresh_for_training(config, seed,
                                                     args.device)
        start = f"fresh init from seed {seed}"
    images = training_images(args.config, config, model.device)
    gen = torch.Generator(model.device).manual_seed(seed)
    print(f"{args.config}: {start} at step {state.step}; {len(images)} "
          f"training images, batch {config['batch_size']}, accumulate "
          f"{state.accumulate}", flush=True)
    for m in run(model, state, images, args.steps, config["batch_size"],
                 seed, gen):
        print(f"step {state.step} loss_simple "
              f"{m['train/loss_simple'].item():.6f} loss_indep "
              f"{m.get('train/loss_indep', torch.zeros(())).item():.6f} "
              f"loss {m['train/loss'].item():.6f} grad_norm "
              f"{m['grad_norm'].item():.6f} lr {m['lr']:.6e}", flush=True)
    if args.out:
        save_checkpoint(args.out, model, state, variables)
        print(f"saved -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
