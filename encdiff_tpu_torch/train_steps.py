"""A few stage-2 train steps of the flagship from a compact checkpoint.

Counterpart of ``main_val.py -t true --max_steps N -s SEED``
(``encdiff_tpu/train/harness.py``) for the flagship's final purification
phase (``configs.FLAGSHIP_TRAIN``: L1 ε-loss, HSIC at λ 2, AdamW at
batch x 2e-6 with the 10k-step warmup, EMA 0.9999, scale_by_std). The
optimizer and the EMA start fresh from the loaded weights, so the LR warmup
starts again at its first value. Batches of the v4 renderer's
``TRAIN_GRID`` (4,096 images) are drawn through a seeded permutation; t and
the noise from a ``torch.Generator`` seeded the same. Prints one line per
step and optionally saves the trained state as a compact ``.npz`` that
``LatentDiffusion.from_checkpoint`` reads.

    python -m encdiff_tpu_torch.train_steps --ckpt <npz> --steps N \
        --batch_size 128 --seed 23 [--device cuda] [--out <npz>]
"""

from __future__ import annotations

import argparse

import torch

from encdiff_tpu_torch import convert
from encdiff_tpu_torch.configs import FLAGSHIP_TRAIN
from encdiff_tpu_torch.core.compact_ckpt import (load_compact,
                                                 model_variables, save_compact)
from encdiff_tpu_torch.data.synthetic_shapes import (TRAIN_GRID,
                                                     epoch_batches,
                                                     render_all_v4)
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
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


def save_checkpoint(path: str, model, state, variables: dict) -> str:
    """The trained UNet, Encoder4 (params and batch statistics), EMA, scale
    factor and step, under the paths of ``variables``, with its frozen
    first stage; no optimizer state, as the JAX package's compact files."""
    unet_tree = variables["unet"]["params"]
    cond, stats = convert.encoder4_to_flax(
        model.cond_stage_model.state_dict(), variables["cond"]["params"],
        variables["cond"]["batch_stats"])
    train_state = {
        "params": {"unet": convert.state_dict_to_flax(model.unet.state_dict(),
                                                      unet_tree),
                   "cond": cond},
        "batch_stats": stats,
        "scale_factor": float(state.scale_factor),
        "step": state.step,
        "ema": convert.state_dict_to_flax(state.ema.params, unet_tree),
    }
    return save_compact(path, train_state,
                        {"first_stage": variables["first_stage"]})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch_size", type=int,
                    default=FLAGSHIP_TRAIN["batch_size"])
    ap.add_argument("--seed", type=int, default=FLAGSHIP_TRAIN["seed"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    config = {**FLAGSHIP_TRAIN, "batch_size": args.batch_size}
    model, state, variables = load_for_training(args.ckpt, config,
                                                args.device)
    images = torch.from_numpy(render_all_v4(factor_sizes=TRAIN_GRID)).to(
        model.device)
    gen = torch.Generator(model.device).manual_seed(args.seed)
    print(f"loaded {args.ckpt} at step {state.step}; {len(images)} training "
          f"images, batch {args.batch_size}", flush=True)
    for m in run(model, state, images, args.steps, args.batch_size,
                 args.seed, gen):
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
