"""Latent-swap grid from one compact checkpoint.

Counterpart of ``scripts/generate_swap_from_ckpt.py`` for the flagship and
the faces configurations (``encdiff_tpu_torch/configs.py``). Inputs are
drawn with ``RandomState(seed).choice``, as the script draws them, from a
sub-grid of the configuration's renderer: the v4 Shapes3D stand-in's
``INPUT_GRID`` (64 images at 64 px; the full 480,000-image grid takes
5.9 GB) or the face renderer's ``TRAIN_GRID`` (512 images at 256 px; the
full grid takes 6.8 GB). ``-r`` takes a compact ``.npz`` or a harness
checkpoint directory (``<run>/checkpoints/last``, read through its
``model.npz``); without it the model is a fresh init drawn from
``--seed``. Writes
``swap_full_grid.npy`` (inputs, then the factor-major swaps, NHWC in
[-1, 1]) and ``factor_correspondence.json``.

    python -m encdiff_tpu_torch.generate_swap [--config faces] \
        [-r <ckpt>] --num_samples 8 --ddim_steps 200 --eta 0 \
        --seed 42 --out <dir> [--device cuda]

The faces eval chain (``scripts/round3_faces_eval.sh``) runs it as
``--config faces --num_samples 4 --ddim_steps 50``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from encdiff_tpu_torch.configs import FACES, FLAGSHIP
from encdiff_tpu_torch.data import synthetic_faces
from encdiff_tpu_torch.data.synthetic_shapes import render_all_v4
from encdiff_tpu_torch.evalx.swap import swap_sample
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion

#: factor grid the flagship's inputs are drawn from: 2 values of each of
#: the 6 factors
INPUT_GRID = (2, 2, 2, 2, 2, 2)
CONFIGS = {"flagship": FLAGSHIP, "faces": FACES}


def factor_correspondence(base: np.ndarray, swapped: np.ndarray) -> dict:
    """Per-factor pixel-difference energy: how much of the image each
    factor controls."""
    b = base.shape[0]
    out = {}
    for cdx in range(swapped.shape[0] // b):
        diff = np.abs(swapped[cdx * b:(cdx + 1) * b] - base).mean(axis=(0, 3))
        out[f"factor_{cdx:02}"] = {
            "mean_abs_diff": float(diff.mean()),
            "max_abs_diff": float(diff.max()),
            "active_fraction": float((diff > 0.05).mean()),
        }
    return out


def input_grid(config: str = "flagship") -> np.ndarray:
    """The uint8 images of configuration ``config`` that inputs are drawn
    from: ``INPUT_GRID`` of the v4 renderer, or the face renderer's
    ``TRAIN_GRID`` at 256 px."""
    if config == "faces":
        return synthetic_faces.render_faces(
            CONFIGS["faces"]["first_stage_config"]["ddconfig"]["resolution"],
            factor_sizes=synthetic_faces.TRAIN_GRID)
    return render_all_v4(factor_sizes=INPUT_GRID)


def pick_inputs(num_samples: int, seed: int,
                config: str = "flagship") -> np.ndarray:
    """``num_samples`` distinct images of ``input_grid(config)``, in
    [-1, 1]."""
    images = input_grid(config)
    idx = np.random.RandomState(seed).choice(len(images), size=num_samples,
                                             replace=False)
    return images[idx].astype(np.float32) / 127.5 - 1.0


def load_model(config: str, ckpt: str | None, seed: int,
               device) -> LatentDiffusion:
    """The model of ``CONFIGS[config]`` with the weights of ``ckpt`` (a
    compact ``.npz`` or a harness checkpoint directory), or without
    ``ckpt`` a fresh init drawn from ``seed``."""
    if ckpt:
        return LatentDiffusion.from_checkpoint(ckpt, device=device,
                                               config=CONFIGS[config])
    model = LatentDiffusion(CONFIGS[config], device)
    model.init_parameters(torch.Generator(model.device).manual_seed(seed))
    return model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=tuple(CONFIGS), default="flagship")
    ap.add_argument("-r", "--ckpt", default=None,
                    help="compact .npz or harness checkpoint directory; a "
                         "fresh init from --seed without")
    ap.add_argument("--num_samples", type=int, default=8)
    ap.add_argument("--ddim_steps", type=int, default=200)
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="swap_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = load_model(args.config, args.ckpt, args.seed, args.device)
    batch = pick_inputs(args.num_samples, args.seed, args.config)
    gen = torch.Generator(model.device).manual_seed(args.seed)
    x = swap_sample(model, batch, ddim_steps=args.ddim_steps, eta=args.eta,
                    generator=gen).cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "swap_full_grid.npy"),
            np.concatenate([batch, x], axis=0))
    with open(os.path.join(args.out, "factor_correspondence.json"), "w") as f:
        json.dump(factor_correspondence(batch, x), f, indent=2)
    print(f"wrote {x.shape[0] // args.num_samples}-factor swap grid "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
