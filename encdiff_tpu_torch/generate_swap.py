"""Latent-swap grid from one compact checkpoint.

Counterpart of ``scripts/generate_swap_from_ckpt.py`` for the flagship
configuration (``encdiff_tpu_torch/configs.py``). Inputs are drawn from a
small grid of the v4 Shapes3D stand-in (``INPUT_GRID``, 64 images), since
the full 480,000-image grid takes 5.9 GB. Writes ``swap_full_grid.npy`` (inputs, then
the factor-major swaps, NHWC in [-1, 1]) and ``factor_correspondence.json``.

    python -m encdiff_tpu_torch.generate_swap -r <ckpt.npz> --num_samples 8 \
        --ddim_steps 200 --eta 0 --seed 42 --out <dir> [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from encdiff_tpu_torch.data.synthetic_shapes import render_all_v4
from encdiff_tpu_torch.evalx.swap import swap_sample
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion

#: factor grid the inputs are drawn from: 2 values of each of the 6 factors
INPUT_GRID = (2, 2, 2, 2, 2, 2)


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


def pick_inputs(num_samples: int, seed: int) -> np.ndarray:
    """``num_samples`` distinct images of ``INPUT_GRID``, in [-1, 1]."""
    images = render_all_v4(factor_sizes=INPUT_GRID)
    idx = np.random.RandomState(seed).choice(len(images), size=num_samples,
                                             replace=False)
    return images[idx].astype(np.float32) / 127.5 - 1.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-r", "--ckpt", required=True)
    ap.add_argument("--num_samples", type=int, default=8)
    ap.add_argument("--ddim_steps", type=int, default=200)
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="swap_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = LatentDiffusion.from_checkpoint(args.ckpt, device=args.device)
    batch = pick_inputs(args.num_samples, args.seed)
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
