"""FID between real images and DDIM reconstructions.

Counterpart of ``scripts/celeba_fid.py`` for the faces configuration,
without ``--feature_probe_npz``. Real images are drawn as the script draws
them, ``RandomState(0).choice(34560, num)``, from the full face grid of
``SyntheticFacesTrain`` (6.8 GB at 256 px, its colour blocks composed on
``--device``), so ``--num`` may be up to 34,560 (the eval chain's is
2,048). Each batch is reconstructed as the script's ``sample_batch``
does it: Encoder4's code of the real images conditions a DDIM chain from
noise (a generator seeded with the batch's first index), and the VQ decoder
maps the latents to images. Inception pool3 features of both sets give the
Fréchet distance: with ``--inception_weights`` (a pytorch-fid
``pt_inception`` state_dict) calibrated, else from a seeded random init,
uncalibrated. ``-r`` takes a compact ``.npz`` or a harness checkpoint
directory (``<run>/checkpoints/last``); without it the model is a fresh
init drawn from ``--seed``. Prints and optionally writes ``{"fid", "num",
"mode", "calibrated"}``.

    python -m encdiff_tpu_torch.fid --config faces [-r <ckpt>] \\
        --num 2048 --batch_size 64 --ddim_steps 50 [--eta 1] \\
        [--inception_weights pt.pth] [--out fid.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from encdiff_tpu_torch.data import synthetic_faces
from encdiff_tpu_torch.evalx import fid as fid_lib
from encdiff_tpu_torch.generate_swap import CONFIGS, load_model


def real_indices(num: int, n: int) -> np.ndarray:
    """The grid rows of the real images: ``RandomState(0).choice(n, num)``
    without replacement, in the drawn order."""
    return np.random.RandomState(0).choice(n, size=num, replace=False)


def real_images(num: int, config: str = "faces", device=None) -> np.ndarray:
    """``num`` uint8 images of the configuration's full face grid, at
    ``real_indices``; the grid's colour blocks are composed on ``device``
    (``SyntheticFaces``) and it stays cached for the process."""
    size = CONFIGS[config]["first_stage_config"]["ddconfig"]["resolution"]
    images = synthetic_faces.SyntheticFacesTrain(size, device=device).images
    return images[real_indices(num, len(images))]


@torch.no_grad()
def sample_batch(model, real_uint8, ddim_steps: int, eta: float,
                 generator: torch.Generator):
    """Reconstructions of a uint8 batch (B, S, S, 3): tokens from Encoder4,
    DDIM from noise drawn from ``generator``, the VQ decode; in [-1, 1]."""
    x = torch.as_tensor(real_uint8, device=model.device).float() / 127.5 - 1.0
    tokens = model.cond_warp(model.cond_encoding(x))
    latents = model.sample_ddim(tokens, steps=ddim_steps, eta=eta,
                                generator=generator)
    return model.decode_first_stage(latents)


def reconstructions(model, real, batch_size: int, ddim_steps: int,
                    eta: float) -> np.ndarray:
    """``sample_batch`` over ``real`` in batches, mapped to [0, 1]."""
    out = []
    for i in range(0, len(real), batch_size):
        gen = torch.Generator(model.device).manual_seed(i)
        img = sample_batch(model, real[i:i + batch_size], ddim_steps, eta,
                           gen)
        out.append(((img + 1) / 2).clamp(0, 1).cpu().numpy())
        if (i // batch_size) % 10 == 0:
            print(f"sampled {i + len(out[-1])}/{len(real)}", flush=True)
    return np.concatenate(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("faces",), default="faces")
    ap.add_argument("-r", "--ckpt", default=None,
                    help="compact .npz or harness checkpoint directory; a "
                         "fresh init from --seed without")
    ap.add_argument("--num", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--ddim_steps", type=int, default=200)
    ap.add_argument("--eta", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--inception_weights", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = load_model(args.config, args.ckpt, args.seed, args.device)
    real = real_images(args.num, args.config, model.device)
    gen = reconstructions(model, real, args.batch_size, args.ddim_steps,
                          args.eta)
    if args.inception_weights:
        sd = torch.load(args.inception_weights, map_location="cpu")
        inception = fid_lib.fid_inception(model.device, state_dict=sd)
        mode, calibrated = "inception", True
    else:
        print("WARNING: no --inception_weights; FID is uncalibrated "
              "(random-init Inception features)", flush=True)
        inception = fid_lib.fid_inception(model.device, seed=0)
        mode, calibrated = "random_features", False
    score = fid_lib.compute_fid(inception, real.astype(np.float32) / 255.0,
                                gen, batch_size=args.batch_size)
    result = {"fid": score, "num": args.num, "mode": mode,
              "calibrated": calibrated}
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
