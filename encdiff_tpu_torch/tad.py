"""TAD of a trained model's concept codes against an eval set's attributes.

Counterpart of ``scripts/celeba_tad.py``: Encoder4 (on its running
statistics) encodes the eval file's images on the device, in batches, into
its scalars, or with ``--use_tokens`` into the warped tokens (U * D); TAD
(``evalx.tad.tad_score``) scores them against the file's binary
attributes. The eval file holds ``data`` (uint8 images, NHWC or NCHW),
``targ`` (attributes; > 0 is true) and, optionally, ``attr_names``
(``data.synthetic_faces.write_eval_npz`` writes one from the face grid).
``-r`` takes a compact ``.npz`` or a harness checkpoint directory
(``<run>/checkpoints/last``). Prints the score and each attribute's best
latent; ``--out`` writes the script's JSON keys.

    python -m encdiff_tpu_torch.tad --config faces -r <ckpt> \\
        --eval_npz <npz> [--use_tokens] [--batch_size 256] [--out tad.json] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from encdiff_tpu_torch.evalx.tad import CELEBA_ATTRS, tad_score
from encdiff_tpu_torch.generate_swap import CONFIGS, load_model


@torch.no_grad()
def encode(model, data: np.ndarray, batch_size: int,
           use_tokens: bool = False) -> np.ndarray:
    """Encoder4's codes (N, U), or its warped tokens (N, U * D), of uint8
    or [-1, 1] images ``data`` (N, S, S, 3), ``batch_size`` at a time."""
    codes = []
    for i in range(0, len(data), batch_size):
        x = torch.as_tensor(data[i:i + batch_size], device=model.device)
        x = x.float() / 127.5 - 1.0 if x.dtype == torch.uint8 else x.float()
        u = model.cond_encoding(x)
        if use_tokens:
            u = model.cond_warp(u).reshape(u.shape[0], -1)
        codes.append(u.cpu().numpy())
    return np.concatenate(codes)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=tuple(CONFIGS), default="faces")
    ap.add_argument("-r", "--ckpt", required=True,
                    help="compact .npz or harness checkpoint directory")
    ap.add_argument("--eval_npz", required=True)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--use_tokens", action="store_true",
                    help="score the warped (U*D) tokens instead of the "
                         "scalars")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = load_model(args.config, args.ckpt, 0, args.device)
    with np.load(args.eval_npz) as f:
        data, targ = f["data"], f["targ"]
        attr_names = ([str(n) for n in f["attr_names"]]
                      if "attr_names" in f.files else CELEBA_ATTRS)
    if data.ndim == 4 and data.shape[1] == 3:  # NCHW -> NHWC
        data = np.transpose(data, (0, 2, 3, 1))
    targ = (np.asarray(targ) > 0).astype(np.float32)
    z = encode(model, data, args.batch_size, args.use_tokens)

    result = tad_score(z, targ)
    print(f"TAD SCORE: {result['tad_score']:.4f}  "
          f"Attributes Captured: {result['attributes_captured']}")
    for i, name in enumerate(attr_names[:targ.shape[1]]):
        print(f"  {name:<22} lat {int(result['argmax_latent'][i]):>4} "
              f"max {result['max_auroc'][i]:.3f} "
              f"nd {result['norm_diffs'][i]:.3f}")
    if args.out:
        with open(args.out, "w") as fo:
            json.dump({"TAD SCORE: ": result["tad_score"],
                       "Attributes Captured: ":
                           result["attributes_captured"]}, fo)
    return result


if __name__ == "__main__":
    main()
