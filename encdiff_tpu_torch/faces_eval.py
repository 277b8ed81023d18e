"""The faces eval chain on one checkpoint: TAD, FID and the swap grid.

Counterpart of ``scripts/round3_faces_eval.sh``. ``-r`` names a harness
checkpoint directory (``<run>/checkpoints/last`` of ``main_val -b faces``)
or a compact ``.npz``. In turn, each timed on the host's clock around work
that ends on the device:

1. the eval file of ``--tad_num`` faces of the full grid at the faces
   configuration's 256 px (``data.synthetic_faces.write_eval_npz``);
2. ``python -m encdiff_tpu_torch.tad`` on it -> ``<out>/tad.json``;
3. ``python -m encdiff_tpu_torch.fid --num <fid_num> --batch_size 64
   --ddim_steps 50`` -> ``<out>/fid.json``;
4. ``python -m encdiff_tpu_torch.generate_swap --config faces
   --num_samples 4 --ddim_steps 50`` -> ``<out>/swap``.

Prints each step's wall and the device's name, and writes them to
``<out>/walls.json``.

    python -m encdiff_tpu_torch.faces_eval -r <checkpoint> [--out <dir>] \\
        [--tad_num 4096] [--fid_num 2048] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from encdiff_tpu_torch import fid, generate_swap, tad
from encdiff_tpu_torch.core.device import resolve_device
from encdiff_tpu_torch.data import synthetic_faces

#: the DDIM steps of the FID's reconstructions and of the swap, the script's
DDIM_STEPS = 50


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-r", "--ckpt", required=True)
    ap.add_argument("--out", default="faces_eval")
    ap.add_argument("--tad_num", type=int, default=4096)
    ap.add_argument("--fid_num", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    print(f"faces ckpt: {args.ckpt}", flush=True)
    walls: dict = {}

    def timed(name, fn, *fn_args, **fn_kwargs):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = fn(*fn_args, **fn_kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls[name] = time.perf_counter() - t
        print(f"[faces-eval] {name}: {walls[name]:.3f}s", flush=True)
        return out

    size = generate_swap.CONFIGS["faces"]["first_stage_config"]["ddconfig"][
        "resolution"]
    npz = timed("eval_npz", synthetic_faces.write_eval_npz,
                os.path.join(args.out, "test_faces.npz"), image_size=size,
                num=args.tad_num, device=device)
    dev = ["--device", str(device)]
    timed("tad", tad.main, ["--config", "faces", "-r", args.ckpt,
                            "--eval_npz", npz, "--out",
                            os.path.join(args.out, "tad.json"), *dev])
    timed("fid", fid.main, ["--config", "faces", "-r", args.ckpt, "--num",
                            str(args.fid_num), "--batch_size", "64",
                            "--ddim_steps", str(DDIM_STEPS), "--out",
                            os.path.join(args.out, "fid.json"), *dev])
    timed("swap", generate_swap.main, [
        "--config", "faces", "-r", args.ckpt, "--num_samples", "4",
        "--ddim_steps", str(DDIM_STEPS), "--out",
        os.path.join(args.out, "swap"), *dev])
    result = {"ckpt": args.ckpt, "walls_s": walls, "tad_num": args.tad_num,
              "fid_num": args.fid_num,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")}
    with open(os.path.join(args.out, "walls.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
