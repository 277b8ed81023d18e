"""The post-hoc disentanglement battery on one checkpoint.

Sweeps the configuration's ground-truth grid with the checkpoint's
Encoder4 (the harness's ``encode_sweep``, on ``--device``) and scores the
representation with every metric of ``evalx/evaluate.py``'s registry (or
those of ``--metrics``) at ``--tier full`` (the registry's defaults:
10,000 / 5,000 points, 100 boosting stages) or ``--tier fast`` (2,500 /
1,250 points, 20 stages), each from ``RandomState(--seed)``. ``--reps``
scores a saved (N, latent_unit) sweep instead (a harness run's
``reps/<step>.npy``). Prints each metric's seconds and scores and writes
them, with the device's name, to ``--out``.

    python -m encdiff_tpu_torch.posthoc_eval -b mpi3d \\
        -r demo_artifacts/round5/mpi3d_best_dci_fp16.npz [--tier full] \\
        [--metrics dci,med] [--out posthoc.json] [--device cuda] \\
        [key=value ...]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from encdiff_tpu_torch.core.device import resolve_device
from encdiff_tpu_torch.evalx.eval_driver import _to_jsonable
from encdiff_tpu_torch.evalx.evaluate import evaluate_battery
from encdiff_tpu_torch.train import harness
from encdiff_tpu_torch.train.loop import encode_sweep


def sweep(config: dict, ckpt: str, device, logdir: str) -> np.ndarray:
    """The (N, latent_unit) codes of every row of the configuration's
    validation grid (its train grid where it has none) under ``ckpt``."""
    config = dict(config)
    lightning = config.pop("lightning", {})
    trainer = harness.Trainer(config, lightning, logdir=logdir,
                              device=device)
    trainer.resume_ckpt = ckpt
    trainer._ensure_state()
    data = trainer.data
    ds = data.dataset("validation" if "validation" in data.dataset_configs
                      else "train")
    return encode_sweep(trainer.model, trainer._device_grid(ds)).cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-b", "--base", required=True)
    ap.add_argument("-r", "--ckpt", default=None)
    ap.add_argument("--reps", default=None)
    ap.add_argument("--tier", default="full", choices=["fast", "full"])
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("-l", "--logdir", default="logs/posthoc")
    ap.add_argument("--device", default="cuda")
    args, overrides = ap.parse_known_args(argv)
    if (args.ckpt is None) == (args.reps is None):
        raise SystemExit("posthoc_eval: give -r <checkpoint> or --reps <npy>")
    device = resolve_device(args.device)
    config = harness.load_configs([args.base], overrides)
    dataset = config["model"]["params"].get("eval_name")
    if not dataset:
        raise ValueError("the config needs model.params.eval_name for the "
                         "ground-truth dataset")
    t0 = time.perf_counter()
    reps = (np.load(args.reps) if args.reps else
            sweep(config, args.ckpt, device, args.logdir))
    sweep_s = time.perf_counter() - t0
    seconds: dict = {}
    scores = evaluate_battery(
        dataset, reps, tier=args.tier, seed=args.seed, device=device,
        metrics=args.metrics.split(",") if args.metrics else None,
        timings=seconds)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    for name, s in scores.items():
        print(f"{name} {seconds[name]:.3f}s: " + json.dumps(
            _to_jsonable(s)), flush=True)
    result = {"dataset": dataset, "reps": list(reps.shape),
              "tier": args.tier, "seed": args.seed, "device": kind,
              "sweep_s": sweep_s, "seconds": seconds,
              "scores": _to_jsonable(scores)}
    print(f"posthoc_eval: {dataset} {reps.shape} at the {args.tier} tier on "
          f"{kind}: sweep {sweep_s:.3f}s, metrics "
          f"{sum(seconds.values()):.3f}s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
