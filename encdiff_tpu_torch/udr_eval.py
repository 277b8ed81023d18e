"""UDR across model seeds: the port of ``scripts/udr_eval.py``.

Given checkpoints of the same configuration trained from different seeds,
encodes samples of its ground-truth dataset with each one's Encoder4 (on
``--device``) and reports the pairwise UDR disentanglement and each
model's score (``evalx/udr.py``; its Lasso on ``--device`` too).

    python -m encdiff_tpu_torch.udr_eval -b <harness name | cfg.json> \\
        -r <ckpt> <ckpt> [...] [--num_data_points 1000] [--batch_size 100] \\
        [--correlation lasso|spearman] [--activity variance|none] \\
        [--activity_threshold 0.01] [--out <json>] [--device cuda] \\
        [key=value ...]

``-b`` is read as ``main_val`` reads it (``train.harness.load_configs``,
dotlist overrides included); its ``model.params.eval_name`` names the
ground-truth dataset. ``-r`` takes compact ``.npz`` files or harness
checkpoint directories (``<run>/checkpoints/last``, whose fp32 sidecar
holds the weights the run trained). ``--activity variance`` masks the
codes whose variance over 2,048 images drawn by ``RandomState(17)`` is
below ``--activity_threshold`` of the largest, as the protocol masks dead
VAE dimensions by their KL.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from encdiff_tpu_torch import convert
from encdiff_tpu_torch.core.compact_ckpt import (checkpoint_npz,
                                                 load_model_variables)
from encdiff_tpu_torch.core.config import instantiate_from_config
from encdiff_tpu_torch.core.device import resolve_device
from encdiff_tpu_torch.evalx.ground_truth.named_data import get_index_dataset
from encdiff_tpu_torch.evalx.udr import compute_udr
from encdiff_tpu_torch.nn.encoder4 import Encoder4
from encdiff_tpu_torch.train import harness
from encdiff_tpu_torch.train.checkpoint_io import STATE_FILE

#: the activity sample's seed and size, and its encode's chunk
ACTIVITY_SEED = 17
ACTIVITY_POINTS = 2048
ACTIVITY_CHUNK = 256


def load_encoder(model_params: dict, ckpt: str, device) -> Encoder4:
    """The configuration's Encoder4 with the weights of ``ckpt``, on its
    running statistics."""
    variables, _ = load_model_variables(checkpoint_npz(ckpt))
    cond = variables["cond"]
    sd = convert.encoder4_state_dict(cond["params"],
                                     cond.get("batch_stats") or {})
    side = os.path.join(ckpt, STATE_FILE)
    if os.path.isdir(ckpt) and os.path.exists(side):
        sd = torch.load(side, map_location="cpu", weights_only=True)["cond"]
    enc = Encoder4(**{
        "image_size": model_params["first_stage_config"]["ddconfig"][
            "resolution"], **model_params["cond_stage_config"]})
    out_f, in_f = sd["fc.weight"].shape
    if enc.fc.in_features != in_f:
        # a flax Dense takes its input size from the image it saw first
        enc.fc = torch.nn.Linear(in_f, out_f)
    enc.load_state_dict(sd)
    return enc.to(device).eval().requires_grad_(False)


def code_fn(enc: Encoder4, images: torch.Tensor):
    """obs (integer indices) -> (B, latent_unit) float32 numpy codes of
    those rows of the uint8 grid ``images`` (N, S, S, 3)."""
    dev = next(enc.parameters()).device

    @torch.no_grad()
    def codes(obs):
        idx = torch.as_tensor(np.asarray(obs, np.int64), device=images.device)
        x = images[idx].to(dev).float() / 127.5 - 1.0
        return enc.encoding(x.permute(0, 3, 1, 2)).cpu().numpy()

    return codes


def main(argv=None, record: dict | None = None) -> dict:
    """Parse ``argv``, run UDR, print and (``--out``) write its scores.
    ``record``, when given, receives every representation function's
    outputs in call order and the arguments of ``compute_udr``, so that
    its scores can be computed again from the same codes."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-b", "--base", required=True)
    ap.add_argument("-r", "--ckpts", nargs="+", required=True)
    ap.add_argument("--num_data_points", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=100)
    ap.add_argument("--correlation", default="lasso",
                    choices=["lasso", "spearman"])
    ap.add_argument("--activity", default="variance",
                    choices=["variance", "none"])
    ap.add_argument("--activity_threshold", type=float, default=0.01)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args, overrides = ap.parse_known_args(argv)
    device = resolve_device(args.device)

    config = harness.load_configs([args.base], overrides)
    params = config["model"]["params"]
    if not params.get("eval_name"):
        raise ValueError("the config needs model.params.eval_name for the "
                         "ground-truth dataset")
    label_dataset = get_index_dataset(params["eval_name"])
    data = instantiate_from_config(config["data"]).setup(device=device)
    images = harness.device_images(data.dataset("train").images, device)

    act_idx = np.random.RandomState(ACTIVITY_SEED).randint(
        0, len(images), size=ACTIVITY_POINTS)
    rep_fns, activities = [], []
    outputs: list[list] = []
    for ck in args.ckpts:
        codes = code_fn(load_encoder(params, ck, device), images)
        act = None
        if args.activity == "variance":
            sample = np.concatenate(
                [codes(act_idx[i:i + ACTIVITY_CHUNK])
                 for i in range(0, len(act_idx), ACTIVITY_CHUNK)], axis=0)
            var = sample.var(axis=0)
            act = var / max(var.max(), 1e-12)
            activities.append(act.tolist())
        seen: list = []
        outputs.append(seen)

        def rep_fn(obs, codes=codes, act=act, seen=seen):
            out = codes(obs) if act is None else (codes(obs), act)
            seen.append(out)
            return out

        rep_fns.append(rep_fn)

    kwargs = dict(batch_size=args.batch_size,
                  num_data_points=args.num_data_points,
                  correlation_matrix=args.correlation,
                  include_raw_correlations=False,
                  kl_filter_threshold=args.activity_threshold)
    scores = compute_udr(label_dataset, rep_fns, np.random.RandomState(0),
                         device=str(device), **kwargs)
    if record is not None:
        record.update(outputs=outputs, kwargs=kwargs,
                      label_dataset=label_dataset)
    if activities:
        scores["activity_vectors"] = activities
        scores["activity_threshold"] = args.activity_threshold
    print(json.dumps({"model_scores": scores["model_scores"],
                      "pairwise": scores["pairwise_disentanglement_scores"]},
                     indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(scores, f, indent=2)
    return scores


def replay(record: dict, device="cpu") -> dict:
    """``compute_udr`` again over the codes a ``main(record=...)`` run's
    representation functions returned, its Lasso on ``device``."""
    fns = []
    for seen in record["outputs"]:
        it = iter(seen)
        fns.append(lambda obs, it=it: next(it))
    return compute_udr(record["label_dataset"], fns,
                       np.random.RandomState(0), device=device,
                       **record["kwargs"])


if __name__ == "__main__":
    main()
