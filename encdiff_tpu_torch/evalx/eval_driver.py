"""The in-training disentanglement metric driver.

Counterpart of ``encdiff_tpu/evalx/eval_driver.py:37-101`` (``eval_func``):
given the ground-truth index dataset and an (N, latent_unit) representation
array, run the metric battery at the reference protocol's sizes and write
``<step>.json`` in the JAX package's layout. The representation function
is index lookup (``reps[indices]``).

The port scores FactorVAE and MIG, which are numpy. DCI and β-VAE fit
sklearn predictors (gradient boosting, logistic regression) that no numpy
rewrite reproduces, and the machine with the card has no sklearn: asking
for them raises. Score them from the representations the harness writes
(``<logdir>/reps/<step>.npy``) with ``encdiff_tpu/evalx/eval_driver.py``
where sklearn is installed.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from encdiff_tpu_torch.evalx.metrics.factor_vae import compute_factor_vae
from encdiff_tpu_torch.evalx.metrics.mig import compute_mig

METRICS = ("MIG", "factor_VAE")
#: metrics of the JAX battery that need sklearn
SKLEARN_METRICS = ("beta_VAE", "dci")


def eval_func(label_dataset, reps: np.ndarray, save_path: str | None,
              step: int, preflix: str = "", seed: int = 0,
              metrics=METRICS) -> dict:
    """Run MIG (10,000 points, 20 bins) and FactorVAE (batch 64, 10,000
    train and 5,000 eval votes, 10,000 points for the variances, prune
    threshold 0.05), each from ``RandomState(seed)``, on ``reps`` (N, U),
    and write ``<save_path>/<preflix><step>.json``."""
    refused = [m for m in metrics if m in SKLEARN_METRICS]
    if refused:
        raise ValueError(
            f"{refused}: DCI and beta-VAE fit sklearn predictors, which the "
            "port does not have; score the representations the harness "
            "writes (<logdir>/reps/<step>.npy) with "
            "encdiff_tpu/evalx/eval_driver.py:eval_func where sklearn is "
            "installed")
    unknown = set(metrics) - set(METRICS)
    if unknown:
        raise ValueError(f"unknown metrics {sorted(unknown)}; the port "
                         f"scores {METRICS}")
    reps = np.asarray(reps)
    if reps.ndim != 2:
        raise ValueError(f"reps must be (N, latent_unit), got {reps.shape}")

    def representation_function(obs):
        # observations are integer indices (the index-lookup trick)
        return reps[np.asarray(obs, dtype=np.int64)]

    value_dict: dict[str, Any] = {}
    if "MIG" in metrics:
        value_dict["MIG"] = compute_mig(
            label_dataset, representation_function,
            np.random.RandomState(seed), num_train=10000, num_bins=20)
    if "factor_VAE" in metrics:
        value_dict["factor_VAE"] = compute_factor_vae(
            label_dataset, representation_function,
            np.random.RandomState(seed), batch_size=64, num_train=10000,
            num_eval=5000, num_variance_estimate=10000, prune_threshold=0.05)

    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        with open(os.path.join(save_path, f"{preflix}{step}.json"), "w") as f:
            json.dump(_to_jsonable(value_dict), f, indent=2)
    return value_dict


def _to_jsonable(obj):
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
