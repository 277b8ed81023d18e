"""The in-training disentanglement metric driver.

Counterpart of ``encdiff_tpu/evalx/eval_driver.py`` (``eval_func``,
``reduce_tokens_pca1``): given the ground-truth index dataset and an (N,
latent_unit) representation array, or an (N, U, D) token array reduced to
one scalar a token by per-token PCA(1), run the metric battery (β-VAE, DCI,
MIG, FactorVAE, at the reference protocol's sizes) and write
``<step>.json`` in the JAX package's layout. The representation function
is index lookup (``reps[indices]``).

MIG and FactorVAE are numpy on the host. DCI's gradient-boosted trees and
β-VAE's logistic regression (``metrics/gbt.py``, ``metrics/logistic.py``:
ports of the sklearn predictors the JAX package fits) and the PCA run in
torch on ``device``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import scipy.linalg
import torch

from encdiff_tpu_torch.evalx.metrics import (
    compute_beta_vae_sklearn, compute_dci, compute_factor_vae, compute_mig)

METRICS = ("beta_VAE", "dci", "MIG", "factor_VAE")


def reduce_tokens_pca1(reps, device="cpu") -> np.ndarray:
    """(N, U, D) token reps -> (N, U) float64 scalars, sklearn's
    ``PCA(n_components=1).fit_transform`` per token, by the solver its
    ``auto`` policy picks: for N >= 10 D (and D <= 1000) the covariance's
    eigenvectors, for max(N, D) <= 500 an SVD of the centred data (both in
    torch on ``device``), else ``_randomized_svd`` (``randomized_pca1``,
    scipy on the host, drawing from numpy's global ``RandomState`` token by
    token). ``svd_flip`` makes the largest loading of the component
    positive."""
    if not isinstance(reps, torch.Tensor):
        reps = np.asarray(reps)
    n, u, d = reps.shape
    if not (d <= 1000 and n >= 10 * d) and max(n, d) > 500:
        host = np.asarray(reps.cpu() if isinstance(reps, torch.Tensor)
                          else reps)
        out = np.zeros((n, u), dtype=np.float64)
        for i in range(u):
            out[:, i] = randomized_pca1(host[:, i, :])
        return out
    x = torch.as_tensor(np.asarray(reps, np.float64) if not isinstance(
        reps, torch.Tensor) else reps).to(torch.device(device), torch.float64)
    mean = x.mean(0)                                            # (U, D)
    if d <= 1000 and n >= 10 * d:
        xt = x.transpose(0, 1)                                  # (U, N, D)
        cov = xt.transpose(1, 2) @ xt - n * mean[:, :, None] * mean[:, None, :]
        cov = cov / (n - 1)
        comp = torch.linalg.eigh(cov).eigenvectors[..., -1]    # (U, D)
    else:
        comp = torch.linalg.svd((x - mean).transpose(0, 1),
                                full_matrices=False).Vh[:, 0]
    top = comp.abs().argmax(-1, keepdim=True)
    comp = comp * torch.sign(comp.gather(-1, top))
    out = (x * comp).sum(-1) - (mean * comp).sum(-1)
    return out.cpu().numpy()


def randomized_pca1(x: np.ndarray) -> np.ndarray:
    """One token's ``PCA(n_components=1, svd_solver="randomized")
    .fit_transform`` as sklearn 1.9 computes it (``_pca.py:_fit_truncated``,
    ``utils/extmath.py:_randomized_svd`` and ``_randomized_range_finder``),
    in the input's dtype: 1 + 10 oversamples drawn from numpy's global
    ``RandomState``, ``n_iter`` "auto" (7 below a tenth of the smaller
    side, else 4), the power iterations normalised by LU (by nothing at 2
    or fewer), a QR at the end, an SVD of the projection, ``svd_flip`` on
    the component, and the scores U S."""
    x = np.asarray(x)
    centred = x - np.mean(x, axis=0)
    n_random = 1 + 10
    n_iter = 7 if 1 < 0.1 * min(centred.shape) else 4
    transpose = centred.shape[0] < centred.shape[1]
    m = centred.T if transpose else centred
    q = np.random.mtrand._rand.normal(size=(m.shape[1], n_random))
    if m.dtype == np.float32:
        q = q.astype(np.float32, copy=False)
    if n_iter <= 2:
        normalizer = lambda a: (a, None)  # noqa: E731
    else:
        normalizer = lambda a: scipy.linalg.lu(  # noqa: E731
            a, permute_l=True, check_finite=False)
    for _ in range(n_iter):
        q, _ = normalizer(m @ q)
        q, _ = normalizer(m.T @ q)
    q, _ = scipy.linalg.qr(m @ q, mode="economic", check_finite=False)
    uhat, s, vt = scipy.linalg.svd(q.T @ m, full_matrices=False,
                                   lapack_driver="gesdd")
    u = q @ uhat
    if transpose:
        u, s, vt = vt[:1].T, s[:1], u[:, :1].T
    else:
        u, s, vt = u[:, :1], s[:1], vt[:1]
    sign = np.sign(vt[0, np.argmax(np.abs(vt[0]))])
    return (u[:, 0] * sign) * s[0]


def eval_func(label_dataset, reps, save_path: str | None, step: int,
              preflix: str = "", seed: int = 0,
              dci_predictor: str = "gradient_boosting", metrics=METRICS,
              budget: str = "full", device="cuda",
              timings: dict | None = None) -> dict:
    """Run the metric battery and write ``<save_path>/<preflix><step>.json``.

    β-VAE: batch 64, 10,000 train and 5,000 eval points; DCI: 10,000 train
    and 5,000 test points and 100 boosting stages, or at ``budget="fast"``
    (the in-training tier) 2,500 and 1,250 points and 20 stages, tagged
    ``"dci_budget": "fast"``; MIG: 10,000 points, 20 bins; FactorVAE: batch
    64, 10,000 train and 5,000 eval votes, 10,000 points for the variances,
    prune threshold 0.05. Each draws from ``RandomState(seed)``. DCI's and
    β-VAE's predictors and the token PCA run on ``device``. ``timings``,
    when given, receives each metric's seconds."""
    unknown = set(metrics) - set(METRICS)
    if unknown:
        raise ValueError(f"unknown metrics {sorted(unknown)}; the port "
                         f"scores {METRICS}")
    reps = np.asarray(reps)
    if reps.ndim == 3:
        reps = reduce_tokens_pca1(reps, device)
    if reps.ndim != 2:
        raise ValueError(f"reps must be (N, latent_unit) or (N, U, D), got "
                         f"{reps.shape}")

    def representation_function(obs):
        # observations are integer indices (the index-lookup trick)
        return reps[np.asarray(obs, dtype=np.int64)]

    fast = budget == "fast"
    if fast and dci_predictor == "gradient_boosting":
        dci_predictor = "gradient_boosting_fast"
    battery = {
        "beta_VAE": lambda: compute_beta_vae_sklearn(
            label_dataset, representation_function,
            np.random.RandomState(seed), batch_size=64, num_train=10000,
            num_eval=5000, device=device),
        "dci": lambda: compute_dci(
            label_dataset, representation_function,
            np.random.RandomState(seed),
            num_train=2500 if fast else 10000,
            num_test=1250 if fast else 5000,
            predictor=dci_predictor, device=device),
        "MIG": lambda: compute_mig(
            label_dataset, representation_function,
            np.random.RandomState(seed), num_train=10000, num_bins=20),
        "factor_VAE": lambda: compute_factor_vae(
            label_dataset, representation_function,
            np.random.RandomState(seed), batch_size=64, num_train=10000,
            num_eval=5000, num_variance_estimate=10000, prune_threshold=0.05),
    }
    value_dict: dict[str, Any] = {}
    for name in METRICS:
        if name in metrics:
            t0 = time.perf_counter()
            value_dict[name] = battery[name]()
            if timings is not None:
                timings[name] = time.perf_counter() - t0
    if fast and "dci" in value_dict:
        value_dict["dci"]["dci_budget"] = "fast"

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
