"""The representation-evaluation entry point: the metric registry.

The port of ``encdiff_tpu/evalx/evaluate.py``: a name -> metric registry
over the ported suite, scoring a representation function, or a
precomputed (N, D) representation array looked up by the dataset's
observation indices, against a named ground-truth dataset. The metrics
that fit a predictor (β-VAE's and MED's logistic regressions, DCI's,
downstream's and fairness's gradient-boosted trees, SAP's discrete SVM and
explicitness's logistic regression) fit it on ``device``; the others are
numpy on the host.

    from encdiff_tpu_torch.evalx.evaluate import evaluate_representation
    evaluate_representation("dci", "mpi3d", reps)                 # the card
    evaluate_representation("dci", "mpi3d", reps, device="cpu")   # the CPU

``evaluate_battery`` runs every name at one of two tiers: ``full``, the
registry's defaults (10,000 train and 5,000 test points, sklearn's 100
boosting stages, fairness at 100 points a class), or ``fast``, the
in-training tier's 2,500 and 1,250 points and 20 stages.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from encdiff_tpu_torch.core.device import resolve_device
from encdiff_tpu_torch.evalx.ground_truth import named_data

#: the metrics whose predictors run on ``device``
ON_DEVICE = frozenset({"dci", "beta_vae", "sap", "modularity", "med",
                       "downstream", "reduced_downstream", "fairness"})


#: the fast tier's sizes; the full tier passes none (the defaults)
FAST_POINTS, FAST_TEST = 2500, 1250
FAST_PREDICTOR = "gradient_boosting_fast"


def tier_kwargs(metric: str, tier: str = "full") -> dict:
    """The keyword arguments of ``metric`` at ``tier``."""
    if tier == "full":
        return {}
    if tier != "fast":
        raise ValueError(f"unknown tier {tier!r}: fast or full")
    n, m, p = FAST_POINTS, FAST_TEST, FAST_PREDICTOR
    return {
        "dci": dict(num_train=n, num_test=m, predictor=p),
        "factor_vae": dict(num_train=n, num_eval=m, num_variance_estimate=n),
        "beta_vae": dict(num_train=n, num_eval=m),
        "mig": dict(num_train=n),
        "sap": dict(num_train=n, num_test=m),
        "irs": dict(num_train=n),
        "modularity": dict(num_train=n, num_test=m),
        "fairness": dict(num_train=n, predictor=p),
        "unsupervised": dict(num_train=n),
        "downstream": dict(num_train=(n,), num_test=m, predictor=p),
        "reduced_downstream": dict(num_train=(n,), num_test=m, predictor=p),
        "med": dict(num_train=n, num_test=m),
    }[metric]


def _registry() -> dict[str, Callable]:
    from encdiff_tpu_torch.evalx import metrics as M

    return {
        "dci": M.compute_dci,
        "factor_vae": M.compute_factor_vae,
        "beta_vae": M.compute_beta_vae_sklearn,
        "mig": M.compute_mig,
        "sap": M.compute_sap,
        "irs": M.compute_irs,
        "modularity": M.compute_modularity_explicitness,
        "fairness": M.compute_fairness,
        "unsupervised": M.unsupervised_metrics,
        "downstream": M.compute_downstream_task,
        "reduced_downstream": M.compute_reduced_downstream_task,
        "med": M.compute_med,
    }


def available_metrics() -> list[str]:
    return sorted(_registry())


def evaluate_representation(
    metric: str,
    dataset_name: str,
    representation: Callable | np.ndarray,
    seed: int = 0,
    device="cuda",
    **metric_kwargs: Any,
) -> dict:
    """Run one metric on a representation over a named ground-truth
    dataset, its draws from ``RandomState(seed)``.

    ``representation`` is either a callable ``obs -> (B, D)`` or a
    precomputed ``(N, D)`` array indexed by the dataset's observation
    indices. A metric's predictor runs on ``device`` (the card unless the
    caller asks for the CPU; no CUDA raises)."""
    reg = _registry()
    if metric not in reg:
        raise ValueError(f"unknown metric {metric!r}; "
                         f"available: {available_metrics()}")
    dev = resolve_device(device)
    ds = named_data.get_index_dataset(dataset_name)
    if callable(representation):
        rep_fn = representation
    else:
        table = np.asarray(representation)

        def rep_fn(obs):
            return table[np.asarray(obs, dtype=np.int64)]

    if metric in ON_DEVICE:
        metric_kwargs = {"device": str(dev), **metric_kwargs}
    rng = np.random.RandomState(seed)
    return reg[metric](ds, rep_fn, rng, **metric_kwargs)


def evaluate_battery(dataset_name: str, representation, tier="full",
                     seed: int = 0, device="cuda", metrics=None,
                     timings: dict | None = None) -> dict:
    """Every registry metric (or those of ``metrics``) at ``tier``, each
    from ``RandomState(seed)`` on ``device``: {name: scores}.
    ``timings``, when given, receives each metric's seconds (on the card
    after a synchronisation)."""
    dev = resolve_device(device)
    out = {}
    for name in metrics or available_metrics():
        t0 = time.perf_counter()
        out[name] = evaluate_representation(name, dataset_name,
                                            representation, seed=seed,
                                            device=dev,
                                            **tier_kwargs(name, tier))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if timings is not None:
            timings[name] = time.perf_counter() - t0
    return out
