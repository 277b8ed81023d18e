"""Fairness of downstream predictions under interventions on the other
factors (Locatello et al. 2019).

A port of ``encdiff_tpu/evalx/metrics/fairness.py``: a predictor a factor
(the port's gradient-boosted trees on ``device``, every factor's fit in one
batch, their seeds drawn from numpy's global state in the JAX package's
order), then, for each other factor, the predictions on points whose
factor is set to each of its values in turn. The observations of every
value are drawn first, in the JAX package's order, and predicted in one
call.
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.metrics import utils


def compute_fairness(ground_truth_data, representation_function, random_state,
                     artifact_dir=None, num_train=10000,
                     num_test_points_per_class=100, batch_size=16,
                     predictor="gradient_boosting", device="cpu"):
    del artifact_dir
    factor_counts = ground_truth_data.factors_num_values
    num_factors = len(factor_counts)
    mus_train, ys_train = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_train, random_state,
        batch_size)
    models = utils.fit_predictors(predictor, mus_train.T, ys_train, device)

    mean_fairness = np.zeros((num_factors, num_factors))
    max_fairness = np.zeros((num_factors, num_factors))
    for i in range(num_factors):
        model = models[i]
        for j in range(num_factors):
            if i == j:
                continue
            original = ground_truth_data.sample_factors(
                num_test_points_per_class, random_state)
            reps = []
            for c in range(factor_counts[j]):
                intervened = np.copy(original)
                intervened[:, j] = c
                obs = ground_truth_data.sample_observations_from_factors(
                    intervened, random_state)
                reps.append(utils.obtain_representation(
                    obs, representation_function, batch_size))
            predictions = model.predict(np.concatenate(reps, 1).T).reshape(
                factor_counts[j], -1)
            counts = np.zeros((factor_counts[i], factor_counts[j]),
                              dtype=np.int64)
            for c in range(factor_counts[j]):
                counts[:, c] = np.bincount(predictions[c],
                                           minlength=factor_counts[i])
            mean_fairness[i, j], max_fairness[i, j] = inter_group_fairness(
                counts)

    scores = {}
    scores.update(_scores_dict(mean_fairness, "mean_fairness"))
    scores.update(_scores_dict(max_fairness, "max_fairness"))
    return scores


def inter_group_fairness(counts):
    """Mean/max total variation between per-group prediction distributions
    and the pooled distribution."""
    counts = counts.astype(np.float64)
    overall = counts.sum(axis=1) / counts.sum()
    tvs = []
    weights = []
    for j in range(counts.shape[1]):
        col = counts[:, j]
        if col.sum() == 0:
            continue
        dist = col / col.sum()
        tvs.append(0.5 * np.sum(np.abs(dist - overall)))
        weights.append(col.sum())
    tvs = np.asarray(tvs)
    weights = np.asarray(weights) / np.sum(weights)
    return np.sum(tvs * weights), np.max(tvs)


def _scores_dict(metric, prefix):
    result = {}
    n = metric.shape[0]
    for i in range(n):
        for j in range(n):
            if i != j:
                result[f"{prefix}:pred{i}:sens{j}"] = metric[i, j]
    row_means, row_maxs = [], []
    for i in range(n):
        rel = [metric[i, j] for j in range(n) if i != j]
        result[f"{prefix}:pred{i}:mean_sens"] = np.mean(rel)
        result[f"{prefix}:pred{i}:max_sens"] = np.max(rel)
        row_means.append(np.mean(rel))
        row_maxs.append(np.max(rel))
    result[f"{prefix}:mean_pred:mean_sens"] = np.mean(row_means)
    result[f"{prefix}:mean_pred:max_sens"] = np.mean(row_maxs)
    result[f"{prefix}:max_pred:mean_sens"] = np.max(row_means)
    result[f"{prefix}:max_pred:max_sens"] = np.max(row_maxs)
    return result
