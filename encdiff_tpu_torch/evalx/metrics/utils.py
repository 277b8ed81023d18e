"""Metric utilities: the numpy part of ``encdiff_tpu/evalx/metrics/utils.py``.

Copies of ``generate_batch_factor_code``, ``obtain_representation``,
``split_train_test``, ``histogram_discretize``, ``discrete_mutual_info``,
``discrete_entropy``, ``normalize_data``, ``sample_factor_batches`` and
``observations_from_factor_batches`` (:20-87, 116-131). The JAX package
takes the mutual information from ``sklearn.metrics.mutual_info_score``;
the port keeps no sklearn, so ``mutual_info_score`` below computes the same
expression (natural log) from the dense contingency table, visiting its
non-zero cells in the row-major order sklearn's sparse table gives. The
predictor registry (:90-113) returns the port's gradient boosting
(``gbt.py``); the cross-validated logistic regression is not ported.
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.metrics import gbt


def mutual_info_score(labels_true, labels_pred) -> float:
    """I(labels_true; labels_pred) in nats, as sklearn computes it."""
    classes, class_idx = np.unique(np.asarray(labels_true),
                                   return_inverse=True)
    clusters, cluster_idx = np.unique(np.asarray(labels_pred),
                                      return_inverse=True)
    if classes.size == 1 or clusters.size == 1:
        return 0.0
    contingency = np.zeros((classes.size, clusters.size), np.int64)
    np.add.at(contingency, (class_idx.ravel(), cluster_idx.ravel()), 1)
    nzx, nzy = np.nonzero(contingency)
    nz_val = contingency[nzx, nzy]
    contingency_sum = contingency.sum()
    pi = contingency.sum(axis=1)
    pj = contingency.sum(axis=0)
    log_contingency_nm = np.log(nz_val)
    contingency_nm = nz_val / contingency_sum
    outer = pi.take(nzx) * pj.take(nzy)
    log_outer = -np.log(outer) + np.log(pi.sum()) + np.log(pj.sum())
    mi = (contingency_nm * (log_contingency_nm - np.log(contingency_sum))
          + contingency_nm * log_outer)
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def generate_batch_factor_code(ground_truth_data, representation_function,
                               num_points, random_state, batch_size):
    """Returns (codes (D, N), factors (F, N)) — transposed dlib convention."""
    reps, factors = [], []
    i = 0
    while i < num_points:
        n = min(num_points - i, batch_size)
        f, obs = ground_truth_data.sample(n, random_state)
        factors.append(f)
        reps.append(np.asarray(representation_function(obs)))
        i += n
    return np.vstack(reps).T, np.vstack(factors).T


def obtain_representation(observations, representation_function, batch_size):
    """(N, ...) observations -> (D, N) codes."""
    reps = []
    for i in range(0, observations.shape[0], batch_size):
        reps.append(np.asarray(
            representation_function(observations[i:i + batch_size])))
    return np.vstack(reps).T


def split_train_test(observations, train_percentage):
    n = observations.shape[1]
    n_train = int(np.ceil(n * train_percentage))
    return observations[:, :n_train], observations[:, n_train:]


def histogram_discretize(target, num_bins=20):
    """Per-row histogram discretization."""
    target = np.asarray(target)
    out = np.zeros_like(target, dtype=np.int64)
    for i in range(target.shape[0]):
        out[i, :] = np.digitize(
            target[i, :], np.histogram(target[i, :], num_bins)[1][:-1])
    return out


def discrete_mutual_info(mus, ys):
    """Pairwise discrete MI matrix (num_codes, num_factors), in nats."""
    num_codes, num_factors = mus.shape[0], ys.shape[0]
    m = np.zeros([num_codes, num_factors])
    for i in range(num_codes):
        for j in range(num_factors):
            m[i, j] = mutual_info_score(ys[j, :], mus[i, :])
    return m


def discrete_entropy(ys):
    num_factors = ys.shape[0]
    h = np.zeros(num_factors)
    for j in range(num_factors):
        h[j] = mutual_info_score(ys[j, :], ys[j, :])
    return h


def normalize_data(data, mean=None, stddev=None):
    if mean is None:
        mean = np.mean(data, axis=1)
    if stddev is None:
        stddev = np.std(data, axis=1)
    return (data - mean[:, np.newaxis]) / stddev[:, np.newaxis], mean, stddev


def logistic_regression_cv():
    """dlib's predictor: ``LogisticRegressionCV`` over 10 folds."""
    raise NotImplementedError(
        "logistic_regression_cv (LogisticRegressionCV, 10 folds over a C "
        "grid) is not ported: ROADMAP queue 1 #16")


def gradient_boosting_classifier(device="cpu"):
    return gbt.GradientBoostingClassifier(device=device)


def make_predictor_fn(predictor: str = "gradient_boosting"):
    """Predictor registry (the reference binds
    gradient_boosting_classifier)."""
    if predictor == "gradient_boosting":
        return gradient_boosting_classifier
    if predictor == "logistic_regression_cv":
        return logistic_regression_cv
    raise ValueError(f"unknown predictor {predictor!r}")


def sample_factor_batches(ground_truth_data, num_points, batch_size,
                          random_state):
    """(P, B, F) latent factor batches in one shot — factors are iid across
    rows, so one flat sample_factors call reshapes into P minibatches."""
    P, B = num_points, batch_size
    flat = ground_truth_data.sample_factors(P * B, random_state)
    return flat.reshape(P, B, flat.shape[-1])


def observations_from_factor_batches(ground_truth_data, factors,
                                     random_state):
    """factors (P, B, F) -> observations (P, B, ...)."""
    P, B, F = factors.shape
    obs = ground_truth_data.sample_observations_from_factors(
        factors.reshape(P * B, F), random_state)
    return obs.reshape(P, B, *np.shape(obs)[1:])
