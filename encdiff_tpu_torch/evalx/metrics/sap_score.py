"""SAP score (Kumar et al. 2018).

A port of ``encdiff_tpu/evalx/metrics/sap_score.py``: per (code, factor)
predictability matrix, R² for continuous factors (vectorised over every
pair, numpy on the host) or the balanced linear SVC's test accuracy for
discrete ones (``svm.py``: every code of a factor fitted in one batch on
``device``, liblinear's seeds drawn from numpy's global state code by code
and factor by factor, as the JAX package's loop fits them); the score is
the mean gap between the two most predictive codes of each factor.
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.metrics import svm, utils


def compute_sap(ground_truth_data, representation_function, random_state,
                artifact_dir=None, num_train=10000, num_test=5000,
                batch_size=16, continuous_factors=True, device="cpu"):
    del artifact_dir
    mus, ys = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_train, random_state,
        batch_size)
    mus_test, ys_test = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_test, random_state,
        batch_size)
    return _compute_sap(mus, ys, mus_test, ys_test, continuous_factors,
                        device=device)


def _compute_sap(mus, ys, mus_test, ys_test, continuous_factors,
                 device="cpu"):
    score_matrix = compute_score_matrix(mus, ys, mus_test, ys_test,
                                        continuous_factors, device=device)
    assert score_matrix.shape == (mus.shape[0], ys.shape[0])
    return {"SAP_score": compute_avg_diff_top_two(score_matrix)}


def compute_score_matrix(mus, ys, mus_test, ys_test, continuous_factors,
                         device="cpu"):
    num_latents, num_factors = mus.shape[0], ys.shape[0]
    if continuous_factors:
        # vectorized R^2: cov(mu_i, y_j)^2 / (var mu_i * var y_j)
        mu_c = mus - mus.mean(axis=1, keepdims=True)
        y_c = ys - ys.mean(axis=1, keepdims=True)
        n = mus.shape[1]
        cov = (mu_c @ y_c.T) / (n - 1)                     # (D, F)
        var_mu = mu_c.var(axis=1, ddof=1)[:, None]
        var_y = y_c.var(axis=1, ddof=1)[None, :]
        score = np.where(var_mu > 1e-12, cov**2 / (var_mu * var_y), 0.0)
        return score
    for _ in range(num_latents * num_factors):
        svm.draw_seed()
    score = np.zeros([num_latents, num_factors])
    for j in range(num_factors):
        classifier = svm.OneFeatureSVC(device=device).fit(mus, ys[j, :])
        pred = classifier.predict(mus_test)
        score[:, j] = np.mean(pred == ys_test[j, :][None, :], axis=1)
    return score


def compute_avg_diff_top_two(matrix):
    sorted_matrix = np.sort(matrix, axis=0)
    return np.mean(sorted_matrix[-1, :] - sorted_matrix[-2, :])
