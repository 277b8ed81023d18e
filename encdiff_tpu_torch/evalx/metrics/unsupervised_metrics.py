"""Unsupervised scores: gaussian total correlation, gaussian Wasserstein
correlation and the average pairwise discrete mutual information.

A copy of ``encdiff_tpu/evalx/metrics/unsupervised_metrics.py``: numpy
and scipy on the host (``np.cov``, ``slogdet``, ``scipy.linalg.sqrtm``,
called without the ``disp`` argument newer scipy no longer takes).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from encdiff_tpu_torch.evalx.metrics import utils


def unsupervised_metrics(ground_truth_data, representation_function,
                         random_state, artifact_dir=None, num_train=10000,
                         batch_size=16, num_bins=20):
    del artifact_dir
    mus_train, _ = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_train, random_state,
        batch_size)
    num_codes = mus_train.shape[0]
    cov_mus = np.cov(mus_train)
    scores = {
        "gaussian_total_correlation": gaussian_total_correlation(cov_mus),
        "gaussian_wasserstein_correlation":
            gaussian_wasserstein_correlation(cov_mus),
    }
    scores["gaussian_wasserstein_correlation_norm"] = (
        scores["gaussian_wasserstein_correlation"] / np.sum(np.diag(cov_mus)))
    mus_discrete = utils.make_discretizer(mus_train, num_bins=num_bins)
    mi = utils.discrete_mutual_info(mus_discrete, mus_discrete)
    np.fill_diagonal(mi, 0)
    scores["mutual_info_score"] = np.sum(mi) / (num_codes**2 - num_codes)
    return scores


def gaussian_total_correlation(cov):
    """KL(N(0,cov) || prod marginals) = 0.5(sum log diag - logdet)."""
    return 0.5 * (np.sum(np.log(np.diag(cov))) - np.linalg.slogdet(cov)[1])


def gaussian_wasserstein_correlation(cov):
    sqrtm = scipy.linalg.sqrtm(cov * np.expand_dims(np.diag(cov), axis=1))
    return 2 * np.trace(cov) - 2 * np.trace(sqrtm)
