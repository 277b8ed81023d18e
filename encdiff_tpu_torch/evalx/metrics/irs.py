"""Interventional Robustness Score (Suter et al. 2019).

A copy of ``encdiff_tpu/evalx/metrics/irs.py``: numpy on the host
(``np.percentile``, linear), over histogram-discretised factors.
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.metrics import utils


def compute_irs(ground_truth_data, representation_function, random_state,
                artifact_dir=None, diff_quantile=0.99, num_train=10000,
                batch_size=16, num_bins=20):
    del artifact_dir
    mus, ys = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_train, random_state,
        batch_size)
    ys_discrete = utils.make_discretizer(ys, num_bins=num_bins)
    active_mus = _drop_constant_dims(mus)
    if not active_mus.any():
        irs = 0.0
    else:
        irs = scalable_disentanglement_score(
            ys_discrete.T, active_mus.T, diff_quantile)["avg_score"]
    return {"IRS": irs, "num_active_dims": int(np.sum(active_mus.shape[0]))}


def _drop_constant_dims(ys):
    ys = np.asarray(ys)
    return ys[ys.var(axis=1) > 0.0, :]


def scalable_disentanglement_score(gen_factors, latents, diff_quantile=0.99):
    """EMPIDA-style per-(latent, factor) robustness matrix."""
    num_gen = gen_factors.shape[1]
    num_lat = latents.shape[1]
    max_deviations = np.max(np.abs(latents - latents.mean(axis=0)), axis=0)
    cum_deviations = np.zeros([num_lat, num_gen])
    for i in range(num_gen):
        unique_factors = np.unique(gen_factors[:, i])
        for val in unique_factors:
            match = gen_factors[:, i] == val
            e_loc = np.mean(latents[match, :], axis=0)
            diffs = np.abs(latents[match, :] - e_loc)
            cum_deviations[:, i] += np.percentile(diffs, diff_quantile * 100,
                                                  axis=0)
        cum_deviations[:, i] /= unique_factors.shape[0]
    normalized = cum_deviations / max_deviations[:, np.newaxis]
    irs_matrix = 1.0 - normalized
    disent_scores = irs_matrix.max(axis=1)
    if np.sum(max_deviations) > 0.0:
        avg_score = np.average(disent_scores, weights=max_deviations)
    else:
        avg_score = np.mean(disent_scores)
    return {
        "disentanglement_scores": disent_scores,
        "avg_score": avg_score,
        "parents": irs_matrix.argmax(axis=1),
        "IRS_matrix": irs_matrix,
        "max_deviations": max_deviations,
    }
