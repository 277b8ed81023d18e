"""Mutual Information Gap (Chen et al. 2018).

A copy of ``encdiff_tpu/evalx/metrics/mig.py:16-32``: histogram-discretize
the codes (20 bins), compute the discrete MI matrix, and MIG = the mean
over factors of (top-1 - top-2 MI) / H(factor).
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.metrics import utils


def _compute_mig(mus_train, ys_train, num_bins=20):
    discretized = utils.histogram_discretize(mus_train, num_bins=num_bins)
    m = utils.discrete_mutual_info(discretized, ys_train)
    entropy = utils.discrete_entropy(ys_train)
    sorted_m = np.sort(m, axis=0)[::-1]
    return {"discrete_mig": np.mean(
        np.divide(sorted_m[0, :] - sorted_m[1, :], entropy[:]))}


def compute_mig(ground_truth_data, representation_function, random_state,
                artifact_dir=None, num_train=10000, batch_size=16,
                num_bins=20):
    del artifact_dir
    mus_train, ys_train = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_train, random_state,
        batch_size)
    return _compute_mig(mus_train, ys_train, num_bins=num_bins)
