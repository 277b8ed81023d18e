"""FactorVAE score (Kim & Mnih 2018).

A copy of ``encdiff_tpu/evalx/metrics/factor_vae.py:21-85``: estimate the
global per-dimension variances, prune collapsed dimensions, then
majority-vote a classifier from (fixed-factor minibatch -> argmin of the
normalised variance) pairs, every vote minibatch sampled at once as one
(P, B, F) array. The ``RandomState`` is consumed in the JAX package's
order (variances, then the train votes, then the eval votes), so both
packages cast the same votes. ``num_active_dims`` is the length of the
pruning mask, every dimension, as in the reference.
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.metrics import utils


def _prune_dims(variances, threshold=0.0):
    return np.sqrt(variances) >= threshold


def _compute_variances(ground_truth_data, representation_function, num_points,
                       random_state, eval_batch_size=64):
    obs = ground_truth_data.sample_observations(num_points, random_state)
    reps = utils.obtain_representation(obs, representation_function,
                                       eval_batch_size).T
    return np.var(reps, axis=0, ddof=1)


def _vectorized_votes(ground_truth_data, representation_function, batch_size,
                      num_points, random_state, global_variances, active_dims):
    num_factors = ground_truth_data.num_factors
    factor_index = random_state.randint(num_factors, size=num_points)
    factors = utils.sample_factor_batches(ground_truth_data, num_points,
                                          batch_size, random_state)
    # fix the chosen factor across each minibatch
    factors[:, :, :] = np.where(
        (np.arange(factors.shape[2])[None, None, :] == factor_index[:, None, None]),
        factors[:, :1, :], factors)
    obs = utils.observations_from_factor_batches(ground_truth_data, factors,
                                                 random_state)
    P, B = num_points, batch_size
    reps = np.asarray(representation_function(
        obs.reshape(P * B, *obs.shape[2:]))).reshape(P, B, -1)
    local_var = np.var(reps, axis=1, ddof=1)  # (P, D)
    argmin = np.argmin(local_var[:, active_dims]
                       / global_variances[active_dims][None, :], axis=1)
    votes = np.zeros((num_factors, global_variances.shape[0]), dtype=np.int64)
    np.add.at(votes, (factor_index, argmin), 1)
    return votes


def compute_factor_vae(ground_truth_data, representation_function,
                       random_state, artifact_dir=None, batch_size=64,
                       num_train=10000, num_eval=5000,
                       num_variance_estimate=10000, prune_threshold=0.0):
    del artifact_dir
    global_variances = _compute_variances(
        ground_truth_data, representation_function, num_variance_estimate,
        random_state)
    active_dims = _prune_dims(global_variances, threshold=prune_threshold)
    scores = {}
    if not active_dims.any():
        return {"train_accuracy": 0.0, "eval_accuracy": 0.0,
                "num_active_dims": 0}

    train_votes = _vectorized_votes(
        ground_truth_data, representation_function, batch_size, num_train,
        random_state, global_variances, active_dims)
    classifier = np.argmax(train_votes, axis=0)
    other_index = np.arange(train_votes.shape[1])
    scores["train_accuracy"] = (
        np.sum(train_votes[classifier, other_index]) / np.sum(train_votes))

    eval_votes = _vectorized_votes(
        ground_truth_data, representation_function, batch_size, num_eval,
        random_state, global_variances, active_dims)
    scores["eval_accuracy"] = (
        np.sum(eval_votes[classifier, other_index]) / np.sum(eval_votes))
    scores["num_active_dims"] = int(len(active_dims))
    return scores
