"""β-VAE disentanglement metric (Higgins et al. 2017).

A port of ``encdiff_tpu/evalx/metrics/beta_vae.py``: pick a random factor,
sample two minibatches with that factor pinned equal, feature = mean |z1 -
z2|; a logistic regression predicts the pinned factor. The ``RandomState``
is consumed in the JAX package's order (labels, the two factor batches,
their observations; train points, then eval points).
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.metrics import utils
from encdiff_tpu_torch.evalx.metrics.logistic import LogisticRegression


def _generate_training_batch(ground_truth_data, representation_function,
                             batch_size, num_points, random_state):
    num_factors = ground_truth_data.num_factors
    labels = random_state.randint(num_factors, size=num_points)
    f1 = utils.sample_factor_batches(ground_truth_data, num_points,
                                     batch_size, random_state)
    f2 = utils.sample_factor_batches(ground_truth_data, num_points,
                                     batch_size, random_state)
    # pin the chosen factor: f2[p, :, labels[p]] = f1[p, :, labels[p]]
    mask = (np.arange(f1.shape[2])[None, None, :]
            == labels[:, None, None])
    f2 = np.where(mask, f1, f2)
    o1 = utils.observations_from_factor_batches(ground_truth_data, f1,
                                                random_state)
    o2 = utils.observations_from_factor_batches(ground_truth_data, f2,
                                                random_state)
    P, B = num_points, batch_size
    r1 = np.asarray(representation_function(
        o1.reshape(P * B, *o1.shape[2:]))).reshape(P, B, -1)
    r2 = np.asarray(representation_function(
        o2.reshape(P * B, *o2.shape[2:]))).reshape(P, B, -1)
    points = np.mean(np.abs(r1 - r2), axis=1)  # (P, D)
    return points, labels


def compute_beta_vae_sklearn(ground_truth_data, representation_function,
                             random_state, artifact_dir=None, batch_size=64,
                             num_train=10000, num_eval=5000, device="cpu"):
    """The JAX package's name, kept so that a reader finds the counterpart:
    no sklearn is involved. The predictor is ``logistic.py``'s port of
    sklearn's ``LogisticRegression``, fitted on ``device``."""
    del artifact_dir
    train_points, train_labels = _generate_training_batch(
        ground_truth_data, representation_function, batch_size, num_train,
        random_state)
    model = LogisticRegression(random_state=random_state, device=device)
    model.fit(train_points, train_labels)
    train_accuracy = np.mean(model.predict(train_points) == train_labels)

    eval_points, eval_labels = _generate_training_batch(
        ground_truth_data, representation_function, batch_size, num_eval,
        random_state)
    eval_accuracy = model.score(eval_points, eval_labels)
    return {"train_accuracy": train_accuracy, "eval_accuracy": eval_accuracy}
