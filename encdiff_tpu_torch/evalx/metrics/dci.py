"""DCI: Disentanglement / Completeness / Informativeness (Eastwood &
Williams 2018).

A port of ``encdiff_tpu/evalx/metrics/dci.py``: per-factor gradient
boosted trees give a (codes x factors) importance matrix; D and C are 1 -
the entropy of the normalised importances, importance-weighted; the
informativeness is the predictors' mean accuracy. The trees are
``gbt.py``'s port of sklearn's ``GradientBoostingClassifier()`` (100
stages, 20 for ``gradient_boosting_fast``), every factor's fit in one
batch on ``device``; their seeds come from numpy's global ``RandomState``,
as sklearn's do. ``random_forest`` is not ported.
"""

from __future__ import annotations

import numpy as np
import scipy.stats

from encdiff_tpu_torch.evalx.metrics import gbt, utils

#: boosting stages of each predictor
STAGES = utils.GBT_STAGES


def compute_dci(ground_truth_data, representation_function, random_state,
                artifact_dir=None, num_train=10000, num_test=5000,
                batch_size=16, predictor="gradient_boosting", device="cpu"):
    del artifact_dir
    mus_train, ys_train = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_train, random_state,
        batch_size)
    mus_test, ys_test = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_test, random_state,
        batch_size)
    return _compute_dci(mus_train, ys_train, mus_test, ys_test,
                        predictor=predictor, device=device)


def _compute_dci(mus_train, ys_train, mus_test, ys_test,
                 predictor="gradient_boosting", device="cpu"):
    importance_matrix, train_err, test_err = compute_importance_gbt(
        mus_train, ys_train, mus_test, ys_test, predictor=predictor,
        device=device)
    return {
        "informativeness_train": train_err,
        "informativeness_test": test_err,
        "disentanglement": disentanglement(importance_matrix),
        "completeness": completeness(importance_matrix),
        "importance_matrix": np.round(importance_matrix, 4).tolist(),
    }


def compute_importance_gbt(x_train, y_train, x_test, y_test,
                           predictor="gradient_boosting", device="cpu"):
    """Per-factor tree ensembles -> |feature importance| matrix."""
    if predictor == "random_forest":
        raise NotImplementedError(
            "DCI's random_forest predictor (RandomForestClassifier with "
            "bootstrap draws over n_jobs=-1 and no seed) is not ported: "
            "ROADMAP queue 1 #16")
    if predictor not in STAGES:
        raise ValueError(predictor)
    num_factors = y_train.shape[0]
    num_codes = x_train.shape[0]
    importance_matrix = np.zeros([num_codes, num_factors], dtype=np.float64)
    models = gbt.fit_many(x_train.T, list(y_train),
                          n_estimators=STAGES[predictor], device=device)
    train_acc, test_acc = [], []
    for i, model in enumerate(models):
        importance_matrix[:, i] = np.abs(model.feature_importances_)
        train_acc.append(np.mean(model.predict(x_train.T) == y_train[i, :]))
        test_acc.append(np.mean(model.predict(x_test.T) == y_test[i, :]))
    return importance_matrix, np.mean(train_acc), np.mean(test_acc)


def disentanglement_per_code(importance_matrix):
    return 1.0 - scipy.stats.entropy(importance_matrix.T + 1e-11,
                                     base=importance_matrix.shape[1])


def disentanglement(importance_matrix):
    per_code = disentanglement_per_code(importance_matrix)
    if importance_matrix.sum() == 0.0:
        importance_matrix = np.ones_like(importance_matrix)
    code_importance = importance_matrix.sum(axis=1) / importance_matrix.sum()
    return np.sum(per_code * code_importance)


def completeness_per_factor(importance_matrix):
    return 1.0 - scipy.stats.entropy(importance_matrix + 1e-11,
                                     base=importance_matrix.shape[0])


def completeness(importance_matrix):
    per_factor = completeness_per_factor(importance_matrix)
    if importance_matrix.sum() == 0.0:
        importance_matrix = np.ones_like(importance_matrix)
    factor_importance = importance_matrix.sum(axis=0) / importance_matrix.sum()
    return np.sum(per_factor * factor_importance)
