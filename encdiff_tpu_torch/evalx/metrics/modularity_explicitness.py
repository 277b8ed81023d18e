"""Modularity and explicitness (Ridgeway & Mozer 2018).

A port of ``encdiff_tpu/evalx/metrics/modularity_explicitness.py``: the
modularity from the discrete mutual information of histogram-discretised
codes (numpy on the host), the explicitness as the one-vs-rest ROC-AUC of
a logistic regression per factor (``logistic.py``, fitted on ``device``).

The factor is binarised as the reference's ``disentanglement_lib`` does,
by ``MultiLabelBinarizer``: one column per class, two for a factor of two
values. The JAX package calls ``label_binarize``, which gives a factor of
two values one column against ``predict_proba``'s two, and sklearn's
``roc_auc_score`` then raises; wherever the JAX function runs (three
values or more) the two binarisations are the same.
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.metrics import preprocessing, utils
from encdiff_tpu_torch.evalx.metrics.logistic import LogisticRegression


def compute_modularity_explicitness(ground_truth_data,
                                    representation_function, random_state,
                                    artifact_dir=None, num_train=10000,
                                    num_test=5000, batch_size=16,
                                    num_bins=20, device="cpu"):
    del artifact_dir
    mus_train, ys_train = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_train, random_state,
        batch_size)
    mus_test, ys_test = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_test, random_state,
        batch_size)
    discretized = utils.make_discretizer(mus_train, num_bins=num_bins)
    mi = utils.discrete_mutual_info(discretized, ys_train)
    scores = {"modularity_score": modularity(mi)}

    expl_train = np.zeros(ys_train.shape[0])
    expl_test = np.zeros(ys_test.shape[0])
    mus_train_norm, mean, std = utils.normalize_data(mus_train)
    mus_test_norm, _, _ = utils.normalize_data(mus_test, mean, std)
    for i in range(ys_train.shape[0]):
        expl_train[i], expl_test[i] = explicitness_per_factor(
            mus_train_norm, ys_train[i, :], mus_test_norm, ys_test[i, :],
            device=device)
    scores["explicitness_score_train"] = np.mean(expl_train)
    scores["explicitness_score_test"] = np.mean(expl_test)
    return scores


def explicitness_per_factor(mus_train, y_train, mus_test, y_test,
                            device="cpu"):
    """One-vs-rest logistic regression ROC-AUC, train and test."""
    clf = LogisticRegression(device=device).fit(mus_train.T, y_train)
    classes = clf.classes_
    y_train_bin = preprocessing.multilabel_binarize(y_train, classes)
    y_test_bin = preprocessing.multilabel_binarize(y_test, classes)
    roc_train = preprocessing.roc_auc_score(
        y_train_bin, clf.predict_proba(mus_train.T))
    roc_test = preprocessing.roc_auc_score(
        y_test_bin, clf.predict_proba(mus_test.T))
    return roc_train, roc_test


def modularity(mutual_information):
    """1 - normalized off-max squared MI per code, averaged."""
    squared_mi = np.square(mutual_information)
    max_squared = np.max(squared_mi, axis=1)
    numerator = np.sum(squared_mi, axis=1) - max_squared
    denominator = max_squared * (squared_mi.shape[1] - 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        delta = numerator / denominator
    score = 1.0 - delta
    score[max_squared == 0.0] = 0.0
    return np.mean(score)
