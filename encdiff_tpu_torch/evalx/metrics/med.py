"""MED and top-k MED: DCI-style scores over a mutual-information
importance matrix, with a logistic regression's informativeness.

A port of ``encdiff_tpu/evalx/metrics/med.py``: the importance is the
discrete mutual information of histogram-discretised codes, normalised per
factor (numpy on the host); the codes are standardised (``preprocessing.
StandardScaler``) and one logistic regression a factor (``logistic.py``,
on ``device``) gives the train and test accuracies; D and C are DCI's.
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.metrics import preprocessing, utils
from encdiff_tpu_torch.evalx.metrics.dci import (
    completeness, disentanglement, disentanglement_per_code)
from encdiff_tpu_torch.evalx.metrics.logistic import LogisticRegression


def compute_med(ground_truth_data, representation_function, random_state,
                artifact_dir=None, num_train=10000, num_test=5000,
                batch_size=16, topk=-1, num_bins=20, device="cpu"):
    del artifact_dir
    mus_train, ys_train = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_train, random_state,
        batch_size)
    mus_test, ys_test = utils.generate_batch_factor_code(
        ground_truth_data, representation_function, num_test, random_state,
        batch_size)
    return _compute_med(mus_train, ys_train, mus_test, ys_test, topk,
                        num_bins=num_bins, device=device)


def _compute_med(mus_train, ys_train, mus_test, ys_test, topk, num_bins=20,
                 device="cpu"):
    importance, train_err, test_err = compute_importance_mi(
        mus_train, ys_train, mus_test, ys_test, num_bins=num_bins,
        device=device)
    scores = {
        "informativeness_train": train_err,
        "informativeness_test": test_err,
        "disentanglement": disentanglement(importance),
        "completeness": completeness(importance),
    }
    if topk > 0:
        pick = pick_by_dis_per_factor(importance, topk)
        reduced = importance[pick, :]
        scores[f"top{topk}_disentanglement"] = disentanglement(reduced)
        scores[f"top{topk}_completeness"] = completeness(reduced)
    return scores


def compute_importance_mi(x_train, y_train, x_test, y_test, num_bins=20,
                          device="cpu"):
    """MI-normalised importance and logistic informativeness."""
    discretized = utils.make_discretizer(x_train, num_bins=num_bins)
    m = utils.discrete_mutual_info(discretized, y_train)
    importance = np.divide(m, m.sum(axis=0))

    scaler = preprocessing.StandardScaler().fit(x_train.T)
    x_train_s = scaler.transform(x_train.T)
    x_test_s = scaler.transform(x_test.T)
    train_acc, test_acc = [], []
    for i in range(y_train.shape[0]):
        model = LogisticRegression(device=device)
        model.fit(x_train_s, y_train[i, :])
        train_acc.append(np.mean(model.predict(x_train_s) == y_train[i, :]))
        test_acc.append(np.mean(model.predict(x_test_s) == y_test[i, :]))
    return importance, np.mean(train_acc), np.mean(test_acc)


def pick_by_dis_per_factor(importance_matrix, k):
    """Per-factor top-k most-disentangled code dims."""
    latent_num, factor_num = importance_matrix.shape
    dis_per_code = disentanglement_per_code(importance_matrix)
    sort_index = np.argsort(-dis_per_code)
    factor_per_code = np.argmax(importance_matrix, axis=1)
    factor_dim = [[] for _ in range(factor_num)]
    is_full = [False] * factor_num
    for dim in sort_index:
        cur = factor_per_code[dim]
        if len(factor_dim[cur]) < k:
            factor_dim[cur].append(dim)
        else:
            is_full[cur] = True
        if all(is_full):
            break
    select = []
    for dims in factor_dim:
        select.extend(dims)
    return sorted(set(select))
