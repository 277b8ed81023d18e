"""Downstream-task and reduced-downstream-task accuracies.

A port of ``encdiff_tpu/evalx/metrics/downstream_task.py``: a predictor a
factor on the codes (the port's gradient-boosted trees, ``gbt.py``, on
``device``); the reduced task drops the code the predictor of one factor
finds most important and retrains. The JAX package fits one factor after
another, each drawing its trees' seeds from numpy's global state; here the
fits that share their codes grow together (``utils.fit_predictors``), and
the reduced task's seeds are drawn up front in the JAX package's order
(the reduction's fit, then the retrained factors', factor by factor), so
that its seven reductions also grow together.
"""

from __future__ import annotations

import numpy as np

from encdiff_tpu_torch.evalx.metrics import gbt, utils


def compute_downstream_task(ground_truth_data, representation_function,
                            random_state, artifact_dir=None,
                            num_train=(10000,), num_test=5000, batch_size=16,
                            predictor="gradient_boosting", device="cpu"):
    del artifact_dir
    scores = {}
    for train_size in num_train:
        mus_train, ys_train = utils.generate_batch_factor_code(
            ground_truth_data, representation_function, train_size,
            random_state, batch_size)
        mus_test, ys_test = utils.generate_batch_factor_code(
            ground_truth_data, representation_function, num_test,
            random_state, batch_size)
        models = utils.fit_predictors(predictor, mus_train.T, ys_train,
                                      device)
        train_acc, test_acc = _accuracies(models, mus_train.T, ys_train,
                                          mus_test.T, ys_test)
        s = str(train_size)
        scores[s + ":mean_train_accuracy"] = np.mean(train_acc)
        scores[s + ":mean_test_accuracy"] = np.mean(test_acc)
        scores[s + ":min_train_accuracy"] = np.min(train_acc)
        scores[s + ":min_test_accuracy"] = np.min(test_acc)
        for i, (tr, te) in enumerate(zip(train_acc, test_acc)):
            scores[s + f":train_accuracy_factor_{i}"] = tr
            scores[s + f":test_accuracy_factor_{i}"] = te
    return scores


def _accuracies(models, x_train, y_train, x_test, y_test):
    train_acc, test_acc = [], []
    for i, model in enumerate(models):
        train_acc.append(np.mean(model.predict(x_train) == y_train[i, :]))
        test_acc.append(np.mean(model.predict(x_test) == y_test[i, :]))
    return train_acc, test_acc


def compute_reduced_downstream_task(ground_truth_data,
                                    representation_function, random_state,
                                    artifact_dir=None,
                                    num_factors_to_remove=1,
                                    num_train=(10000,), num_test=5000,
                                    batch_size=16,
                                    predictor="gradient_boosting",
                                    device="cpu"):
    """Remove the k most-informative code dims per factor, retrain,
    measure leakage."""
    del artifact_dir
    scores = {}
    if predictor not in utils.GBT_STAGES:
        utils.make_predictor_fn(predictor)()  # raises: not ported
    stages = utils.GBT_STAGES[predictor]
    for train_size in num_train:
        s = str(train_size)
        mus_train, ys_train = utils.generate_batch_factor_code(
            ground_truth_data, representation_function, train_size,
            random_state, batch_size)
        mus_test, ys_test = utils.generate_batch_factor_code(
            ground_truth_data, representation_function, num_test,
            random_state, batch_size)
        num_factors = ground_truth_data.num_factors
        # the global draws of the JAX loop, factor by factor: each removal's
        # fit, then the retrained factors' fits
        seeds = [([gbt.draw_seeds([ys_train[factor]], stages)
                   for _ in range(num_factors_to_remove)],
                  gbt.draw_seeds(list(ys_train), stages))
                 for factor in range(num_factors)]
        reduced = [(mus_train.copy(), mus_test.copy())
                   for _ in range(num_factors)]
        for r in range(num_factors_to_remove):
            if r == 0:
                # the first removal of every factor sees the same codes
                models = gbt.fit_many(
                    mus_train.T, list(ys_train), n_estimators=stages,
                    device=device,
                    seeds=np.concatenate([seeds[f][0][0]
                                          for f in range(num_factors)], 1))
            else:
                models = [gbt.fit_many(
                    reduced[f][0].T, [ys_train[f]], n_estimators=stages,
                    device=device, seeds=seeds[f][0][r])[0]
                    for f in range(num_factors)]
            reduced = [_drop_most_important(models[f], *reduced[f])
                       for f in range(num_factors)]
        reduced_train_scores, other_train_scores = [], []
        reduced_test_scores, other_test_scores = [], []
        for factor in range(num_factors):
            red_train, red_test = reduced[factor]
            models = gbt.fit_many(red_train.T, list(ys_train),
                                  n_estimators=stages, device=device,
                                  seeds=seeds[factor][1])
            train_acc, test_acc = _accuracies(models, red_train.T, ys_train,
                                              red_test.T, ys_test)
            scores[s + f":reduced_factor_{factor}"
                   ":mean_train_accuracy_reduced_factor"] = train_acc[factor]
            scores[s + f":reduced_factor_{factor}"
                   ":mean_test_accuracy_reduced_factor"] = test_acc[factor]
            reduced_train_scores.append(train_acc[factor])
            reduced_test_scores.append(test_acc[factor])
            others_tr = [a for i, a in enumerate(train_acc) if i != factor]
            others_te = [a for i, a in enumerate(test_acc) if i != factor]
            other_train_scores.append(np.mean(others_tr))
            other_test_scores.append(np.mean(others_te))
        scores[s + ":mean_train_accuracy_reduced_factor"] = np.mean(
            reduced_train_scores)
        scores[s + ":mean_test_accuracy_reduced_factor"] = np.mean(
            reduced_test_scores)
        scores[s + ":mean_train_accuracy_other_factors"] = np.mean(
            other_train_scores)
        scores[s + ":mean_test_accuracy_other_factors"] = np.mean(
            other_test_scores)
    return scores


def _drop_most_important(model, mus_train, mus_test):
    """Drop the code the fitted ``model`` finds most important."""
    importance = np.abs(model.feature_importances_)
    drop = int(np.argmax(importance))
    keep = [i for i in range(mus_train.shape[0]) if i != drop]
    return mus_train[keep, :], mus_test[keep, :]


def compute_reduced_representation(mus_train, ys_train, mus_test, ys_test,
                                   factor_of_interest, predictor_fn):
    """Drop the code dim most informative for factor_of_interest."""
    model = predictor_fn()
    model.fit(mus_train.T, ys_train[factor_of_interest, :])
    return _drop_most_important(model, mus_train, mus_test)
