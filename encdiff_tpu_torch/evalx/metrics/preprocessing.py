"""The sklearn pieces the post-hoc metrics call, in numpy on the host.

The JAX package's MED scales its codes with ``preprocessing.StandardScaler``
(``encdiff_tpu/evalx/metrics/med.py:104``) and its explicitness scores
one-vs-rest ROC-AUCs of ``label_binarize``d factors
(``modularity_explicitness.py:46-51``). These are sklearn 1.9's
computations on (samples, features) arrays of a few thousand rows:

* ``StandardScaler``: the mean and the population variance by
  ``_incremental_mean_and_var`` (float64 accumulators, the corrected
  two-pass variance), a near-constant feature's scale (``_is_constant_
  feature``) set to 1, and ``transform`` in the input's dtype.
* ``label_binarize``: one column per class, a single column for two
  classes; ``multilabel_binarize``: one column per class always, as
  ``MultiLabelBinarizer`` gives it for a vector of single labels.
* ``roc_auc_score`` on a (samples, classes) indicator: the macro average
  of each column's AUC, the Mann-Whitney statistic with tied scores given
  their mean rank (what the trapezoid under ``roc_curve`` sums to). A
  column with one class only raises, as sklearn does.
"""

from __future__ import annotations

import numpy as np
import scipy.stats


class StandardScaler:
    """``sklearn.preprocessing.StandardScaler()`` (mean and std)."""

    def fit(self, X):
        X = np.asarray(X)
        n = X.shape[0]
        new_sum = np.sum(X, axis=0, dtype=np.float64)
        mean = new_sum / n
        temp = X - new_sum / n
        correction = np.sum(temp, axis=0, dtype=np.float64)
        temp **= 2
        unnormalized = np.sum(temp, axis=0, dtype=np.float64)
        unnormalized -= correction ** 2 / n
        var = unnormalized / n
        eps = np.finfo(np.float64).eps
        constant = var <= n * eps * var + (n * mean * eps) ** 2
        scale = np.sqrt(var)
        scale[constant] = 1.0
        self.mean_, self.var_, self.scale_ = mean, var, scale
        self.n_samples_seen_ = n
        return self

    def transform(self, X):
        X = np.array(X, copy=True)
        X -= self.mean_.astype(X.dtype)
        X /= self.scale_.astype(X.dtype)
        return X


def multilabel_binarize(y, classes) -> np.ndarray:
    """(samples, classes) 0/1 indicator of ``y`` over ``classes``."""
    return (np.asarray(y).ravel()[:, None]
            == np.asarray(classes)[None, :]).astype(np.int64)


def label_binarize(y, classes) -> np.ndarray:
    """``sklearn.preprocessing.label_binarize``: the indicator, but one
    column (the second class) for two classes."""
    out = multilabel_binarize(y, classes)
    return out[:, 1:] if len(classes) == 2 else out


def binary_roc_auc(y_true, y_score) -> float:
    """AUC of one 0/1 column against its scores, ties at their mean
    rank."""
    y_true = np.asarray(y_true).ravel()
    pos = y_true == 1
    n_pos = int(pos.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class is present in y_true. ROC AUC score "
                         "is not defined in that case.")
    ranks = scipy.stats.rankdata(np.asarray(y_score).ravel())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def roc_auc_score(y_true, y_score) -> float:
    """Macro-averaged AUC of a (samples, classes) indicator against
    (samples, classes) scores."""
    y_true, y_score = np.asarray(y_true), np.asarray(y_score)
    if y_true.ndim != 2 or y_true.shape != y_score.shape:
        raise ValueError(f"y_true {y_true.shape} and y_score {y_score.shape}"
                         " must be (samples, classes) alike")
    return float(np.mean([binary_roc_auc(y_true[:, c], y_score[:, c])
                          for c in range(y_true.shape[1])]))
