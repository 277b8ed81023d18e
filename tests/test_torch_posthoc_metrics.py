"""The port's post-hoc metrics without trees, held against the JAX package
(and their sklearn pieces against sklearn) on the CPU.

Both sides draw from the same ``RandomState`` over a small index-backed
ground truth (3 factors of 3–5 values, 6 float32 codes that carry the
factors through noise, as an encoder's codes do). Tolerances:

- IRS, SAP's continuous R², the unsupervised scores and MED's importance
  (D, C, top-k): ``EXACT_TOL`` (1e-9); each came out equal here;
- MED's and explicitness's logistic regressions: accuracies equal, AUC
  within ``AUC_TOL`` (1e-6);
- SAP's discrete path, whose ``LinearSVC`` the port solves to convergence
  where liblinear stops at its tolerance: the score within ``SVC_TOL``
  (2e-3; measured 0.0 on these codes, so no test point lies within
  liblinear's tolerance of a boundary);
- ``StandardScaler``, ``label_binarize`` and the multilabel ``roc_auc_score``
  against sklearn's: equal, and the AUC within 1e-12 (a rank statistic
  against the trapezoid under ``roc_curve``).
"""

import importlib

import numpy as np
import pytest
import sklearn.metrics
import sklearn.preprocessing

from encdiff_tpu.evalx.ground_truth.core import (
    IndexBackedDataset as JIndexBacked)
from encdiff_tpu.evalx.metrics import irs as jirs
from encdiff_tpu.evalx.metrics import med as jmed
from encdiff_tpu.evalx.metrics import modularity_explicitness as jme
from encdiff_tpu.evalx.metrics import sap_score as jsap
from encdiff_tpu_torch.evalx.ground_truth.core import IndexBackedDataset
from encdiff_tpu_torch.evalx.metrics import irs, med, preprocessing
from encdiff_tpu_torch.evalx.metrics import modularity_explicitness as me
from encdiff_tpu_torch.evalx.metrics import sap_score
from torch_threads import one_thread  # noqa: F401

jun = importlib.import_module("encdiff_tpu.evalx.metrics.unsupervised_metrics")
un = importlib.import_module(
    "encdiff_tpu_torch.evalx.metrics.unsupervised_metrics")

EXACT_TOL = 1e-9
AUC_TOL = 1e-6
SVC_TOL = 2e-3
SIZES = (3, 4, 5)


def _codes(sizes=SIZES, d=6, seed=0):
    n = int(np.prod(sizes))
    rs = np.random.RandomState(seed)
    f = np.stack(np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij"),
                 -1).reshape(n, len(sizes))
    reps = 0.45 * rs.randn(n, d)
    for j in range(len(sizes)):
        reps[:, j] += 0.35 * f[:, j]
        reps[:, (j + 3) % d] += 0.1 * f[:, j] ** 2
    return reps.astype(np.float32)


def _both(fn_jax, fn_port, sizes=SIZES, seed=1, **kw):
    reps = _codes(sizes)

    def rep(obs):
        return reps[np.asarray(obs, np.int64)]

    n = len(reps)
    theirs = fn_jax(JIndexBacked(np.arange(n), sizes), rep,
                    np.random.RandomState(seed), **kw)
    ours = fn_port(IndexBackedDataset(np.arange(n), sizes), rep,
                   np.random.RandomState(seed), **kw)
    assert list(ours) == list(theirs)
    return ours, theirs


def _close(ours, theirs, keys, tol):
    for k in keys:
        assert abs(float(ours[k]) - float(theirs[k])) <= tol, (
            k, ours[k], theirs[k])


def test_irs_matches_jax():
    ours, theirs = _both(jirs.compute_irs, irs.compute_irs, num_train=600,
                         batch_size=16)
    assert ours["num_active_dims"] == theirs["num_active_dims"] == 6
    _close(ours, theirs, ["IRS"], EXACT_TOL)


def test_sap_continuous_matches_jax():
    ours, theirs = _both(jsap.compute_sap, sap_score.compute_sap,
                         num_train=600, num_test=300)
    _close(ours, theirs, ["SAP_score"], EXACT_TOL)
    assert theirs["SAP_score"] > 0.01


def test_sap_discrete_matches_jax():
    np.random.seed(5)
    ours, theirs = _both(jsap.compute_sap, sap_score.compute_sap,
                         num_train=600, num_test=300,
                         continuous_factors=False)
    _close(ours, theirs, ["SAP_score"], SVC_TOL)
    after = np.random.rand()
    np.random.seed(5)
    _both(jsap.compute_sap, jsap.compute_sap, num_train=600, num_test=300,
          continuous_factors=False)
    assert np.random.rand() == after  # liblinear's seeds, drawn as sklearn's


def test_svc_accuracies_match_liblinear():
    """Each code's accuracy against sklearn's ``LinearSVC`` one by one."""
    from sklearn import svm as sksvm

    reps = _codes().T.astype(np.float64)
    rs = np.random.RandomState(2)
    f = np.stack(np.meshgrid(*[np.arange(s) for s in SIZES], indexing="ij"),
                 -1).reshape(-1, 3).T
    pick, test = rs.randint(0, reps.shape[1], 700), \
        rs.randint(0, reps.shape[1], 400)
    for j, sizes in enumerate(SIZES):
        model = sap_score.svm.OneFeatureSVC().fit(reps[:, pick], f[j, pick])
        ours = np.mean(model.predict(reps[:, test]) == f[j, test][None, :],
                       axis=1)
        for i in range(reps.shape[0]):
            clf = sksvm.LinearSVC(C=0.01, class_weight="balanced")
            clf.fit(reps[i, pick, None], f[j, pick])
            want = np.mean(clf.predict(reps[i, test, None]) == f[j, test])
            assert abs(ours[i] - want) <= SVC_TOL, (i, j, ours[i], want)


def test_unsupervised_matches_jax():
    ours, theirs = _both(jun.unsupervised_metrics, un.unsupervised_metrics,
                         num_train=600)
    _close(ours, theirs, list(theirs), EXACT_TOL)


@pytest.mark.parametrize("topk", [-1, 2])
def test_med_matches_jax(topk):
    ours, theirs = _both(jmed.compute_med, med.compute_med, num_train=600,
                         num_test=300, topk=topk)
    for k in ("informativeness_train", "informativeness_test"):
        assert ours[k] == theirs[k], k
    _close(ours, theirs, [k for k in theirs if "informativeness" not in k],
           EXACT_TOL)


def test_modularity_explicitness_matches_jax():
    sizes = (3, 4, 5)
    ours, theirs = _both(jme.compute_modularity_explicitness,
                         me.compute_modularity_explicitness, sizes=sizes,
                         num_train=600, num_test=300)
    _close(ours, theirs, ["modularity_score"], EXACT_TOL)
    _close(ours, theirs, ["explicitness_score_train",
                          "explicitness_score_test"], AUC_TOL)


def test_standard_scaler_matches_sklearn():
    x = _codes().astype(np.float32)
    x[:, 2] = 0.25  # a constant feature: scale 1
    theirs = sklearn.preprocessing.StandardScaler().fit(x)
    ours = preprocessing.StandardScaler().fit(x)
    np.testing.assert_array_equal(ours.mean_, theirs.mean_)
    np.testing.assert_array_equal(ours.var_, theirs.var_)
    np.testing.assert_array_equal(ours.scale_, theirs.scale_)
    got = ours.transform(x[:50])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, theirs.transform(x[:50]))


@pytest.mark.parametrize("k", [2, 3, 6])
def test_binarizers_and_auc_match_sklearn(k):
    rs = np.random.RandomState(k)
    y = rs.randint(0, k, 300)
    classes = np.arange(k)
    np.testing.assert_array_equal(
        preprocessing.label_binarize(y, classes),
        sklearn.preprocessing.label_binarize(y, classes=classes))
    indicator = preprocessing.multilabel_binarize(y, classes)
    np.testing.assert_array_equal(
        indicator,
        sklearn.preprocessing.MultiLabelBinarizer().fit_transform(
            y[:, None]))
    # scores with ties, as rounded probabilities have them
    scores = np.round(rs.rand(300, k) + 0.3 * indicator, 2)
    assert abs(preprocessing.roc_auc_score(indicator, scores)
               - sklearn.metrics.roc_auc_score(indicator, scores)) <= 1e-12
    with pytest.raises(ValueError, match="one class"):
        preprocessing.roc_auc_score(np.ones((5, 2)), np.zeros((5, 2)))
