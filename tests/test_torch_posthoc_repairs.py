"""Three faults of the port's metrics, each held to the JAX package (or to
sklearn, where the JAX package itself departs) on the CPU.

1. The logistic regression keeps float32 input in float32, as sklearn 1.9
   does (``_logistic_regression_path``): on 500 seeded float32 points of
   20 features and 5 classes its coefficients equal sklearn's within
   ``COEF32_TOL`` (measured: 0.0); the float64 fit that the port ran on
   every input before lies 8.85e-6 from them. β-VAE, whose points are
   float32 means of float32 codes, then gives the JAX package's
   accuracies.
2. ``reduce_tokens_pca1`` below N = 10 D on more than 500 rows takes
   sklearn's randomized SVD, drawing from numpy's global ``RandomState``:
   on (600, 4, 128) token reps under one ``np.random.seed`` it equals the
   JAX one within ``PCA_TOL``, sign included (measured: 0.0; the exact SVD
   the port took before lies 14.5 from it: the randomized solver's top
   component on a nearly flat spectrum is another vector).
3. Explicitness on a factor of two values: the port binarises it into two
   columns, as ``disentanglement_lib``'s ``MultiLabelBinarizer`` does, and
   equals sklearn's ``roc_auc_score`` on that binarisation; the JAX
   package's one-column ``label_binarize`` makes sklearn raise, so the JAX
   function is held to the port only on factors of three values or more.
"""

import numpy as np
import pytest
from sklearn.linear_model import LogisticRegression as SkLogisticRegression
from sklearn.metrics import roc_auc_score
from sklearn.preprocessing import MultiLabelBinarizer

from encdiff_tpu.evalx import eval_driver as jdriver
from encdiff_tpu.evalx.ground_truth.core import (
    IndexBackedDataset as JIndexBacked)
from encdiff_tpu.evalx.metrics import beta_vae as jbeta
from encdiff_tpu.evalx.metrics import modularity_explicitness as jme
from encdiff_tpu_torch.evalx import eval_driver
from encdiff_tpu_torch.evalx.ground_truth.core import IndexBackedDataset
from encdiff_tpu_torch.evalx.metrics import beta_vae
from encdiff_tpu_torch.evalx.metrics import modularity_explicitness as me
from encdiff_tpu_torch.evalx.metrics.logistic import LogisticRegression
from torch_threads import one_thread  # noqa: F401

COEF32_TOL = 1e-6
PCA_TOL = 1e-6
AUC_TOL = 1e-6


def _points(n_classes, n=500, d=20, seed=3):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, n_classes, n)
    x = rs.randn(n, d) + 0.6 * np.eye(n_classes)[y] @ rs.randn(n_classes, d)
    return x.astype(np.float32), y


@pytest.mark.parametrize("n_classes", [5, 2])
def test_logistic_regression_keeps_float32(n_classes):
    x, y = _points(n_classes)
    theirs = SkLogisticRegression(random_state=0).fit(x, y)
    ours = LogisticRegression().fit(x, y)
    assert ours.coef_.dtype == theirs.coef_.dtype == np.float32
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=0,
                               atol=COEF32_TOL)
    np.testing.assert_allclose(ours.intercept_, theirs.intercept_, rtol=0,
                               atol=COEF32_TOL)
    np.testing.assert_array_equal(ours.predict(x), theirs.predict(x))
    np.testing.assert_allclose(ours.predict_proba(x), theirs.predict_proba(x),
                               rtol=0, atol=COEF32_TOL)


def _grid(sizes, d, seed):
    """Float32 codes of a small ground truth: each factor in one code,
    through noise, beside pure-noise codes."""
    n = int(np.prod(sizes))
    rs = np.random.RandomState(seed)
    f = np.stack(np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij"),
                 -1).reshape(n, len(sizes))
    reps = 0.4 * rs.randn(n, d)
    reps[:, :len(sizes)] += 0.3 * f
    return reps.astype(np.float32)


def test_beta_vae_on_float32_codes_matches_jax():
    sizes = (3, 4, 5)
    reps = _grid(sizes, 6, seed=1)

    def rep(obs):
        return reps[np.asarray(obs, np.int64)]

    n = len(reps)
    theirs = jbeta.compute_beta_vae_sklearn(
        JIndexBacked(np.arange(n), sizes), rep, np.random.RandomState(4),
        batch_size=4, num_train=400, num_eval=300)
    ours = beta_vae.compute_beta_vae_sklearn(
        IndexBackedDataset(np.arange(n), sizes), rep,
        np.random.RandomState(4), batch_size=4, num_train=400, num_eval=300)
    assert ours == theirs
    assert 0.4 < theirs["eval_accuracy"] < 1.0


def test_reduce_tokens_pca1_randomized_matches_jax():
    rs = np.random.RandomState(0)
    reps = rs.randn(600, 4, 128) * np.linspace(0.5, 2.0, 128)
    np.random.seed(7)
    theirs = jdriver.reduce_tokens_pca1(reps)
    np.random.seed(7)
    ours = eval_driver.reduce_tokens_pca1(reps)
    assert ours.shape == theirs.shape == (600, 4)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=PCA_TOL)
    # the global state moved as the JAX package's draws move it
    after = np.random.rand()
    np.random.seed(7)
    jdriver.reduce_tokens_pca1(reps)
    assert np.random.rand() == after


def _standardised(sizes, seed):
    reps = _grid(sizes, 5, seed).T                   # (codes, points)
    n = reps.shape[1]
    rs = np.random.RandomState(seed + 1)
    f = np.stack(np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij"),
                 -1).reshape(n, len(sizes)).T
    pick = rs.randint(0, n, 400)
    test = rs.randint(0, n, 300)
    norm, mean, std = me.utils.normalize_data(reps[:, pick])
    norm_test, _, _ = me.utils.normalize_data(reps[:, test], mean, std)
    return norm, f[:, pick], norm_test, f[:, test]


def test_explicitness_matches_jax_on_three_values_or_more():
    x, y, xt, yt = _standardised((3, 4, 2), seed=2)
    for i in (0, 1):
        theirs = jme.explicitness_per_factor(x, y[i], xt, yt[i])
        ours = me.explicitness_per_factor(x, y[i], xt, yt[i])
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=AUC_TOL)


def test_explicitness_on_a_binary_factor_is_the_two_column_auc():
    x, y, xt, yt = _standardised((3, 4, 2), seed=2)
    with pytest.raises(ValueError):
        jme.explicitness_per_factor(x, y[2], xt, yt[2])
    clf = SkLogisticRegression().fit(x.T, y[2])
    mlb = MultiLabelBinarizer()
    want = (roc_auc_score(mlb.fit_transform(y[2][:, None]),
                          clf.predict_proba(x.T)),
            roc_auc_score(mlb.fit_transform(yt[2][:, None]),
                          clf.predict_proba(xt.T)))
    got = me.explicitness_per_factor(x, y[2], xt, yt[2])
    np.testing.assert_allclose(got, want, rtol=0, atol=AUC_TOL)
    assert 0.5 < want[1] <= 1.0
