"""The port's tree-based post-hoc metrics, downstream task and fairness,
held against the JAX package on the CPU.

Both sides draw their points from the same ``RandomState`` over a small
index-backed ground truth (factors of 2, 3 and 4 values and a nuisance
factor of 6 that is drawn but not scored, so that one set of factors has
several observations; 5 float32 codes carrying the factors through
noise), and ``np.random.seed`` is set before each
side, since sklearn's ``GradientBoostingClassifier()`` draws its trees'
seeds from numpy's global state. On the CPU the port's trees equal
sklearn's tree for tree, so every score is equal, and the global state
ends where the JAX run leaves it. The port fits the factors of one set of
codes together (``gbt.fit_many``) and predicts all the values of an
intervened factor in one call; that leaves every draw in the JAX order.
"""

import numpy as np

from encdiff_tpu.evalx.ground_truth.core import (
    IndexBackedDataset as JIndexBacked)
from encdiff_tpu.evalx.metrics import downstream_task as jdt
from encdiff_tpu.evalx.metrics import fairness as jfair
from encdiff_tpu_torch.evalx.ground_truth.core import IndexBackedDataset
from encdiff_tpu_torch.evalx.metrics import downstream_task as dt
from encdiff_tpu_torch.evalx.metrics import fairness
from torch_threads import one_thread  # noqa: F401

SIZES = (2, 3, 4, 6)
LATENT = [0, 1, 2]


def codes(sizes=SIZES, d=5, seed=0):
    n = int(np.prod(sizes))
    rs = np.random.RandomState(seed)
    f = np.stack(np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij"),
                 -1).reshape(n, len(sizes))
    reps = 0.5 * rs.randn(n, d)
    for j in range(len(LATENT)):
        reps[:, j] += 0.4 * f[:, j]
    return reps.astype(np.float32)


def both(fn_jax, fn_port, seed=1, global_seed=9, **kw):
    """Each side from the same global seed; returns their scores and the
    global state's next draw after each."""
    reps = codes()

    def rep(obs):
        return reps[np.asarray(obs, np.int64)]

    n = len(reps)
    np.random.seed(global_seed)
    theirs = fn_jax(JIndexBacked(np.arange(n), SIZES, LATENT), rep,
                    np.random.RandomState(seed), **kw)
    after_theirs = np.random.rand()
    np.random.seed(global_seed)
    ours = fn_port(IndexBackedDataset(np.arange(n), SIZES, LATENT), rep,
                   np.random.RandomState(seed), **kw)
    after_ours = np.random.rand()
    assert list(ours) == list(theirs)
    assert after_ours == after_theirs
    return ours, theirs


def test_downstream_task_equals_jax():
    ours, theirs = both(jdt.compute_downstream_task,
                        dt.compute_downstream_task, num_train=(150, 60),
                        num_test=100)
    assert ours == theirs
    assert 0.3 < theirs["150:mean_test_accuracy"] < 1.0


def test_fairness_equals_jax():
    ours, theirs = both(jfair.compute_fairness, fairness.compute_fairness,
                        num_train=150, num_test_points_per_class=20)
    assert ours == theirs
    assert theirs["mean_fairness:mean_pred:mean_sens"] > 0.0
