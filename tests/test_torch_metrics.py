"""The port's ground truth, metrics and eval driver held against the JAX
package, on the CPU.

Both sides are numpy: the same ``RandomState`` draws go through the JAX
package's ``evalx`` and the port's copy. Sampling, index lookups and
FactorVAE's votes are held exactly; MIG to 1e-12, since the port's numpy
``mutual_info_score`` stands in for sklearn's (held to sklearn's at 1e-12
too). FactorVAE and MIG run at the full protocol's sizes (FactorVAE:
batch 64, 10,000 train and 5,000 eval votes, 10,000 variance points,
prune threshold 0.05; MIG: 10,000 points, 20 bins) over
``synthetic_shapes_full``'s 480,000 indices, on random reps and on reps
that encode the factors (structured: each factor in two codes, scaled and
noised, beside pure-noise and constant codes).
"""

import json

import numpy as np
import pytest
import sklearn.metrics

from encdiff_tpu.evalx import eval_driver as jdriver
from encdiff_tpu.evalx.ground_truth import named_data as jnamed
from encdiff_tpu.evalx.ground_truth.core import (
    StateSpaceAtomIndex as JaxAtomIndex)
from encdiff_tpu.evalx.metrics import factor_vae as jfvae
from encdiff_tpu.evalx.metrics import mig as jmig
from encdiff_tpu.evalx.metrics import utils as jutils
from encdiff_tpu_torch.evalx import eval_driver
from encdiff_tpu_torch.evalx.ground_truth import named_data
from encdiff_tpu_torch.evalx.ground_truth.core import StateSpaceAtomIndex
from encdiff_tpu_torch.evalx.metrics import factor_vae, mig, utils

MIG_TOL = 1e-12
NAMES = sorted(named_data._REGISTRY)


@pytest.mark.parametrize("name", NAMES)
def test_ground_truth_sampling_matches_jax(name):
    """The same factors and observation indices for the same draws."""
    ours, theirs = (named_data.get_index_dataset(name),
                    jnamed.get_index_dataset(name))
    assert ours.factors_num_values == theirs.factors_num_values
    assert ours.num_factors == theirs.num_factors
    assert len(ours.images) == len(theirs.images)
    rs_a, rs_b = np.random.RandomState(3), np.random.RandomState(3)
    f_a, f_b = ours.sample_factors(500, rs_a), theirs.sample_factors(500, rs_b)
    np.testing.assert_array_equal(f_a, f_b)
    np.testing.assert_array_equal(
        ours.sample_observations_from_factors(f_a, rs_a),
        theirs.sample_observations_from_factors(f_b, rs_b))
    np.testing.assert_array_equal(ours.sample(300, rs_a)[1],
                                  theirs.sample(300, rs_b)[1])


def test_state_space_atom_index_matches_jax():
    sizes = [3, 4, 2]
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in sizes],
                                indexing="ij"), -1).reshape(-1, 3)
    features = grid[np.random.RandomState(0).permutation(len(grid))]
    ours, theirs = (StateSpaceAtomIndex(sizes, features),
                    JaxAtomIndex(sizes, features))
    np.testing.assert_array_equal(ours.features_to_index(grid),
                                  theirs.features_to_index(grid))
    with pytest.raises(ValueError):
        StateSpaceAtomIndex(sizes, features[1:])


def test_registry_refuses_unknown_names():
    with pytest.raises(ValueError, match="Unknown ground-truth dataset"):
        named_data.get_index_dataset("no_such_data")


@pytest.mark.parametrize("seed", range(4))
def test_mutual_info_score_matches_sklearn(seed):
    rs = np.random.RandomState(seed)
    for _ in range(25):
        n = rs.randint(1, 3000)
        a = rs.randint(rs.randint(1, 16), size=n)
        b = rs.randint(rs.randint(1, 21), size=n) * 7 - 3
        assert abs(utils.mutual_info_score(a, b)
                   - sklearn.metrics.mutual_info_score(a, b)) <= MIG_TOL


def _reps(kind: str) -> np.ndarray:
    """(480,000, 20) float32 reps over synthetic_shapes_full."""
    data = named_data.get_index_dataset("synthetic_shapes_full")
    rs = np.random.RandomState(11)
    n = len(data.images)
    if kind == "random":
        return rs.randn(n, 20).astype(np.float32)
    # every row's factors from its index, through the mixed-radix bases
    factors = (np.arange(n)[:, None] // data.factor_bases.astype(np.int64)
               % np.asarray(data.factor_sizes))
    reps = np.zeros((n, 20), np.float32)
    for j in range(6):
        reps[:, 2 * j] = factors[:, j] * (j + 1.0) + 0.05 * rs.randn(n)
        reps[:, 2 * j + 1] = -0.5 * factors[:, j] + 0.3 * rs.randn(n)
    reps[:, 12:18] = rs.randn(n, 6)
    reps[:, 18:] = 0.01 * rs.randn(n, 2)  # pruned: std below 0.05
    return reps


@pytest.fixture(scope="module", params=["random", "structured"])
def reps(request):
    return request.param, _reps(request.param)


def test_factor_vae_matches_jax(reps):
    kind, r = reps
    data = named_data.get_index_dataset("synthetic_shapes_full")
    jdata = jnamed.get_index_dataset("synthetic_shapes_full")
    kw = dict(batch_size=64, num_train=10000, num_eval=5000,
              num_variance_estimate=10000, prune_threshold=0.05)
    ours = factor_vae.compute_factor_vae(
        data, lambda i: r[i], np.random.RandomState(0), **kw)
    theirs = jfvae.compute_factor_vae(
        jdata, lambda i: r[i], np.random.RandomState(0), **kw)
    assert ours == theirs
    if kind == "structured":
        assert ours["eval_accuracy"] == 1.0
        assert ours["num_active_dims"] == 20


def test_mig_matches_jax(reps):
    kind, r = reps
    data = named_data.get_index_dataset("synthetic_shapes_full")
    jdata = jnamed.get_index_dataset("synthetic_shapes_full")
    ours = mig.compute_mig(data, lambda i: r[i], np.random.RandomState(0),
                           num_train=10000, num_bins=20)
    theirs = jmig.compute_mig(jdata, lambda i: r[i], np.random.RandomState(0),
                              num_train=10000, num_bins=20)
    assert abs(ours["discrete_mig"] - theirs["discrete_mig"]) <= MIG_TOL
    if kind == "structured":
        assert ours["discrete_mig"] > 0.05


def test_metric_utils_match_jax():
    rs = np.random.RandomState(5)
    codes = rs.randn(7, 900)
    ys = rs.randint(0, 9, size=(4, 900))
    np.testing.assert_array_equal(utils.histogram_discretize(codes, 20),
                                  jutils.histogram_discretize(codes, 20))
    d = utils.histogram_discretize(codes, 20)
    np.testing.assert_allclose(utils.discrete_mutual_info(d, ys),
                               jutils.discrete_mutual_info(d, ys),
                               rtol=0, atol=MIG_TOL)
    np.testing.assert_allclose(utils.discrete_entropy(ys),
                               jutils.discrete_entropy(ys), rtol=0,
                               atol=MIG_TOL)
    for a, b in zip(utils.normalize_data(codes), jutils.normalize_data(codes)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(utils.split_train_test(codes, 0.66),
                    jutils.split_train_test(codes, 0.66)):
        np.testing.assert_array_equal(a, b)
    data = named_data.get_index_dataset("synthetic_shapes")
    jdata = jnamed.get_index_dataset("synthetic_shapes")
    table = rs.randn(len(data.images), 5)
    for a, b in zip(
            utils.generate_batch_factor_code(
                data, lambda i: table[i], 1000, np.random.RandomState(1), 16),
            jutils.generate_batch_factor_code(
                jdata, lambda i: table[i], 1000, np.random.RandomState(1),
                16)):
        np.testing.assert_array_equal(a, b)


def test_eval_func_json_matches_jax(tmp_path):
    r = _reps("structured")
    data = named_data.get_index_dataset("synthetic_shapes_full")
    jdata = jnamed.get_index_dataset("synthetic_shapes_full")
    ours = eval_driver.eval_func(data, r, str(tmp_path / "port"), 97500,
                                 metrics=("MIG", "factor_VAE"))
    theirs = jdriver.eval_func(jdata, r, str(tmp_path / "jax"), 97500,
                               metrics=("MIG", "factor_VAE"))
    assert list(ours) == list(theirs) == ["MIG", "factor_VAE"]
    a = json.loads((tmp_path / "port" / "97500.json").read_text())
    b = json.loads((tmp_path / "jax" / "97500.json").read_text())
    assert a["factor_VAE"] == b["factor_VAE"]
    assert list(a["MIG"]) == list(b["MIG"]) == ["discrete_mig"]
    assert abs(a["MIG"]["discrete_mig"] - b["MIG"]["discrete_mig"]) <= MIG_TOL
