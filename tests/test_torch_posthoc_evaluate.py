"""The port's ``evalx/evaluate.py`` (the metric registry) held against the
JAX package's on the CPU.

Every one of the twelve registry names runs through both packages'
``evaluate_representation`` on the same small ground truth (factors of 3,
3 and 4 values and a nuisance factor of 5; 6 float32 codes), each side
after the same ``np.random.seed``: the same key set, and the same values
within ``TOL`` (1e-9; every value came out equal). The tree-based metrics
run at the in-training tier's 20 stages on both sides: the port's
``gradient_boosting_fast``, and on the JAX side, whose registry of
predictors knows only sklearn's 100-stage default, the same
``GradientBoostingClassifier(n_estimators=20)`` patched into its
``make_predictor_fn`` by the test. The port's entry point runs on the card
unless asked for the CPU, and raises without CUDA. ``python -m
encdiff_tpu_torch.posthoc_eval`` on a tiny config's checkpoint (``-r``,
the harness's sweep) gives ``evaluate_battery``'s scores of that sweep,
and the same with ``--reps`` on the saved sweep.
"""

import json

import numpy as np
import pytest
import torch
from sklearn.ensemble import GradientBoostingClassifier

from encdiff_tpu.evalx import evaluate as jevaluate
from encdiff_tpu.evalx.ground_truth import named_data as jnamed
from encdiff_tpu.evalx.ground_truth.core import (
    IndexBackedDataset as JIndexBacked)
from encdiff_tpu.evalx.metrics import utils as jutils
from encdiff_tpu_torch import posthoc_eval
from encdiff_tpu_torch.data import synthetic_shapes
from encdiff_tpu_torch.evalx import evaluate
from encdiff_tpu_torch.evalx.ground_truth import named_data
from encdiff_tpu_torch.evalx.ground_truth.core import IndexBackedDataset
from encdiff_tpu_torch.train import harness
from test_torch_harness import TINY, TINY_GRID
from torch_threads import one_thread  # noqa: F401

TOL = 1e-9
SIZES = (3, 3, 4, 5)
LATENT = [0, 1, 2]
FAST = "gradient_boosting_fast"
KWARGS = {
    "dci": dict(num_train=120, num_test=60, predictor=FAST),
    "factor_vae": dict(batch_size=8, num_train=150, num_eval=80,
                       num_variance_estimate=200),
    "beta_vae": dict(batch_size=8, num_train=200, num_eval=100),
    "mig": dict(num_train=300),
    "sap": dict(num_train=300, num_test=150),
    "irs": dict(num_train=300),
    "modularity": dict(num_train=300, num_test=150),
    "fairness": dict(num_train=120, num_test_points_per_class=12,
                     predictor=FAST),
    "unsupervised": dict(num_train=300),
    "downstream": dict(num_train=(120,), num_test=60, predictor=FAST),
    "reduced_downstream": dict(num_train=(90,), num_test=60,
                               predictor=FAST),
    "med": dict(num_train=300, num_test=150, topk=1),
}


def _codes():
    n = int(np.prod(SIZES))
    rs = np.random.RandomState(0)
    f = np.stack(np.meshgrid(*[np.arange(s) for s in SIZES], indexing="ij"),
                 -1).reshape(n, len(SIZES))
    reps = 0.45 * rs.randn(n, 6)
    for j in LATENT:
        reps[:, j] += 0.4 * f[:, j]
        reps[:, j + 3] += 0.1 * f[:, j] ** 2
    return reps.astype(np.float32)


@pytest.fixture
def tiny(monkeypatch):
    n = int(np.prod(SIZES))
    monkeypatch.setitem(jnamed._REGISTRY, "tiny_posthoc",
                        lambda images=None: JIndexBacked(
                            np.arange(n), SIZES, LATENT))
    monkeypatch.setitem(named_data._REGISTRY, "tiny_posthoc",
                        lambda images=None: IndexBackedDataset(
                            np.arange(n), SIZES, LATENT))
    make = jutils.make_predictor_fn

    def make_predictor_fn(predictor="gradient_boosting"):
        if predictor == FAST:
            return lambda: GradientBoostingClassifier(n_estimators=20)
        return make(predictor)

    monkeypatch.setattr(jutils, "make_predictor_fn", make_predictor_fn)
    return _codes()


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_registry_names_match_jax():
    assert evaluate.available_metrics() == jevaluate.available_metrics()
    assert len(evaluate.available_metrics()) == 12


@pytest.mark.parametrize("metric", sorted(KWARGS))
def test_evaluate_representation_matches_jax(tiny, metric):
    np.random.seed(3)
    theirs = jevaluate.evaluate_representation(
        metric, "tiny_posthoc", tiny, seed=5, **KWARGS[metric])
    np.random.seed(3)
    ours = evaluate.evaluate_representation(
        metric, "tiny_posthoc", tiny, seed=5, device="cpu", **KWARGS[metric])
    ours, theirs = dict(_flat(ours)), dict(_flat(theirs))
    assert list(ours) == list(theirs)
    for k, want in theirs.items():
        got = ours[k]
        np.testing.assert_allclose(np.real(np.asarray(got, np.float64)),
                                   np.real(np.asarray(want, np.float64)),
                                   rtol=0, atol=TOL, err_msg=k)


def test_a_representation_function_or_its_table(tiny):
    def rep(obs):
        return tiny[np.asarray(obs, np.int64)]

    a = evaluate.evaluate_representation("mig", "tiny_posthoc", tiny,
                                         device="cpu", num_train=200)
    b = evaluate.evaluate_representation("mig", "tiny_posthoc", rep,
                                         device="cpu", num_train=200)
    assert a == b
    with pytest.raises(ValueError, match="unknown metric"):
        evaluate.evaluate_representation("lfw", "tiny_posthoc", tiny,
                                         device="cpu")


def test_the_card_by_default_and_no_fallback(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate.evaluate_representation("mig", "tiny_posthoc", tiny)


def test_posthoc_eval_cli_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(synthetic_shapes.SyntheticShapes3DV4Full,
                        "factor_sizes", TINY_GRID)
    monkeypatch.setitem(named_data._REGISTRY, "tiny_grid",
                        lambda images=None: IndexBackedDataset(
                            np.arange(64), TINY_GRID))
    harness.clear_device_cache()
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    config = harness.load_configs([str(cfg)], [])
    lightning = config.pop("lightning")
    trainer = harness.Trainer(config, lightning, seed=3,
                              logdir=str(tmp_path / "run"), device="cpu")
    trainer._ensure_state()
    ckpt = str(tmp_path / "run" / "last")
    trainer.save_checkpoint(ckpt)
    metrics = "mig,irs,sap,unsupervised"
    out = tmp_path / "posthoc.json"
    got = posthoc_eval.main(["-b", str(cfg), "-r", ckpt, "--tier", "fast",
                             "--metrics", metrics, "--out", str(out),
                             "-l", str(tmp_path / "logs"), "--device",
                             "cpu"])
    assert json.loads(out.read_text()) == got
    assert got["reps"] == [64, 20] and sorted(got["seconds"]) == sorted(
        metrics.split(","))
    reps = posthoc_eval.sweep(config, ckpt, "cpu", str(tmp_path / "logs"))
    want = evaluate.evaluate_battery("tiny_grid", reps, tier="fast",
                                     device="cpu",
                                     metrics=metrics.split(","))
    assert got["scores"] == json.loads(json.dumps(
        {k: {kk: float(vv) for kk, vv in v.items()}
         for k, v in want.items()}))
    np.save(tmp_path / "reps.npy", reps)
    again = posthoc_eval.main(["-b", str(cfg), "--reps",
                               str(tmp_path / "reps.npy"), "--tier", "fast",
                               "--metrics", metrics, "--device", "cpu"])
    assert again["scores"] == got["scores"]
    harness.clear_device_cache()
