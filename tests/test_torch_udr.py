"""The port's UDR (``evalx/udr.py``, ``evalx/lasso.py``) and its CLI
(``udr_eval``) held against the JAX package and sklearn on the CPU.

- ``Lasso(alpha=0.1)`` on multi-target data against sklearn's: the
  coefficients, intercepts and sweeps of each target (``LASSO_TOL``, 1e-9;
  measured 4.4e-16).
- ``compute_udr`` on three models' codes (one code dead, masked by its
  activity) against the JAX one at both correlation matrices: the raw
  correlations, pairwise and model scores within 1e-6 with the Lasso (its
  stop rule sits on float64 sums taken in another order; measured 5e-8
  where a fit runs its 1,000 sweeps) and 1e-9 with Spearman (measured
  0.0).
- ``python -m encdiff_tpu_torch.udr_eval`` with ``--device cpu`` on a tiny
  config's two seeded fresh inits, one a harness checkpoint directory and
  one a compact ``.npz``: the codes of each are its Encoder4's (within
  1e-5 relative: batches of another size sum in another order), and its
  scores equal the JAX ``compute_udr`` on the same codes within 1e-6
  (Lasso) and 1e-9 (Spearman).
"""

import json

import numpy as np
import pytest
import torch
from sklearn.linear_model import Lasso as SkLasso

from encdiff_tpu.evalx import udr as judr
from encdiff_tpu.evalx.ground_truth.core import (
    IndexBackedDataset as JIndexBacked)
from encdiff_tpu_torch import udr_eval
from encdiff_tpu_torch.core.compact_ckpt import load_model_variables
from encdiff_tpu_torch.data import synthetic_shapes
from encdiff_tpu_torch.data.synthetic_shapes import render_all_v4
from encdiff_tpu_torch.evalx import udr
from encdiff_tpu_torch.evalx.ground_truth import named_data
from encdiff_tpu_torch.evalx.ground_truth.core import IndexBackedDataset
from encdiff_tpu_torch.evalx.lasso import Lasso
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.train import harness
from test_torch_harness import TINY, TINY_GRID
from torch_threads import one_thread  # noqa: F401

LASSO_TOL = 1e-9
UDR_TOL = {"lasso": 1e-6, "spearman": 1e-9}
#: the same network on batches of another size sums in another order
CODE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lasso_matches_sklearn(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(600, 12)
    x[:, 3] = 0.0                                 # a column with no norm
    w = rs.randn(12, 7) * (rs.rand(12, 7) < 0.3)
    y = x @ w + 0.5 * rs.randn(600, 7) + 1.5
    theirs = SkLasso(alpha=0.1, random_state=0).fit(x, y)
    ours = Lasso(alpha=0.1).fit(x, y)
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=0,
                               atol=LASSO_TOL)
    np.testing.assert_allclose(ours.intercept_, theirs.intercept_, rtol=0,
                               atol=LASSO_TOL)
    np.testing.assert_array_equal(ours.n_iter_, theirs.n_iter_)
    one = Lasso(alpha=0.1).fit(x, y[:, 0])
    assert one.coef_.shape == (12,) and np.ndim(one.intercept_) == 0


def _models(sizes, n_models=3, d=8):
    n = int(np.prod(sizes))
    rs = np.random.RandomState(0)
    f = np.stack(np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij"),
                 -1).reshape(n, len(sizes))
    fns = []
    for m in range(n_models):
        r = (0.3 * rs.randn(n, d)).astype(np.float32)
        perm = rs.permutation(d)
        for j in range(len(sizes)):
            r[:, perm[j]] += f[:, j] * (0.5 + 0.2 * m)
        r[:, perm[-1]] = 0.0
        act = np.where(r.var(0) > 1e-3, 1.0, 0.0)
        fns.append(lambda o, r=r, act=act: (r[np.asarray(o)], act))
    return fns


@pytest.mark.parametrize("correlation", ["lasso", "spearman"])
def test_compute_udr_matches_jax(correlation):
    sizes = (3, 4, 5)
    n = int(np.prod(sizes))
    fns = _models(sizes)
    kw = dict(batch_size=50, num_data_points=500,
              correlation_matrix=correlation)
    theirs = judr.compute_udr(JIndexBacked(np.arange(n), sizes), fns,
                              np.random.RandomState(0), **kw)
    ours = udr.compute_udr(IndexBackedDataset(np.arange(n), sizes), fns,
                           np.random.RandomState(0), **kw)
    assert list(ours) == list(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0,
                                   atol=UDR_TOL[correlation], err_msg=k)
    assert 0.1 < min(theirs["model_scores"])


@pytest.fixture
def tiny_runs(tmp_path, monkeypatch):
    """The tiny config and two checkpoints of its seeded fresh inits: a
    harness checkpoint directory (seed 1) and a compact npz (seed 2)."""
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
    ckpts = []
    for seed in (1, 2):
        trainer = harness.Trainer(config, lightning, seed=seed,
                                  logdir=str(tmp_path / f"run{seed}"),
                                  device="cpu")
        trainer._ensure_state()
        path = str(tmp_path / f"run{seed}" / "last")
        trainer.save_checkpoint(path)
        ckpts.append(path if seed == 1 else path + "/model.npz")
    yield str(cfg), ckpts
    harness.clear_device_cache()


@pytest.mark.parametrize("correlation", ["lasso", "spearman"])
def test_udr_eval_cli_on_the_cpu(tiny_runs, tmp_path, correlation):
    cfg, ckpts = tiny_runs
    out = tmp_path / "udr.json"
    record = {}
    scores = udr_eval.main(["-b", cfg, "-r", *ckpts, "--num_data_points",
                            "200", "--batch_size", "50", "--correlation",
                            correlation, "--out", str(out), "--device",
                            "cpu"], record=record)
    written = json.loads(out.read_text())
    assert written["model_scores"] == scores["model_scores"]
    assert len(scores["model_scores"]) == 2
    assert len(written["activity_vectors"]) == 2
    # the codes are the checkpoints' Encoder4 codes of the rows drawn
    images = render_all_v4(16, factor_sizes=TINY_GRID)
    rs = np.random.RandomState(0)
    obs = [JIndexBacked(np.arange(64), TINY_GRID).sample_observations(
        50, rs) for _ in range(4)]
    for ck, seen in zip(ckpts, record["outputs"]):
        model = LatentDiffusion(TINY["model"]["params"], device="cpu")
        model.load_variables(*load_model_variables(
            ck if ck.endswith(".npz") else ck + "/model.npz"))
        if not ck.endswith(".npz"):  # the directory's fp32 weights
            side = torch.load(ck + "/train_state.pt", weights_only=True)
            model.cond_stage_model.load_state_dict(side["cond"])
        for o, (codes, act) in zip(obs, seen):
            want = model.cond_encoding(
                torch.from_numpy(images[o]).float() / 127.5 - 1.0).numpy()
            np.testing.assert_allclose(codes, want, **CODE_TOL)
    # the scores: the JAX compute_udr on the same codes
    fns = []
    for seen in record["outputs"]:
        it = iter(seen)
        fns.append(lambda o, it=it: next(it))
    theirs = judr.compute_udr(JIndexBacked(np.arange(64), TINY_GRID), fns,
                              np.random.RandomState(0), **record["kwargs"])
    for k in ("model_scores", "pairwise_disentanglement_scores"):
        np.testing.assert_allclose(scores[k], theirs[k], rtol=0,
                                   atol=UDR_TOL[correlation], err_msg=k)
    again = udr_eval.replay(record)
    assert again["model_scores"] == scores["model_scores"]
