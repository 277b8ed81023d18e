"""The VQ-GAN step without LPIPS (``perceptual_weight: 0``, the 27,648-image
VQ YAMLs ``synthetic_shapes_vq.yaml`` and ``synthetic-bands27k-vq.yaml``)
held against the JAX package's, on the CPU.

- At ``tests/test_torch_vq_step.py``'s narrow width (VQ ch 32, ch_mult (1,
  2), one res block, 64 codes, 32 px, B = 2), the port's and the JAX
  ``vq_trainer`` steps start from the same seeded weights with no LPIPS
  variables (neither loss builds its LPIPS module: the reconstruction term
  is the L1 alone, and the adaptive weight is taken through it), take a
  step on a uint8 batch, then the port takes the JAX state across and both
  take a second on another batch: every logged value to 1e-5 relative and
  every leaf, Adam moment and batch statistic to 1e-4 relative L2, with
  that file's rule for the elements whose gradient is rounding.
- ``main_val -b shapes_vq`` at that width on a 32-image v1 grid trains
  without LPIPS through the harness: no LPIPS leaf in its model, its
  checkpoint or its compact file, and ``test()`` logs a perceptual loss of
  0 beside finite others.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.core.compact_ckpt import load_compact as jax_load_compact
from encdiff_tpu.models.autoencoder import VQModel as JVQModel
from encdiff_tpu.train import vq_trainer as jvq
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.configs import SHAPES_VQ_RUN
from encdiff_tpu_torch.data import synthetic_shapes
from encdiff_tpu_torch.models.autoencoder import VQModel
from encdiff_tpu_torch.train import harness, vq_trainer
from encdiff_tpu_torch.train.checkpoint_io import STATE_FILE
from test_torch_vq_step import (B, DD, LOSS, LR, _seeded, check_leaves,
                                compare_logs, run_both, unmoved)
from torch_threads import one_thread  # noqa: F401

#: the VQ YAMLs' loss at perceptual_weight 0
LOSS0 = {**LOSS, "perceptual_weight": 0.0}
TINY_GRID = [2, 2, 2, 2, 1, 2]  # 32 images
TINY_VQ = ["model.params.ddconfig.resolution=32",
           "model.params.ddconfig.ch_mult=[1,2]",
           "model.params.ddconfig.num_res_blocks=1",
           "model.params.n_embed=64", "data.params.batch_size=4",
           "data.params.train.params.image_size=32",
           "data.params.validation.params.image_size=32"]


@pytest.fixture(scope="module")
def steps():
    jmodel = JVQModel(ddconfig=DD, n_embed=64, embed_dim=3,
                      lossconfig={"target": "encdiff_tpu.losses.gan."
                                            "VQLPIPSWithDiscriminator",
                                  "params": LOSS0})
    assert jmodel.loss.lpips is None
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    gen_shapes = jax.eval_shape(jmodel.module.init, jax.random.PRNGKey(0),
                                x)["params"]
    disc_shapes = jax.eval_shape(lambda: jmodel.loss.discriminator.init(
        jax.random.PRNGKey(0), x, train=False))
    zeros = lambda t: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                   dict(t))
    gen = _seeded(zeros(gen_shapes), 0)
    dvars = _seeded(zeros(disc_shapes), 1)
    gen_tx, disc_tx = jvq.make_optimizers(LR, lr_g_factor=jmodel.lr_g_factor)
    state = jvq.VQTrainState(
        step=jnp.asarray(0, jnp.int32), gen_params=gen,
        disc_params=dvars["params"], disc_batch_stats=dvars["batch_stats"],
        loss_vars={}, gen_opt=gen_tx.init(gen),
        disc_opt=disc_tx.init(dvars["params"]))
    model = VQModel(DD, lossconfig={
        "target": "encdiff_tpu_torch.losses.gan.VQLPIPSWithDiscriminator",
        "params": LOSS0}, n_embed=64, embed_dim=3)
    assert model.loss.lpips is None
    model.load_vq_state(convert.vq_state_dicts(jax.tree.map(np.asarray,
                                                            state)))
    pstate = vq_trainer.create_vq_train_state(model, LR)
    rs = np.random.RandomState(2)
    batches = [rs.randint(0, 256, (B, 32, 32, 3), dtype=np.uint8)
               for _ in range(2)]
    out, _ = run_both(jmodel, state, gen_tx, disc_tx, model, pstate, batches)
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_lpips_free_logs_match_jax(steps, step):
    log, jlog, _, _, _ = steps[step]
    compare_logs(log, jlog)
    assert log["train/p_loss"].item() == 0.0
    # the reconstruction term is the L1 alone
    assert log["train/rec_loss"].item() == log["train/nll_loss"].item()
    assert 0.0 < log["train/d_weight"].item() < 0.75 * 1e4


@pytest.mark.parametrize("step", [0, 1])
def test_lpips_free_leaves_match_jax(steps, step):
    port, want, before = steps[step][2:]
    check_leaves(port, want, before)
    assert unmoved(port, before, "generator") == []
    assert unmoved(port, before, "discriminator") == []


def test_shapes_vq_trains_without_lpips_through_the_harness(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(synthetic_shapes.SyntheticShapes3D, "factor_sizes",
                        TINY_GRID)
    assert SHAPES_VQ_RUN["model"]["params"]["lossconfig"]["params"][
        "perceptual_weight"] == 0.0
    try:
        trainer = harness.main(["-b", "shapes_vq", "-t", "--max_steps", "2",
                                "--val_batches", "1", "--device", "cpu",
                                "-l", str(tmp_path), *TINY_VQ])
    finally:
        harness.clear_device_cache()
        synthetic_shapes.clear_cache()
    assert trainer.is_vq and trainer.state.step == 2
    assert trainer.model.loss.lpips is None
    assert len(trainer.data.dataset("train")) == 32
    last = os.path.join(trainer.ckptdir, "last", STATE_FILE)
    saved = torch.load(last, weights_only=False)["model"]
    assert not [k for k in saved if "lpips" in k]
    tree = jax_load_compact(os.path.join(trainer.ckptdir,
                                         "compact_last.npz"))
    assert "lpips" not in json.dumps(jax.tree.map(lambda v: 0, tree))
    with open(os.path.join(trainer.logdir, "test_results.json")) as f:
        results = json.load(f)
    assert results["val/p_loss"] == 0.0
    assert results["val/rec_loss"] == results["val/nll_loss"]
    assert np.isfinite(list(results.values())).all()
