"""The VQ-GAN trainer behind the port's ``main_val``, held against the JAX
package, on the CPU.

A narrow VQ-GAN config (``TINY_VQ``: the flagship VQ's layout at ch 32,
ch_mult (1, 2), one res block, 64 codes, 32 px, LPIPS and the PatchGAN on,
B = 4) over the v4 grid patched to 64 images, through
``main(["-b", <json>, "-t", "--max_steps", "3", "--val_batches", "2",
"--device", "cpu"])``:

- the run writes the JAX harness's files: the configs, the image logs of
  inputs and reconstructions (``.npy`` grids) at step 2, ``last`` with both
  Adam states at count 3, ``compact_last.npz`` and ``test_results.json``;
- the JAX ``load_compact`` and ``VQModel.load_reference_checkpoint`` read
  ``compact_last.npz``, and the JAX model decodes from it as the port does
  from the same file, to 1e-5;
- ``test_results.json`` equals the means of the JAX eval step over the same
  two validation batches on the run's final fp32 state, to 1e-5 relative;
- resuming a VQ-GAN run is refused, as the JAX ``fit_vq`` has no resume;
- ``-b flagship_vq`` is registered and is ``FLAGSHIP_VQ_RUN``.
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
from encdiff_tpu_torch.configs import FLAGSHIP_VQ_RUN
from encdiff_tpu_torch.core.compact_ckpt import load_compact
from encdiff_tpu_torch.data import synthetic_shapes
from encdiff_tpu_torch.data.synthetic_shapes import render_all_v4
from encdiff_tpu_torch.models.autoencoder import VQModel
from encdiff_tpu_torch.train import harness, vq_trainer
from encdiff_tpu_torch.train.checkpoint_io import STATE_FILE
from torch_threads import one_thread  # noqa: F401

REL = 1e-5
TINY_GRID = [2, 2, 2, 2, 2, 2]  # 64 images
DD = dict(double_z=False, z_channels=3, resolution=32, in_channels=3,
          out_ch=3, ch=32, ch_mult=[1, 2], num_res_blocks=1,
          attn_resolutions=[], dropout=0.0)
LOSS = {"target": "encdiff_tpu_torch.losses.gan.VQLPIPSWithDiscriminator",
        "params": dict(disc_conditional=False, disc_in_channels=3,
                       disc_start=0, disc_weight=0.75, codebook_weight=1.0,
                       perceptual_weight=1.0)}
DATA = {"target": "encdiff_tpu_torch.data.synthetic_shapes."
                  "SyntheticShapes3DV4FullTrain", "params": {"image_size": 32}}
TINY_VQ = {
    "model": {"base_learning_rate": 1e-4,
              "target": "encdiff_tpu_torch.models.autoencoder.VQModel",
              "params": {"embed_dim": 3, "n_embed": 64,
                         "monitor": "val/rec_loss", "ddconfig": DD,
                         "lossconfig": LOSS}},
    "data": {"target": "encdiff_tpu_torch.train.data.DataModuleFromConfig",
             "params": {"batch_size": 4, "train": DATA, "validation": DATA}},
    "lightning": {"callbacks": {"image_logger": {
        "target": "encdiff_tpu_torch.train.callbacks.ImageLogger",
        "params": {"batch_frequency": 2, "max_images": 8,
                   "increase_log_steps": False}}},
        "trainer": {"max_epochs": 2}},
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI's 3-step run; (trainer, logdir, the grid)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(synthetic_shapes.SyntheticShapes3DV4Full, "factor_sizes",
               TINY_GRID)
    tmp = tmp_path_factory.mktemp("vq")
    cfg = tmp / "tiny_vq.json"
    cfg.write_text(json.dumps(TINY_VQ))
    try:
        trainer = harness.main(["-b", str(cfg), "-t", "--max_steps", "3",
                                "--val_batches", "2", "--device", "cpu",
                                "-l", str(tmp / "logs")])
    finally:
        mp.undo()
    harness.clear_device_cache()
    return trainer, trainer.logdir, render_all_v4(32, factor_sizes=TINY_GRID)


def test_run_writes_the_harness_files(run):
    trainer, logdir, _ = run
    assert trainer.is_vq and trainer.state.step == 3
    assert sorted(os.listdir(os.path.join(logdir, "configs")))[0].endswith(
        "-lightning.json")
    for key in ("inputs", "reconstructions"):
        grid = np.load(os.path.join(logdir, "images", "train",
                                    f"{key}_gs-000002.npy"))
        assert grid.shape == (2 * 34 + 2, 4 * 34 + 2, 3), key
        assert grid.dtype == np.uint8
    saved = torch.load(os.path.join(logdir, "checkpoints", "last", STATE_FILE),
                       weights_only=False)
    assert saved["step"] == 3
    for name in ("gen_opt", "disc_opt"):
        counts = {float(s["step"]) for s in saved[name]["state"].values()}
        assert counts == {3.0}, name
    assert os.path.exists(os.path.join(logdir, "checkpoints",
                                       "compact_last.npz"))
    with open(os.path.join(logdir, "test_results.json")) as f:
        results = json.load(f)
    assert results["val/d_weight"] == 0.75
    assert all(np.isfinite(v) for v in results.values())


def _jax_model():
    return JVQModel(ddconfig=DD, n_embed=64, embed_dim=3,
                    lossconfig={"target": "encdiff_tpu.losses.gan."
                                          "VQLPIPSWithDiscriminator",
                                "params": LOSS["params"]})


def test_jax_reads_the_compact_checkpoint(run):
    _, logdir, grid = run
    path = os.path.join(logdir, "checkpoints", "compact_last.npz")
    tree = jax_load_compact(path)["state"]
    assert int(tree["step"]) == 3
    assert set(tree) == {"gen_params", "disc_params", "disc_batch_stats",
                         "loss_vars", "step"}
    jmodel = _jax_model()
    template = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        dict(jax.eval_shape(jmodel.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))))
    variables = jmodel.load_reference_checkpoint(template, path)
    x = grid[[0, 9, 27, 63]].astype(np.float32) / 127.5 - 1.0
    want = np.asarray(jmodel.reconstruct(variables, x))

    port = VQModel(DD, lossconfig=LOSS, n_embed=64, embed_dim=3)
    port.load_vq_state(convert.vq_state_dicts(load_compact(path)["state"]))
    with torch.no_grad():
        got = port.reconstruct(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=REL, atol=REL)


def test_test_results_match_the_jax_eval_step(run):
    trainer, logdir, grid = run
    # the run's final fp32 state, from its last checkpoint
    saved = torch.load(os.path.join(logdir, "checkpoints", "last", STATE_FILE),
                       weights_only=False)
    port = VQModel(DD, lossconfig=LOSS, n_embed=64, embed_dim=3)
    port.load_state_dict(saved["model"])
    fields = convert.vq_flax_state(port, saved["step"])
    jmodel = _jax_model()
    gen_tx, disc_tx = jvq.make_optimizers(1e-4)
    state = jvq.VQTrainState(
        step=jnp.asarray(fields["step"]), gen_params=fields["gen_params"],
        disc_params=fields["disc_params"],
        disc_batch_stats=fields["disc_batch_stats"],
        loss_vars=fields["loss_vars"],
        gen_opt=gen_tx.init(fields["gen_params"]),
        disc_opt=disc_tx.init(fields["disc_params"]))
    eval_fn = jvq.build_vq_eval_step(jmodel, jmodel.loss)
    rows = [{k: float(v) for k, v in eval_fn(state, grid[i * 4:(i + 1) * 4])
             .items()} for i in range(2)]
    with open(os.path.join(logdir, "test_results.json")) as f:
        results = json.load(f)
    assert set(results) == set(rows[0])
    for k in rows[0]:
        np.testing.assert_allclose(results[k], np.mean([r[k] for r in rows]),
                                   rtol=REL, atol=1e-7, err_msg=k)
    # and the run's own state gives them again (on another thread count)
    assert trainer.validate_vq() == pytest.approx(results, rel=REL)


def test_resuming_a_vq_run_is_refused(run, tmp_path):
    _, logdir, _ = run
    cfg = tmp_path / "tiny_vq.json"
    cfg.write_text(json.dumps(TINY_VQ))
    with pytest.raises(NotImplementedError, match="fresh init"):
        harness.main(["-b", str(cfg), "-t", "--max_steps", "1",
                      "--resume_ckpt", os.path.join(logdir, "checkpoints",
                                                    "last"),
                      "--device", "cpu", "-l", str(tmp_path / "logs")])


def test_flagship_vq_is_registered():
    assert harness.REGISTERED["flagship_vq"] is FLAGSHIP_VQ_RUN
    config = harness.load_configs(["flagship_vq"], ["model.params.n_embed=16"])
    assert config["model"]["params"]["n_embed"] == 16
    assert FLAGSHIP_VQ_RUN["model"]["params"]["n_embed"] == 2048
    assert vq_trainer.as_images(torch.zeros(1, 2, 2, 3, dtype=torch.uint8)
                                ).shape == (1, 3, 2, 2)
