"""``-b faces_vq`` behind the port's ``main_val``, on the CPU.

- ``FACES_VQ_RUN`` equals ``configs/demo/synthetic-faces-vq.yaml`` with the
  port's targets, and ``-b faces_vq`` builds a trainer at the reference's
  LR, 4 (accumulation) x 8 (batch) x 4.5e-6 = 1.44e-4.
- The harness composes the face grid on its own ``--device``.
- ``device_images`` drops the grid it holds before it uploads another (the
  flagship's 5.9 GB before the faces' 6.8 GB on the card).
- ``main(["-b", "faces_vq", "-t", "--max_steps", "8", "--val_batches",
  "2", "--device", "cpu", ...])`` at a tiny size (the faces VQ's layout at
  32 px, ch_mult (1, 2), one res block, 64 codes, micro-batch 2 with the
  config's 4-way accumulation, on a 16-image face grid): two updates, the
  image logger's warm-up logs, ``last``, ``test_results.json`` and a
  ``compact_last.npz`` that the JAX ``load_compact`` and
  ``VQModel.load_reference_checkpoint`` read, the JAX model decoding from
  it as the port does to ``REL`` (1e-5).
"""

import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from encdiff_tpu.core.compact_ckpt import load_compact as jax_load_compact
from encdiff_tpu.models.autoencoder import VQModel as JVQModel
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.configs import FACES_VQ_RUN
from encdiff_tpu_torch.core.compact_ckpt import load_compact
from encdiff_tpu_torch.data import synthetic_faces
from encdiff_tpu_torch.models.autoencoder import VQModel
from encdiff_tpu_torch.train import harness, vq_trainer
from encdiff_tpu_torch.train.checkpoint_io import STATE_FILE
from test_torch_harness import _port_target
from torch_threads import one_thread  # noqa: F401

YAML = os.path.join(os.path.dirname(__file__), os.pardir,
                    "configs/demo/synthetic-faces-vq.yaml")
REL = 1e-5
TINY_GRID = (2, 1, 2, 1, 2, 1, 2)  # 16 faces
SIZE = 32
DD = {**FACES_VQ_RUN["model"]["params"]["ddconfig"], "resolution": SIZE,
      "ch_mult": [1, 2], "num_res_blocks": 1}
#: dotlist overrides of the tiny run: the faces VQ's layout at 32 px
TINY = [f"model.params.ddconfig.resolution={SIZE}",
        "model.params.ddconfig.ch_mult=[1,2]",
        "model.params.ddconfig.num_res_blocks=1", "model.params.n_embed=64",
        "data.params.batch_size=2",
        f"data.params.train.params.image_size={SIZE}",
        f"data.params.validation.params.image_size={SIZE}"]


@pytest.fixture
def tiny_grid(monkeypatch):
    monkeypatch.setattr(synthetic_faces.SyntheticFaces, "factor_sizes",
                        TINY_GRID)
    yield
    harness.clear_device_cache()


def test_faces_vq_run_matches_yaml():
    with open(YAML) as f:
        ref = yaml.safe_load(f)
    assert FACES_VQ_RUN == _port_target(ref)
    assert harness.REGISTERED["faces_vq"] is FACES_VQ_RUN


def test_faces_vq_learning_rate_and_accumulation(tiny_grid, tmp_path):
    trainer = harness.main(["-b", "faces_vq", "--device", "cpu", "-l",
                            str(tmp_path),
                            f"data.params.train.params.image_size={SIZE}",
                            f"data.params.validation.params.image_size={SIZE}",
                            f"model.params.ddconfig.resolution={SIZE}"])
    assert trainer.is_vq and trainer.state is None
    assert (trainer.batch_size, trainer.accumulate) == (8, 4)
    assert trainer.learning_rate == pytest.approx(1.44e-4, rel=1e-12)
    assert len(trainer.data.dataset("train")) == int(np.prod(TINY_GRID))


def test_the_grid_is_composed_on_the_harness_device(tiny_grid, monkeypatch,
                                                    tmp_path):
    seen = []
    render = synthetic_faces.render_faces

    def recording(*args, device=None):
        seen.append(device)
        return render(*args, device=device)
    monkeypatch.setattr(synthetic_faces, "render_faces", recording)
    monkeypatch.setattr(synthetic_faces, "_CACHE", {})
    harness.main(["-b", "faces_vq", "--device", "cpu", "-l", str(tmp_path),
                  f"data.params.train.params.image_size={SIZE}",
                  f"data.params.validation.params.image_size={SIZE}",
                  f"model.params.ddconfig.resolution={SIZE}"])
    assert [str(d) for d in seen] == ["cpu"]


def test_device_images_drops_the_held_grid_first(monkeypatch):
    first = np.zeros((2, 4, 4, 3), np.uint8)
    held = weakref.ref(harness.device_images(first, "cpu"))
    seen = []
    upload = torch.from_numpy

    def from_numpy(a):
        seen.append(held() is None)
        return upload(a)
    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    second = np.ones((2, 4, 4, 3), np.uint8)
    out = harness.device_images(second, "cpu")
    assert seen == [True] and torch.equal(out, upload(second))
    assert harness.device_images(second, "cpu") is out
    harness.clear_device_cache()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI's 8-micro-step run; (trainer, logdir)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(synthetic_faces.SyntheticFaces, "factor_sizes", TINY_GRID)
    tmp = tmp_path_factory.mktemp("faces_vq")
    try:
        trainer = harness.main(["-b", "faces_vq", "-t", "--max_steps", "8",
                                "--val_batches", "2", "--device", "cpu",
                                "-l", str(tmp / "logs"), *TINY])
    finally:
        mp.undo()
        harness.clear_device_cache()
    return trainer, trainer.logdir


def test_run_takes_two_updates_and_writes_the_harness_files(run):
    trainer, logdir = run
    assert trainer.state.step == 8 and trainer.accumulate == 4
    assert trainer.learning_rate == pytest.approx(4 * 2 * 4.5e-6, rel=1e-12)
    assert (vq_trainer.optimizer_count(trainer.state.gen_opt),
            vq_trainer.optimizer_count(trainer.state.disc_opt)) == (2, 2)
    for step in (1, 2, 4, 8):
        for key in ("inputs", "reconstructions"):
            assert os.path.exists(os.path.join(
                logdir, "images", "train", f"{key}_gs-{step:06}.npy"))
    saved = torch.load(os.path.join(logdir, "checkpoints", "last",
                                    STATE_FILE), weights_only=False)
    assert saved["step"] == 8 and saved["gen_acc"]["accumulate"] == 4
    with open(os.path.join(logdir, "test_results.json")) as f:
        results = json.load(f)
    assert results and all(np.isfinite(v) for v in results.values())


def test_jax_reads_the_compact_checkpoint(run):
    _, logdir = run
    path = os.path.join(logdir, "checkpoints", "compact_last.npz")
    tree = jax_load_compact(path)["state"]
    assert int(tree["step"]) == 8
    assert set(tree) == {"gen_params", "disc_params", "disc_batch_stats",
                         "loss_vars", "step"}
    jmodel = JVQModel(ddconfig=DD, n_embed=64, embed_dim=3)
    template = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        dict(jax.eval_shape(jmodel.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))))
    variables = jmodel.load_reference_checkpoint(template, path)
    grid = synthetic_faces.render_faces(SIZE, TINY_GRID)
    x = grid[[0, 5, 10, 15]].astype(np.float32) / 127.5 - 1.0
    want = np.asarray(jmodel.reconstruct(variables, x))

    port = VQModel(DD, n_embed=64, embed_dim=3,
                   lossconfig=FACES_VQ_RUN["model"]["params"]["lossconfig"])
    port.load_vq_state(convert.vq_state_dicts(load_compact(path)["state"]))
    with torch.no_grad():
        got = port.reconstruct(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=REL, atol=REL)
