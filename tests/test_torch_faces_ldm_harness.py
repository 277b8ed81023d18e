"""``main_val -b faces`` over a ``-b faces_vq`` run, on the CPU, against the
JAX package.

A tiny pipeline (``test_torch_faces_ldm_ingest``'s layouts): a faces VQ-GAN
run (32 px, one update), then ``-b faces -t --max_steps 8`` over its
``checkpoints/last`` by the JAX pipeline's override spelling, on the
16-face grid at micro-batch 2 with the config's 4-way accumulation, with
the image logger forced to step 8 (DDIM 2, the faces YAML's flags):

- two updates at the reference's LR, 4 x 2 x 2e-6, times the warm-up of
  the optimizer's own count; no trainable leaf moves on a micro-step that
  does not end an update, and AdamW steps every leaf on each update; the
  EMA stands still until the first update and moves on every micro-step
  from it on; ``last`` (``model.npz``, ``train_state.pt``), the image log's
  grids and an empty ``test_results.json`` (no validation metrics);
- the latent cache equal to the JAX ``precompute_latents`` on the same
  first stage (the run's, carried across as a flax tree) to ``REL``
  (1e-5);
- ``last/model.npz`` read by the JAX ``load_model_variables``: its first
  stage decodes a seeded latent (with seeded scalars) as the port's
  ``LatentDiffusion.from_checkpoint(<last>)`` does, to ``REL``, and its
  codes agree;
- a run of 4 micro-steps resumed with ``-r`` to 8 ends bit for bit where
  the straight run ends (parameters, AdamW, the EMA).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.models.autoencoder import VQModelInterface as JInterface
from encdiff_tpu.train import loop as jloop
from encdiff_tpu.train.checkpoint_io import load_model_variables as jax_load
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.data import synthetic_faces
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.train import harness
from encdiff_tpu_torch.train.checkpoint_io import MODEL_FILE, STATE_FILE
from encdiff_tpu_torch.train.loop import trainable_parameters
from test_torch_faces_ldm_ingest import TINY_GRID, TINY_LDM, tiny_vq_run

REL = 1e-5
STEPS = 8
#: the image logger at step 8 only, its DDIM at 2 steps
LOG = ["lightning.callbacks.image_logger.params.batch_frequency=8",
       "lightning.callbacks.image_logger.params.log_images_kwargs."
       "ddim_steps=2"]


def _main(argv, record=None):
    """``harness.main`` on the tiny grid and one torch thread; ``record``
    collects the latent cache and, per micro-step, the trainable leaves
    that moved and whether the EMA moved."""
    mp = pytest.MonkeyPatch()
    mp.setattr(synthetic_faces.SyntheticFaces, "factor_sizes", TINY_GRID)
    if record is not None:
        latents_fn, step_fn = harness.precompute_latents, harness.train_step

        def precompute_latents(model, images, *a, **kw):
            record["z"] = latents_fn(model, images, *a, **kw)
            record["images"] = images
            return record["z"]

        def train_step(model, state, batch, **kw):
            params = trainable_parameters(model)
            before = {k: p.detach().clone() for k, p in params.items()}
            ema = {k: v.clone() for k, v in state.ema.params.items()}
            out = step_fn(model, state, batch, **kw)
            record["moved"].append(
                (state.step, sum(not torch.equal(p, before[k])
                                 for k, p in params.items())))
            record["ema"].append(any(not torch.equal(v, ema[k])
                                     for k, v in state.ema.params.items()))
            return out
        record.update(moved=[], ema=[])
        mp.setattr(harness, "precompute_latents", precompute_latents)
        mp.setattr(harness, "train_step", train_step)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.main([*argv, "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
        mp.undo()
        harness.clear_device_cache()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the straight 8-step run's trainer, its records, the resumed run's
    trainer, the VQ run's logdir)."""
    tmp = tmp_path_factory.mktemp("faces_ldm")
    vq = tiny_vq_run(tmp / "vq")
    ckpt = ("model.params.first_stage_config.params.ckpt_path="
            + os.path.join(vq, "checkpoints", "last"))
    base = ["-b", "faces", "-t", "-l", str(tmp / "ldm"), *TINY_LDM, ckpt]
    record = {}
    straight = _main([*base, "--max_steps", str(STEPS), *LOG], record)
    first = _main([*base, "--max_steps", str(STEPS // 2), "--no-test"])
    resumed = _main(["-r", first.logdir, "-t", "--max_steps", str(STEPS),
                     "--no-test"])
    return straight, record, resumed, vq


def test_two_updates_at_the_reference_lr(runs):
    trainer, record, _, _ = runs
    state = trainer.state
    assert (state.step, state.updates, trainer.accumulate) == (STEPS, 2, 4)
    assert trainer.learning_rate == pytest.approx(4 * 2 * 2e-6, rel=1e-12)
    warm = lambda n: 1e-6 + (1.0 - 1e-6) * n / 10000
    # each micro-step logs the LR of the update it feeds: AdamW's count
    # before it
    history = trainer.lr_monitor.history
    assert [s for s, _ in history] == list(range(1, STEPS + 1))
    for step, lr in history:
        assert lr == pytest.approx(1.6e-5 * warm((step - 1) // 4),
                                   rel=1e-6), step
    # the parameters move on the 4th and 8th micro-steps only, AdamW has
    # stepped every leaf twice (at the warm-up's first LRs, 1.6e-11 and
    # 1.6e-9, most leaves cannot change in fp32), and the EMA moves on every
    # micro-step from the first update on
    assert [s for s, n in record["moved"] if n] == [4, 8]
    params = trainable_parameters(trainer.model).values()
    assert all(int(state.optimizer.state[p]["step"]) == 2 for p in params)
    assert record["ema"] == [False] * 3 + [True] * 5


def test_run_writes_last_the_image_log_and_test_results(runs):
    trainer, _, _, _ = runs
    last = os.path.join(trainer.ckptdir, "last")
    assert sorted(os.listdir(last)) == sorted([MODEL_FILE, STATE_FILE])
    root = os.path.join(trainer.logdir, "images", "train")
    assert sorted(os.listdir(root)) == sorted(
        f"{k}_gs-{STEPS:06}.npy" for k in
        ("inputs", "reconstruction", "conditioning", "diffusion_row",
         "samples"))
    for name in os.listdir(root):
        assert np.isfinite(np.load(os.path.join(root, name))).all()
    with open(os.path.join(trainer.logdir, "test_results.json")) as f:
        assert json.load(f) == {}


def test_latent_cache_matches_jax_precompute(runs):
    trainer, record, _, _ = runs
    fs = trainer.model.first_stage_model
    dd = fs.ddconfig
    jvq = JInterface(ddconfig=dd, n_embed=fs.n_embed, embed_dim=3,
                     use_disentangled_concat=True, disentangled_dim=20)
    frozen = {"first_stage": {"params": convert.flax_variables(fs)[0]}}
    images = record["images"].numpy()
    cache, hwc = jloop.precompute_latents(
        types.SimpleNamespace(encode_first_stage=jvq.encode), frozen,
        jnp.asarray(images.reshape(len(images), -1)))
    want = np.asarray(cache["z"]).reshape(len(images), *hwc)
    assert record["z"].shape == want.shape == (16, 16, 16, 3)
    np.testing.assert_allclose(record["z"].numpy(), want, rtol=REL,
                               atol=REL)


def test_jax_reads_last_and_decodes_as_the_port(runs):
    trainer, _, _, _ = runs
    last = os.path.join(trainer.ckptdir, "last")
    variables, sf = jax_load(None, os.path.join(last, MODEL_FILE))
    config = trainer.model_params
    port = LatentDiffusion.from_checkpoint(last, device="cpu", config=config)
    assert sf == pytest.approx(float(trainer.state.scale_factor), rel=1e-7)
    dd = config["first_stage_config"]["ddconfig"]
    jvq = JInterface(ddconfig=dd, n_embed=64, embed_dim=3,
                     use_disentangled_concat=True, disentangled_dim=20)
    rs = np.random.RandomState(31)
    z = rs.randn(2, 16, 16, 3).astype(np.float32)
    u = rs.randn(2, 20).astype(np.float32)
    fs_vars = jax.tree.map(jnp.asarray, variables["first_stage"])
    ref = np.asarray(jax.jit(lambda v, z, u: jvq.decode(
        v, z / sf, True, u))(fs_vars, z, u))
    out = port.decode_first_stage(z, disentangled_repr=torch.from_numpy(u),
                                  force_not_quantize=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=REL, atol=REL)
    _, _, (_, _, idx_ref) = jvq.module.apply(
        fs_vars, jnp.asarray(z), method=lambda m, h: m.quantize(h))
    _, _, (_, _, idx) = port.first_stage_model.quantize(
        torch.from_numpy(z).permute(0, 3, 1, 2))
    assert (idx.numpy() == np.asarray(idx_ref)).mean() >= 0.99


def test_resume_within_the_epoch_is_bit_for_bit(runs):
    straight, _, resumed, _ = runs
    assert (resumed.state.step, resumed.state.updates) == (STEPS, 2)
    a, b = (trainable_parameters(t.model) for t in (straight, resumed))
    for k, p in a.items():
        assert torch.equal(p, b[k]), k
        for name, v in straight.state.optimizer.state[p].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                resumed.state.optimizer.state[b[k]][name])), (k, name)
    for k, v in straight.state.ema.params.items():
        assert torch.equal(v, resumed.state.ema.params[k]), k
    assert torch.equal(straight.state.scale_factor,
                       resumed.state.scale_factor)
