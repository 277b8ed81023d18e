"""The Cars3D chain through the port's harness on the CPU, held against the
JAX package.

A tiny chain as ``scripts/round4b_pipeline.sh:107-116`` runs it: ``-b
cars3d_vq -t --no-test -s 23 -n carsvq`` (the flagship VQ's layout at 32
px, one res block, 64 codes, B = 8, 2 steps), then ``-b cars3d -s 23 -n
carsld`` over its ``checkpoints/last`` with the pipeline's HSIC overrides
(UNet model_channels 32, 16x16x3 latents, B = 8, 3 steps, the image logger
forced to step 3 at DDIM 2 with the swap rows, then ``test()``), on the
Cars3D grid at (2, 4, 7) = 56 images repeated ten times an epoch, with a
56-index ``cars3d`` ground truth registered:

- each step's rows are those of the JAX device path's x10 order
  (``RandomState(seed + epoch).permutation(560)`` modulo 56);
- the latent cache equals the JAX ``precompute_latents`` on the run's
  first stage to ``REL`` (1e-5);
- the port's first steps, with the t and noise the JAX ``loss_fn`` draws
  from the same keys, against the JAX ``build_train_step`` from the same
  starting weights on the same batches, at the YAML's LR (8 x 2e-6 times
  the warm-up's 1e-6 at first), from every trainable leaf redrawn from a
  seed at the first step (the fresh init's zero output convolutions would
  hold most gradients at zero): each step's loss and the scale factor to
  ``REL``; AdamW's first moment, which sums the steps' gradients, and
  every trainable leaf to ``LEAF`` (1e-4 relative L2; a leaf whose exact
  gradient is zero, a bias before a normalisation, is held within 1e-6 of
  the moments' global norm);
- FactorVAE and MIG of ``test()`` equal the JAX ``eval_func``'s on the
  reps it wrote;
- ``epoch_order`` at MPI3D's n = 1,036,800, B = 128 equals the JAX device
  path's permutation.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.core import ema as jema
from encdiff_tpu.core.config import instantiate_from_config as jinstantiate
from encdiff_tpu.core.yamlcfg import OmegaConf
from encdiff_tpu.evalx.eval_driver import eval_func as jeval_func
from encdiff_tpu.evalx.ground_truth.core import \
    IndexBackedDataset as JIndexBacked
from encdiff_tpu.models.autoencoder import VQModelInterface as JInterface
from encdiff_tpu.train import harness as jharness
from encdiff_tpu.train import loop as jloop
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.data import synthetic_cars3d as cars
from encdiff_tpu_torch.evalx.ground_truth import named_data
from encdiff_tpu_torch.evalx.ground_truth.core import IndexBackedDataset
from encdiff_tpu_torch.train import harness
from encdiff_tpu_torch.train.data import epoch_order
from encdiff_tpu_torch.train.loop import trainable_parameters
from test_torch_cross_configs import YAML
from torch_threads import one_thread  # noqa: F401

REL = 1e-5
LEAF = 1e-4
GRID = [2, 4, 7]   # 56 images
N = 56
SIZE = 32
B = 8
SEED = 23
STEPS = 3
VQ = ["model.params.ddconfig.resolution=32",
      "model.params.ddconfig.ch_mult=[1,2]",
      "model.params.ddconfig.num_res_blocks=1", "model.params.n_embed=64",
      f"data.params.batch_size={B}",
      f"data.params.train.params.image_size={SIZE}",
      f"data.params.validation.params.image_size={SIZE}"]
LDM = ["model.params.image_size=16",
       "model.params.unet_config.image_size=16",
       "model.params.unet_config.model_channels=32",
       "model.params.unet_config.channel_mult=[1,2]",
       "model.params.unet_config.num_res_blocks=1",
       "model.params.unet_config.attention_resolutions=[1,2]",
       "model.params.unet_config.num_heads=4",
       "model.params.cond_stage_config.d=32",
       f"model.params.first_stage_config.ddconfig.resolution={SIZE}",
       "model.params.first_stage_config.ddconfig.ch_mult=[1,2]",
       "model.params.first_stage_config.ddconfig.num_res_blocks=1",
       "model.params.first_stage_config.n_embed=64",
       f"data.params.batch_size={B}",
       f"data.params.train.params.image_size={SIZE}",
       f"data.params.validation.params.image_size={SIZE}"]
HSIC = ["model.params.indep_type=hsic", "model.params.lambda_indep=2.0"]
LOG = [f"lightning.callbacks.image_logger.params.batch_frequency={STEPS}",
       "lightning.callbacks.image_logger.params.log_images_kwargs."
       "ddim_steps=2"]


def _jax_spelling(items):
    """Dotlist items with the ``params`` level of the JAX YAML's
    sub-configs, which the port's configs hold flattened."""
    out = []
    for item in items:
        parts = item.split(".")
        if parts[:2] == ["model", "params"] and parts[2] in harness.FLATTENED \
                and parts[3] != "params":
            parts.insert(3, "params")
        out.append(".".join(parts))
    return out


def _redraw(model, gen):
    """Every trainable leaf drawn anew: kernels N(0, 1/fan_in), norm scales
    1 + N(0, 0.1^2), every other leaf N(0, 0.1^2)."""
    with torch.no_grad():
        for name, p in trainable_parameters(model).items():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() > 1:
                fan_in = (p.shape[-2] if name.startswith("cond.warp_mlps.")
                          else p[0].numel())
                p.copy_(noise / fan_in ** 0.5)
            elif name.endswith(".weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def _jax_draw(step):
    """The t and noise the JAX ``loss_fn`` draws from step ``step``'s key."""
    t_rng, n_rng, _ = jax.random.split(jax.random.PRNGKey(100 + step), 3)
    t = jax.random.randint(t_rng, (B,), 0, 1000)
    return np.array(t), np.array(jax.random.normal(n_rng, (B, 16, 16, 3)))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The VQ run's logdir, the LDM trainer and its records: the starting
    weights, each step's batch and loss, the latent cache."""
    tmp = tmp_path_factory.mktemp("cars3d")
    mp = pytest.MonkeyPatch()
    mp.setattr(cars.SyntheticCars3DFull, "factor_sizes", GRID)
    mp.setitem(named_data._REGISTRY, "cars3d",
               lambda images=None: IndexBackedDataset(np.arange(N), GRID))
    record = {"steps": []}
    latents_fn, step_fn = harness.precompute_latents, harness.train_step

    def precompute_latents(model, images, *a, **kw):
        record["images"] = images
        record["z"] = latents_fn(model, images, *a, **kw)
        return record["z"]

    def train_step(model, state, batch, **kw):
        k = len(record["steps"])
        if k == 0:
            _redraw(model, torch.Generator().manual_seed(SEED))
            record["start"] = {
                "unet": {n: v.clone() for n, v in
                         model.unet.state_dict().items()},
                "cond": {n: v.clone() for n, v in
                         model.cond_stage_model.state_dict().items()}}
        t, noise = _jax_draw(k)
        m = step_fn(model, state, batch, t=torch.from_numpy(t).long(),
                    noise=torch.from_numpy(noise))
        record["steps"].append({"batch": {n: v.clone()
                                          for n, v in batch.items()},
                                "loss": float(m["train/loss"])})
        return m

    try:
        vq = harness.main(["-b", "cars3d_vq", "-t", "--no-test", "-l",
                           str(tmp / "runs_cross"), "-s", str(SEED), "-n",
                           "carsvq", "--max_steps", "2", "--device", "cpu",
                           *VQ])
        last = os.path.join(vq.logdir, "checkpoints", "last")
        mp.setattr(harness, "precompute_latents", precompute_latents)
        mp.setattr(harness, "train_step", train_step)
        ldm = harness.main([
            "-b", "cars3d", "-t", "-l", str(tmp / "runs_cross"), "-s",
            str(SEED), "-n", "carsld", "--max_steps", str(STEPS),
            "--device", "cpu", "--eval_metrics", "MIG,factor_VAE",
            f"model.params.first_stage_config.params.ckpt_path={last}",
            *HSIC, *LDM, *LOG])
    finally:
        mp.undo()
        harness.clear_device_cache()
        cars._CACHE.clear()
    return vq, ldm, record


def test_the_runs_write_last_the_image_log_and_test_results(chain):
    vq, ldm, record = chain
    assert vq.state.step == 2 and os.path.basename(vq.logdir).endswith(
        "_carsvq")
    assert len(record["steps"]) == STEPS and ldm.state.step == STEPS
    assert ldm.model_params["indep_type"] == "hsic"
    assert os.path.exists(os.path.join(ldm.ckptdir, "last"))
    root = os.path.join(ldm.logdir, "images", "train")
    assert f"samples_swapping_gs-{STEPS:06}.npy" in os.listdir(root)
    with open(os.path.join(ldm.logdir, "test_results.json")) as f:
        results = json.load(f)
    assert sorted(results) == ["val/factor_vae_score", "val/mig"]
    assert np.load(os.path.join(ldm.logdir, "reps", f"{STEPS}.npy")).shape \
        == (N, 20)


def test_steps_take_the_jax_x10_order(chain):
    _, _, record = chain
    images = record["images"]
    assert len(images) == N
    # encdiff_tpu/train/harness.py:467-475 at len 10 x 56, B = 8
    n = 10 * N
    spe = n // B
    order = (np.random.RandomState(SEED).permutation(n)[: spe * B]
             .astype(np.int32)) % N
    assert spe == 70
    for k, step in enumerate(record["steps"]):
        rows = torch.from_numpy(order[k * B:(k + 1) * B].astype(np.int64))
        assert torch.equal(step["batch"]["image"], images[rows]), k
        assert torch.equal(step["batch"]["z"], record["z"][rows]), k


def test_latent_cache_matches_jax_precompute(chain):
    _, ldm, record = chain
    fs = ldm.model.first_stage_model
    jvq = JInterface(ddconfig=fs.ddconfig, n_embed=fs.n_embed, embed_dim=3,
                     use_disentangled_concat=True, disentangled_dim=20)
    frozen = {"first_stage": {"params": convert.flax_variables(fs)[0]}}
    images = record["images"].numpy()
    cache, hwc = jloop.precompute_latents(
        types.SimpleNamespace(encode_first_stage=jvq.encode), frozen,
        jnp.asarray(images.reshape(N, -1)))
    want = np.asarray(cache["z"]).reshape(N, *hwc)
    assert record["z"].shape == want.shape == (N, 16, 16, 3)
    np.testing.assert_allclose(record["z"].numpy(), want, rtol=REL, atol=REL)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _port_names(tree):
    """A JAX {unet, cond} tree as the port's trainable-parameter names."""
    tree = jax.device_get(tree)
    out = {f"unet.{k}": v.numpy()
           for k, v in convert.flax_to_state_dict(tree["unet"]).items()}
    out.update({f"cond.{k}": v.numpy() for k, v in
                convert.encoder4_state_dict(tree["cond"], {}).items()})
    return out


def test_first_steps_match_the_jax_train_step(chain):
    """The port's steps against ``build_train_step`` from the same
    weights, batches and keys."""
    _, ldm, record = chain
    cfg = OmegaConf.to_container(jharness.load_configs(
        [str(YAML["cars3d"])],
        _jax_spelling([*HSIC, *LDM, "model.params.first_stage_config."
                       "ckpt_path=null"])))
    jmodel = jinstantiate(cfg["model"])
    shapes = jax.eval_shape(
        lambda k: jmodel.init_variables(k, image_resolution=SIZE),
        jax.random.PRNGKey(0))
    start = record["start"]
    unet = convert.state_dict_to_flax(start["unet"],
                                      shapes["unet"]["params"])
    cond, stats = convert.encoder4_to_flax(start["cond"],
                                           shapes["cond"]["params"],
                                           shapes["cond"]["batch_stats"])
    params = jax.tree.map(jnp.asarray, {"unet": unet, "cond": cond})
    lr = B * float(cfg["model"]["base_learning_rate"])
    assert ldm.learning_rate == pytest.approx(lr, rel=1e-12)
    tx = jloop.build_optimizer(jmodel, lr)
    fs = ldm.model.first_stage_model
    frozen = {"first_stage": {"params": jax.tree.map(
        jnp.asarray, convert.flax_variables(fs)[0])}}
    state = jloop.TrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, stats),
        opt_state=tx.init(params), ema=jema.init(params["unet"]),
        scale_factor=jnp.asarray(1.0, jnp.float32))
    step_fn = jloop.build_train_step(jmodel, tx, donate=False)
    for k, step in enumerate(record["steps"]):
        batch = {n: jnp.asarray(v.numpy()) for n, v in step["batch"].items()}
        state, metrics = step_fn(state, frozen, batch,
                                 jax.random.PRNGKey(100 + k))
        want = float(metrics["train/loss"])
        assert step["loss"] == pytest.approx(want, rel=REL), k
    assert float(ldm.state.scale_factor) == pytest.approx(
        float(state.scale_factor), rel=REL)

    # AdamW's first moment: the steps' gradients
    got = trainable_parameters(ldm.model)
    opt = ldm.state.optimizer
    mu = next(s.mu for s in jax.tree.leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(
            s, "mu"))
    want_mu = _port_names(mu)
    assert set(got) == set(want_mu)
    port_mu = {k: opt.state[p]["exp_avg"].numpy() for k, p in got.items()}
    total = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                        for v in want_mu.values()))
    zero = [k for k, v in want_mu.items()
            if np.linalg.norm(v) <= 1e-6 * total]
    for k in zero:
        assert np.linalg.norm(port_mu[k]) <= 1e-6 * total, k
    assert len(zero) < len(want_mu) // 10
    worst = max((_rel_l2(port_mu[k], v), k)
                for k, v in want_mu.items() if k not in zero)
    assert worst[0] <= LEAF, worst

    # every trainable leaf after the steps
    want = _port_names(state.params)
    worst = max((_rel_l2(p.detach().numpy(), want[k]), k)
                for k, p in got.items())
    assert worst[0] <= LEAF, worst


def test_factor_vae_and_mig_equal_jax_on_the_same_reps(chain):
    _, ldm, _ = chain
    reps = np.load(os.path.join(ldm.logdir, "reps", f"{STEPS}.npy"))
    with open(os.path.join(ldm.logdir, "metrics_sin", f"{STEPS}.json")) as f:
        port = json.load(f)
    want = jeval_func(JIndexBacked(np.arange(N), GRID), reps, None, STEPS,
                      metrics=("MIG", "factor_VAE"))
    assert port["MIG"]["discrete_mig"] == pytest.approx(
        want["MIG"]["discrete_mig"], rel=1e-9, abs=1e-12)
    for key in ("train_accuracy", "eval_accuracy", "num_active_dims"):
        assert port["factor_VAE"][key] == want["factor_VAE"][key], key
    with open(os.path.join(ldm.logdir, "test_results.json")) as f:
        results = json.load(f)
    assert results["val/mig"] == port["MIG"]["discrete_mig"]
    assert results["val/factor_vae_score"] == \
        port["factor_VAE"]["eval_accuracy"]


@pytest.mark.parametrize("seed,epoch", [(23, 0), (23, 7)])
def test_epoch_order_at_mpi3d_size_matches_jax(seed, epoch):
    n, bs = 1_036_800, 128
    spe = n // bs
    ref = (np.random.RandomState(seed + epoch).permutation(n)[: spe * bs]
           .astype(np.int32)) % n
    got = epoch_order(seed, epoch, n, bs, n)
    assert spe == 8100 and len(got) == spe * bs
    np.testing.assert_array_equal(got, ref)
