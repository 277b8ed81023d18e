"""The MCL fine-tune's configuration, checkpoints and harness run, on the
CPU.

- ``FLAGSHIP_MCL_RUN`` against the two YAMLs it draws on: the flagship's
  (``configs/demo/synthetic-shapes-v4-full-encdiff.yaml``: the model, the
  v4 grid, the callbacks and the trainer) and the MCL demo's
  (``configs/demo/synthetic-shapes-mcl.yaml``: the MCL keys, the base LR,
  the warmup, the swap-visualization callback); the v1 grid of the latter
  is deliberately not taken.
- A config that names a value the port does not compute is refused, and
  ``-b flagship model.params.use_mcl=true`` builds the MCL heads and trains
  them (it trained the plain diffusion step before).
- Compact checkpoints with ``params/mcl``: one the port writes holds the
  paths and shapes of the JAX ``init_mcl_variables`` tree, so that the JAX
  lenient restore takes every head leaf; one the JAX package writes
  restores the port's heads (fp16 values); a checkpoint directory restores
  them and their AdamW moments exactly; the committed
  ``v4purify_final_fp16.npz``, which has no heads, keeps their fresh init.
- The tiny harness run with MCL and the swap-visualization callback.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch
import yaml

from encdiff_tpu.core.compact_ckpt import load_compact as jax_load_compact
from encdiff_tpu.core.compact_ckpt import save_compact as jax_save_compact
from encdiff_tpu.losses import mcl as jmcl
from encdiff_tpu_torch.configs import (FLAGSHIP_MCL_RUN, FLAGSHIP_RUN,
                                      MCL_KEYS)
from encdiff_tpu_torch.models.latent_diffusion import FIXED, LatentDiffusion
from encdiff_tpu_torch.train import harness
from encdiff_tpu_torch.train.checkpoint_io import (
    MODEL_FILE, fresh_variables, restore_train_checkpoint, save_checkpoint,
    save_train_checkpoint)
from encdiff_tpu_torch.train.loop import create_train_state, train_step
from test_torch_harness import TINY, _write, tiny  # noqa: F401
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP_YAML = ROOT / "configs/demo/synthetic-shapes-v4-full-encdiff.yaml"
MCL_YAML = ROOT / "configs/demo/synthetic-shapes-mcl.yaml"
FLAGSHIP_NPZ = ROOT / "demo_artifacts/round5/v4purify_final_fp16.npz"
MCL_TINY_PARAMS = {**MCL_KEYS, "mcl_proj_dim": 32}
# TINY's latents are 8x8x3, its images 16 px
TINY_Z = (8, 8, 3)


def _port_target(node):
    if isinstance(node, dict):
        return {k: _port_target(v) for k, v in node.items()}
    if isinstance(node, str) and node.startswith("encdiff_tpu."):
        return "encdiff_tpu_torch." + node[len("encdiff_tpu."):]
    return node


def test_flagship_mcl_run_matches_both_yamls():
    with open(FLAGSHIP_YAML) as f:
        flagship = yaml.safe_load(f)
    with open(MCL_YAML) as f:
        mcl = yaml.safe_load(f)
    ours = FLAGSHIP_MCL_RUN
    assert ours["model"]["base_learning_rate"] == mcl["model"][
        "base_learning_rate"] == 2e-7
    params = dict(ours["model"]["params"])
    for key in MCL_KEYS:
        assert params.pop(key) == mcl["model"]["params"][key], key
    sched = params.pop("scheduler_config")
    assert sched == mcl["model"]["params"]["scheduler_config"]["params"]
    assert sched["warm_up_steps"] == [200]
    base = dict(FLAGSHIP_RUN["model"]["params"])
    base.pop("scheduler_config")
    assert params == base   # held to the flagship YAML by test_torch_harness
    # the flagship's data (the v4 grid), not the MCL YAML's v1 grid
    assert ours["data"] == _port_target(flagship["data"])
    assert "SyntheticShapes3DTrain" in mcl["data"]["params"]["train"][
        "target"]
    callbacks = dict(ours["lightning"]["callbacks"])
    assert callbacks.pop("swap_visualization") == _port_target(
        mcl["lightning"]["callbacks"]["swap_visualization"])
    assert {**ours["lightning"], "callbacks": callbacks} == _port_target(
        flagship["lightning"])
    # the run's LR: B x base LR, as scripts/run_mcl_sweep.py gets it
    assert harness.load_configs(["flagship_mcl"], [])["model"][
        "base_learning_rate"] * 128 == pytest.approx(2.56e-5)


@pytest.mark.parametrize("key,value", [
    ("learn_logvar", True), ("parameterization", "x0"),
    ("original_elbo_weight", 0.1), ("l_simple_weight", 0.5),
    ("indep_bandwidth", 2.0), ("beta_schedule", "cosine"),
    ("loss_type", "l2"), ("num_timesteps_cond", 2),
    ("use_ema", False), ("no_such_key", 1)])
def test_unported_keys_are_refused(key, value):
    params = {**TINY["model"]["params"], key: value}
    with pytest.raises(NotImplementedError, match=key):
        LatentDiffusion(params, device="cpu")
    # the port's own values load
    if key in FIXED:
        LatentDiffusion({**TINY["model"]["params"], key: FIXED[key]},
                        device="cpu")


def test_flagship_with_use_mcl_trains_the_heads():
    """The fault this slice repairs: the overrides build and train the MCL
    heads, and the step logs the MCL term."""
    cfg = harness.load_configs(["flagship"], [
        "model.params.use_mcl=true", "model.params.lambda_mcl=0.05"])
    model = LatentDiffusion(cfg["model"]["params"], device="cpu")
    assert model.use_mcl and model.lambda_mcl == 0.05
    assert model.mcl_type == "infonce_mechgrad"
    tiny_model = LatentDiffusion({**TINY["model"]["params"],
                                  **MCL_TINY_PARAMS}, device="cpu")
    tiny_model.init_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(tiny_model, {**TINY["model"]["params"],
                                            "base_learning_rate": 1e-4,
                                            "batch_size": 4})
    x = np.random.RandomState(1).randint(0, 256, (4, 16, 16, 3), np.uint8)
    metrics = train_step(tiny_model, state, x,
                         generator=torch.Generator().manual_seed(2))
    assert np.isfinite(metrics["train/loss_mcl"].item())
    assert "train/mcl_diffusion_ratio" in metrics
    # the critic's weights reach the loss only through the second order;
    # its biases and u_fc.weight only through ReLU masks (exact zeros)
    live = {"critic.img_conv1.weight", "critic.img_conv2.weight",
            "critic.z_fc.weight", "critic.out.weight"} | {
        k for k, _ in tiny_model.mcl.named_parameters()
        if k.startswith("Pi_")}
    for k, p in tiny_model.mcl.named_parameters():
        assert torch.isfinite(p.grad).all(), k
        assert (p.grad.abs().sum() > 0) == (k in live), k


def _tiny_mcl_model(seed):
    model = LatentDiffusion({**TINY["model"]["params"], **MCL_TINY_PARAMS},
                            device="cpu")
    model.init_parameters(torch.Generator().manual_seed(seed))
    state = create_train_state(model, {**TINY["model"]["params"],
                                       "base_learning_rate": 1e-4,
                                       "batch_size": 4})
    return model, state


def test_port_npz_holds_the_jax_mcl_paths(tmp_path):
    model, state = _tiny_mcl_model(3)
    path = str(tmp_path / "m.npz")
    save_checkpoint(path, model, state, fresh_variables(model))
    tree = jax_load_compact(path)["state"]["params"]["mcl"]
    modules = jmcl.build_mcl_modules(TINY_Z, 20, 32)
    want = jax.eval_shape(lambda k: jmcl.init_mcl_variables(
        modules, k, TINY_Z, 20, image_res=16), jax.random.PRNGKey(0))
    flat = lambda t: {"/".join(str(p.key) for p in path): leaf
                      for path, leaf in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    got, ref = flat(tree), flat(want)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape, k
    kernel = got["critic/params/z_fc/Dense_0/kernel"]
    np.testing.assert_array_equal(
        kernel, model.mcl["critic"].z_fc.weight.detach().numpy().T.astype(
            np.float16).astype(np.float32))


def test_jax_npz_restores_the_port_heads(tmp_path, capsys):
    model, state = _tiny_mcl_model(4)
    tree = fresh_variables(model)
    rs = np.random.RandomState(5)
    mcl = jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32),
                       tree["mcl"])
    params = {"unet": tree["unet"]["params"], "cond": tree["cond"]["params"],
              "mcl": mcl}
    path = str(tmp_path / "j.npz")
    jax_save_compact(path, {"params": params,
                            "batch_stats": tree["cond"]["batch_stats"],
                            "scale_factor": 1.0, "step": 7},
                     {"first_stage": tree["first_stage"]})
    fresh, fresh_state = _tiny_mcl_model(6)
    restore_train_checkpoint(path, fresh, fresh_state)
    assert "mcl/" not in capsys.readouterr().out
    w = fresh.mcl["Pi_u"].fc1.weight.detach().numpy()
    np.testing.assert_array_equal(
        w, mcl["Pi_u"]["params"]["fc1"]["Dense_0"]["kernel"].T.astype(
            np.float16).astype(np.float32))
    conv = fresh.mcl["critic"].img_conv1.weight.detach().numpy()
    np.testing.assert_array_equal(
        conv, mcl["critic"]["params"]["img_conv1"]["Conv_0"]["kernel"]
        .transpose(3, 2, 0, 1).astype(np.float16).astype(np.float32))


def test_checkpoint_directory_restores_heads_and_adamw(tmp_path):
    model, state = _tiny_mcl_model(7)
    x = np.random.RandomState(8).randint(0, 256, (4, 16, 16, 3), np.uint8)
    train_step(model, state, x, generator=torch.Generator().manual_seed(9))
    path = str(tmp_path / "ck")
    save_train_checkpoint(path, model, state, fresh_variables(model))
    again, again_state = _tiny_mcl_model(10)
    restore_train_checkpoint(path, again, again_state)
    for (k, p), q in zip(model.mcl.named_parameters(),
                         again.mcl.parameters()):
        assert torch.equal(p, q), k
        for name, t in state.optimizer.state[p].items():
            assert torch.equal(t, again_state.optimizer.state[q][name]), k


def test_committed_npz_keeps_fresh_heads(capsys):
    cfg = harness.load_configs(["flagship_mcl"], [])
    model = LatentDiffusion(cfg["model"]["params"], device="cpu")
    model.init_parameters(torch.Generator().manual_seed(23))
    state = create_train_state(model, {**cfg["model"]["params"],
                                       "base_learning_rate": 2e-7,
                                       "batch_size": 128})
    heads = {k: v.clone() for k, v in model.mcl.state_dict().items()}
    template = restore_train_checkpoint(str(FLAGSHIP_NPZ), model, state)
    out = capsys.readouterr().out
    # the heads are the first leaves the file lacks (AdamW's moments follow)
    assert "restore kept" in out and "'mcl/critic." in out
    for k, v in model.mcl.state_dict().items():
        assert torch.equal(v, heads[k]), k
    assert state.step == 97500
    assert set(template["mcl"]) == {"critic", "Pi_g", "Pi_u"}


def test_tiny_harness_run_with_mcl_and_swap_grids(tiny):
    cfg = json.loads(json.dumps(TINY))
    cfg["model"]["params"].update(MCL_TINY_PARAMS)
    cfg["lightning"]["callbacks"]["swap_visualization"] = {
        "target": "encdiff_tpu_torch.train.callbacks."
                  "SwapVisualizationCallback",
        "params": {"num_samples": 4, "ddim_steps": 2}}
    trainer = harness.main(["-b", _write(tiny, cfg), "-t", "--max_steps",
                            "2", "-l", str(tiny / "logs"), "--device", "cpu",
                            "--eval_metrics", "MIG,factor_VAE"])
    logdir = pathlib.Path(trainer.logdir)
    meta = json.loads((logdir / "run_metadata.json").read_text())
    assert meta["use_mcl"] is True and meta["mcl_type"] == "infonce_mechgrad"
    with np.load(logdir / "checkpoints/last" / MODEL_FILE) as f:
        assert any(k.startswith("state/params/mcl/critic/") for k in f.files)
    root = logdir / "swap_visualization"
    grid = np.load(root / "swap_grid_e-01_s0000002.npy")
    # the 4 inputs over 20 swaps of 4, 16 px, nrow 4
    assert grid.shape == (21 * 18 + 2, 4 * 18 + 2, 3) and grid.dtype == np.uint8
    pages = sorted(p.name for p in root.glob("factor_*_e-01.npy"))
    assert len(pages) == 20
    assert np.load(root / pages[0]).shape == (2 * 18 + 2, 4 * 18 + 2, 3)
    assert "swap_visualization_s" in trainer.timings
