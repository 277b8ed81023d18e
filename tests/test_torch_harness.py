"""The port's training harness held against the JAX package, on the CPU.

- The representation sweep and the first-stage latent cache on the
  flagship's committed weights over a 600-image sub-grid of the v4
  renderer, in chunks of 256 (a ragged last chunk), against
  ``build_encode_sweep`` and ``precompute_latents``: ``NET_TOL`` (1e-4
  relative and absolute; fp32 networks summed in another order).
- The epoch order, the data module's loader, ``ModelCheckpoint`` and
  ``ImageLogger`` against the JAX harness and callbacks on scripted steps
  and scores (exact: file names, top-k pruning, log steps, grids).
- ``FLAGSHIP_RUN`` against the YAML; the dotlist parsing against the JAX
  config shim's.
- A tiny model from a ``.json`` config (model_channels 32, 8x8 latents,
  the v4 grid at (2, 2, 2, 2, 2, 2), B = 4) trained 6 steps straight, and 3
  steps, saved, resumed and trained 3 more: parameters, batch statistics,
  AdamW, its count, the LR, the accumulation buffers and the EMA equal bit
  for bit. The CLI end to end on it, with ``--device cpu``.
- A checkpoint the harness saved after a step of the flagship read by the
  JAX package's ``load_model_variables``: the same Encoder4 codes and ε as
  the port reading it, to ``NET_TOL``.
"""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from encdiff_tpu.core.config import instantiate_from_config as jinstantiate
from encdiff_tpu.core.yamlcfg import OmegaConf
from encdiff_tpu.data.datasets import ArrayDataset
from encdiff_tpu.train import callbacks as jcb
from encdiff_tpu.train import data as jdata
from encdiff_tpu.train import loop as jloop
from encdiff_tpu.train.checkpoint_io import load_model_variables as jax_load
from encdiff_tpu_torch.configs import FLAGSHIP, FLAGSHIP_RUN
from encdiff_tpu_torch.core.compact_ckpt import load_model_variables
from encdiff_tpu_torch.data import synthetic_shapes
from encdiff_tpu_torch.data.synthetic_shapes import epoch_batches, render_all_v4
from encdiff_tpu_torch.evalx.ground_truth import named_data
from encdiff_tpu_torch.evalx.ground_truth.core import IndexBackedDataset
from encdiff_tpu_torch.evalx.swap import log_images
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.train import callbacks as tcb
from encdiff_tpu_torch.train import harness
from encdiff_tpu_torch.train.checkpoint_io import MODEL_FILE, STATE_FILE
from encdiff_tpu_torch.train.data import epoch_order
from encdiff_tpu_torch.train.loop import (encode_sweep, precompute_latents,
                                          trainable_parameters)
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP_NPZ = ROOT / "demo_artifacts/round5/v4purify_final_fp16.npz"
FLAGSHIP_YAML = ROOT / "configs/demo/synthetic-shapes-v4-full-encdiff.yaml"
NET_TOL = dict(rtol=1e-4, atol=1e-4)
SUB_GRID = (5, 5, 3, 2, 2, 2)   # 600 images: chunks of 256 leave 88
TINY_GRID = [2, 2, 2, 2, 2, 2]  # 64 images

TINY = {
    "model": {"base_learning_rate": 1e-4, "params": {
        "timesteps": 1000, "linear_start": 0.0015, "linear_end": 0.0155,
        "image_size": 8, "channels": 3, "loss_type": "l1",
        "scale_by_std": True, "log_every_t": 200,
        "monitor": "train/loss_simple", "eval_name": "tiny_grid",
        "scheduler_config": {"warm_up_steps": [10],
                             "cycle_lengths": [10000000000000],
                             "f_start": [1e-6], "f_max": [1.0],
                             "f_min": [1.0]},
        "unet_config": {"image_size": 8, "in_channels": 3, "out_channels": 3,
                        "model_channels": 32, "attention_resolutions": [1, 2],
                        "num_res_blocks": 1, "channel_mult": [1, 2],
                        "num_heads": 4, "use_scale_shift_norm": True,
                        "resblock_updown": True,
                        "use_spatial_transformer": True, "context_dim": 16,
                        "latent_unit": 20},
        "first_stage_config": {
            "embed_dim": 3, "n_embed": 64, "use_disentangled_concat": True,
            "disentangled_dim": 20,
            "ddconfig": {"double_z": False, "z_channels": 3, "resolution": 16,
                         "in_channels": 3, "out_ch": 3, "ch": 32,
                         "ch_mult": [1, 2], "num_res_blocks": 1,
                         "attn_resolutions": [], "dropout": 0.0}},
        "cond_stage_config": {"d": 32, "context_dim": 16, "latent_unit": 20}}},
    "data": {"target": "encdiff_tpu_torch.train.data.DataModuleFromConfig",
             "params": {"batch_size": 4, "train": {
                 "target": "encdiff_tpu_torch.data.synthetic_shapes."
                           "SyntheticShapes3DV4FullTrain",
                 "params": {"image_size": 16}}}},
    "lightning": {
        "callbacks": {
            "image_logger": {
                "target": "encdiff_tpu_torch.train.callbacks.ImageLogger",
                "params": {"batch_frequency": 2, "max_images": 4,
                           "increase_log_steps": False,
                           "log_config": {
                               "target": "encdiff_tpu_torch.train."
                                         "callbacks.Record",
                               "params": {"interval": 2}},
                           "log_images_kwargs": {"sample_swap": True,
                                                 "ddim_steps": 2}}},
            "best_vae_checkpoint": {
                "target": "encdiff_tpu_torch.train.callbacks.ModelCheckpoint",
                "params": {"monitor": "val/factor_vae_score", "mode": "max",
                           "filename": "best_vae_{epoch:03d}_"
                                       "{val/factor_vae_score:.4f}",
                           "save_top_k": 1}}},
        "trainer": {"max_epochs": 2, "check_val_every_n_epoch": 1}},
}


def _run(fn, *args, **kw):
    return np.asarray(jax.jit(lambda *a: fn(*a, **kw))(*args))


@pytest.fixture(scope="module")
def flagship():
    with open(FLAGSHIP_YAML) as f:
        params = dict(yaml.safe_load(f)["model"]["params"])
    for k in ("eval_name", "scheduler_config"):
        params.pop(k)
    jmodel = jinstantiate(
        {"target": "encdiff_tpu.models.latent_diffusion.LatentDiffusion",
         "params": params})
    jvars, sf = jax_load(jmodel, str(FLAGSHIP_NPZ))
    jmodel.scale_factor = sf
    tmodel = LatentDiffusion.from_checkpoint(str(FLAGSHIP_NPZ), device="cpu")
    return jmodel, jvars, tmodel


@pytest.fixture(scope="module")
def sub_grid():
    return render_all_v4(factor_sizes=SUB_GRID)


def test_encode_sweep_matches_jax(flagship, sub_grid):
    jmodel, jvars, tmodel = flagship
    n, chunk = len(sub_grid), 256
    n_chunks = -(-n // chunk)
    # the JAX harness's padded order (harness.py:888-898)
    order = np.zeros(n_chunks * chunk, np.int32)
    order[:n] = np.arange(n, dtype=np.int32)
    state = jloop.TrainState(
        step=jnp.int32(0), params={"cond": jvars["cond"]["params"]},
        batch_stats=jvars["cond"]["batch_stats"], opt_state=None, ema=None,
        scale_factor=jnp.float32(1.0))
    sweep = jloop.build_encode_sweep(jmodel, n_chunks, chunk)
    ref = np.asarray(sweep(state, jnp.asarray(sub_grid.reshape(n, -1)),
                           jnp.asarray(order)))[:n]
    tmodel.cond_stage_model.train()  # the sweep must put it in eval mode
    got = encode_sweep(tmodel, torch.from_numpy(sub_grid), chunk=chunk)
    assert got.shape == (n, 20)
    np.testing.assert_allclose(got.numpy(), ref, **NET_TOL)


def test_precompute_latents_matches_jax(flagship, sub_grid):
    jmodel, jvars, tmodel = flagship
    n = len(sub_grid)
    cache, hwc = jloop.precompute_latents(
        jmodel, {"first_stage": jvars["first_stage"]},
        jnp.asarray(sub_grid.reshape(n, -1)), chunk=256)
    ref = np.asarray(cache["z"]).reshape(n, *hwc)
    got = precompute_latents(tmodel, torch.from_numpy(sub_grid), chunk=256)
    assert got.shape == (n, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), ref, **NET_TOL)


@pytest.mark.parametrize("n,n_images,bs", [(480_000, 480_000, 128),
                                           (1000, 100, 7), (64, 64, 4)])
def test_epoch_order_matches_jax_harness(n, n_images, bs):
    for seed, epoch in ((23, 0), (23, 5), (7, 1)):
        # encdiff_tpu/train/harness.py:467-475
        spe = n // bs
        ref = (np.random.RandomState(seed + epoch).permutation(n)
               [: spe * bs].astype(np.int32))
        ref %= n_images
        np.testing.assert_array_equal(
            epoch_order(seed, epoch, n, bs, n_images), ref)


@pytest.mark.parametrize("seed,epoch", [(3, 2), (23, 0)])
def test_epoch_batches_match_jax_loader(seed, epoch):
    """train_steps' batches (``epoch_batches``, through ``epoch_order``)
    are the JAX host loader's, batch for batch."""
    images = render_all_v4(16, factor_sizes=TINY_GRID)
    ours = [images[idx] for idx in epoch_batches(len(images), 5, seed, epoch)]
    theirs = list(jdata.epoch_loader(ArrayDataset(images), 5, seed=seed,
                                     epoch=epoch))
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))


def _listing(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*"))


@pytest.mark.parametrize("kw", [
    dict(monitor="val/factor_vae_score", mode="max", save_top_k=2,
         filename="best_vae_{epoch:03d}_{val/factor_vae_score:.4f}",
         save_last=True),
    dict(monitor="val/mig", mode="min", save_top_k=1,
         filename="{epoch:03d}-{step}"),
    dict(monitor="train/loss_simple", mode="min", save_top_k=3,
         save_last=True, filename="{epoch:03d}-{step}"),
    dict(every_n_train_steps=3, filename="{step}"),
])
def test_model_checkpoint_matches_jax(tmp_path, kw):
    ours = tcb.ModelCheckpoint(**kw).bind(str(tmp_path / "port"))
    theirs = jcb.ModelCheckpoint(**kw).bind(str(tmp_path / "jax"))

    def saver(root):
        return lambda path: os.makedirs(path, exist_ok=True)

    rs = np.random.RandomState(0)
    for step in range(1, 13):
        epoch = step // 4
        metrics = {"val/factor_vae_score": float(rs.rand()),
                   "val/mig": float(rs.rand())}
        for ck, root in ((ours, "port"), (theirs, "jax")):
            ck.maybe_save(saver(root), step, epoch,
                          metrics=None if ck.every_n_train_steps else metrics)
        assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
        assert ([s for s, _ in ours.best] == [s for s, _ in theirs.best])
    assert _listing(tmp_path / "port")


def test_image_logger_matches_jax(tmp_path):
    kw = dict(batch_frequency=8, max_images=4, increase_log_steps=True)
    ours = tcb.ImageLogger(**kw, log_config={
        "target": "encdiff_tpu_torch.train.callbacks.Record",
        "params": {"interval": 3}}).bind(str(tmp_path / "port"))
    theirs = jcb.ImageLogger(**kw, log_config={
        "target": "encdiff_tpu.train.callbacks.Record",
        "params": {"interval": 3}}).bind(str(tmp_path / "jax"))
    assert ours.log_steps == theirs.log_steps == [1, 2, 4, 8]
    rs = np.random.RandomState(1)

    def images(batch, N, **kw):
        del kw
        return {"inputs": batch[:N], "diffusion_row": rs.uniform(
            -1.2, 1.2, (2, 3, 8, 8, 3)).astype(np.float32),
            "samples_swapping": rs.uniform(-1, 1, (12, 8, 8, 3)),
            "scalar": np.zeros(())}

    for step in range(1, 26):
        assert ours.due(step) == theirs.due(step)
        assert ours.wants_metrics(step) == theirs.wants_metrics(step)
        batch = rs.uniform(-1, 1, (6, 8, 8, 3)).astype(np.float32)
        logged = {}
        for lg, root in ((ours, "port"), (theirs, "jax")):
            state = rs.get_state()
            lg.maybe_log(step, "train", images, batch,
                         metrics=lambda: {"train/loss": step * 0.5})
            logged[root] = rs.get_state()
            rs.set_state(state)
        rs.set_state(logged["port"])
        assert ours.log_steps == theirs.log_steps
    port = pathlib.Path(tmp_path / "port" / "images" / "train")
    jax_dir = pathlib.Path(tmp_path / "jax" / "images" / "train")
    stems = sorted(p.stem for p in port.iterdir())
    assert stems == sorted(p.stem for p in jax_dir.iterdir())
    assert "inputs_gs-000016" in stems and "diffusion_row_gs-000004" in stems
    from PIL import Image
    for stem in stems:
        np.testing.assert_array_equal(
            np.load(port / f"{stem}.npy"),
            np.asarray(Image.open(jax_dir / f"{stem}.png")))
    assert ((tmp_path / "port" / "record.csv").read_text()
            == (tmp_path / "jax" / "record.csv").read_text())


def _port_target(node):
    """The YAML's node with the JAX package's targets named in the port."""
    if isinstance(node, dict):
        return {k: _port_target(v) for k, v in node.items()}
    if isinstance(node, str) and node.startswith("encdiff_tpu."):
        return "encdiff_tpu_torch." + node[len("encdiff_tpu."):]
    return node


def test_flagship_run_matches_yaml():
    with open(FLAGSHIP_YAML) as f:
        ref = yaml.safe_load(f)
    model = ref["model"]
    assert FLAGSHIP_RUN["model"]["base_learning_rate"] == \
        model["base_learning_rate"]
    ours = FLAGSHIP_RUN["model"]["params"]
    assert set(ours) == set(model["params"]) | {"loss_type"} - set()
    for key, val in model["params"].items():
        if isinstance(val, dict) and "params" in val:
            val = val["params"]
        if key == "first_stage_config":
            # the port's VQ takes no monitor, checkpoint path or loss
            assert set(val) - set(ours[key]) == {"monitor", "ckpt_path",
                                                 "lossconfig"}
            val = {k: v for k, v in val.items() if k in ours[key]}
        assert ours[key] == val, key
    assert ours["loss_type"] == model["params"]["loss_type"]
    assert FLAGSHIP_RUN["data"] == _port_target(ref["data"])
    assert FLAGSHIP_RUN["lightning"] == _port_target(ref["lightning"])
    assert {k: ours[k] for k in FLAGSHIP} == FLAGSHIP


def test_load_configs_and_dotlist_match_jax(tmp_path):
    items = ["lightning.callbacks.image_logger.params.batch_frequency=20",
             "lightning.callbacks.image_logger.params.increase_log_steps=false",
             "model.base_learning_rate=1.0e-06", "model.params.eval_name=null",
             "data.params.batch_size=4", "model.params.monitor=val/mig",
             "a.b=True", "a.c=[1, 2]"]
    assert harness.from_dotlist(items) == OmegaConf.to_container(
        OmegaConf.from_dotlist(items))
    cfg = harness.load_configs(["flagship"], items[:3])
    assert cfg["model"]["base_learning_rate"] == 1e-6
    params = cfg["lightning"]["callbacks"]["image_logger"]["params"]
    assert params["batch_frequency"] == 20 and not params["increase_log_steps"]
    assert params["max_images"] == 8
    assert FLAGSHIP_RUN["lightning"]["callbacks"]["image_logger"]["params"][
        "batch_frequency"] == 20000  # the registered config is not touched
    # a dumped lightning config without its wrapper is wrapped again
    (tmp_path / "x-lightning.json").write_text(
        json.dumps(FLAGSHIP_RUN["lightning"]))
    cfg = harness.load_configs(["flagship", str(tmp_path / "x-lightning.json")],
                               [])
    assert set(cfg) == {"model", "data", "lightning"}
    with pytest.raises(ValueError, match="registered|json"):
        harness.load_configs([str(FLAGSHIP_YAML)], [])


def test_log_images_refuses_unported_branches():
    for branch in ("inpaint", "quantize_denoised", "plot_progressive_rows"):
        with pytest.raises(NotImplementedError, match="#13"):
            log_images(None, None, **{branch: True})


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The tiny run's config file, its 64-image grid and ground truth."""
    monkeypatch.setattr(synthetic_shapes.SyntheticShapes3DV4Full,
                        "factor_sizes", TINY_GRID)
    monkeypatch.setitem(named_data._REGISTRY, "tiny_grid",
                        lambda images=None: IndexBackedDataset(
                            np.arange(64), TINY_GRID))
    harness.clear_device_cache()
    yield tmp_path
    harness.clear_device_cache()


def _write(tmp_path, cfg, name="tiny.json"):
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


def _snapshot(trainer):
    st = trainer.state
    params = trainable_parameters(trainer.model)
    return {
        "model": {k: v.clone() for k, v in
                  {**{f"unet.{k}": v for k, v in
                      trainer.model.unet.state_dict().items()},
                   **{f"cond.{k}": v for k, v in
                      trainer.model.cond_stage_model.state_dict().items()}
                   }.items()},
        "adamw": {k: {n: t.clone() for n, t in
                      st.optimizer.state[p].items()}
                  for k, p in params.items()},
        "acc": None if st.acc_grads is None else [g.clone()
                                                  for g in st.acc_grads],
        "scalars": (st.step, st.updates, st.mini_step, st.ema.num_updates,
                    float(st.scale_factor), trainer.lr_monitor.history[-1]),
        "ema": {k: v.clone() for k, v in st.ema.params.items()},
    }


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("accumulate", [1, 2])
def test_resume_continues_bit_for_bit(tiny, accumulate):
    cfg = _write(tiny, TINY)
    common = ["--no-test", "--device", "cpu", "--accumulate_grad_batches",
              str(accumulate)]
    straight = harness.main(["-b", cfg, "-t", "--max_steps", "6",
                             "-l", str(tiny / "a"), *common])
    first = harness.main(["-b", cfg, "-t", "--max_steps", "3",
                          "-l", str(tiny / "b"), *common])
    last = os.path.join(first.ckptdir, "last")
    assert sorted(os.listdir(last)) == sorted([MODEL_FILE, STATE_FILE])
    resumed = harness.main(["-r", first.logdir, "-t", "--max_steps", "6",
                            *common])
    assert resumed.lr_monitor.history[0][0] == 4
    assert resumed.state.updates == 6 // accumulate
    if accumulate > 1:
        assert first.state.mini_step == 1  # saved between two updates
    _assert_equal(_snapshot(resumed), _snapshot(straight))
    assert straight.state.ema.num_updates == 6


def test_cli_end_to_end_on_the_cpu(tiny):
    cfg = _write(tiny, TINY)
    trainer = harness.main(["-b", cfg, "-t", "--max_steps", "18", "-l",
                            str(tiny / "logs"), "--device", "cpu",
                            "--eval_metrics", "MIG,factor_VAE"])
    logdir = pathlib.Path(trainer.logdir)
    assert logdir.parent == tiny / "logs" and logdir.name.endswith("_tiny")
    names = {str(p.relative_to(logdir)) for p in logdir.rglob("*")}
    for want in ("checkpoints/last/" + MODEL_FILE,
                 "checkpoints/last/" + STATE_FILE, "metrics_sin/16.json",
                 "metrics_sin/18.json", "reps/16.npy", "reps/18.npy",
                 "record.csv", "run_metadata.json", "test_results.json",
                 "images/train/samples_swapping_gs-000002.npy",
                 "images/train/diffusion_row_gs-000018.npy"):
        assert want in names, want
    assert sum(n.startswith("configs/") and n.endswith("-project.json")
               for n in names) == 1
    assert any(n.startswith("checkpoints/best_vae_000_") for n in names)
    assert np.load(logdir / "reps/18.npy").shape == (64, 20)
    results = json.loads((logdir / "test_results.json").read_text())
    assert sorted(results) == ["val/factor_vae_score", "val/mig"]
    assert all(np.isfinite(v) for v in results.values())
    grid = np.load(logdir / "images/train/samples_swapping_gs-000002.npy")
    assert grid.shape == (20 * 18 + 2, 4 * 18 + 2, 3)
    assert grid.dtype == np.uint8

    resumed = harness.main(["-r", str(logdir), "-t", "--max_steps", "20",
                            "--device", "cpu", "--eval_metrics",
                            "MIG,factor_VAE"])
    assert resumed.state.step == 20
    assert json.loads((logdir / "test_results.json").read_text()).keys() \
        == results.keys()
    assert (logdir / "metrics_sin/20.json").exists()


def test_cli_refusals(tiny, monkeypatch):
    cfg = _write(tiny, TINY)
    args = ["-b", cfg, "-t", "--max_steps", "2", "-l", str(tiny / "r")]
    with pytest.raises(NotImplementedError, match="host"):
        harness.main(args + ["--device", "cpu", "--device_data", "false"])
    with pytest.raises(ValueError, match="unknown metrics"):
        harness.main(args + ["--device", "cpu", "--eval_metrics",
                             "MIG,sap", "--max_steps", "16"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        harness.main(args)


def test_validation_scores_the_battery_and_feeds_best_dci(tiny, monkeypatch):
    """A validation scores the JAX harness's default battery (beta-VAE,
    DCI, MIG, FactorVAE) at the fast tier on the harness's device, logs the
    JAX keys, times each metric, and its DCI feeds a best_dci checkpoint;
    test() asks for the full tier, and so does every validation under
    --full_val_metrics."""
    cfg = json.loads(json.dumps(TINY))
    cfg["lightning"]["callbacks"]["best_dci_checkpoint"] = {
        "target": "encdiff_tpu_torch.train.callbacks.ModelCheckpoint",
        "params": {"monitor": "val/dci_disentanglement", "mode": "max",
                   "filename": "best_dci_{epoch:03d}_"
                               "{val/dci_disentanglement:.4f}",
                   "save_top_k": 1}}
    calls, real = [], harness.eval_func

    def spy(*args, **kw):
        calls.append({k: kw[k] for k in ("metrics", "budget", "device")})
        return real(*args, **kw)
    monkeypatch.setattr(harness, "eval_func", spy)
    # 16 steps an epoch: one validation, at step 16
    trainer = harness.main(["-b", _write(tiny, cfg), "-t", "--max_steps",
                            "17", "--no-test", "-l", str(tiny / "logs"),
                            "--device", "cpu"])
    battery = ("beta_VAE", "dci", "MIG", "factor_VAE")
    assert calls == [{"metrics": battery, "budget": "fast",
                      "device": torch.device("cpu")}]
    keys = ["val/beta_vae", "val/dci_completeness", "val/dci_disentanglement",
            "val/factor_vae_score", "val/mig"]
    val = trainer.last_val_metrics
    assert sorted(val) == keys and all(np.isfinite(v) for v in val.values())
    logdir = pathlib.Path(trainer.logdir)
    scores = json.loads((logdir / "metrics_sin/16.json").read_text())
    assert list(scores) == list(battery)
    assert scores["dci"]["dci_budget"] == "fast"
    assert val["val/dci_disentanglement"] == scores["dci"]["disentanglement"]
    assert val["val/beta_vae"] == scores["beta_VAE"]["eval_accuracy"]
    best = [p.name for p in (logdir / "checkpoints").iterdir()
            if p.name.startswith("best_dci_000_")]
    assert best == [f"best_dci_000_{val['val/dci_disentanglement']:.4f}"]
    assert list(trainer.timings["metric_s"]) == list(battery)
    assert trainer.timings["tier"] == "fast"

    canned = {"beta_VAE": {"eval_accuracy": 1.0},
              "dci": {"disentanglement": 0.5, "completeness": 0.25},
              "MIG": {"discrete_mig": 0.125},
              "factor_VAE": {"eval_accuracy": 0.75}}

    def fake(*args, **kw):
        calls.append(kw["budget"])
        return canned
    monkeypatch.setattr(harness, "eval_func", fake)
    results = trainer.test()
    assert calls[-1] == "full" and sorted(results) == keys
    assert results["val/dci_completeness"] == 0.25
    trainer.full_val_metrics = True
    trainer.validate(epoch=1, step=17)
    assert calls[-1] == "full"
    assert harness.get_parser().parse_args(
        ["--full_val_metrics"]).full_val_metrics is True


def test_jax_reads_the_harness_checkpoint(flagship, tiny):
    """One flagship step at B = 4 from the committed checkpoint, saved by
    the harness; the JAX package and the port read the saved file alike."""
    jmodel, _, _ = flagship
    trainer = harness.main([
        "-b", "flagship", "-t", "--max_steps", "97501", "--resume_ckpt",
        str(FLAGSHIP_NPZ), "--no-test", "-l", str(tiny / "f"), "--device",
        "cpu", "data.params.batch_size=4",
        "model.params.eval_name=tiny_grid"])
    path = os.path.join(trainer.ckptdir, "last", MODEL_FILE)
    jvars, jsf = jax_load(jmodel, path)
    variables, sf = load_model_variables(path)
    assert sf == jsf == pytest.approx(2.2090282, rel=1e-6)
    tmodel = LatentDiffusion(FLAGSHIP, device="cpu")
    tmodel.load_variables(variables, sf, use_ema=False)
    images = render_all_v4(factor_sizes=TINY_GRID)[[0, 9, 27, 63]]
    images = images.astype(np.float32) / 127.5 - 1.0
    cond = {"params": jvars["cond"]["params"],
            "batch_stats": jvars["cond"]["batch_stats"]}
    u_ref = _run(jmodel.cond_encoding, cond, jnp.asarray(images))
    np.testing.assert_allclose(tmodel.cond_encoding(images).numpy(), u_ref,
                               **NET_TOL)
    x = np.random.RandomState(3).randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([17, 903])
    tokens = np.array(jmodel.cond_warp(cond, u_ref[:2]))
    eps_ref = _run(jmodel.apply_model, jvars["unet"], jnp.asarray(x),
                   jnp.asarray(t), jnp.asarray(tokens))
    np.testing.assert_allclose(tmodel.apply_model(x, t, tokens).numpy(),
                               eps_ref, **NET_TOL)
    # the JAX file's paths, and an EMA, which the committed file lacks
    with np.load(path) as saved, np.load(FLAGSHIP_NPZ) as original:
        assert set(saved.files) - set(original.files) == {
            k for k in saved.files if k.startswith("state/ema/")}
        assert int(saved["state/step"]) == 97501
