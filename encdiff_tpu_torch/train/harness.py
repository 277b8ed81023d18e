"""The training harness: the port's ``main_val.py``.

Counterpart of ``encdiff_tpu/train/harness.py`` (:57-178 the CLI surface
and configs, :178-548 and :706-970 the ``Trainer``, :973-1056 ``main``) for
the stage-2 LDM on one device:

- ``-b`` takes a registered config name (``flagship``, which is
  ``configs.FLAGSHIP_RUN``) or a ``.json`` file nested as the YAML configs
  are, and the arguments that follow as ``key.path=value`` overrides; a
  resumed run (``-r``) reads the configs its first run dumped;
- the peak LR follows the reference's rule, accumulate x devices (1) x
  batch x ``base_learning_rate``;
- ``fit`` trains on the dataset resident on the device as uint8, with the
  frozen first stage's latents computed once per fit (``--cache_latents``),
  the epoch's row order of the JAX device path, the batch of global step s
  at ``s % steps_per_epoch`` of it, and t and the noise drawn from a
  generator seeded with (seed, s). As in the JAX harness, the epochs of
  every fit count from 0, so a resumed run reads epoch 0's order: it
  repeats the batches of the run it resumes only while that run was in its
  first epoch. The step, the optimizer, the LR and the EMA continue.
  Validation every ``check_val_every_n_epoch`` epochs of the fit; SIGUSR1
  and KeyboardInterrupt save ``last``, and so does the end of fit;
- ``validate`` sweeps Encoder4 over the whole validation grid
  (``train.loop.encode_sweep``), writes the representations as
  ``<logdir>/reps/<step>.npy`` and scores the JAX harness's battery
  (``evalx.eval_driver``: beta-VAE, DCI, MIG and FactorVAE, or
  ``--eval_metrics``), DCI at the fast tier unless ``--full_val_metrics``,
  its predictors on the harness's device;
- ``test`` runs ``validate`` on the current or restored weights, DCI at
  the full tier, and writes ``test_results.json``; a ``SwapVisualizationCallback`` in the config
  writes its swap grids at the end of every ``validate``.

``-b flagship_mcl`` (``configs.FLAGSHIP_MCL_RUN``) is the MCL fine-tune
that ``scripts/run_mcl_sweep.py`` runs per cell: the model adds the MCL
term and heads (``models.latent_diffusion``), the train step trains the
heads beside the UNet and Encoder4, and a ``--resume_ckpt`` without heads
(the committed ``v4purify_final_fp16.npz``) keeps their seeded fresh init;
``fit`` runs it as any LDM config, on cached latents.

``-b faces`` (``configs.FACES_RUN``) is the faces EncDiff stage of
``scripts/round3_pipeline.sh``: 256 px faces on 64x64x3 latents,
micro-batch 8 with 4-way accumulation on the 34,560-image face grid,
no validation metrics (``eval_name`` null: ``validate`` gives ``{}``, and
the default monitor checkpoint on ``train/loss_simple`` keeps ``last``).
Its first stage is a ``-b faces_vq`` run's, named by the pipeline's
override ``model.params.first_stage_config.params.ckpt_path=<run>/
checkpoints/last`` (the ``params`` level of a sub-config is folded into the
port's flattened node, ``flatten_sub_configs``) and loaded over the seeded
fresh init (``models.autoencoder.VQModelInterface``).

A config whose ``model.target`` is ``models.autoencoder.VQModel``
(``-b flagship_vq``, ``configs.FLAGSHIP_VQ_RUN``; ``-b faces_vq``,
``configs.FACES_VQ_RUN``: 256 px, micro-batch 8 with 4-way accumulation on
the 34,560-image face grid) trains the VQ-GAN first stage instead
(``fit_vq``, :550-704 of the JAX harness): from a seeded
fresh init (the JAX ``fit_vq`` does not resume), the two optimizers of
``train.vq_trainer`` on the device-resident grid in the epoch order above,
the step counted from 0; the image logger writes inputs and
reconstructions of 8 rows drawn with ``RandomState(step)``; each epoch
ends with the validation metrics over the validation grid in order, capped
at ``--val_batches`` batches, and the monitor checkpoints on
``val/rec_loss``; ``test`` writes those metrics as ``test_results.json``. A
checkpoint is a directory holding ``train_state.pt`` (the fp32 model with
its discriminator and LPIPS, both Adam states, the step), and each save
also writes ``<ckptdir>/compact_last.npz``, which the JAX ``load_compact``
and ``VQModel.load_reference_checkpoint`` read.

``-b mpi3d_vq`` / ``-b mpi3d`` and ``-b cars3d_vq`` / ``-b cars3d``
(``configs.MPI3D_*``, ``configs.CARS3D_*``) are the cross-dataset chains of
``scripts/round5_pipeline.sh:187-200`` and ``scripts/round4b_pipeline.sh:
107-116``: the flagship's VQ-GAN, then its EncDiff stage over that run's
``checkpoints/last``, on the MPI3D grid (1,036,800 images, 7 factors, two
of 40 levels) and on the Cars3D grid (17,568 images, a 183-way factor, the
train view repeated ten times an epoch: ``len`` 175,680, rows taken modulo
17,568 by ``epoch_order``), validated on the ``mpi3d`` and ``cars3d``
ground-truth tables. The train and validation views of one grid hold one
array, so both hit one device cache entry. The port keeps the whole MPI3D
grid resident on the card (12.74 GB of uint8, composed there by
``data.synthetic_mpi3d``, whose tensor ``device_images`` takes as it is)
and caches its latents (3.19 GB of fp32): the JAX harness keeps a grid
above 8e9 bytes on the host and streams it (``encdiff_tpu/train/
harness.py:383``), a gate sized for a 16 GB TPU; the port follows the JAX
device path's order and step instead, and the host-streamed path is not
ported (``--device_data false`` raises). ``--val_batches`` caps a VQ-GAN's
validation (the MPI3D VQ validates on the full grid, 8,100 batches).

The rest of the shapes family (``configs.SHAPES_*``, ``configs.BANDS*``):
``-b shapes_vq`` / ``-b shapes`` on the v1 renderer's 27,648-image grid
(the VQ-GAN without LPIPS: ``perceptual_weight`` 0), ``-b shapes_full_vq``
/ ``-b shapes_full`` on the v1 grid at the full 480,000, ``-b
shapes_v2_vq`` / ``-b shapes_v2`` and ``-b shapes_v3_vq`` / ``-b shapes_v3``
on the v2 and v3 grids, the bands control at 27,648 (``-b bands27k_vq`` /
``-b bands27k``) and at 480,000 (``-b bands_control_vq`` / ``-b
bands_control``), and ``-b shapes_mcl``, the whole
``synthetic-shapes-mcl.yaml`` on the v1 grid. Each EncDiff stage runs over
a VQ-GAN run's ``checkpoints/last`` named by the ``ckpt_path`` override;
the 27,648-image YAMLs name a JAX log directory that is not in the
repository, which raises ``FileNotFoundError`` unless overridden. ``-b
shapes_mcl`` fine-tunes a ``-b shapes`` run, as ``scripts/run_mcl_sweep.py``
runs a cell: ``--resume_ckpt <shapes run>/checkpoints/last`` and the
first stage's override.

Checkpoints are directories (``train.checkpoint_io``). The dataset stays on
the device between runs of one process, so a resumed run or a second
``main`` does not upload 5.9 GB again; its latents are computed anew by
each fit, as the JAX harness does. ``--device`` defaults to ``cuda`` and
raises without a card.

    python -m encdiff_tpu_torch.main_val -b flagship -t --max_steps N \\
        [--resume_ckpt <npz>] [-r <logdir>] [--device cpu] [key=value ...]
    python -m encdiff_tpu_torch.main_val -b flagship_mcl -t \\
        --resume_ckpt demo_artifacts/round5/v4purify_final_fp16.npz \\
        --max_steps N
    python -m encdiff_tpu_torch.main_val -b faces_vq -t --max_steps N \\
        [--val_batches K]
    python -m encdiff_tpu_torch.main_val -b faces -t --max_steps N \\
        model.params.first_stage_config.params.ckpt_path=<run>/checkpoints/last
    python -m encdiff_tpu_torch.main_val -b cars3d_vq -t --no-test \\
        -l runs_cross -s 23 -n carsvq
    python -m encdiff_tpu_torch.main_val -b cars3d -t -l runs_cross -s 23 \\
        -n carsld \\
        model.params.first_stage_config.params.ckpt_path=<run>/checkpoints/last \\
        model.params.indep_type=hsic model.params.lambda_indep=2.0
    (and -b mpi3d_vq, then -b mpi3d with --max_epochs 5
     --check_val_every_n_epoch 2 and the ckpt_path override)
    python -m encdiff_tpu_torch.main_val -b shapes_vq -t -n shapesvq
    python -m encdiff_tpu_torch.main_val -b shapes -t -n shapesld \\
        model.params.first_stage_config.params.ckpt_path=<run>/checkpoints/last
    python -m encdiff_tpu_torch.main_val -b shapes_mcl -t \\
        --resume_ckpt <shapes run>/checkpoints/last \\
        model.params.first_stage_config.params.ckpt_path=<run>/checkpoints/last
    (and likewise -b shapes_full_vq / shapes_full, shapes_v2_vq / shapes_v2,
     shapes_v3_vq / shapes_v3, bands27k_vq / bands27k, bands_control_vq /
     bands_control)
"""

from __future__ import annotations

import argparse
import copy
import datetime
import glob
import json
import os
import signal
import time

import numpy as np
import torch

from encdiff_tpu_torch import convert
from encdiff_tpu_torch import configs
from encdiff_tpu_torch.core.compact_ckpt import save_compact_vq
from encdiff_tpu_torch.core.config import get_obj_from_str, instantiate_from_config
from encdiff_tpu_torch.core.device import resolve_device
from encdiff_tpu_torch.evalx.eval_driver import METRICS, eval_func
from encdiff_tpu_torch.evalx.ground_truth.named_data import get_index_dataset
from encdiff_tpu_torch.evalx.swap import log_images
from encdiff_tpu_torch.models.autoencoder import VQModel
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.train import callbacks as cb
from encdiff_tpu_torch.train import vq_trainer
from encdiff_tpu_torch.train.checkpoint_io import (
    MODEL_FILE, STATE_FILE, fresh_variables, restore_train_checkpoint,
    save_train_checkpoint)
from encdiff_tpu_torch.train.data import epoch_order
from encdiff_tpu_torch.train.loop import (create_train_state, encode_sweep,
                                          precompute_latents, train_step)

#: the configs ``-b`` takes by name
REGISTERED = {name: getattr(configs, f"{name.upper()}_RUN") for name in (
    "flagship", "flagship_vq", "flagship_mcl", "faces_vq", "faces",
    "mpi3d_vq", "mpi3d", "cars3d_vq", "cars3d", "shapes_vq", "shapes",
    "shapes_full_vq", "shapes_full", "shapes_v2_vq", "shapes_v2",
    "shapes_v3_vq", "shapes_v3", "bands27k_vq", "bands27k",
    "bands_control_vq", "bands_control", "shapes_mcl")}

#: the dataset on the device, kept between the runs of one process: at most
#: one, with the host array it was uploaded from
_DEVICE_CACHE: dict = {}


def device_images(images_host, device) -> torch.Tensor:
    """``images_host`` (N, S, S, 3) uint8 on ``device``, uploaded once per
    process for the same array; a tensor already on ``device`` (the MPI3D
    grid composed on the card) is taken as it is, without a copy. Another
    array first releases the one the cache holds (the flagship's 5.9 GB
    grid before the faces' 6.8 GB), and the card's allocator returns its
    memory unless the dataset still holds it."""
    hit = _DEVICE_CACHE.get("images")
    if hit is not None and hit[0] is images_host and hit[1] == str(device):
        return hit[2]
    del hit
    clear_device_cache()
    images = (images_host if isinstance(images_host, torch.Tensor)
              else torch.from_numpy(images_host)).to(device)
    _DEVICE_CACHE["images"] = (images_host, str(device), images)
    return images


def clear_device_cache() -> None:
    held = _DEVICE_CACHE.pop("images", None)
    _DEVICE_CACHE.clear()
    if held is not None and held[2].is_cuda:
        del held
        torch.cuda.empty_cache()


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of global step ``step``'s t and noise."""
    return torch.Generator(device).manual_seed((seed << 32) + step)


def get_parser(**parser_kwargs):
    """The flags of ``encdiff_tpu/train/harness.py:get_parser``, and
    ``--device``."""

    def str2bool(v):
        if isinstance(v, bool):
            return v
        if v.lower() in ("yes", "true", "t", "y", "1"):
            return True
        if v.lower() in ("no", "false", "f", "n", "0"):
            return False
        raise argparse.ArgumentTypeError("Boolean value expected.")

    parser = argparse.ArgumentParser(**parser_kwargs)
    parser.add_argument("-n", "--name", type=str, default="", nargs="?")
    parser.add_argument("-r", "--resume", type=str, default="", nargs="?")
    parser.add_argument("-b", "--base", nargs="*", metavar="flagship|cfg.json",
                        default=[])
    parser.add_argument("-t", "--train", type=str2bool, default=False,
                        nargs="?", const=True)
    parser.add_argument("--no-test", type=str2bool, default=False, nargs="?",
                        const=True)
    parser.add_argument("-p", "--project", type=str, default=None)
    parser.add_argument("-d", "--debug", type=str2bool, default=False,
                        nargs="?", const=True)
    parser.add_argument("-s", "--seed", type=int, default=23)
    parser.add_argument("-f", "--postfix", type=str, default="")
    parser.add_argument("-l", "--logdir", type=str, default="logs")
    parser.add_argument("--scale_lr", type=str2bool, default=True, nargs="?",
                        const=True)
    parser.add_argument("--token_num", type=int, default=None)
    parser.add_argument("--gpus", type=str, default=None,
                        help="accepted for parity; the port runs one device")
    parser.add_argument("--devices", type=int, default=None,
                        help="1 (data parallel is not ported)")
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--accumulate_grad_batches", type=int, default=None)
    parser.add_argument("--val_batches", type=int, default=None,
                        help="VQ-GAN: cap the validation batches; LDM: the "
                             "host-streamed sweep, not ported")
    parser.add_argument("--eval_metrics", type=str, default=None,
                        help="comma list of beta_VAE,dci,MIG,factor_VAE "
                             "(default: all four)")
    parser.add_argument("--check_val_every_n_epoch", type=int, default=None)
    parser.add_argument("--resume_ckpt", type=str, default=None,
                        help="warm-start from a checkpoint (a compact .npz "
                             "or a checkpoint directory) without adopting "
                             "its logdir and configs; lenient restore")
    parser.add_argument("--device_data", type=str2bool, default=True,
                        nargs="?", const=True,
                        help="keep the uint8 dataset on the device; false "
                             "(host-streamed batches) is not ported")
    parser.add_argument("--cache_latents", type=str2bool, default=True,
                        nargs="?", const=True,
                        help="encode the dataset with the frozen first "
                             "stage once and train on the cached latents")
    parser.add_argument("--full_val_metrics", type=str2bool, default=False,
                        nargs="?", const=True,
                        help="score DCI at the full tier (10,000/5,000 "
                             "points, 100 boosting stages) in every "
                             "validation; default: the fast tier (2,500/"
                             "1,250 points, 20 stages). test() always scores "
                             "the full tier")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def _parse_value(text: str):
    """A dotlist value: JSON (numbers, true/false/null, lists, quoted
    strings), YAML's spellings of booleans and null, else the text."""
    special = {"True": True, "False": False, "None": None, "~": None,
               "null": None}
    if text in special:
        return special[text]
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def from_dotlist(dotlist) -> dict:
    """``["a.b=1", ...]`` -> ``{"a": {"b": 1}}``."""
    out: dict = {}
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist entry must be key=value, got {item!r}")
        key, value = item.split("=", 1)
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            if not isinstance(node.get(part), dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = _parse_value(value)
    return out


def merge(*configs) -> dict:
    """Deep merge, later configs winning."""
    out: dict = {}
    for cfg in configs:
        for k, v in cfg.items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = merge(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
    return out


#: ``model.params`` sub-configs that the port's run configs hold flattened
#: to their ``params``
FLATTENED = ("unet_config", "first_stage_config", "cond_stage_config",
             "scheduler_config")


def flatten_sub_configs(config: dict) -> dict:
    """``config`` with the ``params`` of each ``FLATTENED`` sub-config of
    ``model.params`` merged into the sub-config: the YAML spelling of an
    override, ``model.params.first_stage_config.params.ckpt_path=<path>``
    (``scripts/round3_pipeline.sh``), reaches the flattened node."""
    mp = (config.get("model") or {}).get("params") or {}
    for key in FLATTENED:
        node = mp.get(key)
        if isinstance(node, dict) and isinstance(node.get("params"), dict):
            mp[key] = merge({k: v for k, v in node.items() if k != "params"},
                            node["params"])
    return config


def load_configs(bases, cli_overrides) -> dict:
    """Merge the base configs (registered names or ``.json`` files) and the
    dotlist overrides, each with its sub-configs flattened
    (``flatten_sub_configs``). A ``*-lightning.json`` that
    ``SetupCallback`` dumped without its ``lightning`` wrapper is wrapped
    again, so that a resumed run keeps its callbacks."""
    configs = []
    for b in bases:
        if b in REGISTERED:
            cfg = REGISTERED[b]
        elif str(b).endswith(".json"):
            with open(b) as f:
                cfg = json.load(f)
            if str(b).endswith("-lightning.json") and "lightning" not in cfg:
                cfg = {"lightning": cfg}
        else:
            raise ValueError(f"{b!r}: a base config is one of "
                             f"{sorted(REGISTERED)} or a .json file")
        configs.append(flatten_sub_configs(copy.deepcopy(cfg)))
    return merge(*configs, flatten_sub_configs(from_dotlist(cli_overrides)))


def apply_token_num(config, token_num):
    """--token_num rewires latent_unit everywhere."""
    if token_num is None:
        return config
    mp = config["model"]["params"]
    mp["unet_config"]["latent_unit"] = token_num
    cs = mp.get("cond_stage_config") or {}
    for key in ("latent_unit", "latent_dim"):
        if key in cs:
            cs[key] = token_num
    fs = mp.get("first_stage_config") or {}
    if fs.get("disentangled_dim"):
        fs["disentangled_dim"] = token_num
    return config


def name_logdir(logdir, now, name, postfix, config, token_num):
    """The run directory: beta-schedule and token-count tags appended to
    the run name."""
    tags = []
    mp = config.get("model", {}).get("params", {})
    if mp.get("beta_schedule"):
        tags.append(str(mp["beta_schedule"]))
    if token_num is not None:
        tags.append(f"{token_num}tokens")
    nowname = now + ("_" + name if name else "") + (
        "_" + "_".join(tags) if tags else "") + postfix
    return os.path.join(logdir, nowname), nowname


class Trainer:
    """The model, its data, its train state and the callbacks of one run."""

    last_val_metrics = None

    def __init__(self, config, lightning_config=None, logdir="logs/run",
                 seed=23, accumulate=1, scale_lr=True, val_batches=None,
                 eval_metrics=None, check_val_every_n_epoch=1,
                 device_data=True, cache_latents=True, device="cuda",
                 full_val_metrics=False):
        self.device = resolve_device(device)
        self.config = config
        self.lightning_config = lightning_config or {}
        self.logdir = logdir
        self.ckptdir = os.path.join(logdir, "checkpoints")
        self.cfgdir = os.path.join(logdir, "configs")
        self.seed = seed
        self.val_batches = val_batches
        self.eval_metrics = (tuple(eval_metrics.split(",")) if eval_metrics
                             else METRICS)
        self.check_val_every_n_epoch = max(1, check_val_every_n_epoch or 1)
        self.full_val_metrics = full_val_metrics
        self.device_data = device_data
        self.cache_latents = cache_latents

        self.base_lr = float(config["model"].get("base_learning_rate", 1e-4))
        self.model_params = dict(config["model"]["params"])
        target = config["model"].get("target")
        self.is_vq = target is not None and issubclass(
            get_obj_from_str(target), VQModel)
        self.model = (VQModel(**self.model_params).to(self.device)
                      if self.is_vq else
                      LatentDiffusion(self.model_params, self.device))
        eval_name = self.model_params.get("eval_name")
        self.label_dataset = (get_index_dataset(eval_name) if eval_name
                              else None)
        self.data = instantiate_from_config(config["data"]).setup(
            device=self.device)
        self.batch_size = self.data.batch_size
        self.accumulate = accumulate
        # the reference's rule: accum x ndev x bs x base_lr, on one device
        self.learning_rate = (accumulate * self.batch_size * self.base_lr
                              if scale_lr else self.base_lr)
        print(f"learning rate = {self.learning_rate:.3e} "
              f"(accum {accumulate} x ndev 1 x bs {self.batch_size} "
              f"x base_lr {self.base_lr:.2e}, scale_lr={scale_lr})",
              flush=True)
        self.state = None
        self.variables = None
        self.resume_ckpt = None
        self.timings: dict = {}
        self._build_callbacks()

    def _build_callbacks(self):
        self.image_logger = None
        self.swap_cb = None
        self.checkpoints: list = []
        callbacks = self.lightning_config.get("callbacks") or {}
        for name, cfg in callbacks.items():
            try:
                obj = instantiate_from_config(cfg)
            except Exception as e:  # noqa: BLE001 - the JAX harness's rule
                print(f"[harness] skipping callback {name}: {e}", flush=True)
                continue
            if isinstance(obj, cb.ImageLogger):
                self.image_logger = obj.bind(self.logdir)
            elif isinstance(obj, cb.ModelCheckpoint):
                self.checkpoints.append(obj.bind(self.ckptdir))
            elif isinstance(obj, cb.SwapVisualizationCallback):
                self.swap_cb = obj.bind(self.logdir)
        # the default monitor checkpoint of the reference's main_val.py
        monitor = self.model_params.get("monitor")
        if monitor and not any(c.monitor == monitor for c in self.checkpoints):
            self.checkpoints.append(cb.ModelCheckpoint(
                monitor=monitor, mode="min", save_top_k=3, save_last=True,
                filename="{epoch:03d}-{step}").bind(self.ckptdir))
        self.device_stats = cb.DeviceStatsCallback()
        self.lr_monitor = cb.LearningRateMonitor()

    # --- state persistence ---------------------------------------------------
    def save_checkpoint(self, path):
        save_train_checkpoint(path, self.model, self.state, self.variables)

    def _ensure_state(self):
        """The train state: a seeded fresh init, then the lenient restore of
        ``resume_ckpt`` if one is set."""
        if self.state is not None:
            return
        self.model.init_parameters(
            torch.Generator(self.device).manual_seed(self.seed))
        self.state = create_train_state(
            self.model, {**self.model_params, "batch_size": self.batch_size,
                         "accumulate_grad_batches": self.accumulate},
            learning_rate=self.learning_rate)
        self.variables = fresh_variables(self.model)
        if self.resume_ckpt:
            self.variables = restore_train_checkpoint(
                self.resume_ckpt, self.model, self.state)

    def _device_grid(self, ds) -> torch.Tensor:
        if not self.device_data:
            raise NotImplementedError(
                "--device_data false streams batches from the host, which "
                "needs the host gather (ROADMAP queue 1 #8); the port keeps "
                "the dataset on the device")
        return device_images(ds.images, self.device)

    # --- the loops -----------------------------------------------------------
    def fit(self, max_epochs=10, max_steps=None, log_every=50):
        if self.is_vq:
            return self.fit_vq(max_epochs=max_epochs, max_steps=max_steps,
                               log_every=log_every)
        cb.SetupCallback(self.logdir, self.ckptdir, self.cfgdir,
                         config=self.config,
                         lightning_config=self.lightning_config,
                         now=datetime.datetime.now().strftime(
                             "%Y-%m-%dT%H-%M-%S")).setup()
        self._ensure_state()
        model, state, bs = self.model, self.state, self.batch_size
        train_ds = self.data.dataset("train")
        images = self._device_grid(train_ds)
        latents = (precompute_latents(model, images) if self.cache_latents
                   else None)
        n = len(train_ds)
        spe = n // bs
        print(f"[harness] dataset on the device ({images.numel() / 2**20:.0f}"
              f" MiB), {spe} steps/epoch; latents cached="
              f"{latents is not None}", flush=True)

        def melk(*args):
            print("[harness] SIGUSR1: saving last checkpoint", flush=True)
            self.save_checkpoint(os.path.join(self.ckptdir, "last"))

        try:
            previous = signal.signal(signal.SIGUSR1, melk)
        except (ValueError, AttributeError):  # not the main thread
            previous = None
        step = state.step
        t0 = time.time()
        try:
            for epoch in range(max_epochs):
                self.device_stats.on_epoch_start()
                order = torch.from_numpy(epoch_order(
                    self.seed, epoch, n, bs, len(images))).to(self.device)
                for _ in range(spe):
                    i = step % spe
                    idx = order[i * bs:(i + 1) * bs]
                    batch = (images[idx] if latents is None else
                             {"image": images[idx], "z": latents[idx]})
                    metrics = train_step(
                        model, state, batch,
                        generator=step_generator(self.seed, step,
                                                 self.device))
                    step = state.step
                    self.lr_monitor.log(step, metrics["lr"])
                    if step % log_every == 0:
                        dt = time.time() - t0
                        print(f"step {step} epoch {epoch} loss "
                              f"{metrics['train/loss'].item():.4f} "
                              f"({log_every / dt:.2f} it/s)", flush=True)
                        t0 = time.time()
                    if self.image_logger is not None and (
                            self.image_logger.wants_metrics(step)
                            or self.image_logger.due(step)):
                        try:
                            self.image_logger.maybe_log(
                                step, "train", self._log_images_fn(),
                                images[idx[:16]],
                                metrics=lambda m=metrics: {
                                    k: float(v) for k, v in m.items()})
                        except Exception as e:  # noqa: BLE001
                            # an image-log failure must not end a long run
                            print(f"[harness] image log failed at step "
                                  f"{step}: {type(e).__name__}: {e}",
                                  flush=True)
                    for ck in self.checkpoints:
                        if ck.every_n_train_steps:
                            ck.maybe_save(self.save_checkpoint, step, epoch)
                    if max_steps and step >= max_steps:
                        raise StopIteration
                self.device_stats.on_epoch_end(epoch)
                if (epoch + 1) % self.check_val_every_n_epoch == 0 \
                        or epoch == max_epochs - 1:
                    val_metrics = self.validate(epoch, step)
                    self.last_val_metrics = val_metrics
                    for ck in self.checkpoints:
                        ck.maybe_save(self.save_checkpoint, step, epoch,
                                      metrics=val_metrics)
        except StopIteration:
            pass
        except KeyboardInterrupt:
            print("[harness] interrupted: saving last checkpoint", flush=True)
            self.save_checkpoint(os.path.join(self.ckptdir, "last"))
            raise
        finally:
            if previous is not None:
                signal.signal(signal.SIGUSR1, previous)
        self.save_checkpoint(os.path.join(self.ckptdir, "last"))
        return state

    def _log_images_fn(self):
        def fn(batch, use_ema=True, **kw):
            self.model.scale_factor = float(self.state.scale_factor)
            return log_images(
                self.model, batch, ema=self.state.ema if use_ema else None,
                **kw)
        return fn

    def test(self) -> dict:
        """The full sweep and metric battery on the current (or restored)
        weights; writes ``<logdir>/test_results.json`` (and, through the
        eval driver, ``metrics_sin/<step>.json``). A VQ-GAN run writes its
        validation metrics, and skips without a trained state, as the JAX
        harness does."""
        os.makedirs(self.logdir, exist_ok=True)
        if self.is_vq:
            if self.state is None:
                print("[harness] test: no trained VQ state; skipping",
                      flush=True)
                return {}
            results = self.validate_vq()
        else:
            self._ensure_state()
            # the test pass scores the full tier, whatever the fit's was
            results = self.validate(epoch=-1, step=self.state.step,
                                    budget="full")
        out_path = os.path.join(self.logdir, "test_results.json")
        with open(out_path, "w") as fh:
            json.dump(results, fh, indent=2)
        print(f"[harness] test results -> {out_path}: " + " ".join(
            f"{k}={v:.4f}" for k, v in results.items()), flush=True)
        return results


    # --- the VQ-GAN first stage ------------------------------------------------
    def fit_vq(self, max_epochs=10, max_steps=None, log_every=50):
        """The VQ-GAN loop from a seeded fresh init; ``max_steps`` counts the
        fit's steps from 0."""
        if self.resume_ckpt:
            raise NotImplementedError(
                "the VQ-GAN trainer starts from a seeded fresh init, as the "
                "JAX fit_vq does: resuming it is not ported")
        cb.SetupCallback(self.logdir, self.ckptdir, self.cfgdir,
                         config=self.config,
                         lightning_config=self.lightning_config,
                         now=datetime.datetime.now().strftime(
                             "%Y-%m-%dT%H-%M-%S")).setup()
        model, bs = self.model, self.batch_size
        model.init_parameters(
            torch.Generator(self.device).manual_seed(self.seed))
        state = self.state = vq_trainer.create_vq_train_state(
            model, self.learning_rate, self.accumulate)
        train_ds = self.data.dataset("train")
        images = self._device_grid(train_ds)
        n = len(train_ds)
        spe = n // bs
        print(f"[harness] dataset on the device ({images.numel() / 2**20:.0f}"
              f" MiB), {spe} steps/epoch", flush=True)

        def melk(*args):
            print("[harness] SIGUSR1: saving last checkpoint", flush=True)
            self._save_vq_checkpoint(os.path.join(self.ckptdir, "last"))

        try:
            previous = signal.signal(signal.SIGUSR1, melk)
        except (ValueError, AttributeError):  # not the main thread
            previous = None
        t0 = time.time()
        try:
            for epoch in range(max_epochs):
                self.device_stats.on_epoch_start()
                order = torch.from_numpy(epoch_order(
                    self.seed, epoch, n, bs, len(images))).to(self.device)
                for _ in range(spe):
                    i = state.step % spe
                    metrics = vq_trainer.train_step(
                        model, state, images[order[i * bs:(i + 1) * bs]])
                    step = state.step
                    if step % log_every == 0:
                        dt = time.time() - t0
                        print(f"step {step} epoch {epoch} rec "
                              f"{metrics['train/rec_loss'].item():.4f} disc "
                              f"{metrics['train/disc_loss'].item():.4f} "
                              f"({log_every / dt:.2f} it/s)", flush=True)
                        t0 = time.time()
                    if self.image_logger is not None and \
                            self.image_logger.check_frequency(step):
                        self._log_vq_images(step, images)
                    if max_steps and step >= max_steps:
                        raise StopIteration
                self.device_stats.on_epoch_end(epoch)
                val_metrics = self.validate_vq()
                if val_metrics:
                    print(f"[val epoch {epoch}] rec_loss="
                          f"{val_metrics.get('val/rec_loss', float('nan')):.4f}",
                          flush=True)
                    self.last_val_metrics = val_metrics
                    for ck in self.checkpoints:
                        ck.maybe_save(self._save_vq_checkpoint, state.step,
                                      epoch, metrics=val_metrics)
        except StopIteration:
            pass
        except KeyboardInterrupt:
            print("[harness] interrupted: saving last checkpoint", flush=True)
            self._save_vq_checkpoint(os.path.join(self.ckptdir, "last"))
            raise
        finally:
            if previous is not None:
                signal.signal(signal.SIGUSR1, previous)
        self._save_vq_checkpoint(os.path.join(self.ckptdir, "last"))
        return state

    @torch.no_grad()
    def _log_vq_images(self, step: int, images) -> None:
        """Inputs and reconstructions of 8 grid rows drawn with
        ``RandomState(step)``, as ``.npy`` grids under ``images/train``."""
        idx = np.random.RandomState(step).randint(0, len(images), 8)
        x = vq_trainer.as_images(images[torch.from_numpy(idx).to(self.device)])
        rec = self.model.reconstruct(x)
        root = os.path.join(self.logdir, "images", "train")
        for key, v in (("inputs", x), ("reconstructions", rec)):
            cb.save_image_grid(v.permute(0, 2, 3, 1).cpu().numpy(),
                               os.path.join(root, f"{key}_gs-{step:06}.npy"))

    def validate_vq(self) -> dict:
        """The means of the eval step's metrics over the validation grid in
        order, in whole batches, at most ``val_batches`` of them."""
        val_ds = self.data.dataset(
            "validation" if "validation" in self.data.dataset_configs
            else "train")
        images = self._device_grid(val_ds)
        bs = self.batch_size
        steps = len(val_ds) // bs
        if self.val_batches:
            steps = min(steps, self.val_batches)
        rows = []
        for i in range(steps):
            idx = torch.arange(i * bs, (i + 1) * bs,
                               device=self.device) % len(images)
            rows.append(vq_trainer.eval_step(self.model, self.state,
                                             images[idx]))
        if not rows:
            return {}
        keys = list(rows[0])
        means = torch.stack([torch.stack([r[k] for k in keys]) for r in rows]
                            ).cpu().double().mean(0).tolist()
        return dict(zip(keys, means))

    def _save_vq_checkpoint(self, path: str) -> None:
        """``<path>/train_state.pt``: the fp32 model (generator,
        discriminator with its batch statistics, LPIPS), both Adam states
        and their accumulation buffers, the step; then
        ``<ckptdir>/compact_last.npz``."""
        state = self.state
        os.makedirs(path, exist_ok=True)
        torch.save({"step": state.step, "model": self.model.state_dict(),
                    "gen_opt": state.gen_opt.state_dict(),
                    "disc_opt": state.disc_opt.state_dict(),
                    "gen_acc": vars(state.gen_acc),
                    "disc_acc": vars(state.disc_acc)},
                   os.path.join(path, STATE_FILE))
        try:  # the JAX harness's rule: the mirror never ends a run
            save_compact_vq(os.path.join(self.ckptdir, "compact_last.npz"),
                            convert.vq_flax_state(self.model, state.step))
        except Exception as e:  # noqa: BLE001
            print(f"[harness] compact npz mirror failed: {e}", flush=True)

    def log_run_metadata(self):
        """``<logdir>/run_metadata.json``: the logger's static config (or
        the run's name and resolved config) and the runtime facts."""
        logger_cfg = (self.lightning_config.get("logger") or {}).get(
            "params", {})
        meta = {
            "name": logger_cfg.get("name") or os.path.basename(self.logdir),
            "project": logger_cfg.get("project"),
            "config": logger_cfg.get("config") or self.config,
            "learning_rate": self.learning_rate,
            "base_learning_rate": self.base_lr,
            "batch_size": self.batch_size,
            "n_devices": 1,
            "accumulate_grad_batches": self.accumulate,
            "seed": self.seed,
        }
        for k in ("use_mcl", "mcl_type", "lambda_mcl", "mcl_tau",
                  "mcl_sigma", "mcl_neg_mode", "indep_type", "lambda_indep",
                  "indep_bandwidth"):
            if k in self.model_params:
                meta[k] = self.model_params[k]
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "run_metadata.json")
        with open(path, "w") as fh:
            json.dump(meta, fh, indent=2, default=str)
        print(f"[harness] run metadata -> {path}", flush=True)

    def validate(self, epoch: int, step: int, budget=None) -> dict:
        """The representation sweep over the whole validation grid and the
        metric battery, DCI at ``budget`` (default: the fast tier, the full
        one under ``--full_val_metrics``); ``val/*`` scores. Records the
        sweep's and each metric's seconds in ``timings``."""
        if self.label_dataset is None:
            return {}
        if self.val_batches:
            raise NotImplementedError(
                "--val_batches selects the host-streamed sweep, which is not "
                "ported (ROADMAP queue 1 #8)")
        val_ds = self.data.dataset(
            "validation" if "validation" in self.data.dataset_configs
            else "train")
        images = self._device_grid(val_ds)
        n = len(val_ds)
        if n != len(images):
            raise ValueError(f"{n} validation indices over {len(images)} "
                             "device rows: the sweep covers every index")
        t0 = time.perf_counter()
        reps = encode_sweep(self.model, images).cpu().numpy()
        t1 = time.perf_counter()
        reps_dir = os.path.join(self.logdir, "reps")
        os.makedirs(reps_dir, exist_ok=True)
        np.save(os.path.join(reps_dir, f"{step}.npy"), reps)
        t2 = time.perf_counter()
        tier = budget or ("full" if self.full_val_metrics else "fast")
        metric_s: dict = {}
        scores = eval_func(self.label_dataset, reps,
                           os.path.join(self.logdir, "metrics_sin"), step,
                           metrics=self.eval_metrics, budget=tier,
                           device=self.device, timings=metric_s)
        self.timings = {"images": n, "sweep_s": t1 - t0,
                        "metrics_s": time.perf_counter() - t2,
                        "metric_s": metric_s, "tier": tier}
        out = {}
        if "factor_VAE" in scores:
            out["val/factor_vae_score"] = scores["factor_VAE"].get(
                "eval_accuracy", 0.0)
        if "dci" in scores:
            out["val/dci_disentanglement"] = scores["dci"].get(
                "disentanglement", 0.0)
            out["val/dci_completeness"] = scores["dci"].get(
                "completeness", 0.0)
        if "MIG" in scores:
            out["val/mig"] = scores["MIG"].get("discrete_mig", 0.0)
        if "beta_VAE" in scores:
            out["val/beta_vae"] = scores["beta_VAE"].get("eval_accuracy", 0.0)
        print(f"[val epoch {epoch}] ({tier} tier) sweep {n} images "
              f"{t1 - t0:.3f}s, metrics {self.timings['metrics_s']:.3f}s ("
              + " ".join(f"{k} {v:.3f}s" for k, v in metric_s.items())
              + "): " + " ".join(f"{k.split('/')[-1]}={v:.4f}"
                                 for k, v in out.items()), flush=True)
        if self.swap_cb is not None:
            # not caught, unlike the JAX harness: an error here would hide a
            # kernel failure in the DDIM swap
            t3 = time.perf_counter()
            self.model.scale_factor = float(self.state.scale_factor)
            self.swap_cb.on_validation_epoch_end(
                self.model, self.state.ema, images, epoch, step)
            self.timings["swap_visualization_s"] = time.perf_counter() - t3
        return out


def _checkpoint_path(path: str) -> bool:
    return os.path.isfile(path) or os.path.exists(
        os.path.join(path, MODEL_FILE))


def main(argv=None) -> Trainer:
    parser = get_parser()
    opt, unknown = parser.parse_known_args(argv)
    now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    if opt.devices not in (None, 1):
        raise ValueError("the port trains on one device (data parallel is "
                         "ROADMAP queue 1 #14)")

    if opt.resume:
        if not os.path.exists(opt.resume):
            raise ValueError(f"Cannot find {opt.resume}")
        if _checkpoint_path(opt.resume):
            logdir = os.path.dirname(os.path.dirname(opt.resume.rstrip("/")))
            ckpt = opt.resume
        else:
            logdir = opt.resume.rstrip("/")
            ckpt = os.path.join(logdir, "checkpoints", "last")
        opt.base = sorted(glob.glob(
            os.path.join(logdir, "configs", "*.json"))) + opt.base
        name = None
    else:
        ckpt = None
        name = opt.name or (os.path.splitext(
            os.path.basename(opt.base[0]))[0] if opt.base else "")
        logdir = None

    config = load_configs(opt.base, unknown)
    config = apply_token_num(config, opt.token_num)
    lightning_config = config.pop("lightning", {})
    if logdir is None:
        logdir, _ = name_logdir(opt.logdir, now, name, opt.postfix, config,
                                opt.token_num)

    trainer_cfg = dict(lightning_config.get("trainer", {}))
    accumulate = (opt.accumulate_grad_batches
                  or trainer_cfg.get("accumulate_grad_batches") or 1)
    max_epochs = opt.max_epochs or trainer_cfg.get("max_epochs", 10)

    trainer = Trainer(config, lightning_config, logdir=logdir, seed=opt.seed,
                      accumulate=accumulate, scale_lr=opt.scale_lr,
                      val_batches=opt.val_batches,
                      eval_metrics=opt.eval_metrics,
                      check_val_every_n_epoch=(
                          opt.check_val_every_n_epoch
                          or trainer_cfg.get("check_val_every_n_epoch", 1)),
                      device_data=opt.device_data,
                      cache_latents=opt.cache_latents, device=opt.device,
                      full_val_metrics=opt.full_val_metrics)
    if opt.resume_ckpt and not ckpt:
        ckpt = opt.resume_ckpt
    if ckpt:
        print(f"[harness] resuming from {ckpt}", flush=True)
        trainer.resume_ckpt = ckpt

    trainer.log_run_metadata()
    interrupted = False
    if opt.train:
        try:
            trainer.fit(max_epochs=max_epochs, max_steps=opt.max_steps)
        except KeyboardInterrupt:
            interrupted = True
    if not opt.no_test and not interrupted and (opt.train or opt.resume):
        trainer.test()
    return trainer
