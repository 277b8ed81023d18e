"""Host-side training callbacks.

Counterpart of ``encdiff_tpu/train/callbacks.py:22-296``: plain objects
whose hooks the harness calls. Two differences: the machine with the card
has neither PIL nor a YAML writer, so image grids are written as uint8
``.npy`` arrays (``<key>_gs-<step>.npy`` where the JAX package writes
``.png``) and ``SetupCallback`` dumps the configs as JSON.
``SwapVisualizationCallback`` (:298-348) writes its grids as ``.npy`` too.
"""

from __future__ import annotations

import csv
import json
import os
import re
import shutil
import time
from typing import Any

import numpy as np
import torch

from encdiff_tpu_torch.core import ema as ema_lib
from encdiff_tpu_torch.core.config import instantiate_from_config


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8, clamped."""
    img = np.clip((np.asarray(img, np.float32) + 1.0) / 2.0, 0.0, 1.0)
    return (img * 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """(N,H,W,C) -> one (gh*H, gw*W, C) grid (torchvision.make_grid stand-in)."""
    n, h, w, c = images.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[pad + r * (h + pad):pad + r * (h + pad) + h,
             pad + col * (w + pad):pad + col * (w + pad) + w] = images[i]
    return grid


def save_image_grid(images: np.ndarray, path: str, nrow: int = 4) -> None:
    """Images in [-1, 1] -> one uint8 grid, saved with ``np.save``."""
    grid = make_grid(to_uint8(images), nrow=nrow)
    if grid.shape[-1] == 1:
        grid = grid[..., 0]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, grid)


class Record:
    """CSV loss logger, one row per ``interval`` steps."""

    def __init__(self, path: str | None = None, interval: int = 200,
                 plot_image: bool = False, **kwargs):
        del kwargs
        self.path = path
        self.interval = interval
        self.plot_image = plot_image
        self._keys: list[str] | None = None

    def bind(self, logdir: str):
        if self.path is None:
            self.path = os.path.join(logdir, "record.csv")
        return self

    def log(self, step: int, metrics: dict[str, Any]):
        if step % self.interval != 0 or self.path is None:
            return
        row = {"step": step,
               **{k: float(v) for k, v in metrics.items()
                  if np.ndim(v) == 0}}
        write_header = not os.path.exists(self.path)
        if self._keys is None:
            self._keys = list(row.keys())
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._keys, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)


class ImageLogger:
    """Periodic ``log_images`` grid dumps. ``increase_log_steps`` adds
    power-of-2 warmup steps as the reference does."""

    def __init__(self, batch_frequency=2000, max_images=8, clamp=True,
                 increase_log_steps=True, rescale=True,
                 disabled=False, log_on_batch_idx=False, log_first_step=False,
                 log_images_kwargs=None, log_config=None, **kwargs):
        del kwargs
        self.batch_freq = batch_frequency
        self.max_images = max_images
        self.clamp = clamp
        self.rescale = rescale
        self.disabled = disabled
        self.log_on_batch_idx = log_on_batch_idx
        self.log_first_step = log_first_step
        self.log_images_kwargs = dict(log_images_kwargs or {})
        self.log_steps = ([2 ** n for n in range(int(np.log2(self.batch_freq)) + 1)]
                          if increase_log_steps else [self.batch_freq])
        self.record = None
        if log_config is not None:
            self.record = instantiate_from_config(log_config)
        self.logdir = None

    def bind(self, logdir: str):
        self.logdir = logdir
        if self.record is not None:
            self.record.bind(logdir)
        return self

    def due(self, step: int) -> bool:
        """Side-effect-free peek at check_frequency."""
        return step % self.batch_freq == 0 or step in self.log_steps

    def check_frequency(self, step: int) -> bool:
        if step % self.batch_freq == 0 or step in self.log_steps:
            try:
                self.log_steps.pop(0)
            except IndexError:
                pass
            return True
        return False

    def wants_metrics(self, step: int) -> bool:
        """True when this step's metrics will be consumed: the train loop
        reads the device scalars only then."""
        return self.record is not None and step % self.record.interval == 0

    def maybe_log(self, step: int, split: str, log_images_fn, batch,
                  metrics=None):
        if self.record is not None and metrics is not None and callable(metrics):
            if self.wants_metrics(step):
                self.record.log(step, metrics())
        elif self.record is not None and metrics is not None:
            self.record.log(step, metrics)
        if self.disabled or not self.check_frequency(step):
            return
        images = log_images_fn(batch, N=self.max_images,
                               **self.log_images_kwargs)
        root = os.path.join(self.logdir or ".", "images", split)
        for k, v in images.items():
            v = np.asarray(v)
            if v.ndim == 5:  # row-strips (b, t, h, w, c) -> flatten rows
                v = v.reshape(-1, *v.shape[2:])
            if v.ndim != 4 or v.shape[0] == 0:
                continue
            nrow = (self.max_images
                    if k == "samples_swapping" else min(4, v.shape[0]))
            save_image_grid(
                v, os.path.join(root, f"{k}_gs-{step:06}.npy"), nrow=nrow)


class ModelCheckpoint:
    """Top-k checkpointing on a monitored metric (the Lightning
    ModelCheckpoint surface the configs use: monitor / mode / save_top_k /
    filename / save_last / every_n_train_steps)."""

    def __init__(self, dirpath=None, filename="{step}", monitor=None,
                 mode="min", save_top_k=1, save_last=False, verbose=False,
                 every_n_train_steps=None, save_weights_only=False, **kwargs):
        del kwargs
        self.dirpath = dirpath
        self.filename = filename
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.verbose = verbose
        self.every_n_train_steps = every_n_train_steps
        self.save_weights_only = save_weights_only
        self.best: list[tuple[float, str]] = []  # (score, path)

    def bind(self, ckptdir: str):
        if self.dirpath is None:
            self.dirpath = ckptdir
        return self

    def _fname(self, step: int, epoch: int, score: float | None) -> str:
        name = (self.filename
                .replace("{step}", f"{step:09}")
                .replace("{epoch:03d}", f"{epoch:03d}")
                .replace("{epoch}", f"{epoch}"))
        if score is not None and "{" in name:
            name = re.sub(r"\{[^}]*:\.4f\}", f"{score:.4f}", name)
        return name

    def maybe_save(self, save_fn, step: int, epoch: int,
                   metrics: dict[str, Any] | None = None):
        """save_fn(path) persists the state. Called at the end of a
        validation epoch (monitored) or after each step
        (every_n_train_steps)."""
        if self.every_n_train_steps:
            if step % self.every_n_train_steps == 0 and step > 0:
                path = os.path.join(self.dirpath,
                                    self._fname(step, epoch, None))
                save_fn(path)
            return
        if self.monitor is None or metrics is None:
            path = os.path.join(self.dirpath, self._fname(step, epoch, None))
            save_fn(path)
            return
        if self.monitor not in metrics:
            # a monitor the validation metrics never hold still honours
            # save_last, so that the run can be resumed
            if self.save_last:
                save_fn(os.path.join(self.dirpath, "last"))
            return
        score = float(metrics[self.monitor])
        sign = 1.0 if self.mode == "max" else -1.0
        # self.best is kept sorted best-first by signed score
        if len(self.best) < self.save_top_k or \
                sign * score > sign * self.best[-1][0]:
            path = os.path.join(self.dirpath,
                                self._fname(step, epoch, score))
            save_fn(path)
            self.best.append((score, path))
            self.best.sort(key=lambda t: -sign * t[0])
            while len(self.best) > self.save_top_k:
                _, stale = self.best.pop()
                shutil.rmtree(stale, ignore_errors=True)
        if self.save_last:
            save_fn(os.path.join(self.dirpath, "last"))


class LearningRateMonitor:
    """Records the scheduled LR of each step."""

    def __init__(self, logging_interval="step", **kwargs):
        del kwargs
        self.logging_interval = logging_interval
        self.history: list[tuple[int, float]] = []

    def log(self, step: int, lr: float):
        self.history.append((step, float(lr)))


class SetupCallback:
    """Creates logdir / ckptdir / cfgdir and dumps the merged configs as
    ``<now>-project.json`` and ``<now>-lightning.json``, the latter without
    its ``lightning`` wrapper, as the reference dumps it."""

    def __init__(self, logdir, ckptdir, cfgdir, config=None,
                 lightning_config=None, now=""):
        self.logdir, self.ckptdir, self.cfgdir = logdir, ckptdir, cfgdir
        self.config = config
        self.lightning_config = lightning_config
        self.now = now

    def setup(self):
        for d in (self.logdir, self.ckptdir, self.cfgdir):
            os.makedirs(d, exist_ok=True)
        for cfg, kind in ((self.config, "project"),
                          (self.lightning_config, "lightning")):
            if cfg is not None:
                with open(os.path.join(self.cfgdir,
                                       f"{self.now}-{kind}.json"), "w") as f:
                    json.dump(cfg, f, indent=2)


class DeviceStatsCallback:
    """Per-epoch wall time and peak device memory (the reference's
    CUDACallback)."""

    def __init__(self):
        self.epoch_start = None

    def on_epoch_start(self):
        self.epoch_start = time.time()

    def on_epoch_end(self, epoch: int) -> dict:
        dt = time.time() - (self.epoch_start or time.time())
        stats = {}
        if torch.cuda.is_available():
            stats["peak_bytes_in_use"] = torch.cuda.max_memory_allocated()
        out = {"epoch": epoch, "epoch_time_s": dt, **stats}
        print(f"[epoch {epoch}] time {dt:.1f}s "
              + (f"peak_mem {stats['peak_bytes_in_use'] / 2**20:.0f}MiB"
                 if stats else ""), flush=True)
        return out


class SwapVisualizationCallback:
    """Fixed-input swap grids at the end of validation
    (``swap_training_end.py:10-252`` of the reference): ``num_samples``
    rows of the validation grid chosen by ``np.random.RandomState(seed)``,
    ``evalx.swap.swap_sample`` at DDIM ``ddim_steps`` and ``eta`` on the
    EMA's weights, its noise from a ``torch.Generator`` seeded with
    ``seed`` (the JAX callback's ``PRNGKey(seed)`` draws other numbers).
    Writes the inputs over all swaps, ``swap_grid_e<epoch>_s<step>.npy``,
    and one page per factor, ``factor_<k>_e<epoch>.npy``, under
    ``<logdir>/swap_visualization``.

    The JAX harness catches and prints this callback's errors; the port's
    lets them raise, since a caught error here would hide a kernel failure
    in the DDIM swap."""

    def __init__(self, num_samples=8, ddim_steps=200, eta=1.0, seed=42,
                 every_n_epochs=1, **kwargs):
        del kwargs
        self.num_samples = num_samples
        self.ddim_steps = ddim_steps
        self.eta = eta
        self.seed = seed
        self.every_n_epochs = every_n_epochs
        self.logdir = None

    def bind(self, logdir: str):
        self.logdir = logdir
        return self

    @torch.no_grad()
    def on_validation_epoch_end(self, model, ema, images, epoch: int,
                                step: int):
        """``images``: the validation grid (N, S, S, 3) uint8 on the
        model's device; ``ema``: the UNet's ``EmaState`` or None."""
        if epoch % self.every_n_epochs:
            return
        from encdiff_tpu_torch.evalx.swap import swap_sample

        rs = np.random.RandomState(self.seed)
        idx = rs.choice(len(images), size=self.num_samples, replace=False)
        batch, _ = model.split_batch(
            images[torch.from_numpy(idx).to(images.device)])
        gen = torch.Generator(model.device).manual_seed(self.seed)
        with ema_lib.maybe_applied(ema, model.unet):
            x = swap_sample(model, batch, ddim_steps=self.ddim_steps,
                            eta=self.eta, generator=gen)
        batch, x = batch.cpu().numpy(), x.cpu().numpy()
        root = os.path.join(self.logdir or ".", "swap_visualization")
        save_image_grid(np.concatenate([batch, x], axis=0),
                        os.path.join(root, f"swap_grid_e{epoch:03}_"
                                           f"s{step:07}.npy"),
                        nrow=self.num_samples)
        for cdx in range(x.shape[0] // self.num_samples):
            blk = x[cdx * self.num_samples:(cdx + 1) * self.num_samples]
            save_image_grid(np.concatenate([batch, blk], axis=0),
                            os.path.join(root, f"factor_{cdx:02}_"
                                               f"e{epoch:03}.npy"),
                            nrow=self.num_samples)
