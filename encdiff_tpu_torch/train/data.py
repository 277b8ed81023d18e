"""The data module of a run config, and the order of its batches.

Counterpart of ``encdiff_tpu/train/data.py:24-122``
(``DataModuleFromConfig``) and of the device path's epoch order in
``encdiff_tpu/train/harness.py:465-479``. Datasets are host uint8 arrays
(``images``) that the harness keeps on the device; a batch is one gather
of their rows, normalised on the device by the model's ``split_batch``.
The host-streamed ``epoch_loader`` waits for the host gather (ROADMAP
queue 1 #8).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from encdiff_tpu_torch.core.config import instantiate_from_config


class DataModuleFromConfig:
    """Constructor of ``main_val.py``'s data module: datasets by split
    (``train``, ``validation``, ``test``, ``predict``), each a
    ``{target, params}`` node, and the batch size. ``num_workers`` and
    ``wrap`` are accepted for the configs' sake: a batch is one vectorised
    gather, and the harness reads the datasets unwrapped."""

    def __init__(self, batch_size, train=None, validation=None, test=None,
                 predict=None, wrap=False, num_workers=None, **kwargs):
        del wrap, num_workers, kwargs
        self.batch_size = batch_size
        self.dataset_configs = {
            name: cfg for name, cfg in (("train", train),
                                        ("validation", validation),
                                        ("test", test), ("predict", predict))
            if cfg is not None}
        self.datasets: dict[str, Any] = {}

    def setup(self):
        for name, cfg in self.dataset_configs.items():
            self.datasets[name] = instantiate_from_config(cfg)
        return self

    def dataset(self, name: str):
        if name not in self.datasets:
            self.setup()
        return self.datasets[name]


def epoch_order(seed: int, epoch: int, n: int, batch_size: int,
                n_images: int) -> np.ndarray:
    """The device path's row order of one epoch: the first
    ``(n // batch_size) * batch_size`` entries of a permutation of ``n``
    seeded with ``seed + epoch``, modulo the ``n_images`` rows the device
    holds (a dataset that repeats its images each epoch reports
    ``len = repeat * n_images``)."""
    spe = n // batch_size
    order = np.random.RandomState(seed + epoch).permutation(n)
    return order[: spe * batch_size] % n_images
