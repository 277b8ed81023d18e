"""The base of the index-ordered image grids.

A copy of ``ArrayDataset`` from ``encdiff_tpu/data/datasets.py:34-72``:
one uint8 array ``images`` (N, H, W, 3) with vectorised batch access. The
port's grids may hold it as a numpy array on the host or as a torch tensor
on the device they were composed on (``data.synthetic_mpi3d``); a row read
through ``__getitem__`` or ``batch_uint8`` comes back to the host as
numpy, as the JAX class gives it. The harness gathers its batches on the
device from ``images`` itself.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

#: the host threads a renderer draws its independent numpy blocks on (numpy
#: releases the GIL in its loops)
RENDER_THREADS = min(8, os.cpu_count() or 1)


def host_rows(images, indices) -> np.ndarray:
    """``images[indices]`` as a host numpy array, for a numpy array or a
    tensor on any device."""
    if isinstance(images, torch.Tensor):
        idx = torch.as_tensor(np.asarray(indices), dtype=torch.long)
        return images[idx.to(images.device)].cpu().numpy()
    return images[indices]


class ArrayDataset:
    """A (N, H, W, 3) uint8 grid: ``len``, ``__getitem__`` (the image in
    [-1, 1] as float32 HWC, and its index when ``with_idx``) and
    ``batch_uint8`` (a vectorised gather of uint8 rows)."""

    images: Any

    def __init__(self, images, with_idx: bool = False):
        assert images.dtype in (np.uint8, torch.uint8) and images.ndim == 4
        self.images = images
        self.length = len(images)
        self.with_idx = with_idx

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> dict[str, Any]:
        assert index < self.length
        img = host_rows(self.images, index).astype(np.float32) / 127.5 - 1.0
        out = {"image": img}
        if self.with_idx:
            out["idx"] = index
        return out

    def batch_uint8(self, indices: np.ndarray) -> np.ndarray:
        return host_rows(self.images, indices)
