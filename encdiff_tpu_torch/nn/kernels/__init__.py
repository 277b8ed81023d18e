"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

Counterpart of ``encdiff_tpu/nn/pallas/``. Every wrapper runs its plain
version on a CPU tensor and launches its kernel on a CUDA tensor, counting
each launch in ``<wrapper>.launches``. Inside ``plain_path()`` the wrappers
run their plain versions on CUDA tensors too, counted in
``<wrapper>.plain_calls``: that is the reference path the kernels are held
against on the card, and the serving path never enters it.
"""

from __future__ import annotations

import contextlib

import torch

_ROUTE = {"plain": False}
_INT_MAX = 2**31 - 1


@contextlib.contextmanager
def plain_path():
    """Run the plain PyTorch versions on CUDA tensors inside the block."""
    prev = _ROUTE["plain"]
    _ROUTE["plain"] = True
    try:
        yield
    finally:
        _ROUTE["plain"] = prev


def takes_plain(wrapper, x) -> bool:
    """Whether ``wrapper`` runs its plain version on tensor ``x``; counts
    a plain call on a CUDA tensor in ``wrapper.plain_calls``."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {x.device}")
    if _ROUTE["plain"]:
        wrapper.plain_calls += 1
        return True
    return False


def check_cuda_tensor(name: str, t, device, shape=None) -> None:
    """Raise unless ``t`` is a float32 tensor on ``device`` (of ``shape``)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def head_strides(name, tensors):
    """The batch, head and row strides of each (B, H, L, dh) tensor; raises
    unless its last dimension is contiguous and its strides fit int32."""
    out = []
    for tname, t in tensors:
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {tname} needs a contiguous last "
                             f"dimension, strides {t.stride()}")
        if max(t.stride()) > _INT_MAX:
            raise ValueError(f"{name}: {tname} strides exceed int32")
        out += t.stride()[:3]
    return out


def launch_stream(device) -> int:
    """The handle of PyTorch's current stream on ``device``, which must be
    the current CUDA device (a kernel launches on the current device)."""
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {device} but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")
