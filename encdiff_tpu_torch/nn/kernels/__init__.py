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


def plain_route(x) -> bool:
    """Whether the wrappers run their plain versions on tensor ``x`` (on
    the CPU, or on CUDA inside ``plain_path()``); counts nothing. The
    backward Functions read it to decide how a second order is taken: on
    the plain route autograd records the plain backward's own ops."""
    return x.device.type == "cpu" or _ROUTE["plain"]


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


def check_rows_aligned(name, tensors):
    """Raise unless every (B, H, L) row of each tensor starts on 16 bytes:
    the kernels copy and read rows 16 bytes at a time."""
    for tname, t in tensors:
        if t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:3]):
            raise ValueError(f"{name}: {tname} rows must start on 16 bytes, "
                             f"strides {t.stride()}")


def kernel_rows(t):
    """``t`` itself where its last dimension is contiguous and its rows start
    on 16 bytes, as the attention backward kernels read them (the callers'
    head-strided views), else a contiguous copy: a backward's cotangent may
    be anything autograd hands it, e.g. the expanded all-stride-0 gradient of
    ``out.sum()``."""
    aligned = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
               and all(st % 4 == 0 for st in t.stride()[:-1]))
    return t if aligned else t.contiguous()


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
