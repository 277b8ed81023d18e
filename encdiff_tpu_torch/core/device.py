"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and
    no CUDA device is present (there is no silent fallback to the CPU).

    On CUDA it also turns TF32 off for matmuls and cuDNN convolutions: the
    VQ codebook argmin needs exact fp32 distances (near-ties flip under
    TF32's 10-bit mantissa), and the port is held against the fp32 JAX
    reference.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
