"""All-factor latent-swap generation.

Counterpart of ``encdiff_tpu/evalx/swap.py:35-111`` (``swap_conditions``,
``_decode_chunked``, ``swap_sample``): the swaps of all ``latent_unit``
factors fold into one batch of ``latent_unit * B`` samples, run through one
DDIM chain and decoded in factor-major order.
"""

from __future__ import annotations

import torch


def swap_conditions(u):
    """(B, U) scalars -> (U, B, U): factor c of every sample replaced by
    sample 0's value, for every c at once."""
    b, n_units = u.shape
    eye = torch.eye(n_units, dtype=u.dtype, device=u.device)[:, None, :]
    base = u[None].expand(n_units, b, n_units)
    return base * (1 - eye) + u[0][None, None, :] * eye


def _decode_chunked(model, z, px_budget: int = 2 ** 21):
    """decode_first_stage in chunks of at most ``px_budget`` output pixels
    (512 images at 64 px: the flagship's 160-sample swap is one chunk)."""
    out_side = z.shape[1] * 2 ** (model.first_stage_model.decoder.num_levels - 1)
    chunk = max(1, px_budget // (out_side * out_side))
    return torch.cat([model.decode_first_stage(z[i:i + chunk])
                      for i in range(0, z.shape[0], chunk)])


@torch.no_grad()
def swap_sample(model, images, ddim_steps: int = 200, eta: float = 1.0,
                x_T=None, generator: torch.Generator | None = None):
    """images (B, 64, 64, 3) in [-1, 1] -> (U*B, 64, 64, 3) decoded swaps,
    factor-major. The decode zero-fills the disentangled-concat channels.
    ``x_T`` (U*B, h, w, C) may be injected; otherwise it and any per-step
    noise come from ``generator``."""
    u = model.cond_encoding(images)
    b, n_units = u.shape
    tokens = model.cond_warp(swap_conditions(u).reshape(n_units * b, n_units))
    samples = model.sample_ddim(tokens, steps=ddim_steps, eta=eta, x_T=x_T,
                                generator=generator)
    return _decode_chunked(model, samples)
