"""All-factor latent-swap generation.

Counterpart of ``encdiff_tpu/evalx/swap.py:35-111`` (``swap_conditions``,
``_decode_chunked``, ``swap_sample``): the swaps of all ``latent_unit``
factors fold into one batch of ``latent_unit * B`` samples, run through DDIM
in chunks of a token budget and decoded in factor-major order.
"""

from __future__ import annotations

import torch

#: latent tokens per DDIM chunk: 32 samples at 64x64 latents, 512 at 16x16
TOKEN_BUDGET = 2 ** 17
#: output pixels per decode: 32 images at 256 px, 512 at 64 px
PX_BUDGET = 2 ** 21


def swap_conditions(u):
    """(B, U) scalars -> (U, B, U): factor c of every sample replaced by
    sample 0's value, for every c at once."""
    b, n_units = u.shape
    eye = torch.eye(n_units, dtype=u.dtype, device=u.device)[:, None, :]
    base = u[None].expand(n_units, b, n_units)
    return base * (1 - eye) + u[0][None, None, :] * eye


def _decode_chunked(model, z, px_budget: int = PX_BUDGET):
    """decode_first_stage in chunks of at most ``px_budget`` output pixels,
    the output side taken from the first stage's configured resolution."""
    out_side = model.first_stage_model.resolution
    chunk = max(1, px_budget // (out_side * out_side))
    return torch.cat([model.decode_first_stage(z[i:i + chunk])
                      for i in range(0, z.shape[0], chunk)])


@torch.no_grad()
def swap_sample(model, images, ddim_steps: int = 200, eta: float = 1.0,
                x_T=None, noises=None,
                generator: torch.Generator | None = None):
    """images (B, S, S, 3) in [-1, 1] -> (U*B, S, S, 3) decoded swaps,
    factor-major. The decode zero-fills the disentangled-concat channels.

    The U*B samples run through DDIM in chunks of ``TOKEN_BUDGET // h·w``
    (one chunk for the flagship's 160 at 16x16 latents, 32 at the faces'
    64x64), each decoded as it finishes. ``x_T`` (U*B, h, w, C) and the
    per-step ``noises`` (S, U*B, h, w, C) may be injected and are sliced per
    chunk; otherwise each chunk draws its own from ``generator``."""
    u = model.cond_encoding(images)
    b, n_units = u.shape
    tokens = model.cond_warp(swap_conditions(u).reshape(n_units * b, n_units))
    chunk = max(1, TOKEN_BUDGET // (model.image_size * model.image_size))
    outs = []
    for i in range(0, tokens.shape[0], chunk):
        part = slice(i, i + chunk)
        samples = model.sample_ddim(
            tokens[part], steps=ddim_steps, eta=eta,
            x_T=None if x_T is None else x_T[part],
            noises=None if noises is None else [n[part] for n in noises],
            generator=generator)
        outs.append(_decode_chunked(model, samples))
    return torch.cat(outs)
