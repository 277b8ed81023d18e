"""All-factor latent-swap generation, and the image logger's battery.

Counterpart of ``encdiff_tpu/evalx/swap.py:35-111`` (``swap_conditions``,
``_decode_chunked``, ``swap_sample``): the swaps of all ``latent_unit``
factors fold into one batch of ``latent_unit * B`` samples, run through DDIM
in chunks of a token budget and decoded in factor-major order. ``log_images``
(:114-238) holds the branches the flagship's image logger turns on.
"""

from __future__ import annotations

import contextlib

import torch

from encdiff_tpu_torch.core import ema as ema_lib
from encdiff_tpu_torch.diffusion.ddpm import q_sample

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


#: the ``log_images`` branches that are not ported (ROADMAP queue 1 #13)
UNPORTED_LOG_BRANCHES = ("quantize_denoised", "inpaint",
                         "plot_progressive_rows")


@torch.no_grad()
def log_images(model, batch, N: int = 8, n_row: int = 4, sample: bool = True,
               ddim_steps: int = 200, ddim_eta: float = 1.0,
               sample_swap: bool = False, plot_diffusion_rows: bool = True,
               ema=None, log_every_t: int = 200,
               generator: torch.Generator | None = None,
               **kwargs) -> dict:
    """The image logger's battery (``encdiff_tpu/evalx/swap.py:114-238``)
    on the first ``N`` images of ``batch`` (uint8, or floats in [-1, 1];
    NHWC): numpy arrays in [-1, 1] under the JAX package's keys —
    ``inputs``, ``reconstruction`` (VQ encode and decode), ``conditioning``
    (the images Encoder4 reads), ``diffusion_row`` (the first
    ``min(N, n_row)`` latents noised at every ``log_every_t``-th timestep
    and the last, decoded: (n_row, T', S, S, 3)), ``samples`` (DDIM from
    the inputs' tokens) and ``samples_swapping`` (``swap_sample``). With
    ``ema`` (an ``EmaState`` of the UNet) both samplers run on its
    weights, as the JAX logger's ``use_ema=True``. Noise comes from
    ``generator`` (seed 42 by default). ``quantize_denoised``, ``inpaint``
    and ``plot_progressive_rows`` raise ``NotImplementedError``."""
    asked = [k for k in UNPORTED_LOG_BRANCHES if kwargs.pop(k, False)]
    if asked:
        raise NotImplementedError(
            f"log_images branches {asked} are not ported (ROADMAP queue 1 "
            "#13)")
    if generator is None:
        generator = torch.Generator(model.device).manual_seed(42)
    x, _ = model.split_batch(batch[:N])
    N = x.shape[0]
    n_row = min(N, n_row)
    z = model.encode_first_stage(x) * model.scale_factor
    log = {"inputs": x, "reconstruction": model.decode_first_stage(z),
           "conditioning": x}
    if plot_diffusion_rows:
        ts = list(range(0, model.num_timesteps, log_every_t))
        if model.num_timesteps - 1 not in ts:
            ts.append(model.num_timesteps - 1)
        z_start = z[:n_row]
        rows = []
        for t in ts:
            noise = torch.randn(z_start.shape, generator=generator,
                                device=model.device)
            z_noisy = q_sample(model.tables, z_start,
                               torch.full((n_row,), t, device=model.device),
                               noise)
            rows.append(model.decode_first_stage(z_noisy))
        log["diffusion_row"] = torch.stack(rows, dim=1)
    with (ema_lib.applied(ema, dict(model.unet.named_parameters()))
          if ema is not None else contextlib.nullcontext()):
        if sample_swap:
            log["samples_swapping"] = swap_sample(
                model, x, ddim_steps=ddim_steps, eta=ddim_eta,
                generator=generator)
        if sample:
            tokens = model.cond_warp(model.cond_encoding(x))
            log["samples"] = model.decode_first_stage(model.sample_ddim(
                tokens, steps=ddim_steps, eta=ddim_eta, generator=generator))
    return {k: v.cpu().numpy() for k, v in log.items()}
