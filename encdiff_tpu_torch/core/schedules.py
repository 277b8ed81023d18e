"""Diffusion noise schedules and DDIM sub-schedule tables.

A numpy-only copy of ``encdiff_tpu/core/schedules.py``: the port keeps its
own copy so that it imports nothing of the JAX package. Tables are built in
float64 on the host and stored as float32; the sampler reads them as Python
floats.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np

__all__ = [
    "make_beta_schedule",
    "DiffusionSchedule",
    "make_ddim_timesteps",
    "make_ddim_sampling_parameters",
    "DDIMSchedule",
]


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """β-schedule builder (parity with ``diffusionmodules/util.py:21-71``),
    fp64 on host for accuracy, including the fork's experimental variants."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        betas = _cosine_betas(n_timestep, cosine_s, power=2)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64) ** 0.5
    elif schedule == "test_type1":
        betas = np.linspace(linear_start**2, linear_end**2, n_timestep,
                            dtype=np.float64) ** 0.5
    elif schedule == "test_type2":
        betas = np.linspace(linear_start**1.5, linear_end**1.5, n_timestep,
                            dtype=np.float64) ** 0.6667
    elif schedule == "test_type3":
        betas = np.linspace(linear_start**3, linear_end**3, n_timestep,
                            dtype=np.float64) ** 0.3333
    elif schedule == "test_type4":
        betas = _cosine_betas(n_timestep, cosine_s, power=2) * 0.999 + 0.001
    elif schedule == "test_type5":
        betas = _cosine_betas(n_timestep, cosine_s, power=4)
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas.astype(np.float64)


def _cosine_betas(n_timestep: int, cosine_s: float, power: int) -> np.ndarray:
    timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
    alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** power
    alphas = alphas / alphas[0]
    betas = 1.0 - alphas[1:] / alphas[:-1]
    return np.clip(betas, 0.0, 0.999)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep tables used by DDPM training / ancestral sampling.

    Mirrors the buffer set registered in ``ddpm_enc.py:131-186``; stored as
    float32 numpy (computed in float64).
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    num_timesteps: int
    linear_start: float
    linear_end: float

    @staticmethod
    def create(
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        given_betas: np.ndarray | None = None,
        v_posterior: float = 0.0,
        parameterization: str = "eps",
    ) -> "DiffusionSchedule":
        if given_betas is not None:
            betas = np.asarray(given_betas, dtype=np.float64)
        else:
            betas = make_beta_schedule(
                beta_schedule, timesteps, linear_start=linear_start,
                linear_end=linear_end, cosine_s=cosine_s)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        alphas_cumprod_next = np.append(alphas_cumprod[1:], alphas_cumprod[-1])
        num_timesteps = int(betas.shape[0])

        posterior_variance = (
            (1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev)
            / (1.0 - alphas_cumprod)
            + v_posterior * betas
        )
        if parameterization == "eps":
            # posterior_variance[0] == 0 -> inf at t=0; overwritten below
            # (same wart as ddpm_enc.py:175-186) — silence the warning.
            with np.errstate(divide="ignore"):
                lvlb_weights = betas**2 / (
                    2 * posterior_variance * alphas * (1 - alphas_cumprod))
        elif parameterization == "x0":
            # parity with ddpm_enc.py:179-180 (note: `2. * 1 - a` == `2 - a`)
            lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 - alphas_cumprod)
        else:
            raise NotImplementedError(f"parameterization {parameterization}")
        lvlb_weights = np.array(lvlb_weights)
        lvlb_weights[0] = lvlb_weights[1]

        f32 = partial(np.asarray, dtype=np.float32)
        return DiffusionSchedule(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            alphas_cumprod_next=f32(alphas_cumprod_next),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                / (1.0 - alphas_cumprod)),
            lvlb_weights=f32(lvlb_weights),
            num_timesteps=num_timesteps,
            linear_start=linear_start,
            linear_end=linear_end,
        )


def make_ddim_timesteps(
    ddim_discr_method: str,
    num_ddim_timesteps: int,
    num_ddpm_timesteps: int,
) -> np.ndarray:
    """Timestep subset selection (``diffusionmodules/util.py:73-88``).

    Requesting more DDIM steps than DDPM timesteps clamps to the full chain
    (the reference crashes with a ZeroDivisionError here)."""
    num_ddim_timesteps = min(num_ddim_timesteps, num_ddpm_timesteps)
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.arange(0, num_ddpm_timesteps, c)
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                        num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(
            f"There is no ddim discretization method called {ddim_discr_method!r}")
    # +1 to get the final alpha values right (first scale to data)
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(
    alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float
):
    """(σ, ᾱ_t, ᾱ_{t-1}, ᾱ_{t+1}) tables (``util.py:91-103``)."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray(
        [alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    alphas_next = np.asarray(
        alphacums[ddim_timesteps[1:]].tolist() + [alphacums[-1]])
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev, alphas_next


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-step tables in ascending time order; the sampler walks them
    from the highest noise level down."""

    timesteps: np.ndarray        # ascending ddpm-timestep subset (S,)
    alphas: np.ndarray           # ᾱ at subset steps (S,)
    alphas_prev: np.ndarray
    alphas_next: np.ndarray
    sigmas: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    eta: float
    num_steps: int

    @staticmethod
    def create(
        schedule: DiffusionSchedule,
        num_steps: int,
        eta: float = 0.0,
        discretize: str = "uniform",
    ) -> "DDIMSchedule":
        ts = make_ddim_timesteps(discretize, num_steps, schedule.num_timesteps)
        acp = schedule.alphas_cumprod.astype(np.float64)
        sigmas, alphas, alphas_prev, alphas_next = make_ddim_sampling_parameters(
            acp, ts, eta)
        f32 = partial(np.asarray, dtype=np.float32)
        return DDIMSchedule(
            timesteps=np.asarray(ts, dtype=np.int32),
            alphas=f32(alphas),
            alphas_prev=f32(alphas_prev),
            alphas_next=f32(alphas_next),
            sigmas=f32(sigmas),
            sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
            eta=eta,
            num_steps=int(ts.shape[0]),
        )
