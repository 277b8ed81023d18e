"""``log_images``'s quantize, inpaint and progressive branches, on the CPU.

On the small model of ``torch_small_ldm`` (the same weights in both
packages), at 100 timesteps so that the ancestral chain stays short:

- the keys and shapes of ``inpaint`` and ``plot_progressive_rows`` equal
  the JAX ``log_images``' (their draws differ: each package draws from its
  own generator), with a config whose ``log_every_t`` is 25, not 200;
- each branch's images equal a direct call of the port's sampler and
  decode on the same draws (bit for bit: the same operations);
- the samplers those branches call, on the UNet: ``sample_ddim`` with the
  inpainting mask and ``sample_ddpm`` with its intermediates against the
  JAX model's, on the JAX key sequence's draws;
- the departure's witness: the JAX ``quantize_denoised`` branch raises
  (its ``quantize_fn`` runs the VQ encoder on the latent x0, which shrinks
  it), and the port's ``samples_x0_quantized`` equals the JAX
  ``ddim_sample`` with x0 through the JAX VQ's own codebook, decoded.

Tolerance: images and latents within 1e-5 relative and 1e-5 of the
largest magnitude of the JAX output (``scaled_tol``; fp32 networks summed
in another order by XLA and PyTorch, each step's error scaled by the
chain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.core.schedules import DDIMSchedule as JaxDDIMSchedule
from encdiff_tpu.diffusion import ddim as jddim
from encdiff_tpu.diffusion import ddpm as jddpm
from encdiff_tpu.evalx.swap import log_images as jax_log_images
from encdiff_tpu_torch.evalx.swap import inpaint_mask, log_images
from torch_small_ldm import small_ldm_pair
from torch_threads import one_thread  # noqa: F401

TIMESTEPS = 100
LOG_EVERY_T = 25
BRANCHES = dict(sample=False, sample_swap=False, plot_diffusion_rows=False)


def scaled_tol(ref):
    """1e-5 relative, and 1e-5 of the largest magnitude of ``ref``."""
    return dict(rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def pair():
    return small_ldm_pair(timesteps=TIMESTEPS, log_every_t=LOG_EVERY_T)


def _batch(seed=0, n=2):
    return np.random.RandomState(seed).randint(0, 256, (n, 16, 16, 3),
                                               dtype=np.uint8)


def _tokens(jmodel, jvars, tmodel, batch):
    x = batch.astype(np.float32) / 127.5 - 1.0
    return tmodel.cond_warp(tmodel.cond_encoding(x)), x


def test_branch_keys_and_shapes_match_jax(pair):
    jmodel, jvars, tmodel, _ = pair
    kw = dict(N=2, ddim_steps=4, inpaint=True, plot_progressive_rows=True)
    ref = jax_log_images(jmodel, jvars, _batch(), use_ema=False, **kw)
    log = log_images(tmodel, _batch(), **kw)
    assert {k: v.shape for k, v in log.items()} == {
        k: v.shape for k, v in ref.items()}
    assert log["progressive_row"].shape == (2, TIMESTEPS // LOG_EVERY_T, 16,
                                            16, 3)
    assert log["diffusion_row"].shape[1] == 5  # 0, 25, 50, 75 and 99
    np.testing.assert_array_equal(log["mask"], np.asarray(ref["mask"]))
    for v in log.values():
        assert np.isfinite(v).all()


def test_log_every_t_follows_the_model_unless_given(pair):
    _, _, tmodel, _ = pair
    assert tmodel.log_every_t == LOG_EVERY_T
    log = log_images(tmodel, _batch(), N=2, sample=False, log_every_t=50,
                     plot_progressive_rows=True)
    assert log["diffusion_row"].shape[1] == 3  # 0, 50 and 99
    assert log["progressive_row"].shape[1] == 2


@pytest.mark.parametrize("branch", ["quantize_denoised", "inpaint",
                                    "plot_progressive_rows"])
def test_each_branch_equals_a_direct_sampler_call(pair, branch):
    _, _, tmodel, _ = pair
    batch = _batch(1)
    log = log_images(tmodel, batch, N=2, ddim_steps=4, ddim_eta=1.0,
                     generator=torch.Generator().manual_seed(3),
                     **{branch: True}, **BRANCHES)
    tokens, x = _tokens(None, None, tmodel, batch)
    gen = torch.Generator().manual_seed(3)
    ddim = dict(steps=4, eta=1.0, generator=gen)
    decode = lambda z: tmodel.decode_first_stage(z).numpy()
    if branch == "quantize_denoised":
        want = {"samples_x0_quantized": decode(tmodel.sample_ddim(
            tokens, quantize_denoised=True, **ddim))}
    elif branch == "inpaint":
        z = tmodel.encode_first_stage(x) * tmodel.scale_factor
        mask = inpaint_mask(2, 8)
        want = {"samples_inpainting": decode(tmodel.sample_ddim(
                    tokens, mask=mask, x0=z, **ddim)),
                "mask": mask.numpy(),
                "samples_outpainting": decode(tmodel.sample_ddim(
                    tokens, mask=1.0 - mask, x0=z, **ddim))}
    else:
        _, inter = tmodel.sample_ddpm(tokens, generator=gen,
                                      log_every_t=LOG_EVERY_T)
        want = {"progressive_row": np.stack([decode(z) for z in inter], 1)}
    assert set(log) == {"inputs", "reconstruction", "conditioning", *want}
    for k, v in want.items():
        np.testing.assert_array_equal(log[k], v, err_msg=k)


def _x_T_and_step_keys(rng, steps, draws_per_step):
    """x_T from the key's first split, then ``draws_per_step`` keys a step,
    as ``jddpm.p_sample_loop`` (one) and ``jddim.ddim_sample`` with a mask
    and no x_T (the noise's, then the q_sample's) split them."""
    key, init = jax.random.split(rng)
    steps_keys = []
    for _ in range(steps):
        keys = []
        for _ in range(draws_per_step):
            key, sub = jax.random.split(key)
            keys.append(sub)
        steps_keys.append(keys)
    return init, steps_keys


def test_sample_ddim_inpaint_matches_jax(pair):
    jmodel, jvars, tmodel, _ = pair
    batch = _batch(2)
    tokens, x = _tokens(jmodel, jvars, tmodel, batch)
    z = tmodel.encode_first_stage(x) * tmodel.scale_factor
    mask = inpaint_mask(2, 8)
    shape, rng = (2, 8, 8, 3), jax.random.PRNGKey(4)
    jd = JaxDDIMSchedule.create(jmodel.schedule, 5, eta=1.0)
    denoise = jmodel.make_denoiser(jvars["unet"], jnp.asarray(tokens.numpy()))
    ref, _ = jax.jit(lambda r: jddim.ddim_sample(
        jd, denoise, shape, r, mask=jnp.asarray(mask.numpy()),
        x0=jnp.asarray(z.numpy()), sched=jmodel.schedule))(rng)
    init, keys = _x_T_and_step_keys(rng, 5, 2)
    draw = lambda k: np.array(jax.random.normal(k, shape, jnp.float32))
    out = tmodel.sample_ddim(
        tokens, steps=5, eta=1.0, x_T=draw(init), mask=mask, x0=z,
        noises=[draw(k[0]) for k in keys], q_noises=[draw(k[1]) for k in keys])
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, **scaled_tol(ref))


def test_sample_ddpm_matches_jax(pair):
    jmodel, jvars, tmodel, _ = pair
    tokens, _ = _tokens(jmodel, jvars, tmodel, _batch(5))
    rng = jax.random.PRNGKey(6)
    ref, ref_inter = jax.jit(lambda r: jmodel.sample_ddpm(
        jvars, jnp.asarray(tokens.numpy()), r,
        log_every_t=LOG_EVERY_T))(rng)
    init, keys = _x_T_and_step_keys(rng, TIMESTEPS, 1)
    shape = (2, 8, 8, 3)
    draw = lambda k: np.array(jax.random.normal(k, shape, jnp.float32))
    out, inter = tmodel.sample_ddpm(
        tokens, x_T=draw(init), noises=np.stack([draw(k[0]) for k in keys]),
        log_every_t=LOG_EVERY_T)
    assert inter.shape == (TIMESTEPS // LOG_EVERY_T, *shape)
    ref, ref_inter = np.asarray(ref), np.asarray(ref_inter)
    np.testing.assert_allclose(out.numpy(), ref, **scaled_tol(ref))
    np.testing.assert_allclose(inter.numpy(), ref_inter,
                               **scaled_tol(ref_inter))


def test_quantize_denoised_departs_from_the_jax_branch(pair):
    """The JAX branch raises on the shrunken latent; the port's equals the
    JAX sampler with the JAX VQ's codebook as ``quantize_fn``."""
    jmodel, jvars, tmodel, _ = pair
    batch = _batch(7)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_log_images(jmodel, jvars, batch, N=2, ddim_steps=4,
                       quantize_denoised=True, use_ema=False, **BRANCHES)
    log = log_images(tmodel, batch, N=2, ddim_steps=4, ddim_eta=0.0,
                     quantize_denoised=True,
                     generator=torch.Generator().manual_seed(8), **BRANCHES)
    # eta 0 draws no step noise: x_T is the generator's only draw
    x_T = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(8))
    tokens, _ = _tokens(jmodel, jvars, tmodel, batch)
    sf = jmodel.scale_factor
    fs = jmodel.first_stage_model

    def quantize_fn(x0):
        return fs.module.apply(jvars["first_stage"], x0 / sf,
                               method=lambda m, h: m.quantize(h))[0] * sf

    jd = JaxDDIMSchedule.create(jmodel.schedule, 4, eta=0.0)
    denoise = jmodel.make_denoiser(jvars["unet"], jnp.asarray(tokens.numpy()))
    samples, _ = jax.jit(lambda: jddim.ddim_sample(
        jd, denoise, (2, 8, 8, 3), jax.random.PRNGKey(0),
        x_T=jnp.asarray(x_T.numpy()), quantize_fn=quantize_fn))()
    ref = np.asarray(jmodel.decode_first_stage(jvars["first_stage"], samples))
    np.testing.assert_allclose(log["samples_x0_quantized"], ref,
                               **scaled_tol(ref))
