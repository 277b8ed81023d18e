"""The port's samplers held against the JAX package's, on the CPU.

``ddim_sample`` with an inpainting mask, with ``quantize_fn`` and with
``log_every``; ``ddim_invert``; ``ddim_sample_cfg``; ``plms_sample``;
``p_mean_variance``; ``p_sample_loop`` with ``log_every_t`` on a
50-timestep schedule. Each runs on both sides with the same denoiser, an
elementwise function written once in jnp and once in torch, so that what
is compared is the samplers' own float32 arithmetic, and with the same
draws: each test rebuilds the JAX function's ``jax.random`` key sequence
and injects its draws (x_T, the per-step noise, the inpainting q_sample
noise) into the port. The samplers are elementwise, so the port runs on
the JAX package's NHWC arrays here. Tolerance: 1e-5 relative and absolute
(``TOL``); the UNet in the loop is held in ``test_torch_attn_maps.py``,
``test_torch_log_images_branches.py`` and ``test_torch_port_slice.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.core.schedules import DDIMSchedule as JaxDDIMSchedule
from encdiff_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from encdiff_tpu.diffusion import ddim as jddim
from encdiff_tpu.diffusion import ddpm as jddpm
from encdiff_tpu.diffusion.plms import plms_sample as jax_plms_sample
from encdiff_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule
from encdiff_tpu_torch.diffusion import ddim, ddpm
from encdiff_tpu_torch.diffusion.plms import plms_sample
from torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = (2, 8, 8, 3)
KW = dict(linear_start=0.0015, linear_end=0.0155)


def _jax_eps(x, t):
    return jnp.tanh(0.7 * x + t.reshape(-1, 1, 1, 1) / 1000.0 - 0.3)


def _torch_eps(x, t):
    return torch.tanh(0.7 * x + t.reshape(-1, 1, 1, 1) / 1000.0 - 0.3)


def _schedules(timesteps=1000, steps=None, eta=0.0):
    ours = DiffusionSchedule.create(timesteps=timesteps, **KW)
    theirs = JaxSchedule.create(timesteps=timesteps, **KW)
    if steps is None:
        return ours, theirs
    return (DDIMSchedule.create(ours, steps, eta=eta),
            JaxDDIMSchedule.create(theirs, steps, eta=eta))


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ddim_draws(rng, steps, with_mask=False):
    """The per-step noises (and q_sample noises) ``jddim.ddim_sample`` draws
    from ``rng`` given x_T (ddim.py:63-70)."""
    noises, q_noises = [], []
    for _ in range(steps):
        rng, nrng = jax.random.split(rng)
        if with_mask:
            rng, qrng = jax.random.split(rng)
            q_noises.append(_t(jax.random.normal(qrng, SHAPE)))
        noises.append(_t(jax.random.normal(nrng, SHAPE)))
    return noises, q_noises


@pytest.mark.parametrize("eta,outpaint", [(0.0, False), (1.0, False),
                                          (1.0, True)])
def test_ddim_sample_inpaint_mask(eta, outpaint):
    sched, jsched = _schedules()
    dsched, jd = _schedules(steps=8, eta=eta)
    mask = np.ones((2, 8, 8, 1), np.float32)
    mask[:, 2:6, 2:6] = 0.0
    if outpaint:
        mask = 1.0 - mask
    x_T, x0 = _randn(0, *SHAPE), _randn(1, *SHAPE)
    rng = jax.random.PRNGKey(2)
    ref, _ = jddim.ddim_sample(jd, _jax_eps, SHAPE, rng, x_T=jnp.asarray(x_T),
                               mask=jnp.asarray(mask), x0=jnp.asarray(x0),
                               sched=jsched)
    noises, q_noises = _ddim_draws(rng, 8, with_mask=True)
    out = ddim.ddim_sample(dsched, _torch_eps, _t(x_T), noises=noises,
                           mask=_t(mask), x0=_t(x0),
                           tables=ddpm.schedule_tables(sched, "cpu"),
                           q_noises=q_noises)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_ddim_sample_quantize_fn():
    _, jd = _schedules(steps=8, eta=1.0)
    dsched, _ = _schedules(steps=8, eta=1.0)
    x_T = _randn(3, *SHAPE)
    rng = jax.random.PRNGKey(4)
    ref, _ = jddim.ddim_sample(jd, _jax_eps, SHAPE, rng, x_T=jnp.asarray(x_T),
                               quantize_fn=lambda x: 0.5 * jnp.tanh(2 * x))
    noises, _ = _ddim_draws(rng, 8)
    out = ddim.ddim_sample(dsched, _torch_eps, _t(x_T), noises=noises,
                           quantize_fn=lambda x: 0.5 * torch.tanh(2 * x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("log_every", [1, 3])
def test_ddim_sample_log_every(log_every):
    dsched, jd = _schedules(steps=10, eta=1.0)
    x_T = _randn(5, *SHAPE)
    rng = jax.random.PRNGKey(6)
    ref, (ref_imgs, ref_x0s) = jddim.ddim_sample(
        jd, _jax_eps, SHAPE, rng, x_T=jnp.asarray(x_T), log_every=log_every)
    noises, _ = _ddim_draws(rng, 10)
    out, (imgs, x0s) = ddim.ddim_sample(dsched, _torch_eps, _t(x_T),
                                        noises=noises, log_every=log_every)
    assert imgs.shape == x0s.shape == (len(range(0, 10, log_every)), *SHAPE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(ref_imgs), **TOL)
    np.testing.assert_allclose(x0s.numpy(), np.asarray(ref_x0s), **TOL)


@pytest.mark.parametrize("steps", [10, 50])
def test_ddim_invert(steps):
    dsched, jd = _schedules(steps=steps)
    x0 = _randn(7, *SHAPE)
    ref = jddim.ddim_invert(jd, _jax_eps, jnp.asarray(x0))
    out = ddim.ddim_invert(dsched, _torch_eps, _t(x0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_ddim_sample_cfg(scale):
    dsched, jd = _schedules(steps=8, eta=1.0)
    x_T = _randn(8, *SHAPE)
    cond, uncond = _randn(9, 2), np.zeros(2, np.float32)
    rng = jax.random.PRNGKey(10)

    def jax_den(x, t, c):
        return _jax_eps(x + c.reshape(-1, 1, 1, 1), t)

    def torch_den(x, t, c):
        return _torch_eps(x + c.reshape(-1, 1, 1, 1), t)

    ref, _ = jddim.ddim_sample_cfg(jd, jax_den, jnp.asarray(cond),
                                   jnp.asarray(uncond), scale, SHAPE, rng,
                                   x_T=jnp.asarray(x_T))
    noises, _ = _ddim_draws(rng, 8)
    out = ddim.ddim_sample_cfg(dsched, torch_den, _t(cond), _t(uncond), scale,
                               _t(x_T), noises=noises)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("steps", [1, 2, 10])
def test_plms_sample(steps):
    """1 step: the first-order step alone, its second call at t_next 0;
    10: every order of the multistep formula."""
    dsched, jd = _schedules(steps=steps)
    x_T = _randn(11, *SHAPE)
    ref = jax_plms_sample(jd, _jax_eps, SHAPE, jax.random.PRNGKey(0),
                          x_T=jnp.asarray(x_T))
    calls = []

    def counted(x, t):
        calls.append(int(t[0]))
        return _torch_eps(x, t)

    out = plms_sample(dsched, counted, _t(x_T))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    ts = [int(t) for t in dsched.timesteps[::-1]]
    assert calls == [ts[0], (ts[1:] + [0])[0]] + ts[1:]


@pytest.mark.parametrize("clip", [True, False])
def test_p_mean_variance(clip):
    sched, jsched = _schedules()
    x, eps = _randn(12, 4, 8, 8, 3) * 2.0, _randn(13, 4, 8, 8, 3)
    t = np.array([0, 1, 517, 999])
    ref = jddpm.p_mean_variance(jsched, jnp.asarray(eps), jnp.asarray(x),
                                jnp.asarray(t), clip_denoised=clip)
    out = ddpm.p_mean_variance(ddpm.schedule_tables(sched, "cpu"), _t(eps),
                               _t(x), _t(t), clip_denoised=clip)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("log_every_t", [None, 10, 7])
def test_p_sample_loop(log_every_t):
    """50 timesteps; x_T from the key's first split, one noise a step
    (ddpm.py:96-115)."""
    sched, jsched = _schedules(timesteps=50)
    rng = jax.random.PRNGKey(14)
    ref = jax.jit(lambda r: jddpm.p_sample_loop(
        jsched, _jax_eps, SHAPE, r, log_every_t=log_every_t))(rng)
    key, init = jax.random.split(rng)
    x_T, noises = _t(jax.random.normal(init, SHAPE)), []
    for _ in range(50):
        key, nkey = jax.random.split(key)
        noises.append(_t(jax.random.normal(nkey, SHAPE)))
    out = ddpm.p_sample_loop(ddpm.schedule_tables(sched, "cpu"), _torch_eps,
                             x_T, noises=noises, log_every_t=log_every_t)
    if log_every_t is None:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        return
    (img, inter), (ref_img, ref_inter) = out, ref
    assert inter.shape == (len(range(0, 50, log_every_t)), *SHAPE)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), **TOL)
    np.testing.assert_allclose(inter.numpy(), np.asarray(ref_inter), **TOL)
