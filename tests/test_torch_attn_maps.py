"""The port's attention-map capture held against the JAX package's, on the
CPU.

``extract_attention_maps``, ``cross_attention_maps_for_images`` and
``ddim_sample_with_attn`` on the small model of ``torch_small_ldm`` (the
same weights in both packages), with the JAX functions' draws injected
into the port. The maps must carry the JAX collection's keys; values are
held to 1e-5 relative and absolute (``TOL``): probabilities of order 0.05
through a network whose outputs agree to about 1e-6 (NET_TOL of
``test_torch_port_slice.py`` is looser, for outputs of order one and
longer chains). The 10-step chain's latents, which reach about 45 through
the random-weight UNet, are held to 1e-5 of their largest magnitude
(``scaled_tol``). Every row of every map sums to 1 within 1e-5 (``ROW_TOL``,
fp32 sums of 20 terms). The captured call's ε equals the uncaptured one's,
and the captured route calls neither ``attention_core_plain`` nor
``fused_attention_plain``: on the card it launches no attention kernel at
attn2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.evalx import attn_maps as jattn_maps
from encdiff_tpu_torch.evalx import attn_maps
from encdiff_tpu_torch.nn.kernels import attention as kattn
from encdiff_tpu_torch.nn.kernels import fused_attention as kfused
from torch_small_ldm import small_ldm_pair
from torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ROW_TOL = 1e-5
#: the small UNet's SpatialTransformer sites (attention at ds 1 and 2)
SITES = ["down_0_0_attn", "down_1_0_attn", "mid_attn", "up_1_0_attn",
         "up_1_1_attn", "up_0_0_attn", "up_0_1_attn"]


@pytest.fixture(scope="module")
def pair():
    return small_ldm_pair(ema=True)


def scaled_tol(ref):
    """1e-5 relative, and 1e-5 of the largest magnitude of ``ref``."""
    return dict(rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _images(seed, n=2):
    return np.random.RandomState(seed).randint(0, 256, (n, 16, 16, 3),
                                               dtype=np.uint8)


def _assert_maps(maps, ref):
    assert sorted(maps) == sorted(ref)
    for k, v in maps.items():
        v = v.numpy() if isinstance(v, torch.Tensor) else v
        np.testing.assert_allclose(v, np.asarray(ref[k]), err_msg=k, **TOL)
        np.testing.assert_allclose(v.sum(-1), 1.0, atol=ROW_TOL, rtol=0)


@pytest.mark.parametrize("use_ema", [False, True])
def test_extract_attention_maps(pair, use_ema):
    jmodel, jvars, tmodel, ema = pair
    x, tokens = _randn(0, 2, 8, 8, 3), _randn(1, 2, 320)
    t = np.array([17, 733])
    ref = jattn_maps.extract_attention_maps(
        jmodel, jvars, jnp.asarray(x), jnp.asarray(t), jnp.asarray(tokens),
        use_ema=use_ema)
    maps = attn_maps.extract_attention_maps(tmodel, x, t, tokens,
                                            ema=ema if use_ema else None)
    assert sorted(maps) == sorted(f"{s}/block_0/attn2/attn" for s in SITES)
    for k, v in maps.items():
        n = 64 if k.startswith(("down_0", "up_0")) else 16
        assert v.shape == (2, 4, n, 20), k
    _assert_maps(maps, ref)


def test_captured_eps_equals_uncaptured_and_runs_no_plain_kernel(
        pair, monkeypatch):
    _, _, tmodel, _ = pair
    x, tokens, t = _randn(2, 2, 8, 8, 3), _randn(3, 2, 320), np.array([5, 900])
    eps = tmodel.apply_model(x, t, tokens)
    plain = {"attention_core": 0, "fused_attention": 0}
    for mod, name in ((kattn, "attention_core_plain"),
                      (kfused, "fused_attention_plain")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=name.rsplit("_", 1)[0], **kw):
            plain[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    eps_c, maps = tmodel.apply_model(x, t, tokens, capture_attn=True)
    np.testing.assert_allclose(eps_c.numpy(), eps.numpy(), **TOL)
    # attn1 alone reaches attention_core's plain version; attn2 nothing
    assert plain == {"attention_core": len(SITES), "fused_attention": 0}
    assert len(maps) == len(SITES)


def test_cross_attention_maps_for_images(pair):
    jmodel, jvars, tmodel, _ = pair
    images = _images(4)
    rng = jax.random.PRNGKey(5)
    ref, ref_tokens, ref_u = jattn_maps.cross_attention_maps_for_images(
        jmodel, jvars, images, t_value=300, rng=rng)
    noise = np.array(jax.random.normal(rng, (2, 8, 8, 3), jnp.float32))
    maps, tokens, u = attn_maps.cross_attention_maps_for_images(
        tmodel, images, t_value=300, noise=noise)
    np.testing.assert_allclose(u.numpy(), np.asarray(ref_u), **TOL)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(ref_tokens), **TOL)
    assert len(maps) == len(SITES)
    _assert_maps(maps, ref)


@pytest.mark.parametrize("eta,use_ema", [(0.0, False), (1.0, True)])
def test_ddim_sample_with_attn(pair, eta, use_ema):
    """JAX: x_T from the key's first split, then one split a step
    (attn_maps.py:95-120)."""
    jmodel, jvars, tmodel, ema = pair
    tokens = _randn(6, 2, 320)
    rng = jax.random.PRNGKey(7)
    ref_img, ref = jattn_maps.ddim_sample_with_attn(
        jmodel, jvars, jnp.asarray(tokens), rng, ddim_steps=10, eta=eta,
        capture_every=4, use_ema=use_ema)
    key, init = jax.random.split(rng)
    x_T, noises = np.array(jax.random.normal(init, (2, 8, 8, 3))), []
    for _ in range(10):
        key, nkey = jax.random.split(key)
        noises.append(np.array(jax.random.normal(nkey, (2, 8, 8, 3))))
    img, maps = attn_maps.ddim_sample_with_attn(
        tmodel, tokens, ddim_steps=10, eta=eta, capture_every=4,
        ema=ema if use_ema else None, x_T=x_T, noises=noises)
    assert sorted(maps) == sorted(ref) and len(maps) == 3
    for t in maps:
        _assert_maps(maps[t], ref[t])
    ref_img = np.asarray(ref_img)
    np.testing.assert_allclose(img.numpy(), ref_img, **scaled_tol(ref_img))
