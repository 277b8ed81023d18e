"""The faces serving slice held against the JAX package, on the CPU.

- ``fused_attention_plain`` against the Pallas ``fused_attention`` in
  interpret mode and ``reference_attention``, at the JAX tests' two cases
  and a model-shaped one (2e-5, the JAX test's tolerance).
- The route: ``CrossAttention`` with a context under ``no_grad`` reaches
  ``fused_attention``, and with grad ``attention_core``; both match the JAX
  module (``ENCDIFF_PALLAS=off``), the latter with its gradients too.
- The chunked ``swap_sample`` at a small-width, faces-shaped model (64x64
  latents, 256 px, 40 samples: DDIM chunks of 32 and 8, decodes of 32 and
  8) against the JAX ``swap_sample``.

The FID pieces are in ``test_torch_port_faces_fid.py``, the chunks'
injected noise and the serving CLIs in
``test_torch_port_faces_serve_cli.py`` (three files, so that the test
run's workers take them in parallel).

Inputs are made with numpy from a seed; the JAX side runs on the CPU.
Tolerances: modules 2e-5, networks and sampler chains 1e-4 (fp32 sums in
another order, as in ``test_torch_port_slice.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu.evalx import swap as jswap
from encdiff_tpu.nn import attention as jattn
from encdiff_tpu.nn.pallas.attention import (fused_attention as jfused,
                                             reference_attention)
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.configs import FACES
from encdiff_tpu_torch.evalx.swap import swap_sample
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.nn import attention as tattn
from encdiff_tpu_torch.nn.kernels.fused_attention import fused_attention

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)

#: faces-shaped at a small width: 64x64 latents, 256 px, one res block,
#: attention at 16x16 and the mid block only (no 4,096-token attention in
#: the UNet); the VQ decoder's mid block still attends over 4,096 latents
SWAP_FACES = {
    **FACES,
    "unet_config": {**FACES["unet_config"], "model_channels": 32,
                    "channel_mult": [1, 2, 2], "num_res_blocks": 1,
                    "attention_resolutions": [4], "num_heads": 4},
    "first_stage_config": {
        **FACES["first_stage_config"], "n_embed": 64,
        "ddconfig": {**FACES["first_stage_config"]["ddconfig"],
                     "ch_mult": [1, 1, 1], "num_res_blocks": 1}},
    "cond_stage_config": {"d": 32, "context_dim": 16, "latent_unit": 20},
}
#: smaller still for the CLIs: 32x32 latents, 128 px
CLI_FACES = {
    **SWAP_FACES, "image_size": 32,
    "unet_config": {**SWAP_FACES["unet_config"], "image_size": 32,
                    "channel_mult": [1, 2], "attention_resolutions": [2]},
    "first_stage_config": {
        **SWAP_FACES["first_stage_config"],
        "ddconfig": {**SWAP_FACES["first_stage_config"]["ddconfig"],
                     "resolution": 128, "ch_mult": [1, 1, 1]}},
}


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- fused_attention's plain version against Pallas ----------------------

@pytest.mark.parametrize("b,n,m,c,d,heads,dim_head,self_attn", [
    (3, 16, 20, 32, 16, 4, 8, False),     # test_fused_attention_matches_reference
    (2, 64, 64, 32, 32, 4, 8, True),      # test_fused_self_attention
    (2, 256, 20, 64, 16, 8, 8, False)])   # a UNet cross-attention site
def test_fused_attention_plain_matches_pallas(b, n, m, c, d, heads, dim_head,
                                              self_attn):
    inner = heads * dim_head
    x = _randn(0, b, n, c)
    ctx = x if self_attn else _randn(1, b, m, d)
    ws = [_randn(2, c, inner) * 0.1, _randn(3, d, inner) * 0.1,
          _randn(4, d, inner) * 0.1, _randn(5, inner, c) * 0.1,
          _randn(6, c) * 0.1]
    kw = dict(heads=heads, dim_head=dim_head)
    jargs = [jnp.asarray(a) for a in (x, ctx, *ws)]
    pallas = np.asarray(jfused(*jargs, **kw, interpret=True))
    ref = np.asarray(reference_attention(*jargs, **kw))
    out = fused_attention(*(_t(a) for a in (x, ctx, *ws)), **kw).numpy()
    assert out.shape == (b, n, c)
    np.testing.assert_allclose(out, pallas, **KERNEL_TOL)
    np.testing.assert_allclose(out, ref, **KERNEL_TOL)


# ---- the route -------------------------------------------------------------

@pytest.fixture
def routes(monkeypatch):
    """Which kernel each CrossAttention call reaches."""
    seen = []
    for name in ("fused_attention", "attention_core", "flash_attention"):
        fn = getattr(tattn, name)

        def record(*args, _name=name, _fn=fn, **kw):
            seen.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(tattn, name, record)
    return seen


def _cross_attention_pair(monkeypatch):
    monkeypatch.setenv("ENCDIFF_PALLAS", "off")
    x, ctx = _randn(10, 2, 256, 64), _randn(11, 2, 20, 16)
    jmod = jattn.CrossAttention(64, 16, heads=8, dim_head=8)
    shapes = jax.eval_shape(
        lambda k: jmod.init(k, jnp.asarray(x), jnp.asarray(ctx)),
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(12)
    params = jax.tree.map(
        lambda s: (rs.randn(*s.shape) * 0.2).astype(np.float32),
        shapes)["params"]
    tmod = tattn.CrossAttention(64, 16, heads=8, dim_head=8)
    tmod.load_state_dict(convert.flax_to_state_dict(params))
    return jmod, params, tmod, x, ctx


def test_cross_attention_takes_fused_without_grad(monkeypatch, routes):
    jmod, params, tmod, x, ctx = _cross_attention_pair(monkeypatch)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(ctx)))
    with torch.no_grad():
        out = tmod(_t(x), context=_t(ctx)).numpy()
    np.testing.assert_allclose(out, ref, **KERNEL_TOL)
    assert routes == ["fused_attention"]
    # grad mode on, but nothing requires grad: the fused route too
    tmod.requires_grad_(False)
    np.testing.assert_allclose(tmod(_t(x), context=_t(ctx)).numpy(), ref,
                               **KERNEL_TOL)
    # self-attention keeps attention_core even without grad
    with torch.no_grad():
        tmod_self = tattn.CrossAttention(64, None, heads=8, dim_head=8)
        tmod_self(_t(x))
    assert routes == ["fused_attention"] * 2 + ["attention_core"]


def test_cross_attention_with_grad_keeps_attention_core(monkeypatch, routes):
    """Where autograd records, the route and its gradients are those of
    before: attention_core and its backward, against ``jax.vjp`` of the JAX
    module."""
    jmod, params, tmod, x, ctx = _cross_attention_pair(monkeypatch)
    g = _randn(13, 2, 256, 64)
    ref, vjp = jax.vjp(lambda p, a, c: jmod.apply({"params": p}, a, c),
                       params, jnp.asarray(x), jnp.asarray(ctx))
    dparams, dx, dctx = vjp(jnp.asarray(g))
    tx, tctx = _t(x).requires_grad_(), _t(ctx).requires_grad_()
    out = tmod(tx, context=tctx)
    assert routes == ["attention_core"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **KERNEL_TOL)
    out.backward(_t(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), **NET_TOL)
    np.testing.assert_allclose(tctx.grad.numpy(), np.asarray(dctx), **NET_TOL)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, dparams))
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   **NET_TOL, err_msg=name)


def test_fused_attention_refuses_inputs_that_require_grad():
    x, ctx = _t(_randn(14, 1, 4, 8)), _t(_randn(15, 1, 3, 4))
    ws = [_t(_randn(16 + i, *s)) for i, s in enumerate(
        [(8, 8), (4, 8), (4, 8), (8, 8), (8,)])]
    with pytest.raises(ValueError, match="forward only"):
        fused_attention(x.requires_grad_(), ctx, *ws, heads=2, dim_head=4)
    with pytest.raises(ValueError, match="forward only"):
        fused_attention(x.detach(), ctx, *ws[:4], ws[4].requires_grad_(),
                        heads=2, dim_head=4)
    with torch.no_grad():  # no autograd, but the argument still requires it
        with pytest.raises(ValueError, match="forward only"):
            fused_attention(x.detach(), ctx, *ws, heads=2, dim_head=4)


# ---- the chunked swap ------------------------------------------------------

def _jax_ldm(cfg):
    return instantiate_from_config({
        "target": "encdiff_tpu.models.latent_diffusion.LatentDiffusion",
        "params": {
            **{k: cfg[k] for k in ("timesteps", "linear_start", "linear_end",
                                   "image_size", "channels")},
            "cond_stage_trainable": True, "concat_mode": False,
            "conditioning_key": "crossattn",
            "unet_config": {"target": "encdiff_tpu.nn.unet.UNetModel",
                            "params": cfg["unet_config"]},
            "first_stage_config": {
                "target": "encdiff_tpu.models.autoencoder.VQModelInterface",
                "params": {**cfg["first_stage_config"],
                           "lossconfig": {"target": "torch.nn.Identity"}}},
            "cond_stage_config": {
                "target": "encdiff_tpu.nn.encoder4.Encoder4",
                "params": cfg["cond_stage_config"]}}})


def _seeded_variables(jmodel, seed, resolution):
    """The JAX model's variable tree valued from a numpy seed: kernels
    N(0, 1/fan_in), norm scales and BatchNorm variances near 1, the rest
    N(0, 0.1²), so that no zero-initialised output conv hides a path."""
    shapes = jax.eval_shape(
        lambda k: jmodel.init_variables(k, image_resolution=resolution),
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def walk(t, path=()):
        if hasattr(t, "items"):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        noise = rs.randn(*t.shape).astype(np.float32)
        if path[-1] == "kernel":
            return noise / np.sqrt(np.prod(t.shape[:-1]))
        if path[-1] == "scale":
            return 1.0 + 0.1 * noise
        if path[-1] == "var":
            return 1.0 + 0.1 * np.abs(noise)
        return 0.1 * noise
    return {**walk(shapes), "ema": None}


def test_chunked_swap_matches_jax(monkeypatch, routes):
    """40 samples at 64x64 latents: DDIM chunks of 32 and 8 (x_T drawn as
    the JAX chunks draw it, from fold_in(rng, i)), each decoded at 256 px
    in one chunk; every cross-attention call on the fused route. The
    decode quantizes, where a near-tie may flip under another summation
    order, so the latents are compared, the codebook indices on them, and
    the port's decoder on JAX's quantized latents (as the flagship test
    compares its decode)."""
    monkeypatch.setenv("ENCDIFF_PALLAS", "off")
    jmodel = _jax_ldm(SWAP_FACES)
    variables = _seeded_variables(jmodel, 30, 256)
    jmodel.scale_factor = 1.7
    jvars = {k: jax.tree.map(jnp.asarray, v) if v is not None else None
             for k, v in variables.items()}
    tmodel = LatentDiffusion(SWAP_FACES, device="cpu")
    tmodel.load_variables(variables, 1.7)

    seen = {"jax": [], "port": []}
    jdecode, tdecode = jmodel.decode_first_stage, tmodel.decode_first_stage

    def jax_decode(fs_vars, z, **kw):
        seen["jax"].append(np.asarray(z))
        return jdecode(fs_vars, z, **kw)

    def port_decode(z, **kw):
        seen["port"].append(z.numpy().copy())
        return tdecode(z, **kw)
    monkeypatch.setattr(jmodel, "decode_first_stage", jax_decode)
    monkeypatch.setattr(tmodel, "decode_first_stage", port_decode)

    images = np.tanh(_randn(31, 2, 256, 256, 3))
    rng = jax.random.PRNGKey(32)
    ref = np.asarray(jswap.swap_sample(jmodel, jvars, jnp.asarray(images),
                                       rng, ddim_steps=2, eta=0.0))
    x_T = np.concatenate([np.asarray(jax.random.normal(
        jax.random.split(jax.random.fold_in(rng, i))[1], (nb, 64, 64, 3)))
        for i, nb in ((0, 32), (32, 8))])
    out = swap_sample(tmodel, images, ddim_steps=2, eta=0.0, x_T=x_T)
    assert out.shape == ref.shape == (40, 256, 256, 3)
    assert [len(z) for z in seen["jax"]] == [32, 8]
    assert [len(z) for z in seen["port"]] == [32, 8]
    # 4 cross-attention sites (16x16 in, mid, 2x 16x16 out) x 2 steps x 2
    assert routes.count("fused_attention") == 4 * 2 * 2
    assert "flash_attention" in routes  # the VQ decoder's mid block
    for zp, zj in zip(seen["port"], seen["jax"]):
        np.testing.assert_allclose(zp, zj, **NET_TOL)

    zj = np.concatenate(seen["jax"]) / jmodel.scale_factor
    fsm = jmodel.first_stage_model.module
    zq, _, (_, _, idx_ref) = fsm.apply(
        jvars["first_stage"], jnp.asarray(zj),
        method=lambda m, h: m.quantize(h))
    _, _, (_, _, idx) = tmodel.first_stage_model.quantize(
        _t(zj).permute(0, 3, 1, 2).contiguous())
    assert (idx.numpy() == np.asarray(idx_ref)).mean() >= 0.999
    # JAX's output is the decode of its own quantized latents
    img = np.concatenate([
        tdecode(np.asarray(zq)[i:i + 32] * jmodel.scale_factor,
                force_not_quantize=True).numpy() for i in (0, 32)])
    np.testing.assert_allclose(img, ref, **NET_TOL)
    assert np.isfinite(out.numpy()).all()
