"""The faces slice's kernels and modules held against the JAX package, on
the CPU.

- The flash kernels' plain versions against the Pallas kernels of
  ``encdiff_tpu/nn/pallas/flash_attention.py`` in interpret mode, as
  ``tests/test_pallas_kernels.py`` runs them: o and lse against
  ``_flash_fwd_impl``, dq, dk, dv (and the port's autograd Function)
  against ``jax.vjp`` of ``flash_attention``. Tolerances are the JAX
  tests' own: 2e-5 forward, 2e-4 gradients.
- The routing: the port's ``CrossAttention`` and VQ ``AttnBlock`` at
  N = 1,024 against the JAX modules under ``ENCDIFF_PALLAS=interpret``
  (2e-5), and which kernel each size reaches.
- Encoder4 at 256 px, the LR rule with accumulation, the seeded fresh init,
  the configuration dicts against the YAML, the face renderer's copy and
  the compact checkpoint of a freshly initialised model.

Inputs are made with numpy from a seed; the JAX side runs on the CPU.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu.data import synthetic_faces as jfaces
from encdiff_tpu.nn import attention as jattn
from encdiff_tpu.nn import encoder4 as jenc
from encdiff_tpu.nn import vae as jvae
from encdiff_tpu.nn.pallas.flash_attention import (_flash_fwd_impl,
                                                   _pad_heads,
                                                   flash_attention as jflash)
from encdiff_tpu.train import loop as jloop
from encdiff_tpu_torch import convert, train_steps
from encdiff_tpu_torch.configs import FACES, FACES_TRAIN, FLAGSHIP_TRAIN
from encdiff_tpu_torch.data import synthetic_faces as tfaces
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.nn import attention as tattn
from encdiff_tpu_torch.nn import vae as tvae
from encdiff_tpu_torch.nn.kernels.flash_attention import (
    flash_attention, flash_attention_dkdv, flash_attention_dq,
    flash_attention_fwd)
from encdiff_tpu_torch.train.loop import (create_train_state,
                                          scaled_learning_rate)
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FACES_YAML = ROOT / "configs/demo/synthetic-faces-encdiff.yaml"
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
MODULE_TOL = dict(rtol=2e-5, atol=2e-5)

#: faces-shaped at a small width: 128 px images on 32x32 latents, so that
#: the UNet's top level (dh 8) and the VQ encoder's mid block (dh 128) reach
#: the flash route
SMALL_FACES = {
    **FACES_TRAIN, "image_size": 32,
    "unet_config": {**FACES["unet_config"], "image_size": 32,
                    "model_channels": 32, "channel_mult": [1, 2],
                    "num_res_blocks": 1, "attention_resolutions": [1],
                    "num_heads": 4},
    "first_stage_config": {
        **FACES["first_stage_config"],
        "ddconfig": {**FACES["first_stage_config"]["ddconfig"],
                     "resolution": 128, "num_res_blocks": 1}},
    "cond_stage_config": {"d": 32, "context_dim": 16, "latent_unit": 20},
}


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _qkv(seed, bh, n, dh):
    """q, k, v, and a cotangent, (1, BH, N, dh) for both packages."""
    return [_randn(seed + i, 1, bh, n, dh) for i in range(4)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- the three flash kernels' plain versions against Pallas --------------

FLASH_CASES = [(256, 128, 64), (1024, 512, 512)]  # N, block_q, block_k


@pytest.mark.parametrize("n,block_q,block_k", FLASH_CASES)
@pytest.mark.parametrize("dh,bh", [(8, 4), (16, 2), (128, 1)])
def test_flash_fwd_matches_pallas(n, block_q, block_k, dh, bh):
    q, k, v, _ = _qkv(10 * dh + n, bh, n, dh)
    scale = dh ** -0.5
    fold = lambda a: _pad_heads(jnp.asarray(a[0]))
    o_ref, lse_ref = _flash_fwd_impl(fold(q), fold(k), fold(v), scale,
                                     block_q, block_k, True)
    o, lse = flash_attention_fwd(_t(q), _t(k), _t(v), scale)
    assert lse.shape == (1, bh, n)
    np.testing.assert_allclose(o[0].numpy(), np.asarray(o_ref)[..., :dh],
                               **FWD_TOL)
    np.testing.assert_allclose(lse[0].numpy(), np.asarray(lse_ref)[..., 0],
                               **FWD_TOL)


@pytest.mark.parametrize("n,block_q,block_k", FLASH_CASES)
@pytest.mark.parametrize("dh,bh", [(8, 4), (16, 2)])
def test_flash_backward_matches_pallas(n, block_q, block_k, dh, bh):
    """dq and dk/dv from the saved lse and delta, and the autograd Function
    as a whole, against ``jax.vjp`` of the Pallas ``flash_attention``."""
    q, k, v, do = _qkv(20 * dh + n, bh, n, dh)
    scale = dh ** -0.5
    _, vjp = jax.vjp(lambda *a: jflash(*a, scale, block_q=block_q,
                                       block_k=block_k, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o, lse = flash_attention_fwd(tq, tk, tv, scale)
    delta = (tdo * o).sum(dim=-1)
    dq = flash_attention_dq(tq, tk, tv, tdo, lse, delta, scale)
    dk, dv = flash_attention_dkdv(tq, tk, tv, tdo, lse, delta, scale)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), ref, **GRAD_TOL)

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    grads = torch.autograd.grad(flash_attention(*leaves, scale), leaves, tdo)
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), ref, **GRAD_TOL)


# ---- routing ---------------------------------------------------------------

@pytest.fixture
def routes(monkeypatch):
    """Which kernel each attention call of the port reaches."""
    seen = []
    for name in ("flash_attention", "attention_core"):
        fn = getattr(tattn, name)

        def record(*args, _name=name, _fn=fn):
            seen.append(_name)
            return _fn(*args)
        monkeypatch.setattr(tattn, name, record)
    return seen


def _init(module, seed, *args, **kw):
    variables = module.init(jax.random.PRNGKey(seed), *args, **kw)
    return jax.tree.map(np.asarray, variables)


@pytest.mark.parametrize("side,route,jax_pallas", [
    (32, "flash_attention", "interpret"), (16, "attention_core", "off")])
def test_cross_attention_routes_as_jax(monkeypatch, routes, side, route,
                                       jax_pallas):
    """Self-attention in the UNet's SpatialTransformer: the flash route at
    N = 1,024 (the JAX flash kernel in interpret mode on the other side),
    attention_core at N = 256 (the JAX einsum path there: its
    attention_core kernel has no interpret mode)."""
    monkeypatch.setenv("ENCDIFF_PALLAS", jax_pallas)
    x = _randn(31, 2, side * side, 32)
    jmod = jattn.CrossAttention(32, None, heads=4, dim_head=8)
    params = _init(jmod, 3, jnp.asarray(x))["params"]
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tattn.CrossAttention(32, None, heads=4, dim_head=8)
    tmod.load_state_dict(convert.flax_to_state_dict(params))
    with torch.no_grad():
        out = tmod(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, **MODULE_TOL)
    assert routes == [route]


def test_vq_attnblock_routes_as_jax(monkeypatch, routes):
    """The VQ mid AttnBlock at 32x32 (N = 1,024, one head of 128): the flash
    forward, against the JAX block in interpret mode."""
    monkeypatch.setenv("ENCDIFF_PALLAS", "interpret")
    x = _randn(32, 1, 32, 32, 128)
    jmod = jvae.AttnBlock(in_channels=128)
    params = _init(jmod, 4, jnp.asarray(x))["params"]
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tvae.AttnBlock(128)
    tmod.load_state_dict(convert.flax_to_state_dict(params))
    with torch.no_grad():
        out = tmod(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert not np.allclose(out, x)
    np.testing.assert_allclose(out, ref, **MODULE_TOL)
    assert routes == ["flash_attention"]


# ---- repairs ---------------------------------------------------------------

def _at_resolution(cfg, res):
    """``cfg`` with its first stage (and so Encoder4) at ``res`` px."""
    fs = cfg["first_stage_config"]
    return {**cfg, "first_stage_config": {
        **fs, "ddconfig": {**fs["ddconfig"], "resolution": res}}}


def test_encoder4_at_256px_matches_jax():
    """LatentDiffusion sizes Encoder4 for the first stage's resolution (a
    16x16xd fc input at 256 px), and on converted weights the port's
    Encoder4 gives the JAX codes and tokens, in eval and in train mode."""
    assert LatentDiffusion(FACES, device="cpu").cond_stage_model.fc \
        .in_features == 16 * 16 * FACES["cond_stage_config"]["d"]
    cond = SMALL_FACES["cond_stage_config"]
    model = LatentDiffusion(_at_resolution(SMALL_FACES, 256), device="cpu")
    assert model.cond_stage_model.fc.in_features == 16 * 16 * cond["d"]

    x = np.tanh(_randn(33, 2, 256, 256, 3))
    jmod = jenc.Encoder4(**cond)
    variables = _init(jmod, 5, jnp.asarray(x))
    params, stats = variables["params"], variables["batch_stats"]
    params = jax.tree.map(lambda a: a + 0.05 * _randn(34, *a.shape), params)
    stats = jax.tree.map(lambda a: np.abs(a) + 0.5, stats)
    tmod = model.cond_stage_model
    tmod.load_state_dict(convert.encoder4_state_dict(params, stats))
    u_ref = jmod.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), method=jmod.encoding)
    tok_ref = jmod.apply({"params": params, "batch_stats": stats}, u_ref,
                         method=jmod.warp)
    x_t = _t(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        u = tmod.eval().encoding(x_t)
        tokens = tmod.warp(u)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(tok_ref).reshape(
        2, -1), rtol=1e-4, atol=1e-4)

    u_train, new = jmod.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=True,
                              method=jmod.encoding, mutable=["batch_stats"])
    with torch.no_grad():
        u = tmod.train().encoding(x_t)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_train), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        tmod.bn2.running_var.numpy(),
        np.asarray(new["batch_stats"]["bn2"]["var"]), rtol=1e-4, atol=1e-6)


def test_lr_rule_with_accumulation():
    assert scaled_learning_rate(2e-6, 8, 4) == pytest.approx(6.4e-5, rel=1e-12)
    assert scaled_learning_rate(2e-6, 128) == pytest.approx(2.56e-4, rel=1e-12)
    for bs, acc in ((8, 4), (128, 1), (2, 2)):
        assert scaled_learning_rate(2e-6, bs, acc) == pytest.approx(
            jloop.scaled_learning_rate(2e-6, bs, 1, acc), rel=1e-12)
    for config, peak in ((SMALL_FACES, 6.4e-5),
                         ({**FLAGSHIP_TRAIN, **SMALL_FACES,
                           "batch_size": 128, "accumulate_grad_batches": 1},
                          2.56e-4)):
        state = create_train_state(LatentDiffusion(config, device="cpu"),
                                   config)
        assert state.accumulate == config["accumulate_grad_batches"]
        assert state.lr_fn(0) == pytest.approx(peak * 1e-6, rel=1e-6)


# ---- the seeded fresh init -------------------------------------------------

def _jax_config(cfg):
    return {"target": "encdiff_tpu.models.latent_diffusion.LatentDiffusion",
            "params": {
                "timesteps": cfg["timesteps"],
                "linear_start": cfg["linear_start"],
                "linear_end": cfg["linear_end"],
                "image_size": cfg["image_size"], "channels": cfg["channels"],
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
                    "params": cfg["cond_stage_config"]}}}


def _port_leaves(model):
    return {**{f"unet.{k}": v for k, v in model.unet.state_dict().items()},
            **{f"cond.{k}": v for k, v in
               model.cond_stage_model.state_dict().items()
               if not k.endswith("num_batches_tracked")},
            **{f"first_stage.{k}": v for k, v in
               model.first_stage_model.state_dict().items()}}


def test_fresh_init_matches_jax_init_variables():
    """Same leaves, shapes and exact-zero leaves as the JAX
    ``init_variables`` after ``convert``; every leaf of more than 1,000
    entries within 10 % of the JAX leaf's standard deviation. The init
    draws from its generator only: the global RNG is untouched, and a seed
    repeats."""
    # the JAX init runs the networks once, op by op: 16 px images and a VQ
    # of two levels keep it quick; the init rules are the same at any size
    res = 16
    fs = SMALL_FACES["first_stage_config"]
    config = {**SMALL_FACES, "image_size": 8,
              "unet_config": {**SMALL_FACES["unet_config"], "image_size": 8},
              "first_stage_config": {**fs, "ddconfig": {
                  **fs["ddconfig"], "resolution": res, "ch_mult": [1, 2]}}}
    jmodel = instantiate_from_config(_jax_config(config))
    jv = jax.tree.map(np.asarray, jmodel.init_variables(
        jax.random.PRNGKey(0), image_resolution=res))
    want = {**{f"unet.{k}": v for k, v in
               convert.flax_to_state_dict(jv["unet"]["params"]).items()},
            **{f"cond.{k}": v for k, v in convert.encoder4_state_dict(
                jv["cond"]["params"], jv["cond"]["batch_stats"]).items()
               if not k.endswith("num_batches_tracked")},
            **{f"first_stage.{k}": v for k, v in
               convert.first_stage_state_dict(
                   jv["first_stage"]["params"]).items()}}

    model = LatentDiffusion(config, device="cpu")
    rng = torch.random.get_rng_state()
    model.init_parameters(torch.Generator().manual_seed(7))
    assert torch.equal(torch.random.get_rng_state(), rng)
    got = _port_leaves(model)

    assert set(got) == set(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    zeros = lambda d: {k for k, v in d.items() if not v.abs().max() > 0}
    assert zeros(got) == zeros(want) and len(zeros(want)) > 10
    big = [k for k, v in want.items() if v.numel() > 1000]
    assert len(big) > 20
    for k in big:
        s_got, s_want = got[k].std().item(), want[k].std().item()
        assert abs(s_got - s_want) <= 0.1 * s_want, (k, s_got, s_want)

    again = LatentDiffusion(config, device="cpu")
    again.init_parameters(torch.Generator().manual_seed(7))
    for k, v in _port_leaves(again).items():
        assert torch.equal(v, got[k]), k


# ---- the configuration, the data and the checkpoint ------------------------

def test_faces_dicts_match_yaml():
    with open(FACES_YAML) as f:
        cfg = yaml.safe_load(f)
    params = cfg["model"]["params"]
    for key in ("timesteps", "loss_type", "scale_by_std", "linear_start",
                "linear_end", "image_size", "channels", "dtype",
                "base_learning_rate"):
        assert FACES_TRAIN[key] == (cfg["model"] if key ==
                                    "base_learning_rate" else params)[key], key
    assert FACES["unet_config"] == params["unet_config"]["params"]
    assert FACES["cond_stage_config"] == params["cond_stage_config"]["params"]
    fs = params["first_stage_config"]["params"]
    for key, val in FACES["first_stage_config"].items():
        assert val == fs[key], key
    assert (FACES_TRAIN["scheduler_config"]
            == params["scheduler_config"]["params"])
    assert FACES_TRAIN["batch_size"] == cfg["data"]["params"]["batch_size"]
    assert (FACES_TRAIN["accumulate_grad_batches"]
            == cfg["lightning"]["trainer"]["accumulate_grad_batches"])
    assert "indep_type" not in FACES_TRAIN and "indep_type" not in params
    assert {k: v for k, v in FACES_TRAIN.items() if k not in (
        "base_learning_rate", "batch_size", "accumulate_grad_batches",
        "seed", "scheduler_config")} == FACES


def test_face_renderer_matches_jax():
    grid = (2, 1, 2, 1, 2, 1, 2)
    np.testing.assert_array_equal(
        tfaces.render_faces(256, factor_sizes=grid),
        jfaces.render_faces(256, factor_sizes=grid))
    np.testing.assert_array_equal(
        tfaces.face_factors(factor_sizes=tfaces.TRAIN_GRID),
        jfaces.face_factors(factor_sizes=tfaces.TRAIN_GRID))
    assert tfaces.FACE_FACTOR_SIZES == jfaces.FACE_FACTOR_SIZES
    assert np.prod(tfaces.TRAIN_GRID) >= 512


def test_fresh_faces_checkpoint_round_trip(tmp_path):
    """A freshly initialised faces-shaped model saved as a compact npz reads
    back through ``LatentDiffusion.from_checkpoint`` (weights at fp16)."""
    model, state, variables = train_steps.fresh_for_training(
        SMALL_FACES, 5, "cpu")
    with torch.no_grad():  # a scale factor and statistics off their init
        state.scale_factor.fill_(1.25)
        model.cond_stage_model.bn1.running_var.fill_(2.0)
    path = str(tmp_path / "faces.npz")
    train_steps.save_checkpoint(path, model, state, variables)
    back = LatentDiffusion.from_checkpoint(path, device="cpu",
                                           config=SMALL_FACES)
    assert back.scale_factor == 1.25
    got, want = _port_leaves(back), _port_leaves(model)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
