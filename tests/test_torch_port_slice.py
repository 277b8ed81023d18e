"""The port's serving slice held against the JAX package, on the CPU.

Every module of the slice is built in both packages at a small size
(model_channels 32, channel_mult (1, 2), one res block, 8x8 latents) from
the same flax-initialised parameters, perturbed from a numpy seed so that
no zero-initialised output conv hides a path, converted with
``encdiff_tpu_torch.convert`` and fed the same numpy inputs. The flagship's
committed weights go through both packages once more at full width.

Tolerances: both sides run fp32 on the CPU, with sums taken in another
order by XLA and by PyTorch. One layer agrees to ~1e-6 relative; a whole
network of ~60 layers to ~1e-5, so the single modules are held to 2e-5 and
the networks, the sampler chains and the decoded images to 1e-4 (relative
and absolute, on outputs of order one).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu.core.schedules import DDIMSchedule as JaxDDIMSchedule
from encdiff_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from encdiff_tpu.diffusion.ddim import ddim_sample as jax_ddim_sample
from encdiff_tpu.evalx.swap import swap_sample as jax_swap_sample
from encdiff_tpu.nn import attention as jattn
from encdiff_tpu.nn import encoder4 as jenc
from encdiff_tpu.nn import layers as jlayers
from encdiff_tpu.nn import quantize as jquant
from encdiff_tpu.nn import unet as junet
from encdiff_tpu.nn import vae as jvae
from encdiff_tpu.train.checkpoint_io import load_model_variables as jax_load
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.configs import FLAGSHIP
from encdiff_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule
from encdiff_tpu_torch.diffusion.ddim import ddim_sample
from encdiff_tpu_torch.evalx.swap import swap_sample
from encdiff_tpu_torch.models.autoencoder import VQModelInterface
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.nn import attention as tattn
from encdiff_tpu_torch.nn import encoder4 as tenc
from encdiff_tpu_torch.nn import layers as tlayers
from encdiff_tpu_torch.nn import quantize as tquant
from encdiff_tpu_torch.nn import unet as tunet
from encdiff_tpu_torch.nn import vae as tvae
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP_NPZ = ROOT / "demo_artifacts/round5/v4purify_final_fp16.npz"
FLAGSHIP_YAML = ROOT / "configs/demo/synthetic-shapes-v4-full-encdiff.yaml"
MODULE_TOL = dict(rtol=2e-5, atol=2e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)

SMALL_UNET = dict(image_size=8, in_channels=3, out_channels=3,
                  model_channels=32, attention_resolutions=[1, 2],
                  num_res_blocks=1, channel_mult=[1, 2], num_heads=4,
                  use_scale_shift_norm=True, resblock_updown=True,
                  use_spatial_transformer=True, context_dim=16,
                  latent_unit=20)
SMALL = {
    "timesteps": 1000, "linear_start": 0.0015, "linear_end": 0.0155,
    "image_size": 8, "channels": 3,
    "unet_config": SMALL_UNET,
    "first_stage_config": {
        "embed_dim": 3, "n_embed": 64, "use_disentangled_concat": True,
        "disentangled_dim": 20,
        "ddconfig": {"double_z": False, "z_channels": 3, "resolution": 16,
                     "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                     "num_res_blocks": 1, "attn_resolutions": [],
                     "dropout": 0.0}},
    "cond_stage_config": {"d": 32, "context_dim": 16, "latent_unit": 20},
}


def _frozen(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _jax_ldm_config(cfg):
    """The JAX package's LatentDiffusion config for a port config dict."""
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
                "cond_stage_config": {"target": "encdiff_tpu.nn.encoder4.Encoder4",
                                      "params": cfg["cond_stage_config"]}}}


def _seeded(shapes, seed):
    """Values from a numpy seed for a flax variable tree of shapes (from
    ``jax.eval_shape`` of the module's init): kernels N(0, 1/fan_in), norm
    scales and BatchNorm variances 1 + N(0, 0.1^2) (variances kept above 1),
    every other leaf N(0, 0.1^2), so that no zero-initialised output conv
    hides a path."""
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
    return walk(shapes)


def _init(module, seed, *args, **kw):
    """(variables as numpy, as jax arrays): the tree of ``module.init``,
    valued from a numpy seed."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw),
                            jax.random.PRNGKey(0))
    np_vars = _seeded(shapes, seed)
    return np_vars, jax.tree.map(jnp.asarray, np_vars)


def _model_variables(jmodel, seed):
    """The JAX LatentDiffusion's variable tree, valued from a numpy seed."""
    shapes = jax.eval_shape(
        lambda k: jmodel.init_variables(k, image_resolution=64),
        jax.random.PRNGKey(0))
    return {**_seeded(shapes, seed), "ema": None}


def _run(fn, *args, **kw):
    """``fn(*args, **kw)`` compiled whole by XLA: one compile is quicker on
    the CPU than running a network op by op."""
    return np.asarray(jax.jit(lambda *a: fn(*a, **kw))(*args))


def _torch_module(module, np_params):
    module.load_state_dict(convert.flax_to_state_dict(np_params))
    return module.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---- layers ---------------------------------------------------------------

@pytest.mark.parametrize("kernel,stride,padding", [
    (3, 1, 1), (4, 2, 1), (1, 1, 0), (3, 2, ((0, 1), (0, 1)))])
def test_torch_conv(kernel, stride, padding):
    x = _randn(0, 2, 9, 9, 5)
    jmod = jlayers.TorchConv(7, kernel, stride=stride, padding=padding)
    npv, jv = _init(jmod, 0, jnp.asarray(x))
    tmod = _torch_module(tlayers.TorchConv(5, 7, kernel, stride, padding),
                         npv["params"])
    np.testing.assert_allclose(_nhwc(tmod(_nchw(x))),
                               np.asarray(jmod.apply(jv, jnp.asarray(x))),
                               **MODULE_TOL)


@pytest.mark.parametrize("film,eps", [(False, 1e-5), (True, 1e-5), (False, 1e-6)])
def test_gnsilu(film, eps):
    x = _randn(1, 2, 8, 8, 64)
    sc = _randn(2, 2, 64) * 0.2 if film else None
    sh = _randn(3, 2, 64) * 0.2 if film else None
    jmod = jlayers.GNSiLU(32, epsilon=eps)
    j = lambda a: None if a is None else jnp.asarray(a)
    npv, jv = _init(jmod, 1, j(x), j(sc), j(sh))
    tmod = _torch_module(tlayers.GNSiLU(64, eps=eps), npv["params"])
    t = lambda a: None if a is None else torch.from_numpy(a)
    np.testing.assert_allclose(_nhwc(tmod(_nchw(x), t(sc), t(sh))),
                               np.asarray(jmod.apply(jv, j(x), j(sc), j(sh))),
                               **MODULE_TOL)


def test_timestep_embedding():
    t = np.array([0, 7, 999])
    np.testing.assert_allclose(
        tlayers.timestep_embedding(torch.from_numpy(t), 64).numpy(),
        np.asarray(jlayers.timestep_embedding(jnp.asarray(t), 64)),
        **MODULE_TOL)


def test_spatial_transformer():
    x, ctx = _randn(4, 2, 8, 8, 64), _randn(5, 2, 20, 16)
    jmod = jattn.SpatialTransformer(64, 4, 16, context_dim=16)
    npv, jv = _init(jmod, 4, jnp.asarray(x), context=jnp.asarray(ctx))
    tmod = _torch_module(tattn.SpatialTransformer(64, 4, 16, context_dim=16),
                         npv["params"])
    out = tmod(_nchw(x), torch.from_numpy(ctx))
    ref = _run(jmod.apply, jv, jnp.asarray(x), context=jnp.asarray(ctx))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **MODULE_TOL)


@pytest.mark.parametrize("cin,cout,mode", [
    (64, 64, None), (32, 64, None), (64, 64, "down"), (64, 64, "up")])
def test_resblock(cin, cout, mode):
    x, emb = _randn(6, 2, 8, 8, cin), _randn(7, 2, 128)
    kw = {"up": mode == "up", "down": mode == "down"}
    jmod = junet.ResBlock(cin, 128, out_channels=cout, **kw)
    npv, jv = _init(jmod, 6, jnp.asarray(x), jnp.asarray(emb))
    tmod = _torch_module(tunet.ResBlock(cin, 128, cout, **kw), npv["params"])
    out = tmod(_nchw(x), torch.from_numpy(emb))
    ref = jmod.apply(jv, jnp.asarray(x), jnp.asarray(emb))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **MODULE_TOL)


# ---- networks -------------------------------------------------------------

@pytest.fixture(scope="module")
def small_unet():
    jmod = junet.UNetModel(**_frozen(SMALL_UNET))
    x, ctx = jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 320))
    npv, jv = _init(jmod, 8, x, jnp.zeros((1,), jnp.int32), ctx)
    tmod = _torch_module(tunet.UNetModel(**SMALL_UNET), npv["params"])
    return jmod, jv, tmod


def test_unet_eps(small_unet):
    jmod, jv, tmod = small_unet
    x, ctx = _randn(9, 3, 8, 8, 3), _randn(10, 3, 320)
    t = np.array([0, 421, 999])
    out = tmod(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    ref = _run(jmod.apply, jv, jnp.asarray(x), jnp.asarray(t),
               jnp.asarray(ctx))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **NET_TOL)


def test_encoder4_codes_and_tokens():
    x = np.tanh(_randn(11, 2, 64, 64, 3))
    jmod = jenc.Encoder4(d=32, context_dim=16, latent_unit=20)
    npv, jv = _init(jmod, 11, jnp.asarray(x))
    tmod = tenc.Encoder4(d=32, context_dim=16, latent_unit=20)
    tmod.load_state_dict(convert.encoder4_state_dict(npv["params"],
                                                     npv["batch_stats"]))
    tmod.eval()
    u = tmod.encoding(_nchw(x))
    u_ref = _run(jmod.apply, jv, jnp.asarray(x), method=jenc.Encoder4.encoding)
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(u_ref), **NET_TOL)
    tok_ref = jmod.apply(jv, u_ref, method=jenc.Encoder4.warp)
    np.testing.assert_allclose(tmod.warp(torch.tensor(u_ref))
                               .detach().numpy(), np.asarray(tok_ref),
                               **MODULE_TOL)


def test_vq_decoder():
    z = _randn(12, 2, 8, 8, 3)
    kw = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
              resolution=16, z_channels=3)
    jmod = jvae.Decoder(in_channels=3, **kw)
    npv, jv = _init(jmod, 12, jnp.asarray(z))
    tmod = _torch_module(tvae.Decoder(**kw), npv["params"])
    np.testing.assert_allclose(_nhwc(tmod(_nchw(z))),
                               _run(jmod.apply, jv, jnp.asarray(z)),
                               **NET_TOL)


def test_quantize_indices():
    z = _randn(13, 4, 8, 8, 3) * 0.5
    jmod = jquant.VectorQuantizer(64, 3)
    npv, jv = _init(jmod, 13, jnp.asarray(z))
    tmod = _torch_module(tquant.VectorQuantizer(64, 3), npv["params"])
    zq, _, (_, _, idx) = tmod(_nchw(z))
    zq_ref, _, (_, _, idx_ref) = jmod.apply(jv, jnp.asarray(z))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(_nhwc(zq), np.asarray(zq_ref), **MODULE_TOL)


@pytest.mark.parametrize("quantize,with_repr", [(True, False), (False, True)])
def test_first_stage_decode(quantize, with_repr):
    fs = SMALL["first_stage_config"]
    jmodel = instantiate_from_config(
        _jax_ldm_config(SMALL)["params"]["first_stage_config"])
    shapes = jax.eval_shape(jmodel.init_variables, jax.random.PRNGKey(0))
    npv = _seeded(shapes, 14)
    jv = jax.tree.map(jnp.asarray, npv)
    tmod = VQModelInterface(**fs)
    tmod.load_state_dict(convert.first_stage_state_dict(npv["params"]))
    tmod.eval()
    h = _randn(15, 2, 8, 8, 3) * 0.3
    rep = _randn(16, 2, 20) if with_repr else None
    out = tmod.decode(_nchw(h), force_not_quantize=not quantize,
                      disentangled_repr=None if rep is None
                      else torch.from_numpy(rep))
    ref = _run(jmodel.decode, jv, jnp.asarray(h),
               force_not_quantize=not quantize,
               disentangled_repr=None if rep is None else jnp.asarray(rep))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **NET_TOL)


def test_schedule_copy_matches():
    kw = dict(timesteps=1000, linear_start=0.0015, linear_end=0.0155)
    ours, theirs = DiffusionSchedule.create(**kw), JaxSchedule.create(**kw)
    for f in ("betas", "alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    d1, d2 = DDIMSchedule.create(ours, 50, 1.0), JaxDDIMSchedule.create(theirs, 50, 1.0)
    for f in ("timesteps", "alphas", "alphas_prev", "sigmas"):
        np.testing.assert_array_equal(getattr(d1, f), getattr(d2, f))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_chain(small_unet, eta):
    """eta 0 from an injected x_T; eta 1 also feeds the port the per-step
    noise the JAX sampler draws (its key splits at ddim.py:63)."""
    jmod, jv, tmod = small_unet
    steps, shape = 4, (2, 8, 8, 3)
    x_T, ctx = _randn(17, *shape), _randn(18, 2, 320)
    sched = DiffusionSchedule.create(linear_start=0.0015, linear_end=0.0155)
    dsched = DDIMSchedule.create(sched, steps, eta=eta)
    jd = JaxDDIMSchedule.create(
        JaxSchedule.create(linear_start=0.0015, linear_end=0.0155), steps,
        eta=eta)
    rng = jax.random.PRNGKey(19)
    ref, _ = jax_ddim_sample(
        jd, lambda x, t: jmod.apply(jv, x, t, jnp.asarray(ctx)), shape, rng,
        x_T=jnp.asarray(x_T))
    noises, key = [], rng
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noises.append(_nchw(np.asarray(jax.random.normal(nkey, shape))))
    out = ddim_sample(dsched, lambda x, t: tmod(x, t, torch.from_numpy(ctx)),
                      _nchw(x_T), noises=noises)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **NET_TOL)


@pytest.fixture(scope="module")
def small_models():
    jmodel = instantiate_from_config(_jax_ldm_config(SMALL))
    variables = _model_variables(jmodel, 20)
    jmodel.scale_factor = 1.7
    jvars = {k: jax.tree.map(jnp.asarray, v) if v is not None else None
             for k, v in variables.items()}
    tmodel = LatentDiffusion(SMALL, device="cpu")
    tmodel.load_variables(variables, 1.7)
    return jmodel, jvars, tmodel


def test_swap_sample(small_models):
    """The whole slice: Encoder4, the 20-factor fold, DDIM and the decode."""
    jmodel, jvars, tmodel = small_models
    images = np.tanh(_randn(21, 2, 64, 64, 3))
    rng = jax.random.PRNGKey(22)
    ref = jax_swap_sample(jmodel, jvars, jnp.asarray(images), rng,
                          ddim_steps=4, eta=0.0)
    # the JAX sampler draws x_T from the first split of its key (ddim.py:50)
    x_T = jax.random.normal(jax.random.split(rng)[1], (40, 8, 8, 3))
    out = swap_sample(tmodel, images, ddim_steps=4, eta=0.0,
                      x_T=np.asarray(x_T))
    assert out.shape == (40, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **NET_TOL)


# ---- the flagship's weights -----------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    with open(FLAGSHIP_YAML) as f:
        params = dict(yaml.safe_load(f)["model"]["params"])
    for k in ("eval_name", "scheduler_config"):
        params.pop(k)
    jmodel = instantiate_from_config(
        {"target": "encdiff_tpu.models.latent_diffusion.LatentDiffusion",
         "params": params})
    jvars, sf = jax_load(jmodel, str(FLAGSHIP_NPZ))
    jmodel.scale_factor = sf
    tmodel = LatentDiffusion.from_checkpoint(str(FLAGSHIP_NPZ), device="cpu")
    return jmodel, jvars, tmodel


def test_flagship_weights_encoder4_unet_and_decode(flagship):
    from encdiff_tpu_torch.data.synthetic_shapes import render_all_v4
    jmodel, jvars, tmodel = flagship
    assert tmodel.scale_factor == pytest.approx(jmodel.scale_factor)
    images = render_all_v4(factor_sizes=(2, 2, 2, 2, 2, 2))[[0, 21, 42, 63]]
    images = images.astype(np.float32) / 127.5 - 1.0
    cond = {"params": jvars["cond"]["params"],
            "batch_stats": jvars["cond"]["batch_stats"]}
    u_ref = _run(jmodel.cond_encoding, cond, jnp.asarray(images))
    np.testing.assert_allclose(tmodel.cond_encoding(images).numpy(),
                               np.asarray(u_ref), **NET_TOL)

    x, t = _randn(23, 2, 16, 16, 3), np.array([517, 517])
    tokens = np.asarray(jmodel.cond_warp(cond, u_ref[:2]))
    eps_ref = _run(jmodel.apply_model, jvars["unet"], jnp.asarray(x),
                   jnp.asarray(t), jnp.asarray(tokens))
    np.testing.assert_allclose(tmodel.apply_model(x, t, tokens).numpy(),
                               np.asarray(eps_ref), **NET_TOL)

    # quantize indices agree; the decode is compared on JAX's quantized
    # latent, since a near-tie may flip under another summation order
    z = _randn(24, 2, 16, 16, 3) * 1.5
    fsm = jmodel.first_stage_model.module
    zq, _, (_, _, idx_ref) = fsm.apply(
        jvars["first_stage"], jnp.asarray(z / jmodel.scale_factor),
        method=lambda m, h: m.quantize(h))
    _, _, (_, _, idx) = tmodel.first_stage_model.quantize(
        _nchw(z / tmodel.scale_factor))
    assert (idx.numpy() == np.asarray(idx_ref)).mean() >= 0.99
    zq_scaled = np.asarray(zq) * jmodel.scale_factor
    img_ref = _run(jmodel.decode_first_stage, jvars["first_stage"],
                   jnp.asarray(zq_scaled), force_not_quantize=True)
    img = tmodel.decode_first_stage(zq_scaled, force_not_quantize=True)
    assert img.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_ref), **NET_TOL)


# ---- the port's own rules -------------------------------------------------

def test_flagship_dict_matches_yaml():
    with open(FLAGSHIP_YAML) as f:
        params = yaml.safe_load(f)["model"]["params"]
    for key in ("timesteps", "linear_start", "linear_end", "image_size",
                "channels"):
        assert FLAGSHIP[key] == params[key], key
    assert FLAGSHIP["unet_config"] == params["unet_config"]["params"]
    assert FLAGSHIP["cond_stage_config"] == params["cond_stage_config"]["params"]
    fs = params["first_stage_config"]["params"]
    for key, val in FLAGSHIP["first_stage_config"].items():
        assert val == fs[key], key


BANNED = ("jax", "flax", "optax", "orbax", "encdiff_tpu", "yaml", "omegaconf",
          "PIL", "sklearn", "torch.utils.cpp_extension")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_port_imports_only_torch_numpy_and_stdlib():
    files = sorted((ROOT / "encdiff_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    subpackages = {p.parent.name for p in files}
    assert {"core", "data", "diffusion", "evalx", "kernels", "losses",
            "models", "nn", "train"} <= subpackages, subpackages
    assert ROOT / "encdiff_tpu_torch" / "train_steps.py" in files
    for path in files:
        for name in _imports(path):
            for banned in BANNED:
                assert not (name == banned or name.startswith(banned + ".")), \
                    f"{path.relative_to(ROOT)} imports {name}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LatentDiffusion(SMALL)
    with pytest.raises(RuntimeError, match="cuda"):
        LatentDiffusion.from_checkpoint(str(FLAGSHIP_NPZ))


def test_generate_swap_cli(tmp_path):
    """The CLI end to end on the flagship's weights, at one input and two
    DDIM steps."""
    from encdiff_tpu_torch import generate_swap
    generate_swap.main(["-r", str(FLAGSHIP_NPZ), "--num_samples", "1",
                        "--ddim_steps", "2", "--device", "cpu",
                        "--out", str(tmp_path)])
    grid = np.load(tmp_path / "swap_full_grid.npy")
    assert grid.shape == (21, 64, 64, 3)
    assert np.isfinite(grid).all()
    assert (tmp_path / "factor_correspondence.json").exists()


def test_kernel_inputs_keep_the_kernels_layout(small_models, monkeypatch):
    """The CUDA kernels take contiguous NCHW (groupnorm_silu) and rows with
    a contiguous last dimension (attention_core); along the whole serving
    path the modules hand them nothing else (the CPU cannot run the
    kernels, so this checks what reaches them)."""
    from encdiff_tpu_torch.nn.kernels import attention as kattn
    from encdiff_tpu_torch.nn.kernels import groupnorm_silu as kgn
    seen = []

    def gn(x, gamma, beta, scale=None, shift=None, **kw):
        seen.append(("gn", all(t is None or t.is_contiguous()
                               for t in (x, scale, shift))))
        return kgn.groupnorm_silu_plain(x, gamma, beta, scale, shift, **kw)

    def attn(q, k, v, scale):
        seen.append(("attn", all(t.stride(3) == 1 for t in (q, k, v))))
        return kattn.attention_core_plain(q, k, v, scale)

    monkeypatch.setattr(tlayers, "groupnorm_silu", gn)
    # the VQ AttnBlock reaches attention_core through nn.attention.attention
    monkeypatch.setattr(tattn, "attention_core", attn)
    _, _, tmodel = small_models
    swap_sample(tmodel, np.tanh(_randn(26, 1, 64, 64, 3)), ddim_steps=1,
                eta=0.0)
    assert {k for k, _ in seen} == {"gn", "attn"}
    assert all(ok for _, ok in seen), [k for k, ok in seen if not ok]
