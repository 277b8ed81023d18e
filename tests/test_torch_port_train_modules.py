"""The modules of the port's training slice held against the JAX package.

Encoder4 in train mode, the VQ encoder and ``encode``, the DDPM loss, the
independence penalties, the EMA, the LR schedule and AdamW, each fed the
same numpy inputs (and, for networks, the same flax-initialised parameters
converted with ``encdiff_tpu_torch.convert``) in both packages, on the CPU.

Tolerances (relative and absolute, outputs of order one, fp32 on both
sides): 2e-5 for one conv, 1e-5 for Encoder4 (about ten layers) and the
penalties, 1e-4 for the VQ encoder (about thirty layers), 1e-6 for the loss
arithmetic and for AdamW updates, and 1e-7 (one float32 ulp at 1) for the
EMA and the LR schedule, which the port computes with the JAX package's
float32 ops.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch import nn

from encdiff_tpu.core import ema as jema
from encdiff_tpu.core import lr_scheduler as jlr
from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from encdiff_tpu.diffusion import ddpm as jddpm
from encdiff_tpu.losses import indep as jindep
from encdiff_tpu.nn import encoder4 as jenc
from encdiff_tpu.nn import vae as jvae
from encdiff_tpu.train.checkpoint_io import load_model_variables as jax_load
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.configs import FLAGSHIP_TRAIN
from encdiff_tpu_torch.core import ema as tema
from encdiff_tpu_torch.core import lr_scheduler as tlr
from encdiff_tpu_torch.core.schedules import DiffusionSchedule
from encdiff_tpu_torch.diffusion import ddpm as tddpm
from encdiff_tpu_torch.losses import indep as tindep
from encdiff_tpu_torch.models.autoencoder import VQModelInterface
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.nn import encoder4 as tenc
from encdiff_tpu_torch.nn import vae as tvae
from encdiff_tpu_torch.train.loop import build_optimizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP_NPZ = ROOT / "demo_artifacts/round5/v4purify_final_fp16.npz"
FLAGSHIP_YAML = ROOT / "configs/demo/synthetic-shapes-v4-full-encdiff.yaml"
RUN_METADATA = ROOT / "demo_artifacts/round5/v4purify_run/run_metadata.json"
ENC_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _seeded(shapes, seed):
    """Values from a numpy seed for a flax tree of shapes: kernels
    N(0, 1/fan_in), norm scales and BatchNorm variances 1 + N(0, 0.1^2)
    (variances kept above 1), every other leaf N(0, 0.1^2)."""
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
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw),
                            jax.random.PRNGKey(0))
    np_vars = _seeded(shapes, seed)
    return np_vars, jax.tree.map(jnp.asarray, np_vars)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# ---- Encoder4 in train mode ------------------------------------------------

@pytest.mark.parametrize("rule", ["flax", "torch_batchnorm2d"])
def test_encoder4_train_mode_codes_tokens_and_batch_stats(rule):
    """Batch statistics and flax's running-statistics update. With
    ``torch_batchnorm2d`` the BatchNorms are swapped for plain
    ``nn.BatchNorm2d`` (unbiased running variance, momentum 0.1): the codes
    still agree, and the running variances must not."""
    x = np.tanh(_randn(30, 4, 64, 64, 3))
    jmod = jenc.Encoder4(d=32, context_dim=16, latent_unit=20)
    npv, jv = _init(jmod, 30, jnp.asarray(x))
    u_ref, mut = jax.jit(lambda v, a: jmod.apply(
        v, a, train=True, mutable=["batch_stats"],
        method=jenc.Encoder4.encoding))(jv, jnp.asarray(x))
    tok_ref = jmod.apply(jv, u_ref, method=jenc.Encoder4.warp)

    tmod = tenc.Encoder4(d=32, context_dim=16, latent_unit=20)
    tmod.load_state_dict(convert.encoder4_state_dict(npv["params"],
                                                     npv["batch_stats"]))
    if rule == "torch_batchnorm2d":
        for m in tmod.modules():
            if isinstance(m, tenc.BatchNorm):
                m.__class__, m.momentum = nn.BatchNorm2d, 0.1
    tmod.train()
    u = tmod.encoding(_nchw(x))
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(u_ref), **ENC_TOL)
    np.testing.assert_allclose(tmod.warp(u).detach().numpy(),
                               np.asarray(tok_ref), **ENC_TOL)
    new_stats = convert.flax_to_state_dict(mut["batch_stats"])
    state = tmod.state_dict()
    assert {k for k in new_stats} == {
        k for k in state if k.endswith(("running_mean", "running_var"))}
    mismatched = []
    for k in new_stats:
        close = np.allclose(state[k].numpy(), new_stats[k].numpy(), **ENC_TOL)
        if rule == "flax" or k.endswith("running_mean"):
            np.testing.assert_allclose(state[k].numpy(), new_stats[k].numpy(),
                                       err_msg=k, **ENC_TOL)
        elif not close:
            mismatched.append(k)
    if rule == "torch_batchnorm2d":
        # at 4x4 and B = 4 the unbiased variance is 64/63 of the biased one
        assert {"bn5.running_var", "res2.bn.running_var"} <= set(mismatched)


# ---- the VQ encoder --------------------------------------------------------

def test_vq_encoder():
    x = np.tanh(_randn(31, 2, 16, 16, 3))
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, in_channels=3,
              resolution=16, z_channels=3)
    jmod = jvae.Encoder(**kw, double_z=False)
    npv, jv = _init(jmod, 31, jnp.asarray(x))
    tmod = tvae.Encoder(**kw, double_z=False)
    tmod.load_state_dict(convert.flax_to_state_dict(npv["params"]))
    ref = jax.jit(jmod.apply)(jv, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(tmod(_nchw(x))), np.asarray(ref),
                               **NET_TOL)


def test_downsample_pads_bottom_and_right():
    x = _randn(32, 1, 9, 9, 4)
    jmod = jvae.Downsample(True)
    npv, jv = _init(jmod, 32, jnp.asarray(x))
    tmod = tvae.Downsample(4)
    tmod.load_state_dict(convert.flax_to_state_dict(npv["params"]))
    out = tmod(_nchw(x))
    assert out.shape == (1, 4, 4, 4)
    np.testing.assert_allclose(_nhwc(out), np.asarray(jmod.apply(jv, jnp.asarray(x))),
                               rtol=2e-5, atol=2e-5)


def test_first_stage_encode_pre_quant():
    cfg = {"embed_dim": 3, "n_embed": 64, "use_disentangled_concat": True,
           "disentangled_dim": 20,
           "ddconfig": {"double_z": False, "z_channels": 3, "resolution": 16,
                        "in_channels": 3, "out_ch": 3, "ch": 32,
                        "ch_mult": [1, 2], "num_res_blocks": 1,
                        "attn_resolutions": [], "dropout": 0.0}}
    jmodel = instantiate_from_config({
        "target": "encdiff_tpu.models.autoencoder.VQModelInterface",
        "params": {**cfg, "lossconfig": {"target": "torch.nn.Identity"}}})
    shapes = jax.eval_shape(jmodel.init_variables, jax.random.PRNGKey(0))
    npv = _seeded(shapes, 33)
    tmod = VQModelInterface(**cfg)
    tmod.load_state_dict(convert.first_stage_state_dict(npv["params"]))
    x = np.tanh(_randn(34, 2, 16, 16, 3))
    ref = jax.jit(jmodel.encode)(jax.tree.map(jnp.asarray, npv), jnp.asarray(x))
    assert ref.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(_nhwc(tmod.encode(_nchw(x))), np.asarray(ref),
                               **NET_TOL)


def test_flagship_encode_first_stage():
    """The flagship's committed VQ encoder, B = 2, in both packages."""
    from encdiff_tpu_torch.data.synthetic_shapes import render_all_v4
    with open(FLAGSHIP_YAML) as f:
        params = dict(yaml.safe_load(f)["model"]["params"])
    for k in ("eval_name", "scheduler_config"):
        params.pop(k)
    jmodel = instantiate_from_config(
        {"target": "encdiff_tpu.models.latent_diffusion.LatentDiffusion",
         "params": params})
    jvars, _ = jax_load(jmodel, str(FLAGSHIP_NPZ))
    images = render_all_v4(factor_sizes=(2, 2, 2, 2, 2, 2))[[5, 58]]
    x = images.astype(np.float32) / 127.5 - 1.0
    ref = jax.jit(jmodel.encode_first_stage)(jvars["first_stage"],
                                             jnp.asarray(x))
    tmodel = LatentDiffusion.from_checkpoint(str(FLAGSHIP_NPZ), device="cpu")
    z = tmodel.encode_first_stage(x)
    assert z.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref), **NET_TOL)


# ---- losses ----------------------------------------------------------------

@pytest.mark.parametrize("loss_type,elbo", [("l1", 0.0)])
def test_ddpm_losses(loss_type, elbo):
    """With t and the noise given, and a fixed denoiser on both sides, at
    the flagship's loss settings (the port's only ones)."""
    x0, noise = _randn(35, 4, 8, 8, 3), _randn(36, 4, 8, 8, 3)
    t = np.array([0, 17, 500, 999])
    logvar = 0.1 * _randn(37, 1000)
    kw = dict(timesteps=1000, linear_start=0.0015, linear_end=0.0155)
    ref, ref_dict = jddpm.ddpm_losses(
        JaxSchedule.create(**kw),
        lambda x, tt: 0.5 * x + 1e-3 * tt[:, None, None, None],
        jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
        jnp.asarray(logvar), loss_type=loss_type, original_elbo_weight=elbo)
    tables = tddpm.schedule_tables(DiffusionSchedule.create(**kw), "cpu")
    loss, loss_dict = tddpm.ddpm_losses(
        tables, lambda x, tt: 0.5 * x + 1e-3 * tt[:, None, None, None],
        _nchw(x0), torch.from_numpy(t), _nchw(noise), torch.from_numpy(logvar))
    assert set(loss_dict) == set(ref_dict)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6, atol=1e-6)
    for k in ref_dict:
        np.testing.assert_allclose(loss_dict[k].item(), float(ref_dict[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["hsic", "decorr", "hsic+decorr"])
def test_indep_penalty_value_and_gradient(kind):
    u = _randn(38, 16, 20)
    u[:, 3] = 0.7 * u[:, 1] + 0.3 * u[:, 3] ** 2   # some dependence
    val, grad = jax.value_and_grad(
        lambda a: jindep.indep_penalty(kind, a))(jnp.asarray(u))
    tu = torch.from_numpy(u).requires_grad_()
    pen = tindep.indep_penalty(kind, tu)
    (tgrad,) = torch.autograd.grad(pen, tu)
    np.testing.assert_allclose(pen.item(), float(val), **ENC_TOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(grad), **ENC_TOL)


# ---- EMA, LR schedule, AdamW -----------------------------------------------

def test_ema_matches_jax():
    params = {"a": _randn(39, 5, 7), "b": _randn(40, 11)}
    jstate = jema.init(jax.tree.map(jnp.asarray, params))
    tstate = tema.init({k: torch.from_numpy(v) for k, v in params.items()})
    for i in range(3):
        new = {k: v + _randn(41 + i, *v.shape) for k, v in params.items()}
        jstate = jema.update(jstate, jax.tree.map(jnp.asarray, new),
                             decay=0.9999)
        tema.update(tstate, {k: torch.from_numpy(v) for k, v in new.items()},
                    decay=0.9999)
        assert tstate.num_updates == int(jstate.num_updates)
        for k in params:
            np.testing.assert_allclose(tstate.params[k].numpy(),
                                       np.asarray(jstate.params[k]),
                                       rtol=1e-7, atol=1e-7)


def test_lr_schedule_matches_jax():
    sched = FLAGSHIP_TRAIN["scheduler_config"]
    base = 128 * FLAGSHIP_TRAIN["base_learning_rate"]
    jfn = jlr.as_optax_schedule(jlr.LambdaLinearScheduler(**sched), base)
    tfn = tlr.as_lr_schedule(tlr.LambdaLinearScheduler(**sched), base)
    for count in (0, 1, 9_999, 10_000, 1_000_000):
        np.testing.assert_allclose(tfn(count), float(jfn(count)), rtol=1e-7,
                                   atol=0, err_msg=str(count))
        assert (tlr.LambdaLinearScheduler(**sched)(count)
                == jlr.LambdaLinearScheduler(**sched)(count))
    assert tfn(0) == pytest.approx(base * 1e-6, rel=1e-6)


def test_adamw_matches_optax():
    params = {"w": _randn(42, 6, 4), "b": _randn(43, 4)}
    tx = optax.adamw(3e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = build_optimizer(list(tp.values()), 3e-3)
    for i in range(2):
        grads = {k: _randn(44 + i, *v.shape) for k, v in params.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)


# ---- the configuration -----------------------------------------------------

def test_flagship_train_config_matches_yaml_and_run():
    """The YAML's loss and LR fields, and the purification run's overrides
    and batch (``run_metadata.json``)."""
    with open(FLAGSHIP_YAML) as f:
        model = yaml.safe_load(f)["model"]
    with open(RUN_METADATA) as f:
        run = json.load(f)
    params = model["params"]
    assert FLAGSHIP_TRAIN["loss_type"] == params["loss_type"]
    assert FLAGSHIP_TRAIN["scale_by_std"] == params["scale_by_std"]
    assert FLAGSHIP_TRAIN["base_learning_rate"] == model["base_learning_rate"]
    assert (FLAGSHIP_TRAIN["scheduler_config"]
            == params["scheduler_config"]["params"])
    run_params = run["config"]["model"]["params"]
    for key in ("indep_type", "lambda_indep"):
        assert FLAGSHIP_TRAIN[key] == run_params[key] == run[key], key
    assert FLAGSHIP_TRAIN["batch_size"] == run["batch_size"]
    assert FLAGSHIP_TRAIN["seed"] == run["seed"]
    assert run["learning_rate"] == pytest.approx(
        FLAGSHIP_TRAIN["batch_size"] * FLAGSHIP_TRAIN["base_learning_rate"])
