"""The port's whole train step held against the JAX ``build_train_step``.

At a small width (UNet model_channels 32, channel_mult (1, 2), one res
block, 4 heads; VQ ch 32; Encoder4 d 32 on 16 px images; 8x8 latents;
B = 8) both packages start from the same flax-initialised parameters,
converted with ``encdiff_tpu_torch.convert``, and take two steps on the
same uint8 batch with the t and the noise the JAX step draws from its key
(``models/latent_diffusion.py:loss_fn``): one step from global step 0,
where scale_by_std sets the scale factor, and one resumed at step 5, which
keeps it. The LR schedule starts at half its peak (1e-3) so that AdamW's
update is visible against the tolerance.

Tolerance: 1e-4 relative on the loss, the gradient norm, the scale factor
and the batch statistics (the HSIC term, near 0 by cancellation, to 1e-4 of
the loss); 1e-4 relative L2 per leaf on the gradients, the updated
parameters, the update itself and the EMA. Leaves whose exact gradient is
zero (biases that feed a normalisation) and elements whose gradient is
within rounding of zero are checked apart (``_split_leaves``): their sign,
and so the sign of Adam's first step on them, is rounding noise.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.core import ema as jema
from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu.train import loop as jloop
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.core.compact_ckpt import load_compact
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.nn import attention as tattn
from encdiff_tpu_torch.nn.kernels import attention as kattn
from encdiff_tpu_torch.nn.kernels import groupnorm_silu as kgn
from encdiff_tpu_torch.train.loop import (create_train_state,
                                          trainable_parameters, train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP_NPZ = ROOT / "demo_artifacts/round5/v4purify_final_fp16.npz"
REL = 1e-4
B = 8

SMALL_UNET = dict(image_size=8, in_channels=3, out_channels=3,
                  model_channels=32, attention_resolutions=[1, 2],
                  num_res_blocks=1, channel_mult=[1, 2], num_heads=4,
                  use_scale_shift_norm=True, resblock_updown=True,
                  use_spatial_transformer=True, context_dim=16,
                  latent_unit=20)
FIRST_STAGE = {
    "embed_dim": 3, "n_embed": 64, "use_disentangled_concat": True,
    "disentangled_dim": 20,
    "ddconfig": {"double_z": False, "z_channels": 3, "resolution": 16,
                 "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                 "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0}}
COND = {"d": 32, "context_dim": 16, "latent_unit": 20}
SCHEDULER = {"warm_up_steps": [10], "cycle_lengths": [10000000000000],
             "f_start": [0.5], "f_max": [1.0], "f_min": [1.0]}
LOSS = {"loss_type": "l1", "scale_by_std": True, "indep_type": "hsic",
        "lambda_indep": 2.0}
SMALL_TRAIN = {
    "timesteps": 1000, "linear_start": 0.0015, "linear_end": 0.0155,
    "image_size": 8, "channels": 3, **LOSS,
    "unet_config": SMALL_UNET, "first_stage_config": FIRST_STAGE,
    "cond_stage_config": {**COND, "image_size": 16},
    "base_learning_rate": 2e-3 / B, "batch_size": B,
    "scheduler_config": SCHEDULER,
}
JAX_CONFIG = {
    "target": "encdiff_tpu.models.latent_diffusion.LatentDiffusion",
    "params": {
        "timesteps": 1000, "linear_start": 0.0015, "linear_end": 0.0155,
        "image_size": 8, "channels": 3, **LOSS,
        "cond_stage_trainable": True, "concat_mode": False,
        "conditioning_key": "crossattn", "use_ema": True,
        "scheduler_config": {
            "target": "encdiff_tpu.core.lr_scheduler.LambdaLinearScheduler",
            "params": SCHEDULER},
        "unet_config": {"target": "encdiff_tpu.nn.unet.UNetModel",
                        "params": SMALL_UNET},
        "first_stage_config": {
            "target": "encdiff_tpu.models.autoencoder.VQModelInterface",
            "params": {**FIRST_STAGE,
                       "lossconfig": {"target": "torch.nn.Identity"}}},
        "cond_stage_config": {"target": "encdiff_tpu.nn.encoder4.Encoder4",
                              "params": COND}}}


def _seeded(shapes, seed):
    """Values from a numpy seed for a flax tree of shapes: kernels
    N(0, 1/fan_in), norm scales and BatchNorm variances 1 + N(0, 0.1^2)
    (variances kept above 1), every other leaf N(0, 0.1^2), so that no
    zero-initialised output conv hides a path."""
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


def _batch(seed):
    return np.random.RandomState(seed).randint(0, 256, (B, 16, 16, 3),
                                               dtype=np.uint8)


def _t_and_noise(rng):
    """What the JAX loss_fn draws from its key."""
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_rng, (B,), 0, 1000)
    return np.asarray(t), np.asarray(jax.random.normal(n_rng, (B, 8, 8, 3)))


def _torch_tree(tree):
    """A JAX {unet, cond} tree as the port's trainable-parameter names."""
    out = {f"unet.{k}": v for k, v in
           convert.flax_to_state_dict(jax.device_get(tree["unet"])).items()}
    out.update({f"cond.{k}": v for k, v in convert.encoder4_state_dict(
        jax.device_get(tree["cond"]), {}).items()})
    return out


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_leaves(got: dict, want: dict, tol: float, what: str):
    assert set(got) == set(want), what
    worst = max((_rel_l2(got[k], want[k]), k) for k in want)
    assert worst[0] <= tol, f"{what}: {worst[1]} off by {worst[0]:.2e}"


def _snapshot(tmodel):
    return {k: p.detach().clone().numpy()
            for k, p in trainable_parameters(tmodel).items()}


def _batch_stats(tmodel):
    return {k: v.numpy().copy() for k, v in
            tmodel.cond_stage_model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


#: the two runs: from global step 0 (scale_by_std sets the factor) and
#: resumed at step 5 with a factor of 1.7 (kept), each with a fresh optimizer
RUNS = {"step0": (0, 1.0, 61), "resumed": (5, 1.7, 62)}


@pytest.fixture(scope="module")
def steps():
    """One step of each run in both packages from the same parameters: the
    JAX states before and after, its metrics and gradients, and the port's
    snapshots."""
    jmodel = instantiate_from_config(JAX_CONFIG)
    shapes = jax.eval_shape(
        lambda k: jmodel.init_variables(k, image_resolution=16),
        jax.random.PRNGKey(0))
    variables = _seeded(shapes, 60)
    params = jax.tree.map(jnp.asarray, {"unet": variables["unet"]["params"],
                                        "cond": variables["cond"]["params"]})
    stats = jax.tree.map(jnp.asarray, variables["cond"]["batch_stats"])
    tx = jloop.build_optimizer(jmodel, SMALL_TRAIN["base_learning_rate"] * B)
    frozen = {"first_stage": jax.tree.map(jnp.asarray,
                                          variables["first_stage"])}
    step_fn = jloop.build_train_step(jmodel, tx, donate=False)

    def loss(p, bs, sf, batch, rng):
        frozen_in = {"first_stage": frozen["first_stage"],
                     "cond_batch_stats": bs}
        return jmodel.loss_fn(p, frozen_in, batch, rng, sf, train=True)[0]
    grad_fn = jax.jit(jax.grad(loss))

    out = {}
    for name, (step, sf, seed) in RUNS.items():
        rng, batch = jax.random.PRNGKey(seed), _batch(seed)
        jstate = jloop.TrainState(
            step=jnp.asarray(step, jnp.int32), params=params,
            batch_stats=stats, opt_state=tx.init(params),
            ema=jema.init(params["unet"]),
            scale_factor=jnp.asarray(sf, jnp.float32))
        new, jm = step_fn(jstate, frozen, jnp.asarray(batch), rng)
        grads = grad_fn(params, stats, new.scale_factor, jnp.asarray(batch),
                        rng)

        tmodel = LatentDiffusion(SMALL_TRAIN, device="cpu")
        tmodel.load_variables({**variables, "ema": None}, sf, use_ema=False)
        state = create_train_state(tmodel, SMALL_TRAIN, step=step)
        t, noise = _t_and_noise(rng)
        m = train_step(tmodel, state, batch, t=t, noise=noise)
        out[name] = dict(
            jax_before=_torch_tree(params), jax_after=new,
            jax_metrics=jax.device_get(jm), jax_grads=_torch_tree(grads),
            port={"metrics": {k: float(v) for k, v in m.items()},
                  "grads": {k: p.grad.numpy().copy() for k, p in
                            trainable_parameters(tmodel).items()},
                  "params": _snapshot(tmodel),
                  "ema": {k: v.numpy().copy()
                          for k, v in state.ema.params.items()},
                  "stats": _batch_stats(tmodel),
                  "scale_factor": float(state.scale_factor),
                  "step": state.step, "updates": state.updates})
    return out


def _split_leaves(grads: dict):
    """(leaves whose gradient is zero up to rounding, {leaf: mask of the
    elements whose gradient sign is above rounding}). A bias that feeds a
    normalisation (a conv before BatchNorm, or before a GroupNorm of one
    channel per group) has a zero gradient in exact arithmetic; its rounding
    noise differs between the packages, and so does the sign of Adam's
    first step, ±lr, on it and on any element whose gradient is within
    rounding of zero."""
    total = np.sqrt(sum(np.sum(np.square(v.numpy(), dtype=np.float64))
                        for v in grads.values()))
    zero, masks = set(), {}
    for k, v in grads.items():
        g = v.numpy()
        if np.linalg.norm(g) <= 1e-6 * total:
            zero.add(k)
        else:
            masks[k] = np.abs(g) >= 1e-3 * np.sqrt(np.mean(np.square(g)))
    return zero, masks, total


@pytest.mark.parametrize("run", list(RUNS))
def test_loss_grad_norm_and_scale_factor(steps, run):
    r = steps[run]
    port, jm = r["port"], r["jax_metrics"]
    for k in ("train/loss", "train/loss_simple", "grad_norm"):
        np.testing.assert_allclose(port["metrics"][k], float(jm[k]), rtol=REL,
                                   err_msg=k)
    # the unbiased HSIC is a difference of large terms, near 0 here: held
    # to 1e-4 of the loss it enters
    np.testing.assert_allclose(port["metrics"]["train/loss_indep"],
                               float(jm["train/loss_indep"]), rtol=REL,
                               atol=REL * float(jm["train/loss"]))
    sf = float(r["jax_after"].scale_factor)
    np.testing.assert_allclose(port["scale_factor"], sf, rtol=REL)
    step, given, _ = RUNS[run]
    if step == 0:   # scale_by_std at step 0 sets the factor...
        assert abs(sf - given) > 0.01
    else:           # ...and a later step keeps the state's
        assert port["scale_factor"] == np.float32(given) == sf
    assert (port["step"], port["updates"]) == (step + 1, 1)
    assert port["metrics"]["lr"] == pytest.approx(
        0.5 * B * SMALL_TRAIN["base_learning_rate"], rel=1e-6)


@pytest.mark.parametrize("run", list(RUNS))
def test_gradients_of_every_leaf(steps, run):
    r = steps[run]
    got, want = r["port"]["grads"], r["jax_grads"]
    zero, masks, total = _split_leaves(want)
    assert set(got) == set(want)
    assert len(masks) > 10 * len(zero)
    _assert_leaves({k: got[k] for k in masks},
                   {k: want[k] for k in masks}, REL, "gradients")
    for k in zero:
        assert np.linalg.norm(got[k] - want[k].numpy()) <= 1e-6 * total, k


@pytest.mark.parametrize("run", list(RUNS))
def test_params_ema_and_batch_stats_after_the_step(steps, run):
    r = steps[run]
    port = r["port"]
    zero, masks, _ = _split_leaves(r["jax_grads"])
    kept = sum(m.sum() for m in masks.values())
    assert kept >= 0.95 * sum(m.size for m in masks.values())
    lr = port["metrics"]["lr"]
    after = _torch_tree(r["jax_after"].params)
    before = r["jax_before"]
    ema = {f"unet.{k}": v for k, v in convert.flax_to_state_dict(
        jax.device_get(r["jax_after"].ema.params)).items()}
    port_ema = {f"unet.{k}": v for k, v in port["ema"].items()}
    pick = lambda d, f=lambda a: a: {k: f(np.asarray(d[k]))[masks[k]]
                                     for k in masks if k in d}
    _assert_leaves(pick(port["params"]), pick(after), REL, "parameters")
    _assert_leaves({k: port["params"][k][m] - before[k].numpy()[m]
                    for k, m in masks.items()},
                   {k: after[k].numpy()[m] - before[k].numpy()[m]
                    for k, m in masks.items()}, REL, "AdamW update")
    _assert_leaves(pick(port_ema), pick(ema), REL, "EMA")
    for k in zero:  # Adam's first step is at most lr (plus the decay)
        for p in (port["params"][k], after[k].numpy()):
            assert np.abs(p - before[k].numpy()).max() <= 1.01 * lr, k
    stats = convert.flax_to_state_dict(
        jax.device_get(r["jax_after"].batch_stats))
    assert set(port["stats"]) == set(stats)
    for k in stats:
        np.testing.assert_allclose(port["stats"][k], stats[k].numpy(),
                                   rtol=REL, atol=1e-6, err_msg=k)


def test_backward_kernels_get_their_layout(monkeypatch):
    """What reaches the kernels in a train step: contiguous NCHW for
    ``groupnorm_silu`` and its gradient, rows with a contiguous last
    dimension for ``attention_core`` and its dO. The CUDA wrappers raise on
    anything else; the CPU cannot run them, so this checks what reaches
    them, and that every forward call under autograd has its backward."""
    seen = {"gn": [], "gn_bwd": [], "attn": [], "attn_bwd": []}

    def gn_fwd(x, gamma, beta, scale, shift, groups, eps):
        seen["gn"].append(all(t is None or t.is_contiguous()
                              for t in (x, scale, shift)))
        return kgn.groupnorm_silu_plain(x, gamma, beta, scale, shift,
                                        groups=groups, eps=eps)

    def gn_bwd(g, x, *args, **kw):
        seen["gn_bwd"].append(g.is_contiguous() and x.is_contiguous())
        return kgn.groupnorm_silu_bwd_plain(g, x, *args, **kw)

    def attn_fwd(q, k, v, scale):
        seen["attn"].append(all(t.stride(3) == 1 for t in (q, k, v)))
        return kattn.attention_core_plain(q, k, v, scale)

    def attn_bwd(q, k, v, do, scale):
        seen["attn_bwd"].append(all(t.stride(3) == 1 for t in (q, k, v, do)))
        return kattn.attention_core_bwd_plain(q, k, v, do, scale)

    monkeypatch.setattr(kgn, "_groupnorm_silu_fwd", gn_fwd)
    monkeypatch.setattr(kgn, "gn_silu_bwd", gn_bwd)
    monkeypatch.setattr(kattn, "_attention_core_fwd", attn_fwd)
    monkeypatch.setattr(kattn, "attention_core_bwd", attn_bwd)
    tmodel = LatentDiffusion(SMALL_TRAIN, device="cpu")
    state = create_train_state(tmodel, SMALL_TRAIN)
    t, noise = _t_and_noise(jax.random.PRNGKey(65))
    train_step(tmodel, state, _batch(66), t=t, noise=noise)
    unet_attn = sum(isinstance(m, tattn.CrossAttention)
                    for m in tmodel.unet.modules())
    unet_gn = sum(type(m).__name__ == "GNSiLU" for m in tmodel.unet.modules())
    assert (len(seen["attn_bwd"]), len(seen["gn_bwd"])) == (unet_attn, unet_gn)
    # the frozen VQ encoder adds forward calls only
    assert len(seen["attn"]) == unet_attn + 1
    assert len(seen["gn"]) > unet_gn
    assert all(all(v) for v in seen.values()), seen


def test_converter_round_trip(steps):
    """``state_dict_to_flax`` / ``encoder4_to_flax`` undo the converter."""
    jstate = steps["step0"]["jax_after"]
    unet = jax.device_get(jstate.params["unet"])
    back = convert.state_dict_to_flax(convert.flax_to_state_dict(unet), unet)
    jax.tree.map(np.testing.assert_array_equal, back, unet)
    cond = jax.device_get(jstate.params["cond"])
    stats = jax.device_get(jstate.batch_stats)
    p, s = convert.encoder4_to_flax(convert.encoder4_state_dict(cond, stats),
                                    cond, stats)
    jax.tree.map(np.testing.assert_array_equal, (p, s), (cond, stats))


def test_train_steps_cli_writes_a_loadable_checkpoint(tmp_path, capsys):
    """Two steps of the flagship at B = 4 on the CPU, saved and read back."""
    from encdiff_tpu_torch import train_steps
    out = tmp_path / "trained.npz"
    train_steps.main(["--ckpt", str(FLAGSHIP_NPZ), "--steps", "2",
                      "--batch_size", "4", "--seed", "23", "--device", "cpu",
                      "--out", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["97501", "97502"]
    for ln in lines:
        assert np.isfinite([float(v) for v in ln.split()[3::2]]).all(), ln
    tree = load_compact(str(out))
    assert int(tree["state"]["step"]) == 97502
    assert "ema" in tree["state"]
    original = load_compact(str(FLAGSHIP_NPZ))["state"]["scale_factor"]
    assert float(tree["state"]["scale_factor"]) == float(original)
    model = LatentDiffusion.from_checkpoint(str(out), device="cpu")
    eps = model.apply_model(np.zeros((1, 16, 16, 3), np.float32), [500],
                            np.zeros((1, 320), np.float32))
    assert torch.isfinite(eps).all()
