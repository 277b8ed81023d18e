"""The port's MCL losses (``encdiff_tpu_torch/losses/mcl.py``) and the
second-order autograd Functions of the GN-SiLU and attention backward,
held against the JAX package on the CPU.

- The heads (``MechanismCritic``, ``MLPProj``) carry the JAX
  ``init_mcl_variables`` draw across through ``convert.mcl_state_dict``; the
  decoder is a small VQ first stage (ch 32, ch_mult (1, 2), one res block:
  8x8x3 latents to 16 px, its mid-block attention included) with seeded
  flax parameters, decoding without the quantizer (the straight-through
  estimator is the identity for gradients; the quantized path is held in
  ``test_torch_mcl_step.py``). Each of the five loss types, with the JAX
  draws injected (the permutation, ε, the probe v), gives the same value
  and the same gradients with respect to z, u and every head leaf.
- ``_GNSiLUBwd`` and ``_AttentionCoreBwd`` (the backward of the backward)
  against ``jax.vjp`` of ``jax.vjp`` of the XLA references.

Tolerance: the loss to 1e-5 relative; each gradient to 1e-4 relative L2
(fp32 through a decoder differentiated twice, sums in other orders), but a
head leaf whose exact gradient is zero (a bias that reaches the mechanism
gradient only through a ReLU's mask) is held within 1e-6 of the gradients'
global norm; the Functions' outputs to 1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.core.config import instantiate_from_config
from encdiff_tpu.losses import mcl as jmcl
from encdiff_tpu.nn.pallas.groupnorm_silu import reference_groupnorm_silu
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.losses import mcl as tmcl
from encdiff_tpu_torch.models.autoencoder import VQModelInterface
from encdiff_tpu_torch.nn.kernels.attention import _AttentionCoreBwd
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import _GNSiLUBwd
from torch_threads import one_thread  # noqa: F401

B, U, PROJ = 4, 20, 32
Z_SHAPE = (8, 8, 3)            # (h, w, c), as the JAX package gives it
REL = 1e-4
FIRST_STAGE = {
    "embed_dim": 3, "n_embed": 64, "use_disentangled_concat": True,
    "disentangled_dim": U,
    "ddconfig": {"double_z": False, "z_channels": 3, "resolution": 16,
                 "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                 "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0}}
CASES = [("nce_logistic", "shuffle_u"), ("nce_logistic", "shuffle_z"),
         ("infonce_mechgrad", "shuffle_u"), ("fisher_sm", "shuffle_u"),
         ("denoise_sm", "shuffle_u"), ("jacobian_vjp_infonce", "shuffle_u")]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _seeded(shapes, seed):
    """Kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), other leaves
    N(0, 0.1²), from a numpy seed."""
    rs = np.random.RandomState(seed)

    def walk(t, path=()):
        if hasattr(t, "items"):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        noise = rs.randn(*t.shape).astype(np.float32)
        if path[-1] == "kernel":
            return noise / np.sqrt(np.prod(t.shape[:-1]))
        if path[-1] == "scale":
            return 1.0 + 0.1 * noise
        return 0.1 * noise
    return walk(shapes)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def setup():
    """Both packages' decoders and heads on the same parameters, and the
    inputs z (NHWC) and u."""
    jfs = instantiate_from_config({
        "target": "encdiff_tpu.models.autoencoder.VQModelInterface",
        "params": {**FIRST_STAGE,
                   "lossconfig": {"target": "torch.nn.Identity"}}})
    shapes = jax.eval_shape(jfs.init_variables, jax.random.PRNGKey(0))
    fs_vars = jax.tree.map(jnp.asarray, _seeded(shapes, 70))
    modules = jmcl.build_mcl_modules(Z_SHAPE, U, PROJ)
    params = jmcl.init_mcl_variables(modules, jax.random.PRNGKey(71),
                                     Z_SHAPE, U, image_res=16)
    tfs = VQModelInterface(**FIRST_STAGE)
    tfs.load_state_dict(convert.first_stage_state_dict(
        jax.device_get(fs_vars["params"])))
    tfs.requires_grad_(False)
    heads = tmcl.build_mcl_modules(Z_SHAPE, U, PROJ)
    heads.load_state_dict(convert.mcl_state_dict(jax.device_get(params)))
    rs = np.random.RandomState(72)
    z = rs.randn(B, *Z_SHAPE).astype(np.float32)
    u = rs.randn(B, U).astype(np.float32)
    return dict(jfs=jfs, fs_vars=fs_vars, modules=modules, params=params,
                tfs=tfs, heads=heads, z=z, u=u)


def test_heads_match(setup):
    """MechanismCritic (the image features zero-padded from 128 to 256),
    MLPProj, InfoNCE and the BCE with logits."""
    s = setup
    rs = np.random.RandomState(73)
    x_hat = rs.randn(B, 16, 16, 3).astype(np.float32)
    jc = s["modules"]["critic"].apply(s["params"]["critic"], x_hat, s["z"],
                                      s["u"])
    tc = s["heads"]["critic"](_nchw(x_hat), _nchw(s["z"]),
                              torch.from_numpy(s["u"]))
    np.testing.assert_allclose(tc.detach().numpy(), jc, rtol=1e-5, atol=1e-6)
    for name, inp in (("Pi_g", s["z"].reshape(B, -1)), ("Pi_u", s["u"])):
        jo = s["modules"][name].apply(s["params"][name], inp)
        to = s["heads"][name](torch.from_numpy(np.ascontiguousarray(inp)))
        np.testing.assert_allclose(to.detach().numpy(), jo, rtol=1e-5,
                                   atol=1e-6)
    q, k = rs.randn(B, PROJ).astype(np.float32), rs.randn(B, PROJ).astype(
        np.float32)
    np.testing.assert_allclose(
        tmcl.info_nce_from_qk(torch.from_numpy(q), torch.from_numpy(k),
                              0.1).item(),
        float(jmcl.info_nce_from_qk(q, k, 0.1)), rtol=1e-6)
    for target in (0.0, 1.0):
        np.testing.assert_allclose(
            tmcl._bce_with_logits(torch.from_numpy(q[:, 0] * 5), target).item(),
            float(jmcl._bce_with_logits(q[:, 0] * 5, target)), rtol=1e-6)


@pytest.mark.parametrize("loss_type,neg_mode", CASES)
def test_mcl_loss_value_and_gradients(setup, loss_type, neg_mode):
    s = setup
    rng = jax.random.PRNGKey(74)
    jfs, fs_vars, modules = s["jfs"], s["fs_vars"], s["modules"]

    def jdecode(zz, uu):
        return jfs.decode(fs_vars, zz, force_not_quantize=True,
                          disentangled_repr=uu)

    def jloss(z, u, params):
        return jmcl.mcl_loss(loss_type, jdecode, z, u, modules, params, rng,
                             tau=0.1, sigma=0.1, neg_mode=neg_mode)

    val, (gz, gu, gp) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2)))(s["z"], s["u"], s["params"])
    # the draw mcl_loss makes from its key
    draw = None
    if loss_type == "nce_logistic":
        draw = torch.from_numpy(np.asarray(jax.random.permutation(rng, B)))
    elif loss_type in ("fisher_sm", "denoise_sm"):
        draw = _nchw(jax.random.normal(rng, s["z"].shape, jnp.float32))
    elif loss_type == "jacobian_vjp_infonce":
        draw = _nchw(jax.random.normal(rng, (B, 16, 16, 3), jnp.float32))

    heads = s["heads"]
    z = _nchw(s["z"]).requires_grad_()
    u = torch.from_numpy(s["u"]).requires_grad_()
    loss = tmcl.mcl_loss(
        loss_type, lambda zz, uu: s["tfs"].decode(
            zz, force_not_quantize=True, disentangled_repr=uu),
        z, u, heads, tau=0.1, sigma=0.1, neg_mode=neg_mode, draw=draw)
    names = [k for k, _ in heads.named_parameters()]
    grads = torch.autograd.grad(loss, [z, u, *heads.parameters()],
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, [z, u, *heads.parameters()])]
    np.testing.assert_allclose(loss.item(), float(val), rtol=1e-5)
    assert _rel(grads[0].permute(0, 2, 3, 1).numpy(), gz) <= REL
    assert _rel(grads[1].numpy(), gu) <= REL
    want = convert.mcl_state_dict(jax.device_get(gp))
    assert set(want) == set(names)
    total = np.sqrt(sum(np.sum(np.square(v.numpy(), dtype=np.float64))
                        for v in want.values()))
    assert total > 0
    nonzero = 0
    for name, g in zip(names, grads[2:]):
        w = want[name].numpy()
        if np.linalg.norm(w) <= 1e-6 * total:
            assert np.linalg.norm(g.numpy() - w) <= 1e-6 * total, name
        else:
            nonzero += 1
            assert _rel(g.numpy(), w) <= REL, (name, _rel(g.numpy(), w))
    assert nonzero >= 4  # the critic's weights at least


def test_gn_silu_bwd_double_backward_matches_jax():
    """``_GNSiLUBwd``: the gradients of (dx, dgamma, dbeta) with respect to
    (g, x, gamma, beta) against jax.vjp of jax.vjp of
    ``reference_groupnorm_silu``, NHWC there."""
    rs = np.random.RandomState(75)
    shape = (2, 64, 4, 4)
    x, g, du = (rs.randn(*shape).astype(np.float32) * 2 + 0.5,
                rs.randn(*shape).astype(np.float32),
                rs.randn(*shape).astype(np.float32))
    gamma = (1 + 0.2 * rs.randn(64)).astype(np.float32)
    beta = (0.2 * rs.randn(64)).astype(np.float32)
    gbar, bbar = (rs.randn(64).astype(np.float32) for _ in range(2))
    nhwc = lambda a: np.ascontiguousarray(a.transpose(0, 2, 3, 1))

    def bwd(gg, xx, ga, be):
        return jax.vjp(lambda a, b, c: reference_groupnorm_silu(
            a, b, c, groups=32, eps=1e-6), xx, ga, be)[1](gg)

    _, vjp2 = jax.vjp(bwd, nhwc(g), nhwc(x), gamma, beta)
    want = vjp2((nhwc(du), gbar, bbar))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (g, x, gamma, beta)]
    outs = _GNSiLUBwd.apply(*leaves, None, None, 32, 1e-6)
    got = torch.autograd.grad(outs[:3], leaves,
                              [torch.from_numpy(a) for a in (du, gbar, bbar)])
    for i, (a, w) in enumerate(zip(got, want)):
        a = a.numpy()
        if a.ndim == 4:
            a = nhwc(a)
        assert _rel(a, w) <= REL, (i, _rel(a, w))


def test_attention_bwd_double_backward_matches_jax():
    """``_AttentionCoreBwd``: the gradients of (dq, dk, dv) with respect to
    (q, k, v, do) against jax.vjp of jax.vjp of softmax(q kᵀ s) v."""
    rs = np.random.RandomState(76)
    b, h, n, m, dh = 2, 2, 6, 5, 8
    scale = dh ** -0.5
    q, k, v, do, qb, kb, vb = (rs.randn(b, h, length, dh).astype(np.float32)
                               for length in (n, m, m, n, n, m, m))

    def attn(qq, kk, vv):
        p = jax.nn.softmax(jnp.einsum("bhnd,bhmd->bhnm", qq, kk) * scale,
                           axis=-1)
        return jnp.einsum("bhnm,bhmd->bhnd", p, vv)

    def bwd(qq, kk, vv, dd):
        return jax.vjp(attn, qq, kk, vv)[1](dd)

    want = jax.vjp(bwd, q, k, v, do)[1]((qb, kb, vb))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, do)]
    outs = _AttentionCoreBwd.apply(*leaves, scale)
    got = torch.autograd.grad(outs, leaves,
                              [torch.from_numpy(a) for a in (qb, kb, vb)])
    for i, (a, w) in enumerate(zip(got, want)):
        assert _rel(a.numpy(), w) <= REL, (i, _rel(a.numpy(), w))
