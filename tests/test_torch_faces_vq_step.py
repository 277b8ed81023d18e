"""The faces VQ-GAN's 4-way accumulated update and its flash backward held
against the JAX package, on the CPU.

- One update of a narrow faces VQ-GAN (``NARROW``: the faces VQ's layout,
  ch 32 and ch_mult (1, 2, 4), at 128 px with one res block and 64 codes,
  so that its 32x32 latents take the flash route in both mid blocks, with
  one head of 128) from the same numpy-seeded weights on both sides, as
  four micro-batches of 2 through ``optax.MultiSteps`` and through
  ``train.loop.accumulate_grads``: the logs of every micro-step to
  ``LOG_REL``; no weight moved before the fourth; after it every generator
  and discriminator leaf, both Adam states and the batch statistics to
  ``LEAF_REL`` relative L2, with ``test_torch_vq_step.py``'s rule for
  rounding-zero gradients. The port runs the flash wrappers' plain
  versions (the CPU route), counted here; the JAX side its plain
  attention, as the JAX tests run it on the CPU.

  The tolerances are ten times those of the 32 px test, for the JAX step's
  own fp32 rounding at 128 px: against the same step taken by the port in
  float64, the JAX generator gradient of the first micro-step is 1.4e-4
  off (relative L2, median over leaves; 2.1e-4 at the 90th percentile) and
  its adaptive weight 1.6e-5, where the port's float32 gradient is 2.7e-6
  off. ``LOG_REL`` 1e-4 holds the adaptive weight (up to 4.2e-5 off in
  these four micro-steps); ``LEAF_REL`` 2e-3 the mean gradient of four
  micro-steps in Adam's second moment, which doubles its relative error
  (up to 9.5e-4).
- The plain dq and dk/dv at dh 128, and the port's autograd Function
  around them, against the Pallas ``_flash_core_bwd`` in interpret mode,
  at N of 256, 384 and 1,024 (``FLASH_TOL``, 2e-5: fp32 sums in another
  order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encdiff_tpu.models.autoencoder import VQModel as JVQModel
from encdiff_tpu.losses import lpips as jlpips
from encdiff_tpu.nn.pallas.flash_attention import (
    flash_attention as jflash_attention)
from encdiff_tpu.train import vq_trainer as jvq
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.nn import attention as tattn
from encdiff_tpu_torch.nn.kernels import flash_attention as kflash
from encdiff_tpu_torch.train import vq_trainer
from test_torch_vq_step import (LOSS, _seeded, check_leaves, compare_logs,
                                jax_state, port_from_jax, port_leaves,
                                unmoved)

ACCUMULATE = 4
B = 2
RES = 128
NARROW = dict(double_z=False, z_channels=3, resolution=RES, in_channels=3,
              out_ch=3, ch=32, ch_mult=[1, 2, 4], num_res_blocks=1,
              attn_resolutions=[], dropout=0.0)
LOG_REL = 1e-4
LEAF_REL = 2e-3
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def update():
    """Four micro-steps on both sides from the same start: per micro-step
    (port logs, JAX logs, port leaves after it), the leaves before, the
    JAX state's leaves after the update, and the plain flash calls."""
    assert tattn.takes_flash((RES // 4) ** 2, (RES // 4) ** 2)
    jmodel = JVQModel(ddconfig=NARROW, n_embed=64, embed_dim=3,
                      lossconfig={"target": "encdiff_tpu.losses.gan."
                                            "VQLPIPSWithDiscriminator",
                                  "params": LOSS})
    x = jnp.zeros((1, RES, RES, 3), jnp.float32)
    gen_shapes = jax.eval_shape(jmodel.module.init, jax.random.PRNGKey(0),
                                x)["params"]
    disc_shapes = jax.eval_shape(lambda: jmodel.loss.discriminator.init(
        jax.random.PRNGKey(0), x, train=False))
    zeros = lambda t: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                   dict(t))
    gen = _seeded(zeros(gen_shapes), 5)
    dvars = _seeded(zeros(disc_shapes), 6)
    lpips = jlpips.calibrate_random_features(jax.jit(
        jlpips.LPIPSModule().init)(jax.random.PRNGKey(1830), x, x))
    state, gen_tx, disc_tx = jax_state(
        jmodel, gen, dvars["params"], dvars["batch_stats"],
        jax.tree.map(np.asarray, lpips["params"]), accumulate=ACCUMULATE)
    model, pstate = port_from_jax(NARROW, 64, state, accumulate=ACCUMULATE)
    before = port_leaves(model, pstate)
    step = jvq.build_vq_train_step(jmodel, jmodel.loss, gen_tx, disc_tx,
                                   donate=False)
    rs = np.random.RandomState(7)
    batches = [rs.randint(0, 256, (B, RES, RES, 3), dtype=np.uint8)
               for _ in range(ACCUMULATE)]

    calls = {"fwd": 0, "dq": 0, "dkdv": 0}
    mp = pytest.MonkeyPatch()
    for key in calls:
        name = f"flash_attention_{key}_plain"
        fn = getattr(kflash, name)

        def counted(*args, _key=key, _fn=fn):
            calls[_key] += 1
            return _fn(*args)
        mp.setattr(kflash, name, counted)
    micro = []
    try:
        for batch in batches:
            state, jlog = step(state, batch)
            log = vq_trainer.train_step(model, pstate,
                                        torch.from_numpy(batch))
            micro.append((log, jlog, port_leaves(model, pstate)))
    finally:
        mp.undo()
    want = convert.vq_state_dicts(jax.tree.map(np.asarray, state))
    return micro, before, want, calls


@pytest.mark.parametrize("micro", range(ACCUMULATE))
def test_micro_step_logs_match_jax(update, micro):
    log, jlog, _ = update[0][micro]
    compare_logs(log, jlog, LOG_REL)


def test_mid_blocks_take_the_flash_route(update):
    # the encoder's and the decoder's mid block, forward and backward, in
    # each micro-step's generator pass
    assert update[3] == {k: 2 * ACCUMULATE for k in ("fwd", "dq", "dkdv")}


def test_no_weight_moves_before_the_fourth_micro_step(update):
    micro, before = update[0], update[1]
    for _, _, leaves in micro[:-1]:
        for part in ("generator", "discriminator"):
            for k, v in leaves[part].items():
                if not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked")):
                    assert torch.equal(v, before[part][k]), (part, k)
        assert leaves["gen_opt"][0] == leaves["disc_opt"][0] == 0


def test_update_matches_jax(update):
    micro, before, want, _ = update
    port = micro[-1][2]
    assert port["gen_opt"][0] == port["disc_opt"][0] == 1
    check_leaves(port, want, before, LEAF_REL)
    assert unmoved(port, before, "generator") == []
    assert unmoved(port, before, "discriminator") == []


def _heads(rs, b, h, n, dh):
    return rs.randn(b, h, n, dh).astype(np.float32)


@pytest.mark.parametrize("b,h,n", [(2, 1, 256), (1, 2, 384), (1, 1, 1024)])
def test_plain_flash_backward_matches_pallas_at_dh_128(b, h, n):
    """The JAX package pads no lane at dh 128: its kernels run as the
    faces VQ's mid blocks call them (here in interpret mode, blocks of
    128)."""
    rs = np.random.RandomState(n)
    dh = 128
    q, k, v, do = (_heads(rs, b, h, n, dh) for _ in range(4))
    scale = dh ** -0.5

    def jfn(q, k, v):
        return jflash_attention(q, k, v, scale, block_q=128, block_k=128,
                                interpret=True)
    o_ref, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v)))
    dq_ref, dk_ref, dv_ref = (np.asarray(g) for g in vjp(jnp.asarray(do)))

    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    o, lse = kflash.flash_attention_fwd(tq, tk, tv, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **FLASH_TOL)
    delta = (tdo * o).sum(dim=-1).contiguous()
    dq = kflash.flash_attention_dq(tq, tk, tv, tdo, lse, delta, scale)
    dk, dv = kflash.flash_attention_dkdv(tq, tk, tv, tdo, lse, delta, scale)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    grads = torch.autograd.grad(kflash.flash_attention(*leaves, scale),
                                leaves, tdo)
    for got, want in zip(grads, (dq_ref, dk_ref, dv_ref)):
        np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)
