"""The GN-SiLU kernels' launch plans, forward and backward, at every
GroupNorm shape that the flagship and faces configurations produce, on the
CPU.

``gn_silu_plan`` and ``gn_silu_bwd_plan`` are the Python copies of the plans
in ``csrc/groupnorm_silu.cu`` (the card tests hold each equal to its
source). The shapes
come from one UNet call, one VQ decode and one VQ encode of each
configuration, built and run on the meta device with the kernel wrappers
replaced by shape-only stand-ins, so nothing is computed.
"""

import collections

import pytest
import torch

from encdiff_tpu_torch.configs import FACES, FLAGSHIP
from encdiff_tpu_torch.models.autoencoder import VQModelInterface
from encdiff_tpu_torch.nn import attention as port_attention
from encdiff_tpu_torch.nn import layers as port_layers
from encdiff_tpu_torch.nn import vae as port_vae
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import (
    gn_silu_bwd3_plan, gn_silu_bwd_bwd_plan, gn_silu_bwd_plan, gn_silu_plan)
from encdiff_tpu_torch.nn.unet import UNetModel

#: an H100's opt-in shared memory a block (227 KB)
H100_SMEM = 232448
BATCHES = (16, 32, 64, 128, 160)


def _gn_shapes(config, monkeypatch):
    """(C, H * W) of every GN-SiLU call of one UNet call, one decode and one
    encode at B = 1."""
    seen = collections.Counter()

    def gn(x, gamma, beta, scale=None, shift=None, *, groups=32, eps=1e-5):
        assert groups == 32
        seen[(x.shape[1], x.shape[2] * x.shape[3])] += 1
        return torch.empty_like(x)

    def attn(q, k, v, scale):
        return torch.empty_like(q)

    monkeypatch.setattr(port_layers, "groupnorm_silu", gn)
    monkeypatch.setattr(port_attention, "attention", attn)
    monkeypatch.setattr(port_vae, "attention", attn)
    with torch.device("meta"):
        unet = UNetModel(**config["unet_config"])
        first = VQModelInterface(**config["first_stage_config"])
        s, c = config["image_size"], config["channels"]
        res = config["first_stage_config"]["ddconfig"]["resolution"]
        unet_config = config["unet_config"]
        tokens = torch.empty(1, unet_config.get("latent_unit", 20)
                             * unet_config["context_dim"])
        unet(torch.empty(1, c, s, s), torch.zeros(1, dtype=torch.long),
             tokens)
        first.decode(torch.empty(1, c, s, s), force_not_quantize=True)
        first.encode(torch.empty(1, 3, res, res))
    return seen


@pytest.mark.parametrize("name,config", [("flagship", FLAGSHIP),
                                         ("faces", FACES)])
def test_gn_silu_plan_at_every_configured_shape(name, config, monkeypatch):
    shapes = _gn_shapes(config, monkeypatch)
    assert len(shapes) >= 10
    clusters = set()
    for (c, hw) in shapes:
        group_bytes = 4 * (c // 32) * hw
        for b in BATCHES:
            plan = gn_silu_plan(b, c, hw, 32, H100_SMEM)
            assert plan.smem <= H100_SMEM
            assert plan.slice * plan.cluster >= (c // 32) * hw
            assert plan.blocks == -(-b * 32 // plan.per_block) * plan.cluster
            if group_bytes <= H100_SMEM - 4096:
                assert plan.cluster == 1, (name, c, hw)
            else:
                assert 2 <= plan.cluster <= 8, (name, c, hw)
            clusters.add(plan.cluster)
    # the faces decoder's 256x256 level (32 and 64 channels: 256 and 512 KB
    # groups) runs on clusters; every flagship group fits one block
    assert clusters == ({1} if name == "flagship" else {1, 2, 4})


def test_gn_silu_plan_packs_small_groups_and_splits_large_ones():
    tiny = gn_silu_plan(160, 256, 4, 32, H100_SMEM)     # 32 floats a group
    assert (tiny.team, tiny.per_block, tiny.cluster) == (32, 8, 1)
    assert tiny.blocks == 160 * 32 // 8
    mid = gn_silu_plan(160, 64, 4096, 32, H100_SMEM)    # 32 KB
    assert (mid.team, mid.per_block, mid.cluster) == (256, 1, 1)
    big = gn_silu_plan(32, 32, 65536, 32, H100_SMEM)    # 256 KB
    assert (big.cluster, big.slice, big.blocks) == (2, 32768, 32 * 32 * 2)
    huge = gn_silu_plan(1, 32, 262144, 32, H100_SMEM)   # 1 MB
    assert huge.cluster == 8
    with pytest.raises(ValueError, match="does not fit"):
        gn_silu_plan(1, 32, 4 * 262144, 32, H100_SMEM)  # 4 MB: 16 blocks


@pytest.mark.parametrize("name,config", [("flagship", FLAGSHIP),
                                         ("faces", FACES)])
def test_gn_silu_bwd_plan_at_every_configured_shape(name, config,
                                                    monkeypatch):
    """The backward stages x and the gradient, and splits a group over a
    cluster until its blocks fit two an SM (half the shared memory).
    Every configured group fits; every flagship group fits one block, and
    the faces decoder's 128x128 and 256x256 levels run on clusters of 2 to
    8 (256 KB to 1 MB of x + g a group)."""
    shapes = _gn_shapes(config, monkeypatch)
    clusters = set()
    for (c, hw) in shapes:
        for b in BATCHES:
            plan = gn_silu_bwd_plan(b, c, hw, 32, H100_SMEM)
            assert plan.smem <= H100_SMEM
            assert plan.slice * plan.cluster >= (c // 32) * hw
            assert plan.blocks == -(-b * 32 // plan.per_block) * plan.cluster
            assert plan.team == gn_silu_plan(b, c, hw, 32, H100_SMEM).team
            slice_ = ((c // 32) * hw + 3) // 4 * 4  # the group, on 16 bytes
            one_block = 4 * (plan.per_block * 2 * slice_ + 256 + 66)
            if one_block <= H100_SMEM // 2:
                assert plan.cluster == 1, (name, c, hw)
            else:
                assert 2 <= plan.cluster <= 8, (name, c, hw)
                assert plan.smem <= H100_SMEM // 2 or plan.cluster == 8
            clusters.add(plan.cluster)
    assert clusters == ({1} if name == "flagship" else {1, 2, 4, 8})


@pytest.mark.parametrize("case", ["packs", "vq_decoder", "splits", "refuses",
                                  "third_order"])
def test_gn_silu_bwd_plan_packs_small_groups_and_splits_large_ones(case):
    if case == "packs":     # 32 floats a group: 8 groups a block
        plan = gn_silu_bwd_plan(128, 256, 4, 32, H100_SMEM)
        assert (plan.team, plan.per_block, plan.cluster) == (32, 8, 1)
        assert plan.blocks == 128 * 32 // 8
        assert plan.smem == 4 * (8 * 2 * 32 + 256 + 66)
    elif case == "vq_decoder":  # (32, 32, 256, 256): 512 KB of x + g a group
        plan = gn_silu_bwd_plan(32, 32, 65536, 32, H100_SMEM)
        assert (plan.team, plan.per_block, plan.cluster) == (256, 1, 8)
        assert (plan.slice, plan.blocks) == (8192, 32 * 32 * 8)
        assert plan.smem <= H100_SMEM // 2  # two blocks an SM
    elif case == "splits":  # up to half the shared memory in one block
        assert gn_silu_bwd_plan(8, 384, 1024, 32, H100_SMEM).cluster == 1
        assert gn_silu_bwd_plan(8, 128, 4096, 32, H100_SMEM).cluster == 2
        assert gn_silu_bwd_plan(2, 64, 16384, 32, H100_SMEM).cluster == 4
        # 1 MB: eight blocks of 128 KB, one an SM, since none fit two
        plan = gn_silu_bwd_plan(1, 32, 131072, 32, H100_SMEM)
        assert plan.cluster == 8 and plan.smem > H100_SMEM // 2
    elif case == "refuses":  # 2 MB of x + g: 16 blocks
        with pytest.raises(ValueError, match="does not fit"):
            gn_silu_bwd_plan(1, 32, 262144, 32, H100_SMEM)
    else:  # the MCL step's 64x64 level of the VQ decoder, 8,192 floats a group
        two = gn_silu_bwd_bwd_plan(128, 64, 4096, 32, H100_SMEM)
        assert (two.cluster, two.smem) == (1, 4 * (3 * 8192 + 256 + 66))
        # four staged arrays, 128 KB, exceed half: clusters of 2 blocks
        plan = gn_silu_bwd3_plan(128, 64, 4096, 32, H100_SMEM)
        assert (plan.team, plan.per_block, plan.cluster) == (256, 1, 2)
        assert (plan.slice, plan.blocks) == (4096, 128 * 32 * 2)
        assert plan.smem == 4 * (4 * 4096 + 256 + 66) <= H100_SMEM // 2
