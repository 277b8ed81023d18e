"""The faces EncDiff stage's first-stage ingestion and run config, on the CPU.

- ``VQModelInterface(ckpt_path=...)`` (the disentangled concat: 3 + 20
  input channels of ``post_quant_conv``) against the JAX interface's load
  (``load_reference_checkpoint``, what ``init_variables`` runs over its
  init; the template comes from ``jax.eval_shape`` of that init, whose
  random draws nothing here compares, in 3 s instead of 20) on
  ``demo_artifacts/round5/v4vq_fp16.npz`` at its 64 px layout: every
  loaded leaf equal (fp16 -> fp32, exact), the 3 loaded input channels of
  ``post_quant_conv`` equal, its 20 others the port's seeded init, and the
  decode of one seeded latent with seeded scalars equal to ``REL`` (1e-5)
  once the widened rows are carried across.
- The same on a port ``-b faces_vq`` tiny run (the faces VQ's layout at 32
  px of ``tests/test_torch_faces_vq_harness.py``, micro-batch 2, one
  update): ``checkpoints/compact_last.npz`` against the JAX load, and
  ``checkpoints/last`` (the directory: the fp32 generator of
  ``train_state.pt``) equal to the run's own generator and, rounded to
  fp16, to the ``.npz``'s.
- Refusals: a Lightning ``.ckpt`` (ROADMAP queue 1 #15), a shape mismatch
  other than the widening, a missing leaf.
- ``FACES_RUN`` equals ``configs/demo/synthetic-faces-encdiff.yaml``, and
  the JAX pipeline's override spelling
  ``model.params.first_stage_config.params.ckpt_path=<path>`` merges as the
  JAX harness merges it and reaches the interface of a ``-b faces``
  trainer, whose fresh init then holds the run's generator.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from encdiff_tpu.core.yamlcfg import OmegaConf
from encdiff_tpu.models.autoencoder import VQModelInterface as JInterface
from encdiff_tpu.train import harness as jharness
from encdiff_tpu_torch import convert
from encdiff_tpu_torch.configs import FACES_RUN, FLAGSHIP
from encdiff_tpu_torch.data import synthetic_faces
from encdiff_tpu_torch.models.autoencoder import (GENERATOR, VQModelInterface,
                                                  generator_state)
from encdiff_tpu_torch.train import harness
from test_torch_harness import _port_target

ROOT = pathlib.Path(__file__).resolve().parents[1]
VQ_NPZ = str(ROOT / "demo_artifacts/round5/v4vq_fp16.npz")
FACES_YAML = ROOT / "configs/demo/synthetic-faces-encdiff.yaml"
REL = 1e-5
TINY_GRID = (2, 1, 2, 1, 2, 1, 2)  # 16 faces
SIZE = 32
#: the faces VQ's layout at 32 px: 16x16x3 latents
TINY_DD = {**FACES_RUN["model"]["params"]["first_stage_config"]["ddconfig"],
           "resolution": SIZE, "ch_mult": [1, 2], "num_res_blocks": 1}
TINY_VQ = [f"model.params.ddconfig.resolution={SIZE}",
           "model.params.ddconfig.ch_mult=[1,2]",
           "model.params.ddconfig.num_res_blocks=1", "model.params.n_embed=64",
           "data.params.batch_size=2",
           f"data.params.train.params.image_size={SIZE}",
           f"data.params.validation.params.image_size={SIZE}"]
#: dotlist overrides of a tiny ``-b faces`` run over it: 32 px faces on
#: 16x16x3 latents, UNet model_channels 32, Encoder4 d 32, micro-batch 2
TINY_LDM = ["model.params.image_size=16",
            "model.params.unet_config.image_size=16",
            "model.params.unet_config.model_channels=32",
            "model.params.unet_config.channel_mult=[1,2]",
            "model.params.unet_config.num_res_blocks=1",
            "model.params.unet_config.attention_resolutions=[1,2]",
            "model.params.unet_config.num_heads=4",
            "model.params.cond_stage_config.d=32",
            f"model.params.first_stage_config.ddconfig.resolution={SIZE}",
            "model.params.first_stage_config.ddconfig.ch_mult=[1,2]",
            "model.params.first_stage_config.ddconfig.num_res_blocks=1",
            "model.params.first_stage_config.n_embed=64",
            "data.params.batch_size=2",
            f"data.params.train.params.image_size={SIZE}",
            f"data.params.validation.params.image_size={SIZE}"]


def tiny_vq_run(logroot) -> str:
    """The logdir of ``main_val -b faces_vq`` at the tiny layout: one update
    (4 micro-steps of 2) on the 16-face grid, without image logs or
    ``test()`` (``tests/test_torch_faces_vq_harness.py`` covers those)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(synthetic_faces.SyntheticFaces, "factor_sizes", TINY_GRID)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = harness.main([
            "-b", "faces_vq", "-t", "--no-test", "--max_steps", "4",
            "--device", "cpu", "-l", str(logroot), *TINY_VQ,
            "lightning.callbacks.image_logger.params.increase_log_steps="
            "false"])
    finally:
        torch.set_num_threads(n)
        mp.undo()
        harness.clear_device_cache()
    return trainer.logdir


@pytest.fixture(scope="module")
def vq_logdir(tmp_path_factory):
    return tiny_vq_run(tmp_path_factory.mktemp("faces_vq"))


def _interface(dd, n_embed, ckpt_path=None, seed=7):
    model = VQModelInterface(embed_dim=3, n_embed=n_embed, ddconfig=dd,
                             use_disentangled_concat=True, disentangled_dim=20,
                             ckpt_path=ckpt_path)
    model.init_parameters(torch.Generator().manual_seed(seed))
    model.load_ckpt_path()
    return model.eval()


def _jax_loaded(dd, n_embed, path):
    """The JAX interface and its variables after its load of ``path``."""
    jmodel = JInterface(ddconfig=dd, n_embed=n_embed, embed_dim=3,
                        use_disentangled_concat=True, disentangled_dim=20,
                        ckpt_path=path)
    shapes = jax.eval_shape(
        jmodel.module.init, jax.random.PRNGKey(0),
        jnp.zeros((1, dd["resolution"], dd["resolution"], 3)))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            dict(shapes))
    return jmodel, jmodel.load_reference_checkpoint(template, path)


def _check_against_jax(dd, n_embed, path, seed):
    """Every loaded leaf equal, the widened rows the port's seeded init, and
    the decode of a seeded latent equal once the rows are carried across."""
    port = _interface(dd, n_embed, path, seed)
    fresh = _interface(dd, n_embed, None, seed)
    jmodel, jvars = _jax_loaded(dd, n_embed, path)
    want = convert.flax_to_state_dict(
        jax.tree.map(np.asarray, jvars["params"]))
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        if k == "post_quant_conv.weight":
            assert tuple(v.shape) == (3, 23, 1, 1)
            torch.testing.assert_close(v[:, :3], want[k][:, :3], rtol=0,
                                       atol=0)
            torch.testing.assert_close(v[:, 3:],
                                       fresh.state_dict()[k][:, 3:],
                                       rtol=0, atol=0)
        else:
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    # the JAX tree takes the port's widened rows; then one decode each
    params = jax.tree.map(np.asarray, dict(jvars["params"]))
    params["post_quant_conv"]["Conv_0"]["kernel"] = (
        got["post_quant_conv.weight"].numpy().transpose(2, 3, 1, 0))
    side = dd["resolution"] // 2 ** (len(dd["ch_mult"]) - 1)
    rs = np.random.RandomState(seed)
    z = rs.randn(2, side, side, 3).astype(np.float32)
    u = rs.randn(2, 20).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, z, u: jmodel.decode(
        {"params": p}, z, True, u))(params, z, u))
    with torch.no_grad():
        out = port.decode(torch.from_numpy(z).permute(0, 3, 1, 2),
                          force_not_quantize=True,
                          disentangled_repr=torch.from_numpy(u))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=REL, atol=REL)
    return port


def test_v4vq_npz_ingestion_matches_jax():
    _check_against_jax(FLAGSHIP["first_stage_config"]["ddconfig"], 2048,
                       VQ_NPZ, 11)


def test_faces_vq_run_npz_ingestion_matches_jax(vq_logdir):
    _check_against_jax(TINY_DD, 64, os.path.join(
        vq_logdir, "checkpoints", "compact_last.npz"), 12)


def test_faces_vq_run_directory_holds_the_run_generator(vq_logdir):
    ckdir = os.path.join(vq_logdir, "checkpoints")
    saved = torch.load(os.path.join(ckdir, "last", "train_state.pt"),
                       weights_only=False)["model"]
    run = {k: v for k, v in saved.items() if k.split(".")[0] in GENERATOR}
    from_dir = generator_state(os.path.join(ckdir, "last"))
    from_npz = generator_state(os.path.join(ckdir, "compact_last.npz"))
    assert set(from_dir) == set(run) == set(from_npz)
    for k, v in from_dir.items():
        assert torch.equal(v, run[k]), k
        assert torch.equal(v.half().float(), from_npz[k]), k
    port = _interface(TINY_DD, 64, os.path.join(ckdir, "last"), 13)
    fresh = _interface(TINY_DD, 64, None, 13)
    for k, v in port.state_dict().items():
        if k == "post_quant_conv.weight":
            assert torch.equal(v[:, :3], run[k])
            assert torch.equal(v[:, 3:], fresh.state_dict()[k][:, 3:])
        else:
            assert torch.equal(v, run[k]), k


def test_ingestion_refusals(tmp_path):
    model = _interface(TINY_DD, 64)
    with pytest.raises(NotImplementedError, match="#15"):
        generator_state(str(tmp_path / "last.ckpt"))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["post_quant_conv.weight"] = sd["post_quant_conv.weight"][:, :3]
    model.load_generator(sd)                      # the widening: accepted
    for key, bad in (("post_quant_conv.weight", (3, 5, 1, 1)),
                     ("quantize.embedding", (128, 3)),
                     ("quant_conv.bias", (4,))):
        wrong = {**sd, key: torch.zeros(bad)}
        with pytest.raises(ValueError, match=f"shape mismatch at {key}"):
            model.load_generator(wrong)
    narrow = VQModelInterface(embed_dim=3, n_embed=64, ddconfig=TINY_DD)
    with pytest.raises(ValueError, match="post_quant_conv.weight"):
        narrow.load_generator({**sd, "post_quant_conv.weight":
                               model.state_dict()["post_quant_conv.weight"]})
    missing = dict(sd)
    del missing["decoder.conv_out.bias"]
    with pytest.raises(KeyError, match="decoder.conv_out.bias"):
        model.load_generator(missing)
    with pytest.raises(NotImplementedError, match="lossconfig"):
        VQModelInterface(embed_dim=3, n_embed=64, ddconfig=TINY_DD,
                         lossconfig={"target": "encdiff_tpu_torch.losses."
                                               "gan.VQLPIPSWithDiscriminator"})


def test_faces_run_matches_yaml():
    with open(FACES_YAML) as f:
        ref = yaml.safe_load(f)
    model = ref["model"]
    assert FACES_RUN["model"]["base_learning_rate"] == \
        model["base_learning_rate"]
    flat = {k: v["params"] if isinstance(v, dict) and "params" in v else v
            for k, v in model["params"].items()}
    assert FACES_RUN["model"]["params"] == flat
    assert FACES_RUN["data"] == _port_target(ref["data"])
    assert FACES_RUN["lightning"] == _port_target(ref["lightning"])
    assert harness.REGISTERED["faces"] is FACES_RUN


def test_pipeline_override_spelling_reaches_the_interface(vq_logdir,
                                                          tmp_path,
                                                          monkeypatch):
    last = os.path.join(vq_logdir, "checkpoints", "last")
    items = [f"model.params.first_stage_config.params.ckpt_path={last}",
             "model.params.unet_config.params.model_channels=32",
             "data.params.batch_size=2"]
    port = harness.load_configs(["faces"], items)
    jcfg = OmegaConf.to_container(jharness.load_configs([str(FACES_YAML)],
                                                        items))
    flat = {k: v["params"] if isinstance(v, dict) and "params" in v else v
            for k, v in jcfg["model"]["params"].items()}
    assert port["model"]["params"] == flat
    assert port["data"] == _port_target(jcfg["data"])

    monkeypatch.setattr(synthetic_faces.SyntheticFaces, "factor_sizes",
                        TINY_GRID)
    trainer = harness.main(["-b", "faces", "--device", "cpu", "-l",
                            str(tmp_path), *TINY_LDM, items[0]])
    harness.clear_device_cache()
    fs = trainer.model.first_stage_model
    assert fs.ckpt_path == last and trainer.state is None
    trainer._ensure_state()
    run = generator_state(last)
    for k, v in fs.state_dict().items():
        if k == "post_quant_conv.weight":
            assert torch.equal(v[:, :3], run[k])
        else:
            assert torch.equal(v, run[k]), k
