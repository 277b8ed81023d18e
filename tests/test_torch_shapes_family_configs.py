"""The shapes family's run configs held against their YAMLs, on the CPU.

- Each of the 13 dicts (``configs.SHAPES_*``, ``configs.BANDS*``) equals
  its whole YAML of ``configs/demo/`` with the port's targets, as
  ``tests/test_torch_faces_ldm_ingest.py`` holds ``FACES_RUN``: the
  EncDiff stages' sub-configs as their ``params``, the first stage with its
  ``monitor``, ``ckpt_path`` and identity ``lossconfig``. The one
  difference is ``synthetic-shapes-mcl.yaml``'s ``ckpt_path``: the absolute
  path, on the machine the YAML was written on, of the JAX log directory
  that the other 27,648-image YAMLs name relative to the repository, which
  the port keeps.
- ``-b`` takes each by name, and ``load_configs`` with the first stage's
  override merges as the JAX harness's ``load_configs`` merges the YAML
  with it.
- ``-b shapes_mcl`` resolves the v1 grid (27,648 images), the
  ``synthetic_shapes`` ground truth and the MCL model.
- A first stage whose ``ckpt_path`` does not exist raises a clear error
  when the run initialises it.
"""

import pathlib

import pytest
import torch
import yaml

from encdiff_tpu.core.yamlcfg import OmegaConf
from encdiff_tpu.train import harness as jharness
from encdiff_tpu_torch import configs
from encdiff_tpu_torch.core.config import instantiate_from_config
from encdiff_tpu_torch.data import synthetic_shapes
from encdiff_tpu_torch.evalx.ground_truth.named_data import get_index_dataset
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.train import harness
from test_torch_harness import _port_target

ROOT = pathlib.Path(__file__).resolve().parents[1]
YAML = {
    "shapes_vq": "synthetic_shapes_vq.yaml",
    "shapes": "synthetic-shapes-encdiff.yaml",
    "shapes_full_vq": "synthetic_shapes_full_vq.yaml",
    "shapes_full": "synthetic-shapes-full-encdiff.yaml",
    "shapes_v2_vq": "synthetic-shapes-v2-full-vq.yaml",
    "shapes_v2": "synthetic-shapes-v2-full-encdiff.yaml",
    "shapes_v3_vq": "synthetic-shapes-v3-full-vq.yaml",
    "shapes_v3": "synthetic-shapes-v3-full-encdiff.yaml",
    "bands27k_vq": "synthetic-bands27k-vq.yaml",
    "bands27k": "synthetic-bands27k-encdiff.yaml",
    "bands_control_vq": "synthetic-bands-control-vq.yaml",
    "bands_control": "synthetic-bands-control-encdiff.yaml",
    "shapes_mcl": "synthetic-shapes-mcl.yaml",
}
RUNS = {name: getattr(configs, f"{name.upper()}_RUN") for name in YAML}
LDM = [name for name in YAML if not name.endswith("_vq")]
CKPT = ("model.params.first_stage_config.params.ckpt_path=runs/vq/"
        "checkpoints/last")


def _load(name):
    with open(ROOT / "configs/demo" / YAML[name]) as f:
        return yaml.safe_load(f)


def _flat_params(params):
    """A YAML's ``model.params`` with each sub-config as its ``params``."""
    return {k: v["params"] if isinstance(v, dict) and "params" in v else v
            for k, v in params.items()}


@pytest.mark.parametrize("name", list(YAML))
def test_run_matches_its_whole_yaml(name):
    ref, run = _load(name), RUNS[name]
    assert harness.REGISTERED[name] is run
    if name.endswith("_vq"):
        assert run == _port_target(ref)
        return
    # the EncDiff stage's model target is the harness's default
    assert set(ref["model"]) - set(run["model"]) == {"target"}
    assert run["model"]["base_learning_rate"] == \
        ref["model"]["base_learning_rate"]
    theirs = _flat_params(ref["model"]["params"])
    ours = run["model"]["params"]
    if name == "shapes_mcl":
        fs = dict(theirs["first_stage_config"])
        assert fs["ckpt_path"].startswith("/") and fs["ckpt_path"].endswith(
            "/" + configs.V1_VQ_CKPT)
        theirs["first_stage_config"] = {**fs,
                                        "ckpt_path": configs.V1_VQ_CKPT}
    assert ours == theirs
    assert run["data"] == _port_target(ref["data"])
    assert run["lightning"] == _port_target(ref["lightning"])


@pytest.mark.parametrize("name", LDM)
def test_first_stage_override_merges_as_jax(name):
    port = harness.load_configs([name], [CKPT])
    jcfg = OmegaConf.to_container(jharness.load_configs(
        [str(ROOT / "configs/demo" / YAML[name])], [CKPT]))
    assert port["model"]["params"] == _flat_params(jcfg["model"]["params"])
    assert port["model"]["params"]["first_stage_config"]["ckpt_path"] == \
        "runs/vq/checkpoints/last"
    assert port["data"] == _port_target(jcfg["data"])
    assert port["lightning"] == _port_target(jcfg["lightning"])


def test_shapes_mcl_resolves_the_v1_grid_and_the_mcl_model():
    cfg = harness.load_configs(["shapes_mcl"], [CKPT])
    params = cfg["model"]["params"]
    assert params["eval_name"] == "synthetic_shapes"
    assert {k: params[k] for k in configs.MCL_KEYS} == configs.MCL_KEYS
    assert params["scheduler_config"]["warm_up_steps"] == [200]
    assert cfg["model"]["base_learning_rate"] * \
        cfg["data"]["params"]["batch_size"] == pytest.approx(2.56e-5)
    swap = cfg["lightning"]["callbacks"]["swap_visualization"]["params"]
    assert swap == {"num_samples": 8, "ddim_steps": 200}
    data = instantiate_from_config(cfg["data"]).setup(device="cpu")
    for split in ("train", "validation"):
        ds = data.dataset(split)
        assert type(ds) is synthetic_shapes.SyntheticShapes3DTrain
        assert ds.images is synthetic_shapes.get_images(
            "v1", 64, synthetic_shapes.FACTOR_SIZES)
    assert len(data.dataset("train")) == \
        len(get_index_dataset(params["eval_name"]).images) == 27_648
    model = LatentDiffusion(params, device="cpu")
    assert model.use_mcl and model.mcl is not None
    assert (model.mcl_type, model.lambda_mcl) == ("infonce_mechgrad", 0.05)
    synthetic_shapes.clear_cache()


@pytest.mark.parametrize("name", ["shapes", "shapes_mcl"])
def test_a_missing_first_stage_checkpoint_raises(name):
    params = harness.load_configs([name], [])["model"]["params"]
    assert params["first_stage_config"]["ckpt_path"] == configs.V1_VQ_CKPT
    model = LatentDiffusion(params, device="cpu")
    with pytest.raises(FileNotFoundError, match="ckpt_path"):
        model.init_parameters(torch.Generator().manual_seed(0))
