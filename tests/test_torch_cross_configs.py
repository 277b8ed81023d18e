"""The MPI3D and Cars3D run configs held against their YAMLs, on the CPU.

- ``MPI3D_VQ_RUN`` and ``CARS3D_VQ_RUN`` equal
  ``configs/demo/synthetic-{mpi3d,cars3d}-vq.yaml`` with the port's
  targets; ``MPI3D_RUN`` and ``CARS3D_RUN`` equal
  ``configs/demo/synthetic-{mpi3d,cars3d}-encdiff.yaml`` as
  ``test_flagship_run_matches_yaml`` holds the flagship's (the port's first
  stage takes no ``monitor``, ``ckpt_path`` or ``lossconfig``).
- Each is the flagship's run with only the keys the YAMLs change, and
  ``-b`` takes each by name.
- ``load_configs`` with each pipeline's overrides
  (``scripts/round4b_pipeline.sh:107-116``, ``scripts/round5_pipeline.sh:
  187-200``) merges as the JAX harness's ``load_configs`` merges the YAML
  with them.
"""

import copy
import pathlib

import pytest
import yaml

from encdiff_tpu.core.yamlcfg import OmegaConf
from encdiff_tpu.train import harness as jharness
from encdiff_tpu_torch import configs
from encdiff_tpu_torch.train import harness
from test_torch_harness import _port_target

ROOT = pathlib.Path(__file__).resolve().parents[1]
YAML = {name: ROOT / f"configs/demo/synthetic-{ds}-{kind}.yaml"
        for name, ds, kind in (("mpi3d_vq", "mpi3d", "vq"),
                               ("mpi3d", "mpi3d", "encdiff"),
                               ("cars3d_vq", "cars3d", "vq"),
                               ("cars3d", "cars3d", "encdiff"))}
RUNS = {"mpi3d_vq": configs.MPI3D_VQ_RUN, "mpi3d": configs.MPI3D_RUN,
        "cars3d_vq": configs.CARS3D_VQ_RUN, "cars3d": configs.CARS3D_RUN}
CKPT = "model.params.first_stage_config.params.ckpt_path=runs_cross/vq/" \
       "checkpoints/last"
#: each pipeline's dotlist overrides of the -b config
PIPELINE = {"mpi3d_vq": [], "cars3d_vq": [], "mpi3d": [CKPT],
            "cars3d": [CKPT, "model.params.indep_type=hsic",
                       "model.params.lambda_indep=2.0"]}
#: the first stage's keys that the port's VQ interface does not take
FIRST_STAGE_ONLY_JAX = {"monitor", "ckpt_path", "lossconfig"}


def _load(name):
    with open(YAML[name]) as f:
        return yaml.safe_load(f)


def _flat_params(params):
    """A YAML's ``model.params`` with each sub-config as its ``params``."""
    return {k: v["params"] if isinstance(v, dict) and "params" in v else v
            for k, v in params.items()}


@pytest.mark.parametrize("name", ["mpi3d_vq", "cars3d_vq"])
def test_vq_run_matches_yaml(name):
    assert RUNS[name] == _port_target(_load(name))
    assert harness.REGISTERED[name] is RUNS[name]


@pytest.mark.parametrize("name", ["mpi3d", "cars3d"])
def test_ldm_run_matches_yaml(name):
    ref = _load(name)
    run = RUNS[name]
    assert run["model"]["base_learning_rate"] == \
        ref["model"]["base_learning_rate"]
    ours, theirs = run["model"]["params"], _flat_params(ref["model"]["params"])
    assert set(ours) == set(theirs)
    for key, val in theirs.items():
        if key == "first_stage_config":
            assert set(val) - set(ours[key]) == FIRST_STAGE_ONLY_JAX
            val = {k: v for k, v in val.items() if k in ours[key]}
        assert ours[key] == val, key
    assert run["data"] == _port_target(ref["data"])
    assert run["lightning"] == _port_target(ref["lightning"])
    assert harness.REGISTERED[name] is run


@pytest.mark.parametrize("name", list(RUNS))
def test_runs_differ_from_the_flagship_only_where_the_yamls_do(name):
    flagship = (configs.FLAGSHIP_VQ_RUN if name.endswith("_vq")
                else configs.FLAGSHIP_RUN)
    run = copy.deepcopy(RUNS[name])
    ds = name.split("_")[0]
    trainer = run["lightning"]["trainer"]
    want = {"mpi3d_vq": {"max_epochs": 1}, "cars3d_vq": {"max_epochs": 4},
            "mpi3d": {"max_epochs": 8, "check_val_every_n_epoch": 1},
            "cars3d": {"max_epochs": 30, "check_val_every_n_epoch": 4}}[name]
    for key, value in want.items():
        assert trainer.pop(key) == value
        trainer[key] = flagship["lightning"]["trainer"][key]
    if not name.endswith("_vq"):
        params = run["model"]["params"]
        assert params["eval_name"] == ds
        assert params["scheduler_config"]["warm_up_steps"] == \
            [10000 if ds == "mpi3d" else 4000]
        params["eval_name"] = flagship["model"]["params"]["eval_name"]
        params["scheduler_config"]["warm_up_steps"] = [10000]
    targets = {k: run["data"]["params"][k].pop("target")
               for k in ("train", "validation")}
    module = f"encdiff_tpu_torch.data.synthetic_{ds}."
    assert all(t.startswith(module) for t in targets.values())
    for k in ("train", "validation"):
        run["data"]["params"][k]["target"] = \
            flagship["data"]["params"][k]["target"]
    assert run == flagship


@pytest.mark.parametrize("name", list(RUNS))
def test_pipeline_overrides_merge_as_jax(name):
    items = PIPELINE[name]
    port = harness.load_configs([name], items)
    jcfg = OmegaConf.to_container(jharness.load_configs([str(YAML[name])],
                                                        items))
    assert port["data"] == _port_target(jcfg["data"])
    assert port["lightning"] == _port_target(jcfg["lightning"])
    if name.endswith("_vq"):
        assert port["model"] == _port_target(jcfg["model"])
        return
    ours, theirs = port["model"]["params"], _flat_params(
        jcfg["model"]["params"])
    fs = theirs["first_stage_config"]
    assert ours["first_stage_config"]["ckpt_path"] == fs["ckpt_path"] == \
        "runs_cross/vq/checkpoints/last"
    theirs["first_stage_config"] = {k: v for k, v in fs.items()
                                    if k not in ("monitor", "lossconfig")}
    assert ours == theirs
    if name == "cars3d":
        assert (ours["indep_type"], ours["lambda_indep"]) == ("hsic", 2.0)
