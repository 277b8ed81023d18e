"""The flagship and the faces configurations as Python dicts.

``FLAGSHIP`` holds the model fields of
``configs/demo/synthetic-shapes-v4-full-encdiff.yaml`` (the architecture of
``configs/latent-diffusion/shapes3d-vq-4-16-encdiff.yaml``, and of
``_flagship_config`` in ``__graft_entry__.py``), kept here because the port
reads no YAML. ``FLAGSHIP_TRAIN`` adds what the flagship's final
purification phase trained with: the YAML's training fields and the run's
HSIC overrides (``demo_artifacts/round5/v4purify_run/run_metadata.json``).
``tests/test_torch_port_slice.py`` and
``tests/test_torch_port_train_modules.py`` hold both equal to those files.

``FLAGSHIP_RUN`` is the whole YAML as ``train.harness`` reads it
(``-b flagship``), nested as the YAML is: ``model`` (``base_learning_rate``
and ``params``: ``FLAGSHIP`` with the YAML's other model fields, its
sub-configs as their ``params``), ``data`` (the full 480,000-image v4 grid
as train and validation data, B = 128) and ``lightning`` (the image logger
every 20,000 steps, the best-FactorVAE and best-DCI checkpoints, 24 epochs,
validation every 2), with the port's classes as targets.
``tests/test_torch_harness.py`` holds it equal to the YAML.

``FACES`` and ``FACES_TRAIN`` hold the model and training fields of
``configs/demo/synthetic-faces-encdiff.yaml``: 256 px images of the
procedural face grid on 64x64x3 latents, micro-batch 8 with 4-way gradient
accumulation; ``train.harness``'s default seed. ``dtype`` is the YAML's
(bf16 activations on the TPU); the port reads it and runs fp32.
``tests/test_torch_port_faces.py`` holds both equal to the YAML.
"""

FLAGSHIP = {
    "timesteps": 1000,
    "loss_type": "l1",
    "scale_by_std": True,
    "linear_start": 0.0015,
    "linear_end": 0.0155,
    "image_size": 16,
    "channels": 3,
    "unet_config": {
        "image_size": 16,
        "in_channels": 3,
        "out_channels": 3,
        "model_channels": 64,
        "attention_resolutions": [1, 2, 4],
        "num_res_blocks": 2,
        "channel_mult": [1, 2, 4, 4],
        "num_heads": 8,
        "use_scale_shift_norm": True,
        "resblock_updown": True,
        "use_spatial_transformer": True,
        "context_dim": 16,
        "latent_unit": 20,
    },
    "first_stage_config": {
        "embed_dim": 3,
        "n_embed": 2048,
        "use_disentangled_concat": True,
        "disentangled_dim": 20,
        "ddconfig": {
            "double_z": False,
            "z_channels": 3,
            "resolution": 64,
            "in_channels": 3,
            "out_ch": 3,
            "ch": 32,
            "ch_mult": [1, 2, 4],
            "num_res_blocks": 2,
            "attn_resolutions": [],
            "dropout": 0.0,
        },
    },
    "cond_stage_config": {
        "d": 128,
        "context_dim": 16,
        "latent_unit": 20,
    },
}

FLAGSHIP_TRAIN = {
    **FLAGSHIP,
    "indep_type": "hsic",
    "lambda_indep": 2.0,
    "base_learning_rate": 2.0e-06,
    "batch_size": 128,
    "seed": 23,
    "scheduler_config": {
        "warm_up_steps": [10000],
        "cycle_lengths": [10000000000000],
        "f_start": [1.0e-06],
        "f_max": [1.0],
        "f_min": [1.0],
    },
}


FACES = {
    "timesteps": 1000,
    "loss_type": "l1",
    "scale_by_std": True,
    "linear_start": 0.0015,
    "linear_end": 0.0155,
    "image_size": 64,
    "channels": 3,
    "dtype": "bfloat16",
    "unet_config": {**FLAGSHIP["unet_config"], "image_size": 64},
    "first_stage_config": {
        **FLAGSHIP["first_stage_config"],
        "ddconfig": {**FLAGSHIP["first_stage_config"]["ddconfig"],
                     "resolution": 256},
    },
    "cond_stage_config": dict(FLAGSHIP["cond_stage_config"]),
}

FACES_TRAIN = {
    **FACES,
    "base_learning_rate": 2.0e-06,
    "batch_size": 8,
    "accumulate_grad_batches": 4,
    "seed": 23,
    "scheduler_config": dict(FLAGSHIP_TRAIN["scheduler_config"]),
}


FLAGSHIP_RUN = {
    "model": {
        "base_learning_rate": 2.0e-06,
        "params": {
            **FLAGSHIP,
            "num_timesteps_cond": 1,
            "log_every_t": 200,
            "first_stage_key": "image",
            "cond_stage_key": "image",
            "cond_stage_trainable": True,
            "concat_mode": False,
            "monitor": "train/loss_simple",
            "conditioning_key": "crossattn",
            "eval_name": "synthetic_shapes_full",
            "scheduler_config": dict(FLAGSHIP_TRAIN["scheduler_config"]),
        },
    },
    "data": {
        "target": "encdiff_tpu_torch.train.data.DataModuleFromConfig",
        "params": {
            "batch_size": 128,
            "num_workers": 8,
            "wrap": True,
            "train": {"target": "encdiff_tpu_torch.data.synthetic_shapes."
                                "SyntheticShapes3DV4FullTrain"},
            "validation": {"target": "encdiff_tpu_torch.data.synthetic_shapes."
                                     "SyntheticShapes3DV4FullTrain"},
        },
    },
    "lightning": {
        "callbacks": {
            "image_logger": {
                "target": "encdiff_tpu_torch.train.callbacks.ImageLogger",
                "params": {
                    "log_config": {
                        "target": "encdiff_tpu_torch.train.callbacks.Record",
                        "params": {"plot_image": True},
                    },
                    "batch_frequency": 20000,
                    "max_images": 8,
                    "increase_log_steps": False,
                    "log_images_kwargs": {"inpaint": False,
                                          "sample_swap": True,
                                          "plot_progressive_rows": False},
                },
            },
            "best_vae_checkpoint": {
                "target": "encdiff_tpu_torch.train.callbacks.ModelCheckpoint",
                "params": {
                    "monitor": "val/factor_vae_score",
                    "mode": "max",
                    "filename": "best_vae_{epoch:03d}_{val/factor_vae_score:.4f}",
                    "save_top_k": 1,
                },
            },
            "best_dci_checkpoint": {
                "target": "encdiff_tpu_torch.train.callbacks.ModelCheckpoint",
                "params": {
                    "monitor": "val/dci_disentanglement",
                    "mode": "max",
                    "filename": "best_dci_{epoch:03d}_{val/dci_disentanglement:.4f}",
                    "save_top_k": 1,
                },
            },
        },
        "trainer": {"benchmark": True, "max_epochs": 24,
                    "check_val_every_n_epoch": 2},
    },
}
