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

``FLAGSHIP_VQ_RUN`` is the whole ``configs/demo/synthetic-shapes-v4-full-vq.yaml``
(``-b flagship_vq``): the flagship's VQ-GAN first stage (ch 32, ch_mult
(1, 2, 4), 64 px, 16x16x3 latents, 2,048 codes) against LPIPS, the PatchGAN
discriminator and the adaptive GAN weight, B = 128 on the full v4 grid, the
image logger every 2,000 steps with its power-of-2 warm-up, 2 epochs.
``tests/test_torch_vq_harness.py`` holds it equal to the YAML.

``FLAGSHIP_MCL_RUN`` (``-b flagship_mcl``) is the MCL fine-tune of the
flagship as ``scripts/run_mcl_sweep.py`` runs each cell: ``FLAGSHIP_RUN``
(the v4 model and the full v4 grid, which the committed
``v4purify_final_fp16.npz`` was trained on) overlaid with
``configs/demo/synthetic-shapes-mcl.yaml``'s MCL keys (``infonce_mechgrad``
at λ 0.05, τ 0.1, projections of 128, σ 0.1, ``shuffle_u`` negatives), its
base LR of 2e-7, its LR warmup of 200 steps and its swap-visualization
callback (8 samples, DDIM 200). That YAML's own dataset, the v1 renderer's
27,648-image grid (``SyntheticShapes3DTrain``), is not taken: the
committed checkpoint was trained on v4. ``tests/test_torch_mcl_config.py``
holds it to both YAMLs.

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


FLAGSHIP_VQ_RUN = {
    "model": {
        "base_learning_rate": 4.5e-06,
        "target": "encdiff_tpu_torch.models.autoencoder.VQModel",
        "params": {
            "embed_dim": 3,
            "n_embed": 2048,
            "monitor": "val/rec_loss",
            "ddconfig": dict(FLAGSHIP["first_stage_config"]["ddconfig"]),
            "lossconfig": {
                "target": "encdiff_tpu_torch.losses.gan."
                          "VQLPIPSWithDiscriminator",
                "params": {
                    "disc_conditional": False,
                    "disc_in_channels": 3,
                    "disc_start": 0,
                    "disc_weight": 0.75,
                    "codebook_weight": 1.0,
                    "perceptual_weight": 1.0,
                },
            },
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
                "params": {"batch_frequency": 2000, "max_images": 8,
                           "increase_log_steps": True},
            },
        },
        "trainer": {"benchmark": True, "accumulate_grad_batches": 1,
                    "max_epochs": 2},
    },
}


#: the MCL keys of ``configs/demo/synthetic-shapes-mcl.yaml``
MCL_KEYS = {
    "use_mcl": True,
    "lambda_mcl": 0.05,
    "mcl_tau": 0.1,
    "mcl_proj_dim": 128,
    "mcl_sigma": 0.1,
    "mcl_neg_mode": "shuffle_u",
    "mcl_type": "infonce_mechgrad",
}

FLAGSHIP_MCL_RUN = {
    "model": {
        "base_learning_rate": 2.0e-07,
        "params": {
            **FLAGSHIP_RUN["model"]["params"],
            **MCL_KEYS,
            "scheduler_config": {
                **FLAGSHIP_RUN["model"]["params"]["scheduler_config"],
                "warm_up_steps": [200],
            },
        },
    },
    # the v4 grid of FLAGSHIP_RUN, not the MCL YAML's v1 grid: the committed
    # checkpoint the fine-tune starts from was trained on v4
    "data": FLAGSHIP_RUN["data"],
    "lightning": {
        **FLAGSHIP_RUN["lightning"],
        "callbacks": {
            **FLAGSHIP_RUN["lightning"]["callbacks"],
            "swap_visualization": {
                "target": "encdiff_tpu_torch.train.callbacks."
                          "SwapVisualizationCallback",
                "params": {"num_samples": 8, "ddim_steps": 200},
            },
        },
    },
}
