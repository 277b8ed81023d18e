"""The flagship configuration as Python dicts.

``FLAGSHIP`` holds the model fields of
``configs/demo/synthetic-shapes-v4-full-encdiff.yaml`` (the architecture of
``configs/latent-diffusion/shapes3d-vq-4-16-encdiff.yaml``, and of
``_flagship_config`` in ``__graft_entry__.py``), kept here because the port
reads no YAML. ``FLAGSHIP_TRAIN`` adds what the flagship's final
purification phase trained with: the YAML's training fields and the run's
HSIC overrides (``demo_artifacts/round5/v4purify_run/run_metadata.json``).
``tests/test_torch_port_slice.py`` and
``tests/test_torch_port_train_modules.py`` hold both equal to those files.
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
