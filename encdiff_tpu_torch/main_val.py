"""Train and score the stage-2 LDM: the port's ``main_val.py``.

    python -m encdiff_tpu_torch.main_val -b flagship -t --max_steps N \
        [--resume_ckpt <npz>] [-r <logdir>] [--device cpu] [key=value ...]

``-b flagship`` is ``configs/demo/synthetic-shapes-v4-full-encdiff.yaml``
(``configs.FLAGSHIP_RUN``); ``-b <cfg>.json`` reads a config nested as the
YAML is. See ``train/harness.py``.
"""

from encdiff_tpu_torch.train.harness import main

if __name__ == "__main__":
    main()
