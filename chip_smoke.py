#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``encdiff_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

``--out`` (``build/`` by default) takes the harness phases' run
directories, the eval's 38.4 MB of reps among them. Phases, one line each
with its wall time; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi). No CUDA: fail.
2. build: the five CUDA sources with nvcc into ``build/``, all at once;
   then mma-rate: independent chains of mma.sync.m16n8k8 (tf32) on every
   SM (``csrc/mma_probe.cu``), at 1 to 4 warps a sub-partition: cycles per
   mma per sub-partition and the TF32 TFLOP/s they imply, the rate the
   3xTF32 kernels' design bounds assume to be 495 TFLOP/s.
3. shapes: the flagship checkpoint, 8 rendered inputs folded into the 160
   swap samples; one UNet ε call and one VQ decode at B = 160 record every
   kernel call's shape (the 16 cross-attention sites on ``fused_attention``,
   the self-attention on ``attention_core``), and the first UNet call on
   the kernel path is held against the same call on the plain PyTorch
   path.
4. kernels: each kernel against its plain version at every shape of phase
   3, timed with CUDA events beside the plain version, one PyTorch library
   call and the card's bound.
5. main path: one swap request, B = 8, 160 samples, DDIM 200, eta 0, with
   the launch counters set to 0 just before it and read just after.
6. reference: a 10-step chain and a decode, kernel path against plain path.
7. profile: one UNet call's device time by kernel (torch.profiler).

The flagship's stage-2 train step, B = 128, from the same checkpoint through
``encdiff_tpu_torch.train_steps``:

8. train-shapes: hooks record the shape of every forward and backward
   kernel call of one forward + backward.
9. train-kernels: both backward kernels (and the forward kernels at the
   train step's shapes) against their plain versions at every recorded
   shape, timed beside the plain version, the autograd backward of one
   PyTorch library call and the card's bound.
10. train: 40 steps on batches of the v4 renderer's 4,096-image grid, with
    the launch counters set to 0 just before and read just after: ms per
    step, peak memory, losses; every trainable leaf and the EMA must move.
11. train-reference: one forward + backward on the same batch, t and noise
    on the kernel path and on the plain path: loss, every gradient leaf and
    the new batch statistics.
12. train-profile: one train step's device time by kernel (torch.profiler).

The training harness (``python -m encdiff_tpu_torch.main_val``) on the
flagship YAML at full width, on the whole 480,000-image v4 grid:

harness-data: the grid rendered on the host, its bytes held to the JAX
renderer's digest, uploaded as uint8 (the harness keeps it on the card for
the phases after it): seconds of each, peak memory.
harness-eval: a ``Trainer`` restored from the committed checkpoint runs
``test()``: the Encoder4 sweep over the grid (seconds, images/s) and the
whole battery, DCI's gradient-boosted trees and beta-VAE's logistic
regression on the card at the full tier (seconds per metric); it fails
unless FactorVAE is 1.0 with 20 dims, MIG within 0.01 of the checkpoint's
recorded 0.17347, DCI disentanglement within 1e-3 of 0.990158 and beta-VAE
1.0. The same reps at the fast tier on the card (seconds per metric), and
its DCI on the host CPU from the same global seed: the card's D, C,
informativeness and importance matrix within DCI_CARD_TOL and
DCI_IMPORTANCE_TOL of the CPU's. The reps are written under ``--out``.
harness-train: ``main_val.main`` trains 20 steps from the checkpoint with
the image logger every 20 steps (DDIM 50), the launch counters set to 0
just before and read just after, then ``main_val.main -r`` resumes from its
``last`` checkpoint for 10 steps and ends in ``test()``: the latent cache
of each fit, ms per step on cached latents, peak memory. Hooks record the
shape of every kernel call of the first run's latent encode (chunks of
2,048), of its first step and of its image logs; each kernel is held
against its plain version at each of those shapes, and its launches must
equal 20 steps' plus the encode's plus the logs'. The last chunk of the
run's latents is held against the plain path's encode of the same rows, and
the first step's loss against the plain path's on the same batch, t and
noise. After the 20 steps the fit's epoch-end validation (fast tier)
feeds the run's checkpoints as ``fit()`` does (an epoch of the grid is
3,750 steps): it must write a ``best_dci_*`` checkpoint. It fails unless
these, the image logs, the checkpoint files, the resumed run's step, AdamW
count, LR and EMA, and the validation's and test()'s five ``val/*`` keys
(finite) are as expected. The other EncDiff chains' runs score FactorVAE
and MIG only (``UNCHECKED_METRICS``).

The VQ-GAN first-stage trainer (``main_val -b flagship_vq``: the flagship's
VQ config at full width, LPIPS, the PatchGAN and the adaptive GAN weight)
on the same grid, from the harness's seeded fresh init:

vq-shapes: hooks record every kernel call, forward and backward, of one
train step at B = 128, of one eval batch and of one image log of 8.
vq-kernels: every kernel at each of those shapes against its plain version,
timed beside it, the library call (SDPA and its autograd backward, the
GroupNorm chain and its autograd backward) and the card's bound, and the
VQ first stage's other backward shapes: ``gn_silu_bwd`` without FiLM at a
256x256 level (B = 32, on clusters of 4) and ``attention_core_bwd`` at
(160, 1, 256, 256, 128).
vq-train: ``main_val.main`` trains 40 steps with the image logger's warm-up
logs and ends in ``test()`` over 4 validation batches, the launch counters
set to 0 just before and read just after: launches must equal 40 steps',
6 image logs' and 4 eval batches'; both Adam counts 40; every generator and
discriminator leaf moved; ``compact_last.npz`` and ``test_results.json``
finite. ms per step (each step timed on its own, synchronised), peak
memory.
vq-reference: one generator and one discriminator pass on the first batch
at the run's starting weights, kernel path against plain path: every
logged value and the discriminator's loss to 1e-5 relative, every
generator gradient leaf to 1e-3 relative L2; the code indices that differ
are counted, and where any do the kernel path quantizes with the plain
path's.
vq-profile: one train step's device time by kernel.

The MCL fine-tune (``main_val -b flagship_mcl``: ``infonce_mechgrad`` at
λ 0.05 from the committed checkpoint, the MCL heads from the seeded fresh
init) on the same grid:

mcl-shapes: hooks record every kernel call of one step at B = 128, the
second order included (``gn_silu_bwd_bwd``, and the attention VJP, which is
PyTorch ops and no kernel of the port).
mcl-kernels: every kernel at each of those shapes against its plain
version, ``gn_silu_bwd_bwd`` against autograd of the plain backward and
the attention VJP against autograd of ``attention_core_bwd_plain``, timed
beside the library's double backward (the GroupNorm chain's; SDPA's on its
math backend) and the bound.
mcl-train: ``main_val.main`` trains MCL_STEPS steps on cached latents and
ends in ``test()`` with the swap-visualization grids (DDIM 50, not the
config's 200: SWAP_DDIM), the counters set to 0 just before and read just after: launches must equal the steps', the
latent encode's and the swap visualization's recorded calls; in the first
step the critic's four weights have finite nonzero gradients and its six
MCL_EXACT_ZERO leaves exactly zero ones; every other leaf moves; the
checkpoint, test_results.json and the grids exist. ms per step, peak
memory, the losses.
mcl-reference: the kernel path against the plain path at the run's start
on the same batch, z, t and noise: every logged value to 1e-5 and every
trainable leaf to 1e-3 relative L2 (the L1-sign guard at the UNet output
and the forced-code rule as in train- and vq-reference; the critic's image
ReLU masks of the plain path where a pre-activation lies within 1e-5 of its
layer's largest from zero, at most 16 a run), for
``infonce_mechgrad`` at B = 128 and ``nce_logistic``, ``denoise_sm`` and
``jacobian_vjp_infonce`` at B = 16.
mcl-profile: one MCL step's device time by kernel.

The fisher_sm cell of the MCL sweep (``main_val -b flagship_mcl
model.params.mcl_type=fisher_sm model.params.lambda_mcl=0.01``), whose
Hutchinson divergence differentiates the decoder's score once more: a
third order through the frozen decoder, on the same grid:

mcl-fisher-shapes: hooks record every kernel call of one step at B = 128,
the third order's included (``gn_silu_bwd3``, and the attention VJP calls
that autograd records, whose backward is PyTorch ops); peak memory.
mcl-fisher-kernels: every kernel at each of those shapes against its plain
version, ``gn_silu_bwd3`` against autograd of the plain backward recorded
twice and beside autograd's triple backward of the GroupNorm chain, the
attention's third order against the plain route's and beside SDPA's
(math backend) triple backward.
mcl-fisher-train: ``main_val.main`` trains FISHER_STEPS steps and ends in
``test()``, with mcl-train's checks: launches equal to the recorded calls,
no plain call, the critic's gradients, every leaf moves but the exact
zeros and the projection heads fisher_sm does not use; ms per step, peak.
mcl-fisher-reference: the kernel path against the plain path at B = 16 on
the run's first batch, z, t, noise and an injected ε, with mcl-reference's
rules and tolerances.
mcl-fisher-profile: one fisher_sm step's device time by kernel.

The faces VQ-GAN first stage (``main_val -b faces_vq``: 256 px, micro-batch
8 with 4-way accumulation, LPIPS, the PatchGAN and the adaptive GAN weight)
on the full 34,560-image face grid, from the harness's seeded fresh init;
its mid blocks run the flash forward, dq and dk/dv at (8, 1, 4096, 128):

faces-vq-shapes: the grid rendered (its masks on the host, its colour
blocks on the card; the first block held byte for byte against numpy's),
uploaded as uint8 in place of the flagship grid; hooks record every kernel
call of one micro-step, of one eval batch and of one image log of 8.
faces-vq-kernels: every kernel at each of those shapes against its plain
version, timed beside it, the library call and the card's bound.
faces-vq-train: ``main_val.main`` trains FACES_VQ_MICRO_STEPS micro-steps
(4 updates) with the image logger's warm-up logs and ends in ``test()``
over 4 validation batches, the launch counters set to 0 just before and
read just after: launches must equal the micro-steps', 5 image logs' and 4
eval batches', with no plain call; both Adam counts 4; parameters move on
every 4th micro-step and on no other, and every generator and
discriminator leaf has moved by the end; ``compact_last.npz`` and
``test_results.json`` finite. The render's seconds, ms per micro-step and
per update, peak memory.
faces-vq-reference: vq-reference's checks at the run's starting weights on
its first micro-batch of 8, with the adaptive weight's two gradients also
started from the plain path's at the decoder's output and a 1e-6 absolute
floor beside 1e-5 on the logs (FACES_VQ_LOG_ATOL). Two witnesses are
printed: the plain path (no kernel) on the kernel path's reconstruction,
and on its differences from the plain one shuffled over the pixels.
faces-vq-profile: one update's device time by kernel, and its busy share
(the union of the kernels' intervals over the wall).

The faces configuration's stage-2 train step (256 px images, 64x64 latents,
micro-batch 8, 4-way accumulation) from a fresh seeded init, through the
same entry points:

13. faces-shapes: hooks record every forward and backward kernel call of
    one micro-step; the flash kernels run at the UNet's 64² and 32² levels
    and in the VQ encoder's mid block.
14. faces-kernels: the three flash kernels (forward, dq, dk/dv) against
    their plain versions at every recorded shape, and the four earlier
    kernels at the faces shapes they had not seen, timed beside the plain
    version, the PyTorch library call, ``attention_core`` (the flash
    kernels' baseline) and the card's bound.
15. faces-train: 12 optimizer updates (48 micro-batches) on the face
    renderer's 512-image sub-grid, with the launch counters set to 0 just
    before and read just after; AdamW may move only on every 4th
    micro-batch, the EMA on every one.
16. faces-reference: one forward + backward at micro-batch 2, kernel path
    against plain path.
17. faces-profile: one optimizer update's device time by kernel.

The faces configuration's serving paths, as the faces eval chain
(``scripts/round3_faces_eval.sh``) runs them, from a fresh seeded init with
every trainable leaf redrawn (a fresh init's zero output convolutions would
make ε identically zero):

18. faces-serve-shapes: every kernel call of one UNet call and one 256 px
    decode at each batch the serving paths run: 32 (the swap's chunk), 16
    (its last chunk) and 64 (the FID batch); the first UNet ε at B = 32 on
    the kernel path against the plain path; peak memory of the UNet call
    and of the decode at B = 32.
19. faces-serve-kernels: every kernel at every shape of phase 18 against
    its plain version (rows of earlier phases reused), timed beside the
    plain version, the PyTorch library call and the bound;
    ``fused_attention`` also beside the chain it replaces (``nn.Linear`` x3,
    ``attention_core``, ``nn.Linear``), whose SDPA form is its library call.
20. faces-serve: one swap request, 4 rendered faces -> 80 samples, DDIM 50,
    eta 0 (UNet chunks of 32, 32 and 16, a decode of each), with the launch
    counters set to 0 just before and read just after.
21. faces-serve-reference: 10-step chains of 20 samples at eta 0 (and its
    decode) and at eta 1 (the FID's, with injected noise), kernel path
    against plain path.
22. faces-fid: 64 rendered faces against 64 reconstructions (DDIM 50, eta
    1, one batch of 64), Inception features on the card: the uncalibrated
    FID, with the launch counters read around the sampling.
23. faces-serve-profile: one UNet call at B = 32, device time by kernel.

The faces EncDiff stage and its eval chain, as ``scripts/round3_pipeline.sh``
stages 3 and 3b run them, over the faces VQ-GAN run of faces-vq-train:

faces-harness: ``main_val -b faces -t --max_steps 8`` (two updates of 4
micro-steps of 8) with the pipeline's override
``model.params.first_stage_config.params.ckpt_path=<faces VQ-GAN
run>/checkpoints/last`` and the image logger forced to the last
micro-step, on the full face grid (uploaded again) with its latents cached
(chunks of 128 through the VQ encoder, whose mid block runs the flash
forward at (128, 1, 4096, 128)), the launch counters set to 0 just before
and read just after: launches must equal the micro-steps', the latent
encode's and the image log's recorded calls. The first stage must be the
VQ-GAN run's generator with the 20 widened input rows of
``post_quant_conv`` at the seeded init; the cached latents must match a
direct encode of 128 sampled rows (1e-5) and the scale factor the first
micro-batch's; the parameters may move on the 4th and 8th micro-steps only,
AdamW must step every leaf twice, with an exp_avg equal (1e-4 of each
leaf's norm) to that of the 8 micro-steps run again through
``loop.train_step`` outside the harness on the same batches and draws,
and the EMA must move
from the 4th on; the LR
is 4 x 8 x 2e-6 = 6.4e-5 times the warm-up; ``last`` restored by ``-r``
must equal the run's state bit for bit; ``test()`` writes ``{}`` (no
validation metrics). Every kernel at every recorded shape against its
plain version. Upload, latent-cache and image-log seconds, ms per
micro-step and update, peak memory.
faces-eval: ``python -m encdiff_tpu_torch.faces_eval -r <that run>/
checkpoints/last --tad_num 512 --fid_num 64`` (DDIM 50; the port
of ``scripts/round3_faces_eval.sh``): ``tad`` on an eval file of 512
faces, ``fid --num 64`` (eta 1; real rows drawn from the full grid) and
``generate_swap --config faces --num_samples 4``, each CLI with its
launches equal to its recorded calls, and every kernel at every recorded
shape against its plain version; the chain's walls.

The MPI3D and Cars3D chains, with each pipeline's own commands
(``scripts/round4b_pipeline.sh:107-116``: Cars3D, the EncDiff stage with
the HSIC overrides; ``scripts/round5_pipeline.sh:187-200``: MPI3D) cut only
in --max_steps and the VQ-GAN's --val_batches, at the flagship's full width
on the full grids:

cars3d-vq: ``main_val -b cars3d_vq -t -s 23 -n carsvq`` on the 17,568-image
grid (the train view repeated ten times an epoch), 8 steps, the image log
forced to the last, ``test()`` over 2 validation batches, the launch
counters set to 0 just before and read just after: launches must equal the
recorded calls of the steps, the image log and the eval batches; Adam
counts, ``last``, the train and validation views on one device array.
cars3d-harness: ``main_val -b cars3d -t -s 23 -n carsld`` with the HSIC
overrides over that run's ``last``: the latent cache of 17,568, 8 steps,
the image log forced to the last (DDIM 50 on 8 with the swap rows, so
``fused_attention`` runs), ``test()`` (the sweep of all 17,568 rows,
FactorVAE and MIG on the ``cars3d`` table), then ``-r`` and its ``test()``:
launches equal to the recorded calls; the first stage the VQ-GAN run's;
one device array for both views; the latents cached once and equal to a
direct encode of 256 rows; the first batch the device path's epoch order
with the x10 repeat folded; ``-r`` bit for bit and the same reps.
mpi3d-shapes: the 1,036,800-image MPI3D grid, its geometry with numpy on
the host and its 648 blocks composed on the card, where it stays (12.74
GB); its first 9 blocks (every camera height and background) byte for byte
against numpy's; geometry, upload and composition seconds, the card's
memory.
mpi3d-vq, mpi3d-harness: as the Cars3D phases (``-n mpivq``; ``-n mpild
--max_epochs 5 --check_val_every_n_epoch 2``), on the grid resident on the
card, its latents (3.19 GB) cached once a fit, the sweep over 1,036,800
rows and FactorVAE and MIG on the ``mpi3d`` table.
Every kernel of these runs is held against its plain version at every
shape they run.

The rest of the shapes family (v1, v2, v3 and the bands control), at the
flagship's widths:

shapes-render: the v1 and bands grids of 27,648 images and the v1, v2, v3
and bands grids of 480,000, each rendered on the host (one 480,000-image
grid held at a time) and held to the sha256 digest of the JAX renderer's
bytes (SHAPES_DIGESTS; harness-data holds the v4 grid to its own); the
seconds of each.
shapes-vq, shapes-harness: the v1 chain, as the Cars3D phases: ``main_val
-b shapes_vq`` (the VQ-GAN without LPIPS) for 8 steps, an image log and
``test()`` over 2 batches, then ``-b shapes`` over its ``last``: the latent
cache of 27,648, 8 steps, an image log, ``test()`` (FactorVAE and MIG on
the 27,648-row ``synthetic_shapes`` table) and ``-r``.
shapes-mcl-shapes, shapes-mcl, shapes-mcl-reference: ``main_val -b
shapes_mcl`` (the whole ``synthetic-shapes-mcl.yaml`` on the v1 grid)
over that run's ``last`` (``--resume_ckpt``, the first stage's override):
every kernel call of one step at B = 128 against its plain version, the
run of SHAPES_MCL_STEPS steps and ``test()`` with the swap visualization
under mcl-train's checks, and the kernel path against the plain path on
its first batch under mcl-reference's.
bands_control-vq, bands_control-harness: the bands-control chain (``-b
bands_control_vq``, then ``-b bands_control``) on the 480,000-image bands
grid, as the v1 chain but with no EncDiff image log (NO_LOG), its latents
of 480,000 cached once.

Then one JSON line of kernels, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.

The five 3xTF32 kernels (the flash forward, dq and dk/dv,
``attention_core``'s forward and ``fused_attention``) carry, beside the
fp32 CUDA-core bound of the others, their design's bound: the largest of
bytes, three tf32 passes of their products at the dense TF32 peak (tc),
their exponentials at the SFU's rate at the SM clock nvidia-smi reads (exp)
and, for ``fused_attention``, its attention's CUDA-core FLOPs (simt). ``attention_core`` and
``groupnorm_silu`` are also timed on device time, from the replay of a CUDA
graph of back-to-back calls (the host's share left out), beside their
library call timed the same way; so are the flash kernels at a shape where
a launch takes under 0.05 ms. After each phase that checks them, one line
per redesigned kernel counts the shapes where it is no slower than its
library yardstick (SDPA; its autograd backward, which gives dq, dk and dv
together, for each flash backward kernel; for ``fused_attention`` the faster
of its chain and its SDPA chain; for ``groupnorm_silu`` the PyTorch
GroupNorm chain).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
from concurrent.futures import ThreadPoolExecutor
import copy
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from encdiff_tpu_torch import faces_eval
from encdiff_tpu_torch import fid as fid_cli
from encdiff_tpu_torch import generate_swap, main_val
from encdiff_tpu_torch import tad as tad_cli
from encdiff_tpu_torch import train_steps
from encdiff_tpu_torch.configs import FACES, FACES_TRAIN, FLAGSHIP_TRAIN
from encdiff_tpu_torch.core.schedules import DDIMSchedule
from encdiff_tpu_torch.data import (synthetic_faces, synthetic_mpi3d,
                                    synthetic_shapes)
from encdiff_tpu_torch.data.datasets import RENDER_THREADS
from encdiff_tpu_torch.data.synthetic_shapes import (
    FACTOR_SIZES, FULL_FACTOR_SIZES, TRAIN_GRID, SyntheticShapes3DV4FullTrain,
    epoch_batches, render_all_v4)
from encdiff_tpu_torch.evalx import fid as fid_lib
from encdiff_tpu_torch.evalx.eval_driver import eval_func
from encdiff_tpu_torch.evalx.ground_truth.named_data import get_index_dataset
from encdiff_tpu_torch.evalx.swap import (TOKEN_BUDGET, swap_conditions,
                                          swap_sample)
from encdiff_tpu_torch.generate_swap import pick_inputs
from encdiff_tpu_torch.models.autoencoder import generator_state
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.nn import attention as port_attention
from encdiff_tpu_torch.nn import layers as port_layers
from encdiff_tpu_torch.nn import vae as port_vae
from encdiff_tpu_torch.nn.kernels import attention as kattn
from encdiff_tpu_torch.nn.kernels import build, plain_path
from encdiff_tpu_torch.nn.kernels import flash_attention as kflash
from encdiff_tpu_torch.nn.kernels import groupnorm_silu as kgn
from encdiff_tpu_torch.nn.kernels.attention import (
    attention_core, attention_core_bwd, attention_core_bwd_plain,
    attention_core_plain)
from encdiff_tpu_torch.nn.kernels.flash_attention import (
    flash_attention_dkdv, flash_attention_dkdv_plain, flash_attention_dq,
    flash_attention_dq_plain, flash_attention_fwd, flash_attention_fwd_plain)
from encdiff_tpu_torch.nn.kernels.fused_attention import (
    fused_attention, fused_attention_plain)
from encdiff_tpu_torch.nn.kernels.attention import attention_core_bwd_vjp
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import (
    gn_silu_bwd3, gn_silu_bwd_bwd, groupnorm_silu, groupnorm_silu_bwd3_plain,
    groupnorm_silu_bwd_bwd_plain, groupnorm_silu_bwd_plain,
    groupnorm_silu_plain, gn_silu_bwd)
from encdiff_tpu_torch.train import callbacks as port_callbacks
from encdiff_tpu_torch.train import harness, vq_trainer
from encdiff_tpu_torch.train.callbacks import make_grid
from encdiff_tpu_torch.train.checkpoint_io import MODEL_FILE, STATE_FILE
from encdiff_tpu_torch.train.loop import (create_train_state,
                                          draw_t_and_noise, loss_and_grads,
                                          precompute_latents,
                                          trainable_parameters, train_step)

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "demo_artifacts/round5/v4purify_final_fp16.npz")
SEED = 42
NUM_INPUTS = 8
DDIM_STEPS = 200
TRAIN_BATCH = 128
# The LR warmup restarts at 1e-6 of its peak with the fresh optimizer: a
# weight near 1 moves in fp32 only once the LR has grown for some tens of
# steps (at 22 steps some norm weights had not moved in a B = 8 CPU run).
TRAIN_STEPS = 40  # ms per step: the median, and the mean, of the steps after the first two
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 CUDA-core FLOP/s
# and dense TF32 tensor-core FLOP/s; the SFU's exponentials per SM and clock
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
EXP_PER_SM_CLOCK = 16
# the most bytes of scores the plain flash forward holds at once: above it,
# it runs over slices of the batch (every (b, h) is independent), so that
# the FID batch's (64, 8, 4096, 8) fits beside its (B, H, N, N) exponentials
PLAIN_SCORE_BYTES = 2 ** 32
# below this event time a launch is also timed on device time (CUDA-graph
# replays): under it, back-to-back event timing reads the wrapper's host time
GRAPH_BELOW_MS = 0.05
# the mma-rate probe: (warps per SM sub-partition, independent chains a
# warp) for each run, mma.sync.m16n8k8 per chain, and the FLOPs of one
MMA_PROBE_RUNS = ((1, 1), (1, 4), (1, 8), (2, 4), (4, 2), (4, 4), (4, 8))
MMA_PROBE_ITERS = 8192
MMA_FLOPS = 2 * 16 * 8 * 8
# kernel vs plain version at one shape: fp32 sums in another order
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
# a whole UNet call / a 10-step chain / a decode / new batch statistics,
# kernel path vs plain path
PATH_TOL = dict(rtol=1e-3, atol=1e-3)
# a train step's loss, and each gradient leaf, kernel path vs plain path,
# to GRAD_RTOL relative L2. A leaf whose exact gradient is zero (a bias that
# feeds a BatchNorm: Encoder4's seven conv biases) holds only rounding and
# is checked apart, as in the CPU whole-step test: its gradient must stay
# within GRAD_ZERO of the global gradient norm on both paths.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
GRAD_ZERO = 1e-6
# the leaves whose exact gradient is zero: Encoder4's conv biases that feed
# a BatchNorm; no other leaf may be set apart
EXACT_ZERO = {"cond.conv1.bias", "cond.conv2.bias", "cond.conv3.bias",
              "cond.conv4.bias", "cond.res1.conv1.bias", "cond.res1.conv2.bias",
              "cond.res2.conv1.bias"}
# the kernel path runs twice on the same inputs: its run-to-run spread;
# three draws of t and noise, so that a run is likely to meet an L1 sign
# that differs between the paths (reference_check)
REFERENCE_REPEATS = 2
#: mcl_compare's ReLU guard: where a pre-activation of the critic's image
#: ReLUs changes sign between the plain and the kernel path, the held runs
#: take the plain path's value if its magnitude is at most RELU_BAND times
#: the largest of its layer's call, and at no more than RELU_CAP of them a
#: run; a flip farther from zero, or more of them, is a fault. The
#: H100 runs guarded 0-5 a run, the farthest 3.2e-7 of its layer's largest
#: (a few fp32 ulps of it)
RELU_BAND = 1e-5
RELU_CAP = 16
REFERENCE_DRAWS = 3
# the faces train step: 12 optimizer updates of 4 micro-batches of 8; the
# reference check at micro-batch 2 (the plain backward at 8 would hold about
# five (64, 4096, 4096) fp32 score tensors at once)
FACES_UPDATES = 12
FACES_REFERENCE_BATCH = 2
# faces serving as the eval chain runs it: a swap of 4 inputs at DDIM 50,
# eta 0; FID on one batch of 64 at DDIM 50, eta 1
FACES_INPUTS = 4
FACES_DDIM_STEPS = 50
FACES_FID_NUM = 64
FACES_REFERENCE_SAMPLES = 20
# the harness on the flagship: 20 steps with the image logger every 20 (one
# log: the run's time limit holds the MPI3D and Cars3D phases too), then
# a run resumed from the checkpoint that saved at 20, to 30; the metric
# gates of the committed checkpoint at step 97,500: FactorVAE 1.0 with 20
# dims and MIG 0.17347 (demo_artifacts/round5/v4purify_run/97500.json),
# within 0.01 since the reps come from the H100's fp32 and not the TPU's
HARNESS_STEPS = 20
HARNESS_RESUMED_STEPS = 30
HARNESS_LOG_EVERY = 20
#: cuts for the run's time limit: the bands-control chain logs no EncDiff
#: images (the v1 chain's log runs its shapes); the other EncDiff image logs
#: (harness-train, the cross-dataset chains) and the MCL runs' swap
#: visualizations sample at DDIM 50, not 200: the same kernel shapes, a
#: quarter of the UNet calls (with the bands cut alone the whole run took
#: 1,198.9 s on an H100 80GB HBM3 at 700 W behind a slow host)
LOG_DDIM = "lightning.callbacks.image_logger.params.log_images_kwargs." \
    "ddim_steps=50"
NO_LOG = "lightning.callbacks.image_logger.params.disabled=true"
SWAP_DDIM = "lightning.callbacks.swap_visualization.params.ddim_steps=50"
#: rows a chunk of the harness's latent encode (train.loop.precompute_latents)
LATENT_CHUNK = 2048
MIG_TARGET = 0.17347
MIG_TOL = 0.01
#: the committed checkpoint's DCI disentanglement: sklearn's score of the
#: card's reps of step 97,500 (0.990158, PR 12; the TPU's 0.990160); the
#: port's full tier on the card, from the global seed SEED, within DCI_TOL
DCI_TARGET = 0.990158
DCI_TOL = 1e-3
#: the card's fast tier against the port's on the host CPU, the same reps
#: and global seed. Where sklearn decides a tie between features by rounding
#: (a split that isolates an extreme sample under several features, or one
#: of the codes that carry the same factor), the card's parallel sums,
#: torch's exp and the matmul leaf sums decide it otherwise, as another
#: global seed does in sklearn. On the committed checkpoint's reps (PR 20
#: call 1): card against CPU D 2.2e-4, C 1.34e-3, informativeness 1.3e-4,
#: an importance entry 0.0706 (between codes that carry one factor); on the
#: CPU the port equals sklearn there at seed 42, and sklearn's own moved
#: D 5.0e-4, C 1.3e-4 and an importance entry 0.0591 between seeds 42-44
DCI_CARD_TOL = 5e-3
DCI_IMPORTANCE_TOL = 0.15
#: the chains whose DCI and beta-VAE this script does not check score
#: FactorVAE and MIG only (each test() would add a full-tier DCI)
UNCHECKED_METRICS = ("--eval_metrics", "MIG,factor_VAE")
#: the val/* keys of the default battery
BATTERY_KEYS = ["val/beta_vae", "val/dci_completeness",
                "val/dci_disentanglement", "val/factor_vae_score", "val/mig"]
LOG_KEYS = ("inputs", "reconstruction", "conditioning", "diffusion_row",
            "samples", "samples_swapping")
#: backward shapes of the VQ first stage outside the flagship VQ-GAN step,
#: checked in vq-kernels beside it: GN-SiLU without FiLM at a 256x256 level
#: (the faces VQ's decoder), and the mid block's attention (one head of 128)
#: over 16x16 latents at B = 160
VQ_BWD_SHAPES = {"gn_silu_bwd": [((32, 32, 256, 256), 1e-6, False)],
                 "attention_core_bwd": [(160, 1, 256, 256, 128)]}
#: the VQ-GAN trainer on the flagship's VQ config (-b flagship_vq), from the
#: harness's seeded fresh init: 40 steps at B = 128 (the image logger's
#: warm-up logs at steps 1, 2, 4, 8, 16 and 32), then test() over
#: VQ_VAL_BATCHES validation batches; the harness's default seed
VQ_STEPS = 40
VQ_VAL_BATCHES = 4
VQ_SEED = 23
VQ_LOG_STEPS = (1, 2, 4, 8, 16, 32)
#: the VQ generator's leaves whose exact gradient is zero at the flagship
#: width: the keys' biases (softmax is shift-invariant in each query's
#: logits), and the biases at the 32-channel levels that reach only
#: GroupNorms of one channel a group (and, in the decoder, conv_out after
#: one): their gradients are rounding. The faces VQ has the same layout (ch
#: 32, ch_mult (1, 2, 4), 2 res blocks) at 256 px, so the same leaves
VQ_EXACT_ZERO = {
    "encoder.mid_attn_1.k.bias", "decoder.mid_attn_1.k.bias",
    "encoder.down_0_block_0.conv1.bias", "encoder.down_0_block_1.conv1.bias",
    *(f"decoder.up_0_block_{i}.conv{j}.bias" for i in range(3)
      for j in (1, 2)),
    "decoder.up_0_block_0.nin_shortcut.bias"}
#: the faces VQ-GAN first stage (-b faces_vq: 256 px, micro-batch 8, 4-way
#: accumulation) on the full 34,560-image face grid, from the seeded fresh
#: init: FACES_VQ_MICRO_STEPS micro-steps (4 updates; the image logger's
#: warm-up logs at 1, 2, 4, 8 and 16), then test() over
#: FACES_VQ_VAL_BATCHES validation batches
FACES_VQ_MICRO_STEPS = 16
FACES_VQ_VAL_BATCHES = 4
FACES_VQ_LOG_STEPS = (1, 2, 4, 8, 16)
#: faces-vq-reference's rules beside vq-reference's. At 256 px the fresh
#: reconstruction meets the L1's and the PatchGAN's LeakyReLU kinks within
#: the two paths' rounding at thousands of points (5,552 signs of the
#: gradient at the decoder's output differ, 206 at the flagship's 64 px),
#: and the adaptive weight, a ratio of two gradient norms taken through
#: them, moved by 7e-4: its two gradients start from the plain path's too.
#: The GAN term's logs (g_loss, logits_fake) are means of PatchGAN logits
#: that sit near 0 there (-0.043, against 1.72 at the flagship): they get
#: the absolute floor of 1e-6 that the CPU tests of the VQ losses take
#: (tests/test_torch_vq_modules.py) beside LOSS_RTOL
FACES_VQ_LOG_ATOL = 1e-6
#: the MCL fine-tune (-b flagship_mcl) from the committed checkpoint with
#: its seeded fresh heads: MCL_STEPS steps at B = 128 on cached latents,
#: then test(); the other first- and second-order types held kernel path
#: against plain path at B = MCL_TYPES_BATCH
#: the faces EncDiff stage behind ``main_val -b faces`` (faces-harness):
#: two updates of 4 micro-steps of 8 over the faces VQ-GAN run's
#: ``checkpoints/last``, the image log forced to the last micro-step; the
#: latent cache held against a direct encode of LATENT_ROWS sampled rows
FACES_LDM_MICRO_STEPS = 8
FACES_LDM_SEED = 23
FACES_LDM_LR = 6.4e-5  # accumulate 4 x micro-batch 8 x base LR 2e-6
FACES_LATENT_ROWS = 128
LATENT_TOL = dict(rtol=1e-5, atol=1e-5)
#: the eval chain on that run's ``checkpoints/last`` (faces-eval): TAD on an
#: eval file of FACES_TAD_NUM faces, FID of FACES_EVAL_FID_NUM in batches of
#: 64, the swap of FACES_INPUTS faces; DDIM 50 (``faces_eval``'s)
FACES_TAD_NUM = 512
FACES_EVAL_FID_NUM = 64  # one batch: the time limit holds the later phases
MCL_STEPS = 20
MCL_TYPES = ("nce_logistic", "denoise_sm", "jacobian_vjp_infonce")
MCL_TYPES_BATCH = 16
#: the fisher_sm cell of the repo's MCL sweep (configs/mcl/
#: mpi3d-mcl-fisher-lambda001.yaml's type and lambda) on -b flagship_mcl:
#: a third order through the frozen decoder; FISHER_STEPS steps of the run,
#: the kernel path held against the plain path at B = MCL_TYPES_BATCH
FISHER_OVERRIDES = ("model.params.mcl_type=fisher_sm",
                    "model.params.lambda_mcl=0.01")
FISHER_STEPS = 8
#: the critic's leaves that the mechanism gradient g = d/dz sum critic
#: reaches only through a ReLU's mask (zero derivative): their exact
#: gradient is zero in infonce_mechgrad (in JAX too), and AdamW's decay alone
#: moves them, by lr·1e-2 a step, under fp32's resolution during the warmup;
#: the other four critic leaves reach g through the decoder's second order
MCL_EXACT_ZERO = {"mcl.critic.img_conv1.bias", "mcl.critic.img_conv2.bias",
                  "mcl.critic.z_fc.bias", "mcl.critic.u_fc.weight",
                  "mcl.critic.u_fc.bias", "mcl.critic.out.bias"}
#: the MPI3D and Cars3D chains: each pipeline's own commands
#: (``scripts/round4b_pipeline.sh:107-116``, the Cars3D EncDiff stage with
#: its HSIC overrides; ``scripts/round5_pipeline.sh:187-200``, MPI3D) with
#: only --max_steps and the VQ-GAN's --val_batches cut, at full width on the
#: full grids; the latent cache held against a direct encode of
#: CROSS_LATENT_ROWS sampled rows; ``kgen`` offsets the kernel checks' seed;
#: ``log`` holds the EncDiff run's image-logger overrides
CROSS_SEED = 23
CROSS_VQ_STEPS = 8
CROSS_VQ_VAL_BATCHES = 2
CROSS_LDM_STEPS = 8
CROSS_LATENT_ROWS = 256
CROSS = {
    "cars3d": dict(vq=["-n", "carsvq"],
                   ldm=["-n", "carsld", "model.params.indep_type=hsic",
                        "model.params.lambda_indep=2.0"], kgen=11,
                   log=[LOG_DDIM]),
    "mpi3d": dict(vq=["-n", "mpivq"],
                  ldm=["-n", "mpild", "--max_epochs", "5",
                       "--check_val_every_n_epoch", "2"], kgen=13,
                  log=[LOG_DDIM]),
}
#: the rest of the shapes family: the v1 chain (``-b shapes_vq``, then ``-b
#: shapes`` over its ``last``) and the bands-control chain at 480,000
#: images (``-b bands_control_vq``, ``-b bands_control``)
CROSS.update({
    "shapes": dict(vq=["-n", "shapesvq"], ldm=["-n", "shapesld"], kgen=15,
                   log=[LOG_DDIM]),
    "bands_control": dict(vq=["-n", "bandsvq"], ldm=["-n", "bandsld"],
                          kgen=17, log=[NO_LOG]),
})
#: ``-b shapes_mcl`` over the v1 chain's EncDiff run: SHAPES_MCL_STEPS steps
#: and test() with the swap visualization
SHAPES_MCL_STEPS = 8
#: the grids shapes-render renders, in order, and the two it leaves in the
#: renderer's cache for the chains: the v1 grid, and the bands grid at
#: 480,000, rendered last so that one 480,000-image grid is on the host at
#: a time
SHAPES_RENDERS = (("v1", FACTOR_SIZES), ("bands", FACTOR_SIZES),
                  ("v1", FULL_FACTOR_SIZES), ("v2", FULL_FACTOR_SIZES),
                  ("v3", FULL_FACTOR_SIZES), ("bands", FULL_FACTOR_SIZES))
SHAPES_KEPT = {("v1", tuple(FACTOR_SIZES)),
               ("bands", tuple(FULL_FACTOR_SIZES))}
#: rows a chunk of ``grid_digest``
DIGEST_ROWS = 4096
#: ``grid_digest`` of each grid of the shapes family at 64 px, from the JAX
#: package's renderers (``tests/test_torch_shapes_digests.py`` derives them
#: again): (renderer, factor sizes) -> hex digest
SHAPES_DIGESTS = {
    ("v1", tuple(FACTOR_SIZES)):
        "e8a050c11b723aee4db93db21b936ee812d4daeb22e508eaf8a24d7183b209f9",
    ("bands", tuple(FACTOR_SIZES)):
        "a9f5be039f3468f9d7591e72847a7c7045a82924dcdd460f8f70f6b25dc0f9d7",
    ("v1", tuple(FULL_FACTOR_SIZES)):
        "99fe4cde49a2d83a84c56ee9fa86a5e8077a3e80260ef92f514753f8dde47a7a",
    ("v2", tuple(FULL_FACTOR_SIZES)):
        "70ab4f528fff8040da491bb719bd304a97470c193c44f2782e32390acf4307ea",
    ("v3", tuple(FULL_FACTOR_SIZES)):
        "3135b99611f8496af305b8e1d60bb57dbc1b23d2bb17a0f027fd0960e18a7dec",
    ("bands", tuple(FULL_FACTOR_SIZES)):
        "569f0d22af8c5b63e18890747d143fd7182463926fa9e4d3641b7e0ad23730be",
    ("v4", tuple(FULL_FACTOR_SIZES)):
        "aa61855207576968a278e8b46b21e90419e292120b2655f7c6fa2796fd89e434",
}
KERNELS = {
    "groupnorm_silu": dict(
        source="encdiff_tpu_torch/csrc/groupnorm_silu.cu",
        replaces="encdiff_tpu/nn/pallas/groupnorm_silu.py:62"),
    "attention_core": dict(
        source="encdiff_tpu_torch/csrc/attention_core.cu",
        replaces="encdiff_tpu/nn/pallas/attention.py:113"),
    "attention_core_bwd": dict(
        source="encdiff_tpu_torch/csrc/attention_core.cu",
        replaces="encdiff_tpu/nn/pallas/attention.py:156"),
    "gn_silu_bwd": dict(
        source="encdiff_tpu_torch/csrc/groupnorm_silu.cu",
        replaces="no Pallas counterpart; XLA VJP at "
                 "encdiff_tpu/nn/pallas/groupnorm_silu.py:113"),
    "flash_attention_fwd": dict(
        source="encdiff_tpu_torch/csrc/flash_attention.cu",
        replaces="encdiff_tpu/nn/pallas/flash_attention.py:129"),
    "flash_attention_dq": dict(
        source="encdiff_tpu_torch/csrc/flash_attention.cu",
        replaces="encdiff_tpu/nn/pallas/flash_attention.py:187"),
    "flash_attention_dkdv": dict(
        source="encdiff_tpu_torch/csrc/flash_attention.cu",
        replaces="encdiff_tpu/nn/pallas/flash_attention.py:211"),
    "fused_attention": dict(
        source="encdiff_tpu_torch/csrc/fused_attention.cu",
        replaces="encdiff_tpu/nn/pallas/attention.py:66"),
    "gn_silu_bwd_bwd": dict(
        source="encdiff_tpu_torch/csrc/groupnorm_silu.cu",
        replaces="no TPU kernel: XLA's autodiff of the VJP at "
                 "encdiff_tpu/nn/pallas/groupnorm_silu.py:113"),
    "gn_silu_bwd3": dict(
        source="encdiff_tpu_torch/csrc/groupnorm_silu.cu",
        replaces="no TPU kernel: XLA's third-order autodiff of the VJP at "
                 "encdiff_tpu/nn/pallas/groupnorm_silu.py:113"),
}
FLASH = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkdv")
WRAPPERS = {"groupnorm_silu": groupnorm_silu, "attention_core": attention_core,
            "attention_core_bwd": attention_core_bwd,
            "gn_silu_bwd": gn_silu_bwd,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_dq": flash_attention_dq,
            "flash_attention_dkdv": flash_attention_dkdv,
            "fused_attention": fused_attention,
            "gn_silu_bwd_bwd": gn_silu_bwd_bwd, "gn_silu_bwd3": gn_silu_bwd3}
#: what each kernel's baseline column times: the route it replaces at the
#: same shape
BASELINE = {"flash_attention_fwd": "attention_core_ms",
            "flash_attention_dq": "attention_core_ms",
            "flash_attention_dkdv": "attention_core_ms",
            "fused_attention": "chain_ms"}


#: kernels every profile lists, in the top 12 or not: the redesigned
#: kernels of attention_core and groupnorm_silu, forward and backward
PROFILE_ALWAYS = ("attn_core_mma_kernel", "gn_silu_fwd_kernel",
                  "attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel",
                  "gn_silu_bwd_kernel", "gn_silu_bwd_bwd_kernel",
                  "gn_silu_bwd3_kernel")


def mma_rate(card):
    """The mma-rate probe (``csrc/mma_probe.cu``): independent chains of
    mma.sync.m16n8k8 (tf32 in, fp32 accumulators) on register operands, one
    block on each SM. Returns one row per run of ``MMA_PROBE_RUNS``: warps
    per SM sub-partition, chains a warp, SM cycles per mma per sub-partition
    (the median block's clock64 span over the mma one sub-partition
    issued), the dense TF32 TFLOP/s that rate gives on every sub-partition
    at ``card``'s highest clock, the TFLOP/s the whole launch reached on
    event time, and the SM clock (MHz) it ran at (clocks over event
    time)."""
    import ctypes
    fn = build.load("mma_probe").tf32_mma_probe
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    blocks, rows = card["sms"], []
    stream = torch.cuda.current_stream().cuda_stream
    for warps, chains in MMA_PROBE_RUNS:
        threads = 4 * 32 * warps  # four sub-partitions an SM
        cycles = torch.zeros(blocks, dtype=torch.int64, device="cuda")
        sink = torch.empty(blocks * threads, device="cuda")
        run = lambda: fn(blocks, threads, chains, MMA_PROBE_ITERS,
                         cycles.data_ptr(), sink.data_ptr(), stream)
        if run():  # warm-up
            raise RuntimeError("tf32_mma_probe: launch refused")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = run()
        end.record()
        end.synchronize()
        if rc or not torch.isfinite(sink).all():
            raise RuntimeError(f"tf32_mma_probe: rc {rc} or non-finite sums")
        ms = start.elapsed_time(end)
        span = cycles.double().median().item()
        per_mma = span / (MMA_PROBE_ITERS * chains * warps)
        total = blocks * threads // 32 * MMA_PROBE_ITERS * chains * MMA_FLOPS
        rows.append(dict(
            warps=warps, chains=chains, cycles_per_mma=per_mma,
            tflops_at_clock=4 * blocks * card["sm_hz"] * MMA_FLOPS / per_mma
            / 1e12, tflops_events=total / (ms * 1e-3) / 1e12,
            mhz=span / (ms * 1e3)))
    return rows


def grid_digest(images) -> str:
    """sha256 over the sha256 digests of consecutive chunks of DIGEST_ROWS
    rows of a uint8 grid (the chunks hashed on RENDER_THREADS host
    threads): a digest of every byte in row order."""
    images = np.ascontiguousarray(images)

    def chunk(i):
        return hashlib.sha256(
            images[i * DIGEST_ROWS:(i + 1) * DIGEST_ROWS].data).digest()

    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        parts = list(pool.map(chunk, range(-(-len(images) // DIGEST_ROWS))))
    return hashlib.sha256(b"".join(parts)).hexdigest()


def phase(name, t0, msg):
    print(f"[{name}] {time.perf_counter() - t0:.3f}s {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def sm_clocks_mhz():
    """(current, highest) SM clock of card 0 in MHz, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    now, top = (float(v) for v in out[0].split(","))
    return now, top


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, stream=None) -> float:
    """Device time per call of ``fn``: CUDA events around one replay of a
    CUDA graph of ``reps`` back-to-back calls, captured after a warm-up
    call (on ``stream``, if given). The host's share (Python, the wrapper,
    the launch) is left out, which back-to-back event timing (``time_ms``)
    shows below about 0.05 ms a call."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def backward_times(forward, leaves, grad):
    """(event ms, device ms) of the autograd backward of ``forward(leaves)``
    for the cotangent ``grad``: a library call's gradients, timed as
    ``time_ms`` and ``graph_ms`` time a kernel. The backward runs on the
    stream its forward ran on, so both run on one side stream, which the
    graph's capture uses."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward(*leaves)
        backward = lambda: torch.autograd.grad(out, leaves, grad,
                                               retain_graph=True)
        times = time_ms(backward), graph_ms(backward, stream=side)
    torch.cuda.current_stream().wait_stream(side)
    return times


def record_shapes(model):
    """Forward pre-hooks that record, per kernel, the shape of every call
    one forward pass makes. Returns (records, remove)."""
    records = {"groupnorm_silu": [], "attention_core": [],
               "flash_attention_fwd": [], "fused_attention": []}

    def attn(b, h, n, m, dh):  # the routing of nn.attention.attention
        if port_attention.takes_flash(n, m):
            records["flash_attention_fwd"].append((b, h, n, dh))
        else:
            records["attention_core"].append((b, h, n, m, dh))

    def gn_hook(mod, args):
        x = args[0]
        film = len(args) > 1 and args[1] is not None
        records["groupnorm_silu"].append((tuple(x.shape), mod.eps, film))

    def xattn_hook(mod, args, kwargs):  # the routing of CrossAttention
        x = args[0]
        ctx = kwargs.get("context", args[1] if len(args) > 1 else None)
        if mod.takes_fused(x, ctx):
            records["fused_attention"].append(
                (*x.shape[:2], x.shape[2], *ctx.shape[1:], mod.heads,
                 mod.dim_head))
            return
        m = x.shape[1] if ctx is None else ctx.shape[1]
        attn(x.shape[0], mod.heads, x.shape[1], m, mod.dim_head)

    def attnblock_hook(mod, args):
        b, c, h, w = args[0].shape
        attn(b, 1, h * w, h * w, c)

    handles = []
    for mod in model.modules():
        if isinstance(mod, port_layers.GNSiLU):
            handles.append(mod.register_forward_pre_hook(gn_hook))
        elif isinstance(mod, port_attention.CrossAttention):
            handles.append(mod.register_forward_pre_hook(xattn_hook,
                                                         with_kwargs=True))
        elif isinstance(mod, port_vae.AttnBlock):
            handles.append(mod.register_forward_pre_hook(attnblock_hook))
    return records, lambda: [h.remove() for h in handles]


def gn_cost(shape, film):
    """(bytes, fp32 operations) of one groupnorm_silu call: x read and out
    written once, gamma/beta and the FiLM rows read once; per element two
    statistics passes (add; sub, mul, add), normalise and affine (sub, mul,
    mul, add), FiLM (add, mul, add) and SiLU (exp, add, div)."""
    b, c, h, w = shape
    n = b * c * h * w
    nbytes = 4 * (2 * n + 2 * c + (2 * b * c if film else 0))
    return nbytes, n * (4 + 4 + (3 if film else 0) + 3)


def attn_cost(b, h, n, m, dh):
    """(bytes, fp32 operations): q, k, v read and out written once; the two
    products (2 * n * m * dh each) and the softmax (max, sub, exp, add per
    score)."""
    bh = b * h
    return 4 * bh * dh * (2 * n + 2 * m), bh * (4 * n * m * dh + 4 * n * m)


def attn_bwd_work(b, h, n, m, dh):
    """(product FLOPs, exponentials) of one attention_core_bwd call: five
    products of 2 N M dh FLOPs per (batch, head) (q kᵀ, dO vᵀ, Pᵀ dO, dS k,
    dSᵀ q) and one exponential per score: what the function needs, not the
    recomputations of the kernels' design."""
    bh = b * h
    return 10 * bh * n * m * dh, bh * n * m


def attn_bwd_cost(b, h, n, m, dh):
    """(bytes, fp32 operations) of one attention_core_bwd call: q, k, v and
    dO read and dq, dk, dv written once; five products (q kᵀ and dO vᵀ
    recomputed, Pᵀ dO, dS k, dSᵀ q; 2 * n * m * dh each) and per score the
    recomputed softmax (scale, sub, exp) and dS (sub, mul, mul)."""
    bh = b * h
    return (4 * bh * dh * (3 * n + 4 * m),
            bh * (10 * n * m * dh + 6 * n * m))


def gn_bwd_cost(shape, film):
    """(bytes, fp32 operations) of one gn_silu_bwd call: x and the gradient
    read and dx written once, gamma/beta read and their gradients written,
    the FiLM rows read and their gradients written; per element the
    statistics (4), normalise and affine (4), FiLM (3), sigmoid (3), the
    SiLU gradient (5), dy (1), four channel sums (6), dxn and two group
    sums (4) and dx (4)."""
    b, c, h, w = shape
    n = b * c * h * w
    nbytes = 4 * (3 * n + 4 * c + (4 * b * c if film else 0))
    return nbytes, n * (4 + 4 + (3 if film else 0) + 3 + 5 + 1 + 6 + 4 + 4)


def gn_bwd_bwd_cost(shape, params):
    """(bytes, fp32 operations) of one gn_silu_bwd_bwd call without FiLM:
    x, the gradient g and the cotangent u read and dg and dx written once
    (the cotangents of dgamma and dbeta read, their gradients written, with
    ``params``); per element the statistics (4), the first pass's xn, a,
    sigmoid, silu' and five sums (3 + 3 + 4 + 10), the second pass's xn, a,
    sigmoid, silu', silu'', dy, ut, h, e, Gx and two sums (3 + 3 + 4 + 6 +
    2 + 3 + 4 + 2 + 6 + 4, with two channel sums 4 more) and dx (5)."""
    b, c, h, w = shape
    n = b * c * h * w
    nbytes = 4 * (5 * n + 2 * c + (4 * c if params else 0))
    return nbytes, n * (4 + 20 + 37 + (4 if params else 0) + 5)


def gn_bwd3_cost(shape):
    """(bytes, fp32 operations) of one gn_silu_bwd3 call: x, the gradient
    g and the cotangents u and c read, dg and dx written once, gamma and
    beta read; per element the statistics (4), the first pass's xn and four
    sums (2 + 8), the second pass's xn, a, SiLU's three derivatives, ut, ct,
    W1, W2 and six sums (2 + 1 + 14 + 6 + 7 + 12), the third pass's xn, a,
    the derivatives, ut, ct, W1, W2, dg, Gx and three sums (2 + 1 + 14 + 6
    + 7 + 12 + 26 + 6) and dx (5)."""
    b, c, h, w = shape
    n = b * c * h * w
    return 4 * (6 * n + 2 * c), n * (4 + 10 + 42 + 74 + 5)


def attn_vjp_work(b, h, n, m, dh):
    """(fp32 FLOPs, exponentials) of one attention_core_bwd_vjp call: twelve
    products of 2 N M dh FLOPs per (batch, head) (q kᵀ, do vᵀ, dq_bar kᵀ,
    q dk_barᵀ, do dv_barᵀ, S̄ k, dS dk_bar, S̄ᵀ q, dSᵀ dq_bar, dP̄ᵀ do, dP̄ v,
    P dv_bar), about twenty elementwise operations per score, and one
    exponential per score."""
    bh = b * h
    return bh * (24 * n * m * dh + 20 * n * m), bh * n * m


def attn_vjp3_cost(b, h, n, m, dh):
    """(bytes, fp32 operations) of autograd's backward of one recorded
    attention_core_bwd_vjp call (the attention's third order): its seven
    inputs and four cotangents read and seven gradients written once; two
    products for each of the VJP's twelve, and about forty elementwise
    operations per score."""
    bh = b * h
    return (4 * bh * dh * (11 * n + 11 * m),
            bh * (48 * n * m * dh + 40 * n * m))


def attn_vjp_cost(b, h, n, m, dh):
    """(bytes, fp32 operations) of one attention_core_bwd_vjp call: q, k,
    v, do and the three cotangents read and four gradients written once;
    ``attn_vjp_work``'s operations."""
    bh = b * h
    return 4 * bh * dh * (4 * n + 7 * m), attn_vjp_work(b, h, n, m, dh)[0]


def flash_cost(name, b, h, n, dh):
    """(bytes, fp32 operations) of one flash kernel call: its inputs read
    and outputs written once (q, k, v, o, dO, dq, dk, dv (B, H, N, dh); lse,
    delta (B, H, N)); per score one exponential and 2 dh operations per
    product: q kᵀ and P v in the forward; q kᵀ, dO vᵀ and dS k for dq;
    q kᵀ, dO vᵀ, Pᵀ dO and dSᵀ q for dk/dv."""
    bh = b * h
    tensors, stats, products = {"flash_attention_fwd": (4, 1, 2),
                                "flash_attention_dq": (5, 2, 3),
                                "flash_attention_dkdv": (6, 2, 4)}[name]
    return (4 * bh * n * (tensors * dh + stats),
            bh * n * n * (2 * dh * products + 1))


def attn_core_work(b, h, n, m, dh):
    """(product FLOPs, exponentials) of one attention_core forward: q kᵀ
    and P v, 2 N M dh FLOPs each per (batch, head), and one exponential per
    score."""
    bh = b * h
    return 4 * bh * n * m * dh, bh * n * m


def flash_fwd_work(b, h, n, dh):
    """(product FLOPs, exponentials) of one flash forward: q kᵀ and P v,
    2 N² dh FLOPs each per (batch, head), and one exponential per score."""
    bh = b * h
    return 4 * bh * n * n * dh, bh * n * n


def flash_bwd_work(name, b, h, n, dh):
    """(product FLOPs, exponentials) of one flash backward call: per (batch,
    head) 2 N² dh FLOPs per product, three for dq (q kᵀ, dO vᵀ, dS k) and
    four for dk/dv (k qᵀ, v dOᵀ, Pᵀ dO, dSᵀ q), and one exponential per
    score."""
    products = {"flash_attention_dq": 3, "flash_attention_dkdv": 4}[name]
    bh = b * h
    return 2 * products * bh * n * n * dh, bh * n * n


def fused_work(b, n, c, m, d, h, dh):
    """(tensor-core FLOPs, CUDA-core FLOPs, exponentials) of one
    fused_attention call (C_out = C): the four weight products (2 B N C HD,
    4 B M D HD, 2 B N HD C) on the tensor cores; the attention's two
    products and its softmax (4 B N M HD + 4 B H N M) on the CUDA cores;
    one exponential per score."""
    hd = h * dh
    return (2 * b * n * c * hd + 4 * b * m * d * hd + 2 * b * n * hd * c,
            4 * b * n * m * hd + 4 * b * h * n * m, b * h * n * m)


def design_bounds(products, exps, sms, sm_hz, simt=0):
    """(tc_ms, exp_ms, simt_ms): the least times of a 3xTF32 kernel's parts
    on a card of ``sms`` SMs whose highest SM clock is ``sm_hz``: three tf32
    passes of its products at the dense TF32 peak, its exponentials at the
    SFU's rate, and its CUDA-core FLOPs at the fp32 peak."""
    return (3 * products / PEAK_TF32 * 1e3,
            exps / (EXP_PER_SM_CLOCK * sms * sm_hz) * 1e3,
            simt / PEAK_FP32 * 1e3)


def bound(row):
    """A checked row's least time (ms): bytes against operations at the
    fp32 CUDA-core peak, or for the 3xTF32 kernels (rows with tc_ms)
    bytes against each part of the design's work."""
    if "tc_ms" in row:
        return max(row["bytes_ms"], row["tc_ms"], row["exp_ms"],
                   row.get("simt_ms", 0.0))
    return max(row["bytes_ms"], row["ops_ms"])


def fused_cost(b, n, c, m, d, h, dh):
    """(bytes, fp32 operations) of one fused_attention call (C_out = C): x,
    ctx, the four weights and the bias read and y written once; the four
    projections (2 B N C HD, 4 B M D HD, 2 B N HD C), the two attention
    products (4 B N M HD) and the softmax (max, sub, exp, add per score)."""
    hd = h * dh
    nbytes = 4 * (2 * b * n * c + b * m * d + 2 * c * hd + 2 * d * hd + c)
    ops = (2 * b * n * c * hd + 4 * b * m * d * hd + 4 * b * n * m * hd
           + 2 * b * n * hd * c + 4 * b * h * n * m)
    return nbytes, ops


def check_fused(shape, gen, card):
    """Check and time fused_attention at (B, N, C, M, D, H, dh) on the call
    site's layout (transposed nn.Linear weights), beside its plain version,
    the chain it replaces on the route (nn.Linear x3, attention_core,
    nn.Linear) and the same chain with SDPA, the library call. ``card``
    holds the SM count and clock of the design bound."""
    b, n, c, m, d, h, dh = shape
    hd = h * dh
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x, ctx = rand(b, n, c), rand(b, m, d)
    lin_q, lin_k, lin_v = (rand(hd, cin) * cin ** -0.5 for cin in (c, d, d))
    lin_o, bo = rand(c, hd) * hd ** -0.5, 0.1 * rand(c)
    args = (x, ctx, lin_q.t(), lin_k.t(), lin_v.t(), lin_o.t(), bo)
    kernel = lambda: fused_attention(*args, heads=h, dim_head=dh)
    plain = lambda: fused_attention_plain(*args, heads=h, dim_head=dh)

    def chain(attn):
        q = F.linear(x, lin_q).view(b, n, h, dh).transpose(1, 2)
        k = F.linear(ctx, lin_k).view(b, m, h, dh).transpose(1, 2)
        v = F.linear(ctx, lin_v).view(b, m, h, dh).transpose(1, 2)
        o = attn(q, k, v, scale=dh ** -0.5)
        return F.linear(o.transpose(1, 2).reshape(b, n, hd), lin_o, bo)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **KERNEL_TOL)
    torch.testing.assert_close(chain(attention_core), ref, **KERNEL_TOL)
    nbytes, ops = fused_cost(*shape)
    products, simt, exps = fused_work(*shape)
    tc_ms, exp_ms, simt_ms = design_bounds(products, exps, simt=simt, **card)
    return dict(err=(out - ref).abs().max().item(), ms=time_ms(kernel),
                plain_ms=time_ms(plain),
                library_ms=time_ms(
                    lambda: chain(F.scaled_dot_product_attention)),
                baseline_ms=time_ms(lambda: chain(attention_core)),
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3,
                tc_ms=tc_ms, exp_ms=exp_ms, simt_ms=simt_ms)


def check_flash(name, shape, gen, card):
    """Check and time one flash kernel at (B, H, N, dh) on the callers'
    layout, beside its plain version, SDPA (forward; its autograd backward,
    which gives dq, dk and dv together, for the two backward kernels) and
    attention_core / attention_core_bwd at the same shape. ``card`` holds
    the SM count and clock of the forward's design bound."""
    b, h, n, dh = shape
    q, k, v, do = (torch.randn(b, n, h, dh, generator=gen,
                               device="cuda").transpose(1, 2)
                   for _ in range(4))
    scale = dh ** -0.5
    if name == "flash_attention_fwd":
        kernel = lambda: flash_attention_fwd(q, k, v, scale)
        step = max(1, PLAIN_SCORE_BYTES // (4 * h * n * n))

        def plain():
            if step >= b:
                return flash_attention_fwd_plain(q, k, v, scale)
            parts = [flash_attention_fwd_plain(q[i:i + step], k[i:i + step],
                                               v[i:i + step], scale)
                     for i in range(0, b, step)]
            return tuple(torch.cat(t) for t in zip(*parts))
        library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
        baseline = lambda: attention_core(q, k, v, scale)
    else:
        o, lse = flash_attention_fwd_plain(q, k, v, scale)
        delta = (do * o).sum(dim=-1).contiguous()
        args = (q, k, v, do, lse, delta, scale)
        fn, plain_fn = {
            "flash_attention_dq": (flash_attention_dq,
                                   flash_attention_dq_plain),
            "flash_attention_dkdv": (flash_attention_dkdv,
                                     flash_attention_dkdv_plain)}[name]
        kernel = lambda: fn(*args)
        plain = lambda: plain_fn(*args)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        library = lambda: torch.autograd.grad(out, leaves, do,
                                              retain_graph=True)
        baseline = lambda: attention_core_bwd(q, k, v, do, scale)
    got, ref = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **KERNEL_TOL)
    err = max((a - r).abs().max().item() for a, r in zip(got, ref))
    del got, ref
    nbytes, ops = flash_cost(name, *shape)
    row = dict(err=err, ms=time_ms(kernel), plain_ms=time_ms(plain, 5),
               library_ms=time_ms(library), baseline_ms=time_ms(baseline, 5),
               bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3)
    work = (flash_fwd_work(*shape) if name == "flash_attention_fwd"
            else flash_bwd_work(name, *shape))
    tc_ms, exp_ms, _ = design_bounds(*work, **card)  # all three are 3xTF32
    row.update(tc_ms=tc_ms, exp_ms=exp_ms)
    if row["ms"] < GRAPH_BELOW_MS:  # event timing reads the wrapper's host time
        row["device_ms"] = graph_ms(kernel)
    return row


def check_gn(shape, eps, film, gen):
    b, c, h, w = shape
    dev = "cuda"
    x = torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    beta = 0.2 * torch.randn(c, generator=gen, device=dev)
    sc = 0.2 * torch.randn(b, c, generator=gen, device=dev) if film else None
    sh = 0.2 * torch.randn(b, c, generator=gen, device=dev) if film else None

    kernel = lambda: groupnorm_silu(x, gamma, beta, sc, sh, eps=eps)
    plain = lambda: groupnorm_silu_plain(x, gamma, beta, sc, sh, eps=eps)

    def library():
        y = F.group_norm(x, 32, gamma, beta, eps)
        if film:
            y = y * (1.0 + sc[:, :, None, None]) + sh[:, :, None, None]
        return F.silu(y)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **KERNEL_TOL)
    nbytes, ops = gn_cost(shape, film)
    plan = kgn.gn_silu_plan(b, c, h * w, 32, torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin)
    return dict(err=(out - ref).abs().max().item(), ms=time_ms(kernel),
                plain_ms=time_ms(plain), library_ms=time_ms(library),
                device_ms=graph_ms(kernel), library_device_ms=graph_ms(library),
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3,
                path=f"{plan.per_block} a block" if plan.cluster == 1
                else f"cluster of {plan.cluster}")


def check_attn(shape, gen, card):
    b, h, n, m, dh = shape
    # the callers' layout: (B, L, H, dh) projections viewed as (B, H, L, dh)
    q = torch.randn(b, n, h, dh, generator=gen, device="cuda").transpose(1, 2)
    k = torch.randn(b, m, h, dh, generator=gen, device="cuda").transpose(1, 2)
    v = torch.randn(b, m, h, dh, generator=gen, device="cuda").transpose(1, 2)
    scale = dh ** -0.5
    kernel = lambda: attention_core(q, k, v, scale)
    plain = lambda: attention_core_plain(q, k, v, scale)
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **KERNEL_TOL)
    nbytes, ops = attn_cost(*shape)
    tc_ms, exp_ms, _ = design_bounds(*attn_core_work(*shape), **card)
    return dict(err=(out - ref).abs().max().item(), ms=time_ms(kernel),
                plain_ms=time_ms(plain), library_ms=time_ms(library),
                device_ms=graph_ms(kernel), library_device_ms=graph_ms(library),
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3,
                tc_ms=tc_ms, exp_ms=exp_ms)


def check_gn_bwd_bwd(shape, eps, params, gen):
    """Check and time gn_silu_bwd_bwd at x's shape (with the gradients of
    gamma and beta where ``params``) beside its plain version (autograd of
    the plain backward) and autograd's double backward of the GroupNorm
    chain (F.group_norm, F.silu), on event time and on device time
    (CUDA-graph replays)."""
    b, c, h, w = shape
    dev = "cuda"
    x = torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    beta = 0.2 * torch.randn(c, generator=gen, device=dev)
    g, du = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
    bars = (dict(dgamma_bar=torch.randn(c, generator=gen, device=dev),
                 dbeta_bar=torch.randn(c, generator=gen, device=dev))
            if params else {})
    kw = dict(eps=eps, param_grads=params, **bars)
    kernel = lambda: gn_silu_bwd_bwd(du, g, x, gamma, beta, **kw)
    plain = lambda: groupnorm_silu_bwd_bwd_plain(du, g, x, gamma, beta, **kw)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    pairs = [(a, r) for a, r in zip(got, ref) if r is not None]
    for a, r in pairs:
        torch.testing.assert_close(a, r, **KERNEL_TOL)
    err = max((a - r).abs().max().item() for a, r in pairs)
    del got, ref, pairs
    nbytes, ops = gn_bwd_bwd_cost(shape, params)
    plan = kgn.gn_silu_bwd_bwd_plan(b, c, h * w, 32, torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin)
    # the library's second order: the GroupNorm chain's backward recorded
    # (create_graph) and differentiated against the same cotangents
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().requires_grad_() for t in (x, gamma, beta)]
        gl = g.detach().requires_grad_()
        y = F.silu(F.group_norm(leaves[0], 32, leaves[1], leaves[2], eps))
        first = torch.autograd.grad(y, leaves, gl, create_graph=True)
        outs, cots = ([first[0]], [du]) if not params else (
            list(first), [du, bars["dgamma_bar"], bars["dbeta_bar"]])
        library = lambda: torch.autograd.grad(
            outs, [gl, *leaves[:1 + 2 * params]], cots, retain_graph=True)
        library_ms = time_ms(library)
        library_device_ms = graph_ms(library, stream=side)
    torch.cuda.current_stream().wait_stream(side)
    return dict(err=err, ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=library_ms, device_ms=graph_ms(kernel),
                library_device_ms=library_device_ms,
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3,
                path=f"{plan.per_block} a block" if plan.cluster == 1
                else f"cluster of {plan.cluster}")


def check_gn_bwd3(shape, eps, gen):
    """Check and time gn_silu_bwd3 at x's shape beside its plain version
    (autograd of the plain backward, recorded twice) and autograd's triple
    backward of the GroupNorm chain (F.group_norm, F.silu) for the same
    gradients (of the double backward's dx, in g and x), on event time and
    on device time (CUDA-graph replays)."""
    b, c, h, w = shape
    dev = "cuda"
    x = torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    beta = 0.2 * torch.randn(c, generator=gen, device=dev)
    g, du, dx_bar = (torch.randn(shape, generator=gen, device=dev)
                     for _ in range(3))
    kernel = lambda: gn_silu_bwd3(du, dx_bar, g, x, gamma, beta, eps=eps)
    plain = lambda: groupnorm_silu_bwd3_plain(du, dx_bar, g, x, gamma, beta,
                                              eps=eps)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **KERNEL_TOL)
    err = max((a - r).abs().max().item() for a, r in zip(got, ref))
    del got, ref
    nbytes, ops = gn_bwd3_cost(shape)
    plan = kgn.gn_silu_bwd3_plan(b, c, h * w, 32, torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin)
    # the library's third order: the GroupNorm chain's backward and double
    # backward recorded (create_graph), then differentiated once more
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xl, gl = x.detach().requires_grad_(), g.detach().requires_grad_()
        y = F.silu(F.group_norm(xl, 32, gamma, beta, eps))
        first, = torch.autograd.grad(y, xl, gl, create_graph=True)
        second, = torch.autograd.grad(first, xl, du, create_graph=True)
        library = lambda: torch.autograd.grad(second, (gl, xl), dx_bar,
                                              retain_graph=True)
        library_ms = time_ms(library)
        library_device_ms = graph_ms(library, stream=side)
    torch.cuda.current_stream().wait_stream(side)
    return dict(err=err, ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=library_ms, device_ms=graph_ms(kernel),
                library_device_ms=library_device_ms,
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3,
                path=f"{plan.per_block} a block" if plan.cluster == 1
                else f"cluster of {plan.cluster}")


def check_attn_vjp3(shape, gen):
    """Check and time the attention's third order on the kernel route:
    autograd's backward of a recorded ``attention_core_bwd_vjp`` (PyTorch
    ops, no kernel of the port), against the plain route's (autograd of the
    plain backward, recorded twice), beside SDPA's (math backend) triple
    backward, on event time; the fp32 bound of its products."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    b, h, n, m, dh = shape
    lengths = (n, m, m, n, n, m, m)
    ins = [torch.randn(b, h, length, dh, generator=gen, device="cuda")
           for length in lengths]
    cots = [torch.randn(b, h, length, dh, generator=gen, device="cuda")
            for length in (n, m, m, n)]
    scale = dh ** -0.5
    calls = attention_core_bwd_vjp.calls
    leaves = [t.detach().requires_grad_() for t in ins]
    outs = attention_core_bwd_vjp(*leaves, scale)
    fn = lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True)
    pl = [t.detach().requires_grad_() for t in ins]
    second = torch.autograd.grad(attention_core_bwd_plain(*pl[:4], scale),
                                 pl[:4], pl[4:], create_graph=True)
    plain = lambda: torch.autograd.grad(second, pl, cots, retain_graph=True)
    got, ref = fn(), plain()
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **KERNEL_TOL)
    err = max((a - r).abs().max().item() for a, r in zip(got, ref))
    del got, ref
    with sdpa_kernel(SDPBackend.MATH):
        sl = [t.detach().requires_grad_() for t in ins]
        first = torch.autograd.grad(
            F.scaled_dot_product_attention(*sl[:3], scale=scale), sl[:3],
            sl[3], create_graph=True)
        lib2 = torch.autograd.grad(first, sl[:4], sl[4:], create_graph=True)
        library = lambda: torch.autograd.grad(lib2, sl, cots,
                                              retain_graph=True)
        library_ms = time_ms(library)
    nbytes, ops = attn_vjp3_cost(*shape)
    row = dict(err=err, ms=time_ms(fn), plain_ms=time_ms(plain),
               library_ms=library_ms, bytes_ms=nbytes / PEAK_BYTES * 1e3,
               ops_ms=ops / PEAK_FP32 * 1e3)
    attention_core_bwd_vjp.calls = calls  # timing calls are not the path's
    return row


def check_attn_vjp(shape, gen):
    """Check and time attention_core_bwd_vjp (PyTorch ops, no kernel of
    the port) at (B, H, N, M, dh) against autograd of the plain backward
    (its plain version), beside autograd's double backward of SDPA on its
    math backend (the fused backends have no double backward), on event
    time; the fp32 bound of its products."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    b, h, n, m, dh = shape
    q, k, v, do, dq_bar, dk_bar, dv_bar = (
        torch.randn(b, h, length, dh, generator=gen, device="cuda")
        for length in (n, m, m, n, n, m, m))
    scale = dh ** -0.5
    fn = lambda: attention_core_bwd_vjp(q, k, v, do, dq_bar, dk_bar, dv_bar,
                                        scale)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, do)]
    outs = attention_core_bwd_plain(*leaves, scale)
    plain = lambda: torch.autograd.grad(outs, leaves,
                                        (dq_bar, dk_bar, dv_bar),
                                        retain_graph=True)
    got, ref = fn(), plain()
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **KERNEL_TOL)
    err = max((a - r).abs().max().item() for a, r in zip(got, ref))
    del got, ref
    with sdpa_kernel(SDPBackend.MATH):
        sl = [t.detach().requires_grad_() for t in (q, k, v)]
        dl = do.detach().requires_grad_()
        first = torch.autograd.grad(
            F.scaled_dot_product_attention(*sl, scale=scale), sl, dl,
            create_graph=True)
        library = lambda: torch.autograd.grad(
            first, [*sl, dl], (dq_bar, dk_bar, dv_bar), retain_graph=True)
        library_ms = time_ms(library)
    nbytes, ops = attn_vjp_cost(*shape)
    calls = attention_core_bwd_vjp.calls
    row = dict(err=err, ms=time_ms(fn), plain_ms=time_ms(plain),
               library_ms=library_ms, bytes_ms=nbytes / PEAK_BYTES * 1e3,
               ops_ms=ops / PEAK_FP32 * 1e3)
    attention_core_bwd_vjp.calls = calls  # timing calls are not the path's
    return row


def check_attn_bwd(shape, gen, card):
    """Check and time attention_core_bwd at (B, H, N, M, dh) on the callers'
    layout, beside its plain version and SDPA's autograd backward (which
    gives dq, dk and dv too), on event time and on device time (CUDA-graph
    replays), with the design bound on ``card``."""
    b, h, n, m, dh = shape
    # the callers' layout: (B, L, H, dh) buffers viewed as (B, H, L, dh);
    # dO arrives as the gradient of such a view
    q, k, v, do = (torch.randn(b, length, h, dh, generator=gen,
                               device="cuda").transpose(1, 2)
                   for length in (n, m, m, n))
    scale = dh ** -0.5
    kernel = lambda: attention_core_bwd(q, k, v, do, scale)
    plain = lambda: attention_core_bwd_plain(q, k, v, do, scale)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **KERNEL_TOL)
    err = max((a - r).abs().max().item() for a, r in zip(got, ref))
    del got, ref
    nbytes, ops = attn_bwd_cost(*shape)
    tc_ms, exp_ms, _ = design_bounds(*attn_bwd_work(*shape), **card)
    library_ms, library_device_ms = backward_times(
        lambda *a: F.scaled_dot_product_attention(*a, scale=scale),
        [t.detach().requires_grad_() for t in (q, k, v)], do)
    return dict(err=err, ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=library_ms, device_ms=graph_ms(kernel),
                library_device_ms=library_device_ms,
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3,
                tc_ms=tc_ms, exp_ms=exp_ms)


def check_gn_bwd(shape, eps, film, gen):
    """Check and time gn_silu_bwd at x's shape beside its plain version and
    the autograd backward of the GroupNorm chain (F.group_norm, the FiLM,
    F.silu), on event time and on device time (CUDA-graph replays)."""
    b, c, h, w = shape
    dev = "cuda"
    x = torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    beta = 0.2 * torch.randn(c, generator=gen, device=dev)
    sc = 0.2 * torch.randn(b, c, generator=gen, device=dev) if film else None
    sh = 0.2 * torch.randn(b, c, generator=gen, device=dev) if film else None
    g = torch.randn(shape, generator=gen, device=dev)
    kernel = lambda: gn_silu_bwd(g, x, gamma, beta, sc, sh, eps=eps)
    plain = lambda: groupnorm_silu_bwd_plain(g, x, gamma, beta, sc, sh, eps=eps)

    def library(x_, gamma_, beta_, *film_rows):
        y = F.group_norm(x_, 32, gamma_, beta_, eps)
        if film_rows:
            y = (y * (1.0 + film_rows[0][:, :, None, None])
                 + film_rows[1][:, :, None, None])
        return F.silu(y)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    pairs = [(a, r) for a, r in zip(got, ref) if r is not None]
    for a, r in pairs:
        torch.testing.assert_close(a, r, **KERNEL_TOL)
    err = max((a - r).abs().max().item() for a, r in pairs)
    del got, ref, pairs
    nbytes, ops = gn_bwd_cost(shape, film)
    plan = kgn.gn_silu_bwd_plan(b, c, h * w, 32, torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin)
    library_ms, library_device_ms = backward_times(
        library, [t.detach().requires_grad_() for t in (x, gamma, beta, sc, sh)
                  if t is not None], g)
    return dict(err=err, ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=library_ms, device_ms=graph_ms(kernel),
                library_device_ms=library_device_ms,
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3,
                path=f"{plan.per_block} a block" if plan.cluster == 1
                else f"cluster of {plan.cluster}")


@contextlib.contextmanager
def record_backward_shapes():
    """Hooks on the backward of the autograd Functions: every backward
    kernel call's shape, as ``check_*_bwd`` take it, and the second order's
    (``gn_silu_bwd_bwd``, and ``attention_core_bwd_vjp``, which is PyTorch
    ops) and the third order's (the kernels ``_GNSiLUBwdBwd``'s backward
    launches, and ``attention_core_bwd_vjp3``: the VJP calls that autograd
    records, whose backward is the attention's third order)."""
    records = {"attention_core_bwd": [], "gn_silu_bwd": [],
               "flash_attention_dq": [], "flash_attention_dkdv": [],
               "gn_silu_bwd_bwd": [], "attention_core_bwd_vjp": [],
               "gn_silu_bwd3": [], "attention_core_bwd_vjp3": []}
    attn_fn, gn_fn, flash_fn = (kattn._AttentionCore, kgn._GNSiLU,
                                kflash._FlashAttention)
    attn_bwd, gn_bwd, flash_bwd = (attn_fn.backward, gn_fn.backward,
                                   flash_fn.backward)
    gn2_fn, attn2_fn, gn3_fn = (kgn._GNSiLUBwd, kattn._AttentionCoreBwd,
                                kgn._GNSiLUBwdBwd)
    gn2_bwd, attn2_bwd, gn3_bwd = (gn2_fn.backward, attn2_fn.backward,
                                   gn3_fn.backward)

    def gn2_hook(ctx, *grads):
        x = ctx.saved_tensors[1]
        needs = ctx.needs_input_grad
        records["gn_silu_bwd_bwd"].append((tuple(x.shape), ctx.eps,
                                           bool(needs[2] or needs[3])))
        return gn2_bwd(ctx, *grads)

    def attn2_hook(ctx, *grads):
        q, k = ctx.saved_tensors[:2]
        key = (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3])
        records["attention_core_bwd_vjp"].append(key)
        if torch.is_grad_enabled():
            records["attention_core_bwd_vjp3"].append(key)
        return attn2_bwd(ctx, *grads)

    def gn3_hook(ctx, dg_bar, dx_bar):
        # the kernels _GNSiLUBwdBwd.backward launches, by the same rules
        shape = tuple(ctx.saved_tensors[2].shape)
        need_du, need_g, need_x = ctx.needs_input_grad[:3]
        if dg_bar is not None:
            if need_du:
                records["gn_silu_bwd"].append((shape, ctx.eps, False))
            if need_x:
                records["gn_silu_bwd_bwd"].append((shape, ctx.eps, False))
        if dx_bar is not None:
            if need_du:
                records["gn_silu_bwd_bwd"].append((shape, ctx.eps, False))
            if need_g or need_x:
                records["gn_silu_bwd3"].append((shape, ctx.eps))
        return gn3_bwd(ctx, dg_bar, dx_bar)

    def attn_hook(ctx, do):
        q, k, _ = ctx.saved_tensors
        records["attention_core_bwd"].append(
            (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
        return attn_bwd(ctx, do)

    def gn_hook(ctx, g):
        x, _, _, scale, _ = ctx.saved_tensors
        records["gn_silu_bwd"].append((tuple(x.shape), ctx.eps,
                                       scale is not None))
        return gn_bwd(ctx, g)

    def flash_hook(ctx, do):
        q = ctx.saved_tensors[0]
        for name in ("flash_attention_dq", "flash_attention_dkdv"):
            records[name].append(tuple(q.shape))
        return flash_bwd(ctx, do)

    fns = (attn_fn, gn_fn, flash_fn, gn2_fn, attn2_fn, gn3_fn)
    for fn, hook in zip(fns, (attn_hook, gn_hook, flash_hook, gn2_hook,
                              attn2_hook, gn3_hook)):
        fn.backward = staticmethod(hook)
    try:
        yield records
    finally:
        for fn, bwd in zip(fns, (attn_bwd, gn_bwd, flash_bwd, gn2_bwd,
                                 attn2_bwd, gn3_bwd)):
            fn.backward = staticmethod(bwd)


def check_rows(name, shapes, gen, card, seen=None):
    """Check and time kernel ``name`` at each distinct shape of ``shapes``;
    rows carry the shape and its number of calls. ``card`` holds the SM
    count and clock of the 3xTF32 kernels' design bound. ``seen`` maps
    (name, shape) to the row of an earlier phase, which is reused, not
    rerun."""
    check = {"groupnorm_silu": lambda key: check_gn(*key, gen),
             "attention_core": lambda key: check_attn(key, gen, card),
             "gn_silu_bwd": lambda key: check_gn_bwd(*key, gen),
             "attention_core_bwd": lambda key: check_attn_bwd(key, gen, card),
             "fused_attention": lambda key: check_fused(key, gen, card),
             "gn_silu_bwd_bwd": lambda key: check_gn_bwd_bwd(*key, gen),
             "gn_silu_bwd3": lambda key: check_gn_bwd3(*key, gen),
             "attention_core_bwd_vjp": lambda key: check_attn_vjp(key, gen),
             "attention_core_bwd_vjp3": lambda key: check_attn_vjp3(key, gen)}.get(
                 name, lambda key: check_flash(name, key, gen, card))
    seen = {} if seen is None else seen
    rows = []
    for key, count in sorted(collections.Counter(shapes).items(), key=str):
        earlier = (name, key) in seen
        r = dict(seen[(name, key)]) if earlier else check(key)
        r.update(shape=key, count=count)
        rows.append(r)
        base = (f" {BASELINE[name][:-3]} {r['baseline_ms']:.5f}"
                if "baseline_ms" in r else "")
        design = (f" (tc {r['tc_ms']:.5f} exp {r['exp_ms']:.5f}"
                  + (f" simt {r['simt_ms']:.5f}" if "simt_ms" in r else "")
                  + f" bytes {r['bytes_ms']:.5f}; fp32 bound "
                  f"{max(r['bytes_ms'], r['ops_ms']):.5f})"
                  if "tc_ms" in r else "")
        device = ((f" device {r['device_ms']:.5f}" if "device_ms" in r else "")
                  + (f" library device {r['library_device_ms']:.5f}"
                     if "library_device_ms" in r else ""))
        print(f"  {name} {key} x{count}: err {r['err']:.2e} "
              f"ms {r['ms']:.5f} plain {r['plain_ms']:.5f} "
              f"library {r['library_ms']:.5f}{base}{device} "
              f"bound {bound(r):.5f}{design}"
              + (f" [{r['path']}]" if "path" in r else "")
              + (" (checked in an earlier phase)" if earlier else ""),
              flush=True)
    return rows


#: the redesigned kernels' library yardstick at a shape: (label, the
#: kernel's time, the yardstick's time). SDPA for the flash forward, and its
#: autograd backward, which gives dq, dk and dv together, for each of the two
#: flash backward kernels; for
#: fused_attention the faster of its chain and its SDPA chain (event times
#: of back-to-back calls); SDPA for attention_core and the PyTorch GroupNorm
#: chain for groupnorm_silu, and their autograd backwards for
#: attention_core_bwd and gn_silu_bwd, on device time (CUDA-graph replays:
#: most of their shapes take under 0.05 ms, where event timing reads the
#: host)
YARDSTICK = {
    "flash_attention_fwd": ("SDPA", lambda r: r["ms"],
                            lambda r: r["library_ms"]),
    "flash_attention_dq": ("SDPA's autograd backward (dq, dk and dv)",
                           lambda r: r["ms"], lambda r: r["library_ms"]),
    "flash_attention_dkdv": ("SDPA's autograd backward (dq, dk and dv)",
                             lambda r: r["ms"], lambda r: r["library_ms"]),
    "fused_attention": ("min(chain, SDPA chain)", lambda r: r["ms"],
                        lambda r: min(r["library_ms"], r["baseline_ms"])),
    "attention_core": ("SDPA on device time", lambda r: r["device_ms"],
                       lambda r: r["library_device_ms"]),
    "groupnorm_silu": ("the GroupNorm chain on device time",
                       lambda r: r["device_ms"],
                       lambda r: r["library_device_ms"]),
    "attention_core_bwd": ("SDPA's autograd backward on device time",
                           lambda r: r["device_ms"],
                           lambda r: r["library_device_ms"]),
    "gn_silu_bwd": ("the GroupNorm chain's autograd backward on device time",
                    lambda r: r["device_ms"],
                    lambda r: r["library_device_ms"]),
    "gn_silu_bwd_bwd": ("the GroupNorm chain's autograd double backward on "
                        "device time", lambda r: r["device_ms"],
                        lambda r: r["library_device_ms"]),
    "gn_silu_bwd3": ("the GroupNorm chain's autograd triple backward on "
                     "device time", lambda r: r["device_ms"],
                     lambda r: r["library_device_ms"]),
    "attention_core_bwd_vjp": ("SDPA's (math backend) autograd double "
                               "backward", lambda r: r["ms"],
                               lambda r: r["library_ms"]),
    "attention_core_bwd_vjp3": ("SDPA's (math backend) autograd triple "
                                "backward", lambda r: r["ms"],
                                lambda r: r["library_ms"])}


def print_yardstick(phase_name, rows_by_kernel):
    """One line per redesigned kernel of ``rows_by_kernel``: at how many of
    its shapes it is no slower than its yardstick, and the others; for the
    kernels timed on device time also the count on event times."""
    for name, (label, mine, ref) in YARDSTICK.items():
        rows = rows_by_kernel.get(name)
        if not rows:
            continue
        lost = [r for r in rows if mine(r) > ref(r)]
        events = ""
        if "library_device_ms" in rows[0]:
            won = sum(r["ms"] <= r["library_ms"] for r in rows)
            events = f" (on event times, host included: {won} of {len(rows)})"
        print(f"  [{phase_name}] yardstick {name}: no slower than {label} at "
              f"{len(rows) - len(lost)} of {len(rows)} shapes{events}"
              + ("; slower at " + ", ".join(
                  f"{r['shape']} {mine(r):.5f} vs {ref(r):.5f} ms"
                  for r in lost) if lost else ""), flush=True)


def seen_rows(*tables):
    """(name, shape) -> row over tables of checked rows by kernel name."""
    return {(name, r["shape"]): r for table in tables
            for name, rows in table.items() for r in rows}


def summed(name, rows):
    """Kernel ``name``'s times summed over the calls of ``rows``."""
    total = lambda f: sum(r.get(f, 0.0) * r["count"] for r in rows)
    bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
    out = {"ms": total("ms"), "plain_ms": total("plain_ms"),
           "bound_ms": sum(bound(r) * r["count"] for r in rows),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": total("library_ms"),
           "max_abs_err": max(r["err"] for r in rows)}
    if all("tc_ms" in r for r in rows):  # a 3xTF32 kernel: its parts
        tc_ms, exp_ms = total("tc_ms"), total("exp_ms")
        out.update(tc_ms=tc_ms, exp_ms=exp_ms,
                   binds="tensor cores" if tc_ms >= exp_ms else "exponentials",
                   fp32_bound_ms=sum(max(r["bytes_ms"], r["ops_ms"])
                                     * r["count"] for r in rows))
        if any("simt_ms" in r for r in rows):
            out["simt_ms"] = total("simt_ms")
        out["bound_by"] = ("bytes" if bytes_ms >= max(
            tc_ms, exp_ms, out.get("simt_ms", 0.0)) else "operations")
    if all("device_ms" in r for r in rows):
        out["device_ms"] = total("device_ms")
    if all("library_device_ms" in r for r in rows):
        out["library_device_ms"] = total("library_device_ms")
    if all("baseline_ms" in r for r in rows):
        out[BASELINE[name]] = total("baseline_ms")
    return out


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0
        w.plain_calls = 0


def read_counts():
    return ({k: w.launches for k, w in WRAPPERS.items()},
            {k: w.plain_calls for k, w in WRAPPERS.items()})


def profile(fn, calls: int = 3):
    """torch.profiler over ``calls`` calls of ``fn`` after one warm-up:
    (wall ms per call, device-busy ms per call, [(kernel, ms per call,
    launches per call)]) from the CUDA kernel events, or None if the trace
    holds none. Busy is the union of the kernels' intervals: kernels that
    run at once count once there, and their summed durations are the
    rows'."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    # the kernels' activity alone: the rows and the busy share read only
    # the CUDA events, and the host ops' events multiply the trace's size
    acts = [ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    by_name = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for e in prof.events():
        # kernels only: a GPU-side user annotation (the optimizer step's
        # span) overlaps the kernels it encloses
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / calls
            by_name[e.name][1] += 1
            spans.append((e.time_range.start, e.time_range.end))
    if not by_name:
        return None
    busy_us, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy = busy_us / 1e3 / calls
    top = sorted(((k, v[0], v[1] / calls) for k, v in by_name.items()),
                 key=lambda r: -r[1])
    return wall, busy, top


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build"),
                    help="directory for the harness phases' run directories")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    clock_now, clock_top = sm_clocks_mhz()
    card = dict(sms=torch.cuda.get_device_properties(0).multi_processor_count,
                sm_hz=clock_top * 1e6)
    phase("device", t0, f"{smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()} | "
          f"{card['sms']} SMs, SM clock {clock_now:.0f} MHz now, "
          f"{clock_top:.0f} MHz at most (the exponential bound's)")

    t0 = time.perf_counter()
    logs = build.build()
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    phase("build", t0, f"built {sorted(logs) or 'nothing (cached)'} "
          f"into {build.BUILD_DIR}")

    # ---- the rate of mma.sync.m16n8k8 (tf32) that the 3xTF32 kernels use
    t0 = time.perf_counter()
    probe = mma_rate(card)
    for r in probe:
        print(f"  mma-rate {r['warps']} warp(s) x {r['chains']} chain(s) a "
              f"sub-partition: {r['cycles_per_mma']:.3f} cycles an mma, "
              f"{r['tflops_at_clock']:.1f} TFLOP/s at "
              f"{card['sm_hz'] / 1e6:.0f} MHz, {r['tflops_events']:.1f} "
              f"TFLOP/s on event time at {r['mhz']:.0f} MHz", flush=True)
    best = min(probe, key=lambda r: r["cycles_per_mma"])
    phase("mma-rate", t0, f"mma.sync.m16n8k8 tf32 at best "
          f"{best['cycles_per_mma']:.3f} cycles a sub-partition "
          f"({best['warps']} warps x {best['chains']} chains): "
          f"{best['tflops_at_clock']:.1f} TFLOP/s on {card['sms']} SMs at "
          f"{card['sm_hz'] / 1e6:.0f} MHz, {best['tflops_at_clock'] / PEAK_TF32 * 1e12:.3f}"
          f" of the {PEAK_TF32 / 1e12:.0f} TFLOP/s dense TF32 peak the "
          f"design bounds assume; latency of one chain "
          f"{probe[0]['cycles_per_mma']:.3f} cycles")

    # ---- 3: shapes, and the first UNet call, kernel path vs plain path
    t0 = time.perf_counter()
    model = LatentDiffusion.from_checkpoint(CKPT, device="cuda")
    images = pick_inputs(NUM_INPUTS, SEED)
    u = model.cond_encoding(images)
    n_units = u.shape[1]
    tokens = model.cond_warp(
        swap_conditions(u).reshape(n_units * NUM_INPUTS, n_units))
    batch = tokens.shape[0]
    gen = torch.Generator("cuda").manual_seed(SEED)
    x_T = torch.randn(batch, model.image_size, model.image_size,
                      model.channels, generator=gen, device="cuda")
    t_first = torch.full((batch,), int(DDIMSchedule.create(
        model.schedule, DDIM_STEPS).timesteps[-1]), device="cuda")
    records, remove = record_shapes(model)
    eps_kernel = model.apply_model(x_T, t_first, tokens)
    per_unet = {k: list(v) for k, v in records.items()}
    for v in records.values():
        v.clear()
    z_T = x_T.clone()
    model.decode_first_stage(z_T)
    per_decode = {k: list(v) for k, v in records.items()}
    remove()
    with plain_path():
        eps_plain = model.apply_model(x_T, t_first, tokens)
    torch.cuda.synchronize()
    torch.testing.assert_close(eps_kernel, eps_plain, **PATH_TOL)
    eps_err = (eps_kernel - eps_plain).abs().max().item()
    phase("shapes", t0, f"B={batch}: per UNet call "
          f"{ {k: len(v) for k, v in per_unet.items()} }, per decode "
          f"{ {k: len(v) for k, v in per_decode.items()} }; first UNet eps "
          f"kernel vs plain max_abs_err {eps_err:.3e} "
          f"(tol {PATH_TOL})")

    # ---- 4: every kernel at every main-path shape
    t0 = time.perf_counter()
    kgen = torch.Generator("cuda").manual_seed(SEED + 1)
    serve_rows = {name: check_rows(name, per_unet[name] + per_decode[name],
                                   kgen, card)
                  for name in ("groupnorm_silu", "attention_core",
                               "fused_attention")}
    print_yardstick("kernels", serve_rows)
    phase("kernels", t0, "each kernel matches its plain version at every "
          f"main-path shape (tol {KERNEL_TOL})")

    # ---- 5: the main path, counters read around it alone
    t0 = time.perf_counter()
    expected = {k: len(per_unet.get(k, ())) * DDIM_STEPS
                + len(per_decode.get(k, ())) for k in KERNELS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_req = time.perf_counter()
    out = swap_sample(model, images, ddim_steps=DDIM_STEPS, eta=0.0, x_T=x_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_req
    swap_launches, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (batch, 64, 64, 3):
        raise RuntimeError(f"swap output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise RuntimeError("swap output has non-finite values")
    if swap_launches != expected or any(plain_calls.values()):
        raise RuntimeError(f"launches {swap_launches}, expected {expected}; "
                           f"plain calls {plain_calls}")
    phase("main", t0, f"swap request B={NUM_INPUTS} -> {batch} samples, "
          f"DDIM {DDIM_STEPS}, eta 0: wall {wall:.3f}s, "
          f"{batch / wall:.3f} samples/s, peak memory "
          f"{peak / 2**20:.1f} MiB, launches {swap_launches} (expected), "
          f"plain calls {plain_calls} | {smi}")

    # ---- 6: a short chain and a decode, kernel path vs plain path
    t0 = time.perf_counter()
    small = tokens[:n_units]
    lat_k = model.sample_ddim(small, steps=10, x_T=x_T[:n_units])
    img_k = model.decode_first_stage(lat_k, force_not_quantize=True)
    with plain_path():
        lat_p = model.sample_ddim(small, steps=10, x_T=x_T[:n_units])
        img_p = model.decode_first_stage(lat_k, force_not_quantize=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lat_k, lat_p, **PATH_TOL)
    torch.testing.assert_close(img_k, img_p, **PATH_TOL)
    phase("reference", t0, f"10-step chain max_abs_err "
          f"{(lat_k - lat_p).abs().max().item():.3e}, decode max_abs_err "
          f"{(img_k - img_p).abs().max().item():.3e} (tol {PATH_TOL})")

    # ---- 7: where the time of one UNet call goes (not a pass/fail phase)
    t0 = time.perf_counter()
    print_profile("profile", t0, f"one UNet call at B={batch}",
                  profile(lambda: model.apply_model(x_T, t_first, tokens)))
    del model

    train_rows, train_launches, per_step = train_phases(smi, card)
    harness_launches, harness_rows = harness_phases(
        smi, card, seen_rows(serve_rows, train_rows), args.out)
    vq_rows, vq_other, vq_launches, per_vq_step = vq_phases(
        smi, card, seen_rows(serve_rows, train_rows, harness_rows), args.out)
    mcl_rows, mcl_vjp_rows, mcl_launches, per_mcl_step = mcl_phases(
        smi, card, seen_rows(serve_rows, train_rows, harness_rows, vq_rows),
        args.out)
    fisher_rows, fisher_other, fisher_launches, per_fisher_step, fisher = \
        mcl_fisher_phases(smi, card, seen_rows(
            serve_rows, train_rows, harness_rows, vq_rows, mcl_rows,
            {"attention_core_bwd_vjp": mcl_vjp_rows}), args.out)
    harness.clear_device_cache()
    synthetic_shapes.clear_cache()
    torch.cuda.empty_cache()
    (fvq_rows, fvq_other, fvq_launches, per_fvq_step, fvq,
     fvq_dir) = faces_vq_phases(
        smi, card, seen_rows(serve_rows, train_rows, harness_rows, vq_rows,
                             mcl_rows), args.out)
    faces_rows, faces_launches, per_micro = faces_phases(
        smi, card, seen_rows(serve_rows, train_rows))
    fserve_rows, fserve_other, fserve_launches, per_fserve = faces_serve_phases(
        smi, card, seen_rows(serve_rows, train_rows, faces_rows))
    torch.cuda.empty_cache()
    fh_rows, fh_other, fh_launches, per_fh_step, fh, fh_dir = \
        faces_harness_phases(smi, card, seen_rows(
            serve_rows, train_rows, harness_rows, fvq_rows, fvq_other,
            faces_rows, fserve_rows, fserve_other), args.out, fvq_dir)
    feval_rows, feval_launches = faces_eval_phase(smi, card, seen_rows(
        serve_rows, train_rows, fvq_rows, fvq_other, faces_rows, fserve_rows,
        fserve_other, fh_rows, fh_other), args.out, fh_dir)
    seen = seen_rows(serve_rows, train_rows, harness_rows, vq_rows, vq_other,
                     fvq_rows, fvq_other, fh_rows, fh_other)
    harness.clear_device_cache()
    torch.cuda.empty_cache()
    cars = cross_phases(smi, card, seen, args.out, "cars3d")
    mpi_render = mpi3d_shapes_phase(smi)
    mpi = cross_phases(smi, card, {**seen, **seen_rows(*cars["rows"])},
                       args.out, "mpi3d")
    harness.clear_device_cache()
    synthetic_mpi3d.clear_cache()
    shapes_render = shapes_render_phase(smi)
    seen = {**seen, **seen_rows(*cars["rows"], *mpi["rows"])}
    shapes = cross_phases(smi, card, seen, args.out, "shapes")
    seen = {**seen, **seen_rows(*shapes["rows"])}
    smcl_rows, smcl_launches, per_smcl_step, smcl = shapes_mcl_phase(
        smi, card, {**seen, **seen_rows(
            mcl_rows, {"attention_core_bwd_vjp": mcl_vjp_rows})},
        args.out, *shapes["dirs"])
    bands = cross_phases(smi, card, {**seen, **seen_rows(smcl_rows)},
                         args.out, "bands_control")
    harness.clear_device_cache()
    synthetic_shapes.clear_cache()
    chains = (cars, mpi, shapes, bands)

    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "device_ms", "library_device_ms", "tc_ms", "exp_ms", "simt_ms",
              "binds", "fp32_bound_ms")
    kernels = []
    for name in KERNELS:
        parts = {w: summed(name, rows[name]) for w, rows in (
            ("serve", serve_rows), ("train_step", train_rows),
            ("faces_micro_step", faces_rows), ("faces_serve", fserve_rows),
            ("vq_step", vq_rows), ("mcl_step", mcl_rows),
            ("mcl_fisher_step", fisher_rows),
            ("faces_vq_micro_step", fvq_rows),
            ("faces_harness_micro_step", fh_rows),
            ("shapes_mcl_step", smcl_rows))
            if rows.get(name)}
        top = next(iter(parts.values()))
        launches = {"swap": swap_launches[name], "train": train_launches[name],
                    "harness": harness_launches[name],
                    "vq_train": vq_launches[name],
                    "mcl_train": mcl_launches[name],
                    "mcl_fisher_train": fisher_launches[name],
                    "faces_vq_train": fvq_launches[name],
                    "faces_train": faces_launches[name],
                    **{path: counts[name]
                       for path, counts in fserve_launches.items()},
                    "faces_harness": fh_launches[name],
                    "shapes_mcl": smcl_launches[name],
                    **{f"faces_eval_{cli}": counts[name]
                       for cli, counts in feval_launches.items()},
                    **{path: counts[name] for chain in chains
                       for path, counts in chain["launches"].items()}}
        entry = {
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max([p["max_abs_err"] for p in parts.values()]
                               + [r["err"] for r in fserve_other.get(name, ())]
                               + [r["err"] for r in vq_other.get(name, ())]
                               + [r["err"] for r in fvq_other.get(name, ())]
                               + [r["err"] for r in fh_other.get(name, ())]
                               + [r["err"] for r in feval_rows.get(name, ())]
                               + [r["err"] for chain in chains
                                  for table in chain["rows"]
                                  for r in table.get(name, ())]
                               + [r["err"]
                                  for r in smcl_rows.get(name, ())]
                               + [r["err"]
                                  for r in harness_rows.get(name, ())]),
            **{k: top[k] for k in (*fields, BASELINE.get(name)) if k in top}}
        for workload, calls in (("train_step", per_step),
                                ("faces_micro_step", per_micro),
                                ("faces_serve", per_fserve),
                                ("vq_step", per_vq_step),
                                ("mcl_step", per_mcl_step),
                                ("mcl_fisher_step", per_fisher_step),
                                ("faces_vq_micro_step", per_fvq_step),
                                ("faces_harness_micro_step", per_fh_step),
                                ("shapes_mcl_step", per_smcl_step)):
            if workload in parts:
                entry[workload] = {
                    **{k: v for k, v in parts[workload].items()
                       if k != "max_abs_err"},
                    "launches": len(calls[name])}
        kernels.append(entry)
    vjp = summed("attention_core_bwd_vjp", mcl_vjp_rows)
    print("# kernels: ms, plain_ms, bound_ms and library_ms are summed over "
          "the launches of one UNet call plus one VQ decode at B=160 for the "
          "forward kernels, over one train step at B=128 for the flagship's "
          "backward kernels, and over one faces micro-step (micro-batch 8, "
          "256 px) for the flash kernels; train_step, faces_micro_step and "
          "faces_serve (one UNet call at B=32 plus one 256 px decode of 32) "
          "hold every kernel's sums over those calls, and vq_step over one "
          "VQ-GAN train step at B=128 (-b flagship_vq), faces_vq_micro_step "
          "over one faces VQ-GAN micro-step at micro-batch 8, 256 px "
          "(-b faces_vq), faces_harness_micro_step over one faces "
          "EncDiff micro-step at micro-batch 8 on cached latents (-b faces); "
          "max_abs_err also "
          "covers the faces serving shapes at B=16 and B=64, the VQ eval "
          "and image-log shapes (both VQ-GANs) and the other VQ backward "
          "shapes of vq-kernels (attention_core_ms: "
          "attention_core or attention_core_bwd at the flash kernels' shapes; "
          "chain_ms: nn.Linear x3 + attention_core + nn.Linear at "
          "fused_attention's shapes, whose SDPA form is its library_ms; the "
          "library backward gives dq, dk and dv together); device_ms and "
          "library_device_ms (attention_core, groupnorm_silu, "
          "attention_core_bwd, gn_silu_bwd): the kernel and its library call "
          "on device time, from CUDA-graph replays; for the 3xTF32 kernels "
          "(flash_attention_fwd, flash_attention_dq, flash_attention_dkdv, "
          "attention_core, attention_core_bwd, fused_attention) bound_ms "
          "is the "
          "design's bound, the largest of bytes, tc_ms (three tf32 passes "
          "of the products at 495 TFLOP/s), exp_ms (the exponentials at 16 "
          "per SM and clock) and simt_ms (CUDA-core FLOPs at 67 TFLOP/s), "
          "binds names the larger of tc_ms and exp_ms, and fp32_bound_ms is "
          "the fp32 CUDA-core bound of the earlier rows; launches count "
          f"the swap request, the {TRAIN_STEPS} train steps, the harness's "
          f"{HARNESS_STEPS} steps with its image logs, the VQ-GAN run's "
          f"{VQ_STEPS} steps, {len(VQ_LOG_STEPS)} image logs and "
          f"{VQ_VAL_BATCHES} test batches, the MCL run's {MCL_STEPS} steps "
          "with its latent encode and swap visualization, the faces VQ-GAN "
          f"run's {FACES_VQ_MICRO_STEPS} micro-steps, "
          f"{len(FACES_VQ_LOG_STEPS)} image logs and {FACES_VQ_VAL_BATCHES} "
          "test batches, the "
          f"{4 * FACES_UPDATES} faces micro-steps, the faces swap request, "
          "the faces FID sampling, the faces EncDiff run's "
          f"{FACES_LDM_MICRO_STEPS} micro-steps with its latent encode and "
          "image log (faces_harness), and the faces eval chain's tad, fid "
          f"--num {FACES_EVAL_FID_NUM} and generate_swap on its last "
          "(faces_eval_*), and the Cars3D and MPI3D chains' VQ-GAN runs "
          f"({CROSS_VQ_STEPS} steps, an image log, {CROSS_VQ_VAL_BATCHES} "
          "test batches: cars3d_vq_train, mpi3d_vq_train) and EncDiff runs "
          f"({CROSS_LDM_STEPS} steps with the latent encode and an image "
          "log: cars3d_harness, mpi3d_harness), the same of the shapes "
          "family's v1 chain (shapes_vq_train, shapes_harness) and "
          "bands-control chain (bands_control_vq_train, "
          "bands_control_harness: no EncDiff image log), and -b "
          "shapes_mcl's "
          f"{SHAPES_MCL_STEPS} steps with its latent encode and swap "
          "visualization (shapes_mcl); max_abs_err also covers the "
          "faces EncDiff run's latent encode and image log shapes, the eval "
          "chain's and those of the Cars3D, MPI3D, v1 and bands-control "
          "chains; shapes_mcl_step: one -b shapes_mcl step at B=128; "
          "mcl_step: one MCL fine-tune step at "
          "B=128 (-b flagship_mcl, infonce_mechgrad), whose second order "
          "runs gn_silu_bwd_bwd and the attention VJP (PyTorch ops, not a "
          "kernel of the port: "
          + ", ".join(f"{k} {vjp[k]:.5f}" for k in ("ms", "plain_ms",
                                                     "bound_ms", "library_ms"))
          + f", bound by {vjp['bound_by']} at the fp32 peak, "
          f"{len(per_mcl_step['attention_core_bwd_vjp'])} call a step)",
          flush=True)
    print("# mcl_fisher: the fisher_sm run (-b flagship_mcl "
          f"{' '.join(FISHER_OVERRIDES)}) on {smi}: "
          + ", ".join(f"{k} {v:.6g}" for k, v in fisher.items())
          + "; mcl_fisher_step holds every kernel's sums over one of its "
          "steps at B=128, whose third order runs gn_silu_bwd3; per step "
          "the attention VJP (PyTorch ops, no kernel of the port) "
          + "; its third order (autograd of the recorded VJP) ".join(
              ", ".join(f"{k} {summed(n, fisher_other[n])[k]:.5f}"
                        for k in ("ms", "plain_ms", "bound_ms", "library_ms"))
              + f" ({len(per_fisher_step[n])} a step)"
              for n in ("attention_core_bwd_vjp", "attention_core_bwd_vjp3")),
          flush=True)
    print("# faces_vq: the faces VQ-GAN run (-b faces_vq) on "
          f"{smi}: " + ", ".join(f"{k} {v:.6g}" for k, v in fvq.items()),
          flush=True)
    print("# faces_harness: the faces EncDiff run (-b faces over the faces "
          f"VQ-GAN run's last) on {smi}: " + ", ".join(
              f"{k} {v:.6g}" for k, v in fh.items()), flush=True)
    for ds, chain in zip(CROSS, chains):
        print(f"# {ds}: the {ds} chain (-b {ds}_vq, then -b {ds} over its "
              f"last) on {smi}: " + ", ".join(
                  f"{k} {v:.6g}" for k, v in chain["numbers"].items()),
              flush=True)
    print(f"# mpi3d render on {smi}: " + ", ".join(
        f"{k} {v:.6g}" for k, v in mpi_render.items()), flush=True)
    print(f"# shapes render on {smi}: " + ", ".join(
        f"{k} {v:.6g}" for k, v in shapes_render.items()), flush=True)
    print("# shapes_mcl: -b shapes_mcl over the v1 chain's last on "
          f"{smi}: " + ", ".join(f"{k} {v:.6g}" for k, v in smcl.items())
          + "; shapes_mcl_step holds every kernel's sums over one of its "
          "steps at B=128", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    phase("total", t_all, "chip_smoke passed")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def print_profile(name, t0, what, prof):
    if prof is None:
        phase(name, t0, "the profiler saw no CUDA kernel: not measured")
        return
    wall_ms, busy_ms, top = prof
    phase(name, t0, f"{what} under torch.profiler: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %; "
          f"the kernels' durations sum to {sum(r[1] for r in top):.3f} ms), "
          f"{sum(r[2] for r in top):.0f} kernel launches")
    for i, (kname, ms, n) in enumerate(top):
        if i < 12 or any(k in kname for k in PROFILE_ALWAYS):
            print(f"  {ms:9.4f} ms {n:5.0f}x  {kname[:110]}", flush=True)


def record_step(model, state, batch, t, noise):
    """The shape of every forward and backward kernel call of one forward +
    backward on ``batch``, by kernel; Encoder4's statistics are restored."""
    bn = cond_state(model)
    fwd, remove = record_shapes(model)
    with record_backward_shapes() as bwd:
        loss_and_grads(model, state, batch, t, noise)
    torch.cuda.synchronize()
    remove()
    model.cond_stage_model.load_state_dict(bn)
    return {**fwd, **bwd}


def cond_state(model):
    """A copy of Encoder4's state: its parameters and batch statistics."""
    return {k: v.clone() for k, v in
            model.cond_stage_model.state_dict().items()}


def reference_check(name, t0, model, state, batch, draws):
    """For each (t, noise) of ``draws``, one forward + backward on ``batch``
    on the plain path and on the kernel path: the loss to LOSS_RTOL, every
    gradient leaf to GRAD_RTOL relative L2 but the leaves whose exact
    gradient is zero (held within GRAD_ZERO of the global norm), the new
    batch statistics to PATH_TOL, on each of ``REFERENCE_REPEATS``
    kernel-path runs.

    Those kernel-path runs start their backward from the plain path's
    gradient at the UNet output. The L1 loss's gradient there is
    sign(ε_θ − ε) / n: where |ε_θ − ε| is within the two paths' rounding
    its sign differs between them, and one such element moves the
    gradients of the top UNet level by about 1e-3 relative L2. One more
    kernel-path run on its own upstream gradient shows it: printed, with
    the number of such elements, and not held to the tolerance."""
    bn = cond_state(model)

    def forward_backward(t, noise, upstream=None):
        seen = {}

        def output_hook(mod, args, out):
            def grad_hook(g):
                seen["upstream"] = g.detach().clone()
                return upstream
            out.register_hook(grad_hook)
        handle = model.unet.register_forward_hook(output_hook)
        try:
            loss_dict, _ = loss_and_grads(model, state, batch, t, noise)
        finally:
            handle.remove()
        grads = {k: p.grad.detach().clone()
                 for k, p in trainable_parameters(model).items()}
        stats = {k: v for k, v in cond_state(model).items()
                 if k.endswith(("running_mean", "running_var"))}
        model.cond_stage_model.load_state_dict(bn)
        return loss_dict["train/loss"].item(), grads, stats, seen["upstream"]

    readings, faults = [], []
    for i, (t, noise) in enumerate(draws):
        with plain_path():
            loss_p, grads_p, stats_p, upstream_p = forward_backward(t, noise)
        own = forward_backward(t, noise)
        runs = [forward_backward(t, noise, upstream_p)
                for _ in range(REFERENCE_REPEATS)]
        torch.cuda.synchronize()
        norms = {k: torch.linalg.vector_norm(g).item()
                 for k, g in grads_p.items()}
        total = sum(n * n for n in norms.values()) ** 0.5
        zero = sorted(k for k, n in norms.items() if n <= GRAD_ZERO * total)
        if not set(zero) <= EXACT_ZERO:
            raise RuntimeError(f"leaves with a gradient under {GRAD_ZERO} of "
                               f"the global norm that are not known exact "
                               f"zeros: {sorted(set(zero) - EXACT_ZERO)}")

        def relative(grads):
            return {k: torch.linalg.vector_norm(g - grads_p[k]).item()
                    / norms[k] for k, g in grads.items() if k not in zero}

        worst_own = max((r, k) for k, r in relative(own[1]).items())
        flips = (own[3] != upstream_p).sum().item()
        got = []
        for loss_k, grads_k, stats_k, _ in runs:
            if abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
                faults.append(f"draw {i}: loss kernel {loss_k} vs plain "
                              f"{loss_p}")
            rel = relative(grads_k)
            for r, k in sorted(((r, k) for k, r in rel.items()),
                               reverse=True)[:2]:
                print(f"  draw {i}: gradient {k}: relative L2 {r:.3e}, "
                      f"|g| / global {norms[k] / total:.3e}", flush=True)
            failed = [k for k, r in rel.items() if r > GRAD_RTOL]
            loud = [k for k in zero if torch.linalg.vector_norm(
                grads_k[k]).item() > GRAD_ZERO * total]
            if failed or loud:
                faults.append(f"draw {i}: gradients off: {failed}; "
                              f"zero-gradient leaves above {GRAD_ZERO} of "
                              f"the global norm: {loud}")
            for k in stats_p:
                torch.testing.assert_close(stats_k[k], stats_p[k], **PATH_TOL)
            worst = max((r, k) for k, r in rel.items())
            got.append(f"{worst[0]:.3e} ({worst[1]})")
        spread = max(torch.linalg.vector_norm(g - runs[1][1][k]).item()
                     / norms[k] for k, g in runs[0][1].items()
                     if k not in zero)
        readings.append(
            f"draw {i}: plain loss {loss_p:.7f}, kernel "
            f"{', '.join(f'{r[0]:.7f}' for r in runs)}; worst leaf "
            f"{'; '.join(got)}; run to run {spread:.3e}; L1 signs that "
            f"differ at the UNet output {flips}, and on its own upstream "
            f"gradient the kernel path's worst leaf {worst_own[0]:.3e} "
            f"({worst_own[1]})")
    if faults:
        raise RuntimeError(f"{name}: " + "; ".join(readings + faults))
    phase(name, t0, f"B={len(batch)}, {len(draws)} draws of t and noise: "
          f"{len(grads_p) - len(zero)} of {len(grads_p)} gradient leaves "
          f"within relative L2 {GRAD_RTOL} on each of {REFERENCE_REPEATS} "
          f"kernel-path runs, loss within {LOSS_RTOL}, batch statistics "
          f"within {PATH_TOL}; the {len(zero)} leaves with a zero exact "
          f"gradient within {GRAD_ZERO} of the global norm: {zero}. "
          + " | ".join(readings))


def train_phases(smi, card):
    """Phases 8-12 on the flagship's train step at B = 128. Returns the
    checked rows of every kernel at the train step's shapes, the launches of
    the train run, and the calls of one step by kernel."""
    # ---- 8: every kernel call of one forward + backward
    t0 = time.perf_counter()
    config = {**FLAGSHIP_TRAIN, "batch_size": TRAIN_BATCH}
    model, state, _ = train_steps.load_for_training(CKPT, config, "cuda")
    images = torch.from_numpy(render_all_v4(factor_sizes=TRAIN_GRID)).cuda()
    gen = torch.Generator("cuda").manual_seed(config["seed"])
    first = images[torch.from_numpy(
        epoch_batches(len(images), TRAIN_BATCH, config["seed"])[0]).cuda()]
    per_step = record_step(model, state, first,
                           *draw_t_and_noise(model, TRAIN_BATCH, gen))
    phase("train-shapes", t0, f"B={TRAIN_BATCH}, global step {state.step}: "
          f"per train step { {k: len(v) for k, v in per_step.items()} }")

    # ---- 9: every kernel at every shape of the train step
    t0 = time.perf_counter()
    kgen = torch.Generator("cuda").manual_seed(SEED + 2)
    rows = {name: check_rows(name, per_step[name], kgen, card)
            for name in KERNELS if per_step.get(name)}
    print_yardstick("train-kernels", rows)
    phase("train-kernels", t0, "each kernel matches its plain version at "
          f"every shape of the B={TRAIN_BATCH} train step (tol {KERNEL_TOL})")

    # ---- 10: the train run, counters read around it alone
    t0 = time.perf_counter()
    start = {k: p.detach().clone()
             for k, p in trainable_parameters(model).items()}
    ema_start = {k: v.clone() for k, v in state.ema.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics = [], []
    t1 = time.perf_counter()
    for m in train_steps.run(model, state, images, TRAIN_STEPS, TRAIN_BATCH,
                             config["seed"], gen):
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        metrics.append(m)
        t1 = time.perf_counter()
    launches, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    series = {k: torch.stack([m[k] for m in metrics]).tolist()
              for k in ("train/loss", "train/loss_simple", "train/loss_indep",
                        "grad_norm")}
    if not all(torch.isfinite(torch.tensor(v)).all() for v in series.values()):
        raise RuntimeError(f"non-finite loss or grad_norm: {series}")
    unchanged = [k for k, p in trainable_parameters(model).items()
                 if torch.equal(p, start[k])]
    if unchanged:
        raise RuntimeError(f"{len(unchanged)} trainable leaves unchanged "
                           f"after {TRAIN_STEPS} steps: {unchanged[:8]}")
    if all(torch.equal(v, ema_start[k]) for k, v in state.ema.params.items()):
        raise RuntimeError("the EMA did not move")
    expected = {k: len(per_step.get(k, ())) * TRAIN_STEPS for k in KERNELS}
    if launches != expected or any(plain_calls.values()):
        raise RuntimeError(f"launches {launches}, expected {expected}; "
                           f"plain calls {plain_calls}")
    step_ms = sorted(times[2:])[len(times[2:]) // 2] * 1e3
    mean_ms = sum(times[2:]) / len(times[2:]) * 1e3
    phase("train", t0, f"{TRAIN_STEPS} steps at B={TRAIN_BATCH} from global "
          f"step {state.step - TRAIN_STEPS}: {step_ms:.3f} ms per step "
          f"(median of steps 3-{TRAIN_STEPS}; their total over their count "
          f"{mean_ms:.3f} ms; first {times[0] * 1e3:.1f} ms), "
          f"{1e3 / step_ms:.3f} steps/s, peak memory {peak / 2**20:.1f} MiB; "
          + ", ".join(f"{k} {v[0]:.6f} -> {v[-1]:.6f}"
                      for k, v in series.items())
          + f", lr {metrics[0]['lr']:.4e} -> {metrics[-1]['lr']:.4e}; "
          f"launches per step { {k: v // TRAIN_STEPS for k, v in launches.items()} }, "
          f"plain calls {plain_calls} | {smi}")

    # ---- 11: one forward + backward, kernel path vs plain path
    t0 = time.perf_counter()
    batch = images[torch.from_numpy(
        epoch_batches(len(images), TRAIN_BATCH, config["seed"], 1)[0]).cuda()]
    reference_check("train-reference", t0, model, state, batch, [
        draw_t_and_noise(model, TRAIN_BATCH, gen)
        for _ in range(REFERENCE_DRAWS)])

    # ---- 12: where the time of one train step goes (not pass/fail)
    t0 = time.perf_counter()
    print_profile("train-profile", t0, f"one train step at B={TRAIN_BATCH}",
                  profile(lambda: train_step(model, state, batch,
                                             generator=gen), calls=2))
    return rows, launches, per_step


def harness_data_phase(smi):
    """harness-data: the full v4 grid rendered on the host, held to the JAX
    renderer's digest and uploaded as uint8 through the harness's device
    cache (later phases reuse it; harness-train times the latent cache of
    each fit)."""
    t0 = time.perf_counter()
    t = time.perf_counter()
    host = SyntheticShapes3DV4FullTrain().images
    render_s = time.perf_counter() - t
    t = time.perf_counter()
    digest_faults = check_digest("v4", FULL_FACTOR_SIZES, host)
    digest_s = time.perf_counter() - t
    if digest_faults:
        raise RuntimeError(f"harness-data: {digest_faults}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    harness.device_images(host, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    phase("harness-data", t0, f"{len(host)} images {tuple(host.shape)} "
          f"rendered on the host in {render_s:.3f}s (its bytes the JAX "
          f"renderer's digest, {digest_s:.3f}s), uploaded "
          f"({host.nbytes / 2**30:.3f} GiB uint8) in {upload_s:.3f}s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB | {smi}")


def check_digest(renderer, factor_sizes, images) -> list:
    """Faults of a rendered grid against its SHAPES_DIGESTS constant."""
    got = grid_digest(images)
    want = SHAPES_DIGESTS[(renderer, tuple(factor_sizes))]
    if got != want:
        return [f"the {renderer} grid at {list(factor_sizes)}: digest {got},"
                f" the JAX renderer's {want}"]
    return []


def harness_eval_phase(smi, out):
    """harness-eval: a ``Trainer`` of the flagship restored from the
    committed checkpoint runs ``test()``, the full battery on the card (DCI
    at the full tier from the global seed SEED): FactorVAE and MIG against
    the checkpoint's recorded scores, DCI disentanglement against
    DCI_TARGET, beta-VAE's eval accuracy 1.0. The same reps are scored at
    the fast tier on the card (every metric's seconds) and, DCI, on the
    host CPU from the same seed; the card's D, C, informativeness and
    importance matrix are held to the CPU's. The run directory is
    ``<out>/harness_eval``. Returns the trainer, whose weights are the
    checkpoint's."""
    t0 = time.perf_counter()
    config = harness.load_configs(["flagship"], [])
    lightning = config.pop("lightning")
    logdir = os.path.join(out, "harness_eval")
    trainer = harness.Trainer(config, lightning, logdir=logdir,
                              device="cuda")
    trainer.resume_ckpt = CKPT
    np.random.seed(SEED)
    results = trainer.test()
    step = trainer.state.step
    with open(os.path.join(logdir, "metrics_sin", f"{step}.json")) as f:
        scores = json.load(f)
    fvae, mig = scores["factor_VAE"], scores["MIG"]["discrete_mig"]
    dci, beta = scores["dci"], scores["beta_VAE"]
    reps_path = os.path.join(logdir, "reps", f"{step}.npy")
    reps = np.load(reps_path)
    with open(reps_path, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    tm = trainer.timings
    print(f"  reps {reps.shape} {reps.dtype} at {reps_path}, sha256 {sha}; "
          f"row 0 {np.array2string(reps[0], precision=6, max_line_width=400)}"
          f"; dims with a std of at least 0.05 "
          f"{int((reps.std(axis=0, ddof=1) >= 0.05).sum())}", flush=True)
    # the fast tier on the card, then its DCI on the host CPU: same reps,
    # same global seed
    fast_s = {}
    np.random.seed(SEED)
    fast = eval_func(trainer.label_dataset, reps, None, step, budget="fast",
                     device="cuda", timings=fast_s)
    np.random.seed(SEED)
    t1 = time.perf_counter()
    host = eval_func(trainer.label_dataset, reps, None, step,
                     metrics=("dci",), budget="fast", device="cpu")["dci"]
    host_s = time.perf_counter() - t1
    card = fast["dci"]
    dci_keys = ("disentanglement", "completeness", "informativeness_train",
                "informativeness_test")
    diffs = {k: abs(float(card[k]) - float(host[k])) for k in dci_keys}
    imp_diff = float(np.abs(np.array(card["importance_matrix"])
                            - np.array(host["importance_matrix"])).max())
    print(f"  full-tier DCI on the card: "
          + ", ".join(f"{k} {dci[k]:.6f}" for k in dci_keys)
          + f"; importance matrix {dci['importance_matrix']}", flush=True)
    faults = []
    if fvae["eval_accuracy"] != 1.0 or fvae["num_active_dims"] != 20:
        faults.append(f"FactorVAE {fvae} (1.0 with 20 dims expected)")
    if not abs(mig - MIG_TARGET) <= MIG_TOL:
        faults.append(f"MIG {mig} (|MIG - {MIG_TARGET}| <= {MIG_TOL} "
                      "expected)")
    if not abs(dci["disentanglement"] - DCI_TARGET) <= DCI_TOL:
        faults.append(f"DCI disentanglement {dci['disentanglement']} "
                      f"(|D - {DCI_TARGET}| <= {DCI_TOL} expected)")
    if beta["eval_accuracy"] != 1.0:
        faults.append(f"beta-VAE {beta} (eval accuracy 1.0 expected)")
    if max(diffs.values()) > DCI_CARD_TOL or imp_diff > DCI_IMPORTANCE_TOL:
        faults.append(f"fast-tier DCI, card against the CPU: {diffs}, "
                      f"importance {imp_diff} (tol {DCI_CARD_TOL}, "
                      f"{DCI_IMPORTANCE_TOL})")
    if sorted(results) != BATTERY_KEYS or not all(
            np.isfinite(v) for v in results.values()):
        faults.append(f"test() {results}")
    if faults:
        raise RuntimeError("harness-eval: " + "; ".join(faults))
    phase("harness-eval", t0, f"test() at step {step}: sweep of "
          f"{tm['images']} images {tm['sweep_s']:.3f}s "
          f"({tm['images'] / tm['sweep_s']:.1f} images/s), metrics on the "
          f"card {tm['metrics_s']:.3f}s (full tier: " + ", ".join(
              f"{k} {v:.3f}s" for k, v in tm["metric_s"].items())
          + "; fast tier: " + ", ".join(
              f"{k} {v:.3f}s" for k, v in fast_s.items())
          + f"; fast-tier DCI on the host CPU {host_s:.3f}s); FactorVAE "
          f"{fvae['eval_accuracy']} (train {fvae['train_accuracy']}, "
          f"num_active_dims {fvae['num_active_dims']}), MIG {mig:.6f} "
          f"(target {MIG_TARGET} +- {MIG_TOL}), DCI D {dci['disentanglement']:.6f} "
          f"(target {DCI_TARGET} +- {DCI_TOL}) C {dci['completeness']:.6f} "
          f"I {dci['informativeness_test']:.6f}, beta-VAE "
          f"{beta['eval_accuracy']} (train {beta['train_accuracy']}); fast "
          f"tier D {card['disentanglement']:.6f} on the card, "
          f"{host['disentanglement']:.6f} on the CPU: differences "
          + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
          + f", importance {imp_diff:.3e} (tol {DCI_CARD_TOL}, "
          f"{DCI_IMPORTANCE_TOL}); {results} | {smi}")
    return trainer


@contextlib.contextmanager
def recording_harness(stamps):
    """While on, the harness's first latent encode, first train step and
    every image log record the shape of each kernel call they make (the
    first step also its batch, its generator's state and its loss), and
    each train step appends its end time to ``stamps``. Yields the records;
    ``records["on"] = False`` stops the recording."""
    records = {"on": True, "latents": None, "step": None, "logs": []}
    step_fn, latents_fn, log_fn = (harness.train_step,
                                   harness.precompute_latents,
                                   harness.log_images)

    def train_step(model, state, batch, **kwargs):
        if records["on"] and records["step"] is None:
            first = {"batch": {k: v.clone() for k, v in batch.items()},
                     "gen": kwargs["generator"].get_state()}
            fwd, remove = record_shapes(model)
            try:
                with record_backward_shapes() as bwd:
                    metrics = step_fn(model, state, batch, **kwargs)
            finally:
                remove()
            first["loss"] = metrics["train/loss"].item()
            records["step"] = ({**fwd, **bwd}, first)
        else:
            metrics = step_fn(model, state, batch, **kwargs)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return metrics

    def precompute_latents(model, images, *args, **kwargs):
        if not records["on"] or records["latents"] is not None:
            return latents_fn(model, images, *args, **kwargs)
        shapes, remove = record_shapes(model)
        try:
            z = latents_fn(model, images, *args, **kwargs)
        finally:
            remove()
        records["latents"] = (shapes, z)
        return z

    def log_images(model, batch, **kwargs):
        if not records["on"]:
            return log_fn(model, batch, **kwargs)
        shapes, remove = record_shapes(model)
        try:
            return log_fn(model, batch, **kwargs)
        finally:
            remove()
            records["logs"].append(shapes)

    harness.train_step = train_step
    harness.precompute_latents = precompute_latents
    harness.log_images = log_images
    try:
        yield records
    finally:
        harness.train_step = step_fn
        harness.precompute_latents = latents_fn
        harness.log_images = log_fn


def harness_reference(ref, records):
    """The harness run's last chunk of latents against the plain path's
    encode of the same rows, and its first step's loss against the plain
    path's on the same batch, t and noise; ``ref`` is a trainer at the
    run's starting weights. Returns (readings, faults)."""
    _, z = records["latents"]
    _, first = records["step"]
    images = harness.device_images(ref.data.dataset("train").images,
                                   ref.device)
    n, chunk = len(z), min(LATENT_CHUNK, len(z))
    with plain_path():
        z_plain = precompute_latents(ref.model, images[n - chunk:])
    torch.cuda.synchronize()
    faults = []
    try:
        torch.testing.assert_close(z[n - chunk:], z_plain, **PATH_TOL)
    except AssertionError as e:
        faults.append(f"latents of rows {n - chunk}-{n - 1}: {e}")
    z_err = (z[n - chunk:] - z_plain).abs().max().item()
    gen = torch.Generator(ref.device)
    gen.set_state(first["gen"])
    batch = first["batch"]
    t, noise = draw_t_and_noise(ref.model, len(batch["image"]), gen)
    bn = cond_state(ref.model)
    with plain_path():
        loss_dict, _ = loss_and_grads(ref.model, ref.state, batch, t, noise)
    ref.model.cond_stage_model.load_state_dict(bn)
    loss_plain = loss_dict["train/loss"].item()
    if abs(first["loss"] - loss_plain) > LOSS_RTOL * abs(loss_plain):
        faults.append(f"first step's loss {first['loss']}, plain path "
                      f"{loss_plain} (rtol {LOSS_RTOL})")
    return (f"latents of rows {n - chunk}-{n - 1} against the plain path "
            f"max_abs_err {z_err:.3e} (tol {PATH_TOL}); first step's loss "
            f"{first['loss']:.7f}, plain path {loss_plain:.7f} (rtol "
            f"{LOSS_RTOL})"), faults


def harness_train_phase(smi, card, seen, ref, out):
    """harness-train: ``main_val.main`` on the flagship, 20 steps from the
    committed checkpoint with the image logger every 20 steps and no test;
    then ``main_val.main -r`` to step 30, which ends in ``test()``. Returns
    the launches of the 20-step run and the checked rows of its kernel
    calls by kernel."""
    t0 = time.perf_counter()
    logroot = os.path.join(out, "harness")
    # --max_steps counts global steps, which go on from the checkpoint's
    with np.load(CKPT) as f:
        start = int(f["state/step"])
    stamps, latents_s = [], []
    with recording_harness(stamps) as records, \
            timed_calls(harness, "precompute_latents", latents_s):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        trainer = main_val.main([
            "-b", "flagship", "-t", "--max_steps", str(start + HARNESS_STEPS),
            "--resume_ckpt", CKPT, "--no-test", "-l", logroot,
            "--device", "cuda",
            "lightning.callbacks.image_logger.params.batch_frequency="
            f"{HARNESS_LOG_EVERY}",
            "lightning.callbacks.image_logger.params.increase_log_steps="
            "false", LOG_DDIM])
        torch.cuda.synchronize()
        launches, plain_calls = read_counts()
        peak = torch.cuda.max_memory_allocated()
        records["on"] = False
        first = list(stamps)
        # the fit's epoch end (an epoch of this grid is 3,750 steps): the
        # validation at the fast tier feeds the checkpoints as fit() does
        val = trainer.validate(0, trainer.state.step)
        val_s = dict(trainer.timings["metric_s"])
        for ck in trainer.checkpoints:
            ck.maybe_save(trainer.save_checkpoint, trainer.state.step, 0,
                          metrics=val)
        resumed = main_val.main(["-r", trainer.logdir, "-t", "--max_steps",
                                 str(start + HARNESS_RESUMED_STEPS),
                                 "--device", "cuda"])
    faults = []
    # the image logs of step 20: every key, at the grid shape of its count
    root = os.path.join(trainer.logdir, "images", "train")
    n_units = FLAGSHIP_TRAIN["unet_config"]["latent_unit"]
    counts = {"inputs": 8, "reconstruction": 8, "conditioning": 8,
              "diffusion_row": 4 * 6, "samples": 8,
              "samples_swapping": 8 * n_units}
    for key in LOG_KEYS:
        path = os.path.join(root,
                            f"{key}_gs-{start + HARNESS_LOG_EVERY:06}.npy")
        nrow = 8 if key == "samples_swapping" else 4
        want = make_grid(np.zeros((counts[key], 64, 64, 3), np.uint8),
                         nrow=nrow).shape
        if not os.path.exists(path):
            faults.append(f"no image log {path}")
        elif np.load(path).shape != want:
            faults.append(f"{path}: {np.load(path).shape}, {want} expected")
    last = os.path.join(trainer.ckptdir, "last")
    for name in (MODEL_FILE, STATE_FILE):
        if not os.path.exists(os.path.join(last, name)):
            faults.append(f"no {name} in {last}")
    # the resumed run: from the 40th step with AdamW's count at 40, so its
    # first LR is the 41st update's (count 40), not the warmup's first value
    lr_fn = trainer.state.lr_fn
    first_lr = resumed.lr_monitor.history[0]
    want_lr = (start + HARNESS_STEPS + 1, lr_fn(HARNESS_STEPS))
    if first_lr != want_lr or lr_fn(HARNESS_STEPS) == lr_fn(0) \
            or resumed.state.step != start + HARNESS_RESUMED_STEPS \
            or resumed.state.updates != HARNESS_RESUMED_STEPS:
        faults.append(f"resumed run's first (step, lr) {first_lr}, "
                      f"{want_lr} expected; ended at step "
                      f"{resumed.state.step}, AdamW count "
                      f"{resumed.state.updates}")
    ema_moved = not all(torch.equal(v, trainer.state.ema.params[k])
                        for k, v in resumed.state.ema.params.items())
    if resumed.state.ema.num_updates != trainer.state.ema.num_updates + (
            HARNESS_RESUMED_STEPS - HARNESS_STEPS) or not ema_moved:
        faults.append(f"EMA: {resumed.state.ema.num_updates} updates after "
                      f"{trainer.state.ema.num_updates}, moved {ema_moved}")
    with open(os.path.join(resumed.logdir, "test_results.json")) as f:
        test_results = json.load(f)
    test_s = dict(resumed.timings["metric_s"])
    for name, got in (("validation", val), ("test_results.json",
                                            test_results)):
        if sorted(got) != BATTERY_KEYS or not all(
                np.isfinite(v) for v in got.values()):
            faults.append(f"{name} {got}")
    best_dci = sorted(p for p in os.listdir(trainer.ckptdir)
                      if p.startswith("best_dci_"))
    if len(best_dci) != 1:
        faults.append(f"best_dci checkpoints {best_dci} in "
                      f"{trainer.ckptdir}")
    del resumed, trainer
    # the launches: the steps', the latent encode's and the image logs'
    step_shapes, _ = records["step"]
    latent_shapes, _ = records["latents"]
    parts = (latent_shapes, *records["logs"])
    want = {k: HARNESS_STEPS * len(step_shapes.get(k, ()))
            + sum(len(p.get(k, ())) for p in parts) for k in KERNELS}
    if launches != want or any(plain_calls.values()):
        faults.append(f"launches {launches}, expected {want} "
                      f"({HARNESS_STEPS} steps of "
                      f"{ {k: len(v) for k, v in step_shapes.items()} }, "
                      f"the latent encode's and {len(records['logs'])} image "
                      f"logs'); plain calls {plain_calls}")
    reading, wrong = harness_reference(ref, records)
    faults += wrong
    # every kernel at every shape of the run: the encode's chunks of 2,048
    # and the image logs' are new; the step's were checked in train-kernels
    kgen = torch.Generator("cuda").manual_seed(SEED + 6)
    shapes = {k: [s for p in (step_shapes, *parts) for s in p.get(k, ())]
              for k in KERNELS}
    rows = {name: check_rows(name, shapes[name], kgen, card, seen)
            for name in KERNELS if shapes[name]}
    print_yardstick("harness-train", rows)
    records.clear()
    if faults:
        raise RuntimeError("harness-train: " + "; ".join(faults))
    # steps 3-40, without step 21, whose interval holds step 20's image log
    times = [b - a for a, b in zip(first, first[1:])]  # steps 2..40
    steady = [dt for i, dt in enumerate(times, start=2)
              if i >= 3 and i != HARNESS_LOG_EVERY + 1]
    median_ms = sorted(steady)[len(steady) // 2] * 1e3
    mean_ms = sum(steady) / len(steady) * 1e3
    phase("harness-train", t0, f"main_val -b flagship -t --max_steps "
          f"{start + HARNESS_STEPS} from global step {start} on cached "
          f"latents (the latent cache of the grid "
          f"{', then '.join(f'{v:.3f}s' for v in latents_s)}, once a fit): "
          f"{median_ms:.3f} ms per step (median of steps "
          f"3-{HARNESS_STEPS} but {HARNESS_LOG_EVERY + 1}; their mean "
          f"{mean_ms:.3f} ms; the train phase's on uncached latents above), "
          f"peak memory {peak / 2**20:.1f} MiB, launches {launches} "
          f"(expected); every kernel matches its plain version at every "
          f"shape of the run (tol {KERNEL_TOL}); {reading}; image logs at "
          f"step {start + HARNESS_LOG_EVERY}: {list(LOG_KEYS)}; resumed "
          f"with -r to step {start + HARNESS_RESUMED_STEPS}: first (step, "
          f"lr) {first_lr}, AdamW count {HARNESS_RESUMED_STEPS}; the epoch "
          f"end's validation (fast tier: " + ", ".join(
              f"{k} {v:.3f}s" for k, v in val_s.items())
          + f") {val}, wrote {best_dci}; test (full tier: " + ", ".join(
              f"{k} {v:.3f}s" for k, v in test_s.items())
          + f") {test_results} | {smi}")
    return launches, rows


def harness_phases(smi, card, seen, out):
    """harness-data, harness-eval and harness-train, their run directories
    under ``out``; the device dataset stays for the VQ phases. Returns the
    launches of the harness's train run and the checked rows of its kernel
    calls."""
    harness_data_phase(smi)
    ref = harness_eval_phase(smi, out)
    launches, rows = harness_train_phase(smi, card, seen, ref, out)
    del ref
    torch.cuda.empty_cache()
    return launches, rows


def vq_model(config, seed: int):
    """The VQ-GAN of ``config`` (``-b flagship_vq`` or ``-b faces_vq``) on
    the card with the harness's seeded fresh init, and a fresh train state
    at its LR and accumulation."""
    params = config["model"]["params"]
    model = harness.VQModel(**params).cuda()
    model.init_parameters(torch.Generator("cuda").manual_seed(seed))
    bs = config["data"]["params"]["batch_size"]
    accumulate = config["lightning"]["trainer"].get(
        "accumulate_grad_batches", 1)
    lr = accumulate * bs * config["model"]["base_learning_rate"]
    return model, vq_trainer.create_vq_train_state(model, lr, accumulate)


def vq_snapshot(model):
    """Copies of the generator's leaves and of the discriminator's state."""
    return ({k: p.detach().clone()
             for k, p in model.generator_parameters().items()},
            {k: v.clone()
             for k, v in model.loss.discriminator.state_dict().items()})


def record_vq_calls(model, fn):
    """The shape of every kernel call ``fn()`` makes on ``model``, forward
    and backward, by kernel."""
    fwd, remove = record_shapes(model)
    try:
        with record_backward_shapes() as bwd:
            fn()
            torch.cuda.synchronize()
    finally:
        remove()
    return {k: v for k, v in {**fwd, **bwd}.items() if v}


def forced_quantize(quantizer, z, indices):
    """The quantizer's outputs on ``z`` with the code ``indices`` given
    (the plain path's), by its own arithmetic."""
    b, e, h, w = z.shape
    z_q = quantizer.embedding[indices.reshape(-1)].view(b, h, w, e).permute(
        0, 3, 1, 2)
    loss = (quantizer.beta * ((z_q.detach() - z) ** 2).mean()
            + ((z_q - z.detach()) ** 2).mean())
    return z + (z_q - z).detach(), loss, (None, None, indices)


def vq_reference(t0, model, state, batch, name="vq-reference",
                 adaptive_upstream=False, log_atol=0.0):
    """One generator pass (with the adaptive weight) and one discriminator
    pass on ``batch`` at the run's starting weights, on the plain path and
    on the kernel path: the code indices, every logged value and the
    discriminator's loss to LOSS_RTOL (plus ``log_atol``), every generator
    gradient leaf to GRAD_RTOL relative L2 but VQ_EXACT_ZERO's (within
    GRAD_ZERO of the global norm on both paths), on each of
    REFERENCE_REPEATS kernel-path runs. Those runs start their backward at
    the decoder's output from the plain path's gradient there (the L1
    term's sign flips where |x - x_rec| is within the two paths' rounding),
    with ``adaptive_upstream`` the adaptive weight's two gradients too (the
    L1's and the PatchGAN's LeakyReLU kinks, both after the decoder's
    output, each take the plain path's side), and, where a near-tie of the
    VQ argmin gave a code another index, quantize with the plain path's
    indices; one more kernel-path run on its own indices and upstream
    gradients is printed, not held. So are two witnesses of what the
    reconstruction's difference does on its own, each the plain path once
    more with no kernel: its reconstruction moved by the kernel path's own
    differences from it, as they are and shuffled over the pixels."""
    loss_obj = model.loss
    x = vq_trainer.as_images(batch)
    gen = model.generator_parameters()
    disc0 = {k: v.clone() for k, v in loss_obj.discriminator.state_dict().items()}

    def run(upstream=None, indices=None, shift=None):
        handles = []
        if indices is not None:
            handles.append(model.quantize.register_forward_hook(
                lambda m, args, out: forced_quantize(m, args[0], indices)))
        try:
            xrec, qloss, ind = model(x)
        finally:
            for h in handles:
                h.remove()
        out = xrec.detach()
        if shift is not None:
            xrec = xrec + shift

        # the gradients at the decoder's output, in order: with
        # adaptive_upstream the nll's and the GAN term's of the adaptive
        # weight, then the step's own
        seen = []

        def grad_hook(g):
            seen.append(g.detach().clone())
            return None if upstream is None else upstream[len(seen) - 1]
        if adaptive_upstream:
            xrec.register_hook(grad_hook)
        g_total, log = loss_obj.generator_loss(
            qloss, x, xrec, state.step, last_layer=model.get_last_layer(),
            predicted_indices=ind)
        if not adaptive_upstream:
            # after the adaptive weight's two gradients: only the step's
            # own backward starts from ``upstream``
            xrec.register_hook(grad_hook)
        grads = dict(zip(gen, torch.autograd.grad(g_total, list(gen.values()))))
        d_total, d_log = loss_obj.discriminator_loss(x, xrec, state.step)
        loss_obj.discriminator.load_state_dict(disc0)
        return ({**log, **d_log}, grads, ind, seen, out)

    with plain_path():
        log_p, grads_p, ind_p, up_p, xrec_p = run()
    own = run()
    diff = own[4] - xrec_p
    shuffle = torch.randperm(diff.numel(), device=diff.device,
                             generator=torch.Generator(diff.device)
                             .manual_seed(VQ_SEED))
    with plain_path():
        witnesses = [run(shift=d) for d in (
            diff, diff.flatten()[shuffle].view_as(diff))]
    flips = (own[2] != ind_p).sum().item()
    forced = ind_p if flips else None
    runs = [run(up_p, forced) for _ in range(REFERENCE_REPEATS)]
    torch.cuda.synchronize()
    norms = {k: torch.linalg.vector_norm(g).item() for k, g in grads_p.items()}
    total = sum(n * n for n in norms.values()) ** 0.5
    zero = sorted(k for k in VQ_EXACT_ZERO
                  if k in norms and norms[k] <= GRAD_ZERO * total)

    def relative(grads):
        return {k: torch.linalg.vector_norm(g - grads_p[k]).item() / norms[k]
                for k, g in grads.items() if k not in zero}

    faults, got = [], []
    for log_k, grads_k, *_ in runs:
        for k, v in log_p.items():
            if abs(log_k[k].item() - v.item()) > (LOSS_RTOL * abs(v.item())
                                                  + log_atol):
                faults.append(f"{k} kernel {log_k[k].item()} vs plain "
                              f"{v.item()}")
        rel = relative(grads_k)
        failed = [k for k, r in rel.items() if r > GRAD_RTOL]
        loud = [k for k in zero if torch.linalg.vector_norm(
            grads_k[k]).item() > GRAD_ZERO * total]
        if failed or loud:
            faults.append(f"gradients off: {failed}; zero-gradient leaves "
                          f"above {GRAD_ZERO} of the global norm: {loud}")
        worst = max((r, k) for k, r in rel.items())
        got.append(f"{worst[0]:.3e} ({worst[1]})")
    worst_own = max((r, k) for k, r in relative(own[1]).items())
    own_signs = (own[3][-1].sign() != up_p[-1].sign()).sum().item()
    witness_signs = " / ".join(
        str((w[3][-1].sign() != up_p[-1].sign()).sum().item())
        for w in witnesses)
    shifts = "; ".join(
        f"{k.split('/')[-1]} " + " / ".join(
            f"{abs(r[0][k].item() - log_p[k].item()):.3e}"
            for r in (own, *witnesses))
        for k in ("train/d_weight", "train/total_loss", "train/g_loss"))
    kernel_losses = ", ".join(f"{r[0]['train/total_loss'].item():.7f}"
                              for r in runs)
    reading = (f"plain generator loss {log_p['train/total_loss'].item():.7f}, "
               f"kernel {kernel_losses}; "
               f"disc loss plain {log_p['train/disc_loss'].item():.7f}; code "
               f"indices that differ {flips} of {ind_p.numel()}"
               + (" (the kernel-path runs quantize with the plain path's)"
                  if flips else "")
               + f"; worst gradient leaf {'; '.join(got)}; on its own "
               f"indices and upstream gradient ({own_signs} signs differ at "
               f"the decoder's output) the kernel path's worst leaf "
               f"{worst_own[0]:.3e} ({worst_own[1]}) and adaptive weight "
               f"{own[0]['train/d_weight'].item():.7f} (plain "
               f"{log_p['train/d_weight'].item():.7f}); the plain path on "
               f"the kernel path's reconstruction / on its differences "
               f"shuffled (max {diff.abs().max().item():.3e}, relative L2 "
               f"{(diff.norm() / xrec_p.norm()).item():.3e}): "
               f"{witness_signs} signs differ, and the logs move (the "
               f"kernel path on its own / the two witnesses) {shifts}")
    if faults:
        raise RuntimeError(f"{name}: " + reading + "; " + "; ".join(faults))
    phase(name, t0, f"B={len(batch)} at the run's starting weights: "
          f"every logged value within {LOSS_RTOL}"
          + (f" + {log_atol} absolute" if log_atol else "")
          + ", the backward from the plain path's gradients at the "
          "decoder's output" + (" (the adaptive weight's too)"
                                if adaptive_upstream else "") + ", "
          f"{len(grads_p) - len(zero)} of {len(grads_p)} generator gradient "
          f"leaves within relative L2 {GRAD_RTOL} on each of "
          f"{REFERENCE_REPEATS} kernel-path runs; the {len(zero)} leaves "
          f"with a zero exact gradient within {GRAD_ZERO} of the global "
          f"norm: {zero}. {reading}")


@contextlib.contextmanager
def watched_micro_steps(moved, times, start):
    """While on, each VQ-GAN train step appends its own device-synchronised
    seconds to ``times`` and to ``moved`` (the step after it, the number of
    generator and discriminator parameters it changed); the first one puts
    the model's starting leaves (``vq_snapshot``) into ``start``."""
    step_fn = vq_trainer.train_step

    def train_step(model, state, batch):
        params = lambda: [*model.generator_parameters().values(),
                          *model.loss.discriminator.parameters()]
        if not start:
            start.extend(vq_snapshot(model))
        before = [p.detach().clone() for p in params()]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(model, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        moved.append((state.step, sum(not torch.equal(p, b)
                                      for p, b in zip(params(), before))))
        return out

    vq_trainer.train_step = train_step
    try:
        yield
    finally:
        vq_trainer.train_step = step_fn


def vq_phases(smi, card, seen, out):
    """vq-shapes, vq-kernels, vq-train, vq-reference and vq-profile: the
    VQ-GAN trainer behind ``main_val -b flagship_vq`` at B = 128 on the
    full v4 grid the harness phases left on the card. Returns the checked
    rows of the train step's kernel calls, the other checked rows (eval,
    image log, VQ_BWD_SHAPES), the launches of the 40-step run and the
    calls of one step by kernel."""
    # ---- vq-shapes: one step, one eval batch and one image log
    t0 = time.perf_counter()
    config = harness.load_configs(["flagship_vq"], [])
    bs = config["data"]["params"]["batch_size"]
    host = harness.instantiate_from_config(config["data"]).setup().dataset(
        "train").images
    images = harness.device_images(host, "cuda")
    model, state = vq_model(config, VQ_SEED)
    start_gen, start_disc = vq_snapshot(model)
    order = torch.from_numpy(harness.epoch_order(
        VQ_SEED, 0, len(host), bs, len(host))).cuda()
    first = images[order[:bs]]
    per_step = record_vq_calls(
        model, lambda: vq_trainer.train_step(model, state, first))
    per_eval = record_vq_calls(
        model, lambda: vq_trainer.eval_step(model, state, images[:bs]))
    logx = vq_trainer.as_images(images[:8])
    with torch.no_grad():
        per_log = record_vq_calls(model, lambda: model.reconstruct(logx))
    phase("vq-shapes", t0, f"B={bs}: per train step "
          f"{ {k: len(v) for k, v in per_step.items()} }, per eval batch "
          f"{ {k: len(v) for k, v in per_eval.items()} }, per image log of 8 "
          f"{ {k: len(v) for k, v in per_log.items()} }")

    # ---- vq-kernels: every kernel at every shape of the VQ path
    t0 = time.perf_counter()
    kgen = torch.Generator("cuda").manual_seed(SEED + 7)
    step_rows = {name: check_rows(name, per_step[name], kgen, card, seen)
                 for name in KERNELS if per_step.get(name)}
    seen = {**seen, **seen_rows(step_rows)}
    other = {name: [s for part in (per_eval, per_log)
                    for s in part.get(name, ())]
                   + VQ_BWD_SHAPES.get(name, []) for name in KERNELS}
    other_rows = {name: check_rows(name, shapes, kgen, card, seen)
                  for name, shapes in other.items() if shapes}
    print_yardstick("vq-kernels", step_rows)
    print_yardstick("vq-kernels (eval, image log, other VQ shapes)",
                    other_rows)
    phase("vq-kernels", t0, "each kernel matches its plain version at every "
          f"shape of the VQ-GAN step, eval and image log, and at "
          f"{ {k: v for k, v in VQ_BWD_SHAPES.items()} } (tol {KERNEL_TOL})")
    del model, state

    # ---- vq-train: main_val -b flagship_vq, counters read around it alone
    t0 = time.perf_counter()
    logroot = os.path.join(out, "vq")
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with watched_micro_steps([], times, []):
        trainer = main_val.main([
            "-b", "flagship_vq", "-t", "--max_steps", str(VQ_STEPS),
            "--val_batches", str(VQ_VAL_BATCHES), "-l", logroot,
            "--seed", str(VQ_SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    model, state = trainer.model, trainer.state
    faults = []
    want = {k: VQ_STEPS * len(per_step.get(k, ()))
            + len(VQ_LOG_STEPS) * len(per_log.get(k, ()))
            + VQ_VAL_BATCHES * len(per_eval.get(k, ())) for k in KERNELS}
    if launches != want or any(plain_calls.values()):
        faults.append(f"launches {launches}, expected {want} ({VQ_STEPS} "
                      f"steps, {len(VQ_LOG_STEPS)} image logs, "
                      f"{VQ_VAL_BATCHES} eval batches); plain calls "
                      f"{plain_calls}")
    counts = (vq_trainer.optimizer_count(state.gen_opt),
              vq_trainer.optimizer_count(state.disc_opt))
    if counts != (VQ_STEPS, VQ_STEPS) or state.step != VQ_STEPS:
        faults.append(f"Adam counts {counts}, step {state.step}")
    end_gen, end_disc = vq_snapshot(model)
    still = ([k for k, v in end_gen.items() if torch.equal(v, start_gen[k])]
             + [k for k, v in end_disc.items()
                if torch.equal(v, start_disc[k])
                and not k.endswith("num_batches_tracked")])
    if still:
        faults.append(f"{len(still)} leaves unchanged: {still[:8]}")
    ckdir = os.path.join(trainer.logdir, "checkpoints")
    compact = os.path.join(ckdir, "compact_last.npz")
    results_path = os.path.join(trainer.logdir, "test_results.json")
    for path in (compact, results_path,
                 os.path.join(ckdir, "last", STATE_FILE),
                 *(os.path.join(trainer.logdir, "images", "train",
                                f"{k}_gs-{s:06}.npy")
                   for s in VQ_LOG_STEPS
                   for k in ("inputs", "reconstructions"))):
        if not os.path.exists(path):
            faults.append(f"no {path}")
    if os.path.exists(compact):
        with np.load(compact) as f:
            bad = [k for k in f.files if not np.isfinite(
                f[k].astype(np.float64)).all()]
            n_keys = len(f.files)
        if bad:
            faults.append(f"non-finite values in {compact}: {bad[:8]}")
    test_results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            test_results = json.load(f)
        if not test_results or not all(np.isfinite(v)
                                       for v in test_results.values()):
            faults.append(f"test_results.json {test_results}")
    if faults:
        raise RuntimeError("vq-train: " + "; ".join(faults))
    steady = times[2:]
    median_ms = sorted(steady)[len(steady) // 2] * 1e3
    mean_ms = sum(steady) / len(steady) * 1e3
    phase("vq-train", t0, f"main_val -b flagship_vq -t --max_steps "
          f"{VQ_STEPS} --val_batches {VQ_VAL_BATCHES} from the seeded fresh "
          f"init (seed {VQ_SEED}), B={bs} on the {len(host)}-image grid: "
          f"{median_ms:.3f} ms per step (median of steps 3-{VQ_STEPS}; "
          f"their mean {mean_ms:.3f} ms; first {times[0] * 1e3:.1f} ms), "
          f"{1e3 / median_ms:.3f} steps/s, {bs * 1e3 / median_ms:.1f} "
          f"images/s, peak memory {peak / 2**20:.1f} MiB (the grid's "
          f"{host.nbytes / 2**20:.1f} MiB included); launches {launches} "
          f"(expected), plain calls {plain_calls}; Adam counts {counts}; "
          f"every generator and discriminator leaf moved; compact_last.npz "
          f"({n_keys} keys) and test_results.json finite: "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(test_results.items()))
          + f" | {smi}")

    # ---- vq-reference: kernel path vs plain path at the starting weights
    t0 = time.perf_counter()
    ref_model, ref_state = vq_model(config, VQ_SEED)
    vq_reference(t0, ref_model, ref_state, first)
    del ref_model, ref_state

    # ---- vq-profile: one train step's device time (not pass/fail)
    t0 = time.perf_counter()
    batch = images[order[bs:2 * bs]]
    print_profile("vq-profile", t0, f"one VQ-GAN train step at B={bs}",
                  profile(lambda: vq_trainer.train_step(model, state, batch),
                          calls=2))
    del trainer, model, state
    torch.cuda.empty_cache()
    return step_rows, other_rows, launches, per_step


def faces_vq_phases(smi, card, seen, out):
    """faces-vq-shapes, faces-vq-kernels, faces-vq-train,
    faces-vq-reference and faces-vq-profile: the faces VQ-GAN behind
    ``main_val -b faces_vq`` (256 px, micro-batch 8, 4-way accumulation) on
    the full face grid, rendered here (its colour blocks on the card) and
    uploaded by the harness. Returns the checked rows of one micro-step's
    kernel calls, the other checked rows (eval, image log), the launches of
    the run, the calls of one micro-step by kernel, the run's numbers
    (render seconds, micro-step and update ms, peak memory, device-busy
    share) and its run directory (faces-harness trains over its
    ``checkpoints/last``)."""
    # ---- faces-vq-shapes: the grid, one micro-step, one eval batch and one
    # image log
    t0 = time.perf_counter()
    config = harness.load_configs(["faces_vq"], [])
    bs = config["data"]["params"]["batch_size"]
    accumulate = config["lightning"]["trainer"]["accumulate_grad_batches"]
    data = harness.instantiate_from_config(config["data"]).setup(device="cuda")
    train_ds = data.dataset("train")
    host = train_ds.images
    render_s = train_ds.render_s
    # the card's colour blocks against numpy's: the grid's first block
    # (every geometry, the first background, skin and hair colour)
    first_block = synthetic_faces.render_faces(
        host.shape[1], [1, 1, 1, *train_ds.factor_sizes[3:]])
    if not np.array_equal(first_block, host[:len(first_block)]):
        raise RuntimeError("faces-vq-shapes: the card's render differs from "
                           "numpy's on the grid's first block")
    t_up = time.perf_counter()
    images = harness.device_images(host, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t_up
    model, state = vq_model(config, VQ_SEED)
    order = torch.from_numpy(harness.epoch_order(
        VQ_SEED, 0, len(host), bs, len(host))).cuda()
    first = images[order[:bs]]
    per_step = record_vq_calls(
        model, lambda: vq_trainer.train_step(model, state, first))
    per_eval = record_vq_calls(
        model, lambda: vq_trainer.eval_step(model, state, images[:bs]))
    logx = vq_trainer.as_images(images[:8])
    with torch.no_grad():
        per_log = record_vq_calls(model, lambda: model.reconstruct(logx))
    # the encoder's and the decoder's mid block: one head of C channels over
    # the latents (4,096 of 128 channels at 256 px)
    dd = config["model"]["params"]["ddconfig"]
    side = dd["resolution"] // 2 ** (len(dd["ch_mult"]) - 1)
    flash = {k: v for k, v in per_step.items() if k in FLASH}
    want_flash = {k: [(bs, 1, side * side, dd["ch"] * dd["ch_mult"][-1])] * 2
                  for k in FLASH}
    if flash != want_flash:
        raise RuntimeError(f"faces-vq-shapes: flash calls of a micro-step "
                           f"{flash}, expected {want_flash}")
    phase("faces-vq-shapes", t0, f"the {len(host)}-image face grid rendered "
          f"in {render_s:.3f}s (masks on the host, colour blocks on the "
          f"card; its first block byte-identical to numpy's), uploaded in "
          f"{upload_s:.3f}s ({host.nbytes / 2**20:.1f} MiB); micro-batch "
          f"{bs}: per micro-step "
          f"{ {k: len(v) for k, v in per_step.items()} }, per eval batch "
          f"{ {k: len(v) for k, v in per_eval.items()} }, per image log of 8 "
          f"{ {k: len(v) for k, v in per_log.items()} }")

    # ---- faces-vq-kernels: every kernel at every shape of the faces VQ path
    t0 = time.perf_counter()
    kgen = torch.Generator("cuda").manual_seed(SEED + 8)
    step_rows = {name: check_rows(name, per_step[name], kgen, card, seen)
                 for name in KERNELS if per_step.get(name)}
    seen = {**seen, **seen_rows(step_rows)}
    other = {name: [s for part in (per_eval, per_log)
                    for s in part.get(name, ())] for name in KERNELS}
    other_rows = {name: check_rows(name, shapes, kgen, card, seen)
                  for name, shapes in other.items() if shapes}
    print_yardstick("faces-vq-kernels", step_rows)
    print_yardstick("faces-vq-kernels (eval, image log)", other_rows)
    phase("faces-vq-kernels", t0, "each kernel matches its plain version at "
          "every shape of the faces VQ-GAN micro-step, eval and image log "
          f"(tol {KERNEL_TOL})")
    del model, state

    # ---- faces-vq-train: main_val -b faces_vq, counters read around it
    t0 = time.perf_counter()
    logroot = os.path.join(out, "faces_vq")
    times, moved, start = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with watched_micro_steps(moved, times, start):
        trainer = main_val.main(
            ["-b", "faces_vq", "-t", "--max_steps", str(FACES_VQ_MICRO_STEPS),
             "--val_batches", str(FACES_VQ_VAL_BATCHES), "-l", logroot,
             "--seed", str(VQ_SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    model, state = trainer.model, trainer.state
    faults = []
    want = {k: FACES_VQ_MICRO_STEPS * len(per_step.get(k, ()))
            + len(FACES_VQ_LOG_STEPS) * len(per_log.get(k, ()))
            + FACES_VQ_VAL_BATCHES * len(per_eval.get(k, ())) for k in KERNELS}
    if launches != want or any(plain_calls.values()):
        faults.append(f"launches {launches}, expected {want} "
                      f"({FACES_VQ_MICRO_STEPS} micro-steps, "
                      f"{len(FACES_VQ_LOG_STEPS)} image logs, "
                      f"{FACES_VQ_VAL_BATCHES} eval batches); plain calls "
                      f"{plain_calls}")
    updates = FACES_VQ_MICRO_STEPS // accumulate
    counts = (vq_trainer.optimizer_count(state.gen_opt),
              vq_trainer.optimizer_count(state.disc_opt))
    if counts != (updates, updates) or state.step != FACES_VQ_MICRO_STEPS:
        faults.append(f"Adam counts {counts}, step {state.step}")
    n_params = (len(model.generator_parameters())
                + len(list(model.loss.discriminator.parameters())))
    off = [(s, n) for s, n in moved
           if (n != 0) != (s % accumulate == 0)]
    if len(moved) != FACES_VQ_MICRO_STEPS or off:
        faults.append(f"parameters moved on other micro-steps than every "
                      f"{accumulate}th: (step, leaves moved) {moved}")
    start_gen, start_disc = start
    end_gen, end_disc = vq_snapshot(model)
    still = ([k for k, v in end_gen.items() if torch.equal(v, start_gen[k])]
             + [k for k, v in end_disc.items()
                if torch.equal(v, start_disc[k])
                and not k.endswith("num_batches_tracked")])
    if still:
        faults.append(f"{len(still)} leaves unchanged: {still[:8]}")
    ckdir = os.path.join(trainer.logdir, "checkpoints")
    compact = os.path.join(ckdir, "compact_last.npz")
    results_path = os.path.join(trainer.logdir, "test_results.json")
    for path in (compact, results_path,
                 os.path.join(ckdir, "last", STATE_FILE),
                 *(os.path.join(trainer.logdir, "images", "train",
                                f"{k}_gs-{s:06}.npy")
                   for s in FACES_VQ_LOG_STEPS
                   for k in ("inputs", "reconstructions"))):
        if not os.path.exists(path):
            faults.append(f"no {path}")
    n_keys = 0
    if os.path.exists(compact):
        with np.load(compact) as f:
            bad = [k for k in f.files if not np.isfinite(
                f[k].astype(np.float64)).all()]
            n_keys = len(f.files)
        if bad:
            faults.append(f"non-finite values in {compact}: {bad[:8]}")
    test_results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            test_results = json.load(f)
        if not test_results or not all(np.isfinite(v)
                                       for v in test_results.values()):
            faults.append(f"test_results.json {test_results}")
    if faults:
        raise RuntimeError("faces-vq-train: " + "; ".join(faults))
    # micro-steps after the first update; an update's ms: its 4 micro-steps
    steady = times[accumulate:]
    micro_ms = sorted(steady)[len(steady) // 2] * 1e3
    update_ms = sorted(sum(times[i:i + accumulate]) for i in range(
        accumulate, len(times), accumulate))
    update_ms = update_ms[len(update_ms) // 2] * 1e3
    numbers = dict(render_s=render_s, upload_s=upload_s, micro_ms=micro_ms,
                   update_ms=update_ms, peak_mib=peak / 2**20,
                   first_micro_ms=times[0] * 1e3)
    phase("faces-vq-train", t0, f"main_val -b faces_vq -t --max_steps "
          f"{FACES_VQ_MICRO_STEPS} --val_batches {FACES_VQ_VAL_BATCHES} from "
          f"the seeded fresh init (seed {VQ_SEED}), micro-batch {bs} x "
          f"accumulation {accumulate} on the {len(host)}-image grid "
          f"(rendered in {render_s:.3f}s): {micro_ms:.3f} ms per micro-step "
          f"(median of micro-steps {accumulate + 1}-{FACES_VQ_MICRO_STEPS}; "
          f"first {times[0] * 1e3:.1f} ms), {update_ms:.3f} ms per update "
          f"(median of updates 2-{updates}), {bs * accumulate * 1e3 / update_ms:.1f} "
          f"images/s, peak memory {peak / 2**20:.1f} MiB (the grid's "
          f"{host.nbytes / 2**20:.1f} MiB included); launches {launches} "
          f"(expected), plain calls {plain_calls}; Adam counts {counts}; "
          f"parameters moved on micro-steps "
          f"{[s for s, n in moved if n]} only ({n_params} leaves each); every "
          f"generator and discriminator leaf moved; compact_last.npz "
          f"({n_keys} keys) and test_results.json finite: "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(test_results.items()))
          + f" | {smi}")

    # ---- faces-vq-reference: kernel path vs plain path at the start
    t0 = time.perf_counter()
    ref_model, ref_state = vq_model(config, VQ_SEED)
    vq_reference(t0, ref_model, ref_state, first, name="faces-vq-reference",
                 adaptive_upstream=True, log_atol=FACES_VQ_LOG_ATOL)
    del ref_model, ref_state

    # ---- faces-vq-profile: one update's device time (not pass/fail)
    t0 = time.perf_counter()
    batches = [images[order[(i + 1) * bs:(i + 2) * bs]]
               for i in range(accumulate)]

    def update():
        for b in batches:
            vq_trainer.train_step(model, state, b)
    prof = profile(update, calls=1)
    print_profile("faces-vq-profile", t0, f"one faces VQ-GAN update "
                  f"({accumulate} micro-steps of {bs})", prof)
    if prof is not None:
        numbers.update(profile_wall_ms=prof[0], busy_ms=prof[1],
                       busy=prof[1] / prof[0])
    logdir = trainer.logdir
    del trainer, model, state, images
    harness.clear_device_cache()
    torch.cuda.empty_cache()
    return step_rows, other_rows, launches, per_step, numbers, logdir


def mcl_trainer(config, lightning, out, resume=CKPT):
    """A ``Trainer`` of an MCL config restored from ``resume`` (the
    committed checkpoint by default) as ``main_val --resume_ckpt`` restores
    it, its MCL heads the seeded fresh init: the run's starting point."""
    trainer = harness.Trainer(copy.deepcopy(config), copy.deepcopy(lightning),
                              logdir=os.path.join(out, "mcl_reference"),
                              device="cuda")
    trainer.resume_ckpt = resume
    trainer._ensure_state()
    return trainer


def mcl_first_batch(trainer, images):
    """The run's first batch (global step 97,500 of the epoch order), with
    its first-stage code encoded, and the t and noise of that step."""
    bs, n = trainer.batch_size, len(images)
    order = torch.from_numpy(harness.epoch_order(trainer.seed, 0, n, bs,
                                                 n)).cuda()
    i = trainer.state.step % (n // bs)
    x = images[order[i * bs:(i + 1) * bs]]
    model = trainer.model
    batch = {"image": x, "z": model.encode_first_stage(model.split_batch(x)[0])}
    gen = harness.step_generator(trainer.seed, trainer.state.step, "cuda")
    return batch, draw_t_and_noise(model, bs, gen)


def mcl_step_calls(model, state, batch, t, noise):
    """The shape of every kernel call, forward and backward, of one MCL
    forward + backward on ``batch`` (its second and third orders
    included), by kernel; Encoder4's statistics are restored."""
    bn = cond_state(model)
    fwd, remove = record_shapes(model)
    try:
        with record_backward_shapes() as bwd:
            loss_and_grads(model, state, batch, t, noise)
            torch.cuda.synchronize()
    finally:
        remove()
    model.cond_stage_model.load_state_dict(bn)
    return {k: v for k, v in {**fwd, **bwd}.items() if v}


def mcl_grads(model, state, batch, t, noise, draw=None, upstream=None,
              indices=None, relus=None):
    """One MCL forward + backward on ``batch``: (logged values, gradient of
    every trainable leaf, the gradient at the UNet output, the code indices
    of each decode, the critic's pre-activations of its two image ReLUs at
    each call, and of the pre-activations whose sign ``relus`` changed the
    count within RELU_BAND, the count outside it and the largest ratio of
    a guarded one to its layer call's largest magnitude).
    ``upstream`` replaces the gradient at the UNet output (the L1 sign
    guard), ``indices`` the decodes' codes (the forced-index rule), and
    ``relus`` (another run's pre-activations) the value of each
    pre-activation whose sign differs from it where that value is within
    RELU_BAND of its layer call's largest (the ReLU guard: the mask, not
    the gradient, is taken from the other run); Encoder4's statistics are
    restored."""
    bn = cond_state(model)
    seen, codes, handles, pre = {}, [], [], []
    relu = dict(guarded=0, outside=0, worst=0.0)

    def output_hook(mod, args, out):
        def grad_hook(g):
            seen["upstream"] = g.detach().clone()
            return upstream
        out.register_hook(grad_hook)

    def code_hook(mod, args, out):
        if indices is not None:
            out = forced_quantize(mod, args[0], indices[len(codes)])
        codes.append(out[2][2].detach().clone())
        return out
    def relu_hook(mod, args, out):
        if relus is not None:
            ref = relus[len(pre)]
            scale = ref.abs().max()
            flip = (out > 0) != (ref > 0)
            near = ref.abs() <= RELU_BAND * scale
            guard = flip & near
            relu["guarded"] += int(guard.sum())
            relu["outside"] += int((flip & ~near).sum())
            if guard.any():
                relu["worst"] = max(relu["worst"], (
                    ref.abs()[guard].max() / scale).item())
            out = out + ((ref - out) * guard).detach()
        pre.append(out.detach().clone())
        return out
    handles.append(model.unet.register_forward_hook(output_hook))
    handles.append(model.first_stage_model.quantize.register_forward_hook(
        code_hook))
    critic = model.mcl["critic"]
    for conv in (critic.img_conv1, critic.img_conv2):
        handles.append(conv.register_forward_hook(relu_hook))
    try:
        loss_dict, _ = loss_and_grads(model, state, batch, t, noise,
                                      mcl_draw=draw)
    finally:
        for h in handles:
            h.remove()
    grads = {k: p.grad.detach().clone()
             for k, p in trainable_parameters(model).items()}
    model.cond_stage_model.load_state_dict(bn)
    return ({k: v.item() for k, v in loss_dict.items()}, grads,
            seen["upstream"], codes, pre, relu)


def mcl_compare(label, model, state, batch, t, noise, draw=None):
    """Kernel path against plain path on one batch: the plain path, one
    kernel-path run on its own upstream gradient, codes and critic ReLU
    masks (printed, not held), and REFERENCE_REPEATS kernel-path runs from
    the plain path's upstream gradient at the UNet output and, where a code
    flipped, its codes, and with the critic's image ReLU masks of the plain
    path where a pre-activation lies within RELU_BAND of zero (``mcl_grads``'
    ReLU guard: such a pre-activation takes another mask under another
    summation order, as a code does at a near-tie, and moves the critic's
    small second-order gradients far more than rounding; a flip outside
    the band, or more than RELU_CAP guarded in a run, is a fault). Every
    logged value to LOSS_RTOL, every gradient leaf to
    GRAD_RTOL relative L2 but the known exact zeros (EXACT_ZERO, the
    critic's MCL_EXACT_ZERO, the heads the type does not use), which must
    be within GRAD_ZERO of the global norm on both paths. The MCL term
    dominates the global norm (the critic's and Pi_g's gradients), so a
    small leaf of the UNet is held to GRAD_RTOL like any other, not set
    apart by its size as train-reference does. Returns (reading, faults,
    the leaves with a zero exact gradient)."""
    with plain_path():
        log_p, grads_p, up_p, codes_p, pre_p, _ = mcl_grads(
            model, state, batch, t, noise, draw)
    own = mcl_grads(model, state, batch, t, noise, draw)
    flips = sum((a != b).sum().item() for a, b in zip(own[3], codes_p))
    masks = sum(((a > 0) != (b > 0)).sum().item()
                for a, b in zip(own[4], pre_p))
    forced = codes_p if flips else None
    runs = [mcl_grads(model, state, batch, t, noise, draw, up_p, forced,
                      pre_p) for _ in range(REFERENCE_REPEATS)]
    torch.cuda.synchronize()
    norms = {k: torch.linalg.vector_norm(g).item() for k, g in grads_p.items()}
    total = sum(n * n for n in norms.values()) ** 0.5
    unused = {k for k, n in norms.items() if n == 0.0
              and k.startswith(("mcl.Pi_", "mcl.critic."))}
    known = EXACT_ZERO | MCL_EXACT_ZERO | unused
    zero = sorted(k for k in known if norms[k] <= GRAD_ZERO * total)
    faults = []

    def relative(grads):
        return {k: torch.linalg.vector_norm(g - grads_p[k]).item()
                / max(norms[k], 1e-30) for k, g in grads.items()
                if k not in zero}

    got = []
    for log_k, grads_k, *_, relu in runs:
        if relu["outside"] or relu["guarded"] > RELU_CAP:
            faults.append(f"{label}: critic ReLU masks flipped at "
                          f"{relu['outside']} pre-activations farther than "
                          f"{RELU_BAND} of their layer's largest from zero "
                          f"and at {relu['guarded']} within (at most "
                          f"{RELU_CAP})")
        for k, v in log_p.items():
            if abs(log_k[k] - v) > LOSS_RTOL * abs(v):
                faults.append(f"{label}: {k} kernel {log_k[k]} vs plain {v}")
        rel = relative(grads_k)
        failed = [k for k, r in rel.items() if r > GRAD_RTOL]
        loud = [k for k in zero if torch.linalg.vector_norm(
            grads_k[k]).item() > GRAD_ZERO * total]
        if failed or loud:
            faults.append(f"{label}: gradients off: {failed}; zero-gradient "
                          f"leaves above {GRAD_ZERO} of the global norm: "
                          f"{loud}")
        worst = max((r, k) for k, r in rel.items())
        got.append(f"{worst[0]:.3e} ({worst[1]}, |g| / global "
                   f"{norms[worst[1]] / total:.3e})")
    worst_mcl = max((r, k) for k, r in relative(runs[0][1]).items()
                    if k.startswith(("mcl.", "cond.")))
    worst_own = max((r, k) for k, r in relative(own[1]).items())
    signs = (own[2] != up_p).sum().item()
    reading = (f"{label}: plain loss {log_p['train/loss']:.7f}, loss_mcl "
               f"{log_p['train/loss_mcl']:.7f}; kernel "
               + ", ".join(f"{r[0]['train/loss_mcl']:.7f}" for r in runs)
               + f"; worst leaf {'; '.join(got)}, worst Encoder4 or MCL leaf "
               f"{worst_mcl[0]:.3e} ({worst_mcl[1]}); code flips {flips}; "
               f"critic ReLU masks that differ {masks} (guarded in the held "
               f"runs: {', '.join(str(r[5]['guarded']) for r in runs)}, the "
               f"farthest from zero "
               f"{max(r[5]['worst'] for r in runs):.3e} of its layer's "
               f"largest); on its own "
               f"upstream ({signs} L1 signs differ), codes and masks the "
               f"worst leaf {worst_own[0]:.3e} ({worst_own[1]}); "
               f"{len(grads_p) - len(zero)} of {len(grads_p)} leaves held")
    return reading, faults, zero


@contextlib.contextmanager
def recording_mcl_run(metrics, first_grads, swap_records):
    """Inside ``recording_harness``: each train step's metrics go to
    ``metrics``, the first step's gradients of every trainable leaf to
    ``first_grads``, and the shape of every kernel call of each swap
    visualization to ``swap_records``."""
    step_fn = harness.train_step
    cls = port_callbacks.SwapVisualizationCallback
    swap_fn = cls.on_validation_epoch_end

    def train_step(model, state, batch, **kwargs):
        out = step_fn(model, state, batch, **kwargs)
        if not first_grads:
            first_grads.update({k: p.grad.detach().clone() for k, p in
                                trainable_parameters(model).items()})
        metrics.append(out)
        return out

    def swap_visualization(self, model, *args, **kwargs):
        shapes, remove = record_shapes(model)
        try:
            return swap_fn(self, model, *args, **kwargs)
        finally:
            remove()
            swap_records.append(shapes)

    harness.train_step = train_step
    cls.on_validation_epoch_end = swap_visualization
    try:
        yield
    finally:
        harness.train_step = step_fn
        cls.on_validation_epoch_end = swap_fn


def below_resolution(ref, grads, names, steps) -> set:
    """The leaves of ``names`` whose AdamW update at the run's first step,
    taken from ``ref``'s optimizer state (moments and count) and the first
    step's gradients ``grads`` at the largest LR of the run's ``steps``
    updates, is under half of the fp32 spacing of every element it would
    move: in fp32 that update leaves the leaf as it is."""
    opt = ref.state.optimizer
    group = opt.param_groups[0]
    beta1, beta2 = group["betas"]
    lr = max(ref.state.lr_fn(ref.state.updates + i) for i in range(steps))
    out = set()
    for name, p in trainable_parameters(ref.model).items():
        if name not in names:
            continue
        st, g = opt.state.get(p) or {}, grads[name]
        n = float(st.get("step", 0)) + 1
        m = beta1 * st.get("exp_avg", torch.zeros_like(p)) + (1 - beta1) * g
        v = beta2 * st.get("exp_avg_sq", torch.zeros_like(p)) \
            + (1 - beta2) * g * g
        update = lr * group["weight_decay"] * p.abs() + lr / (
            1 - beta1 ** n) * m.abs() / (
                (v / (1 - beta2 ** n)).sqrt() + group["eps"])
        spacing = torch.nextafter(p.abs(), torch.full_like(p, math.inf)) \
            - p.abs()
        if bool((update < spacing / 2).all()):
            out.add(name)
    return out


def mcl_train_phase(smi, card, per_step, ref, images, seen, out,
                    label="mcl-train", overrides=(), steps=MCL_STEPS,
                    base="flagship_mcl", resume=CKPT):
    """mcl-train: ``main_val -b <base>`` (with the dotlist ``overrides``)
    from ``resume`` (the committed checkpoint by default) for ``steps``
    steps on cached latents, ending in ``test()``; launches against the
    recorded calls, the first step's critic gradients, every leaf's
    movement against ``ref`` (a trainer at the run's start; an Encoder4
    bias of EXACT_ZERO or a projection head the type does not use whose
    first gradient is within GRAD_ZERO of the global norm may stand
    still, and so may a leaf whose first AdamW update is under fp32's
    resolution at every element, ``below_resolution``),
    the step and AdamW's count continuing ``ref``'s, the files; the swap
    visualization at DDIM 50 (SWAP_DDIM).
    Returns
    (launches, the run's checked rows, ms per step, peak bytes)."""
    t0 = time.perf_counter()
    logroot = os.path.join(out, label)
    start, updates = ref.state.step, ref.state.updates
    stamps, metrics, first_grads, swap_records = [], [], {}, []
    with recording_harness(stamps) as records, \
            recording_mcl_run(metrics, first_grads, swap_records):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        attention_core_bwd_vjp.calls = 0
        trainer = main_val.main([
            "-b", base, "-t", "--max_steps", str(start + steps),
            "--resume_ckpt", resume, "-l", logroot, "--device", "cuda",
            *UNCHECKED_METRICS, SWAP_DDIM, *overrides])
        torch.cuda.synchronize()
        launches, plain_calls = read_counts()
        vjp_calls = attention_core_bwd_vjp.calls
        peak = torch.cuda.max_memory_allocated()
        records["on"] = False
    faults = []
    step_shapes, _ = records["step"]
    latent_shapes, _ = records["latents"]
    parts = (latent_shapes, *records["logs"], *swap_records)
    counts = lambda d: {k: len(v) for k, v in d.items() if v}
    if counts(step_shapes) != counts(per_step):
        faults.append(f"the run's first step's calls {counts(step_shapes)}, "
                      f"mcl-shapes' {counts(per_step)}")
    want = {k: steps * len(step_shapes.get(k, ()))
            + sum(len(p.get(k, ())) for p in parts) for k in KERNELS}
    want_vjp = steps * len(step_shapes["attention_core_bwd_vjp"])
    if launches != want or vjp_calls != want_vjp or any(plain_calls.values()):
        faults.append(f"launches {launches}, expected {want}; attention VJP "
                      f"calls {vjp_calls}, expected {want_vjp}; plain calls "
                      f"{plain_calls}")
    # the silent drop's signature: the critic's weights get gradients only
    # through the decoder's backward kernels' own backward
    critic = {k: torch.linalg.vector_norm(g).item()
              for k, g in first_grads.items() if k.startswith("mcl.critic.")}
    live = sorted(set(critic) - MCL_EXACT_ZERO)
    bad = [k for k in live if not (np.isfinite(critic[k]) and critic[k] > 0)]
    loud = [k for k in MCL_EXACT_ZERO if critic[k] != 0.0]
    if len(live) != 4 or bad or loud or not all(
            torch.isfinite(g).all() for g in first_grads.values()):
        faults.append(f"first step's critic gradients {critic}: zero or "
                      f"non-finite {bad}; exact zeros that are not {loud}")
    end = trainable_parameters(trainer.model)
    begin = trainable_parameters(ref.model)
    still = [k for k, p in end.items() if torch.equal(p, begin[k])]
    # a leaf whose exact gradient is zero (an Encoder4 bias before a
    # BatchNorm, a head the type does not use) and whose computed one is
    # within GRAD_ZERO of the global norm: Adam's step on rounding noise
    # and AdamW's decay are under fp32's resolution at the warm-up's LR
    total = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in first_grads.values()])).item()
    idle = {k for k, g in first_grads.items()
            if (k.startswith("mcl.Pi_") or k in EXACT_ZERO)
            and torch.linalg.vector_norm(g).item() <= GRAD_ZERO * total}
    unresolved = below_resolution(ref, first_grads, set(still), steps)
    idle |= unresolved
    if set(still) - MCL_EXACT_ZERO - idle:
        faults.append(f"{len(still)} leaves unchanged after {steps} steps:"
                      f" {sorted(set(still) - MCL_EXACT_ZERO - idle)[:8]}")
    series = {k: [m[k].item() for m in metrics]
              for k in ("train/loss", "train/loss_simple", "train/loss_mcl",
                        "train/mcl_diffusion_ratio", "grad_norm")}
    if not all(np.isfinite(v).all() for v in series.values()):
        faults.append(f"non-finite losses: {series}")
    logdir = trainer.logdir
    step = trainer.state.step
    vis = os.path.join(logdir, "swap_visualization")
    grid_path = os.path.join(vis, f"swap_grid_e-01_s{step:07}.npy")
    n_units = FLAGSHIP_TRAIN["unet_config"]["latent_unit"]
    rows_, side = trainer.swap_cb.num_samples, images.shape[1]
    want_grid = make_grid(np.zeros((rows_ * (n_units + 1), side, side, 3),
                                   np.uint8), nrow=rows_).shape
    pages = [os.path.join(vis, f"factor_{c:02}_e-01.npy")
             for c in range(n_units)]
    for path in (os.path.join(trainer.ckptdir, "last", MODEL_FILE),
                 os.path.join(trainer.ckptdir, "last", STATE_FILE),
                 os.path.join(logdir, "test_results.json"), *pages):
        if not os.path.exists(path):
            faults.append(f"no {path}")
    if not os.path.exists(grid_path) or np.load(grid_path).shape != want_grid:
        faults.append(f"{grid_path}: missing or not {want_grid}")
    test_results = {}
    if os.path.exists(os.path.join(logdir, "test_results.json")):
        with open(os.path.join(logdir, "test_results.json")) as f:
            test_results = json.load(f)
        if sorted(test_results) != ["val/factor_vae_score", "val/mig"] or \
                not all(np.isfinite(v) for v in test_results.values()):
            faults.append(f"test_results.json {test_results}")
    if step != start + steps or trainer.state.updates != updates + steps:
        faults.append(f"step {step}, AdamW count {trainer.state.updates}, "
                      f"from {start} and {updates}")
    kgen = torch.Generator("cuda").manual_seed(SEED + 9)
    shapes = {k: [s for p in (step_shapes, *parts) for s in p.get(k, ())]
              for k in KERNELS}
    rows = {name: check_rows(name, shapes[name], kgen, card, seen)
            for name in KERNELS if shapes[name]}
    if faults:
        raise RuntimeError(f"{label}: " + "; ".join(faults))
    steady = [b - a for a, b in zip(stamps, stamps[1:])][1:]  # steps 3..N
    median_ms = sorted(steady)[len(steady) // 2] * 1e3
    mean_ms = sum(steady) / len(steady) * 1e3
    tm = trainer.timings
    phase(label, t0, f"main_val -b {base} -t --max_steps "
          f"{start + steps} --resume_ckpt {resume} "
          f"{' '.join(overrides)}: {trainer.model.mcl_type} lambda "
          f"{trainer.model.lambda_mcl}, "
          f"{steps} steps at B={trainer.batch_size} on cached latents, "
          f"{median_ms:.3f} ms per step (median of steps 3-{steps}; "
          f"their mean {mean_ms:.3f} ms; first {(stamps[0] - t0) * 1e3:.1f} "
          f"ms from the phase's start, the latent encode included), "
          f"{1e3 / median_ms:.3f} steps/s, peak memory "
          f"{peak / 2**20:.1f} MiB (the grid's included); "
          + ", ".join(f"{k} {v[0]:.6f} -> {v[-1]:.6f}"
                      for k, v in series.items())
          + f"; launches per step { {k: len(v) for k, v in step_shapes.items() if v} }"
          f", total {launches} (expected: {steps} steps, the encode, "
          f"{len(swap_records)} swap visualization), attention VJP calls "
          f"{vjp_calls}; first step's critic gradient norms "
          + ", ".join(f"{k[11:]} {v:.3e}" for k, v in sorted(critic.items()))
          + f"; every leaf moved but the {len(still)} whose exact gradient is"
          f" zero and which AdamW's decay alone moves under fp32's "
          f"resolution, or whose first AdamW update is under it "
          f"({len(unresolved)}: {sorted(unresolved)[:6]}...), of "
          f"{len(end)} ({sorted(still)[:12]}); test() sweep "
          f"{tm['sweep_s']:.3f}s"
          f", metrics {tm['metrics_s']:.3f}s, swap visualization "
          f"{tm['swap_visualization_s']:.3f}s: {test_results} | {smi}")
    return launches, rows, median_ms, peak


def mcl_phases(smi, card, seen, out):
    """mcl-shapes, mcl-kernels, mcl-train, mcl-reference and mcl-profile:
    the MCL fine-tune behind ``main_val -b flagship_mcl`` at B = 128 on the
    full v4 grid the earlier phases left on the card. Returns the checked
    rows of one MCL step's kernel calls, the attention VJP's rows, the
    launches of the run and the calls of one step by kernel."""
    # ---- mcl-shapes: every kernel call of one MCL step, second order too
    t0 = time.perf_counter()
    config = harness.load_configs(["flagship_mcl"], [])
    lightning = config.pop("lightning")
    ref = mcl_trainer(config, lightning, out)
    images = harness.device_images(ref.data.dataset("train").images, "cuda")
    batch, (t, noise) = mcl_first_batch(ref, images)
    model, state = ref.model, ref.state
    per_step = mcl_step_calls(model, state, batch, t, noise)
    phase("mcl-shapes", t0, f"B={ref.batch_size} at global step "
          f"{state.step}, {model.mcl_type} lambda {model.lambda_mcl}: per "
          f"MCL step { {k: len(v) for k, v in per_step.items()} }")

    # ---- mcl-kernels: every kernel at every shape of the MCL step
    t0 = time.perf_counter()
    kgen = torch.Generator("cuda").manual_seed(SEED + 8)
    rows = {name: check_rows(name, per_step[name], kgen, card, seen)
            for name in KERNELS if per_step.get(name)}
    vjp_rows = check_rows("attention_core_bwd_vjp",
                          per_step["attention_core_bwd_vjp"], kgen, card)
    print_yardstick("mcl-kernels", {**rows,
                                    "attention_core_bwd_vjp": vjp_rows})
    phase("mcl-kernels", t0, "each kernel matches its plain version at every "
          f"shape of the MCL step (tol {KERNEL_TOL}), gn_silu_bwd_bwd "
          f"against autograd of the plain backward, the attention VJP "
          f"(PyTorch ops) against autograd of attention_core_bwd_plain")

    # ---- mcl-train: main_val -b flagship_mcl, counters read around it
    launches, run_rows, _, _ = mcl_train_phase(
        smi, card, per_step, ref, images, {**seen, **seen_rows(rows)}, out)

    # ---- mcl-reference: kernel path vs plain path at the run's start
    t0 = time.perf_counter()
    readings, faults = [], []
    reading, wrong, zero = mcl_compare(model.mcl_type, model, state, batch,
                                       t, noise)
    readings.append(reading)
    faults += wrong
    if set(zero) & MCL_EXACT_ZERO != MCL_EXACT_ZERO:
        faults.append(f"exact-zero critic leaves {sorted(MCL_EXACT_ZERO)}, "
                      f"found {sorted(set(zero) & MCL_EXACT_ZERO)}")
    gen = torch.Generator("cuda").manual_seed(SEED + 10)
    b16 = {k: v[:MCL_TYPES_BATCH] for k, v in batch.items()}
    t16, n16 = t[:MCL_TYPES_BATCH], noise[:MCL_TYPES_BATCH]
    side = images.shape[1]  # the decoder's output: the grid's images
    draws = {"nce_logistic": torch.randperm(MCL_TYPES_BATCH, generator=gen,
                                            device="cuda"),
             "denoise_sm": torch.randn(n16.shape, generator=gen,
                                       device="cuda"),
             "jacobian_vjp_infonce": torch.randn(
                 MCL_TYPES_BATCH, side, side, 3, generator=gen, device="cuda")}
    try:
        for typ in MCL_TYPES:
            model.mcl_type = typ
            reading, wrong, _ = mcl_compare(typ, model, state, b16, t16, n16,
                                            draws[typ])
            readings.append(reading)
            faults += wrong
    finally:
        model.mcl_type = "infonce_mechgrad"
    if faults:
        raise RuntimeError("mcl-reference: " + " | ".join(readings + faults))
    phase("mcl-reference", t0, f"B={ref.batch_size} (the other types at "
          f"B={MCL_TYPES_BATCH}) at the run's starting weights, the same "
          f"batch, z, t and noise: every logged value within {LOSS_RTOL}, "
          f"every trainable leaf (UNet, Encoder4, critic, Pi_g, Pi_u) within "
          f"relative L2 {GRAD_RTOL} on each of {REFERENCE_REPEATS} "
          f"kernel-path runs from the plain path's gradient at the UNet "
          f"output; the exact-zero leaves within {GRAD_ZERO} of the global "
          f"norm: {zero}. " + " | ".join(readings))

    # ---- mcl-profile: one MCL train step's device time (not pass/fail)
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SEED + 11)
    print_profile("mcl-profile", t0, f"one MCL train step at "
                  f"B={ref.batch_size}", profile(
                      lambda: train_step(model, state, batch, generator=gen),
                      calls=2))
    del ref, model, state
    torch.cuda.empty_cache()
    return rows, vjp_rows, launches, per_step


def mcl_fisher_phases(smi, card, seen, out):
    """mcl-fisher-shapes, mcl-fisher-kernels, mcl-fisher-train,
    mcl-fisher-reference and mcl-fisher-profile: ``main_val -b flagship_mcl
    model.params.mcl_type=fisher_sm model.params.lambda_mcl=0.01`` at B =
    128 on the v4 grid the MCL phases left on the card. Its Hutchinson
    divergence differentiates the frozen decoder's score once more: a third
    order, through ``_GNSiLUBwdBwd`` (``gn_silu_bwd3``) and the recorded
    attention VJP. Returns the checked rows of one step's kernel calls,
    the attention VJP's and its third order's rows, the launches of the run
    and the calls of one step by kernel."""
    # ---- mcl-fisher-shapes: every kernel call of one fisher_sm step
    t0 = time.perf_counter()
    config = harness.load_configs(["flagship_mcl"], list(FISHER_OVERRIDES))
    lightning = config.pop("lightning")
    ref = mcl_trainer(config, lightning, out)
    model, state = ref.model, ref.state
    if model.mcl_type != "fisher_sm" or model.lambda_mcl != 0.01:
        raise RuntimeError(f"mcl-fisher: the overrides gave {model.mcl_type} "
                           f"lambda {model.lambda_mcl}")
    images = harness.device_images(ref.data.dataset("train").images, "cuda")
    batch, (t, noise) = mcl_first_batch(ref, images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_step = mcl_step_calls(model, state, batch, t, noise)
    step_peak = torch.cuda.max_memory_allocated()
    if not per_step.get("gn_silu_bwd3"):
        raise RuntimeError(f"mcl-fisher-shapes: no third-order GN-SiLU call "
                           f"in a fisher_sm step: {per_step.keys()}")
    phase("mcl-fisher-shapes", t0, f"B={ref.batch_size} at global step "
          f"{state.step}, {model.mcl_type} lambda {model.lambda_mcl}: per "
          f"step { {k: len(v) for k, v in per_step.items()} }; peak memory "
          f"of one step {step_peak / 2**20:.1f} MiB (the grid's included)")

    # ---- mcl-fisher-kernels: every kernel at every shape of the step
    t0 = time.perf_counter()
    kgen = torch.Generator("cuda").manual_seed(SEED + 12)
    rows = {name: check_rows(name, per_step[name], kgen, card, seen)
            for name in KERNELS if per_step.get(name)}
    other = {name: check_rows(name, per_step[name], kgen, card, seen)
             for name in ("attention_core_bwd_vjp", "attention_core_bwd_vjp3")}
    print_yardstick("mcl-fisher-kernels", {**rows, **other})
    phase("mcl-fisher-kernels", t0, "each kernel matches its plain version "
          f"at every shape of the fisher_sm step (tol {KERNEL_TOL}), "
          "gn_silu_bwd3 against autograd of the plain backward recorded "
          "twice, the attention VJP's third order (autograd of its recorded "
          "PyTorch ops) against the plain route's")

    # ---- mcl-fisher-train: the run, counters read around it
    launches, _, step_ms, peak = mcl_train_phase(
        smi, card, per_step, ref, images,
        {**seen, **seen_rows(rows, other)}, out, label="mcl-fisher-train",
        overrides=FISHER_OVERRIDES, steps=FISHER_STEPS)

    # ---- mcl-fisher-reference: kernel path vs plain path at the start
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SEED + 13)
    b16 = {k: v[:MCL_TYPES_BATCH] for k, v in batch.items()}
    t16, n16 = t[:MCL_TYPES_BATCH], noise[:MCL_TYPES_BATCH]
    eps = torch.randn(n16.shape, generator=gen, device="cuda")
    reading, faults, zero = mcl_compare("fisher_sm", model, state, b16, t16,
                                        n16, eps)
    if set(zero) & MCL_EXACT_ZERO != MCL_EXACT_ZERO:
        faults.append(f"exact-zero critic leaves {sorted(MCL_EXACT_ZERO)}, "
                      f"found {sorted(set(zero) & MCL_EXACT_ZERO)}")
    if faults:
        raise RuntimeError("mcl-fisher-reference: " + " | ".join(
            [reading] + faults))
    phase("mcl-fisher-reference", t0, f"B={MCL_TYPES_BATCH} at the run's "
          f"starting weights, the same batch, z, t, noise and Hutchinson "
          f"eps: every logged value within {LOSS_RTOL}, every trainable leaf "
          f"within relative L2 {GRAD_RTOL} on each of {REFERENCE_REPEATS} "
          f"kernel-path runs from the plain path's gradient at the UNet "
          f"output; the exact-zero leaves within {GRAD_ZERO} of the global "
          f"norm: {zero}. {reading}")

    # ---- mcl-fisher-profile: one fisher_sm step's device time
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SEED + 14)
    print_profile("mcl-fisher-profile", t0, f"one fisher_sm step at "
                  f"B={ref.batch_size}", profile(
                      lambda: train_step(model, state, batch, generator=gen),
                      calls=2))
    del ref, model, state
    torch.cuda.empty_cache()
    return rows, other, launches, per_step, dict(ms_per_step=step_ms,
                                                 peak_mib=peak / 2**20)


def redraw_trainable(model, gen):
    """Draw every trainable leaf anew from ``gen`` as the CPU whole-step
    tests value theirs: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²),
    every other leaf N(0, 0.1²). A fresh init has zero output convolutions
    and, at the warmup's LR, leaves whose gradients are tiny without being
    zero; at this generic point every leaf but the exact-zero ones carries
    a gradient the reference check can hold to GRAD_RTOL."""
    with torch.no_grad():
        for name, p in trainable_parameters(model).items():
            noise = torch.randn(p.shape, generator=gen, device=p.device)
            if p.dim() > 1:   # conv / linear weights, the warp MLPs' w1-w3
                fan_in = (p.shape[-2] if name.startswith("cond.warp_mlps.")
                          else p[0].numel())
                p.copy_(noise / fan_in ** 0.5)
            elif name.endswith(".weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def faces_phases(smi, card, seen):
    """Phases 13-17 on the faces configuration's train step from a fresh
    seeded init. ``seen`` holds the rows checked in earlier phases by
    (kernel, shape). Returns the checked rows of every kernel at the faces
    micro-step's shapes, the launches of the train run, and the calls of
    one micro-step by kernel."""
    # ---- 13: every kernel call of one micro-step
    t0 = time.perf_counter()
    config = FACES_TRAIN
    seed, micro = config["seed"], config["batch_size"]
    accumulate = config["accumulate_grad_batches"]
    model, state, _ = train_steps.fresh_for_training(config, seed, "cuda")
    images = train_steps.training_images("faces", config, "cuda")
    gen = torch.Generator("cuda").manual_seed(seed)
    first = images[torch.from_numpy(
        epoch_batches(len(images), micro, seed)[0]).cuda()]
    per_micro = record_step(model, state, first,
                            *draw_t_and_noise(model, micro, gen))
    flash_shapes = {k: sorted(set(per_micro[k])) for k in FLASH}
    phase("faces-shapes", t0, f"{len(images)} images of "
          f"{tuple(images.shape[1:])}, micro-batch {micro}, global step "
          f"{state.step}: per micro-step "
          f"{ {k: len(v) for k, v in per_micro.items()} }; flash shapes "
          f"(B, H, N, dh) {flash_shapes}; attention_core shapes "
          f"{sorted(set(per_micro['attention_core']))}; GN-SiLU shapes "
          f"{sorted(set(s for s, _, _ in per_micro['groupnorm_silu']))}")

    # ---- 14: every kernel at every shape of the micro-step
    t0 = time.perf_counter()
    kgen = torch.Generator("cuda").manual_seed(SEED + 3)
    rows = {name: check_rows(name, per_micro[name], kgen, card, seen)
            for name in KERNELS if per_micro.get(name)}
    print_yardstick("faces-kernels", rows)
    phase("faces-kernels", t0, "each kernel matches its plain version at "
          f"every shape of the faces micro-step (tol {KERNEL_TOL}); per "
          "micro-step: " + "; ".join(
              f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f}, plain "
              f"{v['plain_ms']:.3f}, library {v['library_ms']:.3f}"
              + (f", attention_core {v['attention_core_ms']:.3f}"
                 if "attention_core_ms" in v else "") + ")"
              for k, v in ((k, summed(k, r)) for k, r in rows.items())))

    # ---- 15: the train run, counters read around it alone
    t0 = time.perf_counter()
    steps = FACES_UPDATES * accumulate
    params = trainable_parameters(model)
    first_param = next(iter(params.values()))
    prev = {k: p.detach().clone() for k, p in params.items()}
    prev_ema = {k: v.clone() for k, v in state.ema.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics, moved, ema_moved, adam_counts = [], [], [], [], []
    t1 = time.perf_counter()
    for m in train_steps.run(model, state, images, steps, micro, seed, gen):
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        metrics.append(m)
        # outside the timed span: which state moved in this micro-step
        moved.append(any(not torch.equal(p, prev[k])
                         for k, p in params.items()))
        ema_moved.append(any(not torch.equal(v, prev_ema[k])
                             for k, v in state.ema.params.items()))
        adam = state.optimizer.state.get(first_param, {}).get("step")
        adam_counts.append(0 if adam is None else int(adam))
        prev = {k: p.detach().clone() for k, p in params.items()}
        prev_ema = {k: v.clone() for k, v in state.ema.params.items()}
        t1 = time.perf_counter()
    launches, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    series = {k: torch.stack([m[k] for m in metrics]).tolist()
              for k in ("train/loss", "train/loss_simple", "grad_norm")}
    if not all(torch.isfinite(torch.tensor(v)).all() for v in series.values()):
        raise RuntimeError(f"non-finite loss or grad_norm: {series}")
    boundary = [(i + 1) % accumulate == 0 for i in range(steps)]
    if moved != boundary:
        raise RuntimeError(f"parameters moved at micro-steps "
                           f"{[i + 1 for i, v in enumerate(moved) if v]}, "
                           f"expected every {accumulate}th")
    if adam_counts != [(i + 1) // accumulate for i in range(steps)]:
        raise RuntimeError(f"AdamW counts {adam_counts}")
    if not all(ema_moved[accumulate:]) or state.ema.num_updates != steps:
        raise RuntimeError(f"the EMA stood still at micro-steps "
                           f"{[i + 1 for i, v in enumerate(ema_moved) if not v]}"
                           f" ({state.ema.num_updates} updates)")
    if (state.step, state.updates) != (steps, FACES_UPDATES):
        raise RuntimeError(f"global step {state.step}, updates "
                           f"{state.updates}")
    expected = {k: len(per_micro.get(k, ())) * steps for k in KERNELS}
    if launches != expected or any(plain_calls.values()):
        raise RuntimeError(f"launches {launches}, expected {expected}; "
                           f"plain calls {plain_calls}")
    rest = times[accumulate:]  # after the first update
    per_update = [sum(times[i:i + accumulate])
                  for i in range(accumulate, steps, accumulate)]
    median = lambda v: sorted(v)[len(v) // 2]
    phase("faces-train", t0, f"{FACES_UPDATES} updates x {accumulate} "
          f"micro-batches of {micro} from a fresh init (seed {seed}): per "
          f"micro-step {median(rest) * 1e3:.3f} ms median, "
          f"{sum(rest) / len(rest) * 1e3:.3f} ms mean (micro-steps "
          f"{accumulate + 1}-{steps}; first {times[0] * 1e3:.1f} ms); per "
          f"update {median(per_update) * 1e3:.3f} ms median, "
          f"{sum(per_update) / len(per_update) * 1e3:.3f} ms mean (updates "
          f"2-{FACES_UPDATES}), {len(per_update) / sum(per_update):.3f} "
          f"updates/s; peak memory {peak / 2**20:.1f} MiB; "
          + ", ".join(f"{k} {v[0]:.6f} -> {v[-1]:.6f}"
                      for k, v in series.items())
          + f", lr {metrics[0]['lr']:.4e} -> {metrics[-1]['lr']:.4e}; "
          f"parameters and AdamW moved at micro-steps "
          f"{[i + 1 for i, v in enumerate(moved) if v]} only, the EMA at "
          f"every micro-step from {accumulate + 1} on (none before the "
          f"first update: the EMA starts equal to the parameters); launches "
          f"per micro-step { {k: v // steps for k, v in launches.items()} },"
          f" plain calls {plain_calls} | {smi}")

    # ---- 16: one forward + backward at micro-batch 2, kernel vs plain path
    t0 = time.perf_counter()
    redraw_trainable(model, torch.Generator("cuda").manual_seed(seed + 1))
    batch = first[:FACES_REFERENCE_BATCH]
    reference_check("faces-reference", t0, model, state, batch, [
        draw_t_and_noise(model, FACES_REFERENCE_BATCH, gen)
        for _ in range(REFERENCE_DRAWS)])

    # ---- 17: where the time of one optimizer update goes (not pass/fail)
    t0 = time.perf_counter()

    def update():
        for _ in range(accumulate):
            train_step(model, state, first, generator=gen)
    print_profile("faces-profile", t0, f"one update ({accumulate} "
                  f"micro-steps of {micro})", profile(update, calls=1))
    return rows, launches, per_micro


def faces_model(seed: int):
    """The faces configuration's model from a fresh init drawn from
    ``seed``, every trainable leaf then redrawn (``redraw_trainable``): a
    fresh init's zero output convolutions would make ε identically zero."""
    model = LatentDiffusion(FACES, "cuda")
    model.init_parameters(torch.Generator("cuda").manual_seed(seed))
    redraw_trainable(model, torch.Generator("cuda").manual_seed(seed + 1))
    return model


def record_serve_call(model, x_T, t, tokens):
    """Every kernel call of one UNet call on ``x_T`` and of one VQ decode of
    ``x_T``, by kernel: (ε, UNet calls, decode calls, (peak, peak)), each
    peak the most bytes allocated during that call, what was allocated
    before it included."""
    records, remove = record_shapes(model)

    def run(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        calls = {k: list(v) for k, v in records.items()}
        for v in records.values():
            v.clear()
        return out, calls, torch.cuda.max_memory_allocated()

    try:
        eps, per_unet, unet_peak = run(lambda: model.apply_model(x_T, t,
                                                                 tokens))
        _, per_decode, decode_peak = run(
            lambda: model.decode_first_stage(x_T))
    finally:
        remove()
    return eps, per_unet, per_decode, (unet_peak, decode_peak)


def faces_serve_phases(smi, card, seen):
    """Phases 18-23 on the faces configuration's serving paths. ``seen``
    holds the rows checked in earlier phases by (kernel, shape). Returns the
    checked rows of every kernel at one UNet call at the swap's chunk (32)
    plus one 256 px decode of 32, the rows checked at the other batches the
    serving paths run (16 and 64), the launches of the swap request and of
    the FID sampling, and the calls of that UNet call plus decode by
    kernel."""
    # ---- 18: every kernel call of one UNet call and one decode per batch
    t0 = time.perf_counter()
    seed = FACES_TRAIN["seed"]
    size = FACES["first_stage_config"]["ddconfig"]["resolution"]
    model = faces_model(seed)
    images = pick_inputs(FACES_INPUTS, SEED, "faces")
    u = model.cond_encoding(images)
    n_units = u.shape[1]
    tokens = model.cond_warp(
        swap_conditions(u).reshape(n_units * FACES_INPUTS, n_units))
    n_samples = len(tokens)
    side = model.image_size
    chunk = TOKEN_BUDGET // (side * side)  # swap_sample's UNet chunk
    chunks = [min(chunk, n_samples - i) for i in range(0, n_samples, chunk)]
    gen = torch.Generator("cuda").manual_seed(SEED)
    first = DDIMSchedule.create(model.schedule, FACES_DDIM_STEPS).timesteps[-1]
    by_batch = {}
    for b in sorted({*chunks, FACES_FID_NUM}):
        x_b = torch.randn(b, side, side, model.channels, generator=gen,
                          device="cuda")
        t_b = torch.full((b,), int(first), device="cuda")
        by_batch[b] = (x_b, t_b, *record_serve_call(model, x_b, t_b,
                                                    tokens[:b]))
    x_T, t_first, eps_kernel, per_unet, per_decode, peaks = by_batch[chunk]
    with plain_path():
        eps_plain = model.apply_model(x_T, t_first, tokens[:chunk])
    torch.cuda.synchronize()
    torch.testing.assert_close(eps_kernel, eps_plain, **PATH_TOL)
    if eps_plain.abs().max().item() == 0.0:
        raise RuntimeError("the UNet's ε is identically zero")
    per_call = {k: per_unet[k] + per_decode[k] for k in per_unet}
    phase("faces-serve-shapes", t0, f"{len(images)} rendered faces of "
          f"{tuple(images.shape[1:])} -> {n_samples} swap samples; per UNet "
          f"call at B={chunk} "
          f"{ {k: len(v) for k, v in per_unet.items()} }, per {size} px decode "
          f"{ {k: len(v) for k, v in per_decode.items()} }, the same counts "
          f"at B={sorted(b for b in by_batch if b != chunk)}; fused_attention "
          f"shapes (B, N, C, M, D, H, dh) at B={chunk} "
          f"{sorted(set(per_unet['fused_attention']))}; first UNet eps "
          f"kernel vs plain max_abs_err "
          f"{(eps_kernel - eps_plain).abs().max().item():.3e} (tol {PATH_TOL});"
          f" peak memory at B={chunk}: UNet call {peaks[0] / 2**20:.1f} MiB, "
          f"decode {peaks[1] / 2**20:.1f} MiB (the model's weights "
          f"included) | {smi}")
    for b, (_, _, _, unet_b, decode_b, _) in by_batch.items():
        counts = [{k: len(v) for k, v in c.items()} for c in (unet_b, decode_b)]
        if counts != [{k: len(v) for k, v in c.items()}
                      for c in (per_unet, per_decode)]:
            raise RuntimeError(f"kernel calls at B={b} {counts} differ from "
                               f"those at B={chunk}")

    # ---- 19: every kernel at every shape of the UNet calls and decodes
    t0 = time.perf_counter()
    kgen = torch.Generator("cuda").manual_seed(SEED + 4)
    rows = {name: check_rows(name, per_call[name], kgen, card, seen)
            for name in per_call if per_call[name]}
    print_yardstick(f"faces-serve-kernels B={chunk}", rows)
    other = {b: v for b, v in by_batch.items() if b != chunk}
    print(f"  at B={sorted(other)}:", flush=True)
    seen = {**seen, **seen_rows(rows)}
    other_rows = {name: check_rows(
        name, [s for (_, _, _, unet_b, decode_b, _) in other.values()
               for s in unet_b[name] + decode_b[name]], kgen, card, seen)
        for name in per_call if per_call[name]}
    print_yardstick(f"faces-serve-kernels B={sorted(other)}", other_rows)
    phase("faces-serve-kernels", t0, "each kernel matches its plain version "
          f"at every shape of one UNet call and one {size} px decode at "
          f"B={sorted(by_batch)} (tol {KERNEL_TOL}); per UNet call + decode "
          f"at B={chunk}: " + "; ".join(
              f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f}, plain "
              f"{v['plain_ms']:.3f}, library {v['library_ms']:.3f}"
              + "".join(f", {b[:-3]} {v[b]:.3f}" for b in set(BASELINE.values())
                        if b in v) + ")"
              for k, v in ((k, summed(k, r)) for k, r in rows.items())))
    del by_batch, other

    # ---- 20: one swap request as the eval chain runs it
    t0 = time.perf_counter()
    expected = {k: (len(per_unet.get(k, ())) * FACES_DDIM_STEPS
                    + len(per_decode.get(k, ()))) * len(chunks)
                for k in KERNELS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_req = time.perf_counter()
    out = swap_sample(model, images, ddim_steps=FACES_DDIM_STEPS, eta=0.0,
                      generator=torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_req
    swap_launches, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (n_samples, size, size, 3):
        raise RuntimeError(f"faces swap output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise RuntimeError("faces swap output has non-finite values")
    if swap_launches != expected or any(plain_calls.values()):
        raise RuntimeError(f"launches {swap_launches}, expected {expected}; "
                           f"plain calls {plain_calls}")
    phase("faces-serve", t0, f"swap request B={FACES_INPUTS} -> {n_samples} "
          f"samples of {size} px, UNet chunks {chunks}, DDIM "
          f"{FACES_DDIM_STEPS}, eta 0: wall {wall:.3f}s, "
          f"{n_samples / wall:.3f} samples/s, peak memory "
          f"{peak / 2**20:.1f} MiB, launches {swap_launches} (expected), "
          f"plain calls {plain_calls} | {smi}")
    del out

    # ---- 21: a short chain and its decode, kernel path vs plain path
    t0 = time.perf_counter()
    n_ref = FACES_REFERENCE_SAMPLES
    x_ref = torch.randn(n_ref, side, side, model.channels, generator=gen,
                        device="cuda")
    noises = torch.randn(10, n_ref, side, side, model.channels,
                         generator=gen, device="cuda")

    def chains():
        return (model.sample_ddim(tokens[:n_ref], steps=10, x_T=x_ref),
                model.sample_ddim(tokens[:n_ref], steps=10, eta=1.0,
                                  x_T=x_ref, noises=noises))
    lat_k, eta1_k = chains()
    img_k = model.decode_first_stage(lat_k, force_not_quantize=True)
    with plain_path():
        lat_p, eta1_p = chains()
        img_p = model.decode_first_stage(lat_k, force_not_quantize=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lat_k, lat_p, **PATH_TOL)
    torch.testing.assert_close(eta1_k, eta1_p, **PATH_TOL)
    torch.testing.assert_close(img_k, img_p, **PATH_TOL)
    phase("faces-serve-reference", t0, f"{n_ref} samples: 10-step chain "
          f"max_abs_err {(lat_k - lat_p).abs().max().item():.3e} at eta 0, "
          f"{(eta1_k - eta1_p).abs().max().item():.3e} at eta 1 (injected "
          f"noise), decode max_abs_err "
          f"{(img_k - img_p).abs().max().item():.3e} (tol {PATH_TOL})")
    del lat_k, img_k, lat_p, img_p, eta1_k, eta1_p

    # ---- 22: FID of 64 reconstructions against their 64 real faces
    t0 = time.perf_counter()
    real = fid_cli.real_images(FACES_FID_NUM, device="cuda")
    expected = {k: len(per_unet.get(k, ())) * FACES_DDIM_STEPS
                + len(per_decode.get(k, ())) for k in KERNELS}
    torch.cuda.synchronize()
    reset_counts()
    t_req = time.perf_counter()
    recon = fid_cli.reconstructions(model, real, FACES_FID_NUM,
                                    FACES_DDIM_STEPS, 1.0)
    torch.cuda.synchronize()
    sample_wall = time.perf_counter() - t_req
    fid_launches, plain_calls = read_counts()
    if fid_launches != expected or any(plain_calls.values()):
        raise RuntimeError(f"launches {fid_launches}, expected {expected}; "
                           f"plain calls {plain_calls}")
    t_req = time.perf_counter()
    inception = fid_lib.fid_inception("cuda", seed=0)
    score = fid_lib.compute_fid(inception, real.astype("float32") / 255.0,
                                recon, batch_size=FACES_FID_NUM)
    fid_wall = time.perf_counter() - t_req
    if recon.shape != (FACES_FID_NUM, size, size, 3) or not (
            score == score and abs(score) != float("inf")):
        raise RuntimeError(f"FID {score} on reconstructions of shape "
                           f"{recon.shape}")
    phase("faces-fid", t0, f"{FACES_FID_NUM} rendered faces vs "
          f"{FACES_FID_NUM} reconstructions (one batch, DDIM "
          f"{FACES_DDIM_STEPS}, eta 1): sampling {sample_wall:.3f}s, "
          f"Inception features and the Fréchet distance {fid_wall:.3f}s; "
          f"FID {score:.6f} (uncalibrated: random-init Inception); "
          f"launches {fid_launches} (expected), plain calls {plain_calls} "
          f"| {smi}")
    del inception, recon

    # ---- 23: where the time of one UNet call goes (not pass/fail)
    t0 = time.perf_counter()
    print_profile("faces-serve-profile", t0, f"one UNet call at "
                  f"B={chunk}", profile(lambda: model.apply_model(
                      x_T, t_first, tokens[:chunk])))
    return (rows, other_rows,
            {"faces_swap": swap_launches, "faces_fid": fid_launches}, per_call)


@contextlib.contextmanager
def timed_calls(module, name, seconds):
    """While on, each call of ``module.name`` appends its device-synchronised
    seconds to ``seconds``."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def replayable_ldm_steps(replay):
    """While on, the harness's first stage-2 train step puts a copy of the
    model as it stands before it into ``replay["model"]``, and every train
    step appends (a copy of its batch, its generator's state) to
    ``replay["steps"]``, so that ``replayed_state`` can run the same
    micro-steps outside the harness. Enter it last: its copy is taken
    before the other wrappers' hooks are on the model."""
    step_fn = harness.train_step

    def train_step(model, state, batch, **kwargs):
        if "model" not in replay:
            replay["model"] = copy.deepcopy(model)
        replay.setdefault("steps", []).append((
            {k: v.clone() for k, v in batch.items()},
            kwargs["generator"].get_state()))
        return step_fn(model, state, batch, **kwargs)

    harness.train_step = train_step
    try:
        yield
    finally:
        harness.train_step = step_fn


def replayed_state(replay, trainer):
    """The model and train state that ``loop.train_step`` gives, outside the
    harness, from the copy ``replayable_ldm_steps`` took over the micro-steps
    it recorded, each on its batch with its generator's state."""
    model = replay["model"]
    state = create_train_state(model, {
        **trainer.model_params, "batch_size": trainer.batch_size,
        "accumulate_grad_batches": trainer.accumulate},
        learning_rate=trainer.learning_rate)
    for batch, gen_state in replay["steps"]:
        gen = torch.Generator(model.device)
        gen.set_state(gen_state)
        train_step(model, state, batch, generator=gen)
    return model, state


def adam_moments_off(model, state, ref_model, ref_state):
    """The names of the trainable leaves whose AdamW exp_avg differs from
    the reference's by more than 1e-4 of the leaf's L2 norm (a sum taken in
    another order may differ in its last bits; a leaf at exactly zero must
    stay so), the count of leaves whose exp_avg is nonzero, and the largest
    error relative to the leaf's norm."""
    ref = trainable_parameters(ref_model)
    off, nonzero, worst = [], 0, 0.0
    for k, p in trainable_parameters(model).items():
        got = state.optimizer.state[p]["exp_avg"]
        want = ref_state.optimizer.state[ref[k]]["exp_avg"]
        err = torch.linalg.vector_norm(got - want).item()
        norm = torch.linalg.vector_norm(want).item()
        if err > 1e-4 * norm:
            off.append(k)
        if norm > 0:
            nonzero += 1
            worst = max(worst, err / norm)
    return off, nonzero, worst


@contextlib.contextmanager
def watched_ldm_steps(moved, ema_moved, times):
    """While on, each stage-2 train step of the harness appends its own
    device-synchronised seconds to ``times``, (its global step, the number
    of trainable leaves it changed) to ``moved`` and whether it changed the
    EMA to ``ema_moved``; the snapshots and comparisons stay outside the
    timed span."""
    step_fn = harness.train_step

    def train_step(model, state, batch, **kwargs):
        params = trainable_parameters(model)
        before = {k: p.detach().clone() for k, p in params.items()}
        ema = {k: v.clone() for k, v in state.ema.params.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(model, state, batch, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        moved.append((state.step, sum(not torch.equal(p, before[k])
                                      for k, p in params.items())))
        ema_moved.append(any(not torch.equal(v, ema[k])
                             for k, v in state.ema.params.items()))
        return out

    harness.train_step = train_step
    try:
        yield
    finally:
        harness.train_step = step_fn


def same_state(a, b):
    """The names of the trainable leaves, AdamW entries, EMA leaves,
    Encoder4 and first-stage entries (batch statistics included) and
    accumulation buffers in which two stage-2 trainers differ, and the
    step, counts and scale factor where they differ."""
    pa, pb = trainable_parameters(a.model), trainable_parameters(b.model)
    sa, sb = a.state, b.state
    off = [k for k, p in pa.items() if not torch.equal(p, pb[k])]
    for k, p in pa.items():
        for name, v in sa.optimizer.state[p].items():
            w = sb.optimizer.state[pb[k]].get(name)
            if w is None or not torch.equal(torch.as_tensor(v).cpu(),
                                            torch.as_tensor(w).cpu()):
                off.append(f"adamw/{k}/{name}")
    off += [f"ema/{k}" for k, v in sa.ema.params.items()
            if not torch.equal(v, sb.ema.params[k])]
    for part in ("cond_stage_model", "first_stage_model"):
        sda = getattr(a.model, part).state_dict()
        sdb = getattr(b.model, part).state_dict()
        off += [f"{part}/{k}" for k, v in sda.items()
                if not torch.equal(v, sdb[k])]
    if (sa.acc_grads is None) != (sb.acc_grads is None) or (
            sa.acc_grads is not None and not all(
                torch.equal(x, y) for x, y in zip(sa.acc_grads,
                                                  sb.acc_grads))):
        off.append("acc_grads")
    for field in ("step", "updates", "mini_step"):
        if getattr(sa, field) != getattr(sb, field):
            off.append(field)
    if not torch.equal(sa.scale_factor.cpu(), sb.scale_factor.cpu()) or \
            sa.ema.num_updates != sb.ema.num_updates:
        off.append("scale_factor or EMA count")
    return off


def faces_harness_phases(smi, card, seen, out, vq_logdir):
    """faces-harness: ``main_val -b faces -t`` (the faces EncDiff stage of
    ``scripts/round3_pipeline.sh``) over the faces VQ-GAN run's
    ``checkpoints/last``, on the full face grid (cached on the host since
    faces-vq-shapes, uploaded again), with the latents cached, 4-way
    accumulation, the image log forced to the last micro-step, ``last``
    and ``test()``. ``seen`` holds the rows checked in earlier phases.
    Returns the checked rows of one micro-step's kernel calls, the other
    checked rows (the latent encode, the image log), the run's launches,
    the calls of one micro-step by kernel, its numbers and run
    directory."""
    t0 = time.perf_counter()
    last_vq = os.path.join(vq_logdir, "checkpoints", "last")
    n = FACES_LDM_MICRO_STEPS
    stamps, times, moved, ema_moved, upload_s, latents_s, log_s = \
        [], [], [], [], [], [], []
    replay = {}
    argv = ["-b", "faces", "-t", "--max_steps", str(n), "-l",
            os.path.join(out, "faces"), "--seed", str(FACES_LDM_SEED),
            "--device", "cuda",
            f"model.params.first_stage_config.params.ckpt_path={last_vq}",
            f"lightning.callbacks.image_logger.params.batch_frequency={n}"]
    with contextlib.ExitStack() as stack:
        records = stack.enter_context(recording_harness(stamps))
        stack.enter_context(watched_ldm_steps(moved, ema_moved, times))
        stack.enter_context(timed_calls(harness, "device_images", upload_s))
        stack.enter_context(timed_calls(harness, "precompute_latents",
                                        latents_s))
        stack.enter_context(timed_calls(harness, "log_images", log_s))
        stack.enter_context(replayable_ldm_steps(replay))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t_run = time.perf_counter()
        trainer = main_val.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches, plain_calls = read_counts()
        peak = torch.cuda.max_memory_allocated()
        records["on"] = False
    model, state = trainer.model, trainer.state
    params = trainer.model_params
    # the first stage: the faces VQ-GAN run's generator, the widened rows of
    # post_quant_conv at the seeded init's draws
    faults = first_stage_faults(model, params, last_vq, FACES_LDM_SEED)

    # the latent cache against a direct encode of sampled rows; scale_by_std
    # from the first micro-batch's cached code
    _, z = records["latents"]
    images = harness.device_images(trainer.data.dataset("train").images,
                                   "cuda")
    rows = torch.from_numpy(np.sort(np.random.RandomState(SEED).choice(
        len(images), FACES_LATENT_ROWS, replace=False))).cuda()
    direct = model.encode_first_stage(model.split_batch(images[rows])[0])
    torch.cuda.synchronize()
    z_err = (z[rows] - direct).abs().max().item()
    try:
        torch.testing.assert_close(z[rows], direct, **LATENT_TOL)
    except AssertionError as e:
        faults.append(f"latent cache against a direct encode: {e}")
    _, first = records["step"]
    want_sf = 1.0 / first["batch"]["z"].float().reshape(-1).std(
        unbiased=False)
    if not torch.allclose(state.scale_factor, want_sf, rtol=1e-6, atol=0):
        faults.append(f"scale factor {state.scale_factor.item()}, 1/std of "
                      f"the first micro-batch's code {want_sf.item()}")
    del direct

    # the updates: the parameters move on every 4th micro-step only, AdamW
    # steps every leaf on each update, the EMA moves from the first update
    # on; the LR is accumulate x batch x base LR times the warm-up
    accumulate, bs = trainer.accumulate, trainer.batch_size
    boundary = [s for s in range(1, n + 1) if s % accumulate == 0]
    counts = {int(st["step"]) for st in state.optimizer.state.values()}
    if [s for s, k in moved if k] != boundary or counts != {n // accumulate} \
            or len(state.optimizer.state) != len(
                trainable_parameters(model)):
        faults.append(f"(micro-step, leaves moved) {moved}; AdamW counts "
                      f"{counts} over {len(state.optimizer.state)} leaves")
    if ema_moved != [s >= accumulate for s in range(1, n + 1)]:
        faults.append(f"EMA moved at {ema_moved}")
    # at the warm-up's LRs most leaves cannot move in fp32, so the moments
    # show the accumulated gradients: AdamW's exp_avg after the two updates
    # must equal that of loop.train_step run outside the harness on the
    # same micro-batches and draws
    ref_model, ref_state = replayed_state(replay, trainer)
    moments_off, nonzero, moments_err = adam_moments_off(
        model, state, ref_model, ref_state)
    if len(replay["steps"]) != n or moments_off:
        faults.append(f"AdamW exp_avg against {len(replay['steps'])} "
                      f"micro-steps replayed outside the harness: "
                      f"{len(moments_off)} leaves differ "
                      f"({moments_off[:6]})")
    del ref_model, ref_state, replay
    peak_lr = accumulate * bs * trainer.base_lr
    sched = params["scheduler_config"]
    warm = lambda k: (sched["f_start"][0] + (sched["f_max"][0]
                      - sched["f_start"][0]) * k / sched["warm_up_steps"][0])
    lrs = trainer.lr_monitor.history
    if abs(trainer.learning_rate - FACES_LDM_LR) > 1e-12 * FACES_LDM_LR \
            or abs(peak_lr - FACES_LDM_LR) > 1e-12 * FACES_LDM_LR \
            or [s for s, _ in lrs] \
            != list(range(1, n + 1)) or any(
                abs(lr - peak_lr * warm((s - 1) // accumulate))
                > 1e-6 * peak_lr * warm((s - 1) // accumulate)
                for s, lr in lrs):
        faults.append(f"LR {trainer.learning_rate}: (step, lr) {lrs}")

    # last, test() and the image log
    last = os.path.join(trainer.ckptdir, "last")
    for name in (MODEL_FILE, STATE_FILE):
        if not os.path.exists(os.path.join(last, name)):
            faults.append(f"no {name} in {last}")
    results_path = os.path.join(trainer.logdir, "test_results.json")
    test_results = None
    if os.path.exists(results_path):
        with open(results_path) as f:
            test_results = json.load(f)
    if test_results != {}:
        faults.append(f"test_results.json {test_results}, {{}} expected "
                      "(eval_name null)")
    root = os.path.join(trainer.logdir, "images", "train")
    logged = sorted(os.listdir(root)) if os.path.isdir(root) else []
    want_logs = sorted(f"{k}_gs-{n:06}.npy" for k in (
        "inputs", "reconstruction", "conditioning", "diffusion_row",
        "samples"))
    if logged != want_logs or not all(np.isfinite(np.load(
            os.path.join(root, f))).all() for f in logged):
        faults.append(f"image logs {logged}, {want_logs} expected")

    # last resumes bit for bit: -r builds a trainer whose restored state
    # equals the run's
    resumed = main_val.main(["-r", trainer.logdir, "--no-test", "--device",
                             "cuda"])
    resumed._ensure_state()
    differ = same_state(trainer, resumed)
    if differ:
        faults.append(f"-r {trainer.logdir}: the restored state differs in "
                      f"{len(differ)} entries: {differ[:6]}")
    del resumed

    # the launches: the micro-steps', the latent encode's and the image log's
    step_shapes, _ = records["step"]
    latent_shapes, _ = records["latents"]
    want = {k: n * len(step_shapes.get(k, ()))
            + len(latent_shapes.get(k, ()))
            + sum(len(p.get(k, ())) for p in records["logs"]) for k in KERNELS}
    if launches != want or any(plain_calls.values()) \
            or len(records["logs"]) != 1:
        faults.append(f"launches {launches}, expected {want} ({n} "
                      f"micro-steps, the latent encode, "
                      f"{len(records['logs'])} image log); plain calls "
                      f"{plain_calls}")
    kgen = torch.Generator("cuda").manual_seed(SEED + 9)
    step_rows = {name: check_rows(name, step_shapes[name], kgen, card, seen)
                 for name in KERNELS if step_shapes.get(name)}
    seen = {**seen, **seen_rows(step_rows)}
    other = {name: [s for part in (latent_shapes, *records["logs"])
                    for s in part.get(name, ())] for name in KERNELS}
    other_rows = {name: check_rows(name, shapes, kgen, card, seen)
                  for name, shapes in other.items() if shapes}
    print_yardstick("faces-harness (micro-step)", step_rows)
    print_yardstick("faces-harness (latent encode, image log)", other_rows)
    if faults:
        raise RuntimeError("faces-harness: " + "; ".join(faults))
    steady = times[1:]  # micro-steps 2..n, each timed on its own
    micro_ms = sorted(steady)[len(steady) // 2] * 1e3
    update_ms = sum(times[-accumulate:]) * 1e3
    host = trainer.data.dataset("train").images
    numbers = dict(upload_s=upload_s[0], latents_s=latents_s[0],
                   micro_ms=micro_ms, update_ms=update_ms,
                   image_log_s=log_s[0], peak_mib=peak / 2**20,
                   run_s=run_s, first_micro_ms=times[0] * 1e3)
    phase("faces-harness", t0, f"main_val -b faces -t --max_steps {n} over "
          f"{last_vq} (seed {FACES_LDM_SEED}), micro-batch {bs} x "
          f"accumulation {accumulate} on the {len(host)}-image grid: upload "
          f"{upload_s[0]:.3f}s, latent cache {latents_s[0]:.3f}s "
          f"({tuple(z.shape)}, {z.numel() * 4 / 2**20:.1f} MiB, chunks of "
          f"{latent_shapes['groupnorm_silu'][0][0][0]}), {micro_ms:.3f} ms "
          f"per micro-step (median of micro-steps 2-{n}, each timed on its "
          f"own; first {times[0] * 1e3:.1f} ms), {update_ms:.3f} ms per "
          f"update (micro-steps {n - accumulate + 1}-{n}), image log "
          f"{log_s[0]:.3f}s, the run {run_s:.3f}s, peak memory "
          f"{peak / 2**20:.1f} MiB (the grid's {host.nbytes / 2**20:.1f} "
          f"MiB included); launches {launches} (expected), plain calls "
          f"{plain_calls}; the first stage is the faces VQ-GAN run's with "
          f"post_quant_conv's 20 widened rows at the seeded init; the "
          f"latent cache matches a direct encode of {FACES_LATENT_ROWS} rows "
          f"(max_abs_err {z_err:.3e}, tol {LATENT_TOL}); scale factor "
          f"{state.scale_factor.item():.7f}; parameters moved at "
          f"micro-steps {boundary} only ({[k for _, k in moved if k]} of "
          f"{len(trainable_parameters(model))} leaves: the warm-up's LRs "
          f"{[f'{lr:.3e}' for _, lr in lrs[accumulate - 1::accumulate]]}), "
          f"AdamW count {n // accumulate} on every leaf, its exp_avg equal "
          f"to that of {n} micro-steps of loop.train_step replayed outside "
          f"the harness (nonzero on {nonzero} of "
          f"{len(state.optimizer.state)} leaves, largest error "
          f"{moments_err:.3e} of the leaf's norm, tol 1e-4), "
          f"the EMA from "
          f"micro-step {accumulate} on; LR {trainer.learning_rate:.3e} x "
          f"warm-up; -r restores the run's state bit for bit; test() "
          f"{test_results}; every kernel matches its plain version at every "
          f"shape of the run (tol {KERNEL_TOL}) | {smi}")
    logdir = trainer.logdir
    del trainer, model, state, images, z
    records.clear()
    harness.clear_device_cache()
    torch.cuda.empty_cache()
    return step_rows, other_rows, launches, step_shapes, numbers, logdir


@contextlib.contextmanager
def recorded_models(calls):
    """While on, every model the eval CLIs load (``load_model`` of
    ``generate_swap``, ``fid`` and ``tad``) records the shape of each kernel
    call into ``calls`` (kernel -> shapes)."""
    modules = (generate_swap, fid_cli, tad_cli)
    load = generate_swap.load_model
    removers = []

    def load_model(*args, **kwargs):
        model = load(*args, **kwargs)
        records, remove = record_shapes(model)
        removers.append(remove)
        calls.append(records)
        return model

    for m in modules:
        m.load_model = load_model
    try:
        yield
    finally:
        for m in modules:
            m.load_model = load
        for remove in removers:
            remove()


def faces_eval_phase(smi, card, seen, out, run_dir):
    """faces-eval: ``python -m encdiff_tpu_torch.faces_eval`` (the port of
    ``scripts/round3_faces_eval.sh``) on the faces-harness run's
    ``checkpoints/last`` with ``--tad_num FACES_TAD_NUM --fid_num
    FACES_EVAL_FID_NUM`` (DDIM 50): the eval file,
    ``tad``, ``fid`` (rows of the full grid) and ``generate_swap --config
    faces``, each CLI's ``main`` with the launch counters set to 0 just
    before and read just after, which must equal its recorded calls;
    every kernel at every recorded shape against its plain version.
    Returns the checked rows by kernel and the launches by CLI."""
    t0 = time.perf_counter()
    last = os.path.join(run_dir, "checkpoints", "last")
    evaldir = os.path.join(out, "faces_eval")
    size = FACES["first_stage_config"]["ddconfig"]["resolution"]
    launches, results, shapes, faults = {}, {}, {}, []

    def counted(name, fn):
        def main(argv):
            calls = []
            with recorded_models(calls):
                torch.cuda.synchronize()
                reset_counts()
                results[name] = fn(argv)
                torch.cuda.synchronize()
                launches[name], plain_calls = read_counts()
            recorded = {k: [s for c in calls for s in c.get(k, ())]
                        for k in KERNELS}
            shapes[name] = recorded
            want = {k: len(v) for k, v in recorded.items()}
            if launches[name] != want or any(plain_calls.values()) \
                    or len(calls) != 1:
                faults.append(f"{name}: launches {launches[name]}, recorded "
                              f"{want}; plain calls {plain_calls}; "
                              f"{len(calls)} models")
            return results[name]
        return main

    clis = {"tad": tad_cli, "fid": fid_cli, "swap": generate_swap}
    mains = {name: m.main for name, m in clis.items()}
    for name, m in clis.items():
        m.main = counted(name, mains[name])
    try:
        chain = faces_eval.main([
            "-r", last, "--out", evaldir, "--tad_num", str(FACES_TAD_NUM),
            "--fid_num", str(FACES_EVAL_FID_NUM), "--device", "cuda"])
    finally:
        for name, m in clis.items():
            m.main = mains[name]
    walls = chain["walls_s"]
    if sorted(results) != sorted(clis) or sorted(walls) != sorted(
            ["eval_npz", *clis]):
        faults.append(f"faces_eval ran {sorted(results)}, timed "
                      f"{sorted(walls)}")
    with np.load(os.path.join(evaldir, "test_faces.npz")) as f:
        if f["data"].shape != (FACES_TAD_NUM, size, size, 3):
            faults.append(f"eval file {f['data'].shape}")
    tad_r = results["tad"]
    if not 0 <= tad_r["tad_score"] or not np.isfinite(tad_r["tad_score"]) \
            or len(tad_r["max_auroc"]) != len(synthetic_faces.FACE_ATTR_NAMES):
        faults.append(f"tad {tad_r['tad_score']}")
    fid_r = results["fid"]
    if fid_r["num"] != FACES_EVAL_FID_NUM or not np.isfinite(fid_r["fid"]):
        faults.append(f"fid {fid_r}")
    grid = np.load(os.path.join(evaldir, "swap", "swap_full_grid.npy"))
    n_units = FACES["unet_config"]["latent_unit"]
    if grid.shape != (FACES_INPUTS * (1 + n_units), size, size, 3) or not \
            np.isfinite(grid).all():
        faults.append(f"swap grid {grid.shape}")
    kgen = torch.Generator("cuda").manual_seed(SEED + 10)
    merged = {k: [s for v in shapes.values() for s in v[k]] for k in KERNELS}
    rows = {name: check_rows(name, v, kgen, card, seen)
            for name, v in merged.items() if v}
    print_yardstick("faces-eval", rows)
    if faults:
        raise RuntimeError("faces-eval: " + "; ".join(faults))
    phase("faces-eval", t0, f"faces_eval -r {last}: eval file of "
          f"{FACES_TAD_NUM} faces {walls['eval_npz']:.3f}s; tad "
          f"{walls['tad']:.3f}s (TAD "
          f"{tad_r['tad_score']:.6f}, {tad_r['attributes_captured']} "
          f"attributes captured); fid --num {FACES_EVAL_FID_NUM} --ddim_steps "
          f"{faces_eval.DDIM_STEPS} --eta 1 {walls['fid']:.3f}s (FID "
          f"{fid_r['fid']:.6f}, uncalibrated); generate_swap --num_samples "
          f"{FACES_INPUTS} --ddim_steps {faces_eval.DDIM_STEPS} "
          f"{walls['swap']:.3f}s ({grid.shape[0]} images); launches "
          f"{ {k: {n: c for n, c in v.items() if c} for k, v in launches.items()} } "
          f"(each the recorded calls), no plain call; every kernel matches "
          f"its plain version at every recorded shape (tol {KERNEL_TOL}) "
          f"| {smi}")
    return rows, launches



@contextlib.contextmanager
def recording_vq_run(records):
    """While on, the VQ-GAN trainer's first train step, first eval batch and
    every image log record the shape of each kernel call they make
    (``record_vq_calls``); each train step appends its own
    device-synchronised seconds to ``records["times"]``, and the eval
    batches are counted. Yields ``records``."""
    records.update(step=None, eval=None, logs=[], times=[], evals=0)
    step_fn, eval_fn = vq_trainer.train_step, vq_trainer.eval_step
    log_fn = harness.Trainer._log_vq_images

    def recorded(key, fn, model, *args):
        out = []
        records[key] = record_vq_calls(model, lambda: out.append(fn(*args)))
        return out[0]

    def train_step(model, state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = (recorded("step", step_fn, model, model, state, batch)
               if records["step"] is None else step_fn(model, state, batch))
        torch.cuda.synchronize()
        records["times"].append(time.perf_counter() - t)
        return out

    def eval_step(model, state, batch):
        records["evals"] += 1
        if records["eval"] is None:
            return recorded("eval", eval_fn, model, model, state, batch)
        return eval_fn(model, state, batch)

    def log_vq_images(self, step, images):
        records["logs"].append(record_vq_calls(
            self.model, lambda: log_fn(self, step, images)))

    vq_trainer.train_step, vq_trainer.eval_step = train_step, eval_step
    harness.Trainer._log_vq_images = log_vq_images
    try:
        yield records
    finally:
        vq_trainer.train_step, vq_trainer.eval_step = step_fn, eval_fn
        harness.Trainer._log_vq_images = log_fn


def first_stage_faults(model, params, last_vq, seed):
    """Faults of an EncDiff model's first stage against the VQ-GAN run
    whose ``checkpoints/last`` it loaded: every generator leaf the run's,
    ``post_quant_conv``'s 20 widened input rows the seeded init's draws."""
    fresh = LatentDiffusion({**params, "first_stage_config": {
        **params["first_stage_config"], "ckpt_path": None}}, "cuda")
    fresh.init_parameters(torch.Generator("cuda").manual_seed(seed))
    init_rows = fresh.first_stage_model.post_quant_conv.weight[:, 3:].clone()
    del fresh
    run_gen = generator_state(last_vq)
    loaded = model.first_stage_model.state_dict()
    wide = loaded["post_quant_conv.weight"]
    off = [k for k, v in run_gen.items() if k != "post_quant_conv.weight"
           and not torch.equal(loaded[k].cpu(), v)]
    if off or not torch.equal(wide[:, :3].cpu(),
                              run_gen["post_quant_conv.weight"]) \
            or not torch.equal(wide[:, 3:], init_rows):
        return [f"first stage: {len(off)} leaves differ from the VQ-GAN "
                f"run's ({off[:4]}), or post_quant_conv's rows"]
    return []


def cross_vq_phase(smi, card, seen, out, ds):
    """<ds>-vq: ``main_val -b <ds>_vq`` as the pipeline runs it (``CROSS``)
    for CROSS_VQ_STEPS steps, the image logger forced to the last step and
    ``test()`` over CROSS_VQ_VAL_BATCHES validation batches (the pipeline's
    ``--no-test`` left out so that the validation runs), the launch
    counters set to 0 just before and read just after: launches must equal
    the steps', the image log's and the eval batches' recorded calls. Both
    Adam counts, ``last``, ``compact_last.npz``, ``test_results.json`` and
    the log are checked, and the train and validation views must hold one
    array, uploaded once. Returns the checked rows of one step's kernel
    calls, the other checked rows, the launches, the calls of one step by
    kernel, the run's numbers and its run directory."""
    t0 = time.perf_counter()
    n = CROSS_VQ_STEPS
    records = {}
    with recording_vq_run(records):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t_run = time.perf_counter()
        trainer = main_val.main([
            "-b", f"{ds}_vq", "-t", "-l", os.path.join(out, "runs_cross"),
            "-s", str(CROSS_SEED), *CROSS[ds]["vq"], "--max_steps", str(n),
            "--val_batches", str(CROSS_VQ_VAL_BATCHES), "--device", "cuda",
            "lightning.callbacks.image_logger.params.increase_log_steps=false",
            f"lightning.callbacks.image_logger.params.batch_frequency={n}"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches, plain_calls = read_counts()
        peak = torch.cuda.max_memory_allocated()
    state, faults = trainer.state, []
    per_step, per_eval, logs = records["step"], records["eval"], records["logs"]
    want = {k: n * len(per_step.get(k, ()))
            + records["evals"] * len(per_eval.get(k, ()))
            + sum(len(p.get(k, ())) for p in logs) for k in KERNELS}
    if launches != want or any(plain_calls.values()) or len(logs) != 1 \
            or records["evals"] != CROSS_VQ_VAL_BATCHES:
        faults.append(f"launches {launches}, expected {want} ({n} steps, "
                      f"{len(logs)} image logs, {records['evals']} eval "
                      f"batches); plain calls {plain_calls}")
    counts = (vq_trainer.optimizer_count(state.gen_opt),
              vq_trainer.optimizer_count(state.disc_opt))
    if counts != (n, n) or state.step != n:
        faults.append(f"Adam counts {counts}, step {state.step}")
    train_ds = trainer.data.dataset("train")
    val_ds = trainer.data.dataset("validation")
    images = harness.device_images(train_ds.images, "cuda")
    if val_ds.images is not train_ds.images \
            or harness._DEVICE_CACHE["images"][2] is not images:
        faults.append("the train and validation views do not share one "
                      "device array")
    ckdir = os.path.join(trainer.logdir, "checkpoints")
    results_path = os.path.join(trainer.logdir, "test_results.json")
    for path in (os.path.join(ckdir, "compact_last.npz"), results_path,
                 os.path.join(ckdir, "last", STATE_FILE),
                 *(os.path.join(trainer.logdir, "images", "train",
                                f"{k}_gs-{n:06}.npy")
                   for k in ("inputs", "reconstructions"))):
        if not os.path.exists(path):
            faults.append(f"no {path}")
    test_results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            test_results = json.load(f)
        if not test_results or not all(np.isfinite(v)
                                       for v in test_results.values()):
            faults.append(f"test_results.json {test_results}")
    kgen = torch.Generator("cuda").manual_seed(SEED + CROSS[ds]["kgen"])
    step_rows = {name: check_rows(name, per_step[name], kgen, card, seen)
                 for name in KERNELS if per_step.get(name)}
    seen = {**seen, **seen_rows(step_rows)}
    other = {name: [s for part in (per_eval, *logs)
                    for s in part.get(name, ())] for name in KERNELS}
    other_rows = {name: check_rows(name, shapes, kgen, card, seen)
                  for name, shapes in other.items() if shapes}
    print_yardstick(f"{ds}-vq", step_rows)
    print_yardstick(f"{ds}-vq (eval, image log)", other_rows)
    if faults:
        raise RuntimeError(f"{ds}-vq: " + "; ".join(faults))
    steady = records["times"][2:]
    step_ms = sorted(steady)[len(steady) // 2] * 1e3
    bs = trainer.batch_size
    numbers = dict(step_ms=step_ms, first_step_ms=records["times"][0] * 1e3,
                   peak_mib=peak / 2**20, run_s=run_s)
    phase(f"{ds}-vq", t0, f"main_val -b {ds}_vq -t -s {CROSS_SEED} "
          f"{' '.join(CROSS[ds]['vq'])} --max_steps {n} --val_batches "
          f"{CROSS_VQ_VAL_BATCHES}, B={bs} on the {len(images)}-image grid "
          f"(train view of {len(train_ds)} rows, {len(train_ds) // bs} steps "
          f"an epoch; validation view {len(val_ds)} rows, the same device "
          f"array): {step_ms:.3f} ms per step (median of steps 3-{n}, each "
          f"timed on its own; first {records['times'][0] * 1e3:.1f} ms), "
          f"peak memory {peak / 2**20:.1f} MiB (the grid's "
          f"{images.numel() / 2**20:.1f} MiB included), the run {run_s:.3f}"
          f"s; launches {launches} (expected), plain calls {plain_calls}; "
          f"Adam counts {counts}; one image log at step {n}; test() over "
          f"{CROSS_VQ_VAL_BATCHES} batches: " + ", ".join(
              f"{k} {v:.6f}" for k, v in sorted(test_results.items()))
          + f"; every kernel matches its plain version at every shape of "
          f"the run (tol {KERNEL_TOL}) | {smi}")
    logdir = trainer.logdir
    del trainer, state, images
    return step_rows, other_rows, launches, per_step, numbers, logdir


def cross_harness_phase(smi, card, seen, out, ds, vq_logdir):
    """<ds>-harness: ``main_val -b <ds> -t -s 23`` as the pipeline runs it
    (``CROSS``) over the VQ-GAN run's ``checkpoints/last``, for
    CROSS_LDM_STEPS steps on cached latents with the image logger forced to
    the last step (DDIM 50 on 8 with the swap rows: ``fused_attention``;
    none in the bands-control chain, ``CROSS[ds]["log"]``), ending in
    ``test()`` (the sweep of every row of the validation grid,
    FactorVAE and MIG on the dataset's ground-truth table); the launch
    counters set to 0 just before and read just after: launches must equal
    the steps', the latent encode's and the image log's recorded calls.
    The first stage must be the VQ-GAN run's; the grid must be on the card
    once for the train and validation views and its latents cached once;
    the cached latents must match a direct encode of sampled rows and the
    scale factor the first batch's; the first batch must be the rows of
    the device path's epoch order (Cars3D's x10 repeat folded); ``-r``
    must restore the run's state bit for bit and its ``test()`` give the
    same reps. Returns the checked rows of one step's kernel calls, the
    other checked rows, the launches, the calls of one step by kernel, the
    run's numbers and its run directory."""
    t0 = time.perf_counter()
    last_vq = os.path.join(vq_logdir, "checkpoints", "last")
    n = CROSS_LDM_STEPS
    stamps, latents_s, log_s = [], [], []
    with contextlib.ExitStack() as stack:
        records = stack.enter_context(recording_harness(stamps))
        stack.enter_context(timed_calls(harness, "precompute_latents",
                                        latents_s))
        stack.enter_context(timed_calls(harness, "log_images", log_s))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t_run = time.perf_counter()
        trainer = main_val.main([
            "-b", ds, "-t", "-l", os.path.join(out, "runs_cross"), "-s",
            str(CROSS_SEED), *CROSS[ds]["ldm"], "--max_steps", str(n),
            "--device", "cuda", *UNCHECKED_METRICS,
            f"model.params.first_stage_config.params.ckpt_path={last_vq}",
            f"lightning.callbacks.image_logger.params.batch_frequency={n}",
            *CROSS[ds]["log"]])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches, plain_calls = read_counts()
        peak = torch.cuda.max_memory_allocated()
        records["on"] = False
    model, state, params = trainer.model, trainer.state, trainer.model_params
    faults = first_stage_faults(model, params, last_vq, CROSS_SEED)

    # one grid on the card for both views, its latents cached once
    train_ds = trainer.data.dataset("train")
    val_ds = trainer.data.dataset("validation")
    images = harness.device_images(train_ds.images, "cuda")
    held = harness._DEVICE_CACHE["images"]
    if val_ds.images is not train_ds.images or held[2] is not images or (
            isinstance(train_ds.images, torch.Tensor)
            and images.data_ptr() != train_ds.images.data_ptr()):
        faults.append("the train and validation views do not share one "
                      "device array")
    if len(latents_s) != 1:
        faults.append(f"{len(latents_s)} latent encodes in one fit")
    _, z = records["latents"]
    rows = torch.from_numpy(np.sort(np.random.RandomState(SEED).choice(
        len(images), CROSS_LATENT_ROWS, replace=False))).cuda()
    direct = model.encode_first_stage(model.split_batch(images[rows])[0])
    torch.cuda.synchronize()
    z_err = (z[rows] - direct).abs().max().item()
    try:
        torch.testing.assert_close(z[rows], direct, **LATENT_TOL)
    except AssertionError as e:
        faults.append(f"latent cache against a direct encode: {e}")
    del direct
    # the first batch: the device path's epoch order, modulo the rows held
    bs = trainer.batch_size
    order = torch.from_numpy(harness.epoch_order(
        CROSS_SEED, 0, len(train_ds), bs, len(images))).cuda()
    _, first = records["step"]
    if not torch.equal(first["batch"]["image"], images[order[:bs]]) \
            or not torch.equal(first["batch"]["z"], z[order[:bs]]):
        faults.append("the first batch is not the epoch order's first rows")
    want_sf = 1.0 / first["batch"]["z"].float().reshape(-1).std(
        unbiased=False)
    if not torch.allclose(state.scale_factor, want_sf, rtol=1e-6, atol=0):
        faults.append(f"scale factor {state.scale_factor.item()}, 1/std of "
                      f"the first batch's code {want_sf.item()}")
    if state.step != n or state.updates != n or abs(
            trainer.learning_rate - bs * trainer.base_lr) > 1e-18:
        faults.append(f"step {state.step}, AdamW count {state.updates}, LR "
                      f"{trainer.learning_rate}")

    # last, test() and the image log
    last = os.path.join(trainer.ckptdir, "last")
    for name in (MODEL_FILE, STATE_FILE):
        if not os.path.exists(os.path.join(last, name)):
            faults.append(f"no {name} in {last}")
    with open(os.path.join(trainer.logdir, "test_results.json")) as f:
        test_results = json.load(f)
    if sorted(test_results) != ["val/factor_vae_score", "val/mig"] or not \
            all(np.isfinite(v) for v in test_results.values()):
        faults.append(f"test_results.json {test_results}")
    n_rows = len(get_index_dataset(params["eval_name"]).images)
    reps_path = os.path.join(trainer.logdir, "reps", f"{n}.npy")
    reps = np.load(reps_path)
    if reps.shape != (n_rows, 20) or n_rows != len(val_ds) \
            or not np.isfinite(reps).all():
        faults.append(f"reps {reps.shape} over the {n_rows}-row table")
    n_logs = 0 if NO_LOG in CROSS[ds]["log"] else 1
    root = os.path.join(trainer.logdir, "images", "train")
    logged = sorted(os.listdir(root)) if os.path.isdir(root) else []
    want_logs = sorted(f"{k}_gs-{n:06}.npy" for k in LOG_KEYS) * n_logs
    if logged != want_logs or not all(np.isfinite(np.load(
            os.path.join(root, f))).all() for f in logged):
        faults.append(f"image logs {logged}, {want_logs} expected")
    tm = dict(trainer.timings)

    # -r: the run's state restored bit for bit, test() on it the same reps
    resumed = main_val.main(["-r", trainer.logdir, "--device", "cuda",
                             *UNCHECKED_METRICS])
    differ = same_state(trainer, resumed)
    if differ:
        faults.append(f"-r {trainer.logdir}: the restored state differs in "
                      f"{len(differ)} entries: {differ[:6]}")
    with open(os.path.join(resumed.logdir, "test_results.json")) as f:
        resumed_results = json.load(f)
    reps_err = float(np.abs(np.load(reps_path) - reps).max())
    if reps_err > LATENT_TOL["atol"]:
        faults.append(f"-r test(): reps off by {reps_err}")
    resumed_tm = dict(resumed.timings)
    del resumed

    # the launches: the steps', the latent encode's and the image log's
    step_shapes, _ = records["step"]
    latent_shapes, _ = records["latents"]
    want = {k: n * len(step_shapes.get(k, ()))
            + len(latent_shapes.get(k, ()))
            + sum(len(p.get(k, ())) for p in records["logs"]) for k in KERNELS}
    if launches != want or any(plain_calls.values()) \
            or len(records["logs"]) != n_logs:
        faults.append(f"launches {launches}, expected {want} ({n} steps, "
                      f"the latent encode, {len(records['logs'])} image "
                      f"logs, {n_logs} wanted); plain calls {plain_calls}")
    kgen = torch.Generator("cuda").manual_seed(SEED + CROSS[ds]["kgen"] + 1)
    step_rows = {name: check_rows(name, step_shapes[name], kgen, card, seen)
                 for name in KERNELS if step_shapes.get(name)}
    seen = {**seen, **seen_rows(step_rows)}
    other = {name: [s for part in (latent_shapes, *records["logs"])
                    for s in part.get(name, ())] for name in KERNELS}
    other_rows = {name: check_rows(name, shapes, kgen, card, seen)
                  for name, shapes in other.items() if shapes}
    print_yardstick(f"{ds}-harness (step)", step_rows)
    print_yardstick(f"{ds}-harness (latent encode, image log)", other_rows)
    records.clear()
    if faults:
        raise RuntimeError(f"{ds}-harness: " + "; ".join(faults))
    steps = [b - a for a, b in zip(stamps, stamps[1:])]  # steps 2..n
    step_ms = sorted(steps)[len(steps) // 2] * 1e3
    log_msg = f"image log {log_s[0]:.3f}s" if log_s else "no image log"
    numbers = dict(latents_s=latents_s[0], step_ms=step_ms,
                   **({"image_log_s": log_s[0]} if log_s else {}),
                   sweep_s=tm["sweep_s"],
                   metrics_s=tm["metrics_s"],
                   resumed_sweep_s=resumed_tm["sweep_s"],
                   resumed_metrics_s=resumed_tm["metrics_s"],
                   peak_mib=peak / 2**20, run_s=run_s,
                   factor_vae=test_results["val/factor_vae_score"],
                   mig=test_results["val/mig"])
    phase(f"{ds}-harness", t0, f"main_val -b {ds} -t -s {CROSS_SEED} "
          f"{' '.join(CROSS[ds]['ldm'])} --max_steps {n} over {last_vq}, "
          f"B={bs} on the {len(images)}-image grid (train view of "
          f"{len(train_ds)} rows, {len(train_ds) // bs} steps an epoch; one "
          f"device array for both views): latent cache {latents_s[0]:.3f}s "
          f"({tuple(z.shape)}, {z.numel() * 4 / 2**20:.1f} MiB, once), "
          f"{step_ms:.3f} ms per step on cached latents (median of steps "
          f"2-{n}), {log_msg}, test(): sweep of "
          f"{tm['images']} images {tm['sweep_s']:.3f}s, metrics "
          f"{tm['metrics_s']:.3f}s, FactorVAE "
          f"{test_results['val/factor_vae_score']:.6f}, MIG "
          f"{test_results['val/mig']:.6f}; -r restores the run's state bit "
          f"for bit, its test() (sweep {resumed_tm['sweep_s']:.3f}s, metrics "
          f"{resumed_tm['metrics_s']:.3f}s) reps within {reps_err:.3e}: "
          f"{resumed_results}; the run {run_s:.3f}s, peak memory "
          f"{peak / 2**20:.1f} MiB (the grid's {images.numel() / 2**20:.1f} "
          f"MiB included); launches {launches} (expected), plain calls "
          f"{plain_calls}; the first stage is the VQ-GAN run's with "
          f"post_quant_conv's 20 widened rows at the seeded init; the "
          f"latent cache matches a direct encode of {CROSS_LATENT_ROWS} rows "
          f"(max_abs_err {z_err:.3e}, tol {LATENT_TOL}); the first batch "
          f"is the epoch order's; scale factor "
          f"{state.scale_factor.item():.7f}; every kernel matches its plain "
          f"version at every shape of the run (tol {KERNEL_TOL}) | {smi}")
    logdir = trainer.logdir
    del trainer, model, state, images, z
    return step_rows, other_rows, launches, step_shapes, numbers, logdir


def mpi3d_shapes_phase(smi):
    """mpi3d-shapes: the 1,036,800-image MPI3D grid rendered for the MPI3D
    phases (geometry with numpy on the host, composed on the card, where it
    stays), its first f_cam x f_bg blocks held byte for byte against
    numpy's render of the one-object sub-grid (every camera height and
    background); the seconds of the geometry, its upload and the
    composition, and the card's memory. Returns those numbers."""
    t0 = time.perf_counter()
    harness.clear_device_cache()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grid = synthetic_mpi3d.SyntheticMPI3DFull(device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    tm = grid.render_timings
    fs = synthetic_mpi3d.MPI3D_FACTOR_SIZES
    images = grid.images
    if tuple(images.shape) != (synthetic_mpi3d.N_IMAGES_MPI3D, 64, 64, 3) \
            or not images.is_cuda or held != images.numel():
        raise RuntimeError(f"mpi3d-shapes: grid {tuple(images.shape)} on "
                           f"{images.device}, {held} bytes held")
    t = time.perf_counter()
    sub = synthetic_mpi3d.render_mpi3d_all(64, [1, 1, 1, *fs[3:]])
    if not np.array_equal(images[:len(sub)].cpu().numpy(), sub):
        raise RuntimeError("mpi3d-shapes: the card's composition differs "
                           "from numpy's on the grid's first blocks")
    check_s = time.perf_counter() - t
    numbers = {**tm, "render_s": sum(tm.values()), "peak_mib": peak / 2**20,
               "grid_mib": held / 2**20}
    phase("mpi3d-shapes", t0, f"{len(images)} images {tuple(images.shape)} "
          f"(factors {fs}): geometry on the host {tm['geometry_s']:.3f}s, its "
          f"upload {tm['upload_s']:.3f}s, the {int(np.prod(fs[:5]))} "
          f"composition blocks on the card {tm['compose_s']:.3f}s; the grid "
          f"holds {held / 2**20:.1f} MiB of the card, peak "
          f"{peak / 2**20:.1f} MiB during the render (the geometry's "
          f"blocks beside it); its first {len(sub) // (fs[5] * fs[6])} "
          f"blocks (every camera height x background) equal numpy's render "
          f"of the one-object sub-grid ({check_s:.3f}s) | {smi}")
    return numbers


def cross_phases(smi, card, seen, out, ds):
    """<ds>-vq then <ds>-harness over its ``last``. Returns the checked
    rows (step and other) and launches of each, the calls of one LDM step
    by kernel, the numbers of both and their run directories."""
    vq_step, vq_other, vq_launches, _, vq_numbers, vq_dir = cross_vq_phase(
        smi, card, seen, out, ds)
    seen = {**seen, **seen_rows(vq_step, vq_other)}
    h_step, h_other, h_launches, per_step, h_numbers, h_dir = \
        cross_harness_phase(smi, card, seen, out, ds, vq_dir)
    torch.cuda.empty_cache()
    return dict(rows=(vq_step, vq_other, h_step, h_other),
                launches={f"{ds}_vq_train": vq_launches,
                          f"{ds}_harness": h_launches},
                per_step=per_step,
                numbers={**{f"vq_{k}": v for k, v in vq_numbers.items()},
                         **h_numbers},
                dirs=(vq_dir, h_dir))


def shapes_render_phase(smi):
    """shapes-render: every new grid of the shapes family (SHAPES_RENDERS)
    rendered on the host as the harness renders it, one 480,000-image grid
    at a time, each held to its SHAPES_DIGESTS constant; the v1 grid and
    the bands grid at 480,000 (rendered last) stay in the renderer's cache
    for the chains after this phase. Returns the seconds of each render."""
    t0 = time.perf_counter()
    synthetic_shapes.clear_cache()
    harness.clear_device_cache()
    numbers, faults, lines = {}, [], []
    for renderer, fs in SHAPES_RENDERS:
        t = time.perf_counter()
        if (renderer, tuple(fs)) in SHAPES_KEPT:
            grid = synthetic_shapes.get_images(renderer, 64, fs)
        else:
            grid = synthetic_shapes.RENDERERS[renderer](64, factor_sizes=fs)
        render_s = time.perf_counter() - t
        t = time.perf_counter()
        faults += check_digest(renderer, fs, grid)
        digest_s = time.perf_counter() - t
        numbers[f"{renderer}_{len(grid)}_render_s"] = render_s
        lines.append(f"{renderer} {fs}: {len(grid)} images "
                     f"({grid.nbytes / 2**30:.3f} GiB) in {render_s:.3f}s, "
                     f"digest {digest_s:.3f}s")
        del grid
    if faults:
        raise RuntimeError("shapes-render: " + "; ".join(faults))
    phase("shapes-render", t0, f"on {RENDER_THREADS} host threads: "
          + "; ".join(lines) + "; every grid's bytes the JAX renderer's "
          f"(sha256 digests) | {smi}")
    return numbers


def shapes_mcl_phase(smi, card, seen, out, vq_dir, ldm_dir):
    """shapes-mcl: ``main_val -b shapes_mcl`` (the whole
    ``synthetic-shapes-mcl.yaml`` on the v1 grid) over the v1 chain's
    EncDiff run, as ``scripts/run_mcl_sweep.py`` runs a cell
    (``--resume_ckpt <run>/checkpoints/last``, the first stage the VQ-GAN
    run's ``last`` by override): every kernel call of one MCL step
    recorded and held against its plain version at each shape; the run
    (SHAPES_MCL_STEPS steps and ``test()`` with the swap visualization)
    with mcl-train's checks (the v1 chain's UNet is 8 warm-up steps from
    its fresh init, whose zero output convolutions leave many leaves a
    gradient whose AdamW update is under fp32's resolution: such a leaf
    may stand still, ``below_resolution``); the kernel path against the
    plain path on the run's first batch, t and noise (mcl-reference's
    rules). Returns the
    checked rows of one step's kernel calls, the launches of the run, the
    calls of one step by kernel and the run's numbers."""
    t0 = time.perf_counter()
    override = ("model.params.first_stage_config.params.ckpt_path="
                + os.path.join(vq_dir, "checkpoints", "last"))
    last = os.path.join(ldm_dir, "checkpoints", "last")
    config = harness.load_configs(["shapes_mcl"], [override])
    lightning = config.pop("lightning")
    ref = mcl_trainer(config, lightning, out, resume=last)
    model, state = ref.model, ref.state
    images = harness.device_images(ref.data.dataset("train").images, "cuda")
    batch, (t, noise) = mcl_first_batch(ref, images)
    per_step = mcl_step_calls(model, state, batch, t, noise)
    kgen = torch.Generator("cuda").manual_seed(SEED + 19)
    rows = {name: check_rows(name, per_step[name], kgen, card, seen)
            for name in KERNELS if per_step.get(name)}
    vjp_rows = check_rows("attention_core_bwd_vjp",
                          per_step["attention_core_bwd_vjp"], kgen, card,
                          seen)
    phase("shapes-mcl-shapes", t0, f"B={ref.batch_size} on the "
          f"{len(images)}-image v1 grid at global step {state.step} of "
          f"{last}, {model.mcl_type} lambda {model.lambda_mcl}: per step "
          f"{ {k: len(v) for k, v in per_step.items()} }; each kernel "
          f"matches its plain version at every shape (tol {KERNEL_TOL})")
    launches, _, step_ms, peak = mcl_train_phase(
        smi, card, per_step, ref, images,
        {**seen, **seen_rows(rows, {"attention_core_bwd_vjp": vjp_rows})},
        out, label="shapes-mcl", overrides=(override,),
        steps=SHAPES_MCL_STEPS, base="shapes_mcl", resume=last)

    t0 = time.perf_counter()
    reading, faults, zero = mcl_compare(model.mcl_type, model, state, batch,
                                        t, noise)
    if set(zero) & MCL_EXACT_ZERO != MCL_EXACT_ZERO:
        faults.append(f"exact-zero critic leaves {sorted(MCL_EXACT_ZERO)}, "
                      f"found {sorted(set(zero) & MCL_EXACT_ZERO)}")
    if faults:
        raise RuntimeError("shapes-mcl-reference: " + " | ".join(
            [reading] + faults))
    phase("shapes-mcl-reference", t0, f"B={ref.batch_size} at the run's "
          f"starting weights, the same batch, z, t and noise: every logged "
          f"value within {LOSS_RTOL}, every trainable leaf within relative "
          f"L2 {GRAD_RTOL} on each of {REFERENCE_REPEATS} kernel-path runs "
          f"from the plain path's gradient at the UNet output; the "
          f"exact-zero leaves within {GRAD_ZERO} of the global norm: {zero}."
          f" {reading}")
    del ref, model, state, images
    torch.cuda.empty_cache()
    return rows, launches, per_step, dict(ms_per_step=step_ms,
                                          peak_mib=peak / 2**20)


if __name__ == "__main__":
    sys.exit(main())
