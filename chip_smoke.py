#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``encdiff_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each with its wall time; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi). No CUDA: fail.
2. build: both CUDA kernels with nvcc into ``build/``.
3. shapes: the flagship checkpoint, 8 rendered inputs folded into the 160
   swap samples; one UNet ε call and one VQ decode at B = 160 record every
   kernel call's shape, and the first UNet call on the kernel path is held
   against the same call on the plain PyTorch path.
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

Then one JSON line of kernels, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from encdiff_tpu_torch import train_steps
from encdiff_tpu_torch.configs import FLAGSHIP_TRAIN
from encdiff_tpu_torch.core.schedules import DDIMSchedule
from encdiff_tpu_torch.data.synthetic_shapes import (TRAIN_GRID,
                                                     epoch_batches,
                                                     render_all_v4)
from encdiff_tpu_torch.evalx.swap import swap_conditions, swap_sample
from encdiff_tpu_torch.generate_swap import pick_inputs
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.nn import attention as port_attention
from encdiff_tpu_torch.nn import layers as port_layers
from encdiff_tpu_torch.nn import vae as port_vae
from encdiff_tpu_torch.nn.kernels import attention as kattn
from encdiff_tpu_torch.nn.kernels import build, plain_path
from encdiff_tpu_torch.nn.kernels import groupnorm_silu as kgn
from encdiff_tpu_torch.nn.kernels.attention import (
    attention_core, attention_core_bwd, attention_core_bwd_plain,
    attention_core_plain)
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import (
    groupnorm_silu, groupnorm_silu_bwd_plain, groupnorm_silu_plain,
    gn_silu_bwd)
from encdiff_tpu_torch.train.loop import (draw_t_and_noise, loss_and_grads,
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
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
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
# the kernel path runs twice on the same inputs: its run-to-run spread
REFERENCE_REPEATS = 2
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
}
WRAPPERS = {"groupnorm_silu": groupnorm_silu, "attention_core": attention_core,
            "attention_core_bwd": attention_core_bwd,
            "gn_silu_bwd": gn_silu_bwd}


def phase(name, t0, msg):
    print(f"[{name}] {time.perf_counter() - t0:.3f}s {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


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


def record_shapes(model):
    """Forward pre-hooks that record, per kernel, the shape of every call
    one forward pass makes. Returns (records, remove)."""
    records = {"groupnorm_silu": [], "attention_core": []}

    def gn_hook(mod, args):
        x = args[0]
        film = len(args) > 1 and args[1] is not None
        records["groupnorm_silu"].append((tuple(x.shape), mod.eps, film))

    def xattn_hook(mod, args, kwargs):
        x = args[0]
        ctx = kwargs.get("context", args[1] if len(args) > 1 else None)
        m = x.shape[1] if ctx is None else ctx.shape[1]
        records["attention_core"].append(
            (x.shape[0], mod.heads, x.shape[1], m, mod.dim_head))

    def attnblock_hook(mod, args):
        b, c, h, w = args[0].shape
        records["attention_core"].append((b, 1, h * w, h * w, c))

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
    return dict(err=(out - ref).abs().max().item(), ms=time_ms(kernel),
                plain_ms=time_ms(plain), library_ms=time_ms(library),
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3)


def check_attn(shape, gen):
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
    return dict(err=(out - ref).abs().max().item(), ms=time_ms(kernel),
                plain_ms=time_ms(plain), library_ms=time_ms(library),
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3)


def check_attn_bwd(shape, gen):
    b, h, n, m, dh = shape
    # the callers' layout: (B, L, H, dh) buffers viewed as (B, H, L, dh);
    # dO arrives as the gradient of such a view
    q, k, v, do = (torch.randn(b, length, h, dh, generator=gen,
                               device="cuda").transpose(1, 2)
                   for length in (n, m, m, n))
    scale = dh ** -0.5
    kernel = lambda: attention_core_bwd(q, k, v, do, scale)
    plain = lambda: attention_core_bwd_plain(q, k, v, do, scale)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, scale=scale)
    library = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **KERNEL_TOL)
    nbytes, ops = attn_bwd_cost(*shape)
    return dict(err=max((a - r).abs().max().item() for a, r in zip(got, ref)),
                ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=time_ms(library),
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3)


def check_gn_bwd(shape, eps, film, gen):
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
    leaves = [t.detach().requires_grad_() for t in (x, gamma, beta, sc, sh)
              if t is not None]
    y = F.group_norm(leaves[0], 32, leaves[1], leaves[2], eps)
    if film:
        y = y * (1.0 + leaves[3][:, :, None, None]) + leaves[4][:, :, None, None]
    out = F.silu(y)
    library = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    pairs = [(a, r) for a, r in zip(got, ref) if r is not None]
    for a, r in pairs:
        torch.testing.assert_close(a, r, **KERNEL_TOL)
    nbytes, ops = gn_bwd_cost(shape, film)
    return dict(err=max((a - r).abs().max().item() for a, r in pairs),
                ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=time_ms(library),
                bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=ops / PEAK_FP32 * 1e3)


@contextlib.contextmanager
def record_backward_shapes():
    """Hooks on the backward of the two autograd Functions: every backward
    kernel call's shape, as ``check_*_bwd`` take it."""
    records = {"attention_core_bwd": [], "gn_silu_bwd": []}
    attn_fn, gn_fn = kattn._AttentionCore, kgn._GNSiLU
    attn_bwd, gn_bwd = attn_fn.backward, gn_fn.backward

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

    attn_fn.backward, gn_fn.backward = map(staticmethod, (attn_hook, gn_hook))
    try:
        yield records
    finally:
        attn_fn.backward, gn_fn.backward = map(staticmethod,
                                               (attn_bwd, gn_bwd))


def check_rows(name, shapes, gen):
    """Check and time kernel ``name`` at each distinct shape of ``shapes``;
    rows carry the shape and its number of calls."""
    check = {"groupnorm_silu": lambda key: check_gn(*key, gen),
             "attention_core": lambda key: check_attn(key, gen),
             "gn_silu_bwd": lambda key: check_gn_bwd(*key, gen),
             "attention_core_bwd": lambda key: check_attn_bwd(key, gen)}[name]
    rows = []
    for key, count in sorted(collections.Counter(shapes).items(), key=str):
        r = check(key)
        r.update(shape=key, count=count)
        rows.append(r)
        print(f"  {name} {key} x{count}: err {r['err']:.2e} "
              f"ms {r['ms']:.5f} plain {r['plain_ms']:.5f} "
              f"library {r['library_ms']:.5f} "
              f"bound {max(r['bytes_ms'], r['ops_ms']):.5f}", flush=True)
    return rows


def summed(rows):
    """A kernel's times summed over the calls of ``rows``."""
    total = lambda f: sum(r[f] * r["count"] for r in rows)
    bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
    return {"ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) * r["count"]
                            for r in rows),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": total("library_ms"),
            "max_abs_err": max(r["err"] for r in rows)}


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
    holds none."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        # kernels only: a GPU-side user annotation (the optimizer step's
        # span) overlaps the kernels it encloses
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / calls
            by_name[e.name][1] += 1
    if not by_name:
        return None
    busy = sum(v[0] for v in by_name.values())
    top = sorted(((k, v[0], v[1] / calls) for k, v in by_name.items()),
                 key=lambda r: -r[1])
    return wall, busy, top


def main() -> int:
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", t0, f"{smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = build.build()
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    phase("build", t0, f"built {sorted(logs) or 'nothing (cached)'} "
          f"into {build.BUILD_DIR}")

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
                                   kgen)
                  for name in ("groupnorm_silu", "attention_core")}
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

    train_rows, train_launches, per_step = train_phases(smi)

    kernels = []
    for name in KERNELS:
        train = summed(train_rows[name])
        top = summed(serve_rows[name]) if name in serve_rows else train
        launches = {"swap": swap_launches[name], "train": train_launches[name]}
        kernels.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(top["max_abs_err"], train["max_abs_err"]),
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "train_step": {**{k: train[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "launches": len(per_step[name])},
        })
    print("# kernels: ms, plain_ms, bound_ms and library_ms are summed over "
          "the launches of one UNet call plus one VQ decode at B=160 for the "
          "forward kernels, and over one train step at B=128 for the "
          "backward kernels; train_step holds every kernel's sums over one "
          "train step at B=128; launches count the swap request and the "
          f"{TRAIN_STEPS} train steps", flush=True)
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
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(r[2] for r in top):.0f} kernel launches")
    for kname, ms, n in top[:12]:
        print(f"  {ms:9.4f} ms {n:5.0f}x  {kname[:110]}", flush=True)


def cond_state(model):
    """A copy of Encoder4's state: its parameters and batch statistics."""
    return {k: v.clone() for k, v in
            model.cond_stage_model.state_dict().items()}


def train_phases(smi):
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
    t, noise = draw_t_and_noise(model, TRAIN_BATCH, gen)
    bn = cond_state(model)
    fwd, remove = record_shapes(model)
    with record_backward_shapes() as bwd:
        loss_and_grads(model, state, first, t, noise)
    torch.cuda.synchronize()
    remove()
    model.cond_stage_model.load_state_dict(bn)
    per_step = {**fwd, **bwd}
    phase("train-shapes", t0, f"B={TRAIN_BATCH}, global step {state.step}: "
          f"per train step { {k: len(v) for k, v in per_step.items()} }")

    # ---- 9: every kernel at every shape of the train step
    t0 = time.perf_counter()
    kgen = torch.Generator("cuda").manual_seed(SEED + 2)
    rows = {name: check_rows(name, per_step[name], kgen) for name in KERNELS}
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
    expected = {k: len(v) * TRAIN_STEPS for k, v in per_step.items()}
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
    t, noise = draw_t_and_noise(model, TRAIN_BATCH, gen)
    bn = cond_state(model)

    def forward_backward():
        loss_dict, _ = loss_and_grads(model, state, batch, t, noise)
        grads = {k: p.grad.detach().clone()
                 for k, p in trainable_parameters(model).items()}
        stats = {k: v for k, v in cond_state(model).items()
                 if k.endswith(("running_mean", "running_var"))}
        return loss_dict["train/loss"].item(), grads, stats

    runs = []
    for _ in range(REFERENCE_REPEATS):
        runs.append(forward_backward())
        model.cond_stage_model.load_state_dict(bn)
    with plain_path():
        loss_p, grads_p, stats_p = forward_backward()
    torch.cuda.synchronize()
    norms = {k: torch.linalg.vector_norm(g).item() for k, g in grads_p.items()}
    total = sum(n * n for n in norms.values()) ** 0.5
    zero = sorted(k for k, n in norms.items() if n <= GRAD_ZERO * total)
    readings = []
    for loss_k, grads_k, stats_k in runs:
        if abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
            raise RuntimeError(f"loss kernel {loss_k} vs plain {loss_p}")
        rel = {k: (torch.linalg.vector_norm(g - grads_p[k]).item()
                   / norms[k]) for k, g in grads_k.items() if k not in zero}
        for r, k in sorted(((r, k) for k, r in rel.items()), reverse=True)[:4]:
            print(f"  gradient {k}: relative L2 {r:.3e}, |g| / global "
                  f"{norms[k] / total:.3e}", flush=True)
        failed = [k for k, r in rel.items() if r > GRAD_RTOL]
        loud = [k for k in zero if torch.linalg.vector_norm(grads_k[k]).item()
                > GRAD_ZERO * total]
        if failed or loud:
            raise RuntimeError(f"gradients off: {failed}; zero-gradient "
                               f"leaves above {GRAD_ZERO} of the global "
                               f"norm: {loud}")
        for k in stats_p:
            torch.testing.assert_close(stats_k[k], stats_p[k], **PATH_TOL)
        worst = max((r, k) for k, r in rel.items())
        readings.append(f"loss {loss_k:.7f}, worst {worst[0]:.3e} "
                        f"({worst[1]}), unet.conv_in.bias "
                        f"{rel.get('unet.conv_in.bias', float('nan')):.3e}")
    spread = max(torch.linalg.vector_norm(g - runs[1][1][k]).item()
                 / max(norms[k], 1e-30) for k, g in runs[0][1].items()
                 if k not in zero)
    phase("train-reference", t0, f"plain loss {loss_p:.7f} (rtol "
          f"{LOSS_RTOL}); {len(grads_p)} gradient leaves, "
          f"{len(grads_p) - len(zero)} within relative L2 {GRAD_RTOL} on "
          f"each of {REFERENCE_REPEATS} kernel-path runs: "
          + "; ".join(readings)
          + f"; kernel path run to run: worst relative L2 {spread:.3e}; "
          f"{len(zero)} leaves with a zero exact gradient within "
          f"{GRAD_ZERO} of the global norm {total:.4f}: {zero}; batch "
          f"statistics within {PATH_TOL}")

    # ---- 12: where the time of one train step goes (not pass/fail)
    t0 = time.perf_counter()
    print_profile("train-profile", t0, f"one train step at B={TRAIN_BATCH}",
                  profile(lambda: train_step(model, state, batch,
                                             generator=gen), calls=2))
    return rows, launches, per_step


if __name__ == "__main__":
    sys.exit(main())
