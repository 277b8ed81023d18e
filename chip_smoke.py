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

Then one JSON line of kernels, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from encdiff_tpu_torch.core.schedules import DDIMSchedule
from encdiff_tpu_torch.evalx.swap import swap_conditions, swap_sample
from encdiff_tpu_torch.generate_swap import pick_inputs
from encdiff_tpu_torch.models.latent_diffusion import LatentDiffusion
from encdiff_tpu_torch.nn import attention as port_attention
from encdiff_tpu_torch.nn import layers as port_layers
from encdiff_tpu_torch.nn import vae as port_vae
from encdiff_tpu_torch.nn.kernels import build, plain_path
from encdiff_tpu_torch.nn.kernels.attention import (attention_core,
                                                    attention_core_plain)
from encdiff_tpu_torch.nn.kernels.groupnorm_silu import (
    groupnorm_silu, groupnorm_silu_plain)

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "demo_artifacts/round5/v4purify_final_fp16.npz")
SEED = 42
NUM_INPUTS = 8
DDIM_STEPS = 200
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# kernel vs plain version at one shape: fp32 sums in another order
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
# a whole UNet call / a 10-step chain / a decode, kernel path vs plain path
PATH_TOL = dict(rtol=1e-3, atol=1e-3)
KERNELS = {
    "groupnorm_silu": dict(
        source="encdiff_tpu_torch/csrc/groupnorm_silu.cu",
        replaces="encdiff_tpu/nn/pallas/groupnorm_silu.py:62"),
    "attention_core": dict(
        source="encdiff_tpu_torch/csrc/attention_core.cu",
        replaces="encdiff_tpu/nn/pallas/attention.py:113"),
}


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


def profile_unet(model, x, t, tokens, calls: int = 3):
    """torch.profiler over ``calls`` UNet ε calls: (wall ms per call,
    device-busy ms per call, [(kernel, ms per call, launches per call)])
    from the CUDA kernel events, or None if the trace holds none."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    model.apply_model(x, t, tokens)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            model.apply_model(x, t, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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
    results = {}
    for name in KERNELS:
        calls = collections.Counter(per_unet[name] + per_decode[name])
        rows = []
        for key, count in sorted(calls.items(), key=str):
            r = (check_gn(*key, kgen) if name == "groupnorm_silu"
                 else check_attn(key, kgen))
            r.update(shape=key, count=count)
            rows.append(r)
            print(f"  {name} {key} x{count}: err {r['err']:.2e} "
                  f"ms {r['ms']:.5f} plain {r['plain_ms']:.5f} "
                  f"library {r['library_ms']:.5f} "
                  f"bound {max(r['bytes_ms'], r['ops_ms']):.5f}", flush=True)
        results[name] = rows
    phase("kernels", t0, "each kernel matches its plain version at every "
          f"main-path shape (tol {KERNEL_TOL})")

    # ---- 5: the main path, counters read around it alone
    t0 = time.perf_counter()
    expected = {k: len(per_unet[k]) * DDIM_STEPS + len(per_decode[k])
                for k in KERNELS}
    wrappers = {"groupnorm_silu": groupnorm_silu,
                "attention_core": attention_core}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
        w.plain_calls = 0
    t_req = time.perf_counter()
    out = swap_sample(model, images, ddim_steps=DDIM_STEPS, eta=0.0, x_T=x_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_req
    launches = {k: w.launches for k, w in wrappers.items()}
    plain_calls = {k: w.plain_calls for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (batch, 64, 64, 3):
        raise RuntimeError(f"swap output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise RuntimeError("swap output has non-finite values")
    if launches != expected or any(plain_calls.values()):
        raise RuntimeError(f"launches {launches}, expected {expected}; "
                           f"plain calls {plain_calls}")
    phase("main", t0, f"swap request B={NUM_INPUTS} -> {batch} samples, "
          f"DDIM {DDIM_STEPS}, eta 0: wall {wall:.3f}s, "
          f"{batch / wall:.3f} samples/s, peak memory "
          f"{peak / 2**20:.1f} MiB, launches {launches} (expected), "
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
    prof = profile_unet(model, x_T, t_first, tokens)
    if prof is None:
        phase("profile", t0, "the profiler saw no CUDA kernel: not measured")
    else:
        wall_ms, busy_ms, top = prof
        phase("profile", t0, f"one UNet call at B={batch} under "
              f"torch.profiler: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
              f"{sum(r[2] for r in top):.0f} kernel launches")
        for name, ms, n in top[:12]:
            print(f"  {ms:9.4f} ms {n:5.0f}x  {name[:110]}", flush=True)

    kernels = []
    for name, rows in results.items():
        total = lambda f: sum(r[f] * r["count"] for r in rows)
        bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
        kernels.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches[name],
            "max_abs_err": max(r["err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) * r["count"]
                            for r in rows),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": total("library_ms"),
        })
    print("# kernels: ms, plain_ms, bound_ms and library_ms are summed over "
          "the launches of one UNet call plus one VQ decode at B=160",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    phase("total", t_all, "chip_smoke passed")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
