#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``xrnerf_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device  - the card's name and power limit (``nvidia-smi``); TF32 off.
2. build   - the CUDA kernel ``xrnerf_torch/csrc/fused_nerf_mlp_fwd.cu``
             built with nvcc.
3. kernel  - ``fused_nerf_mlp_fwd`` against its plain version on the card
             at width 256 with seeded weights, for N = 1000 (ragged tile),
             1,048,576 (one coarse chunk) and 3,145,728 (one fine chunk),
             rtol 2e-2 / atol 8e-3 (the JAX package's fused-MLP
             tolerances); kernel, plain-version and bf16 ``torch.matmul``
             chain times (CUDA events, median of 7 after warm-up).
4. slice   - vanilla NeRF from ``configs/nerf/nerf_blender.py`` at full
             width (8x256, 64+128 samples, posenc 10/4) with ``fused=True``
             and seeded weights renders an 800x800 novel view through
             ``Trainer.render_image`` at ``eval_chunk`` 16384: one warm-up
             frame and two timed frames, 80 kernel launches per frame,
             finite outputs, and a 32x32 crop re-rendered on the CPU (plain
             version) must agree at >= 40 dB PSNR.
   A further frame under torch.profiler gives device time by kernel and
   the device's idle share (``profile`` line).
5. kernels - one line ``{"kernels": [...]}`` per the port's kernel table.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises and the script exits non-zero; without a CUDA card it exits 2.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12
MLP_MACS_PER_ROW = 63 * 256 + 7 * 256 * 256 + 63 * 256 + 256 * 257 + 283 * 128 + 128 * 3
MLP_FLOP_PER_ROW = 2 * MLP_MACS_PER_ROW  # 1,186,816
RTOL, ATOL = 2e-2, 8e-3
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def seeded_mlp_tree(rng, din=63, dv=27, width=256, bias_std=0.1):
    """flax-layout NerfMLP params ({name: {kernel [din, dout], bias}}) with
    lecun-scaled normal kernels and small random biases."""

    def dense(i, o):
        return {
            "kernel": (rng.standard_normal((i, o)) / math.sqrt(i)).astype("float32"),
            "bias": (bias_std * rng.standard_normal(o)).astype("float32"),
        }

    tree = {"pts_0": dense(din, width)}
    for i in range(1, 8):
        tree[f"pts_{i}"] = dense(din + width if i == 5 else width, width)
    tree["alpha"] = dense(width, 1)
    tree["feature"] = dense(width, width)
    tree["views_0"] = dense(width + dv, width // 2)
    tree["rgb"] = dense(width // 2, 3)
    return tree


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def check_close(name, got, want):
    """Max abs error of ``got`` against ``want``; raises outside rtol/atol."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values outside rtol {RTOL} / atol {ATOL}; "
            f"max abs err {float(err.max())}"
        )
    return float(err.max())


def library_mlp(x, v, p):
    """The same MLP as a bf16 torch.matmul (cuBLAS) chain: the yardstick for
    library_ms, never called by the port."""
    import torch.nn.functional as F

    relu = F.relu
    xb, vb = x.to(torch.bfloat16), v.to(torch.bfloat16)
    h = relu(F.linear(xb, p["w0"], p["b0"]))
    for i in range(1, 5):
        h = relu(F.linear(h, p[f"w{i}"], p[f"b{i}"]))
    h = relu(F.linear(h, p["w5h"]) + F.linear(xb, p["w5x"], p["b5"]))
    for i in (6, 7):
        h = relu(F.linear(h, p[f"w{i}"], p[f"b{i}"]))
    af = F.linear(h, p["waf"], p["baf"])
    feat, sigma = af[:, :256], af[:, 256]
    v1 = relu(F.linear(feat, p["wvf"]) + F.linear(vb, p["wvv"], p["bv"]))
    rgb = F.linear(v1, p["wrgb"], p["brgb"])
    return rgb[:, :3].float(), sigma.float()


def library_params(packed):
    """bf16 views of the kernel's pack for :func:`library_mlp` (x/v widths
    63/27 as the main path gives them)."""
    from xrnerf_torch.ops.fused_nerf_mlp import unpack_params

    u = unpack_params(packed)
    bf = torch.bfloat16
    p = {k: u[k].to(bf) for k in u}
    p["w0"], p["w5x"], p["wvv"] = p["w0"][:, :63], p["w5x"][:, :63], p["wvv"][:, :27]
    p["waf"] = torch.cat([p["wf"], p["wa"][:1]], 0)
    p["baf"] = torch.cat([p["bf"], p["ba"][:1]], 0)
    return {k: t.contiguous() for k, t in p.items()}


def profile_frame(render, frame_ms):
    """One frame under torch.profiler (device activity only): device time by
    kernel (top 8), the fused kernel's part, and the device's idle share
    against ``frame_ms``, the unprofiled frame time (the profiler slows the
    host, so its own wall time overstates idleness)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(e):
        return (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)) / 1e3

    kernels = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    by_kernel = sorted(((e.key, dev_ms(e), e.count) for e in kernels if dev_ms(e) > 0), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in by_kernel)
    return {"phase": "profile", "profiled_wall_ms": wall_ms, "frame_ms": frame_ms,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / frame_ms,
            "fused_mlp_ms": sum(ms for k, ms, _ in by_kernel if "fused_nerf_mlp_fwd" in k),
            "top": [{"name": k[:100], "ms": ms, "calls": c} for k, ms, c in by_kernel[:8]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import xrnerf_torch  # noqa: F401  (fails outside a checkout of the repo)
    from xrnerf_torch import build_network, load_config
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.core.renderer import render_image
    from xrnerf_torch.datasets.rays import get_rays_np, intrinsics_from_hwf, spherical_render_poses
    from xrnerf_torch.ops import build
    from xrnerf_torch.ops.fused_nerf_mlp import fused_nerf_mlp_fwd, fused_nerf_mlp_ref, pack_params
    from xrnerf_torch.utils.metrics import psnr
    from xrnerf_torch.utils.weights import nerf_state_dict_from_jax

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    build.load_library("fused_nerf_mlp_fwd")
    log = build.lib_path("fused_nerf_mlp_fwd").with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text() if log.exists() else "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "kernels": ["fused_nerf_mlp_fwd"], "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    # 3. kernel against its plain version
    rng = np.random.RandomState(SEED)
    mlp_sd = {k: torch.from_numpy(v).to(dev) for k, v in
              nerf_state_dict_from_jax(seeded_mlp_tree(rng)).items()}
    packed = pack_params(mlp_sd, 63, 27)
    lib_p = library_params(packed)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernel_rows = {}
    for n in (1000, 1_048_576, 3_145_728):
        # posenc-like inputs: 3 raw coordinates in [-2, 2], then values in [-1, 1]
        x = torch.rand((n, 63), generator=gen, device=dev) * 2 - 1
        x[:, :3] *= 2
        v = torch.rand((n, 27), generator=gen, device=dev) * 2 - 1
        rgb_k, sig_k = fused_nerf_mlp_fwd(x, v, packed)
        rgb_r, sig_r = fused_nerf_mlp_ref(x, v, packed)
        torch.cuda.synchronize()
        err = max(check_close(f"rgb N={n}", rgb_k, rgb_r), check_close(f"sigma N={n}", sig_k, sig_r))
        ms = time_ms(lambda: fused_nerf_mlp_fwd(x, v, packed))
        plain_ms = time_ms(lambda: fused_nerf_mlp_ref(x, v, packed), reps=5, warmup=1)
        library_ms = time_ms(lambda: library_mlp(x, v, lib_p))
        rgb_l, sig_l = library_mlp(x, v, lib_p)
        lib_err = float(max((rgb_l - rgb_r).abs().max(), (sig_l - sig_r).abs().max()))
        flop = n * MLP_FLOP_PER_ROW
        nbytes = n * (63 + 27 + 4) * 4 + packed.weights.numel() * 2 + packed.biases.numel() * 4
        bound_ms = max(flop / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S) * 1e3
        row = {"phase": "kernel", "name": "fused_nerf_mlp_fwd", "rows": n, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library_max_abs_err": lib_err, "bound_ms": bound_ms,
               "bound_by": "operations" if flop / H100_BF16_FLOPS >= nbytes / H100_HBM_BYTES_S else "bytes",
               "tflops": flop / (ms * 1e-3) / 1e12, "roofline_share": bound_ms / ms}
        emit(row)
        kernel_rows[n] = row
        del x, v, rgb_k, sig_k, rgb_r, sig_r, rgb_l, sig_l
        torch.cuda.empty_cache()

    # 4. the slice: full-width vanilla NeRF renders an 800x800 novel view
    cfg = load_config(os.path.join(ROOT, "configs", "nerf", "nerf_blender.py"), dataname="lego")
    model_cfg = dict(cfg["model"], fused=True)
    chunk = int(cfg["eval_chunk"])
    net_sd = nerf_state_dict_from_jax(
        {"mlp_coarse": seeded_mlp_tree(rng), "mlp_fine": seeded_mlp_tree(rng)}
    )
    tr = Trainer(build_network(model_cfg, device="cuda"), dataset=None, work_dir=None,
                 eval_chunk=chunk, seed=SEED, device="cuda")
    tr.network.load_state_dict({k: torch.from_numpy(v) for k, v in net_sd.items()})

    H = W = 800
    focal = 0.5 * W / math.tan(0.5 * 0.6911112070083618)  # lego camera_angle_x
    K = intrinsics_from_hwf(H, W, focal)
    pose = spherical_render_poses(40, phi=-30.0, radius=4.0)[8]
    rays_o, rays_d = get_rays_np(H, W, K, pose)
    n_rays = H * W
    rays = {
        "rays_o": rays_o.reshape(-1, 3), "rays_d": rays_d.reshape(-1, 3),
        "near": np.full((n_rays, 1), cfg["data"]["near"], np.float32),
        "far": np.full((n_rays, 1), cfg["data"]["far"], np.float32),
    }
    per_frame = 2 * math.ceil(n_rays / chunk)  # coarse + fine per chunk
    points_per_ray = 2 * model_cfg["n_samples"] + model_cfg["n_importance"]  # 64 + (64 + 128)
    fused_nerf_mlp_fwd.launches = 0  # the main path starts here
    frame_ms, out = [], None
    for i in range(3):  # one warm-up frame, two timed
        before = fused_nerf_mlp_fwd.launches
        t0 = time.perf_counter()
        out = tr.render_image(rays, H, W)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        got = fused_nerf_mlp_fwd.launches - before
        if got != per_frame:
            raise AssertionError(f"frame {i}: {got} kernel launches, expected {per_frame}")
        if i:
            frame_ms.append(dt)
    main_path_launches = fused_nerf_mlp_fwd.launches  # the main path ends here
    for k in ("rgb", "disp", "acc"):
        if out[k].shape[:2] != (H, W) or not np.isfinite(out[k]).all():
            raise AssertionError(f"{k}: shape {out[k].shape} or non-finite values")

    cpu_net = build_network(model_cfg, device="cpu")
    cpu_net.load_state_dict({k: torch.from_numpy(v) for k, v in net_sd.items()})
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    ys = slice(H // 2 - 16, H // 2 + 16)
    crop = {k: v.reshape(H, W, -1)[ys, ys].reshape(-1, v.shape[-1]) for k, v in rays.items()}
    t0 = time.perf_counter()
    cpu_out = render_image(cpu_net, crop, 32, 32, chunk=chunk)
    cpu_s = time.perf_counter() - t0
    crop_psnr = float(psnr(out["rgb"][ys, ys], cpu_out["rgb"]))
    if not crop_psnr >= 40.0:
        raise AssertionError(f"card vs CPU plain path on the 32x32 crop: {crop_psnr} dB < 40 dB")
    ms_frame = float(np.median(frame_ms))
    emit({"phase": "slice", "config": "configs/nerf/nerf_blender.py", "fused": True,
          "H": H, "W": W, "eval_chunk": chunk, "frames_timed": len(frame_ms),
          "ms_per_frame": ms_frame, "frame_ms": frame_ms,
          "rays_per_s": n_rays / (ms_frame * 1e-3),
          "points_per_s": n_rays * points_per_ray / (ms_frame * 1e-3),
          "launches_per_frame": per_frame, "launches": main_path_launches,
          "rgb_mean": float(out["rgb"].mean()), "acc_mean": float(out["acc"].mean()),
          "crop_psnr_vs_cpu_db": crop_psnr, "cpu_crop_s": cpu_s})

    # profiled frame (after the main path's counts were read)
    emit(profile_frame(lambda: tr.render_image(rays, H, W), ms_frame))

    # 5. kernels
    k1 = kernel_rows[1_048_576]
    emit({"kernels": [{
        "name": "fused_nerf_mlp_fwd",
        "route": "cuda",
        "source": "xrnerf_torch/csrc/fused_nerf_mlp_fwd.cu",
        "replaces": "xrnerf_tpu/ops/pallas/fused_nerf_mlp.py:150",
        "launches": main_path_launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows.values()),
        "rows": k1["rows"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
