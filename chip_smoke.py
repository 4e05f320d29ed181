#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``xrnerf_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device  - the card's name and power limit (``nvidia-smi``); TF32 off.
2. build   - the CUDA kernels ``xrnerf_torch/csrc/fused_nerf_mlp_fwd.cu``
             and ``fused_nerf_mlp_bwd.cu``, one nvcc each, started
             together; ptxas registers and spills.
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
5. bwd_kernel - ``fused_nerf_mlp_bwd`` against its plain version at width
             256 with seeded weights, N = 1000, 262,144 (one coarse train
             launch) and 786,432 (one fine launch): per leaf (dx, dv, every
             weight and bias block) cosine > 0.99 and norm ratio 0.93-1.07,
             the smallest cosine and largest relative error printed; two
             launches give the same bits; kernel, plain-version and bf16
             ``F.linear``-chain autograd backward times (median of 7).
6. train   - ``Trainer.run`` trains the same full-width network (fused,
             perturb, Adam lr 5e-4 with decay, ``N_rand`` 4096) for 40 steps
             on the lego camera over an analytic scene (a coloured sphere
             over white), logging every 10 steps and checkpointing at the
             end: finite losses, last window below the first, 2 forward and
             2 backward launches per step, ms/step, rays/s, MLP TFLOP/s;
             then ``resume_from`` the checkpoint runs to step 42. A further
             step under torch.profiler (``train_profile`` line).
7. train_grads - one 256-ray batch (perturb off): the card path's
             gradients (the kernels) against the CPU path's (the plain
             versions), same weights, per leaf cosine > 0.97 and norm ratio
             0.93-1.07.
8. kernels - one line ``{"kernels": [...]}`` per the port's kernel table.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises and the script exits non-zero; without a CUDA card it exits 2.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12
MLP_MACS_PER_ROW = 63 * 256 + 7 * 256 * 256 + 63 * 256 + 256 * 257 + 283 * 128 + 128 * 3
MLP_FLOP_PER_ROW = 2 * MLP_MACS_PER_ROW  # 1,186,816
BWD_FLOP_PER_ROW = 3 * MLP_FLOP_PER_ROW  # remat + data gradients + weight gradients: 3,560,448
RTOL, ATOL = 2e-2, 8e-3
GRAD_COS, GRAD_RATIO = 0.99, (0.93, 1.07)  # tests/test_fused_nerf_mlp.py:73-79
NET_COS = 0.97  # tests/test_fused_nerf_mlp.py:101-131
SEED = 0
BWD_ROWS = (1000, 262_144, 786_432)  # ragged; one coarse and one fine train launch
TRAIN_STEPS, TRAIN_LOG, N_RAND = 40, 10, 4096  # N_RAND: bench.py's flagship batch


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


def profile_device(run, wall_ms, phase):
    """``run()`` under torch.profiler (device activity only): device time by
    kernel (top 8), the fused kernels' part, and the device's idle share
    against ``wall_ms``, the unprofiled time of the same work (the profiler
    slows the host, so its own wall time overstates idleness)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    prof_wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(e):
        return (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)) / 1e3

    kernels = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    by_kernel = sorted(((e.key, dev_ms(e), e.count) for e in kernels if dev_ms(e) > 0), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in by_kernel)
    fwd_ms = sum(ms for k, ms, _ in by_kernel if "fused_nerf_mlp_fwd" in k)
    bwd_ms = sum(ms for k, ms, _ in by_kernel if "fused_nerf_mlp_bwd" in k)
    return {"phase": phase, "profiled_wall_ms": prof_wall_ms, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "fused_mlp_ms": fwd_ms, "fused_mlp_bwd_ms": bwd_ms,
            "fused_share_of_busy": (fwd_ms + bwd_ms) / busy_ms if busy_ms else 0.0,
            "top": [{"name": k[:100], "ms": ms, "calls": c} for k, ms, c in by_kernel[:8]]}


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def check_leaves(what, got, want, min_cos, ratio=GRAD_RATIO):
    """Per leaf: cosine, norm ratio and max abs error over the reference's
    largest entry; raises outside the bars."""
    out = {}
    for name in want:
        a, b = got[name].float(), want[name].float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what} {name}: non-finite values")
        c, r = cosine(a, b), float(a.norm() / (b.norm() + 1e-30))
        out[name] = {"cos": c, "ratio": r, "rel_err": float((a - b).abs().max() / (b.abs().max() + 1e-30)),
                     "max_abs_err": float((a - b).abs().max())}
        if not (c > min_cos and ratio[0] < r < ratio[1]):
            raise AssertionError(f"{what} {name}: cosine {c} (bar {min_cos}), norm ratio {r} (bar {ratio})")
    return out


class SphereScene:
    """In-memory training data: rays of the lego camera (800x800, focal
    1111.11) from the 40 orbit poses, ``N_rand`` random pixels per step;
    targets computed in numpy from an analytic scene, a sphere of radius 1
    at the origin coloured by its normal, over a white background."""

    def __init__(self, n_rand, near, far, seed=SEED):
        from xrnerf_torch.datasets.rays import intrinsics_from_hwf, spherical_render_poses

        self.N_rand, self.near, self.far, self.seed = n_rand, near, far, seed
        self.H = self.W = 800
        self.K = intrinsics_from_hwf(self.H, self.W, 0.5 * self.W / math.tan(0.5 * 0.6911112070083618))
        self.poses = spherical_render_poses(40, phi=-30.0, radius=4.0)

    @staticmethod
    def colour(o, d):
        a, b = (d * d).sum(-1), 2 * (o * d).sum(-1)
        disc = b * b - 4 * a * (o * o).sum(-1) + 4 * a  # radius 1
        t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        hit = (disc > 0) & (t > 0)
        normal = o + t[:, None] * d
        return np.where(hit[:, None], 0.5 + 0.5 * normal, 1.0).astype(np.float32)

    def train_batch(self, step, host_id=0, num_hosts=1):
        from xrnerf_torch.datasets.rays import get_rays_np

        rng = np.random.RandomState(self.seed + step)
        rays_o, rays_d = get_rays_np(self.H, self.W, self.K, self.poses[rng.randint(len(self.poses))])
        idx = rng.choice(self.H * self.W, self.N_rand, replace=False)
        o, d = rays_o.reshape(-1, 3)[idx], rays_d.reshape(-1, 3)[idx]
        n = self.N_rand
        return {"rays_o": o, "rays_d": d, "near": np.full((n, 1), self.near, np.float32),
                "far": np.full((n, 1), self.far, np.float32), "target": self.colour(o, d)}


class WindowLog:
    """Hook that keeps each logging window's ``last_logs``."""

    def __init__(self):
        self.windows = []

    def on_run_begin(self, tr): ...

    def on_eval(self, tr, step): ...

    def on_run_end(self, tr): ...

    def after_step(self, tr, step, logs):
        if step % tr.log_interval == 0:
            self.windows.append(dict(tr.last_logs, step=step))


def bwd_kernel_phase(dev, packed, gen):
    """The backward kernel against its plain version; returns its rows by N."""
    from xrnerf_torch.ops.fused_nerf_mlp import fused_nerf_mlp_bwd, fused_nerf_mlp_bwd_ref, unpack_params

    lib_p = {k: t.detach().clone().requires_grad_() for k, t in library_params(packed).items()}
    rows = {}
    for n in BWD_ROWS:
        x = torch.rand((n, 63), generator=gen, device=dev) * 2 - 1
        x[:, :3] *= 2
        v = torch.rand((n, 27), generator=gen, device=dev) * 2 - 1
        g = torch.randn((n, 4), generator=gen, device=dev) / n
        got = fused_nerf_mlp_bwd(x, v, g, packed)
        want = fused_nerf_mlp_bwd_ref(x, v, g, packed)
        torch.cuda.synchronize()

        def leaves(r):
            d = unpack_params(packed._replace(weights=r[2], biases=r[3]))
            return {"dx": r[0], "dv": r[1], **d}

        per_leaf = check_leaves(f"bwd N={n}", leaves(got), leaves(want), GRAD_COS)
        again = fused_nerf_mlp_bwd(x, v, g, packed)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            raise AssertionError(f"bwd N={n}: a second launch gave other bits")
        del want, again
        ms = time_ms(lambda: fused_nerf_mlp_bwd(x, v, g, packed))
        plain_ms = time_ms(lambda: fused_nerf_mlp_bwd_ref(x, v, g, packed))
        xg = x.detach().requires_grad_()
        vg = v.detach().requires_grad_()
        rgb_l, sig_l = library_mlp(xg, vg, lib_p)
        inputs = [xg, vg, *lib_p.values()]
        library_ms = time_ms(lambda: torch.autograd.grad(
            (rgb_l, sig_l), inputs, (g[:, :3].contiguous(), g[:, 3].contiguous()), retain_graph=True,
            allow_unused=True))
        del rgb_l, sig_l, xg, vg
        flop = n * BWD_FLOP_PER_ROW
        nbytes = (n * (63 + 27 + 4 + 63 + 27) * 4 + packed.weights.numel() * (2 + 4)
                  + packed.biases.numel() * (4 + 4))
        bound_ms = max(flop / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S) * 1e3
        row = {"phase": "bwd_kernel", "name": "fused_nerf_mlp_bwd", "rows": n,
               "min_cos": min(r["cos"] for r in per_leaf.values()),
               "max_abs_err": max(r["max_abs_err"] for r in per_leaf.values()),
               "deterministic": True, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms,
               "bound_by": "operations" if flop / H100_BF16_FLOPS >= nbytes / H100_HBM_BYTES_S else "bytes",
               "tflops": flop / (ms * 1e-3) / 1e12, "roofline_share": bound_ms / ms,
               "leaves": {k: [round(r["cos"], 6), round(r["ratio"], 5), round(r["rel_err"], 5)]
                          for k, r in per_leaf.items()}}
        emit(row)
        rows[n] = row
        del x, v, g, got
        torch.cuda.empty_cache()
    return rows


def train_phase(model_cfg, cfg, work_dir):
    """The training slice through ``Trainer.run``; returns (its line, the
    trainer, launches by kernel on its main path)."""
    from xrnerf_torch import build_network
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.ops.fused_nerf_mlp import fused_nerf_mlp_bwd, fused_nerf_mlp_fwd
    from xrnerf_torch.utils import checkpoint as ckpt

    ds = SphereScene(N_RAND, cfg["data"]["near"], cfg["data"]["far"])
    rec = WindowLog()

    def trainer(max_iters, **kw):
        return Trainer(build_network(model_cfg, device="cuda"), ds, optimizer=cfg["optimizer"],
                       work_dir=work_dir, max_iters=max_iters, log_interval=TRAIN_LOG,
                       ckpt_interval=TRAIN_STEPS, seed=SEED, device="cuda", **kw)

    tr = trainer(TRAIN_STEPS, hooks=[rec])
    fused_nerf_mlp_fwd.launches = fused_nerf_mlp_bwd.launches = 0  # the main path starts here
    reached = tr.run()
    torch.cuda.synchronize()
    launches = {"fused_nerf_mlp_fwd": fused_nerf_mlp_fwd.launches,
                "fused_nerf_mlp_bwd": fused_nerf_mlp_bwd.launches}  # and ends here
    if reached != TRAIN_STEPS:
        raise AssertionError(f"training stopped at step {reached}")
    for name, got in launches.items():
        if got != 2 * TRAIN_STEPS:
            raise AssertionError(f"{name}: {got} launches in {TRAIN_STEPS} steps, expected {2 * TRAIN_STEPS}")
    losses = [w["loss"] for w in rec.windows]
    if len(losses) != TRAIN_STEPS // TRAIN_LOG or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"window losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: first window {losses[0]}, last {losses[-1]}")
    path = ckpt.latest_path(work_dir)
    if path is None or not path.endswith(f"ckpt_{TRAIN_STEPS}.pt"):
        raise AssertionError(f"no checkpoint at step {TRAIN_STEPS}: {path}")
    resumed = trainer(TRAIN_STEPS + 2, resume_from=path)
    if resumed.start_step != TRAIN_STEPS or resumed.run() != TRAIN_STEPS + 2:
        raise AssertionError("resume did not continue from the checkpoint to step 42")
    ms_step = float(np.median([w["ms_per_step"] for w in rec.windows[1:]]))
    rows = N_RAND * (model_cfg["n_samples"] + model_cfg["n_samples"] + model_cfg["n_importance"])
    floor_ms = 4 * MLP_FLOP_PER_ROW * rows / H100_BF16_FLOPS * 1e3  # forward 1x + backward 3x
    line = {"phase": "train", "config": "configs/nerf/nerf_blender.py", "fused": True, "N_rand": N_RAND,
            "steps": TRAIN_STEPS, "resumed_to": TRAIN_STEPS + 2, "window_losses": losses,
            "window_ms_per_step": [w["ms_per_step"] for w in rec.windows],
            "ms_per_step": ms_step, "rays_per_s": N_RAND / (ms_step * 1e-3),
            "points_per_s": rows / (ms_step * 1e-3), "mlp_rows_per_step": rows,
            "mlp_tflops_bench_count": 3 * MLP_FLOP_PER_ROW * rows / (ms_step * 1e-3) / 1e12,
            "mlp_floor_ms": floor_ms, "mlp_floor_share": floor_ms / ms_step,
            "launches": launches, "launches_per_step": {k: n / TRAIN_STEPS for k, n in launches.items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return line, tr, ds, launches


def train_grads_phase(model_cfg, net_sd):
    """One 256-ray batch, perturb off: the card path's gradients against the
    CPU path's, same weights."""
    from xrnerf_torch import build_network

    cfg = dict(model_cfg, perturb=False)
    batch = SphereScene(256, 2.0, 6.0, seed=SEED + 1000).train_batch(0)
    grads = {}
    for device in ("cuda", "cpu"):
        net = build_network(cfg, device=device)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in net_sd.items()})
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        loss, _ = net.loss(net(b, generator=torch.Generator(device=device).manual_seed(SEED), train=True), b)
        loss.backward()
        grads[device] = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
        grads[device + "_loss"] = loss.item()
    per_leaf = check_leaves("train_grads", grads["cuda"], grads["cpu"], NET_COS)
    return {"phase": "train_grads", "rays": 256, "loss_card": grads["cuda_loss"], "loss_cpu": grads["cpu_loss"],
            "min_cos": min(r["cos"] for r in per_leaf.values()),
            "ratio_range": [min(r["ratio"] for r in per_leaf.values()), max(r["ratio"] for r in per_leaf.values())]}


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
    names = ["fused_nerf_mlp_fwd", "fused_nerf_mlp_bwd"]
    build.load_libraries(names)
    ptxas = {}
    for name in names:
        log = build.lib_path(name).with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in (log.read_text() if log.exists() else "").splitlines()
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "kernels": names, "seconds": time.perf_counter() - t0, "ptxas": ptxas})

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

    bwd_rows = bwd_kernel_phase(dev, packed, gen)

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
    emit(profile_device(lambda: tr.render_image(rays, H, W), ms_frame, "profile"))
    del tr, out
    torch.cuda.empty_cache()

    # 6. training
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        line, ttr, ds, train_launches = train_phase(model_cfg, cfg, work_dir)
        emit(line)
        batch = ttr._put_batch(ds.train_batch(10_000))
        emit(profile_device(lambda: ttr.train_step(batch, 10_000), line["ms_per_step"], "train_profile"))
        del ttr, batch
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # 7. training gradients, card against CPU
    emit(train_grads_phase(model_cfg, net_sd))

    # 8. kernels
    k1, b1 = kernel_rows[1_048_576], bwd_rows[786_432]
    keys = ("rows", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "fused_nerf_mlp_fwd", "route": "cuda", "source": "xrnerf_torch/csrc/fused_nerf_mlp_fwd.cu",
         "replaces": "xrnerf_tpu/ops/pallas/fused_nerf_mlp.py:150",
         "launches": main_path_launches + train_launches["fused_nerf_mlp_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in kernel_rows.values()), **{k: k1[k] for k in keys}},
        {"name": "fused_nerf_mlp_bwd", "route": "cuda", "source": "xrnerf_torch/csrc/fused_nerf_mlp_bwd.cu",
         "replaces": "xrnerf_tpu/ops/pallas/fused_nerf_mlp.py:159",
         "launches": train_launches["fused_nerf_mlp_bwd"],
         "max_abs_err": max(r["max_abs_err"] for r in bwd_rows.values()),
         "min_cos": min(r["min_cos"] for r in bwd_rows.values()), **{k: b1[k] for k in keys}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
