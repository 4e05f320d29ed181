#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``xrnerf_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device  - the card's name and power limit (``nvidia-smi``); TF32 off.
2. build   - the CUDA kernels ``xrnerf_torch/csrc/fused_nerf_mlp_fwd.cu``,
             ``fused_nerf_mlp_bwd.cu``, ``fused_mlp_fwd.cu``,
             ``fused_mlp_bwd.cu`` and ``scatter_rows.cu``, one nvcc each,
             started together; ptxas registers and spills; for the two
             vanilla-NeRF kernels each kernel's dynamic shared memory.
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
             ``F.linear``-chain autograd backward times (median of 7); one
             more launch under torch.profiler gives the device time of each
             of its passes (``passes_ms``).
6. train   - ``Trainer.run`` trains the same full-width network (fused,
             perturb, Adam lr 5e-4 with decay, ``N_rand`` 4096) for 40 steps
             on the lego camera over an analytic scene (a coloured sphere
             over white), logging every 10 steps and checkpointing at the
             end: finite losses, last window below the first, 2 forward and
             2 backward launches per step, ms/step, rays/s, MLP TFLOP/s, and
             the host time of one batch (pixels drawn without replacement);
             then ``resume_from`` the checkpoint runs to step 42. A further
             step under torch.profiler (``train_profile`` line).
7. train_grads - one 256-ray batch (perturb off): the card path's
             gradients (the kernels) against the CPU path's (the plain
             versions), same weights, per leaf cosine > 0.97 and norm ratio
             0.93-1.07.
8. kernel (tiny MLPs) - ``fused_mlp2_fwd`` (32-64-16) and ``fused_mlp3_fwd``
             (31-64-64-3) against their plain versions at N = 1000, 65,536
             (one grid refresh) and 262,144 (one render chunk), rtol 2e-2 /
             atol 8e-3; kernel, plain-version and bf16 ``F.linear``-chain
             times by CUDA events over a run of calls that walk four input
             buffers (so each finds the L2 cold), queued behind a spin
             kernel so that the host's launch rate does not enter.
9. ngp_grid - Instant-NGP from ``configs/instant_ngp/ngp_blender.py`` at
             full width (16x2 levels, table 2^19, grid 128^3, 512
             candidates, keep 64, budget 2^18) with ``fused=True``: the
             Trainer's construction runs ``init_aux`` on the 40 orbit
             cameras, the seeded table and density column are scaled and the
             density bias set so density varies widely over the cube (scales
             printed), and 16
             ``update_aux`` refreshes run on the card: occupied and
             untrained share of the grid, ms per refresh.
10. ngp_slice - the weights and grid go through a ``.pt`` file into a second
             Trainer (``load_from``, EMA copy as the config asks), which
             renders an 800x800 view at ``eval_chunk`` 8192: one warm-up and
             three timed frames, 79 launches of each tiny-MLP kernel per
             frame, live fraction per chunk (no chunk over the sample
             budget), finite outputs, and a 32x32 crop re-rendered on the
             CPU (plain versions, same weights, same grid) must agree at
             >= 40 dB PSNR. Then one frame under torch.profiler
             (``ngp_profile``: the kernels', the gather's and the sorts'
             share) and the count of host syncs in one chunk (``ngp_syncs``).
11. kernel (tiny-MLP backwards) - ``fused_mlp2_bwd`` and ``fused_mlp3_bwd``
             against their plain versions at the same shapes, N = 127, 128,
             129 (ragged tiles and warpgroup halves) and the N above: per leaf
             (dx and every weight and bias gradient) cosine > 0.99 and norm
             ratio 0.93-1.07, dx also with more than 99 % of its values
             within 3 % of its scale, the same bits on a second launch;
             kernel, plain-version and library times (autograd backward of
             the bf16 ``F.linear`` chain), L2-cold, behind the spin kernel.
12. kernel (scatter) - ``scatter_add_rows`` against its plain version
             (rtol 1e-4, atol 1e-4 of the largest row sum: atomics add in
             another order every run) for the finest hashed vertex level
             (2,097,152 x 2 rows into 524,288, indices of random points),
             the coarsest dense level (into 4,096), the brick shape
             (262,144 x 16 into 65,536, 70 % all-zero rows, skipped) and
             1000 rows with negative ids; library time: ``index_add_``. The
             fifth case, ``vertex_step``, runs after phase 15 on the 16
             levels' corner indices and update rows of one real training step
             (march order), captured from ``ngp_train``'s trainer:
             ``scatter_add_rows_levels`` in one launch against its plain
             version and its time, the same on random points; library time:
             16 ``index_add_``.
13. ngp_train - ``Trainer.run`` trains Instant-NGP at full width (fused, the
             config's Adam and EMA, ``N_rand`` 4096) for 64 steps on the
             analytic sphere seen from the 40 orbit cameras, in
             ``HashNerfDataset``'s batch format: grid refreshes before steps
             0, 16, 32, 48; per step exactly one forward and one backward
             launch of each tiny MLP and one scatter (all 16 levels), one more ``fused_mlp2``
             forward per refresh; falling loss, finite logs, the EMA copy's
             grid equal to the network's; a checkpoint and a resume to step
             66. ``ngp_train_compacted``: 8 more steps from the checkpoint at
             ``N_rand`` 16,384, four times the sample budget, so the
             compaction and its backward run.
14. ngp_train_grads - the trained weights and grid, 256 rays, deterministic
             march: the card path's gradients against the CPU path's, per
             leaf (the hash table included) cosine > 0.97, norm ratio
             0.93-1.07.
15. ngp_train_profile - one step under torch.profiler by kernel group, the
             Adam step and the EMA update timed alone, and the count of host
             syncs in a step (must be 0).
16. ngp_brick_train - ``hash_layout="brick"``, one lattice, full width: 16
             steps, one scatter per step and lattice, finite and falling loss.
17. kernels - one line ``{"kernels": [...]}`` per the port's kernel table.

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
FWD_ROWS = (1000, 1_048_576, 3_145_728)  # ragged; one coarse and one fine eval chunk
BWD_ROWS = (1000, 262_144, 786_432)  # ragged; one coarse and one fine train launch
TRAIN_STEPS, TRAIN_LOG, N_RAND = 40, 10, 4096  # N_RAND: bench.py's flagship batch
TINY_ROWS = (1000, 65_536, 262_144)  # ragged; one grid refresh; one render chunk
TINY_BWD_ROWS = (127, 128, 129) + TINY_ROWS  # and ragged tiles, warpgroup halves
TINY_SHAPES = {"fused_mlp2_fwd": (32, 64, 16), "fused_mlp3_fwd": (31, 64, 64, 3)}
# Seeded NGP field: flax's init, then the table and the density column of
# the density net are scaled so that raw density is spread widely, and the
# density bias is set so that this share of random points lies above the
# grid's threshold (a few percent of the cube ends up occupied, as in a
# trained scene, and no render chunk overflows the sample budget).
NGP_TABLE_SCALE, NGP_SIGMA_SCALE, NGP_SHARE_ABOVE = 1e4, 50.0, 0.10
NGP_REFRESHES = 16
TINY_BWD_SHAPES = {"fused_mlp2_bwd": (32, 64, 16), "fused_mlp3_bwd": (31, 64, 64, 3)}
NGP_TRAIN_STEPS, NGP_TRAIN_LOG, NGP_AUX_INTERVAL = 64, 16, 16
NGP_COMPACT_STEPS, NGP_COMPACT_RAND = 8, 16_384  # 4x the sample budget in candidates' kept samples
NGP_BRICK_STEPS = 16  # two logging windows of 8
SCATTER_RTOL = 1e-4  # and atol 1e-4 of the largest row sum: f32 atomics add in another order every run


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


def time_ms(fn, reps: int = 7, warmup: int = 2, inner: int = 1, head_start_ms: float = 0.0) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls of
    ``fn``, per call. For kernels shorter than the host takes to launch them,
    ``head_start_ms`` first keeps the card busy that long (a spin kernel), so
    the host queues all the calls meanwhile and the events bracket
    back-to-back device work, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin_cycles = int(head_start_ms * 1e-3 * 1.7e9)  # ~1.7 GHz SM clock
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
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


def device_times(run):
    """``run()`` under torch.profiler (device activity only): [(kernel name,
    device ms, launches)], largest first, and the profiled wall time in ms."""
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
    return by_kernel, prof_wall_ms


def profile_device(run, wall_ms, phase, groups=None, top=8):
    """``run()`` under torch.profiler: device time by kernel (the ``top``
    largest), the fused kernels' part, and the device's idle share
    against ``wall_ms``, the unprofiled time of the same work (the profiler
    slows the host, so its own wall time overstates idleness). ``groups``
    ({label: substrings of kernel names, or a predicate on the name}) adds
    each group's device time."""
    by_kernel, prof_wall_ms = device_times(run)
    busy_ms = sum(ms for _, ms, _ in by_kernel)
    fwd_ms = sum(ms for k, ms, _ in by_kernel if "fused_nerf_mlp_fwd" in k)
    bwd_ms = sum(ms for k, ms, _ in by_kernel if "fused_nerf_mlp_bwd" in k)
    line = {"phase": phase, "profiled_wall_ms": prof_wall_ms, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernel_launches": sum(c for _, _, c in by_kernel),
            "fused_mlp_ms": fwd_ms, "fused_mlp_bwd_ms": bwd_ms,
            "fused_share_of_busy": (fwd_ms + bwd_ms) / busy_ms if busy_ms else 0.0,
            "top": [{"name": k[:100], "ms": ms, "calls": c} for k, ms, c in by_kernel[:top]]}
    for label, subs in (groups or {}).items():
        match = subs if callable(subs) else (lambda k, subs=subs: any(sub in k for sub in subs))
        g_ms = sum(ms for k, ms, _ in by_kernel if match(k))
        line[f"{label}_ms"] = g_ms
        line[f"{label}_share_of_busy"] = g_ms / busy_ms if busy_ms else 0.0
    return line


BWD_PASSES = ("fused_nerf_mlp_bwd_rows", "fused_nerf_mlp_bwd_wgrad", "fused_nerf_mlp_bwd_finish")


def passes_ms(run) -> dict:
    """Device time (ms) of each of the backward's passes in ``run()``, and of
    everything else it starts (``other``: the wrapper's fills)."""
    by_kernel, _ = device_times(run)
    out = {name: sum(ms for k, ms, _ in by_kernel if name in k) for name in BWD_PASSES}
    out["other"] = sum(ms for _, ms, _ in by_kernel) - sum(out.values())
    return out


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
    def trace(o, d):
        """(colour [n, 3], hit [n]) of the rays o + t d."""
        a, b = (d * d).sum(-1), 2 * (o * d).sum(-1)
        disc = b * b - 4 * a * (o * o).sum(-1) + 4 * a  # radius 1
        t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        hit = (disc > 0) & (t > 0)
        normal = o + t[:, None] * d
        return np.where(hit[:, None], 0.5 + 0.5 * normal, 1.0).astype(np.float32), hit

    @classmethod
    def colour(cls, o, d):
        return cls.trace(o, d)[0]

    def train_batch(self, step, host_id=0, num_hosts=1):
        """``N_rand`` random pixels of one random camera. Only their rays are
        made (``get_rays_np``'s arithmetic for the chosen pixels), so the host's
        part of a step stays small, as with a dataset that holds its rays.
        Pixels are distinct, as ``SceneDataset`` draws them: a few more than
        ``N_rand`` are drawn (4,096 draws of 640,000 pixels repeat about 13
        times), repeats dropped, the first ``N_rand`` kept in draw order, and
        more drawn in the rare case that too few are left (no permutation of
        the 640,000 pixels per step; one sort of the draws)."""
        rng = np.random.RandomState(self.seed + step)
        pose = self.poses[rng.randint(len(self.poses))].astype(np.float32)
        extra = self.N_rand // 32
        pix = rng.randint(self.H * self.W, size=self.N_rand + extra)
        while True:
            order = np.argsort(pix)
            fresh = np.ones(len(pix), bool)
            fresh[1:] = pix[order[1:]] != pix[order[:-1]]
            keep = np.sort(order[fresh])
            if len(keep) >= self.N_rand:
                break
            pix = np.concatenate([pix, rng.randint(self.H * self.W, size=extra)])
        pix = pix[keep[: self.N_rand]]
        col, row = (pix % self.W).astype(np.float32), (pix // self.W).astype(np.float32)
        K = self.K
        dirs = np.stack([(col - K[0, 2]) / K[0, 0], -(row - K[1, 2]) / K[1, 1], -np.ones_like(col)], axis=-1)
        d = (dirs @ pose[:3, :3].T).astype(np.float32)
        o = np.broadcast_to(pose[:3, 3], d.shape).astype(np.float32)
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


def fwd_kernel_phase(dev, packed, gen, rows=FWD_ROWS):
    """The forward kernel against its plain version; returns its rows by N."""
    from xrnerf_torch.ops.fused_nerf_mlp import fused_nerf_mlp_fwd, fused_nerf_mlp_ref

    lib_p = library_params(packed)
    kernel_rows = {}
    for n in rows:
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
    return kernel_rows


def bwd_kernel_phase(dev, packed, gen, rows=BWD_ROWS):
    """The backward kernel against its plain version; returns its rows by N."""
    from xrnerf_torch.ops.fused_nerf_mlp import fused_nerf_mlp_bwd, fused_nerf_mlp_bwd_ref, unpack_params

    lib_p = {k: t.detach().clone().requires_grad_() for k, t in library_params(packed).items()}
    out = {}
    for n in rows:
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
        by_pass = passes_ms(lambda: fused_nerf_mlp_bwd(x, v, g, packed))
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
               "deterministic": True, "ms": ms, "passes_ms": by_pass, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "operations" if flop / H100_BF16_FLOPS >= nbytes / H100_HBM_BYTES_S else "bytes",
               "tflops": flop / (ms * 1e-3) / 1e12, "roofline_share": bound_ms / ms,
               "leaves": {k: [round(r["cos"], 6), round(r["ratio"], 5), round(r["rel_err"], 5)]
                          for k, r in per_leaf.items()}}
        emit(row)
        out[n] = row
        del x, v, g, got
        torch.cuda.empty_cache()
    return out


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
    batch_ms = []
    for step in range(20):
        t0 = time.perf_counter()
        ds.train_batch(step)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    rows = N_RAND * (model_cfg["n_samples"] + model_cfg["n_samples"] + model_cfg["n_importance"])
    floor_ms = 4 * MLP_FLOP_PER_ROW * rows / H100_BF16_FLOPS * 1e3  # forward 1x + backward 3x
    line = {"phase": "train", "config": "configs/nerf/nerf_blender.py", "fused": True, "N_rand": N_RAND,
            "steps": TRAIN_STEPS, "resumed_to": TRAIN_STEPS + 2, "window_losses": losses,
            "window_ms_per_step": [w["ms_per_step"] for w in rec.windows],
            "ms_per_step": ms_step, "rays_per_s": N_RAND / (ms_step * 1e-3),
            "batch_host_ms": float(np.median(batch_ms)), "points_per_s": rows / (ms_step * 1e-3), "mlp_rows_per_step": rows,
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


def tiny_mlp_phase(dev, gen):
    """The two tiny-MLP forward kernels against their plain versions;
    returns their rows by kernel name and N."""
    import torch.nn.functional as F

    from xrnerf_torch.ops import fused_mlp as fm

    fns = {"fused_mlp2_fwd": (fm.fused_mlp2, fm.fused_mlp2_plain), "fused_mlp3_fwd": (fm.fused_mlp3, fm.fused_mlp3_plain)}
    rng = np.random.RandomState(SEED + 3)
    rows = {}
    for name, shape in TINY_SHAPES.items():
        fn, plain = fns[name]
        params = []  # w1 [in, out], b1, w2, b2, ...: lecun-scaled kernels, small biases
        for i, o in zip(shape[:-1], shape[1:]):
            params += [torch.from_numpy((rng.standard_normal((i, o)) / math.sqrt(i)).astype("float32")).to(dev),
                       torch.from_numpy((0.1 * rng.standard_normal(o)).astype("float32")).to(dev)]
        lib = [(w.t().to(torch.bfloat16).contiguous(), b.to(torch.bfloat16)) for w, b in zip(params[::2], params[1::2])]

        def library(x, *_):  # the yardstick: a bf16 F.linear (cuBLAS) chain, never called by the port
            h = x.to(torch.bfloat16)
            for j, (w, b) in enumerate(lib):
                h = F.linear(h, w, b)
                if j < len(lib) - 1:
                    h = F.relu(h)
            return h.float()

        rows[name] = {}
        with torch.no_grad():
            for n in TINY_ROWS:
                # as the main path gives them: bf16-valued f32 inputs; four buffers, walked in
                # turn, exceed the 50 MB L2 at the render shape
                xs = [(torch.rand((n, shape[0]), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16).float()
                      for _ in range(4)]
                turn = [0]

                def walk(f):
                    def call():
                        turn[0] += 1
                        return f(xs[turn[0] % 4], *params)
                    return call

                got, want = fn(xs[0], *params), plain(xs[0], *params)
                torch.cuda.synchronize()
                err = check_close(f"{name} N={n}", got, want)
                lib_err = float((library(xs[0]) - want).abs().max())
                # microsecond kernels: give the host a head start (see time_ms)
                ms = time_ms(walk(fn), inner=20, head_start_ms=4.0)
                plain_ms = time_ms(walk(plain), inner=4, head_start_ms=4.0)
                library_ms = time_ms(walk(library), inner=4, head_start_ms=4.0)
                flop = 2 * n * sum(i * o for i, o in zip(shape[:-1], shape[1:]))
                nbytes = 4 * (n * (shape[0] + shape[-1]) + sum(p.numel() for p in params))
                bound_ms = max(flop / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S) * 1e3
                row = {"phase": "kernel", "name": name, "shape": list(shape), "rows": n, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "library_max_abs_err": lib_err,
                       "bound_ms": bound_ms, "bytes": nbytes, "flop": flop,
                       "bound_by": "operations" if flop / H100_BF16_FLOPS >= nbytes / H100_HBM_BYTES_S else "bytes",
                       "gb_per_s": nbytes / (ms * 1e-3) / 1e9, "roofline_share": bound_ms / ms}
                emit(row)
                rows[name][n] = row
                del xs, got, want
                torch.cuda.empty_cache()
    return rows


class OrbitCameras:
    """What ``HashNerfNetwork.init_aux`` reads of a dataset: the lego camera
    (800x800, focal 1111.11) on the 40 orbit poses, in NGP grid coordinates."""

    def __init__(self):
        from xrnerf_torch.datasets.hashnerf import pose_nerf2ngp
        from xrnerf_torch.datasets.rays import intrinsics_from_hwf, spherical_render_poses

        self.H = self.W = 800
        self.focal = 0.5 * self.W / math.tan(0.5 * 0.6911112070083618)  # lego camera_angle_x
        self.K = intrinsics_from_hwf(self.H, self.W, self.focal)
        self.poses_ngp = np.stack([pose_nerf2ngp(p) for p in spherical_render_poses(40, phi=-30.0, radius=4.0)])
        self.i_train = np.arange(len(self.poses_ngp))


def count_host_syncs(run):
    """``cudaStreamSynchronize`` calls inside one ``run()`` (its inputs
    already on the card), and the ops the first few ran inside."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    torch.cuda.synchronize()
    events = list(prof.events())
    syncs = [e for e in events if e.name == "cudaStreamSynchronize"]
    inside = []
    for e in syncs[:8]:
        outer = [o for o in events if o is not e and o.thread == e.thread and o.name.startswith("aten::")
                 and o.time_range.start <= e.time_range.start and o.time_range.end >= e.time_range.end]
        outer.sort(key=lambda o: o.time_range.end - o.time_range.start)
        inside.append([o.name for o in outer[:2]])
    return len(syncs), inside


def ngp_phases(work_dir):
    """Instant-NGP serving at full width: grid refreshes, then frames through
    a Trainer built from a weights file. Returns the launches of the two
    tiny-MLP kernels on that path."""
    from xrnerf_torch import build_network, load_config
    from xrnerf_torch.core.renderer import render_image
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.datasets.rays import get_rays_np
    from xrnerf_torch.models.samplers.ngp_march import march_rays
    from xrnerf_torch.ops.fused_mlp import fused_mlp2, fused_mlp3
    from xrnerf_torch.utils.metrics import psnr

    cfg = load_config(os.path.join(ROOT, "configs", "instant_ngp", "ngp_blender.py"), dataname="lego")
    model_cfg = dict(cfg["model"], fused=True)
    chunk = int(cfg["eval_chunk"])
    cams = OrbitCameras()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp2.launches = fused_mlp3.launches = 0  # the main path starts here

    # the grid a server needs: init_aux at construction, then refreshes
    t0 = time.perf_counter()
    first = Trainer(build_network(model_cfg, device="cuda"), dataset=cams, work_dir=None, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    net = first.network
    with torch.no_grad():
        net.field.encoding.table.mul_(NGP_TABLE_SCALE)
        net.field.d_w2[:, 0].mul_(NGP_SIGMA_SCALE)
        pts = torch.rand((65536, 3), generator=torch.Generator(device="cuda").manual_seed(SEED + 7), device="cuda")
        raw = net.field.density(pts)[0]  # bias 0; sigma * dt > threshold <=> raw > log(threshold / dt)
        bar = math.log(model_cfg["density_threshold"] * model_cfg["n_candidates"] / math.sqrt(3.0))
        sigma_bias = bar - float(torch.quantile(raw, 1.0 - NGP_SHARE_ABOVE))
        net.field.d_b2[0] = sigma_bias
        raw_std = float(raw.std())
    fused_mlp2.launches = 0  # the calibration launch above is not the main path
    untrained = float((net.grid_density < 0).float().mean())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    refresh_ms = []
    for _ in range(NGP_REFRESHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.update_aux(gen)
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
    if fused_mlp2.launches != NGP_REFRESHES or fused_mlp3.launches != 0:
        raise AssertionError(f"{NGP_REFRESHES} refreshes launched fused_mlp2 {fused_mlp2.launches} times")
    occupied = float(net.grid_bitfield.float().mean())
    if not (0.0 < occupied < 0.5) or bool(net.grid_bitfield[net.grid_density < 0].any()):
        raise AssertionError(f"occupied share {occupied} after {NGP_REFRESHES} refreshes, or an untrained cell is occupied")
    emit({"phase": "ngp_grid", "config": "configs/instant_ngp/ngp_blender.py", "fused": True,
          "grid_res": model_cfg["grid_res"], "cameras": len(cams.poses_ngp), "construct_s": construct_s,
          "table_scale": NGP_TABLE_SCALE, "sigma_weight_scale": NGP_SIGMA_SCALE, "sigma_bias": sigma_bias,
          "share_above_threshold": NGP_SHARE_ABOVE, "raw_sigma_std": raw_std,
          "refreshes": NGP_REFRESHES, "samples_per_refresh": model_cfg["grid_update_samples"],
          "occupied_share": occupied, "untrained_share": untrained,
          "ms_per_refresh": float(np.median(refresh_ms[1:])), "refresh_ms": refresh_ms,
          "launches_per_refresh": {"fused_mlp2_fwd": 1, "fused_mlp3_fwd": 0}})

    # serving: weights and grid through a file into a second Trainer
    pt = os.path.join(work_dir, "ngp_weights.pt")
    torch.save(net.state_dict(), pt)
    del first, net
    torch.cuda.empty_cache()
    tr = Trainer(build_network(model_cfg, device="cuda"), dataset=cams, work_dir=None, eval_chunk=chunk,
                 seed=SEED + 1, load_from=pt, ema_decay=cfg["ema_decay"], device="cuda")
    H, W = cams.H, cams.W
    rays_o, rays_d = get_rays_np(H, W, cams.K, cams.poses_ngp[8])
    rays = {"rays_o": rays_o.reshape(-1, 3), "rays_d": rays_d.reshape(-1, 3)}
    n_rays = H * W
    n_chunks = math.ceil(n_rays / chunk)
    frame_ms, out = [], None
    for i in range(4):  # one warm-up frame, three timed
        before = (fused_mlp2.launches, fused_mlp3.launches)
        t0 = time.perf_counter()
        out = tr.render_image(rays, H, W)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        got = (fused_mlp2.launches - before[0], fused_mlp3.launches - before[1])
        if got != (n_chunks, n_chunks):
            raise AssertionError(f"NGP frame {i}: {got} tiny-MLP launches, expected {n_chunks} of each")
        if i:
            frame_ms.append(dt)
    launches = {"fused_mlp2_fwd": fused_mlp2.launches, "fused_mlp3_fwd": fused_mlp3.launches}  # the main path ends here
    if sorted(out) != ["acc", "rgb"]:  # HashNerfNetwork has no disp; the default keys skip it
        raise AssertionError(f"NGP render returned {sorted(out)}")
    for k, v in out.items():
        if v.shape[:2] != (H, W) or not np.isfinite(v).all():
            raise AssertionError(f"ngp {k}: shape {v.shape} or non-finite values")

    # live samples per chunk (the march alone): no chunk may overflow the budget,
    # or the frame drops samples that the CPU crop, a chunk of its own, keeps
    enet = tr.eval_network
    live = []
    with torch.inference_mode():
        for s0 in range(0, n_rays, chunk):
            o = torch.from_numpy(rays["rays_o"][s0:s0 + chunk]).cuda()
            d = torch.from_numpy(rays["rays_d"][s0:s0 + chunk]).cuda()
            m = march_rays(None, o, d, enet.grid, n_candidates=enet.n_candidates, n_keep=enet.n_keep,
                           cone_angle=enet.cone_angle, res=enet.grid_res)
            live.append(m.mask.sum())
        live = torch.stack(live).cpu().numpy()
    budget = model_cfg["sample_budget"]
    if live.max() > budget:
        raise AssertionError(f"a chunk holds {int(live.max())} live samples, over the budget {budget}")

    cpu_net = build_network(model_cfg, device="cpu")
    cpu_net.load_state_dict(torch.load(pt, map_location="cpu", weights_only=True))
    ys = slice(H // 2 - 16, H // 2 + 16)
    crop = {k: v.reshape(H, W, 3)[ys, ys].reshape(-1, 3) for k, v in rays.items()}
    t0 = time.perf_counter()
    cpu_out = render_image(cpu_net, crop, 32, 32, chunk=chunk)
    cpu_s = time.perf_counter() - t0
    crop_psnr = float(psnr(out["rgb"][ys, ys], cpu_out["rgb"]))
    if not crop_psnr >= 40.0:
        raise AssertionError(f"NGP card vs CPU plain path on the 32x32 crop: {crop_psnr} dB < 40 dB")
    ms_frame = float(np.median(frame_ms))
    emit({"phase": "ngp_slice", "config": "configs/instant_ngp/ngp_blender.py", "fused": True, "load_from": True,
          "ema_copy": tr.ema_network is not None, "H": H, "W": W, "eval_chunk": chunk,
          "frames_timed": len(frame_ms), "ms_per_frame": ms_frame, "frame_ms": frame_ms,
          "rays_per_s": n_rays / (ms_frame * 1e-3), "samples_per_s": float(live.sum()) / (ms_frame * 1e-3),
          "launches_per_frame": {"fused_mlp2_fwd": n_chunks, "fused_mlp3_fwd": n_chunks}, "launches": launches,
          "rows_per_launch": min(budget, chunk * model_cfg["n_keep"]),
          "live_fraction": float(live.sum()) / (n_rays * model_cfg["n_keep"]),
          "max_chunk_live_over_budget": float(live.max()) / budget,
          "rgb_mean": float(out["rgb"].mean()), "rgb_std": float(out["rgb"].std()),
          "acc_mean": float(out["acc"].mean()), "crop_acc_mean": float(cpu_out["acc"].mean()),
          "crop_psnr_vs_cpu_db": crop_psnr, "cpu_crop_s": cpu_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    # profiled frame and host syncs of one chunk (after the main path's counts were read);
    # "gather" is every index_select / gather kernel: per chunk the 16 hash gathers, the
    # march's three and the compaction's four
    groups = {"tiny_mlp": ["tiny_mlp_fwd_kernel"], "gather": ["scatter_gather", "indexSelect", "vectorized_gather"],
              "sort": ["sort", "Sort", "radix", "Radix"]}
    emit(profile_device(lambda: tr.render_image(rays, H, W), ms_frame, "ngp_profile", groups, top=12))
    mid = (n_chunks // 2) * chunk
    cb = {k: torch.from_numpy(v[mid:mid + chunk]).cuda() for k, v in rays.items()}
    n_syncs, inside = count_host_syncs(lambda: enet(cb, train=False))
    emit({"phase": "ngp_syncs", "rays": chunk, "cudaStreamSynchronize": n_syncs, "inside": inside})
    del tr, enet, cb, out
    torch.cuda.empty_cache()
    return launches


def bound(flop, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the bf16 peak
    and the bytes over the memory rate."""
    t_ops, t_bytes = flop / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def tiny_mlp_bwd_phase(dev, gen):
    """The two tiny-MLP backward kernels against their plain versions;
    returns their rows by kernel name and N."""
    import torch.nn.functional as F

    from xrnerf_torch.ops import fused_mlp as fm

    fns = {"fused_mlp2_bwd": (fm.fused_mlp2_bwd, fm.fused_mlp2_bwd_plain),
           "fused_mlp3_bwd": (fm.fused_mlp3_bwd, fm.fused_mlp3_bwd_plain)}
    rng = np.random.RandomState(SEED + 4)
    rows = {}
    for name, shape in TINY_BWD_SHAPES.items():
        fn, plain = fns[name]
        params = []  # w1 [in, out], b1, w2, b2, ...: lecun-scaled kernels, small biases
        for i, o in zip(shape[:-1], shape[1:]):
            params += [torch.from_numpy((rng.standard_normal((i, o)) / math.sqrt(i)).astype("float32")).to(dev),
                       torch.from_numpy((0.1 * rng.standard_normal(o)).astype("float32")).to(dev)]
        args = params[:-1]  # the last bias does not enter the backward
        leaf_names = ["dx"] + [f"d{k}{i}" for i in range(1, len(shape)) for k in "wb"]
        lib = [(w.t().to(torch.bfloat16).contiguous().requires_grad_(), b.to(torch.bfloat16).requires_grad_())
               for w, b in zip(params[::2], params[1::2])]

        def library_graph(x):  # the yardstick: a bf16 F.linear (cuBLAS) chain under autograd, never called by the port
            h = x.to(torch.bfloat16)
            for j, (w, b) in enumerate(lib):
                h = F.linear(h, w, b)
                if j < len(lib) - 1:
                    h = F.relu(h)
            return h.float()

        rows[name] = {}
        for n in TINY_BWD_ROWS:
            # four input sets, walked in turn, so each call finds the L2 cold
            xs = [(torch.rand((n, shape[0]), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16).float()
                  for _ in range(4)]
            gs = [torch.randn((n, shape[-1]), generator=gen, device=dev) / n for _ in range(4)]
            turn = [0]

            def walk(f):
                def call():
                    turn[0] += 1
                    return f(xs[turn[0] % 4], *args, gs[turn[0] % 4])
                return call

            got, want = fn(xs[0], *args, gs[0]), plain(xs[0], *args, gs[0])
            torch.cuda.synchronize()
            per_leaf = check_leaves(f"{name} N={n}", dict(zip(leaf_names, got)), dict(zip(leaf_names, want)), GRAD_COS)
            scale = float(want[0].abs().max()) + 1e-30
            dx_share = float(((got[0] - want[0]).abs() / scale < 0.03).float().mean())
            if not dx_share > 0.99:
                raise AssertionError(f"{name} N={n}: only {dx_share} of dx within 3 % of its scale")
            if not all(torch.equal(a, b) for a, b in zip(fn(xs[0], *args, gs[0]), got)):
                raise AssertionError(f"{name} N={n}: a second launch gave other bits")
            ms = time_ms(walk(fn), inner=20, head_start_ms=4.0)
            plain_ms = time_ms(walk(plain), inner=4, head_start_ms=4.0)
            inputs = [t for wb in lib for t in wb]
            graphs = []
            for x, g in zip(xs, gs):
                xg = x.detach().requires_grad_()
                graphs.append((library_graph(xg), [xg] + inputs, g))

            def library_bwd():
                turn[0] += 1
                out, leaves, g = graphs[turn[0] % 4]
                return torch.autograd.grad(out, leaves, g, retain_graph=True)

            library_ms = time_ms(library_bwd, inner=4, head_start_ms=4.0)
            widths = list(zip(shape[:-1], shape[1:]))
            # recompute, data gradients (every layer's dh, dx included), weight gradients
            flop = 2 * n * (sum(i * o for i, o in widths[:-1]) + 2 * sum(i * o for i, o in widths))
            nbytes = 4 * (n * (2 * shape[0] + shape[-1]) + sum(p.numel() for p in args) + sum(p.numel() for p in params))
            bound_ms, bound_by = bound(flop, nbytes)
            row = {"phase": "kernel", "name": name, "shape": list(shape), "rows": n,
                   "min_cos": min(r["cos"] for r in per_leaf.values()), "dx_share_within_3pct": dx_share,
                   "max_abs_err": max(r["max_abs_err"] for r in per_leaf.values()), "deterministic": True,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bytes": nbytes, "flop": flop, "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
                   "roofline_share": bound_ms / ms,
                   "leaves": {k: [round(r["cos"], 6), round(r["ratio"], 5)] for k, r in per_leaf.items()}}
            emit(row)
            rows[name][n] = row
            del xs, gs, got, want, graphs
            torch.cuda.empty_cache()
    return rows


def scatter_phase(dev, gen, model_cfg):
    """``scatter_add_rows`` against its plain version at the shapes the
    Instant-NGP step gives it; returns its rows by case."""
    from xrnerf_torch.models.embedders.hashenc import HashEncoding, _corner_weights
    from xrnerf_torch.ops.scatter_rows import scatter_add_rows, scatter_add_rows_plain

    n_pts = N_RAND * model_cfg["n_keep"]  # 262,144 field rows per step
    enc = HashEncoding(**{k: model_cfg[k] for k in ("n_levels", "n_features", "log2_table_size", "base_res", "max_res")}).to(dev)
    cases = {}

    def vertex_case(level):
        """Two input sets of the level's real corner indices and update rows."""
        sets = []
        for _ in range(2):
            idx, t = enc._corner_cells(torch.rand((n_pts, 3), generator=gen, device=dev))
            g = torch.randn((n_pts, enc.n_features), generator=gen, device=dev)
            vals = (_corner_weights(t[level:level + 1], dim=1)[0][..., None] * g[None]).reshape(8 * n_pts, -1)
            sets.append((idx[level].reshape(-1).clone(), vals.contiguous()))  # a copy: the other levels are freed
        return sets, min(enc.resolutions[level] ** 3, enc.table_size), False

    def brick_case():
        sets = []
        for _ in range(2):
            vals = torch.randn((n_pts, 8 * enc.n_features), generator=gen, device=dev)
            vals[torch.rand(n_pts, generator=gen, device=dev) < 0.7] = 0.0  # dead samples
            sets.append((torch.randint(0, enc.table_size // 8, (n_pts,), generator=gen, device=dev), vals))
        return sets, enc.table_size // 8, True

    def small_case():
        idx = torch.randint(0, 300, (1000,), generator=gen, device=dev)
        idx[torch.rand(1000, generator=gen, device=dev) < 0.2] = -1
        return [(idx, torch.randn((1000, 2), generator=gen, device=dev))] * 2, 300, False

    makers = {"vertex_hashed": lambda: vertex_case(enc.n_levels - 1), "vertex_dense_coarsest": lambda: vertex_case(0),
              "brick": brick_case, "small_negative_ids": small_case}
    for case, make in makers.items():
        sets, num_rows, skip = make()
        idx, vals = sets[0]
        got = scatter_add_rows(idx, vals, num_rows, skip_zero_rows=skip)
        want = scatter_add_rows_plain(idx, vals, num_rows, skip_zero_rows=skip)
        torch.cuda.synchronize()
        err = scatter_check(case, got, want)
        got32 = scatter_add_rows(idx.int(), vals, num_rows, skip_zero_rows=skip)  # the int32 entry point
        scatter_check(f"{case} int32", got32, want)
        turn = [0]

        def walk(f, **kw):
            def call():
                turn[0] += 1
                i, v = sets[turn[0] % 2]
                return f(i, v, num_rows, **kw)
            return call

        ms = time_ms(walk(scatter_add_rows, skip_zero_rows=skip), inner=20, head_start_ms=4.0)
        plain_ms = time_ms(walk(scatter_add_rows_plain, skip_zero_rows=skip), inner=4, head_start_ms=4.0)
        # the library call of the same function (ids >= 0; dropped rows go to a spare row)
        lib_sets = [(torch.where(i >= 0, i, num_rows), v) for i, v in sets]

        def library():
            turn[0] += 1
            i, v = lib_sets[turn[0] % 2]
            return torch.zeros((num_rows + 1, v.shape[1]), device=dev).index_add_(0, i, v)

        library_ms = time_ms(library, inner=4, head_start_ms=4.0)
        n, w = vals.shape
        nbytes = n * idx.element_size() + n * w * 4 + num_rows * w * 4
        bound_ms, bound_by = bound(n * w, nbytes)  # one addition per value
        kept = (idx >= 0) & ((vals != 0).any(-1) if skip else True)
        row = {"phase": "kernel", "name": "scatter_add_rows", "case": case, "rows": n, "width": w, "num_rows": num_rows,
               "skip_zero_rows": skip, "kept_share": float(kept.float().mean()), "max_abs_err": err,
               "largest_sum": float(want.abs().max()), "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
               "ns_per_row": ms * 1e6 / n, "roofline_share": bound_ms / ms}
        emit(row)
        cases[case] = row
        del sets, lib_sets, got, want, got32
        torch.cuda.empty_cache()
    return cases


class NGPSphereScene(OrbitCameras):
    """In-memory training data in ``HashNerfDataset``'s batch format
    (``rays_o``, ``rays_d`` in grid coordinates, ``target``, ``alpha``):
    ``N_rand`` random pixels per step over all 40 orbit cameras, coloured by
    :class:`SphereScene`'s analytic sphere. Only the chosen pixels' rays are
    made, so the host's part of a step stays small."""

    def __init__(self, n_rand, seed=SEED):
        from xrnerf_torch.datasets.rays import spherical_render_poses

        super().__init__()
        self.N_rand, self.seed = n_rand, seed
        self.poses = spherical_render_poses(40, phi=-30.0, radius=4.0).astype(np.float32)

    def train_batch(self, step, host_id=0, num_hosts=1):
        rng = np.random.RandomState(self.seed + step)
        n = self.N_rand
        cam = rng.randint(len(self.poses), size=n)
        pix = rng.randint(self.H * self.W, size=n)
        col, row = (pix % self.W).astype(np.float32), (pix // self.W).astype(np.float32)
        K = self.K
        dirs = np.stack([(col - K[0, 2]) / K[0, 0], -(row - K[1, 2]) / K[1, 1], -np.ones_like(col)], axis=-1)

        def world(poses):  # xrnerf_torch.datasets.rays.get_rays_np for the chosen pixels
            return (poses[cam, :3, 3].astype(np.float32),
                    np.einsum("nc,nrc->nr", dirs, poses[cam, :3, :3]).astype(np.float32))

        colour, hit = SphereScene.trace(*world(self.poses))
        o, d = world(self.poses_ngp)
        return {"rays_o": o, "rays_d": d, "target": colour, "alpha": hit[:, None].astype(np.float32)}


# kernel groups of an NGP training step's profile
NGP_STEP_GROUPS = {
    "tiny_mlp_fwd": ["tiny_mlp_fwd_kernel"], "tiny_mlp_bwd": ["tiny_mlp_bwd_kernel", "reduce_partials_kernel"],
    "scatter": ["scatter_rows_"], "gather": ["scatter_gather", "indexSelect", "vectorized_gather"],
    "sort": ["sort", "Sort", "radix", "Radix"], "index_add": ["indexAdd", "index_add", "indexFuncLarge", "indexFuncSmall"],
    "elementwise_long": lambda k: "elementwise" in k and any(t in k for t in ("<long", "long,", "long>")),
    "adam": ["multi_tensor_apply"]}


def ngp_counters():
    """The launch counters of the NGP path's kernels: ``scatter_add_rows`` is
    the scatter kernel as the encodings launch it (all levels at once);
    the one-level wrapper of the same kernel must not launch there."""
    from xrnerf_torch.ops import fused_mlp as fm
    from xrnerf_torch.ops import scatter_rows as sr

    return {"fused_mlp2_fwd": fm.fused_mlp2, "fused_mlp2_bwd": fm.fused_mlp2_bwd, "fused_mlp3_fwd": fm.fused_mlp3,
            "fused_mlp3_bwd": fm.fused_mlp3_bwd, "scatter_add_rows": sr.scatter_add_rows_levels,
            "scatter_add_rows_one_level": sr.scatter_add_rows}


def check_ngp_run(what, tr, rec, launches, steps, refreshes, scatters_per_step):
    """What every NGP training run must show: exact launch counts, finite
    logs, and the EMA copy's grid equal to the network's."""
    want = {"fused_mlp2_fwd": steps + refreshes, "fused_mlp2_bwd": steps, "fused_mlp3_fwd": steps,
            "fused_mlp3_bwd": steps, "scatter_add_rows": scatters_per_step * steps, "scatter_add_rows_one_level": 0}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    for w in rec.windows:
        if not all(math.isfinite(v) for v in w.values()):
            raise AssertionError(f"{what}: a logged value is not finite: {w}")
    if tr.ema_network is not None and not (
        torch.equal(tr.ema_network.grid_density, tr.network.grid_density)
        and torch.equal(tr.ema_network.grid_bitfield, tr.network.grid_bitfield)
    ):
        raise AssertionError(f"{what}: the EMA network's grid differs from the network's")


def ngp_train_phases(work_dir):
    """Instant-NGP training at full width through ``Trainer.run``; returns
    the launches of each kernel on that path."""
    from xrnerf_torch import build_network, load_config
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.utils import checkpoint as ckpt

    cfg = load_config(os.path.join(ROOT, "configs", "instant_ngp", "ngp_blender.py"), dataname="lego")
    model_cfg = dict(cfg["model"], fused=True)
    counters = ngp_counters()
    ds = NGPSphereScene(N_RAND)

    def trainer(cfg_model, max_iters, log_interval, hooks, **kw):
        return Trainer(build_network(cfg_model, device="cuda"), ds, optimizer=cfg["optimizer"], work_dir=work_dir,
                       max_iters=max_iters, log_interval=log_interval, ckpt_interval=NGP_TRAIN_STEPS, seed=SEED,
                       ema_decay=cfg["ema_decay"], eval_chunk=int(cfg["eval_chunk"]), hooks=hooks, device="cuda", **kw)

    def run(tr):
        for f in counters.values():
            f.launches = 0  # the main path starts here
        torch.cuda.synchronize()
        reached = tr.run()
        torch.cuda.synchronize()
        return reached, {k: f.launches for k, f in counters.items()}  # and ends here

    # 13. 64 steps at N_rand 4096: 262,144 field rows per step, equal to the budget
    torch.cuda.reset_peak_memory_stats()
    rec = WindowLog()
    tr = trainer(model_cfg, NGP_TRAIN_STEPS, NGP_TRAIN_LOG, [rec])
    untrained = float((tr.network.grid_density < 0).float().mean())
    reached, launches = run(tr)
    if reached != NGP_TRAIN_STEPS:
        raise AssertionError(f"NGP training stopped at step {reached}")
    check_ngp_run("ngp_train", tr, rec, launches, NGP_TRAIN_STEPS, NGP_TRAIN_STEPS // NGP_AUX_INTERVAL, 1)
    losses = [w["loss"] for w in rec.windows]
    if len(losses) != NGP_TRAIN_STEPS // NGP_TRAIN_LOG or not losses[-1] < losses[0]:
        raise AssertionError(f"NGP loss did not fall: windows {losses}")
    path = os.path.join(work_dir, f"ckpt_{NGP_TRAIN_STEPS}.pt")
    if ckpt.latest_path(work_dir) != path:
        raise AssertionError(f"no checkpoint at step {NGP_TRAIN_STEPS}: {ckpt.latest_path(work_dir)}")
    ms_step = float(np.median([w["ms_per_step"] for w in rec.windows[1:]]))
    n_rows = N_RAND * model_cfg["n_keep"]
    line = {"phase": "ngp_train", "config": "configs/instant_ngp/ngp_blender.py", "fused": True, "N_rand": N_RAND,
            "field_rows_per_step": n_rows, "steps": NGP_TRAIN_STEPS, "refreshes": NGP_TRAIN_STEPS // NGP_AUX_INTERVAL,
            "window_losses": losses, "window_psnr": [w["psnr"] for w in rec.windows],
            "window_ms_per_step": [w["ms_per_step"] for w in rec.windows], "ms_per_step": ms_step,
            "rays_per_s": N_RAND / (ms_step * 1e-3), "live_frac": [w["live_frac"] for w in rec.windows],
            "occupied_share": float(tr.network.grid_bitfield.float().mean()), "untrained_share": untrained,
            "launches": launches, "launches_per_step": {k: v / NGP_TRAIN_STEPS for k, v in launches.items()},
            "ema_grid_equal": True, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    resumed = trainer(model_cfg, NGP_TRAIN_STEPS + 2, NGP_TRAIN_LOG, [], resume_from=path)
    if resumed.start_step != NGP_TRAIN_STEPS or resumed.run() != NGP_TRAIN_STEPS + 2:
        raise AssertionError("NGP resume did not continue from the checkpoint to step 66")
    if not torch.equal(resumed.ema_network.grid_bitfield, resumed.network.grid_bitfield):
        raise AssertionError("resumed run: the EMA network's grid differs from the network's")
    line["resumed_to"] = NGP_TRAIN_STEPS + 2
    emit(line)
    del resumed

    # 8 more steps from the checkpoint at N_rand 16,384: 1,048,576 marched samples against a
    # budget of 262,144, so the compaction and its backward run
    ds.N_rand = NGP_COMPACT_RAND
    torch.cuda.reset_peak_memory_stats()
    crec = WindowLog()
    ctr = trainer(model_cfg, NGP_TRAIN_STEPS + NGP_COMPACT_STEPS, NGP_COMPACT_STEPS // 2, [crec], resume_from=path)
    ctr.ckpt_interval = 0  # no checkpoint of this run is read
    reached, claunches = run(ctr)
    if reached != NGP_TRAIN_STEPS + NGP_COMPACT_STEPS:
        raise AssertionError(f"compacted NGP training stopped at step {reached}")
    check_ngp_run("ngp_train_compacted", ctr, crec, claunches, NGP_COMPACT_STEPS, 1, 1)
    if not crec.windows[-1]["loss"] < losses[0]:
        raise AssertionError(f"compacted run: loss {crec.windows[-1]['loss']} not below the first window's {losses[0]}")
    cms = crec.windows[-1]["ms_per_step"]
    emit({"phase": "ngp_train_compacted", "N_rand": NGP_COMPACT_RAND, "marched_samples": NGP_COMPACT_RAND * model_cfg["n_keep"],
          "sample_budget": model_cfg["sample_budget"], "steps": NGP_COMPACT_STEPS, "from_step": NGP_TRAIN_STEPS,
          "window_losses": [w["loss"] for w in crec.windows], "live_frac": [w["live_frac"] for w in crec.windows],
          "window_ms_per_step": [w["ms_per_step"] for w in crec.windows], "ms_per_step": cms,
          "rays_per_s": NGP_COMPACT_RAND / (cms * 1e-3), "launches": claunches, "ema_grid_equal": True,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    ds.N_rand = N_RAND
    del ctr
    torch.cuda.empty_cache()

    # 14. gradients, card against CPU: the trained weights and grid, deterministic march
    sd = {k: v.detach().cpu() for k, v in tr.network.state_dict().items()}
    batch = NGPSphereScene(256, seed=SEED + 1000).train_batch(0)
    grads = {}
    for device in ("cuda", "cpu"):
        net = build_network(model_cfg, device=device)
        net.load_state_dict(sd)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        loss, _ = net.loss(net(b, generator=None, train=True), b)
        loss.backward()
        grads[device] = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
        grads[device + "_loss"] = loss.item()
        del net
    per_leaf = check_leaves("ngp_train_grads", grads["cuda"], grads["cpu"], NET_COS)
    emit({"phase": "ngp_train_grads", "rays": 256, "loss_card": grads["cuda_loss"], "loss_cpu": grads["cpu_loss"],
          "min_cos": min(r["cos"] for r in per_leaf.values()),
          "ratio_range": [min(r["ratio"] for r in per_leaf.values()), max(r["ratio"] for r in per_leaf.values())],
          "leaves": {k: [round(r["cos"], 6), round(r["ratio"], 5)] for k, r in per_leaf.items()}})
    del grads
    torch.cuda.empty_cache()

    # 15. one step by kernel group, after the main path's counts were read
    batch = tr._put_batch(ds.train_batch(10_000))
    prof = profile_device(lambda: tr.train_step(batch, 10_000), ms_step, "ngp_train_profile", NGP_STEP_GROUPS, top=12)
    prof["adam_step_ms"] = time_ms(tr.optimizer.step, reps=5)
    prof["ema_update_ms"] = time_ms(tr._update_ema, reps=5)
    prof["table_entries"] = tr.network.field.encoding.table.numel()
    n_syncs, inside = count_host_syncs(lambda: tr.train_step(batch, 10_001))
    prof["cudaStreamSynchronize_per_step"] = n_syncs
    prof["syncs_inside"] = inside
    emit(prof)
    if n_syncs != 0:
        raise AssertionError(f"{n_syncs} host syncs in one NGP training step: {inside}")
    step_scatter = capture_vertex_step(tr, batch, 10_002)  # for the scatter's vertex_step case
    del tr, batch
    torch.cuda.empty_cache()

    # 16. the brick layout, one lattice: the other call site of the scatter
    brick_cfg = dict(model_cfg, hash_layout="brick", n_lattices=1)
    brec = WindowLog()
    btr = trainer(brick_cfg, NGP_BRICK_STEPS, NGP_BRICK_STEPS // 2, [brec])
    btr.ckpt_interval = 0  # nor of this one
    reached, blaunches = run(btr)
    if reached != NGP_BRICK_STEPS:
        raise AssertionError(f"brick training stopped at step {reached}")
    check_ngp_run("ngp_brick_train", btr, brec, blaunches, NGP_BRICK_STEPS, 1, brick_cfg["n_lattices"])
    blosses = [w["loss"] for w in brec.windows]
    if not blosses[-1] < blosses[0]:
        raise AssertionError(f"brick loss did not fall: windows {blosses}")
    emit({"phase": "ngp_brick_train", "hash_layout": "brick", "n_lattices": 1, "N_rand": N_RAND, "steps": NGP_BRICK_STEPS,
          "table_shape": list(btr.network.field.encoding.table.shape), "window_losses": blosses,
          "window_ms_per_step": [w["ms_per_step"] for w in brec.windows],
          "scatter_launches_per_step": blaunches["scatter_add_rows"] / NGP_BRICK_STEPS,
          "scatter_shape": [n_rows, 8 * model_cfg["n_features"], btr.network.field.encoding.rows], "launches": blaunches})
    del btr
    torch.cuda.empty_cache()
    return {k: launches[k] + claunches[k] + blaunches[k] for k in launches}, step_scatter


def capture_vertex_step(tr, batch, step):
    """The ids, update rows, row counts and table rows that one training
    step of ``tr`` (vertex layout) hands the scatter, copied."""
    from xrnerf_torch.models.embedders import hashenc
    from xrnerf_torch.ops import scatter_rows as sr

    seen = []

    def record(idx, vals, rows, num_rows, *args, **kw):
        seen.append((idx.clone(), vals.clone(), list(rows), num_rows))
        return sr.scatter_add_rows_levels(idx, vals, rows, num_rows, *args, **kw)

    hashenc.scatter_add_rows_levels = record
    try:
        tr.train_step(batch, step)
    finally:
        hashenc.scatter_add_rows_levels = sr.scatter_add_rows_levels
    torch.cuda.synchronize()
    if len(seen) != 1:
        raise AssertionError(f"one training step called the scatter {len(seen)} times")
    return seen[0]


def scatter_check(case, got, want):
    """Max abs error of the kernel's sums against the plain version's; raises
    outside rtol 1e-4 plus 1e-4 of the largest sum."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"scatter {case}: non-finite kernel output")
    err = (got - want).abs()
    bar = SCATTER_RTOL * float(want.abs().max()) + SCATTER_RTOL * want.abs()
    if bool((err > bar).any()):
        raise AssertionError(f"scatter {case}: {int((err > bar).sum())} of {err.numel()} sums off; max abs err {float(err.max())}")
    return float(err.max())


def vertex_streams(dev, gen, model_cfg, idx, vals):
    """One training step's [L, M] ids and [L, M, W] update rows (march
    order), and the same shapes for random points: the vertex encoding's
    corners of M / 8 uniform points with random gradient rows."""
    from xrnerf_torch.models.embedders.hashenc import HashEncoding, _corner_weights

    L, M, W = vals.shape
    enc = HashEncoding(**{k: model_cfg[k] for k in ("n_levels", "n_features", "log2_table_size", "base_res", "max_res")}).to(dev)
    ridx, t = enc._corner_cells(torch.rand((M // 8, 3), generator=gen, device=dev))
    rg = torch.randn((L, M // 8, W), generator=gen, device=dev)
    return {"march": (idx, vals), "random": (ridx.reshape(L, M), (_corner_weights(t, dim=1)[..., None] * rg[:, None]).reshape(L, M, W))}


def vertex_step_phase(dev, gen, model_cfg, step):
    """``scatter_add_rows_levels`` on one real training step's 16 levels (the
    ids in march order) and on random points: one launch against its plain
    version, and 16 ``index_add_`` as the library call."""
    from xrnerf_torch.ops import scatter_rows as sr

    idx, vals, rows, T = step
    L, M, W = vals.shape
    streams = vertex_streams(dev, gen, model_cfg, idx, vals)
    row = {"phase": "kernel", "name": "scatter_add_rows", "case": "vertex_step", "levels": L, "rows": M, "width": W,
           "num_rows": T, "rows_per_level": rows, "modes": sr.level_modes(rows, W)}
    for label, (i, v) in streams.items():
        got = sr.scatter_add_rows_levels(i, v, rows, T)
        want = sr.scatter_add_rows_levels_plain(i, v, rows, T)
        torch.cuda.synchronize()
        err = scatter_check(f"vertex_step {label}", got, want)
        scatter_check(f"vertex_step {label} int32", sr.scatter_add_rows_levels(i.int(), v, rows, T), want)
        ms = time_ms(lambda: sr.scatter_add_rows_levels(i, v, rows, T), inner=10, head_start_ms=4.0)
        if label == "march":
            lib_idx = [torch.where((i[lvl] >= 0) & (i[lvl] < rows[lvl]), i[lvl], rows[lvl]) for lvl in range(L)]

            def library():
                return [torch.zeros((rows[lvl] + 1, W), device=dev).index_add_(0, lib_idx[lvl], v[lvl]) for lvl in range(L)]

            nbytes = L * (M * i.element_size() + M * W * 4 + T * W * 4)
            bound_ms, bound_by = bound(L * M * W, nbytes)
            row.update({"max_abs_err": err, "largest_sum": float(want.abs().max()), "ms": ms,
                        "plain_ms": time_ms(lambda: sr.scatter_add_rows_levels_plain(i, v, rows, T), inner=2, head_start_ms=4.0),
                        "library_ms": time_ms(library, inner=2, head_start_ms=4.0), "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": nbytes, "roofline_share": bound_ms / ms})
            del lib_idx
        else:
            row.update({"random_points": {"max_abs_err": err, "ms": ms}})
        del got, want
    emit(row)
    del streams
    torch.cuda.empty_cache()
    return row


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
    from xrnerf_torch.ops.fused_nerf_mlp import fused_nerf_mlp_fwd, pack_params
    from xrnerf_torch.utils.metrics import psnr
    from xrnerf_torch.utils.weights import state_dict_from_jax

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
    names = ["fused_nerf_mlp_fwd", "fused_nerf_mlp_bwd", "fused_mlp_fwd", "fused_mlp_bwd", "scatter_rows"]
    build.load_libraries(names)
    ptxas = {}
    for name in names:
        log = build.lib_path(name).with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in (log.read_text() if log.exists() else "").splitlines()
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    from xrnerf_torch.ops import fused_nerf_mlp as nerf_ops
    from xrnerf_torch.ops import fused_mlp as tiny_ops
    from xrnerf_torch.ops import scatter_rows as scatter_ops

    fwd_lib, bwd_lib = (nerf_ops._kernel_lib(name) for name in names[:2])
    tiny_bwd_lib = tiny_ops._kernel_lib("bwd")
    emit({"phase": "build", "kernels": names, "seconds": time.perf_counter() - t0, "ptxas": ptxas,
          "dynamic_smem_bytes": {"fused_nerf_mlp_fwd_kernel": fwd_lib.xr_fused_nerf_mlp_fwd_smem_bytes(),
                                 "fused_nerf_mlp_bwd_rows": bwd_lib.xr_fused_nerf_mlp_bwd_rows_smem_bytes(),
                                 "fused_nerf_mlp_bwd_wgrad": bwd_lib.xr_fused_nerf_mlp_bwd_wgrad_smem_bytes()},
          "tiny_mlp_bwd_smem_bytes": {"fused_mlp2_bwd": tiny_bwd_lib.xr_fused_mlp2_bwd_smem_bytes(),
                                      "fused_mlp3_bwd": tiny_bwd_lib.xr_fused_mlp3_bwd_smem_bytes()},
          "scatter_vector_reductions": bool(scatter_ops._kernel_lib().xr_scatter_add_rows_vectorised())})

    # 3. kernel against its plain version
    rng = np.random.RandomState(SEED)
    mlp_sd = {k: torch.from_numpy(v).to(dev) for k, v in
              state_dict_from_jax(seeded_mlp_tree(rng)).items()}
    packed = pack_params(mlp_sd, 63, 27)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernel_rows = fwd_kernel_phase(dev, packed, gen)
    bwd_rows = bwd_kernel_phase(dev, packed, gen)

    # 4. the slice: full-width vanilla NeRF renders an 800x800 novel view
    cfg = load_config(os.path.join(ROOT, "configs", "nerf", "nerf_blender.py"), dataname="lego")
    model_cfg = dict(cfg["model"], fused=True)
    chunk = int(cfg["eval_chunk"])
    net_sd = state_dict_from_jax(
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

    # 8. the tiny-MLP kernels against their plain versions
    tiny_rows = tiny_mlp_phase(dev, gen)

    # 9, 10. Instant-NGP serving at full width
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_ngp_")
    try:
        ngp_launches = ngp_phases(work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    # 11, 12. the backward kernels of the tiny MLPs and the scatter against their plain versions
    tiny_bwd_rows = tiny_mlp_bwd_phase(dev, gen)
    ngp_model = load_config(os.path.join(ROOT, "configs", "instant_ngp", "ngp_blender.py"), dataname="lego")["model"]
    scatter_rows = scatter_phase(dev, gen, ngp_model)

    # 13-16. Instant-NGP training at full width
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_ngp_train_")
    try:
        ngp_train_launches, step_scatter = ngp_train_phases(work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    scatter_rows["vertex_step"] = vertex_step_phase(dev, gen, ngp_model, step_scatter)
    del step_scatter

    # 17. kernels
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
        *({"name": name, "route": "cuda", "source": f"xrnerf_torch/csrc/fused_mlp_{name[-3:]}.cu",
           "replaces": f"xrnerf_tpu/ops/pallas/fused_mlp.py:{line}",
           "launches": ngp_launches.get(name, 0) + ngp_train_launches[name],
           "max_abs_err": max(r["max_abs_err"] for r in rows[name].values()),
           **{k: rows[name][262_144][k] for k in keys}}
          for name, line, rows in (("fused_mlp2_fwd", 64, tiny_rows), ("fused_mlp2_bwd", 77, tiny_bwd_rows),
                                   ("fused_mlp3_fwd", 184, tiny_rows), ("fused_mlp3_bwd", 202, tiny_bwd_rows))),
        {"name": "scatter_add_rows", "route": "cuda", "source": "xrnerf_torch/csrc/scatter_rows.cu",
         "replaces": "xrnerf_tpu/ops/pallas/scatter_rows.py:62", "launches": ngp_train_launches["scatter_add_rows"],
         "max_abs_err": max(r["max_abs_err"] for r in scatter_rows.values()),
         **{k: scatter_rows["vertex_step"][k] for k in keys}, "levels": scatter_rows["vertex_step"]["levels"],
         "other_shapes": {c: {k: r[k] for k in ("rows", "width", "num_rows", "ms", "plain_ms", "bound_ms", "library_ms")}
                          for c, r in scatter_rows.items() if c != "vertex_step"}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
