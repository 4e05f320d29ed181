#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``xrnerf_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device  - the card's name and power limit (``nvidia-smi``); the flags
             of ``utils/device.py:configure_card`` (TF32 off, cuDNN's
             search on), checked again at the end.
2. build   - the CUDA kernels ``xrnerf_torch/csrc/fused_nerf_mlp_fwd.cu``,
             ``fused_nerf_mlp_bwd.cu``, ``fused_mlp_fwd.cu``,
             ``fused_mlp_bwd.cu`` and ``scatter_rows.cu``, one nvcc each,
             started together; ptxas registers and spills; the dynamic
             shared memory of each ``wgmma`` kernel (the two vanilla-NeRF
             kernels, the colour net's forward, the tiny-MLP backwards).
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
             (one grid refresh) and 262,144 (one render chunk), the colour
             net also at 127, 128, 129 (a ragged, a full and a one-over
             tile) and 262,144 + 37 (a ragged last tile after many
             grid-stride turns), rtol 2e-2 / atol 8e-3, the same bits on a
             second launch; kernel, plain-version and bf16
             ``F.linear``-chain times by CUDA events over a run of calls that
             walk four input buffers (so each finds the L2 cold), queued
             behind a spin kernel so that the host's launch rate does not
             enter.
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
17. mip_train - Mip-NeRF from ``configs/mipnerf/mipnerf_multiscale.py`` at
             full width (2 levels x 128 samples, IPE degrees 0-16, one shared
             8x256 f32 MLP: the JAX network runs it unfused, so this path
             launches none of the hand-written kernels) under the config's
             optimizer as written (Adam 5e-4 log-lerped to 5e-6, warmup 2500
             with delay 0.01, ``grad_clip`` 1e-3): ``Trainer.run`` for 40
             steps at ``N_rand`` 4096 on ``MipSphereScene`` (the lego camera
             and analytic sphere at 800, 400, 200 and 100 px, rays drawn
             across scales in proportion to their pixel counts, each with its
             ``radii`` and ``lossmult = 4^s``, a scale-s target the mean of its
             2^s x 2^s full-resolution sub-pixels), windows of 10, a
             checkpoint, ``resume_from`` to step 42: finite losses, the
             parameters move in every window, 0 launches of the seven
             kernels; ms/step, rays/s, MLP TFLOP/s (1,220,608 flop per row
             forward, 3x per step), the lr of each window.
18. mip_train_grads - 256 rays on the deterministic path (no generator):
             the card's gradients against the CPU's, same weights, per leaf
             cosine > 0.97 and norm ratio 0.93-1.07.
19. mip_train_profile - one step under torch.profiler (device busy, idle
             share, top ops by group) and the host syncs in a step (must
             be 0).
20. mip_slice - the trained weights go through a ``.pt`` into a second
             Trainer (``load_from``), which renders at ``eval_chunk`` 16384 one
             800x800 view (scale 0) and one 100x100 view (scale 3), each a
             warm-up and two timed frames: finite outputs, peak memory, 0
             kernel launches, and a 32x32 crop of the 800x800 view
             re-rendered on the CPU must agree at >= 40 dB; then a frame
             under torch.profiler (``mip_profile``).
21. kilo_occupancy - KiloNeRF at the full width of
             ``configs/kilonerf/kilonerf_finetune.py`` and ``kilonerf_distill.py``
             on ``KiloSphereScene`` (the lego camera, a sphere of radius 0.5
             inside the domain +-0.7, coloured by its normal over white; its
             256^3 grid made analytically): the teacher is phase 6's fused
             network, and ``build_occupancy_grid`` sweeps 256^3 x 3^3 points
             through it (row 1, at least one launch per plane); one slab of
             cells against the plain version of row 1, which may differ only
             within 1 % of the threshold (at the config's threshold and at
             the slab's median density); one slab by kernel group.
22. kilo_distill - two cycles of the kd-tree ``DistillDriver`` with the
             config's ``tree`` dict (the second in a new driver that reads the
             first's checkpoint): ms per cycle, teacher rows, row 1's launches,
             per-network error quantiles; a first cycle cut to 10 Adam steps by
             kernel group; then ``assemble_grid((16, 16, 16))``, and a hand-off
             cycle (10 Adam steps, ``max_error`` 1e9: every root fits).
23. kilo_train - ``KiloNerfNetwork`` (pooled march, 4096 networks) seeded
             from the hand-off cycle's assembled grid (rows checked against
             their leaves), the config's
             Adam with ``param_loss``, the analytic grid as aux: 40 steps at
             ``N_rand`` 1024, a checkpoint and a resume to 42, 0 launches of the
             seven kernels, the share of points the capacity rule dropped;
             ``kilo_train_grads`` (card vs CPU, 256 rays, no jitter, cosine >
             0.999) and ``kilo_train_profile`` (by group, host syncs).
24. kilo_slice - the weights and grid through a ``.pt`` into a second
             Trainer: an 800x800 frame at ``eval_chunk`` 8192 (no budget
             compaction: 262,144 slots), one 32,768-ray chunk (1,048,576 slots:
             compacted to the budget), the frame culled by
             ``kilonerf_strip_active`` (strip 8, 64 probes), one chunk through
             the dense and sphere marches; the crop and the budget chunk against
             the CPU path on the same chunks, and 32x32 rays over the sphere's
             disc at a capacity that holds them, without and with the budget
             compaction, and the same pixels of a frame at such a capacity
             (>= 40 dB on rgb and acc, the CPU side with content); the culled
             frame equal to the unculled one where no network is over capacity.
25. kilo_profile - the frame by kernel group; the culled frame and the budget
             chunk likewise (``kilo_culled_profile``, ``kilo_budget_chunk_profile``).
26. bungee - BungeeNeRF at the full width of
             ``configs/bungeenerf/bungee_multiscale.py`` (4 stages, 64 + 64
             samples, IPE 0-10, width 256, the config's Adam, ``N_rand`` 1024)
             on ``BungeeSphereScene`` (the lego camera and analytic sphere from
             10 orbit poses at each of 4 distances; scale code = distance
             bucket, far 0): ``iters_per_stage`` cut to 5, so 20 steps cross
             the 4 stages; a resume to 22; gradients card vs CPU on 256 rays
             (per leaf cosine > 0.999, norm ratio 0.999-1.001, f32 both sides);
             a profiled step (by group, host syncs); a 100x100 warm-up frame,
             then an 800x800 frame at stage 3 and its 32x32 centre against the
             CPU (>= 40 dB on rgb and acc, CPU mean(acc^2) >= 1e-3).
27. neuralbody - ``configs/neuralbody/nb_zjumocap.py``'s model at full width
             (6890 x 16 codes, 96^3 grid, 4 x 32 conv widths, hidden 256, 64
             samples; f32 cuDNN ``Conv3d``) on ``make_synthetic_zju(n_frames=2,
             n_cams=4, H=512, W=512, n_verts=6890)`` with the config's
             dataset: 20 steps, a resume to 22, gradients, a profiled step, a
             512x512 frame at ``eval_chunk`` 4096 (profiled) and its crop
             against the CPU, the same bars.
28. aninerf - ``configs/aninerf/aninerf_zjumocap_train_pose.py``'s model on
             the same arrays plus 24 joints on SMPL's tree (``ani_arrays``):
             the same measurements, the knn alone at a step's and a chunk's
             points, then ``aninerf_zjumocap_novel_pose.py`` from the
             ``train_pose`` checkpoint (``load_from``) for 10 steps: only
             ``novel_pose_bw_mlp.*`` moves, every other leaf bit for bit.
             Each of 26-28 prints one line, with 0 launches of the seven
             kernels (their counters zeroed before the path and read after).
30. gnr    - ``configs/gnr/gnr_genebody.py``'s model at full width (4 source
             views, 4 hourglass stacks of 256, 256 samples, the 8x256 MLP
             with skips 2, 4, 6, attention, SMPL SDF, T-pose, SMPL depth,
             visual hull; ``N_rand`` 1024) on ``gnr_arrays()``:
             ``make_synthetic_genebody`` with 48 cameras at 512x512 and its
             sphere made a closed latitude-longitude mesh with SMPL's 6,890
             vertices and 13,776 triangles, so the brute-force SMPL queries
             pay what a real capture pays. 20 steps and a resume to 22
             (finite losses, moving parameters); a profiled step by group
             (the mesh tile, GroupNorm, conv, SGEMM, grid sampling, the rest)
             and its host syncs; ``nearest_points`` and ``inside_mesh``
             alone at the step's 262,144 points; gradients card vs CPU on 64
             rays (per leaf cosine > 0.999, norm ratio 0.999-1.001, no
             gradient for the encoder's leaves on either side, the near-tie
             points counted); the central 128x128 window of a held-out view
             (16 chunks of 1,024 rays; the full frame's time derived as 256
             chunks) and its 16x16 centre against the CPU (>= 40 dB on rgb
             and acc); ``reconstruct_gnr`` at ``n_grid`` 64 with 3 smoothing
             passes (seconds, vertices, faces, radial error against the
             sphere). 0 launches of the seven kernels across the phase.
31. multi  - ``xrnerf_torch.parallel`` at the full widths of vanilla NeRF
             (fused, ``N_rand`` 4096 global), Instant-NGP (fused, ``N_rand``
             16,384 global, so the sample budget binds) and KiloNeRF (4096
             networks, ``N_rand`` 1024 global): a one-rank NCCL group through
             ``init_distributed`` trains vanilla NeRF with a mesh; then two
             worker processes (``python3 chip_smoke.py --multi-worker ...``)
             share ``cuda:0`` over gloo (``"backend"``, ``"ranks_per_card"``):
             4 data-parallel steps of each configuration against the one-rank
             run (losses at 1e-5 relative, first-step gradients per leaf
             cosine > 0.999 and norm ratio 0.999-1.001, f32 all-reduce),
             KiloNeRF's capacity mask and Instant-NGP's budget mask bit for
             bit, one n_model 2 step of Instant-NGP and KiloNeRF (the table and
             the expert stacks cut in two; the table's gradient through row 7's
             slice scatter), an 800x800 vanilla frame split over the ranks
             against the one-rank frame (>= 40 dB), launches per rank of the
             seven counters; row 7's slice scatter against the full-table
             launch (``SCATTER_RTOL``); all-reduce bytes per step; ms/step of
             two ranks sharing one card (not a scaling figure). With two or
             more cards, also NCCL with one rank per card: the same checks
             (and, for an even count, the n_model 2 step), untimed.
32. kernels - one line ``{"kernels": [...]}`` per the port's kernel table.
             A line before it gives the script's total seconds.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises and the script exits non-zero; without a CUDA card it exits 2.
"""

from __future__ import annotations

import bisect
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
# the colour net's forward also at a ragged, a full and a one-over tile and a ragged last tile after many turns
TINY_FWD_ROWS = {"fused_mlp2_fwd": TINY_ROWS, "fused_mlp3_fwd": (127, 128, 129) + TINY_ROWS + (262_144 + 37,)}
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
H100_FP32_FLOPS = 67e12  # FP32 (no tensor cores) peak, H100 SXM data sheet: the Mip-NeRF MLP runs f32, TF32 off
MIP_MACS_PER_ROW = 96 * 256 + 4 * 256 * 256 + 352 * 256 + 2 * 256 * 256 + 256 * 257 + 283 * 128 + 128 * 3
MIP_FLOP_PER_ROW = 2 * MIP_MACS_PER_ROW  # 1,220,608: IPE 96 in, view encoding 27
MIP_STEPS, MIP_LOG = 40, 10
MIP_SCALES = 4


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


def distinct_draws(rng, n, population):
    """``n`` distinct ints below ``population`` in draw order: a few more
    than ``n`` drawn, repeats dropped (one sort), more drawn if too few are
    left."""
    extra = n // 32
    pix = rng.randint(population, size=n + extra)
    while True:
        order = np.argsort(pix)
        fresh = np.ones(len(pix), bool)
        fresh[1:] = pix[order[1:]] != pix[order[:-1]]
        keep = np.sort(order[fresh])
        if len(keep) >= n:
            break
        pix = np.concatenate([pix, rng.randint(population, size=extra)])
    return pix[keep[:n]]


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
        pix = distinct_draws(rng, self.N_rand, self.H * self.W)
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


def tiny_mlp_phase(dev, gen, row_counts=TINY_FWD_ROWS):
    """The tiny-MLP forward kernels named in ``row_counts`` against their
    plain versions at its row counts; returns their rows by kernel name and N."""
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
        if name not in row_counts:
            continue
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
            for n in row_counts[name]:
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
                if not torch.equal(fn(xs[0], *params), got):
                    raise AssertionError(f"{name} N={n}: a second launch gave other bits")
                lib_err = float((library(xs[0]) - want).abs().max())
                # microsecond kernels: give the host a head start (see time_ms)
                ms = time_ms(walk(fn), inner=20, head_start_ms=4.0)
                plain_ms = time_ms(walk(plain), inner=4, head_start_ms=4.0)
                library_ms = time_ms(walk(library), inner=4, head_start_ms=4.0)
                flop = 2 * n * sum(i * o for i, o in zip(shape[:-1], shape[1:]))
                nbytes = 4 * (n * (shape[0] + shape[-1]) + sum(p.numel() for p in params))
                bound_ms = max(flop / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S) * 1e3
                row = {"phase": "kernel", "name": name, "shape": list(shape), "rows": n, "max_abs_err": err,
                       "deterministic": True, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "library_max_abs_err": lib_err,
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
    groups = {"tiny_mlp": ["tiny_mlp_fwd_kernel", "tiny_mlp3_fwd_kernel"], "gather": ["scatter_gather", "indexSelect", "vectorized_gather"],
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
    "tiny_mlp_fwd": ["tiny_mlp_fwd_kernel", "tiny_mlp3_fwd_kernel"], "tiny_mlp_bwd": ["tiny_mlp_bwd_kernel", "reduce_partials_kernel"],
    "scatter": ["scatter_rows_"], "gather": ["scatter_gather", "indexSelect", "vectorized_gather"],
    "sort": ["sort", "Sort", "radix", "Radix"], "index_add": ["indexAdd", "index_add", "indexFuncLarge", "indexFuncSmall"],
    "elementwise_long": lambda k: "elementwise" in k and any(t in k for t in ("<long", "long,", "long>")),
    "adam": ["multi_tensor_apply"]}


def kernel_counters():
    """The launch counters of all seven kernels' wrappers."""
    return {**ngp_counters(), **nerf_counters()}


def launched_any(counters):
    """The counters of ``counters`` that counted a launch."""
    return {k: f.launches for k, f in counters.items() if f.launches}


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


class MipSphereScene:
    """In-memory training data in ``MipMultiScaleDataset``'s batch format
    (``rays_o``, ``rays_d``, ``radii``, ``lossmult``, ``near``, ``far``,
    ``target``): :class:`SphereScene`'s lego camera and analytic sphere on the
    40 orbit poses at 800, 400, 200 and 100 px. Each step draws ``N_rand``
    distinct (camera, scale, pixel) entries of the 40 x 850,000 a pool of
    every camera at every scale holds, so scales come in proportion to their
    pixel counts, as the pool's permutation gives them. Only the chosen
    pixels' rays are made: a ray's ``radii`` is ``get_ray_radii`` of its
    pixel and its row neighbour, ``lossmult`` is 4^s, and a scale-s target is
    the mean colour of its 2^s x 2^s full-resolution sub-pixels (what
    ``area_resize`` makes of the full-resolution image)."""

    def __init__(self, n_rand, near=2.0, far=6.0, seed=SEED):
        from xrnerf_torch.datasets.rays import intrinsics_from_hwf, spherical_render_poses

        self.N_rand, self.near, self.far, self.seed = n_rand, near, far, seed
        self.H = self.W = 800
        self.focal = 0.5 * self.W / math.tan(0.5 * 0.6911112070083618)  # lego camera_angle_x
        self.poses = spherical_render_poses(40, phi=-30.0, radius=4.0).astype(np.float32)
        self.Ks = [intrinsics_from_hwf(self.H >> s, self.W >> s, self.focal / 2**s) for s in range(MIP_SCALES)]
        counts = [(self.H >> s) * (self.W >> s) for s in range(MIP_SCALES)]
        self.offsets = np.cumsum([0] + counts)  # a camera's entries, scale-major

    def _dirs(self, cam, s, row, col):
        """World ray directions of scale-``s`` pixels (``get_rays_np``'s
        arithmetic for the given pixels)."""
        K = self.Ks[s]
        d = np.stack([(col - K[0, 2]) / K[0, 0], -(row - K[1, 2]) / K[1, 1], -np.ones_like(col)], axis=-1)
        return np.einsum("nc,nrc->nr", d.astype(np.float32), self.poses[cam, :3, :3]).astype(np.float32)

    def train_batch(self, step, host_id=0, num_hosts=1):
        from xrnerf_torch.datasets.rays import get_ray_radii

        rng = np.random.RandomState(self.seed + step)
        n = self.N_rand
        flat = distinct_draws(rng, n, len(self.poses) * int(self.offsets[-1]))
        cam, entry = flat // int(self.offsets[-1]), flat % int(self.offsets[-1])
        scale = np.searchsorted(self.offsets, entry, side="right") - 1
        o = self.poses[cam, :3, 3].astype(np.float32)
        d = np.empty((n, 3), np.float32)
        radii = np.empty((n, 1), np.float32)
        target = np.empty((n, 3), np.float32)
        for s in range(MIP_SCALES):
            sel = np.nonzero(scale == s)[0]
            if not len(sel):
                continue
            w_s = self.W >> s
            pix = entry[sel] - self.offsets[s]
            row, col = (pix // w_s).astype(np.float32), (pix % w_s).astype(np.float32)
            d[sel] = self._dirs(cam[sel], s, row, col)
            left = np.minimum(col, w_s - 2)
            pair = np.stack([self._dirs(cam[sel], s, row, left), self._dirs(cam[sel], s, row, left + 1)], 1)
            radii[sel] = get_ray_radii(pair)[:, 0]
            f = 2**s  # the full-resolution sub-pixels' rays, traced, averaged
            sub = np.arange(f, dtype=np.float32)
            rows = (row[:, None, None] * f + sub[None, :, None]).repeat(f, 2).reshape(-1)
            cols = (col[:, None, None] * f + sub[None, None, :]).repeat(f, 1).reshape(-1)
            cams = np.repeat(cam[sel], f * f)
            colour = SphereScene.colour(self.poses[cams, :3, 3], self._dirs(cams, 0, rows, cols))
            target[sel] = colour.reshape(len(sel), f * f, 3).mean(1)
        return {"rays_o": o, "rays_d": d, "radii": radii, "lossmult": (4.0 ** scale)[:, None].astype(np.float32),
                "near": np.full((n, 1), self.near, np.float32), "far": np.full((n, 1), self.far, np.float32),
                "target": target}

    def image_rays(self, pose, s):
        """Full-image rays of ``pose`` at scale ``s`` (``MipMultiScaleDataset``'s
        eval item without its target)."""
        from xrnerf_torch.datasets.rays import get_ray_radii, get_rays_np

        H, W = self.H >> s, self.W >> s
        o, d = get_rays_np(H, W, self.Ks[s], pose)
        n = H * W
        return {"rays_o": o.reshape(-1, 3), "rays_d": d.reshape(-1, 3), "radii": get_ray_radii(d).reshape(-1, 1),
                "near": np.full((n, 1), self.near, np.float32), "far": np.full((n, 1), self.far, np.float32)}, (H, W)


class MipWindowLog(WindowLog):
    """Each logging window's ``last_logs``, the learning rate the window ended
    on, and the largest parameter change since the window before."""

    def on_run_begin(self, tr):
        self._last = [p.detach().clone() for p in tr.network.parameters()]

    def after_step(self, tr, step, logs):
        if step % tr.log_interval == 0:
            with torch.no_grad():
                moved = max(float((p - q).abs().max()) for p, q in zip(tr.network.parameters(), self._last))
                self._last = [p.detach().clone() for p in tr.network.parameters()]
            self.windows.append(dict(tr.last_logs, step=step, lr=tr.optimizer.param_groups[0]["lr"], moved=moved))


# kernel groups of a Mip-NeRF step's and frame's profiles
MIP_GROUPS = {"gemm": ["gemm", "Gemm", "sm90_xmma", "cutlass", "ampere_", "sm80_"],
              "adam": ["multi_tensor_apply"], "searchsorted": ["searchsorted"], "scan": ["scan", "Scan", "cumsum"],
              "cat": ["CatArrayBatchedCopy", "cat_"], "reduce": ["reduce_kernel"]}


def mip_phases(work_dir):
    """Mip-NeRF at full width on the card: training through ``Trainer.run``,
    card-vs-CPU gradients, a profiled step, then frames at two scales
    through a Trainer built from a weights file."""
    from xrnerf_torch import build_network, load_config
    from xrnerf_torch.core.renderer import render_image
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.utils import checkpoint as ckpt
    from xrnerf_torch.utils.metrics import psnr

    cfg = load_config(os.path.join(ROOT, "configs", "mipnerf", "mipnerf_multiscale.py"), dataname="lego")
    model_cfg = dict(cfg["model"])
    counters = kernel_counters()
    ds = MipSphereScene(N_RAND)

    # the schedule a run of the config follows: its log-lerp spans the config's max_iters, not these 40 steps
    optimizer = dict(cfg["optimizer"], max_steps=cfg["max_iters"])

    def trainer(max_iters, hooks, **kw):
        return Trainer(build_network(model_cfg, device="cuda"), ds, optimizer=optimizer, work_dir=work_dir,
                       max_iters=max_iters, log_interval=MIP_LOG, ckpt_interval=MIP_STEPS, seed=SEED,
                       eval_chunk=int(cfg["eval_chunk"]), hooks=hooks, device="cuda", **kw)

    # 17. training
    torch.cuda.reset_peak_memory_stats()
    rec = MipWindowLog()
    tr = trainer(MIP_STEPS, [rec])
    for f in counters.values():
        f.launches = 0  # the main path starts here
    reached = tr.run()
    torch.cuda.synchronize()
    if launched_any(counters):  # and ends here
        raise AssertionError(f"the Mip-NeRF path launched hand-written kernels: {launched_any(counters)}")
    if reached != MIP_STEPS:
        raise AssertionError(f"Mip-NeRF training stopped at step {reached}")
    losses = [w["loss"] for w in rec.windows]
    if len(losses) != MIP_STEPS // MIP_LOG or not all(math.isfinite(v) for w in rec.windows for v in w.values()):
        raise AssertionError(f"Mip-NeRF windows {rec.windows}")
    if not all(w["moved"] > 0 for w in rec.windows):
        raise AssertionError(f"Mip-NeRF parameters did not move in a window: {[w['moved'] for w in rec.windows]}")
    path = ckpt.latest_path(work_dir)
    if path is None or not path.endswith(f"ckpt_{MIP_STEPS}.pt"):
        raise AssertionError(f"no Mip-NeRF checkpoint at step {MIP_STEPS}: {path}")
    resumed = trainer(MIP_STEPS + 2, [], resume_from=path)
    if resumed.start_step != MIP_STEPS or resumed.run() != MIP_STEPS + 2:
        raise AssertionError("Mip-NeRF resume did not continue from the checkpoint to step 42")
    del resumed
    ms_step = float(np.median([w["ms_per_step"] for w in rec.windows[1:]]))
    batch_ms = []
    for step in range(20):
        t0 = time.perf_counter()
        ds.train_batch(step)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    rows = N_RAND * model_cfg["num_levels"] * model_cfg["n_samples"]
    floor_ms = 3 * MIP_FLOP_PER_ROW * rows / H100_FP32_FLOPS * 1e3  # forward 1x + backward 2x
    emit({"phase": "mip_train", "config": "configs/mipnerf/mipnerf_multiscale.py", "fused": False, "N_rand": N_RAND,
          "steps": MIP_STEPS, "resumed_to": MIP_STEPS + 2, "window_losses": losses,
          "window_psnr": [w["psnr"] for w in rec.windows], "window_lr": [w["lr"] for w in rec.windows],
          "window_max_param_change": [w["moved"] for w in rec.windows],
          "window_ms_per_step": [w["ms_per_step"] for w in rec.windows], "ms_per_step": ms_step,
          "rays_per_s": N_RAND / (ms_step * 1e-3), "mlp_rows_per_step": rows,
          "mlp_tflops": 3 * MIP_FLOP_PER_ROW * rows / (ms_step * 1e-3) / 1e12, "mlp_floor_ms": floor_ms,
          "mlp_floor_share": floor_ms / ms_step, "batch_host_ms": float(np.median(batch_ms)),
          "kernel_launches": 0, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    # 18. gradients, card against CPU: the trained weights, the deterministic path
    sd = {k: v.detach().cpu() for k, v in tr.network.state_dict().items()}
    batch = MipSphereScene(256, seed=SEED + 1000).train_batch(0)
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
    per_leaf = check_leaves("mip_train_grads", grads["cuda"], grads["cpu"], NET_COS)
    emit({"phase": "mip_train_grads", "rays": 256, "loss_card": grads["cuda_loss"], "loss_cpu": grads["cpu_loss"],
          "min_cos": min(r["cos"] for r in per_leaf.values()),
          "ratio_range": [min(r["ratio"] for r in per_leaf.values()), max(r["ratio"] for r in per_leaf.values())]})
    del grads

    # 19. one step by kernel group, and the host syncs of a step
    tb = tr._put_batch(ds.train_batch(10_000))
    prof = profile_device(lambda: tr.train_step(tb, 10_000), ms_step, "mip_train_profile", MIP_GROUPS, top=12)
    n_syncs, inside = count_host_syncs(lambda: tr.train_step(tb, 10_001))
    prof.update(cudaStreamSynchronize_per_step=n_syncs, syncs_inside=inside)
    emit(prof)
    if n_syncs != 0:
        raise AssertionError(f"{n_syncs} host syncs in one Mip-NeRF training step: {inside}")
    del tr, tb
    torch.cuda.empty_cache()

    # 20. serving: the weights through a file into a second Trainer, frames at scales 0 and 3
    pt = os.path.join(work_dir, "mip_weights.pt")
    torch.save(sd, pt)
    torch.cuda.reset_peak_memory_stats()
    srv = Trainer(build_network(model_cfg, device="cuda"), ds, work_dir=None, eval_chunk=int(cfg["eval_chunk"]),
                  seed=SEED + 1, load_from=pt, device="cuda")
    pose = ds.poses[8]
    views, frames = {}, {}
    for f in counters.values():
        f.launches = 0  # the main path starts here
    for s in (0, 3):
        rays, (H, W) = ds.image_rays(pose, s)
        frame_ms = []
        for i in range(3):  # one warm-up frame, two timed
            t0 = time.perf_counter()
            out = srv.render_image(rays, H, W)
            torch.cuda.synchronize()
            if i:
                frame_ms.append((time.perf_counter() - t0) * 1e3)
        if sorted(out) != ["acc", "rgb"]:
            raise AssertionError(f"Mip-NeRF render returned {sorted(out)}")
        for k, v in out.items():
            if v.shape[:2] != (H, W) or not np.isfinite(v).all():
                raise AssertionError(f"mip scale {s} {k}: shape {v.shape} or non-finite values")
        views[s], frames[s] = (rays, out), frame_ms
    if launched_any(counters):  # the main path ends here
        raise AssertionError(f"Mip-NeRF frames launched hand-written kernels: {launched_any(counters)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (rays, out), H = views[0], ds.H
    cpu_net = build_network(model_cfg, device="cpu")
    cpu_net.load_state_dict(torch.load(pt, map_location="cpu", weights_only=True))
    ys = slice(H // 2 - 16, H // 2 + 16)
    crop = {k: v.reshape(H, H, -1)[ys, ys].reshape(-1, v.shape[-1]) for k, v in rays.items()}
    t0 = time.perf_counter()
    cpu_out = render_image(cpu_net, crop, 32, 32, chunk=int(cfg["eval_chunk"]))
    cpu_s = time.perf_counter() - t0
    crop_psnr = float(psnr(out["rgb"][ys, ys], cpu_out["rgb"]))
    if not crop_psnr >= 40.0:
        raise AssertionError(f"Mip-NeRF card vs CPU on the 32x32 crop: {crop_psnr} dB < 40 dB")
    ms_frame = {s: float(np.median(v)) for s, v in frames.items()}
    samples = model_cfg["num_levels"] * model_cfg["n_samples"]
    floor_frame_ms = MIP_FLOP_PER_ROW * H * H * samples / H100_FP32_FLOPS * 1e3
    emit({"phase": "mip_slice", "config": "configs/mipnerf/mipnerf_multiscale.py", "fused": False, "load_from": True,
          "eval_chunk": int(cfg["eval_chunk"]), "sizes": {s: [H >> s, H >> s] for s in frames},
          "frame_ms": frames, "ms_per_frame": ms_frame,
          "rays_per_s": {s: (H >> s) ** 2 / (ms * 1e-3) for s, ms in ms_frame.items()},
          "mlp_tflops_scale0": MIP_FLOP_PER_ROW * H * H * samples / (ms_frame[0] * 1e-3) / 1e12,
          "mlp_floor_ms_scale0": floor_frame_ms, "mlp_floor_share_scale0": floor_frame_ms / ms_frame[0],
          "kernel_launches": 0, "rgb_mean": float(out["rgb"].mean()), "rgb_std": float(out["rgb"].std()),
          "acc_mean": float(out["acc"].mean()), "crop_psnr_vs_cpu_db": crop_psnr, "cpu_crop_s": cpu_s,
          "peak_mem_gb": peak_gb})
    emit(profile_device(lambda: srv.render_image(rays, H, H), ms_frame[0], "mip_profile", MIP_GROUPS, top=12))
    del srv, views, out
    torch.cuda.empty_cache()


KILO_STEPS, KILO_LOG = 40, 10
KILO_RADIUS = 0.5  # inside the finetune config's domain, +-0.7
KILO_OCC_RES, KILO_OCC_SUB, KILO_OCC_THRESHOLD = 256, 3, 10.0  # the JAX pipeline's sweep
KILO_COS, KILO_RATIO = 0.999, (0.999, 1.001)  # both sides f32, TF32 off
NULL_REL = 1e-5  # a gradient that is zero in exact arithmetic, against the largest entry of any gradient
KILO_BUDGET_CHUNK = 32_768  # 1,048,576 slots: over the config's eval_budget, so the compaction runs
# kernel groups of a KiloNeRF step's and frame's profiles (the rest is elementwise)
KILO_GROUPS = {"bmm": ["gemm", "Gemm", "sm90_xmma", "cutlass", "ampere_", "sm80_", "gemv"],
               "sort": ["sort", "Sort", "radix", "Radix"],
               "gather": ["index_elementwise", "indexSelect", "vectorized_gather", "gather_kernel", "scatter_gather",
                          "index_put", "indexing_backward", "indexFunc", "scatter_kernel", "_scatter_"],
               "posenc": ["sin_kernel", "cos_kernel"], "scan": ["scan", "Scan", "cumsum"],
               "adam": ["multi_tensor_apply"], "reduce": ["reduce_kernel"],
               "cat": ["CatArrayBatchedCopy", "cat_"]}


def kilo_profile(run, wall_ms, phase):
    """``profile_device`` by KiloNeRF's kernel groups; ``elementwise_ms`` is
    the device time outside every group."""
    line = profile_device(run, wall_ms, phase, KILO_GROUPS, top=12)
    line["elementwise_ms"] = line["device_busy_ms"] - sum(line[f"{g}_ms"] for g in KILO_GROUPS)
    return line


class KiloSphereScene(SphereScene):
    """:class:`SphereScene`'s lego camera on the 40 orbit poses, near 2, far
    6, only the chosen pixels' rays made; the sphere has radius 0.5, so it
    lies inside KiloNeRF's domain of +-0.7, coloured by its normal over white."""

    @staticmethod
    def trace(o, d):
        a, b = (d * d).sum(-1), 2 * (o * d).sum(-1)
        disc = b * b - 4 * a * ((o * o).sum(-1) - KILO_RADIUS**2)
        t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        hit = (disc > 0) & (t > 0)
        normal = (o + t[:, None] * d) / KILO_RADIUS
        return np.where(hit[:, None], 0.5 + 0.5 * normal, 1.0).astype(np.float32), hit

    def image_rays(self, pose):
        from xrnerf_torch.datasets.rays import get_rays_np

        o, d = get_rays_np(self.H, self.W, self.K, pose)
        n = self.H * self.W
        return {"rays_o": o.reshape(-1, 3), "rays_d": d.reshape(-1, 3),
                "near": np.full((n, 1), self.near, np.float32), "far": np.full((n, 1), self.far, np.float32)}

    @staticmethod
    def occupancy(res, dmin, dmax):
        """Cells [res^3] of the domain that meet the ball, analytically."""
        lo = np.asarray(dmin, np.float64)
        edge = (np.asarray(dmax, np.float64) - lo) / res
        near2 = []
        for ax in range(3):  # per axis, the squared distance from 0 to the nearest point of each cell
            c0 = lo[ax] + edge[ax] * np.arange(res)
            near2.append(np.clip(0.0, c0, c0 + edge[ax]) ** 2)
        return (near2[0][:, None, None] + near2[1][None, :, None] + near2[2][None, None, :]) <= KILO_RADIUS**2


def occupancy_plane_points(dmin, dmax, res, sub, ix, dev):
    """World points of fine plane ``ix`` as ``build_occupancy_grid`` makes them."""
    fine = res * sub
    xs = (np.arange(fine, dtype=np.float32) + 0.5) / fine
    lo = np.asarray(dmin, np.float32)
    span = np.asarray(dmax, np.float32) - lo
    yy, zz = np.meshgrid(xs, xs, indexing="ij")
    plane = np.stack([np.full_like(yy, xs[ix]), yy, zz], -1).reshape(-1, 3)
    return torch.from_numpy(lo + plane * span).to(dev)


def kilo_phases(work_dir, teacher_cfg, teacher_sd):
    """KiloNeRF at the configs' full width on the card: the occupancy sweep and
    two distillation cycles through the vanilla teacher (row 1), finetune
    training, card-vs-CPU gradients, then frames (pooled march, the budget
    compaction, culling, the other two marches). Returns row 1's launches in
    the occupancy sweep and the distillation."""
    import torch.nn.functional as F

    from xrnerf_torch import build_network, load_config
    from xrnerf_torch.core.distill import DistillDriver
    from xrnerf_torch.core.renderer import render_image, render_rays_chunked
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.models.embedders.posenc import posenc_fast
    from xrnerf_torch.models.fields.kilonerf_field import assign_networks
    from xrnerf_torch.models.networks import kilonerf as kn
    from xrnerf_torch.models.samplers.stratified import sample_along_rays, z_to_pts
    from xrnerf_torch.ops.fused_nerf_mlp import fused_nerf_mlp_ref
    from xrnerf_torch.utils import checkpoint as ckpt
    from xrnerf_torch.utils.metrics import psnr

    fin = load_config(os.path.join(ROOT, "configs", "kilonerf", "kilonerf_finetune.py"), dataname="lego")
    dis = load_config(os.path.join(ROOT, "configs", "kilonerf", "kilonerf_distill.py"), dataname="lego")
    occ_path = os.path.join(work_dir, "occupancy.npy")
    model_cfg = dict(fin["model"], occupancy_path=occ_path)
    dmin, dmax, res = model_cfg["domain_min"], model_cfg["domain_max"], tuple(model_cfg["resolution"])
    chunk = int(fin["eval_chunk"])
    scene = KiloSphereScene(int(fin["data"]["N_rand"]), fin["data"]["near"], fin["data"]["far"])
    np.save(occ_path, scene.occupancy(KILO_OCC_RES, dmin, dmax))
    counters = kernel_counters()
    fwd = counters["fused_nerf_mlp_fwd"]
    dev = torch.device("cuda", 0)

    teacher = build_network(teacher_cfg, device="cuda")
    teacher.load_state_dict(teacher_sd)
    teacher.eval()

    def teacher_fn(pts, dirs):
        with torch.inference_mode():
            return teacher.eval_field(pts, dirs)

    def density(pts):
        dirs = torch.zeros_like(pts)
        dirs[:, 2] = 1.0
        return teacher_fn(pts, dirs)[1]

    # kilo_occupancy: the teacher's density over 768^3 points, through row 1
    t_phase = time.perf_counter()
    fwd.launches = 0  # the main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ_teacher = kn.build_occupancy_grid(density, dmin, dmax, res=(KILO_OCC_RES,) * 3, subsamples=KILO_OCC_SUB,
                                          threshold=KILO_OCC_THRESHOLD)
    sweep_s = time.perf_counter() - t0
    occ_launches = fwd.launches  # and ends here
    planes = KILO_OCC_RES * KILO_OCC_SUB
    if occ_launches < planes:
        raise AssertionError(f"kilo_occupancy: {occ_launches} launches of row 1 for {planes} planes")
    # the same sweep's cells of one coarse slab through the plain version of row 1, same weights, same encodings
    mlp = teacher.mlp_fine
    slab = KILO_OCC_RES // 2
    dens_k, dens_p = [], []
    with torch.inference_mode():
        for ix in range(slab * KILO_OCC_SUB, (slab + 1) * KILO_OCC_SUB):
            pts = occupancy_plane_points(dmin, dmax, KILO_OCC_RES, KILO_OCC_SUB, ix, dev)
            dirs = torch.zeros_like(pts)
            dirs[:, 2] = 1.0
            dens_k.append(density(pts))
            x, v = posenc_fast(pts, teacher.multires), posenc_fast(dirs, teacher.multires_dirs)
            dens_p.append(F.relu(fused_nerf_mlp_ref(x, v, mlp.packed())[1]))
    shape = (KILO_OCC_SUB, KILO_OCC_RES, KILO_OCC_SUB, KILO_OCC_RES, KILO_OCC_SUB)
    dk = torch.stack(dens_k).reshape(shape)
    dp = torch.stack(dens_p).reshape(shape)

    def cells(dens, thr):
        return (dens > thr).any(4).any(2).any(0)

    if not bool(torch.equal(cells(dk, KILO_OCC_THRESHOLD).cpu(), torch.from_numpy(occ_teacher[slab]))):
        raise AssertionError("kilo_occupancy: the sweep's slab differs from the same planes evaluated again")
    # at the config's threshold, and at the slab's median density (so that half its points are over it)
    plain_check = {}
    for label, thr in (("config", KILO_OCC_THRESHOLD), ("median", float(dp.median()))):
        near = ((dp - thr).abs() <= 0.01 * thr).any(4).any(2).any(0)
        differ = cells(dk, thr) != cells(dp, thr)
        if bool((differ & ~near).any()):
            raise AssertionError(f"kilo_occupancy: {int((differ & ~near).sum())} cells differ from the plain "
                                 f"version away from the threshold {thr}")
        plain_check[label] = {"threshold": thr, "occupied_cells": int(cells(dp, thr).sum()),
                              "cells_differ": int(differ.sum()), "cells_near_threshold": int(near.sum())}
    emit({"phase": "kilo_occupancy", "teacher": "configs/nerf/nerf_blender.py, fused, the train phase's weights",
          "res": KILO_OCC_RES, "subsamples": KILO_OCC_SUB, "threshold": KILO_OCC_THRESHOLD,
          "points": planes**3, "sweep_s": sweep_s, "occupied_share": float(occ_teacher.mean()),
          "fused_nerf_mlp_fwd_launches": occ_launches, "plain_check_slab": slab, "plain_check": plain_check,
          "slab_density_max_abs_err": float((dk - dp).abs().max()), "slab_density_max": float(dp.max()),
          "analytic_occupied_share": float(np.load(occ_path).mean()),
          "note": "the finetune below marches the analytic grid", "seconds": time.perf_counter() - t_phase})
    del dk, dp, dens_k, dens_p
    slab_pts = [occupancy_plane_points(dmin, dmax, KILO_OCC_RES, KILO_OCC_SUB, ix, dev)
                for ix in range(slab * KILO_OCC_SUB, (slab + 1) * KILO_OCC_SUB)]
    emit(kilo_profile(lambda: [density(p) for p in slab_pts], sweep_s * 1e3 * KILO_OCC_SUB / planes,
                      "kilo_occupancy_profile"))
    del slab_pts

    # kilo_distill: two cycles of the kd-tree driver as configured, the second in a new driver after the pickle
    t_phase = time.perf_counter()
    dwork = os.path.join(work_dir, "distill")
    os.makedirs(dwork)
    tree = dict(dis["tree"])
    fwd.launches = 0  # the main path starts here
    cycles = []
    for c in range(2):
        driver = DistillDriver(teacher_fn, dmin, dmax, work_dir=dwork, device="cuda", **tree)
        if c and driver.cp["num_networks_fitted"] != cycles[0]["fitted_total"]:
            raise AssertionError("kilo_distill: the resumed driver did not read the first cycle's tree")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        driver.run_cycle(log=lambda *a: None)
        torch.cuda.synchronize()
        errs = np.asarray(driver.last_cycle["errors"])
        if not np.isfinite(errs).all():
            raise AssertionError(f"kilo_distill cycle {c}: non-finite errors")
        cycles.append({"ms": (time.perf_counter() - t0) * 1e3, "networks": driver.last_cycle["networks"],
                       "fitted": driver.last_cycle["fitted"], "saturated": driver.last_cycle["saturated"],
                       "teacher_rows": driver.teacher_rows, "fitted_total": driver.cp["num_networks_fitted"],
                       "queue": len(driver.cp["nodes_to_process"]),
                       "saturated_queue": len(driver.cp["saturated_nodes_to_process"]),
                       "error_quantiles": dict(zip(("p50", "p90", "p99", "max"),
                                                   np.quantile(errs, [0.5, 0.9, 0.99, 1.0]).tolist()))})
    distill_launches = fwd.launches  # and ends here (before the profile below)
    if distill_launches < 4:  # two example draws a cycle, one teacher call each
        raise AssertionError(f"kilo_distill: {distill_launches} launches of row 1")
    # a first cycle cut to 10 Adam steps, by kernel group (the teacher's calls, then the fit)
    short = dict(tree, iters_per_batch=10)

    def short_cycle():
        DistillDriver(teacher_fn, dmin, dmax, device="cuda", **short).run_cycle(log=lambda *a: None)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short_cycle()
    torch.cuda.synchronize()
    line = kilo_profile(short_cycle, (time.perf_counter() - t0) * 1e3, "kilo_distill_profile")
    line["cut"] = "the first cycle at 10 Adam steps of 1,500"
    emit(line)
    cell = (np.asarray(dmax, np.float32) - np.asarray(dmin, np.float32)) / np.asarray(res)
    centres = [np.asarray(dmin, np.float32) + cell * (np.array(ijk) + 0.5) for ijk in np.ndindex(*res)]

    def fitted(drv):
        return np.array([drv.lookup(c).params is not None for c in centres])

    config_fitted = fitted(driver)
    grid = driver.assemble_grid(res) if config_fitted.any() else None  # it raises before any fit, as JAX's does
    # the hand-off into the finetune: two cycles of the config fit no node from a 42-step teacher, so the finetune
    # is seeded from one more cycle cut to 10 Adam steps with max_error 1e9, where every root fits
    handoff = DistillDriver(teacher_fn, dmin, dmax, device="cuda", **dict(short, max_error=1e9))
    handoff.run_cycle(log=lambda *a: None)
    seed_grid, seed_cells = handoff.assemble_grid(res), fitted(handoff)
    if not seed_cells.all():
        raise AssertionError(f"kilo_distill: the hand-off cycle left {int((~seed_cells).sum())} cells without a leaf")
    emit({"phase": "kilo_distill", "config": "configs/kilonerf/kilonerf_distill.py (tree)", "tree": tree,
          "cycles": cycles, "cut": "2 cycles of the run to termination", "fused_nerf_mlp_fwd_launches":
          distill_launches,
          "assembled": {k: list(v.shape) for k, v in grid.items()} if grid is not None else "no fitted leaf",
          "cells_with_fitted_leaf": int(config_fitted.sum()),
          "handoff": {"cut": "1 cycle at 10 Adam steps, max_error 1e9", "networks": handoff.last_cycle["networks"],
                      "fitted": handoff.last_cycle["fitted"], "cells_with_fitted_leaf": int(seed_cells.sum())},
          "seconds": time.perf_counter() - t_phase})

    # kilo_train: the finetune network seeded from the hand-off grid, the config's Adam, the analytic grid
    t_phase = time.perf_counter()
    kwork = os.path.join(work_dir, "finetune")

    def trainer(max_iters, hooks, **kw):
        return Trainer(build_network(model_cfg, device="cuda"), scene, optimizer=fin["optimizer"], work_dir=kwork,
                       max_iters=max_iters, log_interval=KILO_LOG, ckpt_interval=KILO_STEPS, seed=SEED,
                       eval_chunk=chunk, hooks=hooks, device="cuda", **kw)

    torch.cuda.reset_peak_memory_stats()
    rec = MipWindowLog()
    tr = trainer(KILO_STEPS, [rec])
    with torch.no_grad():
        rows = torch.from_numpy(np.nonzero(seed_cells)[0]).to(dev)
        for k, v in seed_grid.items():
            getattr(tr.network.mlp, k)[rows] = torch.from_numpy(v).to(dev)[rows]
    # every 97th cell's row in the finetune field is its kd-tree leaf's fitted weights
    for flat_id in range(0, len(centres), 97):
        leaf = handoff.lookup(centres[flat_id]).params
        for k, v in leaf.items():
            if not np.array_equal(getattr(tr.network.mlp, k)[flat_id].detach().cpu().numpy(), v):
                raise AssertionError(f"kilo_train: cell {flat_id}'s {k} is not its leaf's fitted weights")
    for f in counters.values():
        f.launches = 0  # the main path starts here
    reached = tr.run()
    torch.cuda.synchronize()
    if launched_any(counters):  # and ends here
        raise AssertionError(f"the KiloNeRF finetune launched hand-written kernels: {launched_any(counters)}")
    losses = [w["loss"] for w in rec.windows]
    if reached != KILO_STEPS or len(losses) != KILO_STEPS // KILO_LOG or not all(
            math.isfinite(v) for w in rec.windows for v in w.values()):
        raise AssertionError(f"kilo_train: step {reached}, windows {rec.windows}")
    if not all(w["moved"] > 0 for w in rec.windows):
        raise AssertionError(f"kilo_train: the weights did not move in a window: {[w['moved'] for w in rec.windows]}")
    path = ckpt.latest_path(kwork)
    resumed = trainer(KILO_STEPS + 2, [], resume_from=path)
    if resumed.start_step != KILO_STEPS or resumed.run() != KILO_STEPS + 2:
        raise AssertionError("kilo_train: resume did not continue from the checkpoint to step 42")
    if not torch.equal(resumed.network.occupancy, tr.network.occupancy):
        raise AssertionError("kilo_train: the resumed network's grid differs")
    del resumed
    ms_step = float(np.median([w["ms_per_step"] for w in rec.windows[1:]]))
    batch_ms = []
    for step in range(20):
        t0 = time.perf_counter()
        scene.train_batch(step)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    # the share of live points the capacity rule dropped in one step's batch
    net = tr.network
    with torch.no_grad():
        b = tr._put_batch(scene.train_batch(0))
        flat = z_to_pts(b["rays_o"], b["rays_d"], sample_along_rays(b["near"], b["far"], net.n_samples,
                                                                     perturb=False)).reshape(-1, 3)
        idx, _ = assign_networks(flat, net.domain_lo, net.domain_hi, net.resolution)
        rel = (flat - net.domain_lo) / (net.domain_hi - net.domain_lo)
        idx = torch.where(net.occupancy.reshape(-1)[kn._flat_cells(rel, net.occupancy.shape)], idx, -1)
        load = torch.bincount(idx[idx >= 0].long(), minlength=net.n_nets)
        cap = net.mlp.capacity(flat.shape[0])
        dropped = float((load - cap).clamp(min=0).sum() / load.sum().clamp(min=1))
    emit({"phase": "kilo_train", "config": "configs/kilonerf/kilonerf_finetune.py", "N_rand": scene.N_rand,
          "points_per_step": flat.shape[0], "capacity": cap, "capacity_dropped_share": dropped,
          "live_points": int(load.sum()), "max_network_load": int(load.max()),
          "steps": KILO_STEPS, "resumed_to": KILO_STEPS + 2, "window_losses": losses,
          "window_psnr": [w["psnr"] for w in rec.windows], "window_param_reg": [w["param_reg"] for w in rec.windows],
          "window_max_param_change": [w["moved"] for w in rec.windows],
          "window_ms_per_step": [w["ms_per_step"] for w in rec.windows], "ms_per_step": ms_step,
          "rays_per_s": scene.N_rand / (ms_step * 1e-3), "batch_host_ms": float(np.median(batch_ms)),
          "kernel_launches": 0, "seeded_cells": int(seed_cells.sum()),
          "seeded_from": "the hand-off cycle of kilo_distill",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "seconds": time.perf_counter() - t_phase})

    # kilo_train_grads: 256 rays without jitter, the card against the CPU, same weights and grid
    sd = {k: v.detach().cpu() for k, v in tr.network.state_dict().items()}
    gb = KiloSphereScene(256, scene.near, scene.far, seed=SEED + 1000).train_batch(0)
    grads = {}
    for device in ("cuda", "cpu"):
        gnet = build_network(model_cfg, device=device)
        gnet.load_state_dict(sd)
        bb = {k: torch.from_numpy(v).to(device) for k, v in gb.items()}
        loss = gnet.loss(gnet(bb, generator=None, train=True), bb)[0] + gnet.param_loss()
        loss.backward()
        grads[device] = {k: p.grad.detach().cpu() for k, p in gnet.named_parameters()}
        grads[device + "_loss"] = loss.item()
        del gnet
    per_leaf = check_leaves("kilo_train_grads", grads["cuda"], grads["cpu"], KILO_COS, KILO_RATIO)
    emit({"phase": "kilo_train_grads", "rays": 256, "loss_card": grads["cuda_loss"], "loss_cpu": grads["cpu_loss"],
          "min_cos": min(r["cos"] for r in per_leaf.values()),
          "ratio_range": [min(r["ratio"] for r in per_leaf.values()), max(r["ratio"] for r in per_leaf.values())]})
    del grads

    # kilo_train_profile: one step by kernel group, and the host syncs of a step
    tb = tr._put_batch(scene.train_batch(10_000))
    prof = kilo_profile(lambda: tr.train_step(tb, 10_000), ms_step, "kilo_train_profile")
    n_syncs, inside = count_host_syncs(lambda: tr.train_step(tb, 10_001))
    prof.update(cudaStreamSynchronize_per_step=n_syncs, syncs_inside=inside)
    emit(prof)
    del tr, tb, net
    torch.cuda.empty_cache()

    # kilo_slice: the weights and grid through a .pt into a second Trainer
    t_phase = time.perf_counter()
    pt = os.path.join(work_dir, "kilo_weights.pt")
    torch.save(sd, pt)
    torch.cuda.reset_peak_memory_stats()
    srv = Trainer(build_network(model_cfg, device="cuda"), scene, work_dir=None, eval_chunk=chunk, seed=SEED + 1,
                  load_from=pt, device="cuda")
    net = srv.eval_network
    H = W = scene.H
    rays = scene.image_rays(scene.poses[8].astype(np.float32))
    for f in counters.values():
        f.launches = 0  # the main path starts here
    frame_ms, out = [], None
    for i in range(3):  # one warm-up frame, two timed
        t0 = time.perf_counter()
        out = srv.render_image(rays, H, W)
        torch.cuda.synchronize()
        if i:
            frame_ms.append((time.perf_counter() - t0) * 1e3)
    for k, v in out.items():
        if v.shape[:2] != (H, W) or not np.isfinite(v).all():
            raise AssertionError(f"kilo_slice {k}: shape {v.shape} or non-finite values")

    def chunk_ms(batch, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    # one chunk over the budget: 32,768 rays x 32 kept = 1,048,576 slots > eval_budget
    mid = (H // 2) * W
    big = {k: v[mid - KILO_BUDGET_CHUNK // 2: mid + KILO_BUDGET_CHUNK // 2] for k, v in rays.items()}
    big_dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in big.items()}
    big_ms = chunk_ms(big_dev)
    big_out = net(big_dev)
    with torch.no_grad():
        big_live = int(net.march_samples(big_dev)[1].sum())
    # the other marches on one eval chunk, against the pooled one
    one = {k: v[(KILO_BUDGET_CHUNK - chunk) // 2: (KILO_BUDGET_CHUNK + chunk) // 2] for k, v in big_dev.items()}
    marches = {}
    pooled = net(one)
    with torch.no_grad():
        pooled_mask = net.march_samples(one)[1]
    for march in ("dense", "sphere"):
        net.march = march
        marches[march] = {"chunk_ms": chunk_ms(one), "psnr_vs_pooled": float(psnr(net(one)["rgb"], pooled["rgb"])),
                          "mask_equal_share": float((net.march_samples(one)[1] == pooled_mask).float().mean())}
    net.march = "pooled"
    marches["pooled"] = {"chunk_ms": chunk_ms(one), "live_samples": int(pooled_mask.sum())}
    # stage A's cell radius per ray (r > RMAX: every in-bounds group counts as live)
    dn = np.linalg.norm(rays["rays_d"], axis=-1)
    half_w = (net.march_group - 1) / 2.0 * (scene.far - scene.near) / (net.n_samples - 1) * dn
    r_cells = np.floor(half_w / (min(np.subtract(dmax, dmin)) / KILO_OCC_RES)) + 1
    # the culled frame (strip 8, 64 probes, as bench.py calls it)
    def active(r):
        return kn.kilonerf_strip_active(r["rays_o"], r["rays_d"], r["near"], r["far"], net.occ_dist, net.domain_lo,
                                        net.domain_hi, strip=8, n_probes=64)

    culled_ms, culled = [], None
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        culled = render_rays_chunked(net, rays, chunk=chunk, active_fn=active)
        torch.cuda.synchronize()
        culled_ms.append((time.perf_counter() - t0) * 1e3)
    if launched_any(counters):  # the main path ends here
        raise AssertionError(f"KiloNeRF frames launched hand-written kernels: {launched_any(counters)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # culling is output-identical where no network is over capacity: the same weights with a capacity that
    # holds every chunk's largest network load, culled chunks or not, render the two frames alike
    def max_load(ray_set, order, size):
        most = 0
        with torch.no_grad():
            for start in range(0, len(order), size):
                cb = {k: torch.from_numpy(np.ascontiguousarray(v[order[start:start + size]])).to(dev)
                      for k, v in ray_set.items()}
                z, m, _ = net.march_samples(cb)
                p3 = cb["rays_o"][:, None] + cb["rays_d"][:, None] * z[..., None]
                idx, _ = assign_networks(p3.reshape(-1, 3), net.domain_lo, net.domain_hi, net.resolution)
                idx = torch.where(m.reshape(-1), idx, -1)
                most = max(most, int(torch.bincount(idx[idx >= 0].long(), minlength=net.n_nets).max()))
        return most

    with torch.no_grad():
        act = active({k: torch.from_numpy(v).to(dev) for k, v in rays.items()}).cpu().numpy()
    load_frame, load_culled = max_load(rays, np.arange(H * W), chunk), max_load(rays, np.nonzero(act)[0], chunk)
    frame_cap = net.mlp.capacity(chunk * net.n_keep)
    ample = dict(model_cfg, capacity_factor=(max(load_frame, load_culled) + 1) * net.n_nets / (chunk * net.n_keep))
    ample_net = build_network(ample, device="cuda")
    ample_net.load_state_dict(sd)
    ample_net.eval()
    base = render_rays_chunked(ample_net, rays, chunk=chunk)
    ample_culled = render_rays_chunked(ample_net, rays, chunk=chunk, active_fn=active)
    for k in ("rgb", "acc"):
        if not np.array_equal(ample_culled[k], base[k]):
            raise AssertionError(f"kilo_slice: the culled frame's {k} differs from the unculled frame "
                                 f"(max {np.abs(ample_culled[k] - base[k]).max()})")
    if not np.allclose(ample_culled["disp"], base["disp"], rtol=1e-5, atol=0):
        raise AssertionError("kilo_slice: the culled frame's disp differs from the unculled frame")
    # card against the CPU path, same chunks. Each comparison needs content on the CPU side: with mean(acc^2)
    # >= 1e-3, a card render of background only reads <= 30 dB on acc and fails the 40 dB bar.
    cpu_net = build_network(model_cfg, device="cpu")
    cpu_net.load_state_dict(torch.load(pt, map_location="cpu", weights_only=True))

    def against_cpu(name, card, cpu, min_acc_mean=0.0):
        card = {k: torch.as_tensor(card[k]).cpu().reshape(-1) for k in ("rgb", "acc")}
        cpu = {k: torch.as_tensor(cpu[k]).reshape(-1) for k in ("rgb", "acc")}
        got = {"rgb_psnr_db": float(psnr(card["rgb"], cpu["rgb"])),
               "acc_psnr_db": float(psnr(card["acc"], cpu["acc"])),
               "cpu_acc_mean": float(cpu["acc"].mean()), "cpu_acc_sq_mean": float(cpu["acc"].square().mean())}
        if not (got["rgb_psnr_db"] >= 40.0 and got["acc_psnr_db"] >= 40.0 and got["cpu_acc_sq_mean"] >= 1e-3
                and got["cpu_acc_mean"] > min_acc_mean):
            raise AssertionError(f"kilo_slice {name}: card vs CPU {got} (bars: 40 dB on rgb and acc, CPU "
                                 f"mean(acc^2) >= 1e-3, mean acc > {min_acc_mean})")
        return got

    # at the config's capacity: the 32x32 centre of the frame, and the budget chunk
    ys = slice(H // 2 - 16, H // 2 + 16)
    crop = {k: v.reshape(H, W, -1)[ys, ys].reshape(-1, v.shape[-1]) for k, v in rays.items()}
    t0 = time.perf_counter()
    cpu_crop = render_image(cpu_net, crop, 32, 32, chunk=chunk)
    cpu_s = time.perf_counter() - t0
    vs_cpu = {"crop": against_cpu("crop", render_image(net, crop, 32, 32, chunk=chunk), cpu_crop)}
    frame_crop_psnr = float(psnr(out["rgb"][ys, ys], cpu_crop["rgb"]))
    vs_cpu["budget_chunk"] = against_cpu(
        "budget chunk", big_out, cpu_net({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in big.items()}))
    # where the sphere renders whole: 32x32 rays 6 pixels apart over its disc (radius ~140 pixels), in one chunk
    # at a capacity that holds its largest network load, without and with the budget compaction (half the
    # slots); and the ample frame's same pixels
    ss = slice(H // 2 - 96, H // 2 + 96, 6)
    disc = {k: v.reshape(H, W, -1)[ss, ss].reshape(-1, v.shape[-1]) for k, v in rays.items()}
    n_disc = 32 * 32
    load_disc = max_load(disc, np.arange(n_disc), n_disc)
    for name, budget in (("disc", net.eval_budget), ("disc_budget", n_disc * net.n_keep // 2)):
        for m in (net, cpu_net):
            m.eval_budget = budget
            m.mlp.capacity_factor = (load_disc + 1) * net.n_nets / min(budget, n_disc * net.n_keep)
        cpu_render = render_rays_chunked(cpu_net, disc, chunk=n_disc)
        vs_cpu[name] = against_cpu(name, render_rays_chunked(net, disc, chunk=n_disc), cpu_render,
                                   min_acc_mean=0.1 if name == "disc" else 0.0)
        if name == "disc":
            cpu_disc = cpu_render
    vs_cpu["ample_frame_disc"] = against_cpu(
        "ample frame", {k: v.reshape(H, W, -1)[ss, ss] for k, v in base.items()}, cpu_disc, min_acc_mean=0.1)
    for m in (net, cpu_net):
        m.eval_budget, m.mlp.capacity_factor = model_cfg["eval_budget"], model_cfg["capacity_factor"]
    vs_cpu["disc"]["max_network_load"] = load_disc
    del ample_net, cpu_net
    torch.cuda.empty_cache()
    ms_frame = float(np.median(frame_ms))
    emit({"phase": "kilo_slice", "config": "configs/kilonerf/kilonerf_finetune.py", "load_from": True,
          "march": net.march, "eval_chunk": chunk, "eval_budget": net.eval_budget,
          "slots_per_chunk": chunk * net.n_keep, "frame_ms": frame_ms, "ms_per_frame": ms_frame,
          "rays_per_s": H * W / (ms_frame * 1e-3), "kernel_launches": 0, "rgb_mean": float(out["rgb"].mean()),
          "acc_mean": float(out["acc"].mean()), "vs_cpu": vs_cpu,
          "frame_crop_psnr_vs_cpu_crop_db": frame_crop_psnr, "cpu_crop_s": cpu_s,
          "budget_chunk": {"rays": KILO_BUDGET_CHUNK, "slots": KILO_BUDGET_CHUNK * net.n_keep,
                           "live_samples": big_live, "ms": big_ms},
          "pooled_r_range": [float(r_cells.min()), float(r_cells.max())], "rmax": kn.RMAX,
          "marches_one_chunk": marches, "culled": {"ms": culled_ms, "culled_share": 1.0 - float(act.mean()),
                                                   "psnr_vs_unculled_db": float(psnr(culled["rgb"],
                                                                                     out["rgb"].reshape(-1, 3)))},
          "capacity_per_chunk": frame_cap, "max_network_load_per_chunk": load_frame,
          "max_network_load_per_culled_chunk": load_culled,
          "culled_equal_at_capacity_factor": ample["capacity_factor"], "peak_mem_gb": peak_gb,
          "seconds": time.perf_counter() - t_phase})
    emit(kilo_profile(lambda: srv.render_image(rays, H, W), ms_frame, "kilo_profile"))
    emit(kilo_profile(lambda: render_rays_chunked(net, rays, chunk=chunk, active_fn=active),
                      float(np.median(culled_ms)), "kilo_culled_profile"))
    emit(kilo_profile(lambda: net(big_dev), big_ms, "kilo_budget_chunk_profile"))
    del srv, net, out
    torch.cuda.empty_cache()
    return occ_launches + distill_launches


# --- BungeeNeRF, NeuralBody and AniNeRF: f32 paths, none of the seven kernels ---

F32_STEPS, F32_LOG = 20, 5  # 4 logging windows; ms/step is the median of windows 2-4
BUNGEE_ITERS_PER_STAGE = 5  # a 20-step run crosses the config's 4 stages
BUNGEE_DISTANCES = (5.5, 5.0, 4.5, 4.0)  # orbit radii of stages 0 (far) to 3 (near)
NOVEL_POSE_STEPS = 10
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)
# after flax's init (zero biases) a ReLU density can start below zero at every sample of the body, where it
# passes no gradient and the render stays empty: these density biases are set before training instead
DENSITY_BIAS = {"neuralbody": ("mlp.alpha.bias", 2.0), "aninerf": ("tpose_human.density_out.bias", 10.0)}


def is_conv(name):
    low = name.lower()
    return any(s in low for s in ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit"))


# kernel groups of the three paths' profiles (the rest is ``elementwise_ms``)
F32_GROUPS = {"gemm": lambda k: not is_conv(k) and any(s in k for s in ("gemm", "Gemm", "xmma", "cutlass", "gemv")),
              "conv": is_conv, "argmin": ["ArgMin"],
              "gather": ["index_elementwise", "indexSelect", "index_select", "vectorized_gather", "gather_kernel",
                         "indexing_backward", "embedding"],
              "scatter": ["indexFunc", "index_add", "scatter_kernel", "_scatter_"],
              "searchsorted": ["searchsorted"], "scan": ["scan", "Scan", "cumsum"],
              "cat": ["CatArrayBatchedCopy", "cat_"], "adam": ["multi_tensor_apply"]}


def f32_profile(run, wall_ms, phase):
    line = profile_device(run, wall_ms, phase, F32_GROUPS, top=10)
    line["elementwise_ms"] = line["device_busy_ms"] - sum(line[f"{g}_ms"] for g in F32_GROUPS)
    return line


class BungeeSphereScene:
    """In-memory training data in ``BungeeDataset``'s batch format (``rays_o``,
    ``rays_d``, ``radii``, ``scale_code``, ``near``, ``far``, ``target``,
    ``stage``): :class:`SphereScene`'s lego camera and analytic sphere seen from
    10 orbit poses at each of four distances (``BUNGEE_DISTANCES``); a
    camera's scale code is its distance bucket, the farthest 0. Each step
    draws ``N_rand`` distinct (camera, pixel) entries of the 40 x 640,000 pool
    of rays, as the dataset's permutation does, and makes only their rays; a
    ray's ``radii`` is ``get_ray_radii`` of its pixel and its row neighbour.
    ``stage`` is ``min(step // iters_per_stage, 3)``, a 0-d array."""

    def __init__(self, n_rand, iters_per_stage, near=2.0, far=6.0, seed=SEED):
        from xrnerf_torch.datasets.rays import intrinsics_from_hwf, spherical_render_poses

        self.N_rand, self.iters_per_stage, self.near, self.far, self.seed = n_rand, iters_per_stage, near, far, seed
        self.n_stages = len(BUNGEE_DISTANCES)
        self.H = self.W = 800
        self.focal = 0.5 * self.W / math.tan(0.5 * 0.6911112070083618)  # lego camera_angle_x
        self.K = intrinsics_from_hwf(self.H, self.W, self.focal)
        self.poses = np.concatenate([spherical_render_poses(10, phi=-30.0, radius=r)
                                     for r in BUNGEE_DISTANCES]).astype(np.float32)
        self.scale_codes = np.repeat(np.arange(self.n_stages), 10).astype(np.int32)

    def stage_of(self, step):
        return min(step // self.iters_per_stage, self.n_stages - 1)

    def _dirs(self, cam, row, col):
        K = self.K
        d = np.stack([(col - K[0, 2]) / K[0, 0], -(row - K[1, 2]) / K[1, 1], -np.ones_like(col)], axis=-1)
        return np.einsum("nc,nrc->nr", d.astype(np.float32), self.poses[cam, :3, :3]).astype(np.float32)

    def train_batch(self, step, host_id=0, num_hosts=1):
        from xrnerf_torch.datasets.rays import get_ray_radii

        rng = np.random.RandomState(self.seed + step)
        n, hw = self.N_rand, self.H * self.W
        flat = distinct_draws(rng, n, len(self.poses) * hw)
        cam, pix = flat // hw, flat % hw
        row, col = (pix // self.W).astype(np.float32), (pix % self.W).astype(np.float32)
        d = self._dirs(cam, row, col)
        left = np.minimum(col, self.W - 2)
        radii = get_ray_radii(np.stack([self._dirs(cam, row, left), self._dirs(cam, row, left + 1)], 1))[:, 0]
        o = self.poses[cam, :3, 3].astype(np.float32)
        return {"rays_o": o, "rays_d": d, "radii": radii, "scale_code": self.scale_codes[cam][:, None].astype(np.float32),
                "near": np.full((n, 1), self.near, np.float32), "far": np.full((n, 1), self.far, np.float32),
                "target": SphereScene.colour(o, d), "stage": np.asarray(self.stage_of(step), np.int32)}

    def image_rays(self, pose, size, stage):
        """Full-image rays of ``pose`` at ``size`` x ``size`` (the lego field
        of view) with their radii and the 0-d ``stage``."""
        from xrnerf_torch.datasets.rays import get_ray_radii, get_rays_np, intrinsics_from_hwf

        K = intrinsics_from_hwf(size, size, self.focal * size / self.W)
        o, d = get_rays_np(size, size, K, pose)
        n = size * size
        return {"rays_o": o.reshape(-1, 3), "rays_d": d.reshape(-1, 3), "radii": get_ray_radii(d).reshape(-1, 1),
                "near": np.full((n, 1), self.near, np.float32), "far": np.full((n, 1), self.far, np.float32),
                "stage": np.asarray(stage, np.int32)}


def ani_arrays(seed=SEED):
    """``make_synthetic_zju`` at ZJU-MoCap's 1024^2 at ratio 0.5 with SMPL's
    6,890 vertices, plus 24 joints on SMPL's kinematic tree seeded inside the
    sphere, blend weights softmax(-distance / 0.1) of each vertex to the
    joints, and small seeded rotations per frame (so A is not the identity)."""
    from xrnerf_torch.datasets.load.synthetic import make_synthetic_zju

    arr = make_synthetic_zju(n_frames=2, n_cams=4, H=512, W=512, n_verts=6890, seed=seed)
    rng = np.random.RandomState(seed + 1)
    v0 = arr["verts"][0]
    u = rng.randn(24, 3)
    joints = v0.mean(0) + 0.2 * u / np.linalg.norm(u, axis=-1, keepdims=True) * rng.uniform(0, 1, (24, 1)) ** (1 / 3)
    d = np.linalg.norm(v0[:, None] - joints[None], axis=-1)
    w = np.exp(-(d - d.min(1, keepdims=True)) / 0.1)
    arr.update(joints=joints.astype(np.float32), parents=np.asarray(SMPL_PARENTS),
               weights=(w / w.sum(1, keepdims=True)).astype(np.float32),
               poses=(0.1 * rng.randn(2, 24, 3)).astype(np.float32))
    return arr


def train_f32(model_cfg, ds, optimizer, work_dir, what, steps=F32_STEPS, density_bias=None, **kw):
    """``Trainer.run`` on the card for ``steps`` with windows of ``F32_LOG``
    (``density_bias``: (parameter, value) set after the init), 0 launches of
    the seven kernels, finite windows, moving parameters, a checkpoint and a
    resume by 2 steps: (trainer, windows, ms/step, peak GB)."""
    from xrnerf_torch import build_network
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.utils import checkpoint as ckpt

    counters = kernel_counters()

    def trainer(max_iters, hooks, **extra):
        return Trainer(build_network(model_cfg, device="cuda"), ds, optimizer=optimizer, work_dir=work_dir,
                       max_iters=max_iters, log_interval=F32_LOG, ckpt_interval=steps, seed=SEED,
                       hooks=hooks, device="cuda", **kw, **extra)

    torch.cuda.reset_peak_memory_stats()
    rec = MipWindowLog()
    tr = trainer(steps, [rec])
    if density_bias is not None:
        with torch.no_grad():
            tr.network.get_parameter(density_bias[0]).fill_(density_bias[1])
    start = tr.start_step
    for f in counters.values():
        f.launches = 0  # the main path starts here
    reached = tr.run()
    torch.cuda.synchronize()
    if launched_any(counters):  # and ends here
        raise AssertionError(f"{what} launched hand-written kernels: {launched_any(counters)}")
    if reached != steps or len(rec.windows) != (steps - start) // F32_LOG or not all(
            math.isfinite(v) for w in rec.windows for v in w.values()):
        raise AssertionError(f"{what}: step {reached}, windows {rec.windows}")
    if not all(w["moved"] > 0 for w in rec.windows):
        raise AssertionError(f"{what}: the parameters did not move in a window: {[w['moved'] for w in rec.windows]}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    path = ckpt.latest_path(work_dir)
    if path is None or not path.endswith(f"ckpt_{steps}.pt"):
        raise AssertionError(f"{what}: no checkpoint at step {steps}: {path}")
    resumed = trainer(steps + 2, [], resume_from=path)
    if resumed.start_step != steps or resumed.run() != steps + 2:
        raise AssertionError(f"{what}: resume did not continue from the checkpoint to step {steps + 2}")
    del resumed
    ms_step = float(np.median([w["ms_per_step"] for w in rec.windows[1:]]))
    return tr, rec.windows, ms_step, peak_gb


def grads_f32(model_cfg, sd, batch, what, null=()):
    """The card's loss gradients against the CPU's on one batch, deterministic
    path, same weights: per leaf cosine > 0.999 and norm ratio 0.999-1.001
    (f32 both sides, TF32 off), and a leaf that is zero on the CPU is zero
    on the card; the worst leaf is printed. ``null`` names leaves whose
    gradient is zero in exact arithmetic (GNR's ``nerf.value2.bias``: the
    softmax cancels a shift common to every candidate), so both sides hold
    rounding only: each must stay under ``NULL_REL`` of the largest entry of
    any gradient, and takes no cosine."""
    from xrnerf_torch import build_network

    grads = {}
    for side, device in (("card", "cuda"), ("cpu", "cpu")):
        net = build_network(model_cfg, device=device)
        net.load_state_dict(sd)
        b = {k: torch.from_numpy(np.require(v, requirements="C")).to(device) for k, v in batch.items()}
        loss = net.loss(net(b, generator=None, train=True), b)[0]
        loss.backward()
        grads[side] = {k: p.grad.detach().cpu() for k, p in net.named_parameters() if p.grad is not None}
        grads[side + "_loss"] = loss.item()
        grads["without"] = sorted(k for k, p in net.named_parameters() if p.grad is None)
        del net
    if sorted(grads["card"]) != sorted(grads["cpu"]):
        raise AssertionError(f"{what}: the card and the CPU differ in which leaves have gradients")
    scale = max(float(v.abs().max()) for v in grads["cpu"].values())
    nulls = {k: max(float(grads[side][k].abs().max()) for side in ("card", "cpu")) for k in null}
    if any(m > NULL_REL * scale for m in nulls.values()):
        raise AssertionError(f"{what}: a leaf that should hold rounding only {nulls}, largest entry {scale}")
    nonzero = {k: v for k, v in grads["cpu"].items() if bool(v.any()) and k not in nulls}
    stray = {k: float(v.abs().max()) for k, v in grads["card"].items()
             if k not in nonzero and k not in nulls and bool(v.any())}
    if stray:
        raise AssertionError(f"{what}: zero on the CPU but not on the card (max |grad|): {stray}")
    per_leaf = check_leaves(what, {k: grads["card"][k] for k in nonzero}, nonzero, KILO_COS, KILO_RATIO)
    worst = min(per_leaf, key=lambda k: per_leaf[k]["cos"])
    rays = batch["rays_o"] if "rays_o" in batch else batch["rays_s"]
    return {"rays": int(rays.shape[0]), "leaves": len(per_leaf), "without_grad": grads["without"],
            **({"null_leaves_max_abs": nulls, "largest_entry": scale} if nulls else {}),
            "loss_card": grads["card_loss"],
            "loss_cpu": grads["cpu_loss"], "min_cos": per_leaf[worst]["cos"], "worst_leaf": worst,
            "ratio_range": [min(r["ratio"] for r in per_leaf.values()), max(r["ratio"] for r in per_leaf.values())]}


def frame_f32(model_cfg, ds, pt, views, chunk, what):
    """A second Trainer reads the weights (``load_from``) and renders each
    (rays, H, W) of ``views`` once (the first a warm-up), 0 launches of the
    seven kernels: (trainer, last frame's output, its ms, peak GB)."""
    from xrnerf_torch import build_network
    from xrnerf_torch.core.trainer import Trainer

    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    srv = Trainer(build_network(model_cfg, device="cuda"), ds, work_dir=None, eval_chunk=chunk, seed=SEED + 1,
                  load_from=pt, device="cuda")
    for f in counters.values():
        f.launches = 0  # the main path starts here
    for rays, H, W in views:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = srv.render_image(rays, H, W)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in out.items():
            if v.shape[:2] != (H, W) or not np.isfinite(v).all():
                raise AssertionError(f"{what} {k}: shape {v.shape} or non-finite values")
    if launched_any(counters):  # the main path ends here
        raise AssertionError(f"{what} frames launched hand-written kernels: {launched_any(counters)}")
    return srv, out, ms, torch.cuda.max_memory_allocated() / 1e9


def crop_vs_cpu(model_cfg, pt, rays, out, H, W, ys, xs, chunk, what):
    """The 32x32 crop (``ys``, ``xs``) re-rendered on the CPU with the same
    weights: >= 40 dB on rgb and acc, and content on the CPU side (mean(acc^2)
    >= 1e-3: a background-only card render reads <= 30 dB on acc)."""
    from xrnerf_torch import build_network
    from xrnerf_torch.core.renderer import render_image
    from xrnerf_torch.utils.metrics import psnr

    net = build_network(model_cfg, device="cpu")
    net.load_state_dict(torch.load(pt, map_location="cpu", weights_only=True))
    crop = {k: v if k.startswith("ctx_") or np.ndim(v) == 0 else v.reshape(H, W, -1)[ys, xs].reshape(-1, v.shape[-1])
            for k, v in rays.items()}
    t0 = time.perf_counter()
    cpu = render_image(net, crop, 32, 32, chunk=chunk, keys=("rgb", "acc"))
    got = {"rgb_psnr_db": float(psnr(out["rgb"][ys, xs], cpu["rgb"])),
           "acc_psnr_db": float(psnr(out["acc"][ys, xs], cpu["acc"])),
           "cpu_acc_mean": float(cpu["acc"].mean()), "cpu_acc_sq_mean": float((cpu["acc"] ** 2).mean()),
           "cpu_s": time.perf_counter() - t0}
    if not (got["rgb_psnr_db"] >= 40.0 and got["acc_psnr_db"] >= 40.0 and got["cpu_acc_sq_mean"] >= 1e-3):
        raise AssertionError(f"{what}: card vs CPU on the crop {got} (bars: 40 dB on rgb and acc, "
                             "CPU mean(acc^2) >= 1e-3)")
    return got


def step_summary(tr, ds, ms_step, what):
    """One more step under torch.profiler (by group) and the host syncs of a step."""
    tb = tr._put_batch(ds.train_batch(10_000))
    prof = f32_profile(lambda: tr.train_step(tb, 10_000), ms_step, what)
    n_syncs, inside = count_host_syncs(lambda: tr.train_step(tb, 10_001))
    prof.update(cudaStreamSynchronize_per_step=n_syncs, syncs_inside=inside)
    return prof


def bungee_phase(work_dir):
    """BungeeNeRF at the full width of ``configs/bungeenerf/bungee_multiscale.py``
    on ``BungeeSphereScene``: 20 steps across the 4 stages, a resume to 22,
    card-vs-CPU gradients on 256 rays, a profiled step, a 100x100 warm-up frame
    and an 800x800 frame at stage 3 (crop against the CPU)."""
    from xrnerf_torch import load_config

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(ROOT, "configs", "bungeenerf", "bungee_multiscale.py"), dataname="scene")
    model_cfg = dict(cfg["model"], iters_per_stage=BUNGEE_ITERS_PER_STAGE)
    chunk = int(cfg["eval_chunk"])
    ds = BungeeSphereScene(int(cfg["data"]["N_rand"]), BUNGEE_ITERS_PER_STAGE)
    tr, windows, ms_step, train_peak = train_f32(model_cfg, ds, cfg["optimizer"], work_dir, "bungee_train",
                                                 eval_chunk=chunk)
    stages = [ds.stage_of(w["step"] - 1) for w in windows]
    sd = {k: v.detach().cpu() for k, v in tr.network.state_dict().items()}
    gb = BungeeSphereScene(256, BUNGEE_ITERS_PER_STAGE, seed=SEED + 1000).train_batch(3 * BUNGEE_ITERS_PER_STAGE)
    grads = grads_f32(model_cfg, sd, gb, "bungee_grads")
    prof = step_summary(tr, ds, ms_step, "bungee_profile")
    del tr
    torch.cuda.empty_cache()
    pt = os.path.join(work_dir, "bungee_weights.pt")
    torch.save(sd, pt)
    pose = ds.poses[30 + 2]  # a stage-3 (nearest) camera
    H = ds.H
    rays = ds.image_rays(pose, H, 3)
    srv, out, frame_ms, frame_peak = frame_f32(model_cfg, ds, pt, [(ds.image_rays(pose, 100, 3), 100, 100),
                                                                   (rays, H, H)], chunk, "bungee_frame")
    del srv
    ys = slice(H // 2 - 16, H // 2 + 16)
    vs_cpu = crop_vs_cpu(model_cfg, pt, rays, out, H, H, ys, ys, chunk, "bungee_frame")
    rows = ds.N_rand * 2 * model_cfg["n_samples"]
    return {"phase": "bungee", "config": "configs/bungeenerf/bungee_multiscale.py", "N_rand": ds.N_rand,
            "iters_per_stage": BUNGEE_ITERS_PER_STAGE, "steps": F32_STEPS, "resumed_to": F32_STEPS + 2,
            "window_stages": stages, "window_losses": [w["loss"] for w in windows],
            "window_ms_per_step": [w["ms_per_step"] for w in windows], "ms_per_step": ms_step,
            "rays_per_s": ds.N_rand / (ms_step * 1e-3), "mlp_rows_per_step": rows,
            "device_busy_ms": prof["device_busy_ms"], "idle_share": prof["idle_share"],
            "host_syncs_per_step": prof["cudaStreamSynchronize_per_step"], "profile": prof,
            "train_peak_mem_gb": train_peak, "kernel_launches": 0, "grads": grads,
            "frame": {"H": H, "W": H, "stage": 3, "eval_chunk": chunk, "ms": frame_ms,
                      "rays_per_s": H * H / (frame_ms * 1e-3), "peak_mem_gb": frame_peak,
                      "acc_mean": float(out["acc"].mean()), "vs_cpu": vs_cpu},
            "seconds": time.perf_counter() - t_phase}


def human_phases(work_dir):
    """NeuralBody and AniNeRF at the full width of ``configs/neuralbody/
    nb_zjumocap.py`` and ``configs/aninerf/`` on ``ani_arrays()``: each
    trains 20 steps and resumes to 22, its gradients against the CPU's, a
    profiled step, a 512x512 frame at the config's ``eval_chunk`` (crop
    against the CPU); AniNeRF then trains ``novel_pose`` from its
    ``train_pose`` checkpoint (only ``novel_pose_bw_mlp.*`` may move)."""
    from xrnerf_torch import build_dataset, build_network, load_config
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.models.networks.utils.lbs import closest_vertex
    from xrnerf_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    arrays = ani_arrays()
    arrays_s = time.perf_counter() - t0
    lines = []
    for name, cfg_path in (("neuralbody", ("neuralbody", "nb_zjumocap.py")),
                           ("aninerf", ("aninerf", "aninerf_zjumocap_train_pose.py"))):
        t_phase = time.perf_counter()
        cfg = load_config(os.path.join(ROOT, "configs", *cfg_path), dataname="313")
        model_cfg, chunk = dict(cfg["model"]), int(cfg["eval_chunk"])
        ds = build_dataset(dict(cfg["data"], datadir=None, arrays=arrays))
        wd = os.path.join(work_dir, name)
        tr, windows, ms_step, train_peak = train_f32(model_cfg, ds, cfg["optimizer"], wd, f"{name}_train",
                                                     density_bias=DENSITY_BIAS[name], eval_chunk=chunk)
        sd = {k: v.detach().cpu() for k, v in tr.network.state_dict().items()}
        gds = build_dataset(dict(cfg["data"], datadir=None, arrays=arrays, N_rand=256, seed=SEED + 1000))
        grads = grads_f32(model_cfg, sd, gds.train_batch(0), f"{name}_grads")
        prof = step_summary(tr, ds, ms_step, f"{name}_profile")
        line = {"phase": name, "config": os.path.join("configs", *cfg_path), "N_rand": ds.N_rand,
                "steps": F32_STEPS, "resumed_to": F32_STEPS + 2,
                "window_losses": [w["loss"] for w in windows], "window_ms_per_step": [w["ms_per_step"] for w in windows],
                "ms_per_step": ms_step, "rays_per_s": ds.N_rand / (ms_step * 1e-3),
                "points_per_step": ds.N_rand * model_cfg["n_samples"],
                "device_busy_ms": prof["device_busy_ms"], "idle_share": prof["idle_share"],
                "host_syncs_per_step": prof["cudaStreamSynchronize_per_step"], "profile": prof,
                "train_peak_mem_gb": train_peak, "kernel_launches": 0, "grads": grads}
        del tr
        torch.cuda.empty_cache()
        if name == "aninerf":
            # knn alone at a step's and an eval chunk's point counts
            dev = torch.device("cuda")
            verts = torch.from_numpy(arrays["verts"][0]).to(dev)
            knn = {}
            for n_pts in (ds.N_rand * model_cfg["n_samples"], chunk * model_cfg["n_samples"]):
                pts = torch.randn(n_pts, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)) * 0.5
                knn[n_pts] = time_ms(lambda: closest_vertex(pts, verts), reps=3, warmup=1)
            line["knn_ms"] = knn
            # novel_pose from the train_pose checkpoint: only novel_pose_bw_mlp.* moves
            ncfg = load_config(os.path.join(ROOT, "configs", "aninerf", "aninerf_zjumocap_novel_pose.py"),
                               dataname="313")
            path = ckpt.latest_path(wd)
            loaded = torch.load(path, map_location="cpu", weights_only=True)["model"]
            counters = kernel_counters()
            ntr = Trainer(build_network(ncfg["model"], device="cuda"), ds, optimizer=ncfg["optimizer"],
                          work_dir=os.path.join(work_dir, "novel_pose"), max_iters=NOVEL_POSE_STEPS,
                          log_interval=F32_LOG, ckpt_interval=0, seed=SEED, eval_chunk=chunk, load_from=path,
                          ema_decay=ncfg.get("ema_decay", 0.0), device="cuda")
            for f in counters.values():
                f.launches = 0  # the main path starts here
            t_np = time.perf_counter()
            ntr.run()
            torch.cuda.synchronize()
            np_s = time.perf_counter() - t_np
            if launched_any(counters):  # and ends here
                raise AssertionError(f"novel_pose launched hand-written kernels: {launched_any(counters)}")
            moved, kept = [], 0
            for net in [ntr.network] + ([ntr.ema_network] if ntr.ema_network is not None else []):
                for k, v in net.state_dict().items():
                    same = torch.equal(v.cpu(), loaded[k])
                    if k.startswith("novel_pose_bw_mlp."):
                        moved.append(not same)
                    elif not same:
                        raise AssertionError(f"novel_pose: {k} moved")
                    else:
                        kept += 1
            if not all(moved) or not math.isfinite(ntr.last_logs["loss"]):
                raise AssertionError(f"novel_pose: novel_pose_bw_mlp leaves moved {moved}, logs {ntr.last_logs}")
            line["novel_pose"] = {"steps": NOVEL_POSE_STEPS, "loaded_from": os.path.basename(path),
                                  "trained_leaves": len(ntr.trained_params), "leaves_moved": sum(moved),
                                  "leaves_kept_bit_for_bit": kept, "ema": ntr.ema_network is not None,
                                  "last_loss": ntr.last_logs["loss"], "ms_per_step": ntr.last_logs["ms_per_step"],
                                  "seconds": np_s, "kernel_launches": 0}
            del ntr
            torch.cuda.empty_cache()
        pt = os.path.join(work_dir, f"{name}_weights.pt")
        torch.save(sd, pt)
        rays, gt = ds.eval_item(0)
        H, W = gt.shape[:2]
        srv, out, frame_ms, frame_peak = frame_f32(model_cfg, ds, pt, [(rays, H, W), (rays, H, W)], chunk,
                                                   f"{name}_frame")
        fprof = f32_profile(lambda: srv.render_image(rays, H, W), frame_ms, f"{name}_frame_profile")
        del srv
        torch.cuda.empty_cache()
        ys, xs = slice(H // 2 - 16, H // 2 + 16), slice(W // 2 - 16, W // 2 + 16)
        vs_cpu = crop_vs_cpu(model_cfg, pt, rays, out, H, W, ys, xs, chunk, f"{name}_frame")
        line["frame"] = {"H": H, "W": W, "eval_chunk": chunk, "chunks": math.ceil(H * W / chunk), "ms": frame_ms,
                         "rays_per_s": H * W / (frame_ms * 1e-3), "peak_mem_gb": frame_peak,
                         "acc_mean": float(out["acc"].mean()), "vs_cpu": vs_cpu, "profile": fprof}
        line["seconds"] = time.perf_counter() - t_phase
        lines.append(line)
    lines[0]["arrays_s"] = arrays_s
    return lines


# 30. GNR: the config's full width on a rig with SMPL's mesh size
GNR_RINGS, GNR_SEGMENTS = 84, 82  # a closed sphere of 84 * 82 + 2 = 6,890 vertices and 13,776 triangles, as SMPL's
GNR_RADIUS = 0.3  # make_synthetic_genebody's sphere
GNR_CAMS, GNR_SIZE = 48, 512  # GeneBody's 48 cameras (source views 1, 13, 25, 37 distinct) at load_size
GNR_WINDOW, GNR_CROP = 128, 16  # a frame's central window (16 chunks of 1,024 rays) and its crop against the CPU
GNR_GRID, GNR_LAPLACIAN = 64, 3
GNR_GRAD_RAYS = 64  # card against CPU; the CPU's mesh tile stays short
GNR_TIE_EPS = 1e-5  # |w - 0.5| under which a winding number's sign is a tie


def latlong_sphere(radius=GNR_RADIUS, rings=GNR_RINGS, segments=GNR_SEGMENTS):
    """A closed latitude-longitude sphere: ``rings`` rings of ``segments``
    vertices between two poles, triangles facing outward -> (verts, faces)."""
    th = np.pi * np.arange(1, rings + 1) / (rings + 1)
    ph = 2 * np.pi * np.arange(segments) / segments
    ring = np.stack([np.sin(th)[:, None] * np.cos(ph), np.sin(th)[:, None] * np.sin(ph),
                     np.cos(th)[:, None] * np.ones_like(ph)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 0.0, 1.0]], ring, [[0.0, 0.0, -1.0]]]) * radius
    south = len(verts) - 1
    idx = 1 + np.arange(rings * segments).reshape(rings, segments)
    nxt = np.roll(idx, -1, axis=1)
    faces = [np.stack([np.zeros(segments, np.int64), idx[0], nxt[0]], 1),
             np.stack([np.full(segments, south), nxt[-1], idx[-1]], 1)]
    for r in range(rings - 1):
        faces += [np.stack([idx[r], idx[r + 1], nxt[r + 1]], 1), np.stack([idx[r], nxt[r + 1], nxt[r]], 1)]
    faces = np.concatenate(faces)
    a, b, c = (verts[faces[:, k]] for k in range(3))
    if np.sum(a * np.cross(b, c)) < 0:  # signed volume: make the faces point outward
        faces = faces[:, [0, 2, 1]]
    return verts.astype(np.float32), faces.astype(np.int32)


def gnr_arrays(n_frames=2, n_cams=GNR_CAMS, size=GNR_SIZE, seed=SEED):
    """``make_synthetic_genebody`` with its 128-face icosphere replaced by
    :func:`latlong_sphere` of the same radius (``smpl_verts`` per frame,
    shifted as the maker shifts them, ``smpl_faces``, ``smpl_t_verts``)."""
    from xrnerf_torch.datasets.load.synthetic import make_synthetic_genebody

    arr = make_synthetic_genebody(n_frames=n_frames, n_cams=n_cams, H=size, W=size, radius=GNR_RADIUS, seed=seed)
    v0, faces = latlong_sphere()
    arr.update(smpl_verts=np.stack([v0 + 0.02 * f * np.array([1.0, 0, 0], np.float32) for f in range(n_frames)]),
               smpl_faces=faces, smpl_t_verts=v0)
    return arr


class GnrRanges:
    """Within the block, the GNR network's SMPL queries and the encoder's
    GroupNorms run inside ``torch.profiler.record_function`` ranges, so a
    profile reads their device time (the range's span on the card's
    timeline); undone on exit. Only this script sets them."""

    NAMES = ("gnr_nearest", "gnr_winding", "gnr_groupnorm")

    def __enter__(self):
        import xrnerf_torch.models.networks.gnr as net_mod
        from xrnerf_torch.models.embedders.gnr_embedder import GroupNorm

        def ranged(name, fn):
            def inner(*a, **kw):
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            return inner

        self._saved = (net_mod.nearest_points, net_mod.inside_mesh, GroupNorm.forward)
        net_mod.nearest_points = ranged("gnr_nearest", net_mod.nearest_points)
        net_mod.inside_mesh = ranged("gnr_winding", net_mod.inside_mesh)
        GroupNorm.forward = ranged("gnr_groupnorm", GroupNorm.forward)
        return self

    def __exit__(self, *exc):
        import xrnerf_torch.models.networks.gnr as net_mod
        from xrnerf_torch.models.embedders.gnr_embedder import GroupNorm

        net_mod.nearest_points, net_mod.inside_mesh, GroupNorm.forward = self._saved


def gnr_profile(run, wall_ms, phase):
    """``run()`` under torch.profiler (host and device): device time of the
    mesh tile (nearest point and winding number), GroupNorm, conv, SGEMM,
    grid sampling and the rest (elementwise), and the idle share against
    ``wall_ms``, the unprofiled time of the same work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with GnrRanges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    prof_wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def self_ms(e):
        return (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)) / 1e3

    on_card = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA") and self_ms(e) > 0]
    kernels = sorted(((e.key, self_ms(e), e.count) for e in on_card if e.key not in GnrRanges.NAMES),
                     key=lambda r: -r[1])
    # a range shows on the card's timeline as spans; each kernel that starts inside one counts for that range
    timeline = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in timeline if e.name in GnrRanges.NAMES)
    starts = [sp[0] for sp in spans]
    ranges = dict.fromkeys(GnrRanges.NAMES, 0.0)
    for e in timeline:
        if e.name in GnrRanges.NAMES:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i][1]:
            ranges[spans[i][2]] += (e.time_range.end - e.time_range.start) / 1e3
    busy = sum(ms for _, ms, _ in kernels)
    named = {"conv": is_conv, "sgemm": F32_GROUPS["gemm"], "grid_sample": lambda k: "grid_sampler" in k}
    line = {"phase": phase, "profiled_wall_ms": prof_wall_ms, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "kernel_launches": sum(c for _, _, c in kernels),
            "mesh_tile_ms": ranges["gnr_nearest"] + ranges["gnr_winding"], "nearest_ms": ranges["gnr_nearest"],
            "winding_ms": ranges["gnr_winding"], "groupnorm_ms": ranges["gnr_groupnorm"]}
    for label, match in named.items():
        line[f"{label}_ms"] = sum(ms for k, ms, _ in kernels if match(k))
    line["elementwise_ms"] = busy - sum(line[f"{g}_ms"] for g in ("mesh_tile", "groupnorm", *named))
    for g in ("mesh_tile", "groupnorm", *named, "elementwise"):
        line[f"{g}_share_of_busy"] = line[f"{g}_ms"] / busy if busy else 0.0
    line["top"] = [{"name": k[:100], "ms": ms, "calls": c} for k, ms, c in kernels[:8]]
    return line


def gnr_ties(batch, n_samples, load_size, mesh_chunk):
    """Sample points of ``batch`` (deterministic) inside the visual hull whose
    nearest face on the card differs from the CPU's, or whose winding number
    on the card is within ``GNR_TIE_EPS`` of 0.5: the near-ties."""
    from xrnerf_torch.models.renders.gnr_render import sample_segment, visual_hull_mask
    from xrnerf_torch.ops.mesh import nearest_points, winding_number

    b = {k: torch.from_numpy(np.require(v, requirements="C")) for k, v in batch.items()}
    flat = sample_segment(b["rays_s"], b["rays_e"], n_samples)[0].reshape(-1, 3)
    keep = visual_hull_mask(flat, b["ctx_masks"][:4], b["ctx_calibs"][:4], b["ctx_persps"][:4], load_size, load_size)
    verts, faces = b["ctx_smpl_verts"], b["ctx_smpl_faces"].long()
    idx = {}
    for dev in ("cuda", "cpu"):
        idx[dev] = nearest_points(flat.to(dev), verts.to(dev), faces.to(dev), chunk=mesh_chunk)[1].cpu()
    w = winding_number(flat.cuda(), verts.cuda(), faces.cuda(), chunk=mesh_chunk).cpu()
    ties = keep & ((idx["cuda"] != idx["cpu"]) | ((w - 0.5).abs() <= GNR_TIE_EPS))
    return int(ties.sum()), int(keep.sum())


def gnr_phase(work_dir):
    """GNR at the full width of ``configs/gnr/gnr_genebody.py`` on
    ``gnr_arrays()``: 20 steps and a resume to 22, a profiled step by group,
    the SMPL queries alone at a step's points, card-vs-CPU gradients on 64
    rays, the central 128x128 window of a held-out 512x512 view (16 chunks)
    and its 16x16 centre against the CPU, and ``reconstruct_gnr`` at
    ``n_grid`` 64; 0 launches of the seven kernels across the phase."""
    from xrnerf_torch import build_dataset, build_network, load_config
    from xrnerf_torch.core.renderer import render_image
    from xrnerf_torch.models.renders.gnr_render import reconstruct_gnr, sample_segment
    from xrnerf_torch.ops.mesh import inside_mesh, nearest_points
    from xrnerf_torch.utils.metrics import psnr

    t_phase = time.perf_counter()
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0  # the phase starts here
    arrays = gnr_arrays()
    arrays_s = time.perf_counter() - t_phase
    cfg = load_config(os.path.join(ROOT, "configs", "gnr", "gnr_genebody.py"), dataname="synthetic")
    model_cfg, chunk = dict(cfg["model"]), int(cfg["eval_chunk"])
    mesh_chunk = model_cfg.get("mesh_chunk", 2048)
    ds = build_dataset(dict(cfg["data"], datadir=None, arrays=arrays))
    if len(set(ds.input_views)) != 4:
        raise AssertionError(f"gnr: source views {ds.input_views} are not four distinct views")
    n_pts = ds.N_rand * model_cfg["n_samples"]

    # training: 20 steps, a checkpoint, a resume to 22
    tr, windows, ms_step, train_peak = train_f32(model_cfg, ds, cfg["optimizer"], os.path.join(work_dir, "gnr"),
                                                 "gnr_train", eval_chunk=chunk)
    tb = tr._put_batch(ds.train_batch(10_000))
    prof = gnr_profile(lambda: tr.train_step(tb, 10_000), ms_step, "gnr_profile")
    n_syncs, inside_ops = count_host_syncs(lambda: tr.train_step(tb, 10_001))
    # the SMPL queries alone at the step's sample points
    flat = sample_segment(tb["rays_s"], tb["rays_e"], model_cfg["n_samples"])[0].reshape(-1, 3)
    verts, faces = tb["ctx_smpl_verts"], tb["ctx_smpl_faces"].long()
    mesh = {"points": int(flat.shape[0]), "triangles": int(faces.shape[0]), "vertices": int(verts.shape[0]),
            "mesh_chunk": mesh_chunk,
            "nearest_ms": time_ms(lambda: nearest_points(flat, verts, faces, chunk=mesh_chunk), reps=3, warmup=1),
            "inside_ms": time_ms(lambda: inside_mesh(flat, verts, faces, chunk=mesh_chunk), reps=3, warmup=1)}
    mesh["share_of_step"] = (mesh["nearest_ms"] + mesh["inside_ms"]) / ms_step
    mesh["pairs_per_s"] = 2 * mesh["points"] * mesh["triangles"] / ((mesh["nearest_ms"] + mesh["inside_ms"]) * 1e-3)
    sd = {k: v.detach().cpu() for k, v in tr.network.state_dict().items()}
    del tr, tb, flat
    torch.cuda.empty_cache()

    # gradients, card against CPU, on 64 rays (deterministic path)
    gb = build_dataset(dict(cfg["data"], datadir=None, arrays=arrays, N_rand=GNR_GRAD_RAYS,
                            seed=SEED + 1000)).train_batch(0)
    grads = grads_f32(model_cfg, sd, gb, "gnr_grads", null=("nerf.value2.bias",))
    encoder = sorted(k for k in sd if k.startswith("image_filter."))
    if grads["without_grad"] != encoder:
        raise AssertionError(f"gnr_grads: leaves without a gradient {grads['without_grad'][:4]}..., "
                             f"expected the {len(encoder)} encoder leaves")
    grads["without_grad"] = f"the {len(encoder)} encoder leaves (train_encoder=False)"
    grads["near_tie_points"], grads["hull_points"] = gnr_ties(gb, model_cfg["n_samples"], model_cfg["load_size"],
                                                              mesh_chunk)

    # serving: the central 128x128 window of a held-out view, then its 16x16 centre on the CPU
    pt = os.path.join(work_dir, "gnr_weights.pt")
    torch.save(sd, pt)
    rays, gt = ds.eval_item(0)
    H, W = gt.shape[:2]

    def window(n):
        sl = slice(H // 2 - n // 2, H // 2 + n // 2)
        return {k: v if k.startswith("ctx_") or np.ndim(v) == 0 else v.reshape(H, W, -1)[sl, sl].reshape(-1, v.shape[-1])
                for k, v in rays.items()}

    srv, out, win_ms, win_peak = frame_f32(model_cfg, ds, pt, [(window(32), 32, 32),
                                                               (window(GNR_WINDOW), GNR_WINDOW, GNR_WINDOW)],
                                           chunk, "gnr_window")
    n_chunks = GNR_WINDOW * GNR_WINDOW // chunk
    chunk_ms = win_ms / n_chunks
    cprof = gnr_profile(lambda: srv.render_image(window(32), 32, 32), chunk_ms, "gnr_chunk_profile")
    cpu_net = build_network(model_cfg, device="cpu")
    cpu_net.load_state_dict(sd)
    c0 = (GNR_WINDOW - GNR_CROP) // 2
    t0 = time.perf_counter()
    # one chunk of the crop's 256 rays (the config's 1,024 would pad it to four times the work)
    cpu = render_image(cpu_net, window(GNR_CROP), GNR_CROP, GNR_CROP, chunk=GNR_CROP ** 2, keys=("rgb", "acc"))
    vs_cpu = {"rgb_psnr_db": float(psnr(out["rgb"][c0:c0 + GNR_CROP, c0:c0 + GNR_CROP], cpu["rgb"])),
              "acc_psnr_db": float(psnr(out["acc"][c0:c0 + GNR_CROP, c0:c0 + GNR_CROP], cpu["acc"])),
              "cpu_acc_sq_mean": float((cpu["acc"] ** 2).mean()), "cpu_s": time.perf_counter() - t0,
              "cpu_threads": torch.get_num_threads()}
    if not (vs_cpu["rgb_psnr_db"] >= 40.0 and vs_cpu["acc_psnr_db"] >= 40.0 and vs_cpu["cpu_acc_sq_mean"] >= 1e-3):
        raise AssertionError(f"gnr_window: card vs CPU on the 16x16 crop {vs_cpu} (bars: 40 dB on rgb and acc, "
                             "CPU mean(acc^2) >= 1e-3)")
    del cpu_net

    # reconstruction through the network's density and colour queries, on the card
    net = srv.eval_network
    ctx = {k: torch.from_numpy(np.require(v, requirements="C")).cuda() for k, v in rays.items() if k.startswith("ctx_")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rverts, rfaces, rgbs = reconstruct_gnr(lambda p: net.query_density(ctx, p), lambda p, n: net.query_color(ctx, p, n),
                                           center=rays["ctx_center"], spatial_freq=float(rays["ctx_spatial_freq"]),
                                           load_size=model_cfg["load_size"], n_grid=GNR_GRID, laplacian=GNR_LAPLACIAN,
                                           device="cuda")
    recon_s = time.perf_counter() - t0
    if len(rfaces) == 0 or not np.isfinite(rverts).all() or not np.isfinite(rgbs).all():
        raise AssertionError(f"gnr_reconstruct: {len(rverts)} vertices, {len(rfaces)} faces")
    centre = arrays["smpl_verts"][0].mean(0)
    radial = np.abs(np.linalg.norm(rverts - centre, axis=-1) - GNR_RADIUS)
    del srv, net, ctx
    torch.cuda.empty_cache()
    if launched_any(counters):  # the phase ends here
        raise AssertionError(f"gnr launched hand-written kernels: {launched_any(counters)}")
    return {"phase": "gnr", "config": "configs/gnr/gnr_genebody.py",
            "rig": {"cams": GNR_CAMS, "size": GNR_SIZE, "source_views": list(ds.input_views),
                    "smpl_vertices": int(len(arrays["smpl_t_verts"])), "smpl_triangles": int(len(arrays["smpl_faces"])),
                    "arrays_s": arrays_s},
            "N_rand": ds.N_rand, "n_samples": model_cfg["n_samples"], "steps": F32_STEPS, "resumed_to": F32_STEPS + 2,
            "window_losses": [w["loss"] for w in windows], "window_ms_per_step": [w["ms_per_step"] for w in windows],
            "ms_per_step": ms_step, "rays_per_s": ds.N_rand / (ms_step * 1e-3), "points_per_step": n_pts,
            "device_busy_ms": prof["device_busy_ms"], "idle_share": prof["idle_share"],
            "host_syncs_per_step": n_syncs, "syncs_inside": inside_ops, "profile": prof,
            "train_peak_mem_gb": train_peak, "mesh": mesh, "grads": grads,
            "window": {"H": GNR_WINDOW, "W": GNR_WINDOW, "of": [H, W], "eval_chunk": chunk, "chunks": n_chunks,
                       "ms": win_ms, "ms_per_chunk": chunk_ms, "rays_per_s": GNR_WINDOW ** 2 / (win_ms * 1e-3),
                       "derived_frame_s": H * W // chunk * chunk_ms * 1e-3, "peak_mem_gb": win_peak,
                       "acc_mean": float(out["acc"].mean()), "vs_cpu": vs_cpu, "chunk_profile": cprof},
            "reconstruction": {"n_grid": GNR_GRID, "density_points": GNR_GRID ** 3, "laplacian": GNR_LAPLACIAN,
                               "seconds": recon_s, "vertices": int(len(rverts)), "faces": int(len(rfaces)),
                               "radial_mae": float(radial.mean()), "radius": GNR_RADIUS},
            "kernel_launches": 0,
            "cuts": {"steps": f"{F32_STEPS} of the config's {cfg['max_iters']}",
                     "frame": f"the central {GNR_WINDOW}x{GNR_WINDOW} of {H}x{W} (the full frame's time is derived)",
                     "n_grid": f"{GNR_GRID} (the JAX driver's default is 128)"},
            "seconds": time.perf_counter() - t_phase}

# --- 31. multi: data and model axes over torch.distributed ------------------------------

MULTI_STEPS = 4  # data-parallel steps per configuration; ms/step is the median of steps 2-4
MULTI_NGP_RAND, MULTI_KILO_RAND = 16_384, 1024  # global; NGP: 1,048,576 kept samples against the budget of 2^18
MULTI_COS, MULTI_RATIO = 0.999, (0.999, 1.001)  # f32 sums in another order
MULTI_LOSS_RTOL = 1e-5
MULTI_TIMEOUT_S = 300


class HostRows:
    """A host's rows of a scene's global batch (``train_batch(step, host_id,
    num_hosts)``), as the datasets give each data rank its part; other
    attributes (cameras for ``init_aux``) are the scene's."""

    def __init__(self, scene, n_hosts=1):
        self.scene, self.N_rand = scene, scene.N_rand // n_hosts

    def train_batch(self, step, host_id=0, num_hosts=1):
        from xrnerf_torch.parallel.mesh import shard_batch

        return shard_batch(self.scene.train_batch(step), host_id, num_hosts)

    def __getattr__(self, name):
        return getattr(self.__dict__["scene"], name)


def multi_cases(work_dir):
    """{name: (model config, optimizer, scene, Trainer keywords)} at full width."""
    from xrnerf_torch import load_config

    nerf = load_config(os.path.join(ROOT, "configs", "nerf", "nerf_blender.py"), dataname="lego")
    ngp = load_config(os.path.join(ROOT, "configs", "instant_ngp", "ngp_blender.py"), dataname="lego")
    kilo = load_config(os.path.join(ROOT, "configs", "kilonerf", "kilonerf_finetune.py"), dataname="lego")
    return {
        "nerf": (dict(nerf["model"], fused=True), nerf["optimizer"],
                 SphereScene(N_RAND, nerf["data"]["near"], nerf["data"]["far"]), {}),
        "ngp": (dict(ngp["model"], fused=True), ngp["optimizer"], NGPSphereScene(MULTI_NGP_RAND),
                {"ema_decay": ngp["ema_decay"]}),
        "kilo": (dict(kilo["model"], occupancy_path=os.path.join(work_dir, "occupancy.npy")), kilo["optimizer"],
                 KiloSphereScene(MULTI_KILO_RAND, kilo["data"]["near"], kilo["data"]["far"]), {}),
    }


class StepClock:
    """Hook: the host time of each step, the card synchronised at each end;
    the first step's gradients (after the all-reduce) and every step's loss."""

    def __init__(self):
        self.t, self.losses, self.grads = [time.perf_counter()], [], None

    def on_run_begin(self, tr): ...

    def on_eval(self, tr, step): ...

    def on_run_end(self, tr): ...

    def after_step(self, tr, step, logs):
        torch.cuda.synchronize()
        self.t.append(time.perf_counter())
        self.losses.append(float(logs["loss"]))
        if self.grads is None:
            self.grads = {n: p.grad.detach().clone() for n, p in tr.network.named_parameters() if p.grad is not None}


def multi_train(case, work_dir, mesh, steps):
    """Train one configuration from its seed; returns (trainer, clock, launches
    of the seven kernels on this run)."""
    from xrnerf_torch import build_network
    from xrnerf_torch.core.trainer import Trainer

    model_cfg, opt, scene, kw = multi_cases(work_dir)[case]
    counters = kernel_counters()
    clock = StepClock()
    tr = Trainer(build_network(model_cfg, device="cuda"), HostRows(scene, mesh.data_size if mesh else 1),
                 optimizer=opt, work_dir=None, max_iters=steps, log_interval=steps, ckpt_interval=0, seed=SEED,
                 hooks=[clock], device=torch.cuda.current_device(), mesh=mesh, **kw)
    for f in counters.values():
        f.launches = 0  # the main path starts here
    torch.cuda.synchronize()
    clock.t = [time.perf_counter()]
    if tr.run() != steps:
        raise AssertionError(f"multi {case}: stopped early")
    launches = {k: f.launches for k, f in counters.items()}  # and ends here
    if not all(math.isfinite(x) for x in clock.losses):
        raise AssertionError(f"multi {case}: losses {clock.losses}")
    return tr, clock, launches


def multi_frame_rays():
    cfg_near, cfg_far = 2.0, 6.0  # configs/nerf/nerf_blender.py
    scene = KiloSphereScene(1, cfg_near, cfg_far)
    from xrnerf_torch.datasets.rays import spherical_render_poses

    return scene.image_rays(spherical_render_poses(40, phi=-30.0, radius=4.0)[8])


def multi_masks(work_dir, rows):
    """KiloNeRF's capacity mask over a step's 1,024 x 384 points in 4096
    networks and Instant-NGP's budget mask over 16,384 x 64 samples, seeded,
    this data rank's rows (one rank: all)."""
    from xrnerf_torch import build_network
    from xrnerf_torch.models.fields.kilonerf_field import moe_dispatch

    cases = multi_cases(work_dir)
    d, D = (rows.rank, rows.size) if rows is not None else (0, 1)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, n_nets = MULTI_KILO_RAND * 384, 4096
    net_idx = torch.randint(0, n_nets, (b,), generator=g, device="cuda") // 3  # crowded networks: drops
    net_idx = torch.where(torch.rand(b, generator=g, device="cuda") < 0.3, -1, net_idx).to(torch.int32)
    cap = max(8, int(1.25 * b / n_nets))
    part = net_idx.reshape(D, -1)[d]
    _, keep, order = moe_dispatch(part, n_nets, cap, rows) if rows is not None else moe_dispatch(part, n_nets, cap)
    kilo = torch.zeros_like(keep).index_put((order,), keep)
    live = (torch.rand(MULTI_NGP_RAND * 64, generator=g, device="cuda") < 0.3).reshape(D, -1)[d]
    net = build_network(cases["ngp"][0], device="cuda")
    sel, slot = net.budget_slots(live, rows)
    return {"kilo": kilo.cpu(), "ngp": (live & (slot < sel.shape[0])).cpu()}


def multi_worker(rank, world, port, out_dir, backend) -> int:
    """One rank of the multi phase (``--multi-worker``): data-parallel runs of
    the three configurations, the frame, the masks, and (an even world)
    n_model 2 steps; results to ``out_dir/rank{rank}.pt``."""
    sys.path.insert(0, ROOT)
    from xrnerf_torch.parallel import mesh as pm
    from xrnerf_torch.utils.device import configure_card

    configure_card()
    torch.cuda.set_device(0 if backend == "gloo" else rank)
    pm.init_distributed(f"tcp://127.0.0.1:{port}", backend=backend, world_size=world, rank=rank)
    dp = pm.make_mesh(n_model=1)
    res = {"losses": {}, "grads": {}, "ms_per_step": {}, "launches": {}, "allreduce_bytes": {}}
    frame = None
    for case in ("nerf", "ngp", "kilo"):
        tr, clock, launches = multi_train(case, out_dir, dp, MULTI_STEPS)
        res["losses"][case], res["launches"][case] = clock.losses, launches
        res["ms_per_step"][case] = 1e3 * float(np.median(np.diff(clock.t)[1:]))
        res["allreduce_bytes"][case] = 4 * sum(p.numel() for p in tr.trained_params)
        if rank == 0:
            res["grads"][case] = {k: v.cpu() for k, v in clock.grads.items()}
        if case == "nerf":
            fresh, _, _ = multi_train(case, out_dir, dp, 0)  # the seeded weights, as the one-rank frame's
            rays = multi_frame_rays()
            fwd = kernel_counters()["fused_nerf_mlp_fwd"]
            fwd.launches = 0
            frame = fresh.render_image(rays, 800, 800)["rgb"]
            res["frame_launches"] = fwd.launches
            del fresh
        del tr, clock
        torch.cuda.empty_cache()
    res["frame"] = torch.from_numpy(frame) if rank == 0 else None
    res["masks"] = multi_masks(out_dir, dp.rows)
    if world % 2 == 0:  # the model axis: data rank d's two ranks hold half the table / expert stacks each
        mp = pm.make_mesh(n_model=2)
        res["model_axis"] = {}
        for case in ("ngp", "kilo"):
            tr, clock, launches = multi_train(case, out_dir, mp, 1)
            res["model_axis"][case] = {"loss": clock.losses[0], "launches": launches, "sharded": dict(tr.sharded),
                                       "grads": {k: v.cpu() for k, v in clock.grads.items()},
                                       "ms": 1e3 * float(np.diff(clock.t)[0])}
            del tr, clock
            torch.cuda.empty_cache()
    if "jax" in sys.modules or any(m.startswith("xrnerf_tpu") for m in sys.modules):
        raise AssertionError("a multi worker imported JAX")
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def multi_spawn(world, out_dir, backend):
    """Start ``world`` worker ranks and wait; raises on a failed rank."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    logs = [os.path.join(out_dir, f"{backend}_rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):  # output to files: a full pipe would stall a rank inside a collective
            with open(log, "w") as fh:
                procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multi-worker", str(r),
                                               str(world), str(port), out_dir, backend], env=env, stdout=fh,
                                              stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + MULTI_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log) as fh:
                raise AssertionError(f"multi worker {r}/{world} ({backend}) exited {p.returncode}\n{fh.read()[-6000:]}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def multi_grads(what, got, want):
    """Per leaf cosine and norm ratio of ``got`` against ``want`` (on the
    card); returns (min cosine, worst ratio)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: leaves {sorted(got)} != {sorted(want)}")
    worst_cos, worst_ratio = 1.0, 1.0
    for k, w in want.items():
        a, b = got[k].cuda().double().flatten(), w.cuda().double().flatten()
        na, nb = float(a.norm()), float(b.norm())
        if nb == 0:
            if na != 0:
                raise AssertionError(f"{what} {k}: a gradient where the one-rank run has none")
            continue
        cos, ratio = float(a @ b) / (na * nb), na / nb
        if not (cos > MULTI_COS and MULTI_RATIO[0] < ratio < MULTI_RATIO[1]):
            raise AssertionError(f"{what} {k}: cosine {cos}, norm ratio {ratio}")
        worst_cos, worst_ratio = min(worst_cos, cos), ratio if abs(ratio - 1) > abs(worst_ratio - 1) else worst_ratio
    return worst_cos, worst_ratio


def multi_losses(what, got, want):
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if len(got) != len(want) or not err <= MULTI_LOSS_RTOL:
        raise AssertionError(f"{what}: losses {got} against the one-rank run's {want}")
    return err


def multi_compare(ranks, ref, ref_masks, ref_frame, timed):
    """The multi-rank runs of ``multi_worker`` against the one-rank runs:
    losses, first-step gradients, launches per rank, the masks, the split
    frame and (an even world) the n_model 2 step; ``timed`` adds ms/step."""
    from xrnerf_torch.utils.metrics import psnr

    D = len(ranks)
    out = {"data_axis": {}}
    for case in ("nerf", "ngp", "kilo"):
        for r in ranks:  # each rank launches what the one-rank run launches: the same kernels on its rows
            if r["launches"][case] != ref[case]["launches"]:
                raise AssertionError(f"multi {case}: launches {r['launches'][case]} vs one rank's {ref[case]['launches']}")
        out["data_axis"][case] = {
            "loss_rel_err": max(multi_losses(f"{case} rank {i}", r["losses"][case], ref[case]["losses"])
                                for i, r in enumerate(ranks)),
            "min_cos_ratio": multi_grads(f"multi {case}", ranks[0]["grads"][case], ref[case]["grads"]),
            "allreduce_bytes": ranks[0]["allreduce_bytes"][case],
            "launches_per_rank": [{k: v for k, v in r["launches"][case].items() if v} for r in ranks]}
        if timed:
            out["data_axis"][case]["ms_per_step_two_ranks_one_card"] = [r["ms_per_step"][case] for r in ranks]
    for which in ("kilo", "ngp"):
        got = torch.cat([r["masks"][which] for r in ranks])
        if not torch.equal(got, ref_masks[which]):
            raise AssertionError(f"multi: the {which} mask of {D} ranks differs from one rank's in "
                                 f"{int((got != ref_masks[which]).sum())} places")
    out["masks_bit_equal"] = {"kilo_kept": int(ref_masks["kilo"].sum()), "kilo_points": ref_masks["kilo"].numel(),
                              "ngp_kept": int(ref_masks["ngp"].sum()), "ngp_samples": ref_masks["ngp"].numel()}
    n_chunks = math.ceil(800 * 800 / 8192)  # the Trainer's default eval_chunk; coarse + fine per chunk
    if any(r["frame_launches"] != 2 * math.ceil(n_chunks / D) for r in ranks):
        raise AssertionError(f"multi: frame launches {[r['frame_launches'] for r in ranks]} on {D} ranks: "
                             f"chunks not shared out round-robin")
    frame = ranks[0]["frame"].numpy()
    frame_db = float(psnr(frame, ref_frame))
    if not (frame_db >= 40.0 and np.isfinite(frame).all()):
        raise AssertionError(f"multi: the {D}-rank 800x800 frame is {frame_db} dB from the one-rank frame")
    out["frame"] = {"H": 800, "W": 800, "psnr_db_vs_one_rank": frame_db,
                    "identical": bool(np.array_equal(frame, ref_frame)),
                    "fused_nerf_mlp_fwd_launches_per_rank": [r["frame_launches"] for r in ranks]}
    if "model_axis" in ranks[0]:
        out["model_axis"] = {}
        for case in ("ngp", "kilo"):
            parts = [r["model_axis"][case] for r in ranks[:2]]  # data rank 0's model group
            dims = parts[0]["sharded"]
            grads = {k: torch.cat([p["grads"][k] for p in parts], dim=dims[k]) if k in dims else parts[0]["grads"][k]
                     for k in parts[0]["grads"]}
            out["model_axis"][case] = {
                "sharded": dims, "min_cos_ratio": multi_grads(f"model axis {case}", grads, ref[case]["grads"]),
                "loss_rel_err": max(multi_losses(f"model axis {case}", [r["model_axis"][case]["loss"]],
                                                 ref[case]["losses"][:1]) for r in ranks),
                "launches_per_rank": [{k: v for k, v in r["model_axis"][case]["launches"].items() if v}
                                      for r in ranks]}
            if timed:
                out["model_axis"][case]["ms_step_two_ranks_one_card"] = [p["ms"] for p in parts]
        if not all(r["model_axis"]["ngp"]["launches"].get("scatter_add_rows", 0) == 1 for r in ranks):
            raise AssertionError("multi: the model-axis NGP step did not scatter its table slice through row 7")
    return out


def multi_phase(work_dir):
    """31. The port's data and model axes on the card (see the module notes)."""
    from xrnerf_torch.ops.scatter_rows import scatter_add_rows_levels, shard_rows
    from xrnerf_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    cases = multi_cases(work_dir)
    kilo_cfg = cases["kilo"][0]
    np.save(kilo_cfg["occupancy_path"],
            KiloSphereScene.occupancy(128, kilo_cfg["domain_min"], kilo_cfg["domain_max"]))
    line = {"phase": "multi", "note": "two ranks share one card: not a scaling figure", "backend": "gloo",
            "ranks_per_card": 2, "steps": MULTI_STEPS, "N_rand_global": {"nerf": N_RAND, "ngp": MULTI_NGP_RAND,
                                                                        "kilo": MULTI_KILO_RAND}}

    # the one-rank runs every multi-rank run is held to
    ref = {}
    for case in ("nerf", "ngp", "kilo"):
        tr, clock, launches = multi_train(case, work_dir, None, MULTI_STEPS)
        ref[case] = {"losses": clock.losses, "grads": clock.grads, "launches": launches,
                     "ms_per_step": 1e3 * float(np.median(np.diff(clock.t)[1:])),
                     "allreduce_bytes": 4 * sum(p.numel() for p in tr.trained_params)}
        if case == "nerf":
            fresh, _, _ = multi_train(case, work_dir, None, 0)
            fwd = kernel_counters()["fused_nerf_mlp_fwd"]
            fwd.launches = 0
            ref_frame = fresh.render_image(multi_frame_rays(), 800, 800)["rgb"]
            ref_frame_launches = fwd.launches
            del fresh
        del tr, clock
        torch.cuda.empty_cache()
    ref_masks = multi_masks(work_dir, None)
    line["allreduce_bytes_per_step"] = {c: r["allreduce_bytes"] for c, r in ref.items()}
    line["one_rank_ms_per_step"] = {c: r["ms_per_step"] for c, r in ref.items()}

    # a one-rank NCCL group: the set-up and the mesh's code path with NCCL's collectives
    sock = __import__("socket").socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    pm.init_distributed(f"tcp://127.0.0.1:{port}", backend="nccl", world_size=1, rank=0)
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError(f"backend {torch.distributed.get_backend()}")
        tr, clock, nccl_launches = multi_train("nerf", work_dir, pm.make_mesh(n_model=1), MULTI_STEPS)
        line["nccl_one_rank"] = {"config": "nerf", "loss_rel_err": multi_losses("nccl nerf", clock.losses,
                                                                                ref["nerf"]["losses"]),
                                 "min_cos_ratio": multi_grads("nccl nerf", clock.grads, ref["nerf"]["grads"]),
                                 "launches": {k: v for k, v in nccl_launches.items() if v}}
        del tr, clock
    finally:
        torch.distributed.destroy_process_group()

    want = {"nerf": {"fused_nerf_mlp_fwd": 2 * MULTI_STEPS, "fused_nerf_mlp_bwd": 2 * MULTI_STEPS}, "kilo": {},
            # per step one launch of each tiny MLP and one scatter, one more fused_mlp2 for the step-0 refresh
            "ngp": {"fused_mlp2_fwd": MULTI_STEPS + 1, "fused_mlp2_bwd": MULTI_STEPS, "fused_mlp3_fwd": MULTI_STEPS,
                    "fused_mlp3_bwd": MULTI_STEPS, "scatter_add_rows": MULTI_STEPS}}
    for case, w in want.items():
        if {k: v for k, v in ref[case]["launches"].items() if v} != w:
            raise AssertionError(f"multi {case}: one-rank launches {ref[case]['launches']}, expected {w}")
    if ref_frame_launches != 2 * math.ceil(800 * 800 / 8192):
        raise AssertionError(f"multi: the one-rank frame launched {ref_frame_launches} times")

    # two ranks sharing the card over gloo
    ranks = multi_spawn(2, work_dir, "gloo")
    line.update(multi_compare(ranks, ref, ref_masks, ref_frame, timed=True))
    # this phase's launches of each kernel, on the one-rank runs, the NCCL rank and both gloo ranks
    runs = [r["launches"] for r in ref.values()] + [nccl_launches]
    runs += [r["launches"][c] for r in ranks for c in r["launches"]]
    runs += [r["model_axis"][c]["launches"] for r in ranks for c in r["model_axis"]]
    runs += [{"fused_nerf_mlp_fwd": n} for n in [ref_frame_launches] + [r["frame_launches"] for r in ranks]]
    line["launches"] = {k: sum(run.get(k, 0) for run in runs) for k in kernel_counters()}

    # row 7's slice scatter against the full-table launch
    from xrnerf_torch.models.embedders.hashenc import HashEncoding

    enc_rows = HashEncoding(n_levels=16, n_features=2, log2_table_size=19, base_res=16, max_res=2048).level_rows
    g = torch.Generator(device="cuda").manual_seed(SEED)
    L, M, T = 16, 524_288, 1 << 19
    idx = torch.randint(0, T, (L, M), generator=g, device="cuda") % torch.tensor(enc_rows, device="cuda")[:, None]
    vals = torch.randn((L, M, 2), generator=g, device="cuda")
    full = scatter_add_rows_levels(idx, vals, enc_rows, T)
    errs = []
    for m in range(2):
        t, off = T // 2, m * T // 2
        part = scatter_add_rows_levels(idx - off, vals, shard_rows(enc_rows, off, t), t)
        errs.append(scatter_check(f"slice {m}", part, full[:, off:off + t]))
    line["slice_scatter"] = {"levels": L, "rows_per_level": M, "table_rows": T, "max_abs_err": max(errs)}

    if torch.cuda.device_count() >= 2:  # NCCL, one rank per card: the same checks, no times (no cell asks for them)
        n = torch.cuda.device_count()
        line["nccl_per_card"] = {"ranks": n, **multi_compare(multi_spawn(n, work_dir, "nccl"), ref, ref_masks,
                                                             ref_frame, timed=False)}
    else:
        line["nccl_per_card"] = "not run: one card"
    line["seconds"] = time.perf_counter() - t_phase
    return line



def nerf_counters():
    """The launch counters of the two vanilla-NeRF kernels."""
    from xrnerf_torch.ops import fused_nerf_mlp as fm

    return {"fused_nerf_mlp_fwd": fm.fused_nerf_mlp_fwd, "fused_nerf_mlp_bwd": fm.fused_nerf_mlp_bwd}


# what ``utils.device.configure_card`` promises: f32 matmul and convolutions, cuDNN's algorithm search on
CARD_FLAGS = {"matmul_tf32": False, "cudnn_tf32": False, "cudnn_benchmark": True}


def card_flags():
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32, "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark}


def check_card_flags(when):
    """The CUDA math flags are what the package's ``configure_card`` set (the
    smoke sets none itself), at the start and after every phase ran."""
    if card_flags() != CARD_FLAGS:
        raise AssertionError(f"CUDA math flags at the {when}: {card_flags()}, expected {CARD_FLAGS}")


def main() -> int:
    t_start = time.perf_counter()
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
    from xrnerf_torch.utils.device import configure_card
    from xrnerf_torch.utils.metrics import psnr
    from xrnerf_torch.utils.weights import state_dict_from_jax

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    configure_card()  # the CLI's set-up on the card (run_nerf.main)
    check_card_flags("start")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda, "math_flags": card_flags()})

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
    tiny_fwd_lib, tiny_bwd_lib = tiny_ops._kernel_lib("fwd"), tiny_ops._kernel_lib("bwd")
    emit({"phase": "build", "kernels": names, "seconds": time.perf_counter() - t0, "ptxas": ptxas,
          "dynamic_smem_bytes": {"fused_nerf_mlp_fwd_kernel": fwd_lib.xr_fused_nerf_mlp_fwd_smem_bytes(),
                                 "fused_nerf_mlp_bwd_rows": bwd_lib.xr_fused_nerf_mlp_bwd_rows_smem_bytes(),
                                 "fused_nerf_mlp_bwd_wgrad": bwd_lib.xr_fused_nerf_mlp_bwd_wgrad_smem_bytes()},
          "tiny_mlp_fwd_smem_bytes": {"fused_mlp3_fwd": tiny_fwd_lib.xr_fused_mlp3_fwd_smem_bytes()},
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
        teacher_sd = {k: v.detach().cpu() for k, v in ttr.network.state_dict().items()}  # KiloNeRF's teacher
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

    # 17-20. Mip-NeRF at full width: training, gradients, a profiled step, frames
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_mip_")
    try:
        mip_phases(work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    # 21-25. KiloNeRF at full width: occupancy, distillation, finetune training, frames
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_kilo_")
    try:
        kilo_launches = kilo_phases(work_dir, model_cfg, teacher_sd)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    # 26-28. BungeeNeRF, NeuralBody and AniNeRF at full width (f32, none of the seven kernels)
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_f32_")
    try:
        emit(bungee_phase(work_dir))
        for line in human_phases(work_dir):
            emit(line)
        # 30. GNR at full width (f32, none of the seven kernels)
        emit(gnr_phase(work_dir))
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    # 31. multi: data and model axes, two ranks sharing the card over gloo, one NCCL rank
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    try:
        multi = multi_phase(work_dir)
        emit(multi)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    check_card_flags("end")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    # 32. kernels
    k1, b1 = kernel_rows[1_048_576], bwd_rows[786_432]
    keys = ("rows", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "fused_nerf_mlp_fwd", "route": "cuda", "source": "xrnerf_torch/csrc/fused_nerf_mlp_fwd.cu",
         "replaces": "xrnerf_tpu/ops/pallas/fused_nerf_mlp.py:150",
         "launches": main_path_launches + train_launches["fused_nerf_mlp_fwd"] + kilo_launches
         + multi["launches"]["fused_nerf_mlp_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in kernel_rows.values()), **{k: k1[k] for k in keys}},
        {"name": "fused_nerf_mlp_bwd", "route": "cuda", "source": "xrnerf_torch/csrc/fused_nerf_mlp_bwd.cu",
         "replaces": "xrnerf_tpu/ops/pallas/fused_nerf_mlp.py:159",
         "launches": train_launches["fused_nerf_mlp_bwd"] + multi["launches"]["fused_nerf_mlp_bwd"],
         "max_abs_err": max(r["max_abs_err"] for r in bwd_rows.values()),
         "min_cos": min(r["min_cos"] for r in bwd_rows.values()), **{k: b1[k] for k in keys}},
        *({"name": name, "route": "cuda", "source": f"xrnerf_torch/csrc/fused_mlp_{name[-3:]}.cu",
           "replaces": f"xrnerf_tpu/ops/pallas/fused_mlp.py:{line}",
           "launches": ngp_launches.get(name, 0) + ngp_train_launches[name] + multi["launches"][name],
           "max_abs_err": max(r["max_abs_err"] for r in rows[name].values()),
           **{k: rows[name][262_144][k] for k in keys}}
          for name, line, rows in (("fused_mlp2_fwd", 64, tiny_rows), ("fused_mlp2_bwd", 77, tiny_bwd_rows),
                                   ("fused_mlp3_fwd", 184, tiny_rows), ("fused_mlp3_bwd", 202, tiny_bwd_rows))),
        {"name": "scatter_add_rows", "route": "cuda", "source": "xrnerf_torch/csrc/scatter_rows.cu",
         "replaces": "xrnerf_tpu/ops/pallas/scatter_rows.py:62",
         "launches": ngp_train_launches["scatter_add_rows"] + multi["launches"]["scatter_add_rows"],
         "max_abs_err": max(r["max_abs_err"] for r in scatter_rows.values()),
         **{k: scatter_rows["vertex_step"][k] for k in keys}, "levels": scatter_rows["vertex_step"]["levels"],
         "other_shapes": {c: {k: r[k] for k in ("rows", "width", "num_rows", "ms", "plain_ms", "bound_ms", "library_ms")}
                          for c, r in scatter_rows.items() if c != "vertex_step"}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-worker"]:  # one rank of phase 31
        r, w, p, out, backend = sys.argv[2:7]
        sys.exit(multi_worker(int(r), int(w), int(p), out, backend))
    sys.exit(main())
