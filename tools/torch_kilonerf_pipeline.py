"""KiloNeRF's three phases in the PyTorch port: pretrain -> occupancy ->
distill -> finetune (the port's counterpart of ``tools/kilonerf_pipeline.py``).

    python tools/torch_kilonerf_pipeline.py --pretrain_cfg configs/nerf/nerf_blender.py \\
        --distill_cfg configs/kilonerf/kilonerf_distill.py \\
        --finetune_cfg configs/kilonerf/kilonerf_finetune.py --dataname lego --fused

1. pretrain: ``xrnerf_torch.run_nerf`` trains the vanilla NeRF of
   ``--pretrain_cfg``; its latest checkpoint is the teacher (the port's
   ``ckpt_N.pt``, or else the JAX package's ``ckpt_N.msgpack``, whose
   parameters are read, as ``tools/kilonerf_pipeline.py`` reads them), rebuilt with
   ``fused=True`` when ``--fused`` is given (the hand-written forward kernel
   on the card, as ``chip_smoke.py`` builds its vanilla networks).
2. occupancy: the teacher's density swept over the finetune config's domain
   (``build_occupancy_grid``, ``OCC_RES`` cells a side, 3 points per cell
   and axis), saved as the finetune config's ``occupancy_path``.
3. distill: in the distill config's ``mode``: ``tree`` (``DistillDriver``
   with its ``tree`` dict, resumable from ``distill_checkpoint.pkl``; the
   fitted leaves assembled onto the finetune grid as ``distill_grid.npz``) or
   ``uniform`` (``StudentNerfNetwork`` trained by ``Trainer`` on
   ``KiloNerfDistillDataset``).
4. finetune: ``KiloNerfNetwork`` trained by ``Trainer`` from the distilled
   weights (tree: copied into its stacked leaves; uniform: the student's
   checkpoint through ``--load_from``).

Each phase can be skipped with ``--skip_{pretrain,occupancy,distill,finetune}``.
Everything runs on ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OCC_RES = 256  # occupancy cells per side, as the JAX tool sweeps


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pretrain_cfg", default="configs/nerf/nerf_blender.py")
    p.add_argument("--distill_cfg", default="configs/kilonerf/kilonerf_distill.py")
    p.add_argument("--finetune_cfg", default="configs/kilonerf/kilonerf_finetune.py")
    p.add_argument("--dataname", default="lego")
    p.add_argument("--skip_pretrain", action="store_true")
    p.add_argument("--skip_occupancy", action="store_true")
    p.add_argument("--skip_distill", action="store_true")
    p.add_argument("--skip_finetune", action="store_true")
    p.add_argument("--fused", action="store_true", help="build the teacher with the fused forward kernel")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def load_teacher(cfg_path: str, dataname: str, ckpt_path: str, fused: bool = False, device="cuda"):
    """The pretrained ``NerfNetwork`` from a checkpoint (or a weights file;
    ``.pt``, or the JAX package's ``.msgpack``) and its point-wise field:
    ``teacher_fn(pts, dirs) -> (rgb, sigma)``."""
    import torch

    from xrnerf_torch import build_network, load_config
    from xrnerf_torch.utils.checkpoint import load_weights

    cfg = load_config(cfg_path, dataname=dataname)
    net = build_network(dict(cfg["model"], fused=fused), device=device)
    load_weights(net, ckpt_path)
    net.eval()

    def teacher_fn(pts, dirs):
        with torch.inference_mode():
            return net.eval_field(pts, dirs)

    return teacher_fn, net


def trainer_from_cfg(cfg, network, dataset, work_dir, device):
    from xrnerf_torch.core.trainer import Trainer, build_hooks

    return Trainer(
        network, dataset, optimizer=cfg.get("optimizer", {}), work_dir=work_dir,
        max_iters=cfg.get("max_iters", 150000), eval_interval=cfg.get("eval_interval", 0),
        ckpt_interval=cfg.get("ckpt_interval", 10000), log_interval=cfg.get("log_interval", 100),
        hooks=build_hooks(cfg.get("hooks")), seed=cfg.get("seed", 0), eval_chunk=cfg.get("eval_chunk", 8192),
        device=device,
    )


def main(argv=None):
    args = parse_args(argv)
    import torch

    from xrnerf_torch import build_dataset, build_network, load_config, run_nerf
    from xrnerf_torch.models.networks.kilonerf import build_occupancy_grid
    from xrnerf_torch.utils import checkpoint as ckptmod

    dev = ["--device", args.device]
    # -- phase 1: pretrain an ordinary NeRF ---------------------------------
    pre_cfg = load_config(args.pretrain_cfg, dataname=args.dataname)
    pre_work = pre_cfg.get("work_dir", "./work_dirs/nerf/" + args.dataname)
    if not args.skip_pretrain:
        run_nerf.main(["--config", args.pretrain_cfg, "--dataname", args.dataname] + dev)
    teacher_ckpt = ckptmod.latest_path(pre_work) or ckptmod.latest_path(pre_work, ext=".msgpack")
    assert teacher_ckpt, f"no pretrain checkpoint in {pre_work}"

    fin_cfg = load_config(args.finetune_cfg, dataname=args.dataname)
    dmin, dmax = fin_cfg["model"]["domain_min"], fin_cfg["model"]["domain_max"]
    occ_path = fin_cfg["model"]["occupancy_path"]
    teacher_fn, _ = load_teacher(args.pretrain_cfg, args.dataname, teacher_ckpt, args.fused, args.device)

    # -- phase 1.5: occupancy grid -------------------------------------------
    if not args.skip_occupancy:
        def density_fn(pts):
            dirs = torch.zeros_like(pts)
            dirs[:, 2] = 1.0
            return teacher_fn(pts, dirs)[1]

        res = (OCC_RES,) * 3
        occ = build_occupancy_grid(density_fn, dmin, dmax, res=res, device=args.device)
        os.makedirs(os.path.dirname(occ_path) or ".", exist_ok=True)
        np.save(occ_path, occ)
        print(f"occupancy grid: {occ.mean():.3%} occupied -> {occ_path}")

    # -- phase 2: distill -----------------------------------------------------
    dis_cfg = load_config(args.distill_cfg, dataname=args.dataname)
    dis_work = dis_cfg.get("work_dir", "./work_dirs/kilonerf_distill/" + args.dataname)
    os.makedirs(dis_work, exist_ok=True)
    mode = dis_cfg.get("mode", "uniform")
    grid_npz = os.path.join(dis_work, "distill_grid.npz")
    if not args.skip_distill:
        if mode == "tree":
            from xrnerf_torch.core.distill import DistillDriver

            driver = DistillDriver(teacher_fn, domain_min=dmin, domain_max=dmax, work_dir=dis_work,
                                   device=args.device, **dis_cfg.get("tree", {}))
            driver.run()
            np.savez(grid_npz, **driver.assemble_grid(fin_cfg["model"]["resolution"]))
            print(f"assembled distilled grid -> {grid_npz}")
        else:
            dataset = build_dataset(dict(dis_cfg["data"], teacher_fn=teacher_fn, device=args.device))
            network = build_network(dis_cfg["model"], device=args.device)
            trainer_from_cfg(dis_cfg, network, dataset, dis_work, args.device).run()

    # -- phase 3: finetune ----------------------------------------------------
    if not args.skip_finetune:
        fin_work = fin_cfg.get("work_dir", "./work_dirs/kilonerf/" + args.dataname)
        if mode == "tree" and os.path.exists(grid_npz):
            tr = trainer_from_cfg(fin_cfg, build_network(fin_cfg["model"], device=args.device),
                                  build_dataset(fin_cfg["data"]), fin_work, args.device)
            with torch.no_grad():
                for k, v in np.load(grid_npz).items():
                    leaf = getattr(tr.network.mlp, k)
                    assert tuple(leaf.shape) == v.shape, (k, tuple(leaf.shape), v.shape)
                    leaf.copy_(torch.from_numpy(v))
            tr.run()
        else:
            distill_ckpt = ckptmod.latest_path(dis_work)
            return run_nerf.main(["--config", args.finetune_cfg, "--dataname", args.dataname] + dev
                                 + (["--load_from", distill_ckpt] if distill_ckpt else []))
        return tr


if __name__ == "__main__":
    main()
