"""CLI entry point of the port: train, test or render a config's scene.

    python -m xrnerf_torch.run_nerf --config configs/nerf/nerf_blender.py \
        --dataname lego [--max_iters N] [--device cuda]
    python -m xrnerf_torch.run_nerf --config ... --test_only --load_from weights.pt
    python -m xrnerf_torch.run_nerf --config ... --test_only --load_from ckpt_N.msgpack

Flags are those of the top-level ``run_nerf.py`` plus ``--device``
(default ``cuda``; raises without a card unless ``--device cpu``). On the
card it first calls ``utils.device.configure_card`` (f32 math, TF32 off).

Multi-GPU, one process per card (NCCL), each rank on ``cuda:LOCAL_RANK``:

    torchrun --nproc_per_node 4 -m xrnerf_torch.run_nerf --config ... [--n_model_shards 2]

It joins the process group first (``parallel.mesh.init_distributed``, from
torchrun's environment; gloo with ``--device cpu``) and trains over a
('data', 'model') mesh whenever the world holds more than one rank.
Without ``--test_only``/``--render_only`` it trains (``Trainer.run``) with
the config's optimizer, intervals, hooks and ``ema_decay``;
``--test_only`` writes ``<work_dir>/test/test_results.json``;
``--render_only`` renders the orbit path.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="xrnerf_torch train/test/render entry")
    p.add_argument("--config", required=True, help="python config file")
    p.add_argument("--dataname", default="lego", help="scene name substituted for #DATANAME#")
    p.add_argument("--test_only", action="store_true", help="run test instead of train")
    p.add_argument("--render_only", action="store_true", help="render the spiral path only")
    p.add_argument("--load_from", default=None,
                   help="weights to load: a .pt state dict or checkpoint, or a JAX-package ckpt_N.msgpack (its parameters)")
    p.add_argument("--resume_from", default=None, help="full checkpoint to resume")
    p.add_argument("--work_dir", default=None, help="override cfg.work_dir")
    p.add_argument("--max_iters", type=int, default=None, help="override cfg.max_iters")
    p.add_argument("--n_model_shards", type=int, default=1, help="model-axis size of the device mesh")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="where to run")
    return p.parse_args(argv)


def build_from_config(cfg, args):
    import torch.distributed as dist

    from xrnerf_torch import build_dataset, build_network
    from xrnerf_torch.core.trainer import Trainer, build_hooks
    from xrnerf_torch.parallel.mesh import local_device, make_mesh

    device = local_device(args.device)
    mesh = make_mesh(n_model=args.n_model_shards) if dist.is_initialized() and dist.get_world_size() > 1 else None
    network = build_network(cfg["model"], device=device)
    dataset = build_dataset(cfg["data"])
    return Trainer(
        network,
        dataset,
        optimizer=cfg.get("optimizer", {}),
        work_dir=args.work_dir or cfg.get("work_dir", "./work_dir"),
        max_iters=args.max_iters or cfg.get("max_iters", 200000),
        eval_interval=cfg.get("eval_interval", 0),
        ckpt_interval=cfg.get("ckpt_interval", 10000),
        log_interval=cfg.get("log_interval", 100),
        hooks=build_hooks(cfg.get("hooks")),
        seed=cfg.get("seed", 0),
        eval_chunk=cfg.get("eval_chunk", 8192),
        resume_from=args.resume_from or cfg.get("resume_from"),
        load_from=args.load_from or cfg.get("load_from"),
        ema_decay=cfg.get("ema_decay", 0.0),
        device=device,
        mesh=mesh,
    )


def main(argv=None):
    args = parse_args(argv)
    from xrnerf_torch import load_config
    from xrnerf_torch.core.hooks import SaveSpiralHook, TestHook

    from xrnerf_torch.parallel.mesh import init_distributed
    from xrnerf_torch.utils.device import configure_card

    init_distributed(backend="gloo" if args.device == "cpu" else None)
    cfg = load_config(args.config, dataname=args.dataname)
    if args.device == "cuda":
        configure_card()
    tr = build_from_config(cfg, args)
    if args.render_only:
        SaveSpiralHook().on_eval(tr, tr.step)
    elif args.test_only:
        TestHook(save_img=True, ndown=cfg.get("ndown", 1)).on_run_end(tr)
    else:
        tr.run()
    return tr


if __name__ == "__main__":
    main()
