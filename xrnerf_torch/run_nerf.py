"""CLI entry point of the port: test or render a config's scene.

    python -m xrnerf_torch.run_nerf --config configs/nerf/nerf_blender.py \
        --dataname lego --test_only --load_from weights.pt [--device cuda]

Flags are those of the top-level ``run_nerf.py`` plus ``--device``
(default ``cuda``; raises without a card unless ``--device cpu``).
``--test_only`` writes ``<work_dir>/test/test_results.json``;
``--render_only`` renders the orbit path. Training goes to
``Trainer.run``, which is ported in a later slice and raises until then.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="xrnerf_torch test/render entry")
    p.add_argument("--config", required=True, help="python config file")
    p.add_argument("--dataname", default="lego", help="scene name substituted for #DATANAME#")
    p.add_argument("--test_only", action="store_true", help="run test instead of train")
    p.add_argument("--render_only", action="store_true", help="render the spiral path only")
    p.add_argument("--load_from", default=None, help="weights-only .pt state dict to load")
    p.add_argument("--resume_from", default=None, help="full checkpoint to resume")
    p.add_argument("--work_dir", default=None, help="override cfg.work_dir")
    p.add_argument("--max_iters", type=int, default=None,
                   help="override cfg.max_iters (training, ported in a later slice)")
    p.add_argument("--n_model_shards", type=int, default=1, help="model-axis size (multi-GPU is not ported yet)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="where to run")
    return p.parse_args(argv)


def build_from_config(cfg, args):
    from xrnerf_torch import build_dataset, build_network
    from xrnerf_torch.core.trainer import Trainer

    if args.n_model_shards != 1:
        raise NotImplementedError("multi-GPU meshes are ported in a later slice")
    network = build_network(cfg["model"], device=args.device)
    dataset = build_dataset(cfg["data"])
    return Trainer(
        network,
        dataset,
        work_dir=args.work_dir or cfg.get("work_dir", "./work_dir"),
        seed=cfg.get("seed", 0),
        eval_chunk=cfg.get("eval_chunk", 8192),
        resume_from=args.resume_from or cfg.get("resume_from"),
        load_from=args.load_from or cfg.get("load_from"),
        device=args.device,
    )


def main(argv=None):
    args = parse_args(argv)
    from xrnerf_torch import load_config
    from xrnerf_torch.core.hooks import SaveSpiralHook, TestHook

    cfg = load_config(args.config, dataname=args.dataname)
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
