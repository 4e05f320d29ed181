#!/usr/bin/env python3
"""GNR's bf16 loss gradients on the card against the CPU at fixed weights, with the encoder's features swapped.

    python3 tools/torch_gnr_bf16_probe.py [--perturb 0.05] [--out probe.json]

``configs/gnr/gnr_genebody.py`` at full width on ``chip_smoke.py``'s GNR rig (48 cameras at 512x512, a 6,890-vertex
body) and its 64-ray gradient batch, at flax's init from seed 0 and at that init with ``--perturb`` times a normal
draw added to every MLP leaf. For each set of weights the same step runs as: the card in bf16 with cuDNN's
algorithm search off (``card_bf16``) and twice with it on (``card_bf16_bench1`` / ``2``), the CPU in bf16 and in
f32, the card in f32, the card in bf16 fed the CPU's bf16 encoder features and the CPU in bf16 fed the card's
(``*_cpufeats`` / ``*_cardfeats``), and the CPU in bf16 fed the f32 features rounded to bf16. The encoder is
frozen (``train_encoder=False``), so a feature swap leaves every parameter's path but the features' rounding the
same. Prints the card's name and power limit, then per weight set one JSON line: the losses, the features'
relative L2 distances, and per leaf (cosine, norm ratio) for each compared pair.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PAIRS = [("card_bf16", "cpu_bf16"), ("card_bf16", "cpu_f32"), ("cpu_bf16", "cpu_f32"), ("card_f32", "cpu_f32"),
         ("card_bf16_bench1", "card_bf16_bench2"), ("card_bf16_bench1", "card_bf16"),
         ("card_bf16_cpufeats", "cpu_bf16"), ("cpu_bf16_cardfeats", "card_bf16"), ("cpu_bf16_cardfeats", "cpu_bf16"),
         ("cpu_bf16_f32feats", "cpu_f32"), ("cpu_bf16_f32feats", "cpu_bf16")]


def cosine(a, b):
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm() + 1e-300))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--perturb", type=float, default=0.05)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import chip_smoke as cs
    from xrnerf_torch import build_dataset, build_network, load_config
    from xrnerf_torch.utils.device import configure_card, resolve_device

    resolve_device("cuda")  # raises without a card
    configure_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0], flush=True)
    cfg = load_config(os.path.join(ROOT, "configs", "gnr", "gnr_genebody.py"), dataname="synthetic")
    batch = build_dataset(dict(cfg["data"], datadir=None, arrays=cs.gnr_arrays(), N_rand=cs.GNR_GRAD_RAYS,
                               seed=cs.SEED + 1000)).train_batch(0)
    model = dict(cfg["model"])
    init = build_network(model, device="cpu")
    init.reset_parameters(torch.Generator().manual_seed(cs.SEED))
    sd0 = {k: v.detach().clone() for k, v in init.state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    sd1 = {k: v + args.perturb * torch.randn(v.shape, generator=gen) if k.startswith("nerf.") else v
           for k, v in sd0.items()}

    def run(sd, device, dtype, feats=None, bench=False):
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = bench, not bench
        net = build_network(dict(model, dtype=dtype), device=device)
        net.load_state_dict(sd)
        encode, seen = net.encode_images, {}

        def encode_images(images):
            f = encode(images) if feats is None else feats.to(device)
            seen["feats"] = f.detach().cpu()
            return f

        net.encode_images = encode_images
        b = {k: torch.from_numpy(np.require(v, requirements="C")).to(device) for k, v in batch.items()}
        loss = net.loss(net(b, generator=None, train=True), b)[0]
        loss.backward()
        grads = {k: q.grad.detach().float().cpu() for k, q in net.named_parameters() if q.grad is not None}
        return {"grads": grads, "loss": loss.item(), "feats": seen["feats"]}

    t0 = time.perf_counter()
    for name, sd in (("init", sd0), (f"perturbed_{args.perturb}", sd1)):
        r = {"card_bf16": run(sd, "cuda", "bfloat16")}
        r["card_bf16_bench1"] = run(sd, "cuda", "bfloat16", bench=True)
        r["card_bf16_bench2"] = run(sd, "cuda", "bfloat16", bench=True)
        r["cpu_bf16"] = run(sd, "cpu", "bfloat16")
        r["cpu_f32"] = run(sd, "cpu", "float32")
        r["card_f32"] = run(sd, "cuda", "float32")
        r["card_bf16_cpufeats"] = run(sd, "cuda", "bfloat16", feats=r["cpu_bf16"]["feats"])
        r["cpu_bf16_cardfeats"] = run(sd, "cpu", "bfloat16", feats=r["card_bf16"]["feats"])
        r["cpu_bf16_f32feats"] = run(sd, "cpu", "bfloat16", feats=r["cpu_f32"]["feats"].bfloat16())
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = True, False  # configure_card's
        ref = r["cpu_f32"]["feats"].double()
        feats = {f"{k}~cpu_f32": float((r[k]["feats"].double() - ref).norm() / ref.norm())
                 for k in ("card_bf16", "cpu_bf16", "card_f32")}
        feats["card_bf16~cpu_bf16"] = float((r["card_bf16"]["feats"].double() - r["cpu_bf16"]["feats"].double())
                                            .norm() / ref.norm())
        leaves = sorted(k for k in r["cpu_bf16"]["grads"] if k != "nerf.value2.bias")  # zero in exact arithmetic
        line = {"weights": name, "losses": {k: v["loss"] for k, v in r.items()}, "feats_rel_l2": feats,
                "pairs": {f"{a}~{b}": {k: [cosine(r[a]["grads"][k], r[b]["grads"][k]),
                                           float(r[a]["grads"][k].norm() / r[b]["grads"][k].norm())] for k in leaves}
                          for a, b in PAIRS},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
