"""Device selection for the port's entry points, and the warm-up of torch's
CPU vector math that importing ``xrnerf_torch`` runs (``warm_cpu_math``).

Entry points default to the card and never fall back to the CPU on their
own: a run that asked for ``cuda`` on a host without one raises, and the
CPU path (which runs every kernel's plain version) is taken only when the
caller passes ``device="cpu"``. ``configure_card`` sets the process's
CUDA math flags; the CLI (``run_nerf.main``) calls it before it builds
anything on the card, and a program that builds a ``Trainer`` on the card
itself calls it first.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA card; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def configure_card() -> None:
    """The port's process-wide settings for CUDA math, set once before the
    first matmul or convolution. TF32 off for matmul and cuDNN: the JAX
    networks this port follows run plain f32 ``nn.Dense`` and ``nn.Conv``
    (torch's default keeps cuDNN's TF32 on, which would run NeuralBody's
    ``Conv3d`` stack at a 10-bit mantissa). cuDNN's algorithm search on, as
    XLA autotunes its convolutions: cuDNN times its algorithms for each conv
    shape once and keeps the fastest, where its heuristic picked f32
    weight-gradient kernels ~2.9x slower for NeuralBody
    (``tools/torch_conv_probe.py``). torch keeps a shape's plan however it
    was chosen, so this comes before any convolution runs. With the search
    on, two runs from one seed may pick different conv algorithms and differ
    in the last bits. bf16 and fp16 products sum in f32 (flax's ``dtype``
    contract: bf16 operands, f32 accumulation), where cuBLAS's split-K
    kernels would otherwise be allowed to reduce their partial sums in
    the operands' precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    first card), or ``cpu`` for a CPU device: the line a measuring tool
    prints before its numbers."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def warm_cpu_math() -> None:
    """Make the process's first call into torch's CPU vector math (MKL's VML,
    behind ``exp``, ``sin`` and the like on float tensors) from this thread
    alone. MKL picks its code path on that first call; made from two of
    torch's intra-op threads at once (a float ``exp`` of more than 2,048
    elements is split between them), one thread's share ran MKL's AVX2
    reduced-accuracy kernel, ~1e-4 relative error, in 14 of 420 fresh
    processes of the CPU tests (none of 300 with this call first)."""
    torch.exp(torch.zeros(1))
