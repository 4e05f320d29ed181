"""Device selection for the port's entry points.

Entry points default to the card and never fall back to the CPU on their
own: a run that asked for ``cuda`` on a host without one raises, and the
CPU path (which runs every kernel's plain version) is taken only when the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA card; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev
