"""xrnerf_torch — the PyTorch/CUDA port of xrnerf_tpu for NVIDIA Hopper.

Mirrors ``xrnerf_tpu``'s layout and names module for module; imports
``torch`` and numpy and nothing of JAX or of ``xrnerf_tpu``. Every Pallas
kernel of the JAX package becomes a hand-written CUDA kernel under
``csrc/`` with a plain PyTorch version beside it. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import registry  # noqa: F401
from .config import Config, load_config  # noqa: F401
from .registry import (  # noqa: F401
    DATASETS,
    EMBEDDERS,
    FIELDS,
    HOOKS,
    NETWORKS,
    PIPELINES,
    RENDERS,
    SAMPLERS,
    build_dataset,
    build_network,
)


from .utils.device import warm_cpu_math

warm_cpu_math()


def _register_all():
    """Import modules for registry side effects."""
    from .datasets import aninerf, bungee, genebody, hashnerf, kilonerf, multiscale, neuralbody, scene  # noqa: F401
    from .models.networks import aninerf as _aninerf_net, bungeenerf  # noqa: F401
    from .models.networks import hashnerf as _hashnerf_net, kilonerf as _kilonerf_net, mipnerf, nerf  # noqa: F401
    from .models.networks import gnr as _gnr_net, neuralbody as _neuralbody_net  # noqa: F401
    from .core import hooks  # noqa: F401


_register_all()
