"""Multi-GPU training and rendering — port of ``xrnerf_tpu/parallel``."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, init_distributed, make_mesh  # noqa: F401
