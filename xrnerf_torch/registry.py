"""Tiny string->constructor registry for config-driven assembly.

A copy of ``xrnerf_tpu/registry.py`` (the port imports nothing of the JAX
package): configs carry a ``type`` key naming the registered class or
factory, and :func:`build` instantiates it with the remaining kwargs.

Unlike the reference we keep separate namespaces per component family so a
typo'd ``type`` fails loudly with the valid choices for that family.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """Maps names to callables (classes or factory functions)."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register(self, obj: Optional[Callable] = None, *, name: Optional[str] = None):
        """Use as ``@REG.register`` or ``@REG.register(name="Alias")``."""

        def _do_register(fn: Callable) -> Callable:
            key = name or fn.__name__
            if key in self._entries and self._entries[key] is not fn:
                raise KeyError(f"{key!r} already registered in {self.name!r}")
            self._entries[key] = fn
            return fn

        if obj is None:
            return _do_register
        return _do_register(obj)

    def get(self, key: str) -> Callable:
        if key not in self._entries:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}. "
                f"Available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def keys(self):
        return self._entries.keys()

    def build(self, cfg: Any, **extra_kwargs) -> Any:
        """Instantiate from a config mapping with a ``type`` key.

        Nested dicts that themselves contain a ``type`` key are NOT built
        automatically — component constructors decide what to build, which
        keeps assembly explicit (the reference auto-built recursively via
        mmcv, which made dataflow hard to trace).
        """
        if not isinstance(cfg, dict):
            raise TypeError(f"build() expects a dict config, got {type(cfg)}")
        cfg = dict(cfg)
        try:
            key = cfg.pop("type")
        except KeyError as e:
            raise KeyError(f"config for registry {self.name!r} missing 'type': {cfg}") from e
        cls = self.get(key)
        cfg.update(extra_kwargs)
        return cls(**cfg)


# Component-family registries (reference: NETWORKS/MLPS/RENDERS/EMBEDDERS/
# SAMPLERS all alias one registry; we keep them distinct).
EMBEDDERS = Registry("embedders")
FIELDS = Registry("fields")  # MLPs / neural fields (reference calls these MLPS)
SAMPLERS = Registry("samplers")
RENDERS = Registry("renders")
NETWORKS = Registry("networks")
DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
HOOKS = Registry("hooks")


def build_network(cfg: dict, device="cuda", **kw):
    """Build a registered network and move it to ``device`` (default: the
    card; raises without one unless ``device="cpu"``)."""
    from .utils.device import resolve_device

    return NETWORKS.build(cfg, **kw).to(resolve_device(device))


def build_dataset(cfg: dict, **kw):
    return DATASETS.build(cfg, **kw)
