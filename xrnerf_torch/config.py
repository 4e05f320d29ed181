"""Config system: attribute-accessible nested dicts loaded from python files.

A copy of ``xrnerf_tpu/config.py``: executable python configs plus the
``#DATANAME#`` placeholder substitution, so the port reads the repo's
``configs/*.py`` unchanged. A config file is an ordinary python module that defines top-level variables; every
non-dunder module-level name becomes a config key.
"""

from __future__ import annotations

import copy
import os
import runpy
from typing import Any, Dict


class Config(dict):
    """Dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d: Dict[str, Any] | None = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v):
        if isinstance(v, Config):
            return v
        if isinstance(v, dict):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
        return v

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        def _un(v):
            if isinstance(v, Config):
                return {k: _un(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(_un(x) for x in v)
            return v

        return _un(self)

    def merge(self, other: Dict[str, Any]) -> "Config":
        """Recursive override merge; returns self."""
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, dict):
                self[k].merge(v)
            else:
                self[k] = self._wrap(v)
        return self


def replace_dataname(obj: Any, dataname: str) -> Any:
    """Recursively substitute '#DATANAME#' in every string value.

    """
    if isinstance(obj, str):
        return obj.replace("#DATANAME#", dataname)
    if isinstance(obj, Config):
        return Config({k: replace_dataname(v, dataname) for k, v in obj.items()})
    if isinstance(obj, dict):
        return {k: replace_dataname(v, dataname) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(replace_dataname(v, dataname) for v in obj)
    return obj


def load_config(path: str, dataname: str | None = None) -> Config:
    """Execute a python config file and collect its module-level names."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    ns = runpy.run_path(path)
    cfg = Config(
        {
            k: v
            for k, v in ns.items()
            if not k.startswith("_") and not callable(v) and not isinstance(v, type(os))
        }
    )
    if dataname is not None:
        cfg = replace_dataname(cfg, dataname)
    return cfg
