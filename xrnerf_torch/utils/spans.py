"""Named spans on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
runs on the calling thread (the benchmark's traced slices, ``ProfileHook``)
and a shared no-op context otherwise: on an H100 host (torch 2.11) entering
a ``record_function`` costs ~10 us even with no profiler, ``span`` with none
~0.7 us. The spans are kineto
CPU events, on the clock of the card's activity in the same trace, so each
device operation and each idle gap of the card can be put down to the
innermost span its host thread was in. A profiler records the spans of the
thread that started it alone: a span on another thread (the prefetch worker)
records nothing.

The port's spans, all named ``xrnerf_torch.<stage>``:

- ``nerf.sample``, ``nerf.encode``, ``nerf.mlp``, ``nerf.composite``
  (``models/networks/nerf.py``), whose backward follows them through the
  autograd sequence numbers of their ops;
- ``render.image``, ``render.pad``, ``render.h2d``, ``render.d2h``
  (``core/renderer.py``);
- ``prefetch.wait`` (``core/prefetch.py``, the training loop's side).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler runs, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
