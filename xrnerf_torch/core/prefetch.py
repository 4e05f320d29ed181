"""Host-side batch prefetcher — port of ``xrnerf_tpu/core/prefetch.py``.

A daemon thread runs ``fetch(step)`` (``dataset.train_batch``) ahead of the
training loop and stages the arrays on the device with ``put``, so per-step
host work (pixel sampling, ray generation) and the host-to-device copy
overlap the previous step's device work. Steps are consumed in order; an
exception in the worker is raised by the consumer's ``get``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from ..utils.spans import span


class BatchPrefetcher:
    def __init__(
        self,
        fetch: Callable[[int], dict],
        put: Callable[[dict], dict],
        start_step: int,
        max_steps: int,
        depth: int = 2,
    ):
        self._fetch = fetch
        self._put = put
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, args=(start_step, max_steps), daemon=True)
        self._thread.start()

    def _worker(self, start: int, end: int):
        try:
            for step in range(start, end):
                if self._stop.is_set():
                    return
                item = self._put(self._fetch(step))
                while not self._stop.is_set():
                    try:
                        self._q.put((step, item), timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._exc = e
            self._q.put((None, None))

    def get(self, step: int) -> dict:
        """Batch for ``step`` (steps must be consumed in order)."""
        with span("xrnerf_torch.prefetch.wait"):
            got_step, item = self._q.get()
        if got_step is None:  # the worker died: raise its exception here
            raise self._exc
        if got_step != step:
            raise RuntimeError(f"prefetch out of order: {got_step} != {step}")
        return item

    def close(self):
        self._stop.set()
        # drain so the worker's blocked put can see the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
