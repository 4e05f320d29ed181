"""The benchmark of ``xrnerf_torch``, the PyTorch and CUDA port: one cell of
``BENCHMARK.json`` per run (``python3 portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``).

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model as it is run; its ``family`` names
  ``families/<family>.py`` (how the port builds and serves it) and
  ``reference/<family>.py`` (the plain PyTorch reference beside it);
- ``traffic/<traffic>.json``: the parameters of a traffic mix; its ``kind``
  names the general code ``mixes/<kind>.py`` that reads them;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.

``lib/`` is the yardstick: traffic generation, the trace reduction, the
peaks and operation counts, the statistics. ``reference/`` imports nothing
of the port.
"""
