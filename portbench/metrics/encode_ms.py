"""encode_ms.<tag>: device milliseconds per traced step or frame of the
network's encode stage, the program's span ``xrnerf_torch.<family>.encode``
(vanilla NeRF's fused path: row 8, one launch writing both encodings),
forward and backward."""

from portbench.lib import program


def read(run):
    return program.span_ms(run, f"{program.PROGRAM}{run.cell.cfg['family']}.encode", "device_s")
