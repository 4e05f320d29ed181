"""composite_ms.<tag>: device milliseconds per traced step or frame of the
network's compositing, the program's span ``xrnerf_torch.<family>.composite``
(vanilla NeRF: each ``volume_render``), forward and backward."""

from portbench.lib import program


def read(run):
    return program.span_ms(run, f"{program.PROGRAM}{run.cell.cfg['family']}.composite", "device_s")
