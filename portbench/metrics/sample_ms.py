"""sample_ms.<tag>: device milliseconds per traced step or frame of the
network's sampling, the program's span ``xrnerf_torch.<family>.sample``
(vanilla NeRF: stratified samples, ``sample_pdf`` and the sort of the fine
samples), forward and backward."""

from portbench.lib import program


def read(run):
    return program.span_ms(run, f"{program.PROGRAM}{run.cell.cfg['family']}.sample", "device_s")
