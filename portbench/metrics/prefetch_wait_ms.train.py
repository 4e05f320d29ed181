"""prefetch_wait_ms.train: host milliseconds per traced training step that
the training loop waits on its prefetcher for the next batch, the program's
span ``xrnerf_torch.prefetch.wait``."""

from portbench.lib import program


def read(run):
    return program.span_ms(run, f"{program.PROGRAM}prefetch.wait", "host_s")
