"""pad_ms.render.<tag>: host milliseconds per traced frame in the chunked
renderer's padding, the program's span ``xrnerf_torch.render.pad`` (the
frame's rays padded to whole chunks on the host, its constants copied to the
card). It follows the previous frame's copy back, so the card has no work
queued and waits for all of it."""

from portbench.lib import program


def read(run):
    return program.span_ms(run, f"{program.PROGRAM}render.pad", "host_s")
