"""h2d_idle_ms.render.<tag>: milliseconds per traced frame in which the card
is idle (gaps of 20 us or more) right after one of the chunked renderer's
host-to-device copies (an operation launched in ``xrnerf_torch.render.h2d``):
the card has drained the chunk's copy and waits while the host leaves the
copy's stream synchronise and launches the chunk's first kernel. Read from
the card's timeline, not from where the host was at the gap's middle."""

from portbench.lib import program


def read(run):
    return program.span_ms(run, f"{program.PROGRAM}render.h2d", "idle_after_s")
