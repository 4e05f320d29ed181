"""mfu.render: the whole frame's share of the card's bf16 peak: the model's
operations per ray (the family's count; for vanilla NeRF every sample
through the MLP, forward) times the device-only traced frames' rays, over their
host-timed length (no host-op overhead) and the peak (%)."""

from portbench.lib import flops


def read(run):
    s, fam = run.idle, run.cell.family
    if s is None or not hasattr(fam, "flop_per_ray"):
        return None
    rays = run.counters["slice_frames"] * run.counters["rays_per_frame"]
    return 100.0 * fam.flop_per_ray(run.cell.cfg, False) * rays / s.window_s / flops.H100_BF16_FLOPS
