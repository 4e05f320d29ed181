"""mfu.train: the whole training step's share of the card's bf16 peak: the
model's operations per ray (the family's count; for vanilla NeRF every
sample through the MLP, times 3 for forward and backward) times the traced
slice's rays, over the device-only traced slice (no host-op overhead) and the peak (%)."""

from portbench.lib import flops


def read(run):
    s, fam = run.idle, run.cell.family
    if s is None or not hasattr(fam, "flop_per_ray"):
        return None
    rays = run.counters["slice_steps"] * run.counters["rays_per_step"]
    return 100.0 * fam.flop_per_ray(run.cell.cfg, True) * rays / s.window_s / flops.H100_BF16_FLOPS
