"""nerf_mlp_roofline.train: vanilla NeRF's MLP against its roofline in the
traced training steps: the least time its work needs (the larger of its
operations over the bf16 peak and its bytes over HBM's rate, counted from
the shapes by ``lib/flops.py``: forward once, backward twice the forward's
operations, the encodings read and the outputs written once per pass) over
the device time of every operation launched inside the MLP's span or inside
the autograd nodes of the ops recorded there (%)."""

from portbench.lib import flops


def read(run):
    s = run.summary
    busy = s.layer_device_s.get("nerf_mlp", 0.0) if s is not None else 0.0
    if busy <= 0.0:
        return None
    cfg = run.cell.cfg
    rows = run.counters["slice_steps"] * run.counters["rays_per_step"] * flops.samples_per_ray(cfg)
    least = flops.least_seconds(3 * rows * flops.nerf_mlp_flop_per_row(cfg), 2 * rows * flops.nerf_mlp_bytes_per_row(cfg))
    return 100.0 * least / busy
