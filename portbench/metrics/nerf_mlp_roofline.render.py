"""nerf_mlp_roofline.render: vanilla NeRF's MLP forward against its
roofline in the traced frames: the least time of its operations and bytes
(``lib/flops.py``) over the device time of every operation launched inside
the MLP's span (%)."""

from portbench.lib import flops


def read(run):
    s = run.summary
    busy = s.layer_device_s.get("nerf_mlp", 0.0) if s is not None else 0.0
    if busy <= 0.0:
        return None
    cfg = run.cell.cfg
    rows = run.counters["slice_frames"] * run.counters["rays_per_frame"] * flops.samples_per_ray(cfg)
    least = flops.least_seconds(rows * flops.nerf_mlp_flop_per_row(cfg), rows * flops.nerf_mlp_bytes_per_row(cfg))
    return 100.0 * least / busy
