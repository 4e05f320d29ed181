"""nonmlp_ms.train: device milliseconds per traced training step outside
vanilla NeRF's MLP (forward and backward): the encodings, sampling,
``sample_pdf``, compositing, the loss and Adam."""


def read(run):
    s = run.summary
    if s is None or "nerf_mlp" not in s.layer_device_s:
        return None
    return 1e3 * (s.device_s - s.layer_device_s["nerf_mlp"]) / run.counters["slice_steps"]
