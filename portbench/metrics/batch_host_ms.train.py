"""batch_host_ms.train: host milliseconds of the dataset's ``train_batch``
per step of the window (run in the Trainer's prefetch thread), from the
benchmark's wrapper around the dataset it hands to the Trainer."""


def read(run):
    if run.cell.traffic["kind"] != "train" or not run.counters.get("window_steps"):
        return None
    return run.counters["batch_host_ms"]
