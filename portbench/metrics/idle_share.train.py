"""idle_share.train: the share of the device-only traced slice of a
training window (whole steps between two synchronizes, timed by the host)
in which no operation ran on the card, from the profiler's device activity
(%)."""


def read(run):
    s = run.idle
    if s is None or run.cell.traffic["kind"] != "train":
        return None
    return 100.0 * s.idle_share
