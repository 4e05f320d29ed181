"""idle_share.render: the share of the device-only traced frames (whole
frames, request to RGB on the host, timed by the host) in which no operation
ran on the card (%)."""


def read(run):
    s = run.idle
    if s is None or run.cell.traffic["kind"] != "render":
        return None
    return 100.0 * s.idle_share
