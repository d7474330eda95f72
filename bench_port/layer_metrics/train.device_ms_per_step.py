"""Device-busy milliseconds (the union of intervals) per step of the
traced window."""


def read(res, ctx):
    tr = res.get("trace")
    steps = res["stats"].get("steps")
    if tr is None or not steps or tr.n_device_events == 0:
        return None
    return 1e3 * tr.busy_s / steps
