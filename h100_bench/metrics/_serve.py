"""Shared arithmetic of the serving cells' trace readers: device time of a
range per request of the traced window."""


def per_request_ms(run, name, outside=()):
    tr = run.trace
    if tr is None:
        return None
    n = tr.count("bench.request")
    if not n or not tr.ranges.get(name):
        return None
    return 1e3 * tr.device_s(name, outside=outside) / n


def idle_share(run):
    tr = run.trace
    if tr is None or not tr.window_s():
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
