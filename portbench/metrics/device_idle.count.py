"""device_idle.count: the share of the traced window in which no kernel,
memcpy or memset ran on the device (union of the profiler's intervals)."""


def read(r):
    t = r["trace"]
    if r["family"] != "count" or t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
