"""count_roofline: the least time of the window's count-step bytes
(the driver's ``step_bytes``) at the device's published peak bandwidth, over the
device time of every kernel launched in the window, in percent."""


def read(r):
    t, peak = r["trace"], r["peak"]
    if r["step"] != "count" or t is None or peak is None or r["step_bytes"] is None:
        return None
    if t["kernel_s"] <= 0:
        return None
    return 100.0 * r["step_bytes"] / peak["hbm_bytes_per_s"] / t["kernel_s"]
