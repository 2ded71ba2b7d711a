"""count_windows_per_s: panel windows (-A and -B) counted over the window,
table write included, over the calls' whole elapsed time (host clock)."""


def read(r):
    if r["family"] != "count":
        return None
    return r["windows"] / r["elapsed_s"]
