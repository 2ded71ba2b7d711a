"""detect_windows_per_s: target windows scanned over the window, every
window of every call over the calls' whole elapsed time (host clock)."""


def read(r):
    if r["family"] != "detect":
        return None
    return r["windows"] / r["elapsed_s"]
