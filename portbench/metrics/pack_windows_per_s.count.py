"""pack_windows_per_s.count: the port's packer alone over the cell's
distinct inputs after the window, no device (benchmark's host clock)."""


def read(r):
    if r["family"] != "count" or r["pack"] is None:
        return None
    windows, seconds = r["pack"]
    return windows / seconds
