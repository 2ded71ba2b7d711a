"""setup_s: process start to window start, by the host's clock (inputs
made from the seed, the stage's constructor, the warm-up call)."""


def read(r):
    return r["setup_s"]
