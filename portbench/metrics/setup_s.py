"""``setup_s``: process start to the first timed frame or step (host
clock): imports, the seed's grids, weights and rays on the device, the
kernel libraries loaded from the checkout's cache, warm-up."""


def read(rec):
    return rec["setup_s"]
