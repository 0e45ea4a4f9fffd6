"""device_idle_share.train: the share of the traced train steps' wall time
in which no operation ran on the card (1 - the union of the device events'
intervals over the window)."""


def read(r):
    t = r.traced
    if t is None or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
