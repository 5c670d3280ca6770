"""Device busy time a step: the union of device intervals of the traced
window over the steps it holds."""


def read(t):
    w, steps = t.get("profile"), t.get("profiled_steps")
    return 1e3 * w.busy_s / steps if w is not None and steps else None
