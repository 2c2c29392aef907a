"""1 - the union of the device's kernel and copy intervals over the traced
span of training chunks."""


def read(r):
    return 1.0 - r.trace.busy_s / r.trace.window_s
