"""Device kernels launched in the traced span, over its optimizer steps: the
host's issue work a step (copies not counted)."""


def read(r):
    return len(r.trace.kernels) / r.units
