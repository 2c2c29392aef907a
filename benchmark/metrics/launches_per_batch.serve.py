"""Device kernels launched in the traced span, over its served batches of
the Recommender's batch size (copies not counted)."""


def read(r):
    return len(r.trace.kernels) / r.units
