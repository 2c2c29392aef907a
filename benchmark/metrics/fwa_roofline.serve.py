"""K1 (feature-wise attention forward) in the traced served batches: its
bound over its summed device time, in %."""


def read(r):
    return r.roofline(__file__, ("fwa_fwd",), ("fwa",))
