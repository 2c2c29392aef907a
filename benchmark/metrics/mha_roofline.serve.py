"""K3 (multi-head attention forward) in the traced served batches: its
bound over its summed device time, in %."""


def read(r):
    return r.roofline(__file__, ("mha_fwd",), ("mha",))
