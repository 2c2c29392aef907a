"""K1 and K2 (feature-wise attention forward and backward) in the traced
training steps: their bound, call by call the larger of valid-length
bytes over HBM and operations over the float32 peak, over their summed
device time, in %."""


def read(r):
    return r.roofline(__file__, ("fwa_fwd", "fwa_bwd"), ("fwa", "fwa_bwd"))
