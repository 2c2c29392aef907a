"""K3 and K3b (multi-head attention forward and backward) in the traced
training steps: their bound, call by call the larger of valid-length
bytes over HBM and operations over the float32 peak, over their summed
device time, in %."""


def read(r):
    return r.roofline(__file__, ("mha_fwd", "mha_bwd"), ("mha", "mha_bwd"))
