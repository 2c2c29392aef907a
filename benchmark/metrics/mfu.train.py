"""The traced training steps' operations (work/<config>.py, from valid
lengths, the backward at twice the forward, the optimizer) over the span
and the card's float32 peak, in %."""


def read(r):
    return r.mfu()
