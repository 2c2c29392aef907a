"""The traced batches' operations (the user tower from valid lengths, the
catalog product) over the span and the card's float32 peak, in %."""


def read(r):
    return r.mfu()
