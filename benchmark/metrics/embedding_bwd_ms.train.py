"""Device milliseconds a step of the embedding gathers' backward: the
index-backward (scatter-add) kernels and the sort that orders their
indices, named by the patterns in embedding_bwd_ms.train.d/."""


def read(r):
    n, seconds = r.kernel_time(__file__)
    return 1e3 * seconds / r.units if n else None
