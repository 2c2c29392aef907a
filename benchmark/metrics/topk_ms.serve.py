"""Device milliseconds a served batch of scoring the catalog, masking the
history and taking the top k: the kernels named by the patterns in
topk_ms.serve.d/ (the catalog product, the exclusion's scatter, top-k)."""


def read(r):
    n, seconds = r.kernel_time(__file__)
    return 1e3 * seconds / r.units if n else None
