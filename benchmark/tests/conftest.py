"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the repository's root.  Tests marked `card` need a CUDA device; they
decide so inside the `card` fixture and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (the H100)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda:0")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    from benchmark.tests.tiny import tiny_copy

    return tiny_copy(tmp_path_factory.mktemp("tiny"))
