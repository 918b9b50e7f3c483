import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    """Pools go to the test's own cache directory."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))


@pytest.fixture
def tiny_root(tmp_path):
    from benchmark.tests import tiny

    return tiny.make_root(str(tmp_path))


@pytest.fixture
def card():
    """The test needs a CUDA card: decided here, when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
