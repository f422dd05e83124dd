"""The harness's CPU tests run their tiny models on one thread: a shared
machine's thread pool turns each small product into milliseconds."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
