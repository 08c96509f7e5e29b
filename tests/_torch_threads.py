"""One intra-op torch thread for the port's test modules.

The suite runs several pytest workers on shared cores; the port's tensors
in these tests are tiny, and a pool of spinning OpenMP threads in every
worker slows all of them down many times over.  A port test module takes
the cap with ``from _torch_threads import one_torch_thread  # noqa: F401``.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the importing module runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
