"""An autouse fixture for the port's CPU test modules: torch on one
intra-op thread for the module.  The suite runs several pytest workers
on one host, and a torch pool of a thread a core in each of them
oversubscribes the cores; the tests' small shapes gain nothing from
more threads.  A module takes it with
``from tests.torch_one_thread import one_torch_thread  # noqa: F401``."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
