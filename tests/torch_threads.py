"""The port's test modules pin torch to one thread: the suite runs in
several xdist workers at once, and torch's default of a thread a core in
each slows every worker many times over.  A module pins itself with
``from tests.torch_threads import one_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
