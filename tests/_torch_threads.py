"""One torch intra-op thread for a test module of the port: the reduced
models and plain kernels are small, and a thread pool's hand-offs
dominate at these sizes on a shared CPU.  A module takes it with
``from _torch_threads import one_thread`` (autouse, module-scoped: the
old count comes back after the module)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
