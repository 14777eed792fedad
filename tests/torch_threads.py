"""One torch intra-op thread for the port's CPU tests.

The suite runs in several xdist workers on one host's cores, each
worker's torch with as many OpenMP threads as the host has cores, beside
the reference's XLA thread pools: oversubscribed, the threads spend much
of their time waiting for each other.  A port test module imports
``one_torch_thread``, which runs the module's tests on one torch thread
and restores the count after them.  The tests are smoke-sized, and each
comparison runs both of its sides in one process, under the same
setting.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
