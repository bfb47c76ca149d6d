"""A fixture for the port's test files: one PyTorch intra-op thread.

The suite runs several xdist workers on few cores. PyTorch's intra-op
threads then wait on one another at the end of every parallel operation
while other workers hold the cores: measured on an 8-core machine with six
workers, ``test_chunked_step_equals_the_sequential_one`` took 210 s beside
the other port tests and 1.6 s alone. With one thread a worker the
operations run back to back.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
